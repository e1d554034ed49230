"""``ParamAttr`` and ``create_parameter`` (counterpart of those parts of
the reference's ``nn/layer/layers.py``).

The port's layers are ``torch.nn.Module``s; what the reference's
``Layer.create_parameter`` does is :func:`create_parameter` here, which
makes an ``nn.Parameter`` and sets the attributes the port's optimizers
read where the reference's read them on its ``Parameter``:

- ``learning_rate`` -> ``p.optimize_attr = {"learning_rate": ratio}``;
- ``regularizer`` -> ``p.regularizer`` (which also makes a sparse
  embedding's update dense, as in the reference);
- ``need_clip`` -> ``p.need_clip``; ``do_model_average`` ->
  ``p.do_model_average``;
- ``trainable=False`` -> ``requires_grad=False``: ``TrainStep`` and the
  optimizers leave the parameter out;
- ``name`` -> ``p.param_name`` (the optimizer's name of it;
  ``torch.Tensor.name`` is torch's).

An attr of ``False`` (``bias_attr=False``) means no parameter: None.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.errors import InvalidArgumentError
from .. import initializer as I

__all__ = ["ParamAttr", "create_parameter"]


class ParamAttr:
    """paddle.ParamAttr (fluid/param_attr.py)."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr) -> Optional["ParamAttr"]:
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return None
        raise InvalidArgumentError("unsupported param_attr: %r" % (attr,))


def create_parameter(shape, attr=None, dtype=None, is_bias: bool = False,
                     default_initializer=None, device=None,
                     generator: Optional[torch.Generator] = None
                     ) -> Optional[nn.Parameter]:
    """The reference's ``Layer.create_parameter``: a parameter of
    ``shape`` from ``attr``'s initializer, else ``default_initializer``,
    else zeros for a bias and XavierUniform otherwise, drawn from
    ``generator`` on ``device``; None when ``attr`` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is None:
        return None
    init = attr.initializer or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    with torch.no_grad():
        value = init(tuple(int(s) for s in shape), dtype, device=device,
                     generator=generator)
    p = nn.Parameter(value, requires_grad=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.do_model_average = attr.do_model_average
    p.need_clip = attr.need_clip
    if attr.name is not None:
        p.param_name = attr.name
    return p
