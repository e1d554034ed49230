"""Activation layers (counterpart of the reference's
``nn/layer/activation.py``): each calls the ``nn.functional`` op of its
name with the arguments it was built with."""
from __future__ import annotations


from .. import functional as F
from .. import initializer as I
from .layers import Layer, create_parameter


def _simple(name, fn_name, extra_args=()):
    def __init__(self, *args, name=None, **kwargs):
        Layer.__init__(self)
        for (argname, default), val in zip(
                extra_args, list(args) + [None] * len(extra_args)):
            setattr(self, argname,
                    val if val is not None else kwargs.get(argname, default))

    def forward(self, x):
        args = [getattr(self, argname) for argname, _ in extra_args]
        return getattr(F, fn_name)(x, *args)

    return type(name, (Layer,), {"__init__": __init__,
                                 "forward": forward,
                                 "__module__": __name__})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
GELU = _simple("GELU", "gelu", (("approximate", False),))
LeakyReLU = _simple("LeakyReLU", "leaky_relu", (("negative_slope", 0.01),))
ELU = _simple("ELU", "elu", (("alpha", 1.0),))
SELU = _simple("SELU", "selu")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardtanh = _simple("Hardtanh", "hardtanh", (("min", -1.0), ("max", 1.0)))
Hardshrink = _simple("Hardshrink", "hardshrink", (("threshold", 0.5),))
Softshrink = _simple("Softshrink", "softshrink", (("threshold", 0.5),))
Softplus = _simple("Softplus", "softplus",
                   (("beta", 1.0), ("threshold", 20.0)))
Softsign = _simple("Softsign", "softsign")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu",
                          (("threshold", 1.0),))
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
GLU = _simple("GLU", "glu", (("axis", -1),))


class Softmax(Layer):
    def __init__(self, axis: int = -1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis: int = -1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class PReLU(Layer):
    """``num_parameters`` slopes (1: shared; C: one per channel on axis
    1), each ``init``."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25,
                 weight_attr=None, data_format="NCHW", name=None,
                 device=None):
        super().__init__()
        self.weight = create_parameter(
            [num_parameters], weight_attr,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self.weight)


class Maxout(Layer):
    def __init__(self, groups: int, axis: int = 1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)
