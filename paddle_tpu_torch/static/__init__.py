"""``static``: the static-graph surface (counterpart of
``paddle_tpu.static``).

The graph engine is ``graph.py`` (programs of deferred ops, evaluated by
``Executor`` on its place); this module adds ``static.nn``, the metrics,
and persistence: ``save``/``load`` of a program's persistable variables
and ``save_inference_model``/``load_inference_model``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..jit import InputSpec  # noqa: F401
from ..tensor.control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .graph import (  # noqa: F401
    BuildStrategy, CompiledProgram, Executor, ExecutionStrategy, Print,
    Program, Scope, Variable, WeightNormParamAttr, _to_numpy,
    append_backward, cpu_places, create_global_var, create_parameter,
    cuda_places, data, default_main_program, default_startup_program,
    device_guard, global_scope, gradients, name_scope, program_guard,
    py_func, scope_guard, xpu_places,
)


class nn:
    """``static.nn``: structured control flow, ``fc``, ``embedding``,
    ``conv2d``, ``dropout`` and ``batch_norm`` over created parameters."""

    while_loop = staticmethod(while_loop)
    cond = staticmethod(cond)
    case = staticmethod(case)
    switch_case = staticmethod(switch_case)

    @staticmethod
    def fc(x, size, num_flatten_dims: int = 1, weight_attr=None,
           bias_attr=None, activation=None, name=None):
        """``x @ w + b`` over created parameters."""
        from .. import tensor as T
        from ..nn import functional as F

        in_dim = 1
        for s in x.shape[num_flatten_dims:]:
            in_dim *= int(s)
        w = create_parameter([in_dim, size], x.dtype, name=None)
        b = create_parameter([size], x.dtype, is_bias=True)
        flat = T.reshape(x, list(x.shape[:num_flatten_dims]) + [in_dim]) \
            if len(x.shape) > num_flatten_dims + 1 else x
        out = T.add(T.matmul(flat, w), b)
        if activation:
            out = getattr(F, activation)(out)
        return out

    @staticmethod
    def embedding(input, size, is_sparse: bool = False, padding_idx=None,
                  param_attr=None, dtype: str = "float32", name=None):
        """A lookup in a created table."""
        from ..nn import functional as F

        w = create_parameter([int(size[0]), int(size[1])], dtype)
        return F.embedding(input, w, padding_idx=padding_idx)

    @staticmethod
    def conv2d(input, num_filters, filter_size, stride=1, padding=0,
               dilation=1, groups=1, param_attr=None, bias_attr=None,
               act=None, data_format: str = "NCHW", name=None):
        """``F.conv2d`` over a created filter (and bias)."""
        from .. import tensor as T
        from ..nn import functional as F

        k = (filter_size, filter_size) if isinstance(filter_size, int) \
            else tuple(filter_size)
        cin = int(input.shape[1] if data_format == "NCHW"
                  else input.shape[-1])
        w = create_parameter([num_filters, cin // groups, k[0], k[1]],
                             input.dtype)
        out = F.conv2d(input, w, None, stride=stride, padding=padding,
                       dilation=dilation, groups=groups,
                       data_format=data_format)
        if bias_attr is not False:
            b = create_parameter([num_filters], input.dtype, is_bias=True)
            shape = [1, num_filters, 1, 1] if data_format == "NCHW" \
                else [1, 1, 1, num_filters]
            out = T.add(out, T.reshape(b, shape))
        if act:
            out = getattr(F, act)(out)
        return out

    @staticmethod
    def dropout(x, dropout_prob: float = 0.5, is_test: bool = False,
                name=None):
        from ..nn import functional as F

        return F.dropout(x, dropout_prob, training=not is_test)

    @staticmethod
    def batch_norm(input, act=None, is_test: bool = False, momentum=0.9,
                   epsilon=1e-5, param_attr=None, bias_attr=None,
                   data_format: str = "NCHW", name=None):
        """Scale and shift parameters and running statistics as
        persistable variables; in training mode the running statistics'
        new values are appended to the program's updates (the
        reference's MeanOut/VarianceOut)."""
        from .. import tensor as T
        from ..nn import functional as F

        c = int(input.shape[1] if data_format == "NCHW" else input.shape[-1])
        from ..nn import initializer as I

        scale = create_parameter([c], input.dtype,
                                 default_initializer=I.Constant(1.0))
        shift = create_parameter([c], input.dtype, is_bias=True)
        tag = "bn_%d" % len(input.program._vars)
        mean = create_global_var([c], 0.0, input.dtype, persistable=True,
                                 name=tag + "_mean")
        var = create_global_var([c], 1.0, input.dtype, persistable=True,
                                name=tag + "_variance")
        prog = input.program
        # the one BN implementation (functional.norm's triple): the
        # static bridge turns its three outputs into selector Variables
        out, new_mean, new_var = F._bn_triple(
            input, mean, var, scale, shift, training=not is_test,
            momentum=momentum, epsilon=epsilon, data_format=data_format)
        if not is_test:
            prog._updates.append((mean, new_mean))
            prog._updates.append((var, new_var))
        if act:
            out = getattr(F, act)(out)
        return out


def accuracy(input, label, k: int = 1, correct=None, total=None):
    """The top-``k`` accuracy as a graph node."""
    from ..framework.dispatch import make_op
    from ..metric import accuracy as _acc

    return make_op(_acc, "accuracy")(input, label, k=k)


def _auc(pred, lab):
    """Single-batch ROC AUC by midranks: tied scores get the average of
    their rank span, so the Mann-Whitney statistic matches sklearn on
    quantized scores."""
    score = pred[:, 1] if pred.ndim == 2 and pred.shape[1] == 2 \
        else pred.reshape(-1)
    score = score.contiguous()
    lab2 = lab.reshape(-1)
    sorted_s = torch.sort(score).values
    lo = torch.searchsorted(sorted_s, score, right=False)
    hi = torch.searchsorted(sorted_s, score, right=True)
    ranks = (lo + hi + 1).to(torch.float64) / 2.0
    pos = lab2 > 0
    n_pos = pos.sum().to(torch.float64)
    n_neg = lab2.shape[0] - n_pos
    s = torch.where(pos, ranks, 0.0).sum()
    auc = (s - n_pos * (n_pos + 1) / 2.0) / torch.clamp(n_pos * n_neg, min=1)
    return torch.where((n_pos > 0) & (n_neg > 0), auc,
                       torch.zeros_like(auc)).to(torch.float32)


def auc(input, label, curve: str = "ROC", num_thresholds: int = 4095,
        topk: int = 1, slide_steps: int = 1):
    """Single-batch AUC as a graph node (stateless); returns ``(auc, [],
    [])`` as the reference's."""
    from ..framework.dispatch import make_op

    return make_op(_auc, "auc")(input, label), [], []


# -- persistence ------------------------------------------------------------

def _collect_persistables(program: Program) -> Dict[str, np.ndarray]:
    scope = global_scope()
    return {name: _to_numpy(scope._values[name])
            for name, v in program._vars.items()
            if v.kind == "persist" and name in scope._values}


def save(program: Program, model_path: str, protocol: int = 4, **kwargs):
    """A program's persistable variables to ``<path>.pdparams.npz``."""
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    np.savez(model_path + ".pdparams", **_collect_persistables(program))


def load(program: Program, model_path: str, executor=None, var_list=None):
    """Read ``save``'s file into the scope."""
    with np.load(model_path + ".pdparams.npz", allow_pickle=False) as z:
        state = {k: z[k] for k in z.files}
    program.set_state_dict(state)


def load_program_state(model_path: str, var_list=None) -> Dict[str, np.ndarray]:
    with np.load(model_path + ".pdparams.npz", allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def set_program_state(program: Program, state_dict: Dict[str, np.ndarray]):
    program.set_state_dict(state_dict)


def serialize_program(feed_vars, fetch_vars, **kwargs) -> bytes:
    """The program's feeds and fetches as a JSON manifest (the
    reference's stand-in for a serialized program)."""
    fetch = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    feeds = feed_vars if isinstance(feed_vars, (list, tuple)) else [feed_vars]
    doc = {
        "feeds": [{"name": v.name, "shape": list(v.shape),
                   "dtype": str(v.dtype).replace("torch.", "")}
                  for v in feeds],
        "fetches": [v.name for v in fetch],
    }
    return json.dumps(doc).encode("utf-8")


def serialize_persistables(feed_vars, fetch_vars, **kwargs) -> bytes:
    import io as _io

    prog = (fetch_vars[0] if isinstance(fetch_vars, (list, tuple))
            else fetch_vars).program
    buf = _io.BytesIO()
    np.savez(buf, **_collect_persistables(prog))
    return buf.getvalue()


def deserialize_program(data: bytes) -> dict:
    return json.loads(data.decode("utf-8"))


def deserialize_persistables(program: Program, data: bytes, executor=None):
    import io as _io

    with np.load(_io.BytesIO(data), allow_pickle=False) as z:
        program.set_state_dict({k: z[k] for k in z.files})


def save_to_file(path: str, content: bytes) -> None:
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program: Program, feed_vars, fetch_vars) -> Program:
    return program.clone(for_test=True)


# Same-process program registry: the deferred graph is a live Python
# object, not a serialized program (jit.save/load carries programs across
# processes), so save stamps a token that load resolves back to the
# Program while it is alive.
_saved_programs: Dict[str, Program] = {}


def save_inference_model(path_prefix: str, feed_vars, fetch_vars, executor,
                         program: Optional[Program] = None, **kwargs):
    """The manifest, the persistables and the inference program (the
    program without its updates)."""
    fetch = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    program = program or fetch[0].program or default_main_program()
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    save_to_file(path_prefix + ".pdmodel",
                 serialize_program(feed_vars, fetch_vars))
    np.savez(path_prefix + ".pdiparams", **_collect_persistables(program))
    token = "prog_%d" % id(program)
    # the inference subgraph: no update ops (the reference's for_test
    # clone)
    _saved_programs[token] = program.clone(for_test=True)
    meta = {"fetches": [v.name for v in fetch], "token": token}
    save_to_file(path_prefix + ".pdmeta", json.dumps(meta).encode())


def load_inference_model(path_prefix: str, executor,
                         program: Optional[Program] = None, **kwargs):
    """``(program, feed_names, fetch_vars)``."""
    manifest = json.loads(load_from_file(path_prefix + ".pdmodel").decode())
    meta = {}
    if os.path.exists(path_prefix + ".pdmeta"):
        meta = json.loads(load_from_file(path_prefix + ".pdmeta").decode())
    prog = program or _saved_programs.get(meta.get("token", ""), None) \
        or default_main_program()
    with np.load(path_prefix + ".pdiparams.npz", allow_pickle=False) as z:
        prog.set_state_dict({k: z[k] for k in z.files})
    feed_names = [f["name"] for f in manifest["feeds"]]
    fetch_vars = [prog._vars[name] for name in meta.get("fetches", ())
                  if name in prog._vars]
    return prog, feed_names, fetch_vars


ParallelExecutor = CompiledProgram


__all__ = [
    "InputSpec", "nn", "while_loop", "cond", "case", "switch_case",
    "Variable", "Program", "Scope", "Executor", "CompiledProgram",
    "ParallelExecutor", "BuildStrategy", "ExecutionStrategy", "Print",
    "WeightNormParamAttr", "append_backward", "gradients", "accuracy", "auc",
    "cpu_places", "cuda_places", "xpu_places", "create_global_var",
    "create_parameter", "data", "default_main_program",
    "default_startup_program", "device_guard", "global_scope", "name_scope",
    "program_guard", "py_func", "scope_guard", "save", "load",
    "load_program_state", "set_program_state", "serialize_program",
    "serialize_persistables", "deserialize_program",
    "deserialize_persistables", "save_to_file", "load_from_file",
    "normalize_program", "save_inference_model", "load_inference_model",
]
