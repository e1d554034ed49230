"""ONNX export: trace a layer and write an ONNX model file (counterpart of
``paddle_tpu.onnx``).

The reference walks a jaxpr; the port walks the graph of
``torch.export(...).run_decompositions()`` (core ATen operators) and maps
each operator onto the ONNX op set the numpy runtime (``runtime.py``)
covers: ``Add`` ... ``Where``, ``Conv``, ``MatMul``, ``ReduceSum``/``Max``/
``Min``/``Prod``, ``Reshape``, ``Expand``, ``Transpose``, ``Cast``.
Softmax and layer norm are written as their compositions over that set.
The wire format is written directly (``_proto.py``): there is no ``onnx``
package here or on the card.  Files are standard ONNX (ir_version 8,
opset 17).

Any other operator raises naming it, as paddle2onnx's op-coverage errors
do; K3's registered operator (``paddle_tpu_torch.flash_attention_forward``)
is refused by name too: attention has no ONNX op in this set.
"""
from __future__ import annotations

import operator
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.errors import InvalidArgumentError
from . import _proto as P

__all__ = ["export"]

_DTYPES = {
    np.dtype(np.float32): P.FLOAT,
    np.dtype(np.int64): P.INT64,
    np.dtype(np.int32): P.INT32,
    np.dtype(np.bool_): P.BOOL,
}
_TORCH_NP = {torch.float32: np.float32, torch.int64: np.int64,
             torch.int32: np.int32, torch.bool: np.bool_}


def _np_dtype(dtype) -> np.dtype:
    if dtype not in _TORCH_NP:
        raise InvalidArgumentError(
            "ONNX export: unsupported dtype %s" % (dtype,))
    return np.dtype(_TORCH_NP[dtype])


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = _DTYPES.get(arr.dtype)
    if dt is None:
        raise InvalidArgumentError(
            "ONNX export: unsupported initializer dtype %s" % arr.dtype)
    return (b"".join(P.f_int(1, d) for d in arr.shape)
            + P.f_int(2, dt)
            + P.f_bytes(9, arr.tobytes())
            + P.f_str(8, name))


def _value_info(name: str, shape, dtype) -> bytes:
    dims = b"".join(P.f_msg(1, P.f_int(1, int(d))) for d in shape)
    ttype = P.f_int(1, _DTYPES[np.dtype(dtype)]) + P.f_msg(2, dims)
    return P.f_str(1, name) + P.f_msg(2, P.f_msg(1, ttype))


def _attr_ints(name: str, vals) -> bytes:
    return P.f_msg(5, P.f_str(1, name) + P.f_int(20, P.ATTR_INTS)
                   + b"".join(P.f_int(8, int(v)) for v in vals))


def _attr_int(name: str, v: int) -> bytes:
    return P.f_msg(5, P.f_str(1, name) + P.f_int(20, P.ATTR_INT)
                   + P.f_int(3, int(v)))


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str],
          attrs: bytes = b"") -> bytes:
    return P.f_msg(1, b"".join(P.f_str(1, i) for i in inputs)
                   + b"".join(P.f_str(2, o) for o in outputs)
                   + P.f_str(4, op) + attrs)


_UNARY = {
    "exp": "Exp", "log": "Log", "tanh": "Tanh", "sigmoid": "Sigmoid",
    "neg": "Neg", "sqrt": "Sqrt", "abs": "Abs", "sign": "Sign",
    "floor": "Floor", "ceil": "Ceil", "reciprocal": "Reciprocal",
    "clone": "Identity", "alias": "Identity", "detach": "Identity",
    "lift_fresh_copy": "Identity",
}
_BINARY = {
    "add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
    "maximum": "Max", "minimum": "Min", "pow": "Pow",
    "gt": "Greater", "lt": "Less", "ge": "GreaterOrEqual",
    "le": "LessOrEqual", "eq": "Equal", "logical_and": "And",
    "logical_or": "Or",
}
_REDUCE = {"amax": "ReduceMax", "amin": "ReduceMin"}
_RESHAPES = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze"}


def _meta(node):
    return node.meta["val"]


def _dims(dim, ndim: int) -> list:
    dims = [dim] if isinstance(dim, int) else list(dim or range(ndim))
    return [d % ndim for d in dims]


class _Converter:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.names: Dict = {}
        self.counter = 0

    def fresh(self, hint: str = "t") -> str:
        self.counter += 1
        return "%s_%d" % (hint, self.counter)

    def const(self, arr: np.ndarray, hint: str = "const") -> str:
        name = self.fresh(hint)
        self.initializers.append(P.f_msg(5, _tensor_proto(name, arr)))
        return name

    def emit_node(self, op, ins, outs, attrs=b"") -> None:
        self.nodes.append(_node(op, ins, outs, attrs))

    def name_of(self, arg, like=None) -> str:
        """An fx node's name, or a constant for a Python scalar (in the
        dtype of ``like``, a tensor node beside it)."""
        if isinstance(arg, torch.fx.Node):
            return self.names[arg]
        dtype = _np_dtype(_meta(like).dtype) if like is not None \
            else np.dtype(np.float32)
        return self.const(np.asarray(arg, dtype), "lit")

    def _reduce_mean(self, x: str, axes, keepdims: int, count: int,
                     dtype) -> str:
        s = self.fresh("sum")
        self.emit_node("ReduceSum", [x, self.const(np.asarray(axes,
                                                              np.int64))],
                       [s], _attr_int("keepdims", keepdims))
        out = self.fresh("mean")
        self.emit_node("Div", [s, self.const(np.asarray(count, dtype))],
                       [out])
        return out

    def emit(self, node) -> None:
        target = node.target
        if target is operator.getitem:
            src, i = node.args
            got = self.names[src]
            if not isinstance(got, list):
                raise InvalidArgumentError(
                    "ONNX export: getitem of a single output")
            if got[i] is None:
                raise InvalidArgumentError(
                    "ONNX export: output %d of %s has no ONNX mapping"
                    % (i, src.target))
            self.names[node] = got[i]
            return
        if not isinstance(target, torch._ops.OpOverload):
            raise InvalidArgumentError(
                "ONNX export: call %r has no ONNX mapping" % (target,))
        if target.namespace != "aten":
            raise InvalidArgumentError(
                "ONNX export: operator %r has no ONNX mapping (K3's "
                "attention kernel and other custom operators are not "
                "exported)" % target.name())
        op = target.overloadpacket.__name__
        if op.startswith("_assert"):
            return  # a trace-time check: nothing at run time
        args, kw = node.args, node.kwargs
        out = self.fresh("v")
        self.names[node] = out
        val = _meta(node)

        if op in _UNARY:
            self.emit_node(_UNARY[op], [self.name_of(args[0])], [out])
        elif op in _BINARY:
            like = next((a for a in args[:2]
                         if isinstance(a, torch.fx.Node)), None)
            a = self.name_of(args[0], like)
            b = self.name_of(args[1], like)
            alpha = kw.get("alpha", 1)
            if alpha != 1:
                scaled = self.fresh("alpha")
                self.emit_node("Mul", [b, self.name_of(alpha, like)],
                               [scaled])
                b = scaled
            if op == "div" and kw.get("rounding_mode") is not None:
                raise InvalidArgumentError(
                    "ONNX export: div with rounding_mode has no mapping")
            self.emit_node(_BINARY[op], [a, b], [out])
        elif op == "rsqrt":
            mid = self.fresh("sqrt")
            self.emit_node("Sqrt", [self.name_of(args[0])], [mid])
            self.emit_node("Reciprocal", [mid], [out])
        elif op == "relu":
            self.emit_node("Max", [self.name_of(args[0]),
                                   self.name_of(0.0, args[0])], [out])
        elif op == "sum":
            x = args[0]
            axes = _dims(args[1] if len(args) > 1 else None,
                         _meta(x).ndim)
            keep = int(args[2]) if len(args) > 2 else int(
                kw.get("keepdim", False))
            self.emit_node("ReduceSum", [self.name_of(x), self.const(
                np.asarray(axes, np.int64))], [out],
                _attr_int("keepdims", keep))
        elif op in _REDUCE:
            x = args[0]
            axes = _dims(args[1] if len(args) > 1 else None,
                         _meta(x).ndim)
            keep = int(args[2]) if len(args) > 2 else 0
            # ReduceMax/Min take axes as an attribute until opset 18
            self.emit_node(_REDUCE[op], [self.name_of(x)], [out],
                           _attr_ints("axes", axes)
                           + _attr_int("keepdims", keep))
        elif op == "mean":
            x = args[0]
            shape = _meta(x).shape
            axes = _dims(args[1] if len(args) > 1 else None, len(shape))
            keep = int(args[2]) if len(args) > 2 else 0
            count = int(np.prod([shape[d] for d in axes]))
            mean = self._reduce_mean(self.name_of(x), axes, keep, count,
                                     _np_dtype(val.dtype))
            self.emit_node("Identity", [mean], [out])
        elif op in ("mm", "bmm"):
            self.emit_node("MatMul", [self.name_of(a) for a in args[:2]],
                           [out])
        elif op == "addmm":
            bias, a, b = args[:3]
            if kw.get("beta", 1) != 1 or kw.get("alpha", 1) != 1:
                raise InvalidArgumentError(
                    "ONNX export: addmm with beta/alpha has no mapping")
            prod = self.fresh("mm")
            self.emit_node("MatMul", [self.name_of(a), self.name_of(b)],
                           [prod])
            self.emit_node("Add", [prod, self.name_of(bias)], [out])
        elif op == "permute":
            self.emit_node("Transpose", [self.name_of(args[0])], [out],
                           _attr_ints("perm", _dims(args[1],
                                                    len(args[1]))))
        elif op in _RESHAPES:
            self.emit_node("Reshape", [self.name_of(args[0]), self.const(
                np.asarray(val.shape, np.int64))], [out])
        elif op == "expand":
            self.emit_node("Expand", [self.name_of(args[0]), self.const(
                np.asarray(val.shape, np.int64))], [out])
        elif op == "_to_copy":
            src = args[0]
            if _meta(src).dtype == val.dtype:
                self.emit_node("Identity", [self.name_of(src)], [out])
            else:
                self.emit_node("Cast", [self.name_of(src)], [out],
                               _attr_int("to", _DTYPES[_np_dtype(
                                   val.dtype)]))
        elif op == "where":
            like = next(a for a in args[1:] if isinstance(a, torch.fx.Node))
            self.emit_node("Where", [self.name_of(args[0])] + [
                self.name_of(a, like) for a in args[1:]], [out])
        elif op in ("full", "scalar_tensor", "zeros", "ones"):
            if op == "scalar_tensor":
                value = args[0]
            elif op == "full":
                value = args[1]
            else:
                value = 0 if op == "zeros" else 1
            arr = np.full(tuple(val.shape), value, _np_dtype(val.dtype))
            self.emit_node("Identity", [self.const(arr, "full")], [out])
        elif op == "arange":
            # static bounds: the values are a constant of the program
            arr = np.arange(*[a for a in args if isinstance(a, (int, float))],
                            dtype=_np_dtype(val.dtype))
            self.emit_node("Identity", [self.const(arr, "arange")], [out])
        elif op == "_softmax":
            x, dim = self.name_of(args[0]), _dims(args[1], val.ndim)
            mx, sh, ex, sm = (self.fresh(h) for h in
                              ("max", "shift", "exp", "sum"))
            self.emit_node("ReduceMax", [x], [mx], _attr_ints("axes", dim)
                           + _attr_int("keepdims", 1))
            self.emit_node("Sub", [x, mx], [sh])
            self.emit_node("Exp", [sh], [ex])
            self.emit_node("ReduceSum", [ex, self.const(np.asarray(
                dim, np.int64))], [sm], _attr_int("keepdims", 1))
            self.emit_node("Div", [ex, sm], [out])
        elif op == "native_layer_norm":
            self._layer_norm(node, out)
        elif op == "convolution":
            self._conv(node, out)
        else:
            raise InvalidArgumentError(
                "ONNX export: operator %r has no ONNX mapping yet"
                % target.name())

    def _layer_norm(self, node, out) -> None:
        x, shape, weight, bias, eps = node.args
        xv = _meta(x)
        dtype = _np_dtype(xv.dtype)
        axes = list(range(xv.ndim - len(shape), xv.ndim))
        count = int(np.prod(shape))
        xn = self.name_of(x)
        mean = self._reduce_mean(xn, axes, 1, count, dtype)
        cen, sq, root, norm = (self.fresh(h) for h in
                               ("centered", "square", "std", "norm"))
        self.emit_node("Sub", [xn, mean], [cen])
        self.emit_node("Mul", [cen, cen], [sq])
        var = self._reduce_mean(sq, axes, 1, count, dtype)
        shifted = self.fresh("var_eps")
        self.emit_node("Add", [var, self.const(np.asarray(eps, dtype))],
                       [shifted])
        self.emit_node("Sqrt", [shifted], [root])
        self.emit_node("Div", [cen, root], [norm])
        y = norm
        if weight is not None:
            y2 = self.fresh("scaled")
            self.emit_node("Mul", [y, self.name_of(weight)], [y2])
            y = y2
        if bias is not None:
            y2 = self.fresh("shifted")
            self.emit_node("Add", [y, self.name_of(bias)], [y2])
            y = y2
        self.emit_node("Identity", [y], [out])
        # mean and rstd (outputs 1, 2) are not exported
        self.names[node] = [out, None, None]

    def _conv(self, node, out) -> None:
        (x, w, bias, stride, padding, dilation, transposed, _,
         groups) = node.args
        if transposed:
            raise InvalidArgumentError(
                "ONNX export: transposed conv has no Conv mapping; "
                "ConvTranspose emission not implemented yet")
        if _meta(x).ndim != 4:
            raise InvalidArgumentError(
                "ONNX export: conv supported in 2-D NCHW layout only")
        attrs = (_attr_ints("strides", stride)
                 + _attr_ints("dilations", dilation)
                 + _attr_int("group", groups)
                 + _attr_ints("pads", list(padding) + list(padding)))
        conv = out if bias is None else self.fresh("conv")
        self.emit_node("Conv", [self.name_of(x), self.name_of(w)], [conv],
                       attrs)
        if bias is not None:
            # the runtime's Conv takes no bias input: add it as the
            # reference's traced bias add does
            c = _meta(w).shape[0]
            b4 = self.fresh("bias4")
            self.emit_node("Reshape", [self.name_of(bias), self.const(
                np.asarray([1, c, 1, 1], np.int64))], [b4])
            self.emit_node("Add", [conv, b4], [out])


class _Call(torch.nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, *xs):
        return self.layer(*xs)


def export(layer, path: str, input_spec: Optional[Sequence] = None,
           opset_version: int = 17) -> str:
    """Trace ``layer`` on the example arrays (or tensors) of
    ``input_spec`` and write ``path``.onnx; returns the path written."""
    if input_spec is None:
        raise InvalidArgumentError(
            "onnx.export needs input_spec= example arrays (static shapes)")
    device = next(iter(list(layer.parameters()) + list(layer.buffers())),
                  torch.empty(0)).device \
        if isinstance(layer, torch.nn.Module) else torch.device("cpu")
    examples = tuple(torch.as_tensor(np.asarray(x.detach().cpu())
                                     if torch.is_tensor(x) else
                                     np.asarray(x)).to(device)
                     for x in input_spec)
    was_training = getattr(layer, "training", False)
    if hasattr(layer, "eval"):
        layer.eval()
    try:
        with torch.no_grad():
            ep = torch.export.export(_Call(layer), examples, strict=False)
            ep = ep.run_decompositions()
    finally:
        if was_training and hasattr(layer, "train"):
            layer.train()

    conv = _Converter()
    state = dict(ep.state_dict)
    state.update(ep.constants)
    by_name = {s.arg.name: s for s in ep.graph_signature.input_specs}
    graph_inputs = []
    n_user = 0
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            spec = by_name[node.name]
            if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT:
                name = "input_%d" % n_user
                n_user += 1
                conv.names[node] = name
                val = _meta(node)
                graph_inputs.append(_value_info(name, val.shape,
                                                _np_dtype(val.dtype)))
            else:
                arr = state[spec.target].detach().cpu().numpy()
                conv.names[node] = conv.const(arr, "w")
        elif node.op == "call_function":
            conv.emit(node)
        elif node.op == "output":
            outs = node.args[0]
    graph_outputs = []
    for ov in outs:
        name = conv.names[ov]
        val = _meta(ov)
        graph_outputs.append(_value_info(name, val.shape,
                                         _np_dtype(val.dtype)))

    graph = (b"".join(conv.nodes)
             + P.f_str(2, "paddle_tpu_torch_graph")
             + b"".join(conv.initializers)
             + b"".join(P.f_msg(11, gi) for gi in graph_inputs)
             + b"".join(P.f_msg(12, go) for go in graph_outputs))
    model = (P.f_int(1, 8)  # ir_version
             + P.f_str(2, "paddle_tpu_torch")
             + P.f_msg(7, graph)
             + P.f_msg(8, P.f_str(1, "") + P.f_int(2, opset_version)))
    out_path = path if path.endswith(".onnx") else path + ".onnx"
    with open(out_path, "wb") as f:
        f.write(model)
    return out_path
