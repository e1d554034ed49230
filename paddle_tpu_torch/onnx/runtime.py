"""Tiny numpy executor for exported ONNX files (test/validation harness);
the reference's ``paddle_tpu/onnx/runtime.py`` as it is.

No onnx/onnxruntime in this environment, so round-trip validation of
``paddle_tpu.onnx.export`` runs here: parse the wire format back
(``_proto.decode``) and evaluate the graph with numpy.  Covers exactly the
op set the exporter emits.
"""
from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from ..core.errors import InvalidArgumentError
from . import _proto as P

__all__ = ["load", "run"]

_NP_DTYPES = {P.FLOAT: np.float32, P.INT32: np.int32, P.INT64: np.int64,
              P.BOOL: np.bool_}


def _parse_tensor(buf: bytes) -> np.ndarray:
    f = P.decode(buf)
    dims = [int(d) for d in f.get(1, [])]
    dt = _NP_DTYPES[int(f[2][0])]
    raw = f.get(9, [b""])[0]
    return np.frombuffer(raw, dtype=dt).reshape(dims).copy()


def _parse_attrs(node_fields) -> Dict:
    attrs = {}
    for abuf in node_fields.get(5, []):
        f = P.decode(abuf)
        name = f[1][0].decode()
        atype = int(f[20][0])
        if atype == P.ATTR_INT:
            attrs[name] = int(f[3][0])
        elif atype == P.ATTR_INTS:
            attrs[name] = [int(v) for v in f.get(8, [])]
        elif atype == P.ATTR_FLOAT:
            attrs[name] = float(f[2][0])
        else:
            raise InvalidArgumentError("attr type %d unsupported" % atype)
    return attrs


def load(path: str):
    """Parse model file → (nodes, initializers, input_names, output_names)."""
    with open(path, "rb") as fh:
        model = P.decode(fh.read())
    graph = P.decode(model[7][0])
    inits = {}
    for tbuf in graph.get(5, []):
        f = P.decode(tbuf)
        inits[f[8][0].decode()] = _parse_tensor(tbuf)
    nodes = []
    for nbuf in graph.get(1, []):
        f = P.decode(nbuf)
        nodes.append({
            "op": f[4][0].decode(),
            "inputs": [b.decode() for b in f.get(1, [])],
            "outputs": [b.decode() for b in f.get(2, [])],
            "attrs": _parse_attrs(f),
        })
    def names(field):
        return [P.decode(b)[1][0].decode() for b in graph.get(field, [])]
    return nodes, inits, names(11), names(12)


def _conv(x, w, attrs):
    sh, sw = attrs.get("strides", [1, 1])
    dh, dw = attrs.get("dilations", [1, 1])
    groups = attrs.get("group", 1)
    pt_, pl = attrs.get("pads", [0, 0, 0, 0])[:2]
    pb, pr = attrs.get("pads", [0, 0, 0, 0])[2:]
    x = np.pad(x, ((0, 0), (0, 0), (pt_, pb), (pl, pr)))
    n, c, h, wd = x.shape
    o, ci, kh, kw = w.shape
    ekh = (kh - 1) * dh + 1  # effective (dilated) kernel extent
    ekw = (kw - 1) * dw + 1
    oh = (h - ekh) // sh + 1
    ow = (wd - ekw) // sw + 1
    og = o // groups
    out = np.zeros((n, o, oh, ow), np.float32)
    for g in range(groups):
        xg = x[:, g * ci:(g + 1) * ci]
        wg = w[g * og:(g + 1) * og]
        for y in range(oh):
            for z in range(ow):
                patch = xg[:, :, y * sh:y * sh + ekh:dh,
                           z * sw:z * sw + ekw:dw]
                out[:, g * og:(g + 1) * og, y, z] = np.einsum(
                    "nchw,ochw->no", patch, wg)
    return out


def run(path: str, inputs: List[np.ndarray]) -> List[np.ndarray]:
    nodes, env, in_names, out_names = load(path)
    for name, arr in zip(in_names, inputs):
        env[name] = np.asarray(arr)
    for nd in nodes:
        op = nd["op"]
        a = [env[k] for k in nd["inputs"]]
        at = nd["attrs"]
        if op == "MatMul":
            r = a[0] @ a[1]
        elif op in ("Add", "Sub", "Mul", "Div", "Max", "Min", "Pow",
                    "Greater", "Less", "GreaterOrEqual", "LessOrEqual",
                    "Equal", "And", "Or"):
            f = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
                 "Div": np.divide, "Max": np.maximum, "Min": np.minimum,
                 "Pow": np.power, "Greater": np.greater, "Less": np.less,
                 "GreaterOrEqual": np.greater_equal,
                 "LessOrEqual": np.less_equal, "Equal": np.equal,
                 "And": np.logical_and, "Or": np.logical_or}[op]
            r = f(a[0], a[1])
        elif op in ("Exp", "Log", "Tanh", "Neg", "Sqrt", "Abs", "Sign",
                    "Floor", "Ceil", "Reciprocal"):
            f = {"Exp": np.exp, "Log": np.log, "Tanh": np.tanh,
                 "Neg": np.negative, "Sqrt": np.sqrt, "Abs": np.abs,
                 "Sign": np.sign, "Floor": np.floor, "Ceil": np.ceil,
                 "Reciprocal": np.reciprocal}[op]
            r = f(a[0])
        elif op == "Sigmoid":
            r = 1.0 / (1.0 + np.exp(-a[0]))
        elif op == "Identity":
            r = a[0]
        elif op in ("ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd"):
            f = {"ReduceSum": np.sum, "ReduceMax": np.max,
                 "ReduceMin": np.min, "ReduceProd": np.prod}[op]
            # ReduceSum: axes as 2nd input (opset 13+); the others carry an
            # axes attribute at opset 17
            axes = (tuple(int(v) for v in a[1]) if len(a) > 1
                    else tuple(at.get("axes", [])) or None)
            r = f(a[0], axis=axes, keepdims=bool(at.get("keepdims", 1)))
        elif op == "Reshape":
            r = a[0].reshape([int(v) for v in a[1]])
        elif op == "Expand":
            r = np.broadcast_to(a[0], [int(v) for v in a[1]]).copy()
        elif op == "Transpose":
            r = np.transpose(a[0], at["perm"])
        elif op == "Cast":
            r = a[0].astype(_NP_DTYPES[at["to"]])
        elif op == "Where":
            r = np.where(a[0], a[1], a[2])
        elif op == "Conv":
            r = _conv(a[0].astype(np.float32), a[1].astype(np.float32), at)
        else:
            raise InvalidArgumentError("runtime: op %r unsupported" % op)
        env[nd["outputs"][0]] = r
    return [env[n] for n in out_names]
