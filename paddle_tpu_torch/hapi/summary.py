"""``summary`` and ``flops`` (counterpart of the reference's
``hapi/summary.py``): one forward under forward hooks on the leaf
layers, collecting each one's output shape, parameter count and
multiply-accumulate estimate by the reference's rules (the same counts
for the same network)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.errors import InvalidArgumentError

__all__ = ["summary", "flops"]


def _shape_of(out):
    if hasattr(out, "shape"):
        return list(tuple(out.shape))
    if isinstance(out, (tuple, list)) and out:
        return _shape_of(out[0])
    return []


def _device_of(net) -> torch.device:
    for p in net.parameters():
        return p.device
    return torch.device("cpu")


def _run_forward(net, input_size, input=None, dtypes=None):
    """The forward's inputs: ``input``, or numpy draws (seed 0) of
    ``input_size`` (``None``/-1 dims are 1) on the network's device."""
    if input is not None:
        return list(input) if isinstance(input, (tuple, list)) else [input]
    if input_size is None:
        raise InvalidArgumentError("summary/flops need input_size= or input=")
    sizes = input_size if isinstance(input_size, list) else [input_size]
    if sizes and not isinstance(sizes[0], (tuple, list)):
        sizes = [tuple(sizes)]
    dtypes = dtypes or ["float32"] * len(sizes)
    rng = np.random.RandomState(0)
    dev = _device_of(net)
    args = []
    for s, dt in zip(sizes, dtypes):
        s = tuple(1 if d is None or d == -1 else int(d) for d in s)
        if np.issubdtype(np.dtype(dt), np.integer):
            a = rng.randint(0, 2, s).astype(dt)
        else:
            a = rng.randn(*s).astype(dt)
        args.append(torch.from_numpy(a).to(dev))
    return args


def _collect(net, args, flop_fn=None):
    rows = []

    def mk_hook(name):
        def hook(lyr, inputs, outputs):
            n_params = sum(int(np.prod(p.shape))
                           for p in lyr.parameters(recurse=False))
            row = {"name": "%s (%s)" % (name or type(lyr).__name__,
                                        type(lyr).__name__),
                   "output_shape": _shape_of(outputs), "params": n_params}
            if flop_fn is not None:
                row["flops"] = flop_fn(lyr, inputs, outputs)
            rows.append(row)
        return hook

    hooks = [sub.register_forward_hook(mk_hook(name))
             for name, sub in net.named_modules()
             if not list(sub.children())]  # the leaves, as the reference
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*args)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()
    return rows


def summary(net, input_size=None, dtypes=None, input=None):
    """Print the per-layer table and totals; returns ``{"total_params",
    "trainable_params"}``."""
    rows = _collect(net, _run_forward(net, input_size, input, dtypes))
    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if p.requires_grad)
    width = max([len(r["name"]) for r in rows] + [20])
    lines = ["-" * (width + 40),
             "%-*s %-20s %12s" % (width, "Layer (type)", "Output Shape",
                                  "Param #"),
             "=" * (width + 40)]
    for r in rows:
        lines.append("%-*s %-20s %12s" % (
            width, r["name"], r["output_shape"], "{:,}".format(r["params"])))
    lines += ["=" * (width + 40),
              "Total params: {:,}".format(total),
              "Trainable params: {:,}".format(trainable),
              "Non-trainable params: {:,}".format(total - trainable),
              "-" * (width + 40)]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def _layer_flops(layer, inputs, outputs) -> int:
    """Multiply-accumulates of one leaf layer (the reference's rules: a
    convolution's output x kernel x input channels / groups, a Linear's
    output x in_features, 2 an output for a norm, 1 for the listed
    activations and pools, 0 otherwise)."""
    from ..nn.layer.conv import _ConvNd

    out_shape = _shape_of(outputs)
    n_out = int(np.prod(out_shape)) if out_shape else 0
    cls = type(layer).__name__
    if isinstance(layer, _ConvNd):
        k = int(np.prod(layer._kernel_size)) * layer._in_channels \
            // layer._groups
        return n_out * k
    if cls == "Linear":
        return n_out * int(layer.weight.shape[0])
    if "Norm" in cls:
        return 2 * n_out
    if cls in ("ReLU", "ReLU6", "LeakyReLU", "PReLU", "Sigmoid", "Tanh",
               "GELU", "Softmax"):
        return n_out
    if cls in ("AvgPool2D", "MaxPool2D", "AdaptiveAvgPool2D",
               "AdaptiveMaxPool2D"):
        return n_out
    return 0


def flops(net, input_size=None, dtypes=None, input=None,
          print_detail: bool = False) -> int:
    """The multiply-accumulates of one forward pass."""
    rows = _collect(net, _run_forward(net, input_size, input, dtypes),
                    flop_fn=_layer_flops)
    total = sum(r["flops"] for r in rows)
    if print_detail:
        for r in rows:
            print("%-40s %-20s %15s" % (r["name"], r["output_shape"],
                                        "{:,}".format(r["flops"])))
        print("Total FLOPs: {:,}".format(total))
    return int(total)
