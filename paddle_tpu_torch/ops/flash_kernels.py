"""Flash-attention kernel K3 (forward and backward), its plain twins, its
launch counters and the ``torch.autograd.Function`` that joins them.

Counterpart of the library Pallas kernel the reference's
``ops/flash_attention.py`` calls (``jax.experimental.pallas.ops.tpu
.flash_attention`` with its ``custom_vjp``).  The kernels are hand-written
CUDA for Hopper (``csrc/flash_attention.cu``), built by ``ops/_build.py`` at
first launch and bound through a plain C interface.

Semantics are the reference's ``_reference_attention``: a masked score
(causal, top-left aligned; unequal segment ids) is *replaced* by
``finfo(float32).min`` and only then is the bias added, so a row whose keys
are all masked attends uniformly.  The forward's softmax statistics are
kept per row as the two terms of the log-sum-exp, ``(m, log l)``
([B, H, Lq, 2] fp32): for a fully masked row ``m`` is about finfo.min and
would swallow ``log l`` in one float.

Dispatch is by the device of the tensors alone, as in ``decode_kernels``:

- a CUDA tensor launches the kernel, or raises when the kernel cannot take
  the inputs -- there is no fallback;
- a CPU tensor runs the plain twin.  The backward twin is the flash
  backward written out in torch (P recomputed from the saved statistics,
  ``delta = rowsum(dO * O)``, dS, then dQ/dK/dV), not autograd through the
  forward, so the CPU tests check the backward algorithm itself.

Each wrapper counts its launches by the inputs' dtype in a dict attribute
(``flash_attention_forward_kernel.launches_by_dtype``), incremented only
where it launches on the card, so a caller can tell a bf16 training run
from one that ran K3 in float32; ``launch_counts()`` sums the dtypes.  The
backward wrapper counts one per call; a call launches its three kernels
(delta, dK/dV pass, dQ pass).  No captured CUDA graph runs K3 (the
captured steps are decode steps), so ``jit.aot``'s replays do not count
these wrappers.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.errors import ExternalError, InvalidArgumentError
from . import kernel_cost

__all__ = ["FlashAttentionFunction", "flash_attention_forward_kernel",
           "flash_attention_backward_kernel", "flash_attention_forward_plain",
           "flash_attention_backward_plain", "head_dim_and_dtype_supported",
           "kernel_takes", "MAX_HEAD_DIM", "reset_launch_counts",
           "launch_counts", "launch_counts_by_dtype"]

# head_dim: a multiple of 8 (the rule the port's kernels share, kept for
# vector loads) and at most 256 (the largest register tile the kernels
# instantiate)
MAX_HEAD_DIM = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def head_dim_and_dtype_supported(d: int, dtype) -> bool:
    """f32 or bf16, head_dim a multiple of 8 up to 256."""
    return dtype in _DTYPE_CODES and d % 8 == 0 and d <= MAX_HEAD_DIM


def _bias4(bias, b, h, lq, lk):
    """``bias`` viewed as 4-D [B|1, H|1, Lq|1, Lk|1] (leading axes added as
    in numpy broadcasting), or None when it does not broadcast to
    [B, H, Lq, Lk].  The kernels read a size-1 axis with stride 0."""
    if bias.ndim > 4:
        return None
    b4 = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape))
    for got, full in zip(b4.shape, (b, h, lq, lk)):
        if got not in (1, full):
            return None
    return b4


def kernel_takes(q, k, v, bias=None) -> bool:
    """The kernels' structural limits: 4-D q [B, H, Lq, D] and k/v
    [B, H, Lk, D] of one dtype (f32 or bf16), head_dim a multiple of 8 up to
    256, and a bias that broadcasts to [B, H, Lq, Lk]."""
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        return False
    b, h, lq, d = q.shape
    if tuple(k.shape[:2]) != (b, h) or k.shape[3] != d or k.shape[2] < 1 \
            or lq < 1:
        return False
    if k.dtype != q.dtype or v.dtype != q.dtype \
            or not head_dim_and_dtype_supported(d, q.dtype):
        return False
    return bias is None or _bias4(bias, b, h, lq, k.shape[2]) is not None


# -- plain twins ---------------------------------------------------------


def _allow(q_seg, kv_seg, causal: bool, lq: int, lk: int, device):
    """[B|1, 1, Lq, Lk] bool: where the raw score stands, or None."""
    allow = None
    if causal:
        allow = torch.ones(lq, lk, dtype=torch.bool,
                           device=device).tril()[None, None]
    if q_seg is not None:
        same = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        allow = same if allow is None else allow & same
    return allow


def _scores(q, k, bias, q_seg, kv_seg, causal, sm_scale):
    """fp32 scores after masking and bias, and the mask."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    allow = _allow(q_seg, kv_seg, causal, q.shape[2], k.shape[2], q.device)
    if allow is not None:
        s = s.masked_fill(~allow, torch.finfo(torch.float32).min)
    if bias is not None:
        s = s + bias.float()
    return s, allow


def flash_attention_forward_plain(q, k, v, bias=None, q_seg=None,
                                  kv_seg=None, causal: bool = False,
                                  sm_scale: float = 1.0):
    """Twin of the K3 forward: ``(o, stats)`` with ``o`` in q's dtype and
    ``stats`` [B, H, Lq, 2] fp32 = (row max m, log of the normaliser)."""
    s, _ = _scores(q, k, bias, q_seg, kv_seg, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p / l, v.float()).to(q.dtype)
    return o, torch.cat([m, torch.log(l)], dim=-1)


def flash_attention_backward_plain(q, k, v, o, stats, do, bias=None,
                                   q_seg=None, kv_seg=None,
                                   causal: bool = False,
                                   sm_scale: float = 1.0,
                                   bias_grad: bool = False):
    """Twin of the K3 backward: ``(dq, dk, dv, ds)`` with the gradients in
    their inputs' dtypes and ``ds`` [B, H, Lq, Lk] fp32 (the bias gradient
    before any broadcast sum) when ``bias_grad``, else None."""
    s, allow = _scores(q, k, bias, q_seg, kv_seg, causal, sm_scale)
    # (s - m) first: for a fully masked row it is exactly 0
    p = torch.exp((s - stats[..., :1]) - stats[..., 1:])
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2)) - delta)
    # a replaced score carries no gradient to q or k
    dsm = ds if allow is None else ds.masked_fill(~allow, 0.0)
    dq = torch.matmul(dsm, k.float()) * sm_scale
    dk = torch.matmul(dsm.transpose(-1, -2), q.float()) * sm_scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            ds if bias_grad else None)


# -- kernel wrappers -------------------------------------------------------


def _check_inputs(q, k, v, bias, q_seg, kv_seg):
    if not kernel_takes(q, k, v, bias):
        raise InvalidArgumentError(
            "flash kernel takes 4-D q [B, H, Lq, D] and k/v [B, H, Lk, D] of "
            "one dtype (float32 or bfloat16), head_dim a multiple of 8 up to "
            "%d and a bias that broadcasts to [B, H, Lq, Lk]; got q %r %s, "
            "k %r %s, v %r %s, bias %r"
            % (MAX_HEAD_DIM, tuple(q.shape), q.dtype, tuple(k.shape), k.dtype,
               tuple(v.shape), v.dtype,
               None if bias is None else tuple(bias.shape)))
    if (q_seg is None) != (kv_seg is None):
        raise InvalidArgumentError(
            "segment ids come as a pair (q_seg [B, Lq], kv_seg [B, Lk])")
    if q_seg is not None and (
            tuple(q_seg.shape) != (q.shape[0], q.shape[2])
            or tuple(kv_seg.shape) != (k.shape[0], k.shape[2])):
        raise InvalidArgumentError(
            "segment ids must be q_seg [B, Lq] = %r and kv_seg [B, Lk] = %r, "
            "got %r and %r" % ((q.shape[0], q.shape[2]),
                               (k.shape[0], k.shape[2]),
                               tuple(q_seg.shape), tuple(kv_seg.shape)))


def _unit_d(t):
    """``t`` with unit stride over its last axis (a copy only if not)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _strides(**named):
    """The kernels' host stride array: (batch, head, row) element strides
    of q, k, v, o, dout, dq, dk, dv, then the bias's four (0 on broadcast
    axes); absent operands leave zeros."""
    vals = [0] * 28
    for i, name in enumerate(("q", "k", "v", "o", "dout", "dq", "dk", "dv")):
        t = named.get(name)
        if t is not None:
            vals[3 * i:3 * i + 3] = t.stride()[:3]
    bias = named.get("bias")
    if bias is not None:
        vals[24:28] = [0 if n == 1 else st
                       for n, st in zip(bias.shape, bias.stride())]
    return (ctypes.c_longlong * 28)(*vals)


def _bias_arg(bias, q, k):
    if bias is None:
        return None
    b4 = _bias4(bias, q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    return b4.to(device=q.device, dtype=torch.float32)


def _seg_arg(seg, device):
    return None if seg is None else \
        seg.to(device=device, dtype=torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_card(q, named, what):
    if q.device.type != "cuda":
        raise InvalidArgumentError(
            "%s runs on cuda (or its plain twin on cpu), got %s"
            % (what, q.device))
    for name, t in named:
        if t is not None and t.device != q.device:
            raise InvalidArgumentError("%s: %s is on %s, q on %s"
                                       % (what, name, t.device, q.device))


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise ExternalError("%s launch failed: cudaError_t %d" % (what, rc))


def flash_attention_forward_kernel(q, k, v, bias=None, q_seg=None,
                                   kv_seg=None, causal: bool = False,
                                   sm_scale: float = 1.0):
    """K3 forward: ``(o, stats)`` for q [B, H, Lq, D] against k/v
    [B, H, Lk, D].  ``o`` has q's dtype and q's strides (a transposed head
    view gets a transposed output, so merging heads is free); ``stats`` is
    [B, H, Lq, 2] fp32.  CPU tensors run
    :func:`flash_attention_forward_plain`."""
    _check_inputs(q, k, v, bias, q_seg, kv_seg)
    if q.device.type == "cpu":
        return flash_attention_forward_plain(q, k, v, bias, q_seg, kv_seg,
                                             causal, sm_scale)
    _on_card(q, (("k", k), ("v", v), ("bias", bias), ("q_seg", q_seg),
                 ("kv_seg", kv_seg)), "flash_attention_forward_kernel")
    q, k, v = _unit_d(q), _unit_d(k), _unit_d(v)
    bias = _bias_arg(bias, q, k)
    q_seg, kv_seg = _seg_arg(q_seg, q.device), _seg_arg(kv_seg, q.device)
    from ._build import load

    lib = load("flash_attention")
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    stats = torch.empty(b, h, lq, 2, device=q.device, dtype=torch.float32)
    rc = lib.ptt_flash_attention_forward(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(bias), _ptr(q_seg), _ptr(kv_seg), out.data_ptr(),
        stats.data_ptr(), _strides(q=q, k=k, v=v, o=out, bias=bias), b, h,
        lq, k.shape[2], d, int(bool(causal)), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_attention_forward_kernel")
    flash_attention_forward_kernel.launches_by_dtype[
        _DTYPE_NAMES[q.dtype]] += 1
    kernel_cost.report(_forward_flops(q, k, causal), kernel_cost.nbytes(
        q, k, v, bias, q_seg, kv_seg, out, stats))
    return out, stats


def _forward_flops(q, k, causal: bool) -> float:
    """K3 forward's count for a step's cost report: ``4 B H Lq Lk D`` (the
    two products), halved when causal."""
    b, h, lq, d = q.shape
    return 4.0 * b * h * lq * k.shape[2] * d / (2 if causal else 1)


def flash_attention_backward_kernel(q, k, v, o, stats, do, bias=None,
                                    q_seg=None, kv_seg=None,
                                    causal: bool = False,
                                    sm_scale: float = 1.0,
                                    bias_grad: bool = False):
    """K3 backward: ``(dq, dk, dv, ds)`` from the forward's inputs, its
    output ``o`` and ``stats``, and the output gradient ``do``.  Launches
    three kernels on the current stream: delta = rowsum(dO * O), the dK/dV
    pass (grid over key tiles) and the dQ pass (grid over query tiles, which
    also writes ``ds`` [B, H, Lq, Lk] fp32 when ``bias_grad``).  CPU tensors
    run :func:`flash_attention_backward_plain`."""
    _check_inputs(q, k, v, bias, q_seg, kv_seg)
    if tuple(do.shape) != tuple(q.shape) or tuple(o.shape) != tuple(q.shape):
        raise InvalidArgumentError(
            "o and do must be shaped like q %r, got %r and %r"
            % (tuple(q.shape), tuple(o.shape), tuple(do.shape)))
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, stats, do, bias,
                                              q_seg, kv_seg, causal, sm_scale,
                                              bias_grad)
    _on_card(q, (("k", k), ("v", v), ("o", o), ("stats", stats), ("do", do),
                 ("bias", bias), ("q_seg", q_seg), ("kv_seg", kv_seg)),
             "flash_attention_backward_kernel")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if tuple(stats.shape) != (b, h, lq, 2) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise InvalidArgumentError(
            "stats must be the forward's contiguous [B, H, Lq, 2] float32, "
            "got %r %s" % (tuple(stats.shape), stats.dtype))
    q, k, v, o = _unit_d(q), _unit_d(k), _unit_d(v), _unit_d(o)
    do = _unit_d(do.to(q.dtype))
    bias = _bias_arg(bias, q, k)
    q_seg, kv_seg = _seg_arg(q_seg, q.device), _seg_arg(kv_seg, q.device)
    from ._build import load

    lib = load("flash_attention")
    code = _DTYPE_CODES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, h, lq, device=q.device, dtype=torch.float32)
    ds = (torch.empty(b, h, lq, lk, device=q.device, dtype=torch.float32)
          if bias_grad and bias is not None else None)
    strides = _strides(q=q, k=k, v=v, o=o, dout=do, dq=dq, dk=dk, dv=dv,
                       bias=bias)
    _raise_on(lib.ptt_flash_attention_bwd_delta(
        code, o.data_ptr(), do.data_ptr(), delta.data_ptr(), strides, b, h,
        lq, d, stream), "flash_attention_backward_kernel (delta)")
    common = (_ptr(bias), _ptr(q_seg), _ptr(kv_seg), do.data_ptr(),
              stats.data_ptr(), delta.data_ptr())
    _raise_on(lib.ptt_flash_attention_bwd_dkdv(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), *common,
        dk.data_ptr(), dv.data_ptr(), strides, b, h, lq, lk, d,
        int(bool(causal)), float(sm_scale), stream),
        "flash_attention_backward_kernel (dK/dV)")
    _raise_on(lib.ptt_flash_attention_bwd_dq(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), *common,
        dq.data_ptr(), _ptr(ds), strides, b, h, lq, lk, d,
        int(bool(causal)), float(sm_scale), stream),
        "flash_attention_backward_kernel (dQ)")
    flash_attention_backward_kernel.launches_by_dtype[
        _DTYPE_NAMES[q.dtype]] += 1
    # the backward's five products are 2.5x the forward's two
    kernel_cost.report(2.5 * _forward_flops(q, k, causal), kernel_cost.nbytes(
        q, k, v, o, stats, do, bias, q_seg, kv_seg, delta, dq, dk, dv, ds))
    return dq, dk, dv, ds


_WRAPPERS = {"flash_attention_forward_kernel": flash_attention_forward_kernel,
             "flash_attention_backward_kernel":
                 flash_attention_backward_kernel}


def reset_launch_counts() -> None:
    """Set every K3 wrapper's launch counts to 0."""
    for fn in _WRAPPERS.values():
        fn.launches_by_dtype = dict.fromkeys(_DTYPE_NAMES.values(), 0)


reset_launch_counts()


def launch_counts() -> dict:
    """{wrapper name: launches since the last reset}."""
    return {name: sum(fn.launches_by_dtype.values())
            for name, fn in _WRAPPERS.items()}


def launch_counts_by_dtype() -> dict:
    """{wrapper name: {"float32": n, "bfloat16": n}}: the launches since
    the last reset, by the inputs' dtype."""
    return {name: dict(fn.launches_by_dtype)
            for name, fn in _WRAPPERS.items()}


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable K3: the forward launches the K3 forward (or its twin
    on the CPU) and saves q, k, v, O and the statistics -- never P; the
    backward launches the K3 backward.  A bias gets a gradient only when it
    requires one (dS summed over its broadcast axes)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_seg, kv_seg, causal, sm_scale):
        o, stats = flash_attention_forward_kernel(q, k, v, bias, q_seg,
                                                  kv_seg, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, stats, bias, q_seg, kv_seg)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, stats, bias, q_seg, kv_seg = ctx.saved_tensors
        bias_grad = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, ds = flash_attention_backward_kernel(
            q, k, v, o, stats, do, bias, q_seg, kv_seg, ctx.causal,
            ctx.sm_scale, bias_grad)
        dbias = None
        if bias_grad:
            dbias = ds.sum_to_size(bias.shape).to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None
