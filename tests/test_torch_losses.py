"""The port's twenty loss functions against the reference's on the CPU,
over their reductions: the same numpy inputs through
``paddle_tpu.nn.functional`` and ``paddle_tpu_torch.nn.functional``
(the reference's cases: ``tests/test_functional_extras.py:43-127, 243``
and ``tests/test_nn.py:133-144``), ``ctc_loss``'s gradient, warpctc's
``"mean"`` normalisation by label length, and each loss's autocast colour
(the black list's run in float32).

Tolerance: 1e-5 relative and 1e-6 absolute on values (fp32 formulas in
another order; torch's CTC against the reference's alpha scan), 1e-4 on
the CTC gradient (``GRAD_TOL``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as RF

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import amp

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
f32 = np.float32


def _sigmoid(x):
    return (1 / (1 + np.exp(-x))).astype(f32)


def _log_softmax(x, axis=-1):
    m = x - x.max(axis, keepdims=True)
    return (m - np.log(np.exp(m).sum(axis, keepdims=True))).astype(f32)


def _ctc_inputs(r):
    T, N, C, L = 12, 3, 6, 5
    return dict(log_probs=r.randn(T, N, C).astype(f32),
                labels=r.randint(1, C, (N, L)).astype(np.int32),
                input_lengths=np.array([12, 9, 7], np.int32),
                label_lengths=np.array([5, 3, 1], np.int32))


def _hsig(r, custom=False):
    n, d, k = 8, 6, 10
    kw = dict(input=r.randn(n, d).astype(f32),
              label=r.randint(0, k, (n,)).astype(np.int64), num_classes=k,
              weight=(r.randn(k - 1, d) * 0.5).astype(f32),
              bias=r.randn(k - 1).astype(f32))
    if custom:  # a custom tree: 3-node paths, -1 padding the short ones
        table = r.randint(0, k - 1, (n, 3)).astype(np.int64)
        table[::2, 2] = -1
        kw.update(path_table=table,
                  path_code=r.randint(0, 2, (n, 3)).astype(np.int64))
    return kw


# name -> (inputs from a RandomState, reductions; None: the function has no
# reduction argument)
CASES = {
    "log_loss": (lambda r: dict(input=_sigmoid(r.randn(6, 1)),
                                label=r.randint(0, 2, (6, 1)).astype(f32)),
                 [None]),
    "cross_entropy": (lambda r: dict(input=r.randn(6, 5).astype(f32),
                                     label=r.randint(0, 5, (6,))),
                      ["mean", "sum", "none"]),
    "softmax_with_cross_entropy": (
        lambda r: dict(logits=r.randn(6, 5).astype(f32),
                       label=r.randint(0, 5, (6, 1))), [None]),
    "nll_loss": (lambda r: dict(input=_log_softmax(r.randn(6, 5)),
                                label=np.array([0, 1, -100, 2, 4, 1]),
                                weight=r.rand(5).astype(f32) + 0.5),
                 ["mean", "sum", "none"]),
    "mse_loss": (lambda r: dict(input=r.randn(4, 3).astype(f32),
                                label=r.randn(4, 3).astype(f32)),
                 ["mean", "sum", "none"]),
    "l1_loss": (lambda r: dict(input=r.randn(4, 3).astype(f32),
                               label=r.randn(4, 3).astype(f32)),
                ["mean", "sum", "none"]),
    "smooth_l1_loss": (lambda r: dict(input=r.randn(4, 3).astype(f32) * 2,
                                      label=r.randn(4, 3).astype(f32),
                                      delta=0.7),
                       ["mean", "sum", "none"]),
    "bce_loss": (lambda r: dict(input=_sigmoid(r.randn(5, 2)),
                                label=r.randint(0, 2, (5, 2)).astype(f32),
                                weight=r.rand(5, 2).astype(f32)),
                 ["mean", "sum", "none"]),
    "binary_cross_entropy": (
        lambda r: dict(input=_sigmoid(r.randn(5, 2)),
                       label=r.randint(0, 2, (5, 2)).astype(f32)),
        ["mean", "sum", "none"]),
    "binary_cross_entropy_with_logits": (
        lambda r: dict(input=r.randn(5, 2).astype(f32) * 3,
                       label=r.randint(0, 2, (5, 2)).astype(f32),
                       pos_weight=r.rand(2).astype(f32) + 0.5),
        ["mean", "sum", "none"]),
    "kl_div": (lambda r: dict(input=_log_softmax(r.randn(4, 5)),
                              label=np.exp(_log_softmax(r.randn(4, 5)))),
               ["mean", "sum", "none", "batchmean"]),
    "margin_ranking_loss": (
        lambda r: dict(input=r.randn(6).astype(f32),
                       other=r.randn(6).astype(f32),
                       label=np.sign(r.randn(6)).astype(f32), margin=0.3),
        ["mean", "sum", "none"]),
    "hinge_embedding_loss": (
        lambda r: dict(input=r.randn(6).astype(f32),
                       label=np.sign(r.randn(6)).astype(f32)),
        ["mean", "sum", "none"]),
    "cosine_similarity": (lambda r: dict(x1=r.randn(4, 6).astype(f32),
                                         x2=r.randn(4, 6).astype(f32)),
                          [None]),
    "sigmoid_focal_loss": (
        lambda r: dict(logit=r.randn(6, 3).astype(f32),
                       label=r.randint(0, 2, (6, 3)).astype(f32),
                       normalizer=np.array([4.0], f32)),
        ["sum", "mean", "none"]),
    "square_error_cost": (lambda r: dict(input=r.randn(4, 3).astype(f32),
                                         label=r.randn(4, 3).astype(f32)),
                          [None]),
    "ctc_loss": (_ctc_inputs, ["mean", "sum", "none"]),
    "dice_loss": (lambda r: dict(
        input=np.exp(_log_softmax(r.randn(4, 3))),
        label=r.randint(0, 3, (4, 1)).astype(np.int64)), [None]),
    "npair_loss": (lambda r: dict(anchor=r.randn(6, 8).astype(f32),
                                  positive=r.randn(6, 8).astype(f32),
                                  labels=np.array([0, 0, 1, 1, 2, 2])),
                   [None]),
    "hsigmoid_loss": (_hsig, [None]),
}

PARAMS = [(name, red) for name, (_, reds) in CASES.items() for red in reds]


def _ref(name, kw):
    args = {k: pt.to_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    out = getattr(RF, name)(**args)
    return np.asarray(getattr(out, "value", out))


def _port(name, kw):
    args = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    return getattr(F, name)(**args).numpy()


def test_every_reference_loss_is_ported():
    assert len(CASES) == 20
    for name in CASES:
        assert callable(getattr(RF, name)) and callable(getattr(F, name))


@pytest.mark.parametrize("name,reduction", PARAMS,
                         ids=["%s-%s" % p for p in PARAMS])
def test_loss_matches_reference(name, reduction):
    kw = CASES[name][0](np.random.RandomState(3))
    if reduction is not None:
        kw["reduction"] = reduction
    want, got = _ref(name, kw), _port(name, kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_hsigmoid_custom_tree_matches_reference():
    kw = _hsig(np.random.RandomState(4), custom=True)
    np.testing.assert_allclose(_port("hsigmoid_loss", kw),
                               _ref("hsigmoid_loss", kw), rtol=RTOL,
                               atol=ATOL)


def test_ctc_loss_gradient_matches_reference():
    r = np.random.RandomState(0)
    T, N, C, L = 8, 2, 5, 3
    x = r.randn(T, N, C).astype(f32)
    labels = r.randint(1, C, (N, L)).astype(np.int32)
    il, ll = np.array([8, 6], np.int32), np.array([3, 2], np.int32)
    rx = pt.to_tensor(x)
    rx.stop_gradient = False
    RF.ctc_loss(rx, pt.to_tensor(labels), pt.to_tensor(il),
                pt.to_tensor(ll)).backward()
    tx = torch.from_numpy(x).requires_grad_()
    F.ctc_loss(tx, torch.from_numpy(labels), torch.from_numpy(il),
               torch.from_numpy(ll)).backward()
    g = tx.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    np.testing.assert_allclose(g, np.asarray(rx.grad.value), rtol=GRAD_TOL,
                               atol=GRAD_TOL)


def test_ctc_mean_normalizes_by_label_length():
    """warpctc's ``"mean"``: mean(loss / label_lengths), not a plain
    mean."""
    kw = _ctc_inputs(np.random.RandomState(0))
    per = _port("ctc_loss", dict(kw, reduction="none"))
    mean = _port("ctc_loss", dict(kw, reduction="mean"))
    np.testing.assert_allclose(mean, (per / kw["label_lengths"]).mean(),
                               rtol=1e-6)


BLACK = sorted(n for n in CASES if n in amp.BLACK_LIST)


@pytest.mark.parametrize("name", BLACK)
def test_black_listed_loss_runs_in_float32(name):
    """Under ``auto_cast`` bf16 a loss the black list names casts its
    floating inputs to float32, whatever their dtype."""
    kw = CASES[name][0](np.random.RandomState(5))
    args = {k: (torch.from_numpy(v).bfloat16() if v.dtype == f32
                else torch.from_numpy(v)) if isinstance(v, np.ndarray)
            else v for k, v in kw.items()}
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        out = getattr(F, name)(**args)
    out = out[0] if isinstance(out, tuple) else out
    assert out.dtype == torch.float32, (name, out.dtype)
