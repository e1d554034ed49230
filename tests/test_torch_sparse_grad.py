"""Row-sparse embedding gradients and the lazy row updates of the port
against the reference on the CPU: every case of
``tests/test_sparse_grad.py``, then lazy Adam against the reference's lazy
Adam on the same weights and ids, untouched rows and moments bit for bit,
``padding_idx``'s zero output whatever the row holds, and the rule that a
sparse embedding under ``TrainStep`` trains on its dense gradient.

The port's carrier is torch's sparse COO gradient in ``p.grad``
(``framework/sparse.py``).  Inputs are made with numpy and handed to both
packages; embedding weights cross as numpy.  Tolerances: one update of
the same fp32 formula 1e-6 relative (``RTOL``); the reference's own
lazy-against-dense check 1e-5; untouched rows exact.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.sparse import SparseGrad as RefSparseGrad

from paddle_tpu_torch import TrainStep, amp, optimizer
from paddle_tpu_torch.framework import sparse
from paddle_tpu_torch.framework.sparse import SparseGrad
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Embedding
from paddle_tpu_torch.nn import functional as F

RTOL = 1e-6


def _emb(n, d, seed=0, **kw):
    return Embedding(n, d, device="cpu",
                     generator=torch.Generator().manual_seed(seed), **kw)


def _ids(rows):
    return torch.tensor(np.asarray(rows, np.int64))


# -- the reference's cases ---------------------------------------------------


def test_sparse_grad_algebra():
    g1 = SparseGrad([0, 2], np.ones((2, 3), np.float32), (4, 3))
    g2 = SparseGrad([2, 3], np.ones((2, 3), np.float32) * 2, (4, 3))
    s = (g1 + g2).coalesce()
    expected = np.zeros((4, 3), np.float32)
    expected[0] = 1
    expected[2] = 3
    expected[3] = 2
    np.testing.assert_array_equal(s.to_dense().numpy(), expected)
    assert (g1 + None) is g1  # the engine's accumulation identity
    np.testing.assert_array_equal((g1 * 2.0).to_dense().numpy(),
                                  2 * g1.to_dense().numpy())
    np.testing.assert_array_equal((g2 / 2.0).to_dense().numpy(),
                                  g2.to_dense().numpy() / 2)
    # the same algebra as the reference's SparseGrad
    r = (RefSparseGrad([0, 2], np.ones((2, 3), np.float32), (4, 3))
         + RefSparseGrad([2, 3], np.ones((2, 3), np.float32) * 2,
                         (4, 3))).coalesce()
    np.testing.assert_array_equal(s.indices.numpy(), np.asarray(r.indices))
    np.testing.assert_array_equal(s.values.numpy(), np.asarray(r.values))


def test_sparse_embedding_backward_is_sparse():
    emb = _emb(1000, 8, sparse=True)
    ids = _ids([[1, 5, 5], [7, 1, 3]])
    emb(ids).sum().backward()
    g = SparseGrad(emb.weight.grad)
    assert emb.weight.grad.is_sparse
    assert tuple(g.values.shape) == (6, 8) and g.dense_shape == (1000, 8)
    # the same math as the dense path
    emb_d = _emb(1000, 8, sparse=False)
    emb_d(ids).sum().backward()
    np.testing.assert_allclose(g.to_dense().numpy(),
                               emb_d.weight.grad.numpy(), rtol=RTOL)


@pytest.mark.parametrize("sparse_grad", [True, False])
def test_sparse_embedding_padding_idx(sparse_grad):
    emb = _emb(50, 4, padding_idx=0, sparse=sparse_grad)
    out = emb(_ids([[0, 3]]))
    np.testing.assert_array_equal(out.detach().numpy()[0, 0], np.zeros(4))
    out.sum().backward()
    dense = sparse.dense_grad(emb.weight).numpy()
    np.testing.assert_array_equal(dense[0], np.zeros(4))  # pad row: no grad
    assert np.abs(dense[3]).sum() > 0


def test_padding_output_is_zero_whatever_the_row_holds():
    """The reference masks the output (``jnp.where``), where torch's
    ``padding_idx`` only withholds the gradient: a non-zero pad row still
    reads as zeros, in both packages, on the same weights."""
    w = np.random.RandomState(0).randn(10, 4).astype(np.float32) + 1.0
    ids = np.array([[2, 2, 5, 9]], np.int64)
    want = np.asarray(pt.nn.functional.embedding(
        pt.to_tensor(ids), pt.to_tensor(w), padding_idx=2).value)
    for sparse_grad in (False, True):
        got = F.embedding(_ids(ids), torch.from_numpy(w), padding_idx=2,
                          sparse=sparse_grad)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[0, :2].any() and got[0, 2:].all()


@pytest.mark.parametrize("opt_name,kwargs", [
    ("SGD", {}),
    ("Adam", {"lazy_mode": True}),
])
def test_lazy_update_touches_only_seen_rows(opt_name, kwargs):
    emb = _emb(100, 4, sparse=True)
    w_before = emb.weight.detach().clone()
    opt = getattr(optimizer, opt_name)(0.1, parameters=emb.parameters(),
                                       **kwargs)
    emb(_ids([[2, 7]])).sum().backward()
    opt.step()
    changed = (emb.weight.detach() - w_before).abs().sum(dim=1) > 0
    assert changed[2] and changed[7]
    assert int(changed.sum()) == 2  # every other row untouched


def _lazy_run(sparse_grad, lazy, steps=3):
    emb = _emb(60, 4, sparse=sparse_grad)
    opt = optimizer.Adam(0.05, parameters=emb.parameters(), lazy_mode=lazy)
    for _ in range(steps):
        emb(_ids([[4, 9, 4]])).sum().backward()
        opt.step()
        opt.clear_grad()
    return emb, opt


def test_lazy_adam_matches_dense_adam_on_touched_rows():
    w_lazy = _lazy_run(True, True)[0].weight.detach().numpy()
    w_dense = _lazy_run(False, False)[0].weight.detach().numpy()
    # touched rows follow the same Adam math (duplicate rows coalesced)
    np.testing.assert_allclose(w_lazy[[4, 9]], w_dense[[4, 9]], rtol=1e-5)


def test_sparse_densifies_under_clip_and_nonlazy():
    emb = _emb(40, 4, sparse=True)
    w_before = emb.weight.detach().clone()
    opt = optimizer.Adam(0.05, parameters=emb.parameters(),
                         grad_clip=ClipGradByGlobalNorm(1.0))
    emb(_ids([[1, 2]])).sum().backward()
    opt.step()  # densified for the clip and the (non-lazy) update
    assert torch.isfinite(emb.weight).all()
    # the dense Adam step moves no untouched row on its first step (their
    # moments and gradients are 0), but it did run densely: every row's
    # moment exists and the untouched ones are exactly 0
    st = opt._states[optimizer.param_name(emb.weight)]
    assert not st["moment1"][0].any() and st["moment1"][1].any()
    assert torch.equal(emb.weight.detach()[3:], w_before[3:])


def test_sparse_embedding_under_trainstep_trains_dense():
    """The reference's documented rule for its compiled step: a sparse
    embedding under ``TrainStep`` trains on its dense gradient (a
    row-sparse gradient cannot be captured); the optimizer's update sees
    no sparse gradient, and the loss falls."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(_emb(30, 4, sparse=True),
                                torch.nn.Flatten(), torch.nn.Linear(8, 2))
    opt = optimizer.Adam(0.05, parameters=model.parameters())
    seen = []
    apply = opt._functional_step

    def recording(params, grads, lr):
        seen.extend(g.is_sparse for g in grads)
        return apply(params, grads, lr)

    opt._functional_step = recording
    step = TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y), opt,
                     donate=False)
    ids = np.array([[1, 2], [3, 4]], np.int64)
    y = np.array([0, 1], np.int64)
    l0 = float(step(ids, y))
    l1 = float(step(ids, y))
    assert l1 < l0
    assert seen and not any(seen)
    # outside the step the same layer gives its sparse gradient again
    model[0](_ids([[1]])).sum().backward()
    assert model[0].weight.grad.is_sparse


def test_public_grad_view_densifies():
    emb = _emb(30, 4, sparse=True)
    emb(_ids([[1, 2]])).sum().backward()
    assert list(emb.weight.grad.shape) == [30, 4]  # the raw carrier's
    g = sparse.dense_grad(emb.weight)
    assert not g.is_sparse and list(g.shape) == [30, 4]
    assert g.abs().sum() > 0


def test_sparse_with_grad_scaler():
    emb = _emb(30, 4, sparse=True)
    opt = optimizer.Adam(0.05, parameters=emb.parameters(), lazy_mode=True)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    w_before = emb.weight.detach().clone()
    loss = emb(_ids([[1, 2]])).sum()
    scaler.scale(loss).backward()
    scaler.unscale_(opt)
    # the values were unscaled in place and stay sparse
    assert emb.weight.grad.is_sparse
    np.testing.assert_allclose(sparse.dense_grad(emb.weight)[1:3].numpy(),
                               np.ones((2, 4)), rtol=RTOL)
    scaler.step(opt)
    scaler.update()
    changed = (emb.weight.detach() - w_before).abs().sum(dim=1) > 0
    assert changed[1] and changed[2] and int(changed.sum()) == 2


def test_adamw_sparse_respects_lr_ratio():
    def run(ratio):
        emb = _emb(30, 4, sparse=True)
        opt = optimizer.AdamW(0.05, parameters=emb.parameters(),
                              lazy_mode=True, weight_decay=0.0,
                              lr_ratio=lambda p: ratio)
        emb(_ids([[3]])).sum().backward()
        opt.step()
        return emb.weight.detach()

    ref = _emb(30, 4, sparse=True).weight.detach()
    assert not torch.allclose(run(1.0)[3], ref[3])
    assert torch.equal(run(0.0), ref)  # a zero ratio: no update at all


# -- against the reference ---------------------------------------------------


@pytest.fixture(scope="module")
def reference_lazy_adam():
    """The reference's lazy Adam, 3 steps on ids [[4, 9, 4]] then [[9, 1]]
    from a seed-0 table: (initial weights, final weights)."""
    pt.seed(0)
    emb = pt.nn.Embedding(60, 4, sparse=True)
    w0 = np.asarray(emb.weight.value).copy()
    opt = pt.optimizer.Adam(0.05, parameters=emb.parameters(),
                            lazy_mode=True)
    for ids in ([[4, 9, 4]], [[9, 1]], [[4, 9, 4]]):
        emb(pt.to_tensor(np.asarray(ids, np.int64))).sum().backward()
        opt.step()
        opt.clear_grad()
    return w0, np.asarray(emb.weight.value)


def test_lazy_adam_matches_reference(reference_lazy_adam):
    w0, want = reference_lazy_adam
    emb = Embedding(60, 4, sparse=True, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(w0))
    opt = optimizer.Adam(0.05, parameters=emb.parameters(), lazy_mode=True)
    for ids in ([[4, 9, 4]], [[9, 1]], [[4, 9, 4]]):
        emb(_ids(ids)).sum().backward()
        opt.step()
        opt.clear_grad()
    got = emb.weight.detach().numpy()
    touched = [1, 4, 9]
    np.testing.assert_allclose(got[touched], want[touched], rtol=RTOL)
    untouched = np.setdiff1d(np.arange(60), touched)
    np.testing.assert_array_equal(got[untouched], w0[untouched])
    np.testing.assert_array_equal(want[untouched], w0[untouched])


@pytest.mark.parametrize("opt_name", ["SGD", "Adam", "AdamW"])
def test_untouched_rows_and_moments_bit_identical(opt_name):
    """Two lazy steps on rows {3, 7} then {7, 11}: every other row of the
    weight and of each moment holds its exact bytes; the beta powers
    advance once a step for the whole parameter."""
    kw = {} if opt_name == "SGD" else {"lazy_mode": True}
    if opt_name == "AdamW":
        kw["weight_decay"] = 0.0
    emb = _emb(64, 8, sparse=True)
    opt = getattr(optimizer, opt_name)(0.1, parameters=emb.parameters(),
                                       **kw)
    w0 = emb.weight.detach().clone()
    emb(_ids([[3, 7]])).sum().backward()
    opt.step()
    opt.clear_grad()
    st = opt._states.get(optimizer.param_name(emb.weight), {})
    moments = {k: v.clone() for k, v in st.items() if v.ndim == 2}
    w1 = emb.weight.detach().clone()
    emb(_ids([[7, 11]])).sum().backward()
    opt.step()
    keep = [r for r in range(64) if r not in (3, 7, 11)]
    assert torch.equal(emb.weight.detach()[keep], w0[keep])
    assert torch.equal(emb.weight.detach()[3], w1[3])  # not met this step
    for k, before in moments.items():
        now = st[k]
        assert torch.equal(now[keep], torch.zeros_like(now[keep])), k
        assert torch.equal(now[3], before[3]), k
        assert now[11].any() and now[7].ne(before[7]).any(), k
    if opt_name != "SGD":
        np.testing.assert_allclose(float(st["beta1_pow"]), 0.9 ** 2,
                                   rtol=RTOL)


def test_o2_master_weight_densifies():
    """A parameter with an O2 master weight takes the dense path (the
    reference's ``_supports_sparse`` refuses it): its master and model
    weight stay in step."""
    emb = _emb(20, 4, sparse=True)
    opt = optimizer.Adam(0.05, parameters=emb.parameters(), lazy_mode=True)
    emb, opt = amp.decorate(emb, opt, level="O2", dtype="bfloat16")
    emb(_ids([[2, 5]])).float().sum().backward()
    assert emb.weight.grad.is_sparse
    opt.step()
    st = opt._states[optimizer.param_name(emb.weight)]
    assert "master_weight" in st
    assert torch.equal(st["master_weight"].to(torch.bfloat16),
                       emb.weight.detach())
