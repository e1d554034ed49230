"""The port's optimizer module against the reference on the CPU: all
eleven update rules through the eager ``step()`` and through
``TrainStep``, with per-parameter ``optimize_attr``, regularizers (L1 and
L2), ``need_clip`` under a global-norm clip, ``apply_decay_param_fun``,
``lr_ratio``, exclusions and O2 master weights; ``state_dict`` round trips
and refusals; ``Lookahead`` and ``ModelAverage``; a scheduler stepped
between ``TrainStep`` calls; ``clear_grad`` and ``minimize``.

The hyperparameters are the reference's own optimizer test's
(``tests/test_nn.py:334-342``).  Inputs are made with numpy and handed to
both packages.  Tolerances: the eager updates 1e-6 absolute on O(1)
parameters after three steps (elementwise fp32 in another order, norms
summed in another order for Lamb, Lars and the clip); through
``TrainStep`` on a small MLP, losses 1e-5 relative and parameters 2e-5
absolute after three steps (the gradients agree to ~1e-7 relative, and an
update divides by a running RMS, which can turn that into a few 1e-6 on a
parameter), Ftrl's 1e-4 (``TRAIN_ATOL``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as ref_nn
from paddle_tpu import optimizer as ref_opt
from paddle_tpu.framework.tensor import Parameter as RefParameter
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.nn import functional as ref_F
from paddle_tpu.regularizer import L1Decay as RefL1, L2Decay as RefL2

from paddle_tpu_torch import (InvalidArgumentError, TrainStep, nn as port_nn,
                              optimizer)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

# the reference's tests/test_nn.py:334-342
HYPER = {
    "SGD": dict(learning_rate=0.1),
    "Momentum": dict(learning_rate=0.1, momentum=0.9),
    "Adam": dict(learning_rate=0.1),
    "AdamW": dict(learning_rate=0.1),
    "Adagrad": dict(learning_rate=0.5),
    "RMSProp": dict(learning_rate=0.05),
    "Adamax": dict(learning_rate=0.1),
    "Adadelta": dict(learning_rate=1.0, epsilon=1e-2),
    "Lamb": dict(learning_rate=0.05),
    "Lars": dict(learning_rate=0.5, lars_coeff=0.5),
    "Ftrl": dict(learning_rate=0.5, l2=1e-4),
}
# the optimizers whose constructor takes weight_decay (a regularizer), and
# those that keep float32 master weights
TAKES_DECAY = {"SGD", "Momentum", "Adam", "Adagrad", "Adadelta", "Adamax",
               "RMSProp", "Ftrl"}
MASTERS = ("SGD", "Momentum", "Adam", "AdamW", "Lamb", "Lars")
EXTRA = {
    "AdamW-decay-fun-ratio": ("AdamW", dict(
        weight_decay=0.05, apply_decay_param_fun=lambda n: n == "w0",
        lr_ratio=lambda p: 0.5 if tuple(p.shape) == (6,) else 1.0)),
    "Lamb-exclude": ("Lamb", dict(
        exclude_from_weight_decay_fn=lambda p: tuple(p.shape) == (6,))),
    "Lars-exclude": ("Lars", dict(exclude_from_weight_decay=["w1"])),
    "RMSProp-centered-momentum": ("RMSProp", dict(centered=True,
                                                  momentum=0.9)),
    "Adagrad-initial-accumulator": ("Adagrad",
                                    dict(initial_accumulator_value=0.1)),
    "Momentum-nesterov": ("Momentum", dict(use_nesterov=True)),
}
CASES = ([(n, "plain") for n in HYPER] + [(n, "attrs") for n in HYPER]
         + [(n, "o2") for n in MASTERS] + [(n, v) for v in EXTRA
                                           for n in [EXTRA[v][0]]])
SHAPES = [(4, 6), (6,), (3,)]
EAGER_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


class _Pkg:
    """One package's classes, so a case builds the same optimizer in
    both."""

    def __init__(self, ref):
        self.opt = ref_opt if ref else optimizer
        self.nn = ref_nn if ref else port_nn
        self.l1, self.l2 = (RefL1, RefL2) if ref else (L1Decay, L2Decay)


def _optimizer(pkg, name, variant, params):
    cls = name
    kw = dict(HYPER[name])
    if variant in EXTRA:
        cls, extra = EXTRA[variant]
        kw.update(extra)
    if variant == "attrs":
        kw["grad_clip"] = pkg.nn.ClipGradByGlobalNorm(0.5)
        if name in TAKES_DECAY:
            kw["weight_decay"] = pkg.l2(0.01)
    if variant == "o2":
        kw["multi_precision"] = True
    return getattr(pkg.opt, cls)(parameters=params, **kw)


def _set_attrs(pkg, params, variant):
    """Per-parameter attributes, where the reference reads them on its
    Parameter: a learning-rate ratio, an L1 regularizer, and a parameter
    the clip leaves alone."""
    if variant != "attrs":
        return
    params[1].optimize_attr = {"learning_rate": 0.5}
    params[2].regularizer = pkg.l1(0.02)
    params[0].need_clip = False


@pytest.mark.parametrize("name,variant", CASES,
                         ids=["%s-%s" % c for c in CASES])
def test_eager_step_matches_reference(name, variant):
    """Three eager steps from the same values and gradients; in the third
    one parameter has no gradient and is skipped by both."""
    rng = np.random.RandomState(len(name) * 7 + len(variant))
    bf16 = variant == "o2"
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    if bf16:  # the same bf16 values on both sides
        vals = [np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
                for v in vals]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    ref_ps = [RefParameter(jnp.asarray(v, jdt), name="w%d" % i)
              for i, v in enumerate(vals)]
    port_ps = [torch.nn.Parameter(_t(v).to(tdt)) for v in vals]
    for i, p in enumerate(port_ps):
        p.param_name = "w%d" % i
    _set_attrs(_Pkg(True), ref_ps, variant)
    _set_attrs(_Pkg(False), port_ps, variant)
    ref = _optimizer(_Pkg(True), name, variant, ref_ps)
    port = _optimizer(_Pkg(False), name, variant, port_ps)
    ptrs = [p.data_ptr() for p in port_ps]
    for s, step_grads in enumerate(grads):
        for i, (rp, pp, g) in enumerate(zip(ref_ps, port_ps, step_grads)):
            skip = s == 2 and i == 2
            rp._grad_val = None if skip else jnp.asarray(g, jdt)
            pp.grad = None if skip else _t(g).to(tdt)
        ref.step()
        port.step()
    assert [p.data_ptr() for p in port_ps] == ptrs  # updated in place
    for rp, pp in zip(ref_ps, port_ps):
        assert pp.dtype == tdt
        if bf16:  # the weight is its fp32 master rounded
            master = port._states[optimizer.param_name(pp)]["master_weight"]
            assert torch.equal(pp.detach(), master.to(torch.bfloat16))
            continue
        np.testing.assert_allclose(pp.detach().numpy(), np.asarray(rp.value),
                                   **EAGER_TOL)
    for rp, pp in zip(ref_ps, port_ps):
        want = ref._states[rp.name]
        got = port._states[optimizer.param_name(pp)]
        assert sorted(got) == sorted(want)
        for slot in want:
            np.testing.assert_allclose(
                got[slot].float().numpy(),
                np.asarray(want[slot].astype(jnp.float32)), err_msg=slot,
                **EAGER_TOL)


# -- through TrainStep --------------------------------------------------------


class _RefMLP(ref_nn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = ref_nn.Linear(8, 16)
        self.l2 = ref_nn.Linear(16, 4)

    def forward(self, x):
        return self.l2(ref_F.gelu(self.l1(x)))


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = port_nn.Linear(8, 16, device="cpu")
        self.l2 = port_nn.Linear(16, 4, device="cpu")

    def forward(self, x):
        return self.l2(F.gelu(self.l1(x)))


def _mlp_pair(seed=0):
    pt.seed(seed)
    ref = _RefMLP()
    port = _MLP()
    with torch.no_grad():
        for (n, rp), (m, pp) in zip(ref.named_parameters(),
                                    port.named_parameters()):
            assert n == m
            pp.copy_(_t(np.asarray(rp.value)))
    return ref, port


def _mlp_batches(n=3):
    rng = np.random.RandomState(11)
    return [(rng.randn(16, 8).astype(np.float32),
             rng.randint(0, 4, 16).astype(np.int32)) for _ in range(n)]


# Ftrl's weight is recomputed each step as -clip(linear) / quad, and
# ``linear`` accumulates g - sigma * w, which cancels: the forwards'
# gradient difference (~1e-7 relative) reaches ~1e-4 relative on a weight
TRAIN_ATOL = {"Ftrl": 1e-4}
TRAIN_CASES = [(n, v) for n in HYPER for v in ("plain", "attrs")]


@pytest.mark.parametrize("name,variant", TRAIN_CASES,
                         ids=["%s-%s" % c for c in TRAIN_CASES])
def test_train_step_matches_reference(name, variant):
    """Three ``TrainStep``s of a small MLP (cross entropy) with the same
    weights and batches: per-step losses and the final parameters."""
    ref, port = _mlp_pair()
    ref_ps = [p for _, p in ref.named_parameters()]
    port_ps = [p for _, p in port.named_parameters()]
    _set_attrs(_Pkg(True), ref_ps[1:], variant)
    _set_attrs(_Pkg(False), port_ps[1:], variant)
    ref_step = RefTrainStep(ref, lambda m, x, y: ref_F.cross_entropy(m(x), y),
                            _optimizer(_Pkg(True), name, variant, ref_ps))
    port_step = TrainStep(port, lambda m, x, y: F.cross_entropy(m(x), y),
                          _optimizer(_Pkg(False), name, variant, port_ps))
    for x, y in _mlp_batches():
        want = float(np.asarray(ref_step(pt.to_tensor(x),
                                         pt.to_tensor(y)).value))
        assert float(port_step(x, y)) == pytest.approx(want, rel=1e-5)
    for rp, pp in zip(ref_ps, port_ps):
        np.testing.assert_allclose(pp.detach().numpy(), np.asarray(rp.value),
                                   rtol=0, atol=TRAIN_ATOL.get(name, 2e-5))


def test_scheduler_stepped_between_train_step_calls():
    """The learning rate is written into the step's device scalar before
    each call: a ``StepDecay`` stepped between calls reaches the next
    step, as the reference reads ``get_lr()`` each call."""
    ref, port = _mlp_pair(seed=1)
    ref_sched = ref_opt.lr.StepDecay(0.5, step_size=1, gamma=0.1)
    port_sched = optimizer.lr.StepDecay(0.5, step_size=1, gamma=0.1)
    ref_step = RefTrainStep(ref, lambda m, x, y: ref_F.cross_entropy(m(x), y),
                            ref_opt.SGD(ref_sched,
                                        parameters=ref.parameters()))
    port_opt = optimizer.SGD(port_sched, parameters=port.parameters())
    port_step = TrainStep(port, lambda m, x, y: F.cross_entropy(m(x), y),
                          port_opt)
    before = [p.detach().clone() for p in port.parameters()]
    for x, y in _mlp_batches(4):
        ref_step(pt.to_tensor(x), pt.to_tensor(y))
        port_step(x, y)
        ref_sched.step()
        port_sched.step()
    assert float(port_step._lr) == pytest.approx(0.5e-3)
    for (_, rp), pp, p0 in zip(ref.named_parameters(), port.parameters(),
                               before):
        np.testing.assert_allclose(pp.detach().numpy(), np.asarray(rp.value),
                                   rtol=0, atol=1e-6)
        assert not torch.equal(pp, p0)


# -- state_dict -----------------------------------------------------------------


def _adam_with_state(names, lr=0.1):
    ps = []
    for n in names:
        p = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
        p.param_name = n
        ps.append(p)
    opt = optimizer.Adam(learning_rate=lr, parameters=ps)
    for p in ps:
        p.grad = 2 * p.detach()
    opt.step()
    return opt, ps


def test_state_dict_round_trip_matches_reference():
    """The reference's round trip (``tests/test_nn.py``): the keys are
    ``"<param>__<slot>"`` on both sides, a second optimizer loads them,
    and the next step agrees with the reference's continued run."""
    p = RefParameter(np.array([1.0, 2.0], np.float32), name="w0")
    ref = ref_opt.Adam(learning_rate=0.1, parameters=[p])
    p._grad_val = jnp.asarray([2.0, 4.0])
    ref.step()
    port, (q,) = _adam_with_state(["w0"])
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    q2 = torch.nn.Parameter(q.detach().clone())
    q2.param_name = "w0"
    port2 = optimizer.Adam(learning_rate=0.1, parameters=[q2])
    port2._state_for(q2)
    held = {k: v.data_ptr() for k, v in port2._states["w0"].items()}
    port2.set_state_dict(sd)
    # written into the existing state tensors: a captured step keeps them
    assert {k: v.data_ptr() for k, v in port2._states["w0"].items()} == held
    for slot, v in ref._states["w0"].items():
        np.testing.assert_allclose(port2._states["w0"][slot].numpy(),
                                   np.asarray(v), rtol=0, atol=1e-6)
    p._grad_val = jnp.asarray([2.0, 4.0])
    ref.step()
    q2.grad = torch.tensor([2.0, 4.0])
    port2.step()
    np.testing.assert_allclose(q2.detach().numpy(), np.asarray(p.value),
                               rtol=0, atol=1e-6)


def test_state_dict_carries_the_scheduler():
    sched = optimizer.lr.StepDecay(0.1, step_size=1)
    p = torch.nn.Parameter(torch.ones(2))
    opt = optimizer.Momentum(sched, parameters=[p])
    p.grad = torch.ones(2)
    opt.step()
    sched.step()
    sd = opt.state_dict()
    assert sd["LR_Scheduler"] == sched.state_dict()
    other = optimizer.lr.StepDecay(0.1, step_size=1)
    optimizer.Momentum(other, parameters=[p]).set_state_dict(sd)
    assert other() == pytest.approx(sched())


def test_state_dict_positional_fallback_and_refusals():
    """Names from another process differ by their counter: mapped by
    position.  Different counts, different stems, different slots or a
    shape mismatch are refused, as the reference refuses them."""
    src, _ = _adam_with_state(["param_7", "param_8"])
    sd = src.state_dict()
    dst, ps = _adam_with_state(["param_1", "param_2"], lr=0.5)
    dst.set_state_dict(sd)
    for a, b in (("param_7", "param_1"), ("param_8", "param_2")):
        for slot, v in src._states[a].items():
            assert torch.equal(dst._states[b][slot], v)
    three, _ = _adam_with_state(["param_1", "param_2", "param_3"])
    with pytest.raises(InvalidArgumentError, match="tracks 3 parameters"):
        three.set_state_dict(sd)
    stems, _ = _adam_with_state(["bias_1", "weight_2"])
    with pytest.raises(InvalidArgumentError, match="structural stems"):
        stems.set_state_dict(sd)
    slots, ps = _adam_with_state(["param_1", "param_2"])
    slots._states["param_1"]["extra"] = torch.zeros(())
    with pytest.raises(InvalidArgumentError, match="carries slots"):
        slots.set_state_dict(sd)
    bad = dict(sd)
    bad["param_7__moment1"] = torch.zeros(3)
    fresh, _ = _adam_with_state(["param_7", "param_8"])
    with pytest.raises(InvalidArgumentError, match="has shape"):
        fresh.set_state_dict(bad)


# -- Lookahead and ModelAverage (the reference's tests/test_nn.py) -------------


def test_lookahead_sync_semantics():
    p = torch.nn.Parameter(torch.tensor([10.0]))
    opt = optimizer.Lookahead(optimizer.SGD(1.0, parameters=[p]), alpha=0.5,
                              k=2)
    ptr = p.data_ptr()
    traj = []
    for _ in range(4):
        (p * 1.0).sum().backward()
        opt.step()
        opt.clear_grad()
        traj.append(float(p.detach()))
    # slow weights start at the initial 10: the first sync pulls 8 back
    # to 9, the second 7 to 8 (the reference's trajectory)
    assert traj == [9.0, 9.0, 8.0, 8.0], traj
    assert p.data_ptr() == ptr  # written in place


def test_lookahead_validates():
    inner = optimizer.SGD(1.0, parameters=[torch.nn.Parameter(
        torch.zeros(1))])
    with pytest.raises(InvalidArgumentError):
        optimizer.Lookahead(inner, alpha=2.0)
    with pytest.raises(InvalidArgumentError):
        optimizer.Lookahead(inner, k=0)
    with pytest.raises(InvalidArgumentError):
        optimizer.Lookahead(None)


def test_lookahead_composes_with_train_step_and_refuses_itself():
    """The reference's pattern: ``TrainStep`` steps the inner optimizer
    and ``sync()`` pulls the slow weights between steps; the wrapper
    itself is refused with ``NotImplementedError``, never quietly run as
    plain SGD; the eager wrapper still works beside it."""
    _, net = _mlp_pair(seed=2)
    opt = optimizer.Lookahead(optimizer.SGD(0.1,
                                            parameters=net.parameters()),
                              k=2)
    step = TrainStep(net, lambda m, x, y: F.cross_entropy(m(x), y),
                     opt.inner_opt)
    (x, y), = _mlp_batches(1)
    l0, l1 = float(step(x, y)), float(step(x, y))
    assert l1 < l0
    before = net.l1.weight.detach().clone()
    opt.sync()
    after_first_sync = net.l1.weight.detach().clone()
    assert not torch.allclose(after_first_sync, before)
    step(x, y)
    opt.sync()
    assert not torch.allclose(net.l1.weight, after_first_sync)
    with pytest.raises(NotImplementedError):
        TrainStep(net, lambda m, x_, y_: F.cross_entropy(m(x_), y_),
                  opt)(x, y)
    opt.clear_grad()
    loss = F.cross_entropy(net(_t(x)), _t(y))
    loss.backward()
    opt.step()
    opt.clear_grad(set_to_zero=False)


def test_lookahead_state_dict_restores_slow_weights():
    p = torch.nn.Parameter(torch.tensor([10.0]))
    opt = optimizer.Lookahead(optimizer.SGD(1.0, parameters=[p]), alpha=0.5,
                              k=2)
    for _ in range(3):
        (p * 1.0).sum().backward()
        opt.step()
        opt.clear_grad()
    sd = opt.state_dict()
    assert any(k.startswith("__lookahead_slow__") for k in sd)
    p2 = torch.nn.Parameter(p.detach().clone())
    opt2 = optimizer.Lookahead(optimizer.SGD(1.0, parameters=[p2]),
                               alpha=0.5, k=2)
    opt2.set_state_dict(sd)
    assert opt2._step_count == opt._step_count
    for i in opt._slow:
        assert torch.equal(opt2._slow[i], opt._slow[i])
    for o, q in ((opt, p), (opt2, p2)):
        (q * 1.0).sum().backward()
        o.step()
        o.clear_grad()
    assert torch.equal(p, p2)


def test_model_average_apply_restore():
    p = torch.nn.Parameter(torch.tensor([0.0]))
    ma = optimizer.ModelAverage(0.15, parameters=[p], min_average_window=2,
                                max_average_window=10)
    ptr = p.data_ptr()
    for v in (1.0, 2.0, 3.0):
        with torch.no_grad():
            p.fill_(v)
        ma.step()
    with ma.apply():
        inside = float(p.detach())
        assert p.data_ptr() == ptr  # the average is written in place
    assert 1.0 < inside < 3.0
    assert float(p.detach()) == 3.0 and p.data_ptr() == ptr
    with ma.apply(need_restore=False):
        pass
    assert float(p.detach()) == pytest.approx(inside)
    with pytest.raises(InvalidArgumentError):
        optimizer.ModelAverage(0.15)


def test_model_average_matches_reference():
    """The reference's window formula consults num_updates * rate: the
    averaged weights over four steps agree."""
    rp = RefParameter(np.array([0.0], np.float32))
    p = torch.nn.Parameter(torch.tensor([0.0]))
    ref = ref_opt.ModelAverage(0.5, parameters=[rp], min_average_window=1,
                               max_average_window=100)
    port = optimizer.ModelAverage(0.5, parameters=[p], min_average_window=1,
                                  max_average_window=100)
    for v in (1.0, 2.0, 3.0, 4.0):
        rp.set_value(np.array([v], np.float32))
        with torch.no_grad():
            p.fill_(v)
        ref.step()
        port.step()
    with ref.apply():
        want = float(np.asarray(rp.value)[0])
    with port.apply():
        got = float(p.detach())
    assert 2.0 < got < 4.0
    assert got == pytest.approx(want, rel=1e-6)


# -- clear_grad, minimize, the clip's empty norm --------------------------------


def test_clear_grad_and_minimize():
    p = torch.nn.Parameter(torch.tensor([1.0, -1.0]))
    opt = optimizer.SGD(0.5, parameters=[p])
    loss = (p * p).sum()
    assert opt.minimize(loss) == (None, None)  # backward + step
    torch.testing.assert_close(p.detach(), torch.tensor([0.0, 0.0]))
    grad = p.grad
    opt.clear_grad(set_to_zero=True)
    assert p.grad is grad and torch.equal(grad, torch.zeros(2))
    opt.clear_grad()
    assert p.grad is None


def test_global_norm_of_no_gradient_is_on_the_given_device():
    clip = port_nn.ClipGradByGlobalNorm(1.0)
    zero = clip.global_norm([None, None], device="meta")
    assert zero.device.type == "meta" and zero.dtype == torch.float32
    # bf16 and fp32 gradients: one float32 norm over both
    g = [torch.full((3,), 2.0, dtype=torch.bfloat16), torch.full((1,), 4.0)]
    torch.testing.assert_close(clip.global_norm(g),
                               torch.tensor(float(np.sqrt(12 + 16))))


def test_chunked_update_equals_one_list(monkeypatch):
    """A group updated in element-bounded chunks (``_CHUNK_ELEMS``, which
    bounds the update's temporaries) gives the one-list update's values
    bit for bit."""
    from paddle_tpu_torch.optimizer import _chunks

    rng = np.random.RandomState(5)
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    out = []
    for limit in (1 << 28, 7):
        monkeypatch.setattr(optimizer, "_CHUNK_ELEMS", limit)
        ps = [torch.nn.Parameter(_t(v)) for v in vals]
        opt = optimizer.Lamb(0.05, parameters=ps,
                             grad_clip=port_nn.ClipGradByGlobalNorm(0.5))
        for _ in range(2):
            for p, g in zip(ps, grads):
                p.grad = _t(g)
            opt.step()
        out.append([p.detach() for p in ps])
    assert [len(c) for c in _chunks(ps)] == [1, 1, 1]  # 24 > 7: one each
    for a, b in zip(*out):
        assert torch.equal(a, b)
