"""The port's training path against the reference: losses, clips, LR
schedulers, optimizer updates, ``TrainStep`` and ``MultiStepTrainStep``.

Inputs are made with numpy and handed to both packages.  Tolerances, all
fp32: losses and clipped gradients 1e-6 relative (elementwise math in
another order); optimizer updates 1e-6 absolute on O(1) parameters after
three steps; the tiny model's TrainStep losses 1e-5 and parameters 2e-5
(its gradients agree to ~1e-6, and Adam's normalised step turns that into
at most a few 1e-6 per step on any parameter).
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
from paddle_tpu.models import TransformerLMCriterion as RefCriterion
from paddle_tpu.nn import functional as ref_F
from paddle_tpu.regularizer import L1Decay as RefL1, L2Decay as RefL2
from torch_parity import build_pair

from paddle_tpu_torch import (InvalidArgumentError, MultiStepTrainStep,
                              TrainStep, TransformerLM,
                              TransformerLMCriterion, optimizer)
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- losses -----------------------------------------------------------------

CE_CASES = {
    "mean": dict(),
    "ignore-index": dict(ignore=True),
    "weight": dict(weight=True, ignore=True),
    "weight-sum": dict(weight=True, reduction="sum"),
    "smoothing": dict(label_smoothing=0.1, ignore=True),
    "none": dict(reduction="none", ignore=True),
    "label-n1": dict(label_n1=True),
    "soft": dict(soft=True),
    "soft-smoothing": dict(soft=True, label_smoothing=0.2,
                           reduction="sum"),
    "probabilities": dict(use_softmax=False),
}


@pytest.mark.parametrize("name", list(CE_CASES))
def test_cross_entropy_matches_reference(name):
    c = CE_CASES[name]
    rng = np.random.RandomState(len(name))
    n, classes = 12, 7
    logits = rng.randn(n, classes).astype(np.float32)
    if not c.get("use_softmax", True):
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if c.get("soft"):
        label = rng.dirichlet(np.ones(classes), n).astype(np.float32)
    else:
        label = rng.randint(0, classes, n).astype(np.int64)
        if c.get("ignore"):
            label[[1, 5]] = -100
        if c.get("label_n1"):
            label = label[:, None]
    kw = dict(reduction=c.get("reduction", "mean"),
              soft_label=bool(c.get("soft")),
              use_softmax=c.get("use_softmax", True),
              label_smoothing=c.get("label_smoothing", 0.0))
    weight = rng.rand(classes).astype(np.float32) + 0.5 \
        if c.get("weight") else None
    want = ref_F.cross_entropy(
        jnp.asarray(logits), jnp.asarray(label),
        weight=None if weight is None else jnp.asarray(weight), **kw)
    got = F.cross_entropy(_t(logits), _t(label),
                          weight=None if weight is None else _t(weight), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def test_softmax_with_cross_entropy_matches_reference():
    rng = np.random.RandomState(1)
    logits = rng.randn(5, 4, 9).astype(np.float32)
    label = rng.randint(0, 9, (5, 4, 1))
    want_loss, want_sm = ref_F.softmax_with_cross_entropy(
        jnp.asarray(logits), jnp.asarray(label), return_softmax=True)
    got_loss, got_sm = F.softmax_with_cross_entropy(
        _t(logits), _t(label), return_softmax=True)
    assert tuple(got_loss.shape) == (5, 4, 1)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               **LOSS_TOL)
    np.testing.assert_allclose(got_sm.numpy(), np.asarray(want_sm),
                               **LOSS_TOL)
    with pytest.raises(InvalidArgumentError):
        F.cross_entropy(_t(logits[:, 0]), _t(label[:, 0, 0]),
                        reduction="avg")


@pytest.mark.parametrize("shift", [True, False])
def test_lm_criterion_matches_reference(shift):
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 6, 11).astype(np.float32)
    labels = rng.randint(0, 11, (2, 6))
    want = RefCriterion(shift_labels=shift)(pt.to_tensor(logits),
                                            pt.to_tensor(labels))
    got = TransformerLMCriterion(shift_labels=shift)(_t(logits), _t(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.value),
                               **LOSS_TOL)


# -- clips and schedulers -----------------------------------------------------


class _P:
    """A stand-in parameter: only ``need_clip`` is read by the clips."""

    def __init__(self, need_clip=True):
        self.need_clip = need_clip


@pytest.mark.parametrize("clip", ["value", "norm", "global", "global-big"])
def test_clips_match_reference(clip):
    rng = np.random.RandomState(3)
    grads = [rng.randn(4, 3).astype(np.float32) * 3,
             rng.randn(5).astype(np.float32), None,
             rng.randn(2, 2).astype(np.float32)]
    params = [_P(), _P(), _P(), _P(need_clip=False)]
    make = {"value": lambda m: m.ClipGradByValue(0.5, -0.3),
            "norm": lambda m: m.ClipGradByNorm(1.0),
            "global": lambda m: m.ClipGradByGlobalNorm(1.0),
            "global-big": lambda m: m.ClipGradByGlobalNorm(100.0)}[clip]
    want = make(ref_nn)([(p, None if g is None else jnp.asarray(g))
                         for p, g in zip(params, grads)])
    got = make(port_nn)([(p, None if g is None else _t(g))
                         for p, g in zip(params, grads)])
    for (_, w), (_, g) in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOSS_TOL)


SCHEDULERS = {
    "NoamDecay": dict(d_model=64, warmup_steps=3),
    "PiecewiseDecay": dict(boundaries=[2, 4], values=[0.1, 0.05, 0.01]),
    "NaturalExpDecay": dict(learning_rate=0.1, gamma=0.5),
    "InverseTimeDecay": dict(learning_rate=0.1, gamma=0.5),
    "PolynomialDecay": dict(learning_rate=0.1, decay_steps=5, cycle=True),
    "LinearWarmup": dict(learning_rate=0.1, warmup_steps=3, start_lr=0.0,
                         end_lr=0.1),
    "ExponentialDecay": dict(learning_rate=0.1, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.1, milestones=[2, 5]),
    "StepDecay": dict(learning_rate=0.1, step_size=2),
    "LambdaDecay": dict(learning_rate=0.1, lr_lambda=lambda e: 0.9 ** e),
    "CosineAnnealingDecay": dict(learning_rate=0.1, T_max=4),
    "OneCycleLR": dict(max_learning_rate=0.1, total_steps=8),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_lr_schedulers_match_reference(name):
    want = getattr(ref_opt.lr, name)(**SCHEDULERS[name])
    got = getattr(optimizer.lr, name)(**SCHEDULERS[name])
    for _ in range(8):
        assert got() == pytest.approx(want(), rel=1e-12)
        want.step()
        got.step()
    assert got.state_dict() == want.state_dict()


def test_reduce_on_plateau_matches_reference():
    want = ref_opt.lr.ReduceOnPlateau(learning_rate=0.1, patience=1)
    got = optimizer.lr.ReduceOnPlateau(learning_rate=0.1, patience=1)
    for metric in (1.0, 0.9, 0.95, 0.96, 0.97, 0.5):
        want.step(metric)
        got.step(metric)
        assert got() == pytest.approx(want(), rel=1e-12)


# -- optimizer updates -------------------------------------------------------

OPT_CASES = {
    "sgd": ("SGD", dict()),
    "sgd-l2": ("SGD", dict(weight_decay=0.1)),
    "momentum": ("Momentum", dict(momentum=0.8)),
    "momentum-nesterov-l1": ("Momentum", dict(momentum=0.8,
                                              use_nesterov=True,
                                              weight_decay="l1")),
    "adam": ("Adam", dict(beta1=0.8, beta2=0.9)),
    "adam-l2-clip": ("Adam", dict(weight_decay="l2", grad_clip="global")),
    "adamw": ("AdamW", dict(weight_decay=0.05)),
    "adamw-decay-fun-ratio": ("AdamW", dict(
        weight_decay=0.05, apply_decay_param_fun="w0",
        lr_ratio="half-bias")),
    "adamw-multi-precision-bf16": ("AdamW", dict(multi_precision=True)),
}


def _opt_kwargs(kw, pkg_nn, reg_mod):
    kw = dict(kw)
    if kw.get("weight_decay") == "l1":
        kw["weight_decay"] = reg_mod[0](0.01)
    elif kw.get("weight_decay") == "l2":
        kw["weight_decay"] = reg_mod[1](0.01)
    if kw.get("grad_clip") == "global":
        kw["grad_clip"] = pkg_nn.ClipGradByGlobalNorm(0.5)
    if "apply_decay_param_fun" in kw:
        kw["apply_decay_param_fun"] = lambda n: n == "w0"
    if "lr_ratio" in kw:
        kw["lr_ratio"] = lambda p: 0.5 if tuple(p.shape) == (6,) else 1.0
    return kw


@pytest.mark.parametrize("name", list(OPT_CASES))
def test_optimizer_updates_match_reference(name):
    cls, kw = OPT_CASES[name]
    rng = np.random.RandomState(len(name))
    bf16 = name.endswith("bf16")  # bf16 weights: fp32 master weights
    vals = [rng.randn(4, 6).astype(np.float32), rng.randn(6).astype(
        np.float32)]
    grads = [[rng.randn(*v.shape).astype(np.float32) for v in vals]
             for _ in range(3)]
    if bf16:  # the same bf16 values on both sides
        vals = [np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
                for v in vals]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    ref_params = [RefParameter(jnp.asarray(v, jdt), name="w%d" % i)
                  for i, v in enumerate(vals)]
    ref = getattr(ref_opt, cls)(
        learning_rate=0.1, parameters=ref_params,
        **_opt_kwargs(kw, ref_nn, (RefL1, RefL2)))
    port_params = [torch.nn.Parameter(_t(v).to(tdt)) for v in vals]
    for i, p in enumerate(port_params):
        p.param_name = "w%d" % i
    port = getattr(optimizer, cls)(
        learning_rate=0.1, parameters=port_params,
        **_opt_kwargs(kw, port_nn, (L1Decay, L2Decay)))
    states = [ref._state_for(p) for p in ref_params]
    cur = [p.value for p in ref_params]
    for step_grads in grads:
        cur, states = ref._functional_step(
            ref_params, cur, [jnp.asarray(g, jdt) for g in step_grads],
            states, jnp.asarray(0.1, jnp.float32))
        port._functional_step(port_params,
                              [_t(g).to(tdt) for g in step_grads],
                              port.get_lr())
    for want, got in zip(cur, port_params):
        assert got.dtype == tdt
        if bf16:  # the weight is its fp32 master rounded, compared below
            master = port._states[optimizer.param_name(got)]["master_weight"]
            assert torch.equal(got.detach(), master.to(torch.bfloat16))
            continue
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)
    for want, p in zip(states, port_params):
        got = port._states[optimizer.param_name(p)]
        assert sorted(got) == sorted(want)
        for slot in want:
            np.testing.assert_allclose(
                got[slot].float().numpy(),
                np.asarray(want[slot].astype(jnp.float32)), rtol=0,
                atol=1e-6)


# -- train steps -------------------------------------------------------------


def _lm_loss(crit):
    return lambda model, ids: crit(model(ids), ids)


def _batch(seed=0, steps=None):
    rng = np.random.RandomState(seed)
    shape = (2, 12) if steps is None else (steps, 2, 12)
    return rng.randint(0, 512, shape)


def test_train_steps_match_reference():
    """Three AdamW steps with global-norm clipping on the tiny model:
    per-step losses and the final parameters."""
    ref, port = build_pair(seed=4)
    ref.train()
    port.train()
    ref_step = RefTrainStep(ref, _lm_loss(RefCriterion()), ref_opt.AdamW(
        1e-3, parameters=ref.parameters(), weight_decay=0.01,
        grad_clip=ref_nn.ClipGradByGlobalNorm(1.0)))
    port_step = TrainStep(port, _lm_loss(TransformerLMCriterion()),
                          optimizer.AdamW(
                              1e-3, parameters=port.parameters(),
                              weight_decay=0.01,
                              grad_clip=port_nn.ClipGradByGlobalNorm(1.0)))
    for s in range(3):
        ids = _batch(s)
        want = float(np.asarray(ref_step(pt.to_tensor(ids.astype(
            np.int32))).value))
        got = port_step(ids)
        assert got.shape == () and not got.requires_grad
        assert float(got) == pytest.approx(want, rel=1e-5)
    ref_params = {n: np.asarray(p.value) for n, p in ref.named_parameters()}
    for n, p in port.named_parameters():
        got = p.detach().numpy()
        if n.endswith("k_proj.bias"):
            # its exact gradient is 0 (softmax ignores a shift of every key
            # by one vector): both sides' gradients are rounding noise, which
            # Adam normalises to steps of up to lr each -- so bound it
            assert np.abs(got).max() <= 3 * 1e-3 * (1 + 1e-6), n
            continue
        np.testing.assert_allclose(got, ref_params[n], rtol=0, atol=2e-5,
                                   err_msg=n)


def _twin_models(seed=5):
    _, a = build_pair(seed=seed)
    _, b = build_pair(seed=seed)
    return a, b


def _adamw(model):
    return optimizer.AdamW(1e-3, parameters=model.parameters(),
                           grad_clip=port_nn.ClipGradByGlobalNorm(1.0))


def test_multi_step_equals_k_train_steps():
    a, b = _twin_models()
    crit = TransformerLMCriterion()
    batches = _batch(1, steps=3)
    multi = MultiStepTrainStep(a, _lm_loss(crit), _adamw(a),
                               steps_per_call=3)
    single = TrainStep(b, _lm_loss(crit), _adamw(b))
    losses = multi(batches)
    assert tuple(losses.shape) == (3,)
    want = [float(single(batches[k])) for k in range(3)]
    np.testing.assert_allclose(losses.numpy(), want, rtol=1e-6)
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=1e-6)


def test_multi_step_shape_errors():
    _, a = build_pair(seed=6)
    crit = TransformerLMCriterion()
    multi = MultiStepTrainStep(a, _lm_loss(crit), _adamw(a),
                               steps_per_call=3)
    with pytest.raises(InvalidArgumentError, match="leading dim 2 != K=3"):
        multi(_batch(0))  # an unstacked [batch, L] input
    with pytest.raises(InvalidArgumentError, match="is a scalar"):
        multi(3)
    with pytest.raises(InvalidArgumentError, match="steps_per_call"):
        MultiStepTrainStep(a, _lm_loss(crit), _adamw(a), steps_per_call=0)


def test_eager_step_equals_train_step():
    a, b = _twin_models(seed=7)
    crit = TransformerLMCriterion()
    opt_a = _adamw(a)
    step = TrainStep(b, _lm_loss(crit), _adamw(b))
    for s in range(2):
        ids = _batch(s)
        loss = crit(a(_t(ids)), _t(ids))
        loss.backward()
        opt_a.step()
        opt_a.clear_grad()
        assert all(p.grad is None for p in a.parameters())
        torch.testing.assert_close(step(ids), loss.detach(), rtol=0,
                                   atol=1e-6)
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=1e-6)


def test_train_step_refuses_foreign_parameters():
    a, b = _twin_models(seed=8)
    with pytest.raises(InvalidArgumentError, match="not parameters"):
        TrainStep(a, _lm_loss(TransformerLMCriterion()),
                  optimizer.SGD(0.1, parameters=b.parameters()))


def test_token_type_embeddings_carry_and_match_reference():
    """An ERNIE-style model (token types on): ``load_reference_params``
    carries ``token_type_embeddings`` and the logits agree (fp32, 1e-4 as
    the other model tests)."""
    ref, port = build_pair(seed=9, type_vocab_size=4, causal=False)
    assert port.token_type_embeddings is not None
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 10))
    types = rng.randint(0, 4, (2, 10))
    want = np.asarray(ref(pt.to_tensor(ids.astype(np.int32)),
                          token_type_ids=pt.to_tensor(types.astype(
                              np.int32))).value)
    with torch.no_grad():
        got = port(_t(ids), token_type_ids=_t(types)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_flops_per_token_matches_reference():
    from paddle_tpu.models import TransformerLM as RefLM

    cfg = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position=128)
    port = TransformerLM(**cfg, device="cpu")
    assert port.flops_per_token(96) == RefLM(**cfg).flops_per_token(96)
