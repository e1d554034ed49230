"""The port's mixed precision (``paddle_tpu_torch.amp``, the autocast shim
of ``framework/dispatch.py``, ``core/flags.py`` and ``core/amp_state.py``)
against the reference's ``paddle_tpu.amp``, on the CPU.

Inputs and weights are made with numpy (or by the reference at a seed and
carried across) and handed to both packages.  Tolerances:

- ops under autocast: the same dtype on both sides, and values within
  ``OP_TOL`` (2e-2 absolute on O(1) outputs: one bf16 rounding is 2^-8
  relative, and the two sides may round a product's sum at another point);
- ``layer_norm`` on a bf16 input: bit for bit (the statistics are float32
  sums of the same values, rounded where the reference rounds them);
- small eager trainings (a Linear stack, the GradScaler cases): losses
  within 1e-3 relative and weights within 1e-4 absolute (float32 masters,
  bf16 products: each side rounds the same products once);
- the main path (``TrainStep`` over the tiny ``TransformerLM``, O2 bf16,
  AdamW at the reference's training rate 1e-4): per-step losses within
  ``MAIN_LOSS_RTOL`` = 1e-3 relative, and the float32 masters within
  ``MAIN_MASTER_RATIO`` = 0.2 of how far they moved (||port - ref|| over
  ||ref - initial||, all parameters together).  bf16 rounding of the
  gradients flips the sign of Adam's step on near-zero gradients (the key
  projections' biases get exactly zero gradient in exact arithmetic), which
  is what the ratio allows; the port measures about 0.07 here, and a port
  that updated the bf16 weights without masters measures 0.74.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as ref_amp
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.models import TransformerLMCriterion as RefCriterion
from paddle_tpu.nn import functional as ref_F
from torch_parity import TINY, build_pair, reference_arrays

import paddle_tpu_torch as ptt
from paddle_tpu_torch import (TrainStep, TransformerLM,
                              TransformerLMCriterion, amp,
                              load_reference_params)
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.core import amp_state, flags
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.framework import dispatch
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_kernels as fk

OP_TOL = dict(rtol=0, atol=2e-2)
SMALL_LOSS_RTOL = 1e-3
SMALL_WEIGHT_ATOL = 1e-4
MAIN_LOSS_RTOL = 1e-3
MAIN_MASTER_RATIO = 0.2
MAIN_LR = 1e-4
MAIN_STEPS = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    """A port tensor or a reference array/Tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(getattr(x, "value", x)).astype(np.float32)


def _ref_dtype(x) -> str:
    return str(np.asarray(getattr(x, "value", x)).dtype)


# -- autocast of single ops (re-pointed copies of tests/test_amp.py) ---------


def _white_ops():
    """(name, reference call, port call) of the white ops the port has."""
    return {
        "matmul": (lambda a, b: pt.matmul(pt.to_tensor(a), pt.to_tensor(b)),
                   lambda a, b: ptt.matmul(_t(a), _t(b))),
        "linear": (lambda a, b: ref_F.linear(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(b[0])),
                   lambda a, b: F.linear(_t(a), _t(b), _t(b[0]))),
    }


@pytest.mark.parametrize("op", ["matmul", "linear"])
@pytest.mark.parametrize("kw,want", [
    (dict(), "bfloat16"),
    (dict(dtype="float16"), "float16"),
    (dict(level="O0"), "float32"),
    (dict(level="O2"), "bfloat16"),
    (dict(custom_black_list=["matmul", "linear"]), "float32"),
    (dict(enable=False), "float32"),
], ids=["o1", "fp16", "o0", "o2", "custom-black", "disabled"])
def test_white_op_dtype_matches_reference(op, kw, want):
    rng = np.random.RandomState(0)
    a = rng.randn(4, 4).astype(np.float32)
    b = rng.randn(4, 4).astype(np.float32)
    ref_fn, port_fn = _white_ops()[op]
    with ref_amp.auto_cast(**kw):
        r = ref_fn(a, b)
    with amp.auto_cast(**kw):
        p = port_fn(a, b)
    assert _ref_dtype(r) == want
    assert dtype_name(p.dtype) == want
    np.testing.assert_allclose(_np(p), _np(r), **OP_TOL)
    # outside the region the op is float32 again on both sides
    assert dtype_name(port_fn(a, b).dtype) == "float32"
    assert _ref_dtype(ref_fn(a, b)) == "float32"


@pytest.mark.parametrize("op", ["cross_entropy", "softmax_with_cross_entropy"])
def test_black_op_runs_in_float32(op):
    rng = np.random.RandomState(1)
    logits = rng.randn(6, 5).astype(np.float32)
    label = rng.randint(0, 5, (6, 1)).astype(np.int64)
    lb = jnp.asarray(logits).astype(jnp.bfloat16)
    with ref_amp.auto_cast():
        r = getattr(ref_F, op)(lb, jnp.asarray(label))
    with amp.auto_cast():
        p = getattr(F, op)(_t(logits).to(torch.bfloat16), _t(label))
    assert _ref_dtype(r) == "float32" and p.dtype == torch.float32
    np.testing.assert_allclose(_np(p), _np(r), rtol=1e-6, atol=1e-6)


def test_custom_white_list_takes_an_op_off_the_black_list():
    rng = np.random.RandomState(2)
    logits = rng.randn(6, 5).astype(np.float32)
    label = rng.randint(0, 5, (6,)).astype(np.int64)
    with ref_amp.auto_cast(custom_white_list=["cross_entropy"]):
        r = ref_F.cross_entropy(jnp.asarray(logits), jnp.asarray(label))
    with amp.auto_cast(custom_white_list=["cross_entropy"]):
        p = F.cross_entropy(_t(logits), _t(label))
    assert _ref_dtype(r) == "bfloat16" and p.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(p), _np(r), **OP_TOL)


_PASS_THROUGH = {
    "gelu": lambda t: F.gelu(t),
    "relu": lambda t: F.relu(t),
    "embedding": lambda t: F.embedding(_t([1, 2]), t.reshape(-1, 8)),
    "dropout": lambda t: F.dropout(t, 0.0),
    "layer_norm": lambda t: F.layer_norm(t, 8),
    "scaled_dot_product_attention":
        lambda t: F.scaled_dot_product_attention(t, t, t, is_causal=True),
}


@pytest.mark.parametrize("op", list(_PASS_THROUGH))
def test_unlisted_ops_keep_their_input_dtype(op):
    x = _t(np.random.RandomState(3).randn(1, 2, 4, 8).astype(np.float32))
    with amp.auto_cast(level="O2"):
        for dt in (torch.float32, torch.bfloat16):
            assert _PASS_THROUGH[op](x.to(dt)).dtype == dt


def test_layer_norm_rounds_as_the_reference():
    """bf16 input, float32 weights (O2 keeps norms float32): a float32
    output equal bit for bit to the reference's."""
    rng = np.random.RandomState(4)
    x = (rng.randn(4, 16, 64) * 3 + 1).astype(np.float32)
    w = (rng.rand(64) + 0.5).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = ref_F.layer_norm(xb, 64, jnp.asarray(w), jnp.asarray(b))
    xt = _t(np.asarray(xb).view(np.int16)).view(torch.bfloat16)
    with amp.auto_cast(level="O2"):
        got = F.layer_norm(xt, 64, _t(w), _t(b))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # without weights the output stays bf16, on both sides
    want16 = ref_F.layer_norm(xb, 64)
    got16 = F.layer_norm(xt, 64)
    assert got16.dtype == torch.bfloat16 and str(want16.dtype) == "bfloat16"
    np.testing.assert_array_equal(got16.float().numpy(),
                                  np.asarray(want16).astype(np.float32))


# -- the shim ---------------------------------------------------------------


def test_shim_casts_nested_arguments_and_returns_gradients_in_caller_dtype():
    Pair = collections.namedtuple("Pair", ["a", "b"])
    seen = {}

    def matmul(x, pair, extra=None):
        seen["dtypes"] = (x.dtype, pair.a.dtype, pair.b.dtype,
                          extra["w"][0].dtype, extra["n"].dtype)
        return x @ pair.a + pair.b

    ns = {"matmul": matmul}
    dispatch.install_ops(ns)
    op = ns["matmul"]
    assert op.__paddle_tpu_op__ and op.__name__ == "matmul"
    x = torch.randn(3, 4, requires_grad=True)
    pair = Pair(torch.randn(4, 2), torch.randn(2))
    extra = {"w": [torch.randn(2)], "n": torch.arange(3)}
    out = op(x, pair, extra=extra)
    assert out.dtype == torch.float32 and seen["dtypes"][0] == torch.float32
    with amp.auto_cast():
        out = op(x, pair, extra=extra)
    assert out.dtype == torch.bfloat16
    assert seen["dtypes"] == (torch.bfloat16,) * 4 + (torch.int64,)
    out.float().sum().backward()
    assert x.grad.dtype == torch.float32
    # installing twice leaves an installed op alone
    dispatch.install_ops(ns)
    assert ns["matmul"] is op


def test_amp_state_is_thread_local_and_restored():
    import threading

    assert not amp_state.amp_enabled()
    seen = []
    with amp.auto_cast():
        assert amp_state.amp_enabled()
        t = threading.Thread(target=lambda: seen.append(
            amp_state.amp_enabled()))
        t.start()
        t.join()
        with amp.auto_cast(level="O0"):
            assert not amp_state.amp_enabled()
        assert amp_state.current().level == "O1"
    assert seen == [False] and not amp_state.amp_enabled()


def test_auto_cast_and_decorate_refuse_bad_arguments():
    from paddle_tpu_torch import InvalidArgumentError

    for kw in (dict(level="O3"), dict(dtype="float32")):
        with pytest.raises(InvalidArgumentError):
            with amp.auto_cast(**kw):
                pass
        with pytest.raises(Exception):
            with ref_amp.auto_cast(**kw):
                pass
    with pytest.raises(InvalidArgumentError):
        amp.decorate(port_nn.Linear(2, 2, device="cpu"), level="O3")
    with pytest.raises(InvalidArgumentError):
        amp.GradScaler(incr_ratio=1.0)
    with pytest.raises(InvalidArgumentError):
        amp.GradScaler(decr_ratio=1.0)


def test_flags_match_reference_registry():
    from paddle_tpu.core import flags as ref_flags

    name = "FLAGS_amp_dtype"
    assert flags.get_flags(name) == ref_flags.get_flags(name) \
        == {name: "bfloat16"}
    assert flags.flag(name) == "bfloat16"
    with pytest.raises(KeyError):
        flags.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(KeyError):
        flags.define_flag(name, "bfloat16")
    for default, text, want in ((False, "on", True), (3, "7", 7),
                                (0.5, "2.5", 2.5), ("x", "y", "y")):
        assert flags._parse(text, default) == ref_flags._parse(text,
                                                                default) \
            == want
    # the flag is what auto_cast and decorate default to
    a = _t(np.eye(3, dtype=np.float32))
    flags.set_flags({name: "float16"})
    try:
        with amp.auto_cast():
            assert ptt.matmul(a, a).dtype == torch.float16
    finally:
        flags.set_flags({name: "bfloat16"})
    with amp.auto_cast():
        assert ptt.matmul(a, a).dtype == torch.bfloat16


def test_flag_reads_its_environment_variable(monkeypatch):
    from paddle_tpu.core import flags as ref_flags

    name = "FLAGS_test_torch_amp_env"
    monkeypatch.setenv(name, "7")
    try:
        flags.define_flag(name, 3, "parsed after its default's type")
        ref_flags.define_flag(name, 3, "parsed after its default's type")
        assert flags.flag(name) == ref_flags.flag(name) == 7
    finally:
        flags._REGISTRY.pop(name, None)
        ref_flags._REGISTRY.pop(name, None)


# -- decorate -----------------------------------------------------------------


def test_decorate_keeps_norm_layers_fp32_and_parameter_identity():
    model = torch.nn.Sequential(port_nn.Linear(8, 8, device="cpu"),
                                port_nn.LayerNorm(8, device="cpu"),
                                port_nn.Linear(8, 4, device="cpu"))
    model.register_buffer("scale", torch.ones(3))
    params = list(model.parameters())
    opt = port_opt.Adam(0.01, parameters=params)
    got, got_opt = amp.decorate(model, opt, level="O2", dtype="float16")
    assert got is model and got_opt is opt and opt._multi_precision
    assert [p.dtype for p in model.parameters()] == [
        torch.float16, torch.float16, torch.float32, torch.float32,
        torch.float16, torch.float16]
    assert model.scale.dtype == torch.float16
    assert all(a is b for a, b in zip(model.parameters(), params))
    assert all(a is b for a, b in zip(opt._parameter_list, params))
    # the reference's decorate gives the same dtypes
    pt.seed(0)
    ref = pt.nn.Sequential(pt.nn.Linear(8, 8), pt.nn.LayerNorm(8),
                           pt.nn.Linear(8, 4))
    ref = ref_amp.decorate(ref, level="O2", dtype="float16")
    assert [_ref_dtype(p) for p in ref.parameters()] == [
        dtype_name(p.dtype) for p in model.parameters()]


def test_decorate_o1_and_master_weight_false():
    lin = port_nn.Linear(4, 4, device="cpu")
    opt = port_opt.SGD(0.1, parameters=lin.parameters())
    assert amp.decorate(lin, opt, level="O1") == (lin, opt)
    assert lin.weight.dtype == torch.float32 and not opt._multi_precision
    assert amp.decorate(lin, level="O1") is lin
    amp.decorate(lin, opt, level="O2", master_weight=False)
    assert lin.weight.dtype == torch.bfloat16 and not opt._multi_precision


def test_decorate_o2_master_weights_match_reference():
    rng = np.random.RandomState(5)
    pt.seed(0)
    ref = pt.nn.Linear(8, 8)
    ref_opt = pt.optimizer.Adam(0.01, parameters=ref.parameters(),
                                multi_precision=False)
    ref, ref_opt = ref_amp.decorate(ref, ref_opt, level="O2",
                                    dtype="bfloat16")
    lin = port_nn.Linear(8, 8, device="cpu")
    load_reference_params(lin, {"weight": np.asarray(ref.weight.value),
                                "bias": np.asarray(ref.bias.value)})
    opt = port_opt.Adam(0.01, parameters=lin.parameters(),
                        multi_precision=False)
    lin, opt = amp.decorate(lin, opt, level="O2", dtype="bfloat16")
    assert lin.weight.dtype == torch.bfloat16 and opt._multi_precision
    xs = rng.randn(4, 8).astype(np.float32)
    with ref_amp.auto_cast(level="O2"):
        ref_loss = ref(pt.to_tensor(xs)).astype("float32").sum()
    ref_loss.backward()
    ref_opt.step()
    with amp.auto_cast(level="O2"):
        loss = lin(_t(xs)).float().sum()
    loss.backward()
    opt.step()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss.value),
                               rtol=SMALL_LOSS_RTOL)
    st = opt._states[port_opt.param_name(lin.weight)]
    ref_st = ref_opt._states[ref.weight.name]
    assert st["master_weight"].dtype == torch.float32
    np.testing.assert_allclose(st["master_weight"].numpy(),
                               np.asarray(ref_st["master_weight"]),
                               atol=SMALL_WEIGHT_ATOL)
    np.testing.assert_array_equal(
        lin.weight.detach().float().numpy(),
        np.asarray(ref.weight.value).astype(np.float32))


def test_decorate_save_dtype():
    lin = port_nn.Linear(8, 8, device="cpu")
    lin = amp.decorate(lin, level="O2", dtype="bfloat16",
                       save_dtype="float32")
    assert lin.weight.dtype == torch.bfloat16
    sd = lin.state_dict()
    assert sd["weight"].dtype == torch.float32
    np.testing.assert_array_equal(sd["weight"].numpy(),
                                  lin.weight.detach().float().numpy())
    weight = lin.weight
    lin.load_state_dict(sd)
    assert lin.weight is weight and lin.weight.dtype == torch.bfloat16


# -- GradScaler ------------------------------------------------------------


def _linear_pair(seed=0):
    pt.seed(seed)
    ref = pt.nn.Linear(4, 4)
    lin = port_nn.Linear(4, 4, device="cpu")
    load_reference_params(lin, {"weight": np.asarray(ref.weight.value),
                                "bias": np.asarray(ref.bias.value)})
    return ref, lin


def test_grad_scaler_scales_and_unscales():
    ref, lin = _linear_pair()
    x = np.random.RandomState(6).randn(2, 4).astype(np.float32)
    opt = port_opt.SGD(0.1, parameters=lin.parameters())
    scaler = amp.GradScaler(init_loss_scaling=128.0)
    lin(_t(x)).sum().backward()
    g_ref = lin.weight.grad.clone()
    opt.clear_grad()
    scaler.scale(lin(_t(x)).sum()).backward()
    np.testing.assert_allclose(lin.weight.grad.numpy(), g_ref.numpy() * 128,
                               rtol=1e-5)
    scaler.unscale_(opt)
    np.testing.assert_allclose(lin.weight.grad.numpy(), g_ref.numpy(),
                               rtol=1e-5)
    scaler.unscale_(opt)  # once per step: a second call changes nothing
    np.testing.assert_allclose(lin.weight.grad.numpy(), g_ref.numpy(),
                               rtol=1e-5)
    scaler.step(opt)
    scaler.update()
    assert scaler.get_loss_scaling() == 128.0


def test_grad_scaler_skips_on_inf():
    _, lin = _linear_pair()
    opt = port_opt.SGD(0.1, parameters=lin.parameters())
    scaler = amp.GradScaler(init_loss_scaling=64.0, decr_every_n_nan_or_inf=1)
    before = lin.weight.detach().clone()
    x = np.random.RandomState(7).randn(2, 4).astype(np.float32)
    scaler.scale(lin(_t(x)).sum()).backward()
    lin.weight.grad.fill_(float("inf"))
    scaler.step(opt)
    scaler.update()
    assert torch.equal(lin.weight.detach(), before)
    assert scaler.get_loss_scaling() == 32.0


def test_step_twice_without_update_raises():
    _, lin = _linear_pair()
    opt = port_opt.SGD(0.1, parameters=lin.parameters())
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    x = _t(np.random.RandomState(8).randn(2, 4).astype(np.float32))
    scaler.scale(lin(x).sum()).backward()
    scaler.step(opt)
    with pytest.raises(RuntimeError, match="update"):
        scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    scaler.scale(lin(x).sum()).backward()
    scaler.step(opt)  # fine after update


def test_grad_scaler_state_dict_roundtrip_and_dynamics():
    s = amp.AmpScaler(init_loss_scaling=64.0, incr_every_n_steps=100,
                      decr_ratio=0.25)
    s2 = amp.GradScaler()
    s2.load_state_dict(s.state_dict())
    assert s2.get_loss_scaling() == 64.0
    assert s2._incr_every_n_steps == 100 and s2._decr_ratio == 0.25
    assert s.state_dict() == ref_amp.GradScaler(
        init_loss_scaling=64.0, incr_every_n_steps=100,
        decr_ratio=0.25).state_dict()
    off = amp.GradScaler(enable=False)
    assert not off.is_enable() and off.scale(3.0) == 3.0


def test_grad_scaler_trajectory_matches_reference():
    """One scripted run of finite and non-finite gradients: the scale at
    every step, the skipped updates and the final weights agree."""
    script = ["ok", "ok", "inf", "ok", "nan", "inf", "ok", "ok", "ok", "ok",
              "ok", "ok", "inf", "ok"]
    kw = dict(init_loss_scaling=1024.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
    ref, lin = _linear_pair(1)
    ref_opt = pt.optimizer.SGD(0.05, parameters=ref.parameters())
    opt = port_opt.SGD(0.05, parameters=lin.parameters())
    ref_sc, sc = ref_amp.GradScaler(**kw), amp.GradScaler(**kw)
    x = np.random.RandomState(9).randn(3, 4).astype(np.float32)
    ref_scales, scales = [], []
    for what in script:
        ref_sc.scale(ref(pt.to_tensor(x)).sum()).backward()
        sc.scale(lin(_t(x)).sum()).backward()
        if what != "ok":
            bad = float(what)
            ref.weight._grad_val = jnp.full_like(ref.weight._grad_val, bad)
            lin.weight.grad.fill_(bad)
        ref_sc.minimize(ref_opt, None)
        sc.minimize(opt, None)
        ref_opt.clear_grad()
        opt.clear_grad()
        ref_scales.append(ref_sc.get_loss_scaling())
        scales.append(sc.get_loss_scaling())
    assert scales == ref_scales
    assert len(set(scales)) > 2  # the script moved the scale both ways
    np.testing.assert_allclose(lin.weight.detach().numpy(),
                               np.asarray(ref.weight.value),
                               atol=SMALL_WEIGHT_ATOL)


def test_fp16_o2_with_grad_scaler_trains():
    """A small model in fp16 O2 with dynamic loss scaling: the loss falls
    and the masters stay float32.  fp16 attention takes the composition
    (K3 runs f32 and bf16 only)."""
    cfg = dict(TINY, num_layers=1)
    model = TransformerLM(**cfg, device="cpu", seed=0)
    opt = port_opt.AdamW(1e-3, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    crit = TransformerLMCriterion()
    ids = _t(np.random.RandomState(10).randint(0, cfg["vocab_size"], (2, 16)))
    fk.reset_launch_counts()
    losses = []
    for _ in range(8):
        with amp.auto_cast(level="O1", dtype="float16"):
            logits = model(ids)
            loss = crit(logits, ids)
        assert logits.dtype == torch.float16 and loss.dtype == torch.float32
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1, losses
    assert model.word_embeddings.weight.dtype == torch.float16
    assert all(st["master_weight"].dtype == torch.float32
               for st in opt._states.values() if "master_weight" in st)
    assert fk.launch_counts_by_dtype() == {
        n: {"float32": 0, "bfloat16": 0} for n in fk.launch_counts()}


def test_training_under_autocast_bf16_matches_reference():
    """The reference test's Linear-ReLU-Linear under O1 autocast with
    float32 weights, 10 eager Adam steps: the same losses, and the
    weights stay float32."""
    rng = np.random.RandomState(11)
    xs = rng.randn(32, 8).astype(np.float32)
    ys = rng.randint(0, 4, (32,)).astype(np.int64)
    pt.seed(0)
    ref = pt.nn.Sequential(pt.nn.Linear(8, 32), pt.nn.ReLU(),
                           pt.nn.Linear(32, 4))
    ref_opt = pt.optimizer.Adam(0.01, parameters=ref.parameters())
    l1 = port_nn.Linear(8, 32, device="cpu")
    l2 = port_nn.Linear(32, 4, device="cpu")
    load_reference_params(l1, {"weight": np.asarray(ref[0].weight.value),
                               "bias": np.asarray(ref[0].bias.value)})
    load_reference_params(l2, {"weight": np.asarray(ref[2].weight.value),
                               "bias": np.asarray(ref[2].bias.value)})
    opt = port_opt.Adam(0.01, parameters=list(l1.parameters())
                        + list(l2.parameters()))
    ref_losses, losses = [], []
    for _ in range(10):
        with ref_amp.auto_cast():
            loss = ref_F.cross_entropy(ref(pt.to_tensor(xs)),
                                       pt.to_tensor(ys.astype(np.int32)))
        loss.backward()
        ref_opt.step()
        ref_opt.clear_grad()
        ref_losses.append(float(loss.value))
        with amp.auto_cast():
            loss = F.cross_entropy(l2(F.relu(l1(_t(xs)))), _t(ys))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.7
    assert l1.weight.dtype == torch.float32
    np.testing.assert_allclose(losses, ref_losses, rtol=SMALL_LOSS_RTOL)


def test_autocast_inside_train_step():
    rng = np.random.RandomState(12)
    xs = rng.randn(16, 8).astype(np.float32)
    ys = rng.randint(0, 4, (16,))
    model = torch.nn.Sequential(port_nn.Linear(8, 16, device="cpu"),
                                torch.nn.ReLU(),
                                port_nn.Linear(16, 4, device="cpu"))
    opt = port_opt.SGD(0.1, parameters=model.parameters())

    def loss_fn(m, x, y):
        with amp.auto_cast():
            return F.cross_entropy(m(x), y)

    step = TrainStep(model, loss_fn, opt)
    l0, l1 = float(step(xs, ys)), float(step(xs, ys))
    assert np.isfinite(l0) and l1 < l0


# -- the deliberate difference -------------------------------------------


def test_python_operators_are_not_cast_under_o2():
    """The reference's Tensor facade routes ``a * b`` through its
    ``multiply`` op, white under O2; the port has no facade, so torch's
    operators are not cast (ROADMAP queue 3).  Installed ops still are."""
    a = np.random.RandomState(13).randn(4, 4).astype(np.float32)
    with ref_amp.auto_cast(level="O2"):
        r = pt.to_tensor(a) * pt.to_tensor(a)
    with ref_amp.auto_cast(level="O2", custom_black_list=["multiply"]):
        r_black = pt.to_tensor(a) * pt.to_tensor(a)
    assert _ref_dtype(r) == "bfloat16" and _ref_dtype(r_black) == "float32"
    with amp.auto_cast(level="O2"):
        p = _t(a) * _t(a)
        m = ptt.matmul(_t(a), _t(a))
    assert p.dtype == torch.float32 and m.dtype == torch.bfloat16
    np.testing.assert_array_equal(p.numpy(), a * a)


# -- convert: bf16 reference arrays ---------------------------------------


def test_load_reference_params_takes_bf16_bit_for_bit():
    ref, _ = build_pair(0)
    ref = ref_amp.decorate(ref, level="O2", dtype="bfloat16")
    arrays = reference_arrays(ref)
    assert arrays["word_embeddings.weight"].dtype.name == "bfloat16"
    port = amp.decorate(TransformerLM(**TINY, device="cpu", seed=1),
                        level="O2", dtype="bfloat16")
    load_reference_params(port, arrays)
    fp32 = load_reference_params(TransformerLM(**TINY, device="cpu", seed=1),
                                 arrays)
    for (name, p), (_, q) in zip(port.named_parameters(),
                                 fp32.named_parameters()):
        want = arrays[name]
        assert dtype_name(p.dtype) == want.dtype.name, name
        if p.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                p.detach().view(torch.int16).numpy(), want.view(np.int16))
        # into a float32 model: the exact upcast
        np.testing.assert_array_equal(q.detach().numpy(),
                                      want.astype(np.float32))


# -- the main path: TrainStep under O2 bf16 ------------------------------


def _padded_batch(rng, vocab, b, l):
    ids = rng.randint(1, vocab, (b, l))
    lens = rng.randint(l // 2, l + 1, b)
    lens[0] = l
    valid = np.arange(l)[None, :] < lens[:, None]
    mask = np.where(valid, 0.0, np.finfo(np.float32).min).astype(
        np.float32)[:, None, None, :]
    return ids, mask, np.where(valid, ids, -100)


@pytest.mark.parametrize("leg", ["causal", "padded"])
def test_o2_bf16_train_step_matches_reference(leg):
    """The reference's training leg (``bench.py``'s ``_lm_leg_runner``) at
    the tiny size: float32 weights carried across, both sides decorated O2
    bf16, 3 ``TrainStep``s of AdamW(1e-4, weight decay 0.01, global-norm
    clip 1.0) with the loss under ``auto_cast(level="O1")``.  The padded
    leg is a non-causal encoder on ragged lengths (a [B, 1, 1, L] padding
    mask) with the pads ignored."""
    causal = leg == "causal"
    ref, port = build_pair(0, causal=causal)
    ref_opt = pt.optimizer.AdamW(
        MAIN_LR, parameters=ref.parameters(), weight_decay=0.01,
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    opt = port_opt.AdamW(MAIN_LR, parameters=port.parameters(),
                         weight_decay=0.01,
                         grad_clip=port_nn.ClipGradByGlobalNorm(1.0))
    ref, ref_opt = ref_amp.decorate(ref, ref_opt, level="O2",
                                    dtype="bfloat16")
    port, opt = amp.decorate(port, opt, level="O2", dtype="bfloat16")
    init = reference_arrays(build_pair(0, causal=causal)[0])
    rng = np.random.RandomState(14)
    seen = {"ref": [], "port": []}
    if causal:
        ids = rng.randint(0, TINY["vocab_size"], (2, 32))
        ref_batch = (pt.to_tensor(ids.astype(np.int32)),)
        batch = (ids,)
        ref_crit, crit = RefCriterion(), TransformerLMCriterion()
    else:
        ids, mask, labels = _padded_batch(rng, TINY["vocab_size"], 3, 24)
        ref_batch = (pt.to_tensor(ids.astype(np.int32)), pt.to_tensor(mask),
                     pt.to_tensor(labels.astype(np.int32)))
        batch = (ids, _t(mask), labels)
        ref_crit = RefCriterion(shift_labels=False)
        crit = TransformerLMCriterion(shift_labels=False)

    def ref_loss(m, x, *rest):
        with ref_amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = m(x, attn_mask=rest[0]) if rest else m(x)
            loss = ref_crit(logits, rest[1] if rest else x)
        # traced inside the reference's compiled step: read the dtypes only
        seen["ref"].append((str(np.dtype(logits.dtype)),
                            str(np.dtype(loss.dtype))))
        return loss

    def port_loss(m, x, *rest):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = m(x, attn_mask=rest[0]) if rest else m(x)
            loss = crit(logits, rest[1] if rest else x)
        seen["port"].append((dtype_name(logits.dtype),
                             dtype_name(loss.dtype)))
        return loss

    ref_step = RefTrainStep(ref, ref_loss, ref_opt)
    step = TrainStep(port, port_loss, opt)
    fk.reset_launch_counts()
    ref_losses, losses = [], []
    for _ in range(MAIN_STEPS):
        ref_losses.append(float(np.asarray(ref_step(*ref_batch).value)))
        losses.append(float(step(*batch)))
    np.testing.assert_allclose(losses, ref_losses, rtol=MAIN_LOSS_RTOL)
    assert seen["port"][-1] == ("bfloat16", "float32")
    assert seen["ref"][-1] == seen["port"][-1]
    ref_params = dict(ref.named_parameters())
    diff = moved = 0.0
    for name, p in port.named_parameters():
        rp = ref_params[name]
        assert dtype_name(p.dtype) == _ref_dtype(rp), name
        assert (p.dtype == torch.float32) == ("norm" in name), name
        st = opt._states[port_opt.param_name(p)]
        ref_st = ref_opt._states[rp.name]
        assert ("master_weight" in st) == ("master_weight" in ref_st), name
        if "master_weight" in st:
            assert st["master_weight"].dtype == torch.float32
            got, want = st["master_weight"].numpy(), np.asarray(
                ref_st["master_weight"])
        else:
            got, want = _np(p), _np(rp)
        assert st["moment1"].dtype == torch.float32
        diff += float(((got - want) ** 2).sum())
        moved += float(((want - init[name]) ** 2).sum())
    ratio = np.sqrt(diff / moved)
    assert ratio <= MAIN_MASTER_RATIO, ratio
    # the CPU runs K3's twin: no kernel launch is counted
    assert fk.launch_counts() == {n: 0 for n in fk.launch_counts()}


def test_o2_forward_feeds_k3_in_bf16(monkeypatch):
    """Under O2 every attention of the model reaches K3's autograd
    function with bf16 q, k and v, and the causal mask (finfo.min rounds
    to -inf in bf16) is still claimed as causal: no [L, L] bias reaches
    the kernel."""
    _, port = build_pair(0)
    port = amp.decorate(port, level="O2", dtype="bfloat16")
    calls = []
    apply = fk.FlashAttentionFunction.apply

    def recording(q, k, v, bias, q_seg, kv_seg, causal, sm_scale):
        calls.append((q.dtype, k.dtype, v.dtype, bias, causal))
        return apply(q, k, v, bias, q_seg, kv_seg, causal, sm_scale)

    monkeypatch.setattr(fk.FlashAttentionFunction, "apply", recording)
    ids = _t(np.random.RandomState(15).randint(0, 512, (2, 16)))
    with amp.auto_cast(level="O1"):
        logits = port(ids)
    logits.float().sum().backward()
    assert len(calls) == TINY["num_layers"]
    assert all(c == (torch.bfloat16,) * 3 + (None, True) for c in calls)
    assert port.encoder.layers[0].self_attn.q_proj.weight.grad.dtype \
        == torch.bfloat16
    assert port.final_norm.weight.grad.dtype == torch.float32


def test_o2_padding_mask_is_read_back_once_a_mask(monkeypatch):
    """Under O2 every layer converts the caller's float32 padding mask to
    bf16; the layers share one converted copy, so the mask detection reads
    the mask back to the host once for all layers and steps, and each
    attention still takes it as key-padding lanes."""
    from paddle_tpu_torch.ops import flash_attention as fa

    _, port = build_pair(0, causal=False)
    port = amp.decorate(port, level="O2", dtype="bfloat16")
    ids, mask, _ = _padded_batch(np.random.RandomState(16),
                                 TINY["vocab_size"], 3, 24)
    mask = _t(mask)
    reads, lanes = [], []
    put, apply = fa._cache_put, fk.FlashAttentionFunction.apply

    def counting_put(cache, m, verdict):
        if cache is fa._pad_detect_cache:
            reads.append(m.dtype)
        return put(cache, m, verdict)

    def recording(q, k, v, bias, q_seg, kv_seg, causal, sm_scale):
        lanes.append((bias is None, kv_seg is not None))
        return apply(q, k, v, bias, q_seg, kv_seg, causal, sm_scale)

    monkeypatch.setattr(fa, "_cache_put", counting_put)
    monkeypatch.setattr(fk.FlashAttentionFunction, "apply", recording)
    for _ in range(2):
        with amp.auto_cast(level="O1"):
            port(_t(ids), attn_mask=mask)
    assert reads == [torch.bfloat16]
    assert lanes == [(True, True)] * (2 * TINY["num_layers"])
