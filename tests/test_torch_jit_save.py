"""The port's static ``jit`` (``to_static``, ``save``/``load``,
``TranslatedLayer``, ``ProgramTranslator``, ``TracedLayer``) held case for
case to the reference's ``tests/test_jit.py`` where a case has a meaning
in the port, and the deployment slice's ERNIE held to the reference's:
``jit.save`` -> ``Predictor`` in both packages on the same weights, batch
2 and 5 from one artifact.

Tolerances: a program replays the eager function's own ops, so fp32
results agree to rounding (rtol 1e-5); the port against the reference
differs by the two frameworks' fp32 summation orders (1e-4 relative to
the logits' largest magnitude)."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import jit, nn
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.jit import InputSpec, to_static

import torch_parity as tp


class MLP(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(8, 16)
        self.fc2 = nn.Linear(16, 4)
        self.act = nn.ReLU()

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def _x(*shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


class TestToStatic:
    def test_function_matches_eager(self):
        @to_static
        def f(x, y):
            return ptt.matmul(x, y) + 1.0

        a, b = _x(3, 4), _x(4, 5, seed=1)
        np.testing.assert_allclose(f(a, b).numpy(),
                                   (ptt.matmul(a, b) + 1.0).numpy(),
                                   rtol=1e-6)

    def test_layer_matches_eager_and_no_retrace(self):
        ptt.seed(0)
        model = MLP()
        calls = {"n": 0}
        orig_forward = model.forward

        def counting_forward(x):
            calls["n"] += 1
            return orig_forward(x)

        static = to_static(counting_forward)
        x = _x(2, 8)
        y1 = static(x)
        np.testing.assert_allclose(y1.detach().numpy(),
                                   orig_forward(x).detach().numpy(),
                                   rtol=1e-5)
        n_after_first = calls["n"]
        static(x)
        static(x)
        # the Python body ran only while the signature traced
        assert calls["n"] == n_after_first == 1
        static(_x(3, 8))  # a new signature traces once more
        assert calls["n"] == 2 and len(static.concrete_program) == 2

    def test_param_update_visible_without_retrace(self):
        ptt.seed(0)
        model = MLP()
        static = to_static(model)
        x = torch.ones(1, 8)
        y1 = static(x).detach().numpy()
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        y2 = static(x).detach().numpy()
        assert not np.allclose(y1, y2)
        np.testing.assert_allclose(y2, 0.0, atol=1e-6)
        assert len(static.concrete_program) == 1

    def test_randomness_advances_per_call(self):
        ptt.seed(7)
        static = to_static(nn.Dropout(0.5))
        x = torch.ones(4, 64)
        assert not np.allclose(static(x).numpy(), static(x).numpy())

    def test_backward_through_to_static(self):
        ptt.seed(0)
        model = MLP()
        x = _x(4, 8)
        model(x).sum().backward()
        eager_grads = {n: p.grad.numpy().copy()
                       for n, p in model.named_parameters()}
        model.clear_gradients()
        to_static(model)(x).sum().backward()
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), eager_grads[n],
                                       rtol=1e-5, atol=1e-6)

    def test_buffer_writeback_batchnorm(self):
        ptt.seed(0)
        bn = nn.BatchNorm1D(8)
        static = to_static(bn)
        before = bn._mean.clone()
        x = _x(16, 8) + 3.0
        static(x)
        mean_buf = [b for n, b in bn.named_buffers() if "mean" in n][0]
        assert abs(float(mean_buf.mean())) > 1e-4
        # the reference's rule, as the eager layer applies it
        want = nn.BatchNorm1D(8)
        want(x)
        np.testing.assert_allclose(bn._mean.numpy(), want._mean.numpy(),
                                   rtol=1e-6)
        assert not torch.equal(before, bn._mean)


class TestReviewRegressions:
    def test_static_scalar_args(self):
        @to_static
        def f(x, axis):
            return ptt.sum(x, axis)

        x = torch.ones(2, 3)
        np.testing.assert_allclose(f(x, 1).numpy(), [3.0, 3.0])
        np.testing.assert_allclose(f(x, 0).numpy(), [2.0, 2.0, 2.0])

    def test_save_uses_decoration_input_spec(self, tmp_path):
        ptt.seed(0)
        model = MLP()
        model.eval()
        static = to_static(model, input_spec=[InputSpec([None, 8])])
        path = str(tmp_path / "spec")
        jit.save(static, path)
        loaded = jit.load(path, device="cpu")
        x = _x(2, 8)
        np.testing.assert_allclose(loaded(x).numpy(),
                                   model(x).detach().numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_to_static_method_decorator(self):
        class M(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 2)

            @to_static
            def forward(self, x):
                return self.fc(x)

        ptt.seed(0)
        m = M()
        x = torch.ones(3, 4)
        out = m(x)
        assert list(out.shape) == [3, 2]
        m2 = M()  # two instances do not share programs
        assert not np.allclose(out.detach().numpy(),
                               m2(x).detach().numpy())

    def test_save_two_dynamic_inputs(self, tmp_path):
        class Two(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 2)

            def forward(self, a, b):
                return self.fc(a) + self.fc(b)

        ptt.seed(0)
        m = Two()
        m.eval()
        path = str(tmp_path / "two")
        jit.save(m, path, input_spec=[InputSpec([None, 4]),
                                      InputSpec([None, 4])])
        loaded = jit.load(path, device="cpu")
        a, b = _x(3, 4), _x(3, 4, seed=1)
        np.testing.assert_allclose(loaded(a, b).numpy(),
                                   m(a, b).detach().numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_translated_layer_set_state_dict_takes_effect(self, tmp_path):
        ptt.seed(0)
        m = MLP()
        m.eval()
        path = str(tmp_path / "live")
        jit.save(m, path, input_spec=[InputSpec([2, 8])])
        loaded = jit.load(path, device="cpu")
        x = torch.ones(2, 8)
        before = loaded(x).numpy()
        zeroed = {k: torch.zeros(v.shape)
                  for k, v in loaded.state_dict().items()}
        loaded.set_state_dict(zeroed)
        after = loaded(x).numpy()
        assert not np.allclose(before, after)
        np.testing.assert_allclose(after, 0.0, atol=1e-6)

    def test_translated_layer_exposes_buffers(self, tmp_path):
        ptt.seed(0)
        bn = nn.BatchNorm1D(4)
        bn.eval()
        path = str(tmp_path / "bn")
        jit.save(bn, path, input_spec=[InputSpec([2, 4])])
        sd = jit.load(path, device="cpu").state_dict()
        assert any("mean" in k for k in sd), sd.keys()


class TestSaveLoad:
    def test_save_load_roundtrip(self, tmp_path):
        ptt.seed(0)
        model = MLP()
        model.eval()
        x = _x(3, 8)
        path = str(tmp_path / "mlp")
        jit.save(model, path, input_spec=[InputSpec([3, 8])])
        np.testing.assert_allclose(
            jit.load(path, device="cpu")(x).numpy(),
            model(x).detach().numpy(), rtol=1e-5, atol=1e-6)

    def test_save_load_dynamic_batch(self, tmp_path):
        ptt.seed(0)
        model = MLP()
        model.eval()
        path = str(tmp_path / "mlp_dyn")
        jit.save(model, path, input_spec=[InputSpec([None, 8])])
        loaded = jit.load(path, device="cpu")
        for bs in (1, 5):
            x = _x(bs, 8, seed=bs)
            np.testing.assert_allclose(loaded(x).numpy(),
                                       model(x).detach().numpy(),
                                       rtol=1e-5, atol=1e-6)

    def test_artifact_layout_and_metadata(self, tmp_path):
        ptt.seed(0)
        model = MLP()
        path = str(tmp_path / "mlp")
        jit.save(model, path, input_spec=[InputSpec([None, 8])])
        meta = json.load(open(path + ".pdmodel.json"))
        for key in ("format", "platforms", "param_names", "buffer_names",
                    "n_inputs", "params_const"):
            assert key in meta
        names = [n for n, _ in model.named_parameters()]
        assert meta["param_names"] == names and meta["n_inputs"] == 1
        data = np.load(path + ".pdiparams.npz")
        assert sorted(data.files) == sorted("param:" + n for n in names)
        assert model.training  # the save ran in eval mode and restored it

    def test_load_needs_a_device(self, tmp_path):
        path = str(tmp_path / "mlp")
        jit.save(MLP(), path, input_spec=[InputSpec([None, 8])])
        if not torch.cuda.is_available():
            with pytest.raises(ptt.UnavailableError):
                jit.load(path)
        with pytest.raises(InvalidArgumentError, match="input_spec"):
            jit.save(MLP(), path)


class TestParamsConstArtifact:
    """``jit.save(params_const=True)``: the weights inside the program."""

    def _net(self):
        ptt.seed(0)

        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.conv = nn.Conv2D(3, 8, 3, padding=1)
                self.bn = nn.BatchNorm2D(8)
                self.act = nn.ReLU()

            def forward(self, x):
                return self.act(self.bn(self.conv(x)))

        net = Net()
        x = _x(2, 3, 16, 16)
        net.train()
        for _ in range(3):  # non-trivial running statistics
            net(x)
        net.eval()
        return net, x

    def test_const_artifact_matches_and_is_self_contained(self, tmp_path):
        net, x = self._net()
        want = net(x).detach().numpy()
        pa, pc = str(tmp_path / "args"), str(tmp_path / "const")
        spec = [InputSpec([2, 3, 16, 16])]
        jit.save(net, pa, input_spec=spec)
        jit.save(net, pc, input_spec=spec, params_const=True)
        la, lc = jit.load(pa, device="cpu"), jit.load(pc, device="cpu")
        np.testing.assert_allclose(la(x).numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(lc(x).numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        kinds = [s.kind.name for s in lc.in_specs]
        assert kinds.count("USER_INPUT") == 1 and "PARAMETER" in kinds
        assert len([s for s in la.in_specs
                    if s.kind.name == "USER_INPUT"]) > 1

    def test_const_artifact_rejects_retarget(self, tmp_path):
        net, x = self._net()
        pc = str(tmp_path / "const")
        jit.save(net, pc, input_spec=[InputSpec([2, 3, 16, 16])],
                 params_const=True)
        lc = jit.load(pc, device="cpu")
        for name in ("set_state_dict", "set_dict", "load_dict"):
            with pytest.raises(InvalidArgumentError, match="params_const"):
                getattr(lc, name)({})

    def test_const_artifact_stores_weights_once(self, tmp_path):
        net, x = self._net()
        pc = str(tmp_path / "const")
        jit.save(net, pc, input_spec=[InputSpec([2, 3, 16, 16])],
                 params_const=True)
        assert len(np.load(pc + ".pdiparams.npz").files) == 0
        assert jit.load(pc, device="cpu").state_dict() == {}

    def test_predictor_over_const_artifact(self, tmp_path):
        from paddle_tpu_torch.inference import Config, create_predictor

        net, x = self._net()
        pc = str(tmp_path / "const")
        jit.save(net, pc, input_spec=[InputSpec([2, 3, 16, 16])],
                 params_const=True)
        config = Config(pc)
        config.disable_gpu()
        out = create_predictor(config).run([x.numpy()])
        np.testing.assert_allclose(out[0], net(x).detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_program_translator_and_traced_layer(tmp_path):
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        return x * 2.0

    static = to_static(f)
    jit.ProgramTranslator.get_instance().enable(False)
    try:
        assert not jit.ProgramTranslator.get_instance().enable_to_static
        static(torch.ones(2))
        static(torch.ones(2))
        assert calls["n"] == 2 and not static.concrete_program
    finally:
        jit.enable_to_static(True)
    static(torch.ones(2))
    static(torch.ones(2))
    assert calls["n"] == 3
    jit.set_code_level(100)
    jit.set_verbosity(0)
    ptt.seed(0)
    model = MLP()
    model.eval()
    x = _x(2, 8)
    out, traced = jit.TracedLayer.trace(model, [x])
    np.testing.assert_allclose(traced(x).detach().numpy(),
                               out.detach().numpy())
    traced.save_inference_model(str(tmp_path / "traced"))
    np.testing.assert_allclose(
        jit.load(str(tmp_path / "traced"), device="cpu")(x).numpy(),
        out.detach().numpy(), rtol=1e-6)


# -- the slice's model: ERNIE, against the reference ----------------------------


@pytest.fixture(scope="module")
def ernie_artifacts(tmp_path_factory):
    """The ERNIE pair saved by both packages' ``jit.save`` with an open
    batch; the port's saved twice (weights as inputs, and in the
    program)."""
    ref, port = tp.ernie_cls_pair()
    d = tmp_path_factory.mktemp("ernie")
    pt.jit.save(ref, str(d / "ref"), input_spec=tp.ernie_specs(pt.jit,
                                                                "int32"))
    jit.save(port, str(d / "port"), input_spec=tp.ernie_specs(jit))
    jit.save(port, str(d / "const"), input_spec=tp.ernie_specs(jit),
             params_const=True)
    return ref, port, d


def _predictors(d, name):
    from paddle_tpu.inference import Config as RefConfig
    from paddle_tpu.inference import create_predictor as ref_create
    from paddle_tpu_torch.inference import Config, create_predictor

    config = Config(str(d / name))
    config.disable_gpu()
    return (ref_create(RefConfig(str(d / "ref"))),
            create_predictor(config))


@pytest.mark.parametrize("name", ["port", "const"])
def test_ernie_saved_and_served_matches_the_reference(ernie_artifacts, name):
    """Batch 2 and 5 from one artifact: the port's Predictor against the
    reference's Predictor on the same weights and inputs."""
    ref, port, d = ernie_artifacts
    ref_pred, pred = _predictors(d, name)
    for b in (2, 5):
        ids, mask, types = tp.ernie_batch(b, seed=b)
        want = ref_pred.run([ids.astype(np.int32), mask,
                             types.astype(np.int32)])[0]
        got = pred.run([ids, mask, types])[0]
        assert got.shape == (b, 3)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        eager = port(torch.from_numpy(ids), torch.from_numpy(mask),
                     torch.from_numpy(types)).detach().numpy()
        np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-6)


def test_ernie_program_holds_k3_and_swappable_weights(ernie_artifacts):
    """The program holds the registered K3 operator once per layer (its
    mask a broadcast bias), and ``set_state_dict`` retargets the
    weights-as-inputs artifact."""
    ref, port, d = ernie_artifacts
    loaded = jit.load(str(d / "port"), device="cpu")
    k3 = [n for n in loaded._program.graph.nodes
          if "flash_attention_forward" in str(n.target)]
    assert len(k3) == tp.ERNIE_SMALL["num_layers"]
    assert all(n.args[3] is not None for n in k3)  # the bias operand
    ids, mask, types = (torch.from_numpy(a) for a in tp.ernie_batch(3))
    before = loaded(ids, mask, types)
    sd = loaded.state_dict()
    key = next(k for k in sd if k.endswith("classifier__bias"))
    loaded.set_state_dict({key: sd[key] + 1.0})
    np.testing.assert_allclose((loaded(ids, mask, types) - before).numpy(),
                               1.0, rtol=1e-5)


def test_ernie_bf16_artifact(tmp_path):
    """An O2 bf16 copy saved under ``auto_cast`` (the casts go into the
    program; bf16 weights as 16-bit patterns in the .npz) serves as its
    eager forward under ``auto_cast`` does."""
    from paddle_tpu_torch import amp

    _, port = tp.ernie_cls_pair()
    port = amp.decorate(port, level="O2", dtype="bfloat16")
    path = str(tmp_path / "bf16")
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        jit.save(port, path, input_spec=tp.ernie_specs(jit))
    meta = json.load(open(path + ".pdmodel.json"))
    assert meta["bf16"] and all(k.startswith(("param:", "buffer:"))
                                for k in meta["bf16"])
    loaded = jit.load(path, device="cpu")
    ids, mask, types = (torch.from_numpy(a) for a in tp.ernie_batch(4))
    got = loaded(ids, mask, types).float().numpy()
    with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
        want = port(ids, mask, types).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
