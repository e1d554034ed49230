"""The port's ONNX export (``paddle_tpu_torch.onnx``) held case for case to
the reference's ``tests/test_onnx.py``: export a layer, parse the file
back and run it with the numpy runtime against the live layer.  Across
the packages, on the same weights: the port's file runs in the
reference's runtime against the reference's layer, and the reference's
file in the port's runtime against the port's layer."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.onnx import export as ref_export
from paddle_tpu.onnx import runtime as ref_ort
from paddle_tpu_torch import load_reference_params
from paddle_tpu_torch.onnx import export
from paddle_tpu_torch.onnx import runtime as ort


def _check_roundtrip(model, xs, path, rtol=1e-5, atol=1e-6):
    with torch.no_grad():
        ref = model(*[torch.from_numpy(x) for x in xs]).numpy()
    path = export(model, path, input_spec=xs)
    got = ort.run(path, list(xs))[0]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    return path


def test_export_mlp_softmax(tmp_path):
    ptt.seed(0)
    model = ptt.nn.Sequential(ptt.nn.Linear(4, 8), ptt.nn.ReLU(),
                              ptt.nn.Linear(8, 3), ptt.nn.Softmax())
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    path = _check_roundtrip(model, (x,), str(tmp_path / "m"))
    nodes, inits, inputs, outputs = ort.load(path)
    ops = {n["op"] for n in nodes}
    assert "MatMul" in ops and "Max" in ops and "Exp" in ops
    assert inputs == ["input_0"] and len(outputs) == 1
    # weights became initializers with real values
    assert any(v.shape in ((4, 8), (8, 4)) for v in inits.values())


def test_export_deeper_activations(tmp_path):
    ptt.seed(1)
    model = ptt.nn.Sequential(ptt.nn.Linear(6, 6), ptt.nn.Sigmoid(),
                              ptt.nn.Linear(6, 6), ptt.nn.Tanh(),
                              ptt.nn.Linear(6, 2))
    x = np.random.RandomState(1).randn(3, 6).astype(np.float32)
    _check_roundtrip(model, (x,), str(tmp_path / "m"))


def test_export_layernorm(tmp_path):
    ptt.seed(2)
    model = ptt.nn.Sequential(ptt.nn.Linear(8, 8), ptt.nn.LayerNorm(8))
    x = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    _check_roundtrip(model, (x,), str(tmp_path / "m"), rtol=1e-4, atol=1e-5)


def test_export_conv2d(tmp_path):
    ptt.seed(3)
    model = ptt.nn.Sequential(ptt.nn.Conv2D(3, 4, 3, padding=1),
                              ptt.nn.ReLU())
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    _check_roundtrip(model, (x,), str(tmp_path / "m"), rtol=1e-4, atol=1e-5)


def test_export_grouped_dilated_conv(tmp_path):
    ptt.seed(4)
    model = ptt.nn.Sequential(
        ptt.nn.Conv2D(4, 4, 3, padding=2, dilation=2, groups=2))
    x = np.random.RandomState(4).randn(1, 4, 8, 8).astype(np.float32)
    _check_roundtrip(model, (x,), str(tmp_path / "m"), rtol=1e-4, atol=1e-5)


def test_export_conv_transpose_is_loud(tmp_path):
    ptt.seed(5)
    model = ptt.nn.Conv2DTranspose(2, 2, 3, stride=2)
    x = np.random.RandomState(5).randn(1, 2, 4, 4).astype(np.float32)
    with pytest.raises(Exception, match="rev|lhs_dilation|ConvTranspose"):
        export(model, str(tmp_path / "convT"), input_spec=(x,))


def test_export_reduce_max_axes_attribute(tmp_path):
    class MaxPoolish(ptt.nn.Layer):
        def forward(self, x):
            return ptt.max(x, axis=1)

    x = np.random.RandomState(6).randn(3, 5).astype(np.float32)
    path = _check_roundtrip(MaxPoolish(), (x,), str(tmp_path / "m"))
    nodes, _, _, _ = ort.load(path)
    rmax = [n for n in nodes if n["op"] == "ReduceMax"]
    # axes as an attribute (opset 17), a single data input
    assert rmax and rmax[0]["attrs"].get("axes") == [1]
    assert len(rmax[0]["inputs"]) == 1


def test_export_unsupported_primitive_is_loud(tmp_path):
    class Sorter(ptt.nn.Layer):
        def forward(self, x):
            return ptt.sort(x, axis=-1)

    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    with pytest.raises(Exception, match="no ONNX mapping"):
        export(Sorter(), str(tmp_path / "bad"), input_spec=(x,))


def test_export_requires_input_spec(tmp_path):
    with pytest.raises(Exception, match="input_spec"):
        export(ptt.nn.Linear(2, 2), str(tmp_path / "nospec"))


def test_export_refuses_k3_by_name(tmp_path):
    """Attention reaches K3's registered operator in the traced program,
    which has no ONNX op in this set: refused naming it."""
    ptt.seed(9)
    attn = ptt.nn.MultiHeadAttention(16, 2)
    x = np.random.RandomState(9).randn(2, 8, 16).astype(np.float32)
    with pytest.raises(Exception, match="flash_attention_forward"):
        export(attn, str(tmp_path / "attn"), input_spec=(x,))


def _pair(build, seed):
    pt.seed(seed)
    ref = build(pt.nn)
    port = build(ptt.nn)
    load_reference_params(port, {n: np.asarray(p.value)
                                 for n, p in ref.named_parameters()})
    return ref, port


@pytest.mark.parametrize("case", ["mlp", "norm", "conv"])
def test_files_cross_between_the_packages(case, tmp_path):
    builds = {
        "mlp": (lambda nn: nn.Sequential(nn.Linear(4, 8), nn.ReLU(),
                                         nn.Linear(8, 3), nn.Softmax()),
                (2, 4)),
        "norm": (lambda nn: nn.Sequential(nn.Linear(8, 8), nn.Tanh(),
                                          nn.LayerNorm(8)), (4, 8)),
        "conv": (lambda nn: nn.Sequential(nn.Conv2D(3, 4, 3, padding=1),
                                          nn.ReLU()), (2, 3, 8, 8)),
    }
    build, shape = builds[case]
    ref, port = _pair(build, 7)
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    want_ref = np.asarray(ref(pt.to_tensor(x)).value)
    with torch.no_grad():
        want_port = port(torch.from_numpy(x)).numpy()
    port_file = export(port, str(tmp_path / "port"), input_spec=(x,))
    ref_file = ref_export(ref, str(tmp_path / "ref"), input_spec=(x,))
    np.testing.assert_allclose(ref_ort.run(port_file, [x])[0], want_ref,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ort.run(ref_file, [x])[0], want_port,
                               rtol=1e-4, atol=1e-5)
