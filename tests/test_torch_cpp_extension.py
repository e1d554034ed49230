"""The port's ``utils.cpp_extension`` against the reference's: the same C++
source compiled by both (g++), forward and backward values, training
through a host op with ``TrainStep`` (the counterpart of the reference's
``test_cpp_extension_under_jit``), a compile error, and a reload.

Both packages call the same compiled code on float32 host buffers, so
forward values are equal; gradients and the TrainStep losses are fp32
elementwise math, 1e-6 relative.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu.utils import cpp_extension as ref_cpp

from paddle_tpu_torch import InvalidArgumentError, TrainStep
from paddle_tpu_torch.incubate import registered_custom_ops
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.utils import cpp_extension

SOURCE = """
#include "pt_extension.h"

PT_OP(ext_scale2) {
  long long n = 1;
  for (int d = 0; d < ndims[0]; ++d) n *= shapes[0][d];
  for (long long i = 0; i < n; ++i) out[i] = 2.0f * ins[0][i];
}

PT_OP(ext_dot_bias) {
  // out = ins[0] + ins[1] elementwise (two-input op)
  long long n = 1;
  for (int d = 0; d < ndims[0]; ++d) n *= shapes[0][d];
  for (long long i = 0; i < n; ++i) out[i] = ins[0][i] + ins[1][i];
}
"""


def _functions():
    return {"ext_scale2": {"out_shape": lambda s: s,
                           "backward": lambda res, ct: (2.0 * ct,)},
            "ext_dot_bias": {"out_shape": lambda s1, s2: s1}}


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    """(reference module, port module) from one source, each built into a
    directory of its own."""
    src_dir = tmp_path_factory.mktemp("ext_src")
    src = src_dir / "ops.cc"
    src.write_text(SOURCE)
    ref = ref_cpp.load(name="torch_parity_ref_ext_%d" % os.getpid(),
                       sources=[str(src)], functions=_functions(),
                       build_directory=str(tmp_path_factory.mktemp("ref")))
    port = cpp_extension.load(
        name="torch_parity_ext_%d" % os.getpid(), sources=[str(src)],
        functions=_functions(),
        build_directory=str(tmp_path_factory.mktemp("port")))
    return ref, port


def test_forward_matches_reference(modules):
    ref, port = modules
    x = np.linspace(-1, 1, 6).astype(np.float32).reshape(2, 3)
    for name, args in (("ext_scale2", (x,)), ("ext_dot_bias", (x, x * 3))):
        want = np.asarray(getattr(ref, name)(
            *[pt.to_tensor(a) for a in args]).value)
        got = getattr(port, name)(*[torch.from_numpy(a) for a in args])
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    # a 0-d input rides the shape ABI as [1] with ndim 0
    assert float(port.ext_scale2(torch.tensor(1.5))) == 3.0


def test_backward_matches_reference(modules):
    ref, port = modules
    x = np.array([1.0, -2.0], np.float32)
    rx = pt.to_tensor(x, stop_gradient=False)
    y = ref.ext_scale2(rx)
    (y * y).sum().backward()
    px = torch.from_numpy(x.copy()).requires_grad_()
    z = port.ext_scale2(px)
    (z * z).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(rx.grad.value),
                               rtol=1e-6)  # 8x
    # an op registered without a backward carries no graph
    assert not port.ext_dot_bias(px, px).requires_grad


def test_under_trainstep_matches_reference(modules):
    """Three SGD(0.1) steps of loss sum(ext_scale2(w) * x), w = ones(4)."""
    ref, port = modules
    x = np.array([1.0, 2.0, -1.0, 0.5], np.float32)

    class RefModel(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter(
                [4], default_initializer=pt.nn.initializer.Constant(1.0))

        def forward(self, a):
            return (ref.ext_scale2(self.w) * a).sum()

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4))

        def forward(self, a):
            return (port.ext_scale2(self.w) * a).sum()

    rm = RefModel()
    ref_step = RefTrainStep(rm, lambda m, a: m(a),
                            pt.optimizer.SGD(0.1, parameters=rm.parameters()),
                            donate=False)
    want = [float(ref_step(pt.to_tensor(x))) for _ in range(3)]
    m = Model()
    step = TrainStep(m, lambda mm, a: mm(a),
                     SGD(0.1, parameters=m.parameters()))
    got = [float(step(x)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]


def test_compile_error_raises(tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++")
    with pytest.raises(InvalidArgumentError, match="failed to compile"):
        cpp_extension.load(name="torch_bad_ext", sources=[str(bad)],
                           functions={"x": {"out_shape": lambda s: s}},
                           build_directory=str(tmp_path))
    with pytest.raises(InvalidArgumentError, match="functions"):
        cpp_extension.load(name="torch_bad_ext", sources=[str(bad)],
                           functions={}, build_directory=str(tmp_path))


def test_reload_registers_versioned_names(tmp_path):
    """Loading a name again binds the new library under a versioned
    registry name (registry names are unique)."""
    src = tmp_path / "ops.cc"
    name = "torch_reload_ext_%d" % os.getpid()
    mods = []
    for factor in ("2.0f", "3.0f"):
        src.write_text(SOURCE.replace("2.0f", factor))
        mods.append(cpp_extension.load(
            name=name, sources=[str(src)],
            functions={"ext_scale2": {"out_shape": lambda s: s}},
            build_directory=str(tmp_path)))
    x = torch.ones(3)
    assert float(mods[0].ext_scale2(x)[0]) == 2.0
    assert float(mods[1].ext_scale2(x)[0]) == 3.0
    ops = registered_custom_ops()
    assert ops["%s.ext_scale2" % name] is mods[0].ext_scale2
    assert ops["%s.ext_scale2#v1" % name] is mods[1].ext_scale2
    assert mods[0]._library_path != mods[1]._library_path
