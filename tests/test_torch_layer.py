"""``nn.Layer`` of the port against the reference's ``Layer`` on the CPU:
a user network written the same way in both packages (parameters,
buffers, a non-persistable buffer, sublayers, ``create_parameter``) has
the reference's parameter order, ``state_dict`` keys and order,
``set_state_dict`` results and hook behaviour; every layer and model
class of the port is an ``nn.Layer``; torch's own signatures still work.
Values compared exactly (copies, no arithmetic) or at 1e-6 (a forward).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.utils import unique_name as ref_unique_name

import paddle_tpu_torch as ptt
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          UnavailableError)
from paddle_tpu_torch.utils import unique_name

from torch_parity import build_pair


def _net_class(nn, to_tensor):
    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(2, 4, 3, padding=1)
            self.bn = nn.BatchNorm2D(4)

        def forward(self, x):
            return nn.functional.relu(self.bn(self.conv(x)))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = nn.LayerList([Block(), Block()])
            self.blocks[1].conv = nn.Conv2D(4, 4, 3, padding=1)
            self.head = nn.Linear(4 * 4 * 4, 3)
            self.scale = self.create_parameter([3], is_bias=True)
            self.register_buffer("steps", to_tensor(np.zeros([1],
                                                             np.float32)))
            self.register_buffer("scratch", to_tensor(
                np.ones([2], np.float32)), persistable=False)

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return self.head(x.reshape([x.shape[0], -1])) + self.scale

    return Net


def _pair():
    pt.seed(0)
    ref = _net_class(pt.nn, lambda a: pt.to_tensor(a))()
    port = _net_class(pnn, torch.from_numpy)()
    arrays = {n: np.asarray(p.value) for n, p in ref.named_parameters()}
    arrays.update({n: np.asarray(b.value)
                   for n, b in ref.named_buffers()})
    with torch.no_grad():
        for n, t in list(port.named_parameters()) + list(
                port.named_buffers()):
            t.copy_(torch.from_numpy(arrays[n]))
    return ref, port


def test_user_network_has_the_reference_structure():
    ref, port = _pair()
    assert isinstance(port, pnn.Layer) and isinstance(port, torch.nn.Module)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    assert list(port.state_dict()) == list(ref.state_dict())
    assert "scratch" not in port.state_dict() and \
        "blocks.0.bn._mean" in port.state_dict()
    assert [n for n, _ in port.named_sublayers()] == \
        [n for n, _ in ref.named_sublayers()]
    assert len(port.sublayers(include_self=True)) == \
        len(ref.sublayers(include_self=True))
    ps = port.parameters()
    assert isinstance(ps, list) and len(ps) == len(ref.parameters())
    assert len(port.parameters(include_sublayers=False)) == 1
    assert port.full_name() == ref.full_name() == "net"
    assert port._dtype == "float32"
    x = np.random.RandomState(0).randn(2, 2, 4, 4).astype(np.float32)
    ref.eval()
    port.eval()
    want = np.asarray(ref(pt.to_tensor(x)).value)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_set_state_dict_matches_reference():
    ref, port = _pair()
    sd = {k: np.asarray(v.value) for k, v in ref.state_dict().items()}
    partial = dict(list(sd.items())[2:])
    partial["not_a_key"] = np.zeros(1, np.float32)
    partial["head.bias"] = np.full([3], 7.0, np.float64)  # cast on copy
    want = ref.set_state_dict(dict(partial))
    got = port.set_state_dict(
        {k: torch.from_numpy(v) for k, v in partial.items()})
    assert got == want
    assert port.head.bias.dtype == torch.float32 and \
        torch.equal(port.head.bias, torch.full([3], 7.0))
    before = port.head.weight.data_ptr()
    port.load_dict({"head.weight": np.ones([64, 3], np.float32)})
    assert port.head.weight.data_ptr() == before  # copied in place
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        port.set_dict({"head.weight": np.ones([3, 64], np.float32)})


def test_hooks_and_mode_helpers():
    _, port = _pair()
    lin = port.head
    seen = []
    pre = lin.register_forward_pre_hook(lambda l, inp: (inp[0] * 0.0,))
    post = lin.register_forward_post_hook(
        lambda l, inp, out: seen.append(out.shape) or out + 1.0)
    out = lin(torch.ones(2, 64))
    assert torch.equal(out, lin.bias.detach().expand(2, 3) + 1.0)
    assert seen == [torch.Size([2, 3])]
    pre.remove()
    post.remove()
    assert torch.allclose(lin(torch.zeros(2, 64)), lin.bias)
    loss = port(torch.ones(2, 2, 4, 4)).sum()
    loss.backward()
    assert all(p.grad is not None for p in port.parameters())
    port.clear_gradients()
    assert all(p.grad is None for p in port.parameters())
    port.astype("float64")
    assert port.head.weight.dtype == torch.float64 and \
        port.blocks[0].bn._dtype == "float64"
    assert port.steps.dtype == torch.float64
    port.to(torch.float32)  # torch's positional form
    port.to(device="cpu", dtype="float32", blocking=True)
    assert port._dtype == "float32"
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError):
            port.to("gpu")
        with pytest.raises(UnavailableError):
            port.to(device="gpu:0")


def test_torch_signatures_still_work():
    _, port = _pair()
    assert len(list(port.parameters(recurse=False))) == 1
    names = [n for n, _ in port.named_parameters("pre", True)]
    assert names[:2] == ["pre.scale", "pre.blocks.0.conv.weight"]
    sd = port.state_dict(prefix="m.", keep_vars=True)
    assert sd["m.head.weight"] is port.head.weight
    dest = {}
    port.head.state_dict(dest, prefix="h.")
    assert set(dest) == {"h.weight", "h.bias"}
    port.register_buffer("tmp", torch.zeros(1), persistent=False)
    assert "tmp" not in port.state_dict()
    wrapper = torch.nn.Sequential(port)
    assert "0.head.weight" in wrapper.state_dict()
    port.load_state_dict(port.state_dict())


def test_every_parameter_has_a_name():
    lin = pnn.Linear(2, 3, weight_attr=ptt.ParamAttr(name="w_named"),
                     device="cpu")
    assert lin.weight.param_name == "w_named"
    assert lin.bias.param_name.startswith("param_")
    _, port = _pair()
    names = [p.param_name for p in port.parameters()]
    assert len(set(names)) == len(names)
    extra = torch.nn.Parameter(torch.zeros(2))
    port.add_parameter("extra", extra)
    assert extra.param_name.startswith("param_")
    assert port.add_sublayer("tail", pnn.ReLU()) is port.tail


def test_unique_name_matches_reference():
    with unique_name.guard(), ref_unique_name.guard():
        got = [unique_name.generate(k) for k in ("fc", "fc", "conv", "fc")]
        want = [ref_unique_name.generate(k)
                for k in ("fc", "fc", "conv", "fc")]
    assert got == want == ["fc_0", "fc_1", "conv_0", "fc_2"]


def _layer_classes():
    import inspect

    from paddle_tpu_torch import models, nn, vision
    from paddle_tpu_torch.nn import lora, ssm
    from paddle_tpu_torch.vision import models as vm

    out = {}
    for mod in (nn, vm, models, vision.ops, ssm, lora):
        for name, obj in vars(mod).items():
            if inspect.isclass(obj) and issubclass(obj, torch.nn.Module):
                out["%s.%s" % (mod.__name__, name)] = obj
    return out


def test_every_layer_and_model_class_is_a_layer():
    classes = _layer_classes()
    assert len(classes) > 120
    bad = sorted(n for n, c in classes.items() if not issubclass(c,
                                                                 pnn.Layer))
    assert not bad, bad


def test_models_are_layers_with_reference_state_dict_keys():
    ref, port = build_pair()
    assert isinstance(port, pnn.Layer)
    assert list(port.state_dict()) == list(ref.state_dict())
    pt.seed(0)
    from paddle_tpu.vision.models import LeNet as RefLeNet

    from paddle_tpu_torch.vision.models import LeNet
    assert list(LeNet(device="cpu").state_dict()) == \
        list(RefLeNet().state_dict())
