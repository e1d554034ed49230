"""The port's model zoo against the reference's on the CPU: the ten
families beside LeNet and ResNet -- MobileNetV1, V2 and V3 (Small and
Large), VGG (with and without BatchNorm), AlexNet, SqueezeNet 1.0 and
1.1, ShuffleNetV2, DenseNet, GoogLeNet (its three outputs) and
InceptionV3 -- each at its published width and 1000 classes, and one
train-mode ``TrainStep`` of MobileNetV2 with its running statistics.

The reference builds each model with its initializers' draws taken from
numpy (``_numpy_draws``: the values do not matter, they are carried
across, and XLA compiles no random kernel per parameter shape); the
port's model gets the reference's parameters and BatchNorm buffers by
``load_reference_params``, with no renaming.  The reference runs its
forward through ``jit.to_static`` (one compile a model).  Images are
small where the architecture allows: 32 px, 64 px for AlexNet and
SqueezeNet, 75 px for InceptionV3 (its stem's minimum).  Tolerances,
fp32: eval logits within 1e-4 of their largest magnitude (deep stacks of
convolutions summed in another order); the MobileNetV2 step's losses
1e-5 relative, its running statistics and its classifier's update
within 1e-4 of each array's largest magnitude.  Dropout's masks are
torch's, so the train-mode step runs with the classifier's dropout at
p 0; dropout itself is held by its invariants.
"""
import contextlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.vision.models as RM

from paddle_tpu_torch import (InvalidArgumentError, TrainStep,
                              UnavailableError, load_reference_params,
                              optimizer, regularizer)
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.vision import models as M


@contextlib.contextmanager
def _numpy_draws(seed):
    """The reference's ``jax.random.normal``/``uniform`` served by a numpy
    generator while a model is built."""
    rng = np.random.RandomState(seed)

    def normal(key, shape=(), dtype=None):
        return np.asarray(rng.standard_normal(shape), np.float32)

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return np.asarray(rng.uniform(minval, maxval, shape), np.float32)

    with mock.patch.object(jax.random, "normal", normal), \
            mock.patch.object(jax.random, "uniform", uniform):
        yield


def _arrays(ref):
    out = {n: np.asarray(p.value) for n, p in ref.named_parameters()}
    out.update({n: np.asarray(b.value) for n, b in ref.named_buffers()})
    return out


def _pair(name, seed=0, **kw):
    with _numpy_draws(seed):
        ref = getattr(RM, name)(**kw)
    port = getattr(M, name)(device="cpu", **kw)
    arrays = _arrays(ref)
    load_reference_params(port, arrays)
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(p.shape)) for p in ref.parameters())
    return ref, port


# (constructor, keyword arguments, image side): one entry a family at
# its published width and 1000 classes, a few with the head cut or a
# width or depth option.  DenseNet-121 keeps its widths (64 stem
# channels, growth 32, bottleneck 4 x 32) at fewer layers a block: the
# full 6/12/24/16 costs ~35 s of XLA compilation for the same modules.
FAMILIES = [
    ("mobilenet_v1", {}, 32), ("mobilenet_v2", {}, 32),
    ("mobilenet_v3_large", {}, 32),
    ("mobilenet_v3_small", dict(num_classes=10), 32),
    ("vgg16", dict(batch_norm=True), 32), ("alexnet", {}, 64),
    ("squeezenet1_0", {}, 64), ("squeezenet1_1", {}, 64),
    ("shufflenet_v2_x1_0", {}, 32),
    ("densenet121", dict(block_config=(2, 3, 4, 2)), 32),
    ("googlenet", {}, 32), ("inception_v3", {}, 75),
]


def _id(name, kw):
    return name + "".join("-%s%s" % (k, "".join(map(str, v))
                                     if isinstance(v, tuple) else v)
                          for k, v in kw.items())


# the headless variants repeat their family's modules: behind ``slow``
HEADLESS = [("mobilenet_v1", dict(num_classes=0), 32),
            ("mobilenet_v2", dict(num_classes=0, with_pool=False), 32)]


@pytest.mark.parametrize(
    "name,kw,side",
    FAMILIES + [pytest.param(*c, marks=pytest.mark.slow) for c in HEADLESS],
    ids=[_id(n, k) for n, k, _ in FAMILIES + HEADLESS])
def test_eval_logits_match_reference(name, kw, side):
    ref, port = _pair(name, **kw)
    ref.eval()
    port.eval()
    x = np.random.RandomState(1).randn(2, 3, side, side).astype(np.float32)
    want = pt.jit.to_static(ref)(pt.to_tensor(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if name == "googlenet":  # (out, aux1, aux2) in eval mode too
        assert isinstance(got, tuple) and len(got) == 3
        pairs = list(zip(got, want))
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        w = np.asarray(w.value)
        assert g.shape == w.shape
        if kw.get("num_classes", 1000) == 1000 and "with_pool" not in kw:
            assert w.shape == (2, 1000)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_mobilenet_v2_train_step_matches_reference():
    """``TrainStep`` of the full-width MobileNetV2 on 4 x 3 x 64 x 64 with
    Momentum and L2Decay(4e-5) (the paper's decay): two calls at learning
    rate 0, whose losses must equal the reference's and after each of
    which every BatchNorm's running statistics must equal the reference's
    (advanced once a call), then one call at 0.01 whose classifier update
    must equal the reference's.  The backbone's update is not compared:
    a ReLU6 input within the two packages' rounding of 0 (2 of the last
    block's 15360 are under 1e-4) takes the mask the other way, and the
    BatchNorm backward spreads that element over its channel."""
    from paddle_tpu.jit import TrainStep as RefTrainStep

    ref, port = _pair("mobilenet_v2")
    ref.classifier[0].p = 0.0
    port.classifier[0].p = 0.0
    rng = np.random.RandomState(2)
    x = rng.randn(4, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 1000, (4,)).astype(np.int64)
    rcrit, crit = pt.nn.CrossEntropyLoss(), pnn.CrossEntropyLoss()
    ropt = pt.optimizer.Momentum(
        0.0, parameters=ref.parameters(),
        weight_decay=pt.regularizer.L2Decay(4e-5))
    opt = optimizer.Momentum(0.0, parameters=port.parameters(),
                             weight_decay=regularizer.L2Decay(4e-5))
    rstep = RefTrainStep(ref, lambda m, a, b: rcrit(m(a), b), ropt)
    step = TrainStep(port, lambda m, a, b: crit(m(a), b), opt)
    for call in range(2):
        want = float(np.asarray(rstep(x, y).value))
        np.testing.assert_allclose(float(step(x, y)), want, rtol=1e-5)
        arrays = _arrays(ref)
        stats = dict(port.named_buffers())
        assert len(stats) == 2 * 52
        for n, b in stats.items():
            w = arrays[n]
            # a BatchNorm whose input is a linear map of another's output
            # has a running mean of 0 in exact arithmetic (rounding noise,
            # ~1e-7): held at 1e-6 absolute
            np.testing.assert_allclose(
                b.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-2),
                err_msg="call %d: %s" % (call, n))
        assert np.abs(stats["features.0.1._mean"].numpy()).max() > 0
    ropt.set_lr(0.01)
    opt.set_lr(0.01)
    rstep(x, y)
    step(x, y)
    arrays = _arrays(ref)
    for n, p in port.classifier.named_parameters():
        w = arrays["classifier." + n]
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=n)


def test_dropout_in_the_zoo_is_dropout():
    model = M.squeezenet1_1(device="cpu").train()
    x = torch.randn(2, 3, 64, 64)
    torch.manual_seed(0)
    a = model(x)
    b = model(x)
    assert not torch.equal(a, b)  # fresh masks each call
    model.eval()
    assert torch.equal(model(x), model(x))


def test_constructor_checks():
    for fn in (M.mobilenet_v2, M.vgg16, M.alexnet):
        with pytest.raises(NotImplementedError):
            fn(pretrained=True, device="cpu")
    with pytest.raises(InvalidArgumentError):
        M.SqueezeNet("2.0", device="cpu")
    with pytest.raises(InvalidArgumentError):
        M.ShuffleNetV2(0.75, device="cpu")
    with pytest.raises(InvalidArgumentError):
        M.DenseNet(100, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError):
            M.mobilenet_v1()


def test_zoo_exports_match_reference():
    assert sorted(M.__all__) == sorted(RM.__all__)
    import paddle_tpu.vision as rvision

    import paddle_tpu_torch.vision as pvision

    for mod in ("models", "ops", "transforms"):
        assert mod in pvision.__all__ and mod in rvision.__all__
    assert sorted(pvision.ops.__all__) == sorted(rvision.ops.__all__)
    assert sorted(pvision.transforms.__all__) == sorted(
        rvision.transforms.__all__)
