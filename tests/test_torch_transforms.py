"""The port's ``vision/transforms`` against the reference's on the CPU:
each functional form, each class transform, and the random ones under
``random.seed`` (the same draws in the same order give the same crops,
flips, angles and jitter in both packages), on uint8 and float HWC
arrays made with numpy from a seed.

Tolerance: equal arrays (the same numpy arithmetic); ``to_tensor`` and
``normalize`` on tensors within 1e-6.  ``to_tensor`` returns a CPU
``torch.Tensor`` where the reference returns its Tensor.  Without PIL,
``resize`` raises ``UnavailableError`` naming it.
"""
import random

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.vision import transforms as R

from paddle_tpu_torch import UnavailableError
from paddle_tpu_torch.vision import transforms as T


def _img(seed=0, h=20, w=24, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return (rng.rand(h, w, 3) * 255).astype(np.uint8)
    return rng.rand(h, w, 3).astype(np.float32)


def _value(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "value"):
        return np.asarray(x.value)
    return np.asarray(x)


def _same(got, want, tol=0.0):
    got, want = _value(got), _value(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if tol:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(got, want)


FUNCTIONAL = [
    ("crop", (3, 4, 10, 12)), ("center_crop", (11,)),
    ("center_crop", ((9, 13),)), ("hflip", ()), ("vflip", ()),
    ("pad", (2,)), ("pad", ((1, 3),)), ("pad", ((1, 2, 3, 4), 7)),
    ("pad", ((2, 1, 0, 3), 0, "reflect")), ("pad", ((2, 2), 0, "edge")),
    ("adjust_brightness", (1.4,)), ("adjust_contrast", (0.6,)),
    ("adjust_saturation", (1.7,)), ("adjust_hue", (0.2,)),
    ("adjust_hue", (-0.45,)), ("to_grayscale", ()), ("to_grayscale", (3,)),
    ("rotate", (30.0,)), ("rotate", (-75.0, "bilinear")),
    ("rotate", (45.0, "nearest", True)),
    ("rotate", (10.0, "bilinear", False, (5, 7), 9)),
    ("resize", (12,)), ("resize", ((15, 9), "nearest")),
    ("resize", ((30, 31), "bicubic")),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("case", range(len(FUNCTIONAL)))
def test_functional_matches_reference(case, dtype):
    name, args = FUNCTIONAL[case]
    if name == "resize" and dtype == np.float32:
        pytest.importorskip("PIL")
        img = _img(case, dtype=np.uint8)[..., :1]  # a one-channel image
    else:
        img = _img(case, dtype=dtype)
    _same(getattr(T, name)(img, *args), getattr(R, name)(img, *args))


def test_to_tensor_and_normalize():
    img = _img(1)
    got = T.to_tensor(img)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _same(got, R.to_tensor(img), 1e-6)
    _same(T.to_tensor(img, "HWC"), R.to_tensor(img, "HWC"), 1e-6)
    _same(T.to_tensor(img[..., 0]), R.to_tensor(img[..., 0]), 1e-6)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    for fmt, to_rgb in (("CHW", False), ("CHW", True)):
        out = T.normalize(got, mean, std, fmt, to_rgb)
        assert isinstance(out, torch.Tensor)
        _same(out, R.normalize(R.to_tensor(img), mean, std, fmt, to_rgb),
              1e-6)
    hwc = img.astype(np.float32)
    _same(T.normalize(hwc, mean, std, "HWC"),
          R.normalize(hwc, mean, std, "HWC"), 1e-6)


def _pipeline(pkg, size=16):
    return pkg.Compose([
        pkg.RandomResizedCrop(size), pkg.RandomHorizontalFlip(),
        pkg.RandomVerticalFlip(0.3),
        pkg.ColorJitter(0.4, 0.4, 0.4, 0.1), pkg.RandomRotation(20),
        pkg.RandomCrop(12, padding=2, pad_if_needed=True),
        pkg.Grayscale(3), pkg.Transpose(), pkg.ToTensor("HWC"),
    ])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_transforms_draw_as_the_reference(seed):
    pytest.importorskip("PIL")
    img = _img(seed, 40, 36)
    random.seed(seed)
    want = [_value(_pipeline(R)(img)) for _ in range(3)]
    random.seed(seed)
    got = [_value(_pipeline(T)(img)) for _ in range(3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert not np.array_equal(got[0], got[1])  # the draws moved


CLASSES = [
    ("RandomCrop", (16,), {}), ("RandomCrop", ((30, 8),),
                               dict(pad_if_needed=True)),
    ("RandomCrop", (12,), dict(padding=3, padding_mode="reflect")),
    ("RandomHorizontalFlip", (0.5,), {}), ("RandomVerticalFlip", (0.5,), {}),
    ("BrightnessTransform", (0.5,), {}), ("ContrastTransform", (0.5,), {}),
    ("SaturationTransform", (0.5,), {}), ("HueTransform", (0.3,), {}),
    ("RandomRotation", ((-40, 10),), dict(interpolation="bilinear")),
    ("CenterCrop", (10,), {}), ("Pad", ((1, 2),), dict(fill=3)),
    ("Transpose", ((1, 0, 2),), {}), ("Grayscale", (), {}),
    ("Normalize", (0.5, 0.25), dict(data_format="HWC")),
]


@pytest.mark.parametrize("case", range(len(CLASSES)))
def test_class_transforms_match_reference(case):
    name, args, kw = CLASSES[case]
    img = _img(case + 10)
    for trial in range(4):
        random.seed(trial)
        want = getattr(R, name)(*args, **kw)(img)
        random.seed(trial)
        got = getattr(T, name)(*args, **kw)(img)
        _same(got, want, 1e-6 if name == "Normalize" else 0.0)


def test_refusals():
    with pytest.raises(Exception, match="non-negative"):
        T.BrightnessTransform(-1)
    with pytest.raises(Exception, match="hue"):
        T.HueTransform(0.7)
    with pytest.raises(Exception, match="hue_factor"):
        T.adjust_hue(_img(), 0.9)
    with pytest.raises(Exception, match="degrees"):
        T.RandomRotation(-5)


def test_resize_names_pil_when_absent(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(UnavailableError, match="PIL"):
        T.resize(_img(), 8)
    # the host pipeline of the card's phase needs no PIL
    pipe = T.Compose([T.RandomCrop(16), T.RandomHorizontalFlip(),
                      T.ToTensor(), T.Normalize([0.5] * 3, [0.25] * 3)])
    assert tuple(pipe(_img()).shape) == (3, 16, 16)


def test_reference_tensor_input_to_normalize_matches():
    img = _img(4)
    want = R.normalize(pt.to_tensor(R.to_tensor(img).value), 0.5, 0.5)
    got = T.normalize(T.to_tensor(img), 0.5, 0.5)
    _same(got, want, 1e-6)
