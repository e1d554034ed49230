"""Image preprocessing (counterpart of the reference's
``vision/transforms``): the functional forms and the ``BaseTransform``
classes, on numpy HWC arrays (uint8 or float) or PIL images, on the host.

``to_tensor`` (and ``ToTensor``) ends the host part: a CHW float32 CPU
``torch.Tensor`` in [0, 1] for uint8 input, which a loader pins and
uploads; ``normalize`` keeps a tensor a tensor.  The random transforms
draw from Python's ``random`` in the reference's order, so
``random.seed(s)`` gives both packages the same crops, flips, angles and
jitter.  ``resize`` (and ``Resize``, ``RandomResizedCrop``) uses PIL,
imported when called; without PIL it raises ``UnavailableError`` naming
it.  The colour and rotation transforms are numpy, as the reference's.
"""
from __future__ import annotations

import numbers
import random
from typing import Sequence

import numpy as np
import torch

from ...core.errors import InvalidArgumentError, UnavailableError

__all__ = [
    "Compose", "ToTensor", "Normalize", "Resize", "CenterCrop", "RandomCrop",
    "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose", "Pad",
    "BrightnessTransform", "ContrastTransform", "SaturationTransform",
    "HueTransform", "ColorJitter", "Grayscale", "RandomRotation",
    "RandomResizedCrop", "to_tensor", "normalize",
    "resize", "center_crop", "crop", "hflip", "vflip", "pad",
    "adjust_brightness", "adjust_contrast", "adjust_saturation",
    "adjust_hue", "rotate", "to_grayscale",
]


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise UnavailableError(
            "vision.transforms.resize needs PIL (the Pillow package), which "
            "is not installed") from e
    return Image


def _to_numpy(img) -> np.ndarray:
    """An array of ``img``: a numpy array, a PIL image or a tensor."""
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


# -- functional (vision/transforms/functional.py parity) --------------------

def to_tensor(pic, data_format: str = "CHW"):
    """HWC uint8 [0, 255] -> a CHW float32 CPU tensor in [0, 1]."""
    arr = _to_numpy(pic)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr))


def normalize(img, mean, std, data_format: str = "CHW", to_rgb: bool = False):
    is_tensor = isinstance(img, torch.Tensor)
    arr = _to_numpy(img).astype(np.float32)
    if to_rgb:  # reference semantics: input is BGR, reverse channels first
        arr = arr[::-1] if data_format == "CHW" else arr[..., ::-1]
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    shape = ([-1, 1, 1] if data_format == "CHW" else [1, 1, -1])
    out = (arr - mean.reshape(shape)) / std.reshape(shape)
    if is_tensor:
        return torch.from_numpy(np.ascontiguousarray(out)).to(img.device)
    return out


def resize(img, size, interpolation: str = "bilinear"):
    arr = _to_numpy(img)
    Image = _pil_image()
    modes = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
             "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}
    if interpolation not in modes:
        raise InvalidArgumentError("unknown interpolation %r" % interpolation)
    h, w = arr.shape[:2]
    if isinstance(size, int):
        if w <= h:
            ow, oh = size, int(size * h / w)
        else:
            oh, ow = size, int(size * w / h)
    else:
        oh, ow = size
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    pil = Image.fromarray(arr.squeeze(-1) if squeeze else arr)
    out = np.asarray(pil.resize((ow, oh), modes[interpolation]))
    if squeeze:
        out = out[:, :, None]
    return out


def crop(img, top: int, left: int, height: int, width: int):
    arr = _to_numpy(img)
    return arr[top:top + height, left:left + width]


def center_crop(img, output_size):
    arr = _to_numpy(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = arr.shape[:2]
    th, tw = output_size
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return crop(arr, top, left, th, tw)


def hflip(img):
    return _to_numpy(img)[:, ::-1].copy()


def vflip(img):
    return _to_numpy(img)[::-1].copy()


def pad(img, padding, fill=0, padding_mode: str = "constant"):
    arr = _to_numpy(img)
    if isinstance(padding, int):
        padding = (padding,) * 4
    elif len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = padding
    widths = [(top, bottom), (left, right)] + [(0, 0)] * (arr.ndim - 2)
    if padding_mode == "constant":
        return np.pad(arr, widths, mode="constant", constant_values=fill)
    return np.pad(arr, widths, mode=padding_mode)


# -- class transforms (vision/transforms/transforms.py parity) --------------

class Compose:
    """The transforms applied in order."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    """transforms.py BaseTransform (simplified single-input form)."""

    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    def __init__(self, data_format: str = "CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format: str = "CHW",
                 to_rgb: bool = False, keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean, self.std = mean, std
        self.data_format = data_format
        self.to_rgb = to_rgb

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format,
                         self.to_rgb)


class Resize(BaseTransform):
    def __init__(self, size, interpolation: str = "bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed: bool = False,
                 fill=0, padding_mode: str = "constant", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        arr = _to_numpy(img)
        if self.padding is not None:
            arr = pad(arr, self.padding, self.fill, self.padding_mode)
        th, tw = self.size
        h, w = arr.shape[:2]
        if self.pad_if_needed and (h < th or w < tw):
            arr = pad(arr, (max(0, tw - w), max(0, th - h)), self.fill,
                      self.padding_mode)
            h, w = arr.shape[:2]
        if h == th and w == tw:
            return arr
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return crop(arr, top, left, th, tw)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return hflip(img)
        return _to_numpy(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return vflip(img)
        return _to_numpy(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = tuple(order)

    def _apply_image(self, img):
        arr = _to_numpy(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode: str = "constant",
                 keys=None):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class BrightnessTransform(BaseTransform):
    def __init__(self, value: float, keys=None):
        if value < 0:
            raise InvalidArgumentError("brightness value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        arr = _to_numpy(img)
        if self.value == 0:
            return arr
        factor = random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        if arr.dtype == np.uint8:
            return np.clip(arr.astype(np.float32) * factor, 0,
                           255).astype(np.uint8)
        return (arr * np.asarray(factor, arr.dtype))  # float stays float


# -- photometric functional ops (transforms/functional.py parity) ----------

def _as_float(arr):
    was_uint8 = arr.dtype == np.uint8
    return arr.astype(np.float32), was_uint8


def _restore(arr, was_uint8):
    if was_uint8:
        return np.clip(arr, 0, 255).astype(np.uint8)
    return arr.astype(np.float32)


def adjust_brightness(img, brightness_factor: float):
    arr, u8 = _as_float(_to_numpy(img))
    return _restore(arr * brightness_factor, u8)


def to_grayscale(img, num_output_channels: int = 1):
    arr = _to_numpy(img)
    gray = (arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114)
    gray = gray[..., None]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=-1)
    return gray.astype(arr.dtype)


def adjust_contrast(img, contrast_factor: float):
    arr, u8 = _as_float(_to_numpy(img))
    mean = to_grayscale(arr).mean()
    return _restore(arr * contrast_factor + mean * (1 - contrast_factor), u8)


def adjust_saturation(img, saturation_factor: float):
    arr, u8 = _as_float(_to_numpy(img))
    gray = to_grayscale(arr)
    return _restore(arr * saturation_factor
                    + gray * (1 - saturation_factor), u8)


def adjust_hue(img, hue_factor: float):
    """Shift hue by hue_factor (in [-0.5, 0.5]) via HSV round-trip."""
    if not -0.5 <= hue_factor <= 0.5:
        raise InvalidArgumentError(
            "hue_factor must be in [-0.5, 0.5], got %s" % hue_factor)
    arr = _to_numpy(img)
    f, u8 = _as_float(arr)
    f = f / 255.0 if u8 else f
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    maxc = f[..., :3].max(-1)
    minc = f[..., :3].min(-1)
    v = maxc
    span = maxc - minc
    s = np.where(maxc > 0, span / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(span, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(span > 0, (h / 6.0) % 1.0, 0.0)
    h = (h + hue_factor) % 1.0
    # hsv -> rgb
    i = np.floor(h * 6.0)
    fr = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * fr)
    t = v * (1.0 - s * (1.0 - fr))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return _restore(out * 255.0 if u8 else out, u8)


def rotate(img, angle: float, interpolation: str = "nearest",
           expand: bool = False, center=None, fill=0):
    """Rotate counter-clockwise by angle degrees (inverse affine map)."""
    arr = _to_numpy(img)
    was_2d = arr.ndim == 2
    if was_2d:
        arr = arr[:, :, None]
    H, W = arr.shape[:2]
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    cy, cx = ((H - 1) / 2.0, (W - 1) / 2.0) if center is None \
        else (center[1], center[0])
    if expand:
        newW = int(np.ceil(abs(W * cos) + abs(H * sin)))
        newH = int(np.ceil(abs(W * sin) + abs(H * cos)))
    else:
        newW, newH = W, H
    ys, xs = np.meshgrid(np.arange(newH), np.arange(newW), indexing="ij")
    # destination center
    dy, dx = (newH - 1) / 2.0, (newW - 1) / 2.0
    yy = ys - (dy if expand else cy)
    xx = xs - (dx if expand else cx)
    # inverse rotation back into source coords
    sx = cos * xx - sin * yy + cx
    sy = sin * xx + cos * yy + cy
    if interpolation == "bilinear":
        x0 = np.floor(sx).astype(np.int64)
        y0 = np.floor(sy).astype(np.int64)
        wx = (sx - x0)[..., None]
        wy = (sy - y0)[..., None]

        def take(yi, xi):
            inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            v = arr[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)].astype(
                np.float32)
            v[~inside] = fill
            return v

        out = (take(y0, x0) * (1 - wy) * (1 - wx)
               + take(y0, x0 + 1) * (1 - wy) * wx
               + take(y0 + 1, x0) * wy * (1 - wx)
               + take(y0 + 1, x0 + 1) * wy * wx)
        out = out.astype(arr.dtype) if arr.dtype != np.uint8 \
            else np.clip(out, 0, 255).astype(np.uint8)
    else:
        xi = np.round(sx).astype(np.int64)
        yi = np.round(sy).astype(np.int64)
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        out = arr[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)].copy()
        out[~inside] = fill
    return out[:, :, 0] if was_2d else out


# -- photometric / geometric transform classes ------------------------------

class ContrastTransform(BaseTransform):
    def __init__(self, value: float, keys=None):
        if value < 0:
            raise InvalidArgumentError("contrast value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _to_numpy(img)
        factor = random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value: float, keys=None):
        if value < 0:
            raise InvalidArgumentError(
                "saturation value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _to_numpy(img)
        factor = random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value: float, keys=None):
        if not 0 <= value <= 0.5:
            raise InvalidArgumentError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _to_numpy(img)
        return adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue in random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self._transforms = [
            BrightnessTransform(brightness), ContrastTransform(contrast),
            SaturationTransform(saturation), HueTransform(hue),
        ]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self._transforms[i]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels: int = 1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation: str = "nearest",
                 expand: bool = False, center=None, fill=0, keys=None):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise InvalidArgumentError(
                    "degrees must be non-negative when scalar")
            self.degrees = (-float(degrees), float(degrees))
        else:
            self.degrees = (float(degrees[0]), float(degrees[1]))
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, self.interpolation, self.expand,
                      self.center, self.fill)


class RandomResizedCrop(BaseTransform):
    """Random area/aspect crop resized to a fixed size (inception-style)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation: str = "bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _sample(self, H, W):
        area = H * W
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = np.exp(random.uniform(*log_ratio))
            w = int(round(np.sqrt(target * aspect)))
            h = int(round(np.sqrt(target / aspect)))
            if 0 < w <= W and 0 < h <= H:
                i = random.randint(0, H - h)
                j = random.randint(0, W - w)
                return i, j, h, w
        # fallback: center crop at the closest valid aspect
        in_ratio = W / H
        if in_ratio < self.ratio[0]:
            w, h = W, int(round(W / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            h, w = H, int(round(H * self.ratio[1]))
        else:
            w, h = W, H
        return (H - h) // 2, (W - w) // 2, h, w

    def _apply_image(self, img):
        arr = _to_numpy(img)
        i, j, h, w = self._sample(arr.shape[0], arr.shape[1])
        return resize(arr[i:i + h, j:j + w], self.size, self.interpolation)
