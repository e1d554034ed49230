"""Legacy image helpers (``paddle.dataset.image``).

Reference: ``python/paddle/dataset/image.py:76-410``. HWC uint8 numpy in,
numpy out; decoding prefers cv2 and falls back to PIL (the reference is
cv2-only). These are host-side preprocessing utilities — device-side
augmentation lives in ``paddle_tpu_torch.vision.transforms``.
"""
from __future__ import annotations

import io
import pickle
import tarfile

import numpy as np

__all__ = []


def _decode(data, is_color):
    try:
        import cv2

        flag = cv2.IMREAD_COLOR if is_color else cv2.IMREAD_GRAYSCALE
        img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        if img is None:
            raise ValueError("cv2 failed to decode image bytes")
        return img
    except ImportError:
        from PIL import Image

        img = Image.open(io.BytesIO(data))
        img = img.convert("RGB" if is_color else "L")
        arr = np.asarray(img)
        # match cv2's BGR channel order so downstream mean values line up
        return arr[:, :, ::-1] if is_color else arr


def load_image_bytes(bytes, is_color=True):  # noqa: A002
    """Decode an in-memory encoded image to HWC (color) / HW (gray)."""
    return _decode(bytes, is_color)


def load_image(file, is_color=True):  # noqa: A002
    """Load and decode an image file."""
    with open(file, "rb") as f:
        return _decode(f.read(), is_color)


def resize_short(im, size):
    """Resize so the shorter edge equals ``size``, keeping aspect ratio."""
    h, w = im.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    try:
        import cv2

        return cv2.resize(im, (new_w, new_h),
                          interpolation=cv2.INTER_CUBIC)
    except ImportError:
        from PIL import Image

        mode = Image.fromarray(im)
        return np.asarray(mode.resize((new_w, new_h), Image.BICUBIC))


def to_chw(im, order=(2, 0, 1)):
    """HWC → CHW (or any axis permutation)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    """Crop the center ``size``×``size`` patch."""
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    if is_color:
        return im[h_start:h_start + size, w_start:w_start + size, :]
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im, size, is_color=True):
    """Crop a random ``size``×``size`` patch."""
    h, w = im.shape[:2]
    h_start = np.random.randint(0, h - size + 1)
    w_start = np.random.randint(0, w - size + 1)
    if is_color:
        return im[h_start:h_start + size, w_start:w_start + size, :]
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im, is_color=True):
    """Mirror horizontally."""
    if len(im.shape) == 3 and is_color:
        return im[:, ::-1, :]
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize-short → (random crop + coin-flip mirror | center crop) →
    CHW float32 → optional mean subtraction (per-channel or elementwise)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and is_color:
            mean = mean[:, np.newaxis, np.newaxis]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    """:func:`load_image` then :func:`simple_transform`."""
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pickle (image-bytes, label) batches out of a tar of images.

    Writes ``<data_file>_batch/<dataset_name>_%05d`` files plus a
    ``meta`` file listing them; returns the meta path (the reference's
    preprocessing helper for cluster training, ``image.py:76``)."""
    import os

    out_path = "%s_batch" % data_file
    meta_file = os.path.join(out_path, "%s_batch.meta" % dataset_name)
    # the meta file is written LAST, so its presence means a complete
    # build; a bare directory from a crashed run is rebuilt, not trusted
    if os.path.exists(meta_file):
        return meta_file
    os.makedirs(out_path, exist_ok=True)

    labels, data, file_id = [], [], 0
    with tarfile.open(data_file) as tf:
        for member in tf.getmembers():
            if member.name in img2label:
                data.append(tf.extractfile(member).read())
                labels.append(img2label[member.name])
                if len(data) == num_per_batch:
                    output = {"label": labels, "data": data}
                    with open(os.path.join(
                            out_path, "%s_%05d" % (dataset_name, file_id)),
                            "wb") as f:
                        pickle.dump(output, f, protocol=2)
                    file_id += 1
                    data, labels = [], []
    if data:
        output = {"label": labels, "data": data}
        with open(os.path.join(out_path, "%s_%05d"
                               % (dataset_name, file_id)), "wb") as f:
            pickle.dump(output, f, protocol=2)

    with open(meta_file, "w") as meta:  # "w": a rebuild must not append
        for file in sorted(os.listdir(out_path)):
            if not file.endswith(".meta"):
                meta.write(os.path.abspath(
                    os.path.join(out_path, file)) + "\n")
    return meta_file
