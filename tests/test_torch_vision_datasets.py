"""``vision.datasets`` and the image backend of the port against the
reference's on the CPU: MNIST/FashionMNIST (IDX), Cifar10/100 (the
python-pickle tarballs), Flowers, VOC2012, DatasetFolder and ImageFolder
on the same files, written from numpy seed 0.  Samples, labels, class
lists and typed errors are equal, not close.
"""
import os

import numpy as np
import pytest

import paddle_tpu.vision as rvision
import paddle_tpu.vision.datasets as rvd
from paddle_tpu.core.errors import InvalidArgumentError as RefInvalid

import paddle_tpu_torch as ptt
import paddle_tpu_torch.vision as pvision
import paddle_tpu_torch.vision.datasets as pvd
from paddle_tpu_torch.core.errors import InvalidArgumentError

from torch_data import (assert_same, dataset_items, png_bytes, write_cifar,
                        write_flowers, write_folder, write_idx, write_voc)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vision_data"))
    rng = np.random.RandomState(0)
    out = {"idx": write_idx(d, "train", 6),
           "idx_raw": write_idx(d, "t10k", 4, gz=False),
           "cifar10": write_cifar(os.path.join(d, "c10.tar.gz"), rng, 10),
           "cifar100": write_cifar(os.path.join(d, "c100.tar.gz"), rng, 100),
           "flowers": write_flowers(d, rng),
           "voc": write_voc(d, rng),
           "folder": write_folder(os.path.join(d, "folder"), rng)}
    nested = os.path.join(d, "imgs", "sub")
    os.makedirs(nested)
    np.save(os.path.join(d, "imgs", "a.npy"),
            rng.randint(0, 255, (4, 4, 3)).astype(np.uint8))
    np.save(os.path.join(nested, "b.npy"),
            rng.randint(0, 255, (4, 4, 3)).astype(np.uint8))
    with open(os.path.join(d, "imgs", "c.png"), "wb") as f:
        f.write(png_bytes(rng.randint(0, 255, (5, 5, 3)).astype(np.uint8)))
    with open(os.path.join(d, "imgs", "notes.txt"), "w") as f:
        f.write("skip me")
    out["imgs"] = os.path.join(d, "imgs")
    return out


def _scale(x):
    return x.astype("float32") / 255.0


# (class name, builder of its keyword arguments from the files)
CASES = [
    ("MNIST", lambda f: dict(image_path=f["idx"][0], label_path=f["idx"][1],
                             mode="train")),
    ("MNIST", lambda f: dict(image_path=f["idx_raw"][0],
                             label_path=f["idx_raw"][1], mode="test")),
    ("FashionMNIST", lambda f: dict(image_path=f["idx"][0],
                                    label_path=f["idx"][1])),
    ("Cifar10", lambda f: dict(data_file=f["cifar10"], mode="train")),
    ("Cifar10", lambda f: dict(data_file=f["cifar10"], mode="test")),
    ("Cifar100", lambda f: dict(data_file=f["cifar100"], mode="train")),
    ("Flowers", lambda f: dict(data_file=f["flowers"][0],
                               label_file=f["flowers"][1],
                               setid_file=f["flowers"][2], mode="train")),
    ("Flowers", lambda f: dict(data_file=f["flowers"][0],
                               label_file=f["flowers"][1],
                               setid_file=f["flowers"][2], mode="valid")),
    ("VOC2012", lambda f: dict(data_file=f["voc"], mode="train")),
    ("VOC2012", lambda f: dict(data_file=f["voc"], mode="valid")),
    ("VOC2012", lambda f: dict(data_file=f["voc"], mode="test")),
    ("DatasetFolder", lambda f: dict(root=f["folder"])),
    ("DatasetFolder", lambda f: dict(root=f["folder"], transform=_scale)),
    ("ImageFolder", lambda f: dict(root=f["imgs"])),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_dataset_samples_match_the_reference(images, name, kw):
    ref = getattr(rvd, name)(**kw(images))
    port = getattr(pvd, name)(**kw(images))
    assert len(port) == len(ref) > 0
    assert_same(dataset_items(port), dataset_items(ref))
    for attr in ("classes", "class_to_idx", "targets", "labels"):
        if hasattr(ref, attr):
            assert_same(getattr(port, attr), getattr(ref, attr), attr)


@pytest.mark.parametrize("name,kw", [
    ("MNIST", {}), ("Cifar10", {}), ("Flowers", {}), ("VOC2012", {}),
    ("MNIST", {"download": True}), ("Cifar10", {"download": True}),
])
def test_refusals_match_the_reference(name, kw):
    with pytest.raises(RefInvalid):
        getattr(rvd, name)(**kw)
    with pytest.raises(InvalidArgumentError):
        getattr(pvd, name)(**kw)


def test_folder_refusals_match_the_reference(tmp_path):
    os.makedirs(str(tmp_path / "empty"))
    os.makedirs(str(tmp_path / "junk" / "cls"))
    (tmp_path / "junk" / "cls" / "x.txt").write_text("nope")
    for sub in ("empty", "junk"):
        with pytest.raises(RefInvalid):
            rvd.DatasetFolder(str(tmp_path / sub))
        with pytest.raises(InvalidArgumentError):
            pvd.DatasetFolder(str(tmp_path / sub))
    with pytest.raises(InvalidArgumentError):
        pvd.folder.has_valid_extension("a.png", ".png")


def test_image_backend_matches_the_reference(images):
    png = os.path.join(images["imgs"], "c.png")
    try:
        for V in (rvision, pvision):
            assert V.get_image_backend() == "cv2"
            V.set_image_backend("pil")
            assert V.get_image_backend() == "pil"
        assert np.array_equal(np.asarray(pvision.image_load(png)),
                              np.asarray(rvision.image_load(png)))
        assert_same(pvision.image_load(png, backend="cv2"),
                    rvision.image_load(png, backend="cv2"))
    finally:
        rvision.set_image_backend("cv2")
        pvision.set_image_backend("cv2")
    with pytest.raises(InvalidArgumentError):
        pvision.set_image_backend("skimage")


def test_folder_feeds_the_loader_workers(images):
    ds = pvd.DatasetFolder(images["folder"], transform=_scale)
    xs, ys = [], []
    for x, y in ptt.io.DataLoader(ds, batch_size=2, num_workers=2,
                                  device="cpu"):
        xs.append(x.numpy())
        ys.append(y.numpy())
    want = dataset_items(rvd.DatasetFolder(images["folder"],
                                           transform=_scale))
    np.testing.assert_array_equal(np.concatenate(xs),
                                  np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(np.concatenate(ys),
                                  [w[1] for w in want])
