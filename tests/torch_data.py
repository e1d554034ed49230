"""Writers of the standard corpus and image formats for the data tests
of both packages, from numpy seeds (nothing is fetched), and a deep
equality that holds one package's samples against the other's.
"""
import gzip
import io
import os
import pickle
import tarfile
import zipfile

import numpy as np


def add_member(tf, name, payload):
    """Add ``payload`` (bytes or text) to an open tar as ``name``."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tf.addfile(info, io.BytesIO(payload))


def assert_same(got, want, path="sample"):
    """Recursive equality: arrays by dtype, shape and value; sequences
    and dicts item by item; everything else by ``==``."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want), (path, type(got), type(want))
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, "%s[%d]" % (path, i))
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], "%s[%r]" % (path, k))
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def dataset_items(ds):
    return [ds[i] for i in range(len(ds))]


# -- text corpora -------------------------------------------------------------

def zipf_words(rng, n_vocab):
    return ["w%d" % i for i in range(n_vocab)], 1.0 / np.arange(
        1, n_vocab + 1) ** 1.1


def write_imdb(path, rng, per_class=4, words=40, n_vocab=60):
    """An aclImdb tarball: ``aclImdb/{train,test}/{pos,neg}/<id>_<r>.txt``
    reviews of Zipf-drawn words with punctuation, mixed case."""
    vocab, p = zipf_words(rng, n_vocab)
    p = p / p.sum()
    with tarfile.open(path, "w:gz") as tf:
        for split in ("train", "test"):
            for label in ("pos", "neg"):
                for i in range(per_class):
                    n = int(rng.randint(words // 2, words))
                    toks = list(rng.choice(vocab, n, p=p))
                    toks[0] = toks[0].capitalize()
                    text = " ".join(toks) + (", great!" if label == "pos"
                                             else ". Bad.")
                    rating = rng.randint(7, 11) if label == "pos" \
                        else rng.randint(1, 5)
                    add_member(tf, "aclImdb/%s/%s/%d_%d.txt"
                               % (split, label, i, rating), text)
    return path


def write_imikolov(path):
    lines = ["the cat sat on the mat", "the dog sat on the log",
             "a cat and a dog"] * 20
    with tarfile.open(path, "w:gz") as tf:
        for split in ("train", "valid", "test"):
            add_member(tf, "./simple-examples/data/ptb.%s.txt" % split,
                       "\n".join(lines))
    return path


def write_uci(path, rng, rows=50):
    data = rng.rand(rows, 14).astype(np.float32)
    with open(path, "w") as f:
        for row in data:
            f.write(" ".join("%.6f" % v for v in row) + "\n")
    return path


MOVIELENS_USERS = "1::M::25::4::00000\n2::F::35::7::11111"
MOVIELENS_MOVIES = ("10::Toy Story (1995)::Animation|Comedy\n"
                    "20::Heat (1995)::Action")


def movielens_ratings(n=20):
    return "\n".join("%d::%d::%d::%d" % (1 + i % 2, 10 * (1 + (i // 2) % 2),
                                          1 + i % 5, 97 + i)
                     for i in range(n))


def write_movielens_tar(path):
    with tarfile.open(path, "w:gz") as tf:
        add_member(tf, "ml-1m/users.dat", MOVIELENS_USERS)
        add_member(tf, "ml-1m/movies.dat", MOVIELENS_MOVIES)
        add_member(tf, "ml-1m/ratings.dat", movielens_ratings())
    return path


def write_movielens_zip(path):
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Comedy\n"
                   "2::Jumanji (1995)::Adventure\n")
        z.writestr("ml-1m/users.dat",
                   "1::M::25::4::90210\n2::F::35::7::10001\n")
        z.writestr("ml-1m/ratings.dat", "".join(
            "%d::%d::%d::%d\n" % (1 + i % 2, 1 + (i // 2) % 2, 1 + i % 5,
                                  1000 + i) for i in range(17)))
    return path


def write_wmt14(path):
    pairs = ["hello world\tbonjour monde", "cat\tchat",
             "hello zebra\tbonjour zebre", "malformed line with no tab"]
    with tarfile.open(path, "w:gz") as tf:
        add_member(tf, "wmt14/src.dict",
                   "\n".join(["<s>", "<e>", "<unk>", "hello", "world",
                              "cat"]))
        add_member(tf, "wmt14/trg.dict",
                   "\n".join(["<s>", "<e>", "<unk>", "bonjour", "monde",
                              "chat"]))
        add_member(tf, "wmt14/train/train", "\n".join(pairs))
        add_member(tf, "wmt14/test/test", pairs[0])
    return path


def write_wmt16(path):
    train = ["hello world\thallo welt", "hello cat\thallo katze",
             "good day\tguten tag", "not a pair"]
    with tarfile.open(path, "w:gz") as tf:
        add_member(tf, "wmt16/train", "\n".join(train))
        add_member(tf, "wmt16/val", train[0])
        add_member(tf, "wmt16/test", train[1])
    return path


def write_conll05(tmp):
    """The release tarball and its three dictionaries; returns their
    paths as Conll05st's keyword arguments."""
    words = ["The", "cat", "sat", "", "Dogs", "bark", ""]
    props = ["- (A0*", "- *)", "sat (V*)", "", "- (A0*)", "bark (V*)", ""]
    tar_path = os.path.join(tmp, "conll05st.tar.gz")
    with tarfile.open(tar_path, "w:gz") as tf:
        for sub, lines in (("words/test.wsj.words.gz", words),
                           ("props/test.wsj.props.gz", props)):
            add_member(tf, "conll05st-release/test.wsj/" + sub,
                       gzip.compress("\n".join(lines).encode()))
    files = {}
    for name, lines in (
            ("word_dict_file", ["<unk>", "the", "The", "cat", "sat", "Dogs",
                                "bark", "bos", "eos"]),
            ("verb_dict_file", ["sat", "bark"]),
            ("target_dict_file", ["B-A0", "I-A0", "B-V", "I-V", "O"])):
        files[name] = os.path.join(tmp, name + ".txt")
        with open(files[name], "w") as f:
            f.write("\n".join(lines))
    return dict(data_file=tar_path, **files)


def write_vocab(path, words):
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")
    return path


# -- images -------------------------------------------------------------------

def write_idx(dirpath, stem, n, gz=True):
    """MNIST's IDX image and label files ``<stem>-{images-idx3,
    labels-idx1}-ubyte[.gz]``."""
    imgs = (np.arange(n * 28 * 28) % 255).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    img_path = os.path.join(dirpath, "%s-images-idx3-ubyte%s" % (stem, suffix))
    lab_path = os.path.join(dirpath, "%s-labels-idx1-ubyte%s" % (stem, suffix))
    with opener(img_path, "wb") as f:
        f.write((2051).to_bytes(4, "big") + n.to_bytes(4, "big")
                + (28).to_bytes(4, "big") + (28).to_bytes(4, "big")
                + imgs.tobytes())
    with opener(lab_path, "wb") as f:
        f.write((2049).to_bytes(4, "big") + n.to_bytes(4, "big")
                + bytes(i % 10 for i in range(n)))
    return img_path, lab_path


def write_cifar(path, rng, classes=10):
    """The python-pickle CIFAR tarball (cifar-10 or cifar-100 layout)."""
    if classes == 10:
        root, names, key = "cifar-10-batches-py/", \
            ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"], \
            b"labels"
    else:
        root, names, key = "cifar-100-python/", ["train", "test"], \
            b"fine_labels"
    with tarfile.open(path, "w:gz") as tf:
        for name in names:
            batch = {b"data": rng.randint(0, 255, (4, 3072)).astype(np.uint8),
                     key: [int(v) for v in rng.randint(0, classes, 4)]}
            add_member(tf, root + name, pickle.dumps(batch))
    return path


def jpg_bytes(rng, w=8, h=8):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def png_bytes(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def write_flowers(tmp, rng, n=6):
    import scipy.io as scio

    data_file = os.path.join(tmp, "102flowers.tgz")
    with tarfile.open(data_file, "w:gz") as tar:
        for i in range(1, n + 1):
            add_member(tar, "jpg/image_%05d.jpg" % i, jpg_bytes(rng))
    label_file = os.path.join(tmp, "imagelabels.mat")
    setid_file = os.path.join(tmp, "setid.mat")
    scio.savemat(label_file, {"labels": rng.randint(1, 103, (1, n))})
    scio.savemat(setid_file, {"tstid": np.array([[1, 2, 3, 4]]),
                              "trnid": np.array([[5]]),
                              "valid": np.array([[6]])})
    return data_file, label_file, setid_file


def write_voc(tmp, rng):
    names = ["2007_000001", "2007_000002", "2007_000003"]
    data_file = os.path.join(tmp, "VOCtrainval.tar")
    seg = "VOCdevkit/VOC2012/ImageSets/Segmentation/"
    with tarfile.open(data_file, "w") as tar:
        add_member(tar, seg + "trainval.txt", "\n".join(names[:2]) + "\n")
        add_member(tar, seg + "train.txt", names[0] + "\n")
        add_member(tar, seg + "val.txt", names[2] + "\n")
        for nm in names:
            add_member(tar, "VOCdevkit/VOC2012/JPEGImages/%s.jpg" % nm,
                       jpg_bytes(rng))
            add_member(tar, "VOCdevkit/VOC2012/SegmentationClass/%s.png"
                       % nm, png_bytes(rng.randint(0, 21, (8, 8)).astype(
                           np.uint8)))
    return data_file


def write_folder(root, rng, classes=("cat", "dog"), per_class=3):
    for cls in classes:
        d = os.path.join(root, cls)
        os.makedirs(d)
        for i in range(per_class):
            np.save(os.path.join(d, "%d.npy" % i),
                    rng.randint(0, 255, (4, 4, 3)).astype(np.uint8))
    return root
