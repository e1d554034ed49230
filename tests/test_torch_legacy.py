"""The legacy namespaces of the port against the reference's on the CPU:
``reader`` and the root's ``batch``, ``compat``, ``version``,
``sysconfig``, ``hub`` (``hapi.hub``), ``utils.download`` and the
``dataset`` package (``common`` and the eleven corpus modules) reading
the same files under one ``DATA_HOME``.

Everything here is host-side Python over numpy: the samples, the
dictionaries, the paths and the typed errors are equal, not close.
Every cache root (``DATA_HOME``, ``WEIGHTS_HOME``, ``HUB_DIR``) is
redirected into the test's temporary directory.
"""
import hashlib
import os
import random
import re
import tarfile

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import reader as RR
from paddle_tpu.dataset import common as rcommon

import paddle_tpu_torch as ptt
from paddle_tpu_torch import reader as PR
from paddle_tpu_torch.dataset import common as pcommon

from torch_data import (add_member, assert_same, write_cifar, write_conll05,
                        write_flowers, write_idx, write_imdb, write_imikolov,
                        write_movielens_zip, write_uci, write_voc,
                        write_wmt14, write_wmt16)


def c10():
    return iter(range(10))


def _boom():
    yield 1
    raise RuntimeError("shard corrupt")


# -- reader decorators and the root's batch ---------------------------------

# (name, builder taking the reader module and returning a reader creator)
READER_CASES = [
    ("firstn", lambda R: R.firstn(c10, 3)),
    ("chain", lambda R: R.chain(c10, c10)),
    ("buffered", lambda R: R.buffered(c10, 2)),
    ("map_readers", lambda R: R.map_readers(lambda a, b: a + b, c10, c10)),
    ("compose", lambda R: R.compose(c10, c10)),
    ("compose_flatten", lambda R: R.compose(lambda: iter([(1, 2)]),
                                            lambda: iter([3]))),
    ("compose_unaligned", lambda R: R.compose(c10, lambda: iter(range(5)),
                                              check_alignment=False)),
    ("xmap_ordered", lambda R: R.xmap_readers(lambda x: x * 2, c10, 3, 4,
                                              order=True)),
    ("cache", lambda R: R.cache(c10)),
]


@pytest.mark.parametrize("name,build", READER_CASES,
                         ids=[c[0] for c in READER_CASES])
def test_reader_decorators_match_the_reference(name, build):
    want = list(build(RR)())
    got = list(build(PR)())
    assert got == want
    if name == "cache":
        cached = build(PR)
        assert list(cached()) == list(cached()) == want


@pytest.mark.parametrize("name,build", [
    ("shuffle", lambda R: R.shuffle(c10, 4)),
    ("xmap_unordered", lambda R: R.xmap_readers(lambda x: x * 2, c10, 3, 4)),
    ("multiprocess", lambda R: R.multiprocess_reader([c10, c10])),
])
def test_unordered_readers_hold_the_reference_multiset(name, build):
    assert sorted(build(PR)()) == sorted(build(RR)())


@pytest.mark.parametrize("build,exc", [
    (lambda R: R.compose(c10, lambda: iter(range(5))), "ComposeNotAligned"),
    (lambda R: R.xmap_readers(lambda x: 1 // x, lambda: iter([1, 0, 2]),
                              2, 4), ZeroDivisionError),
    (lambda R: R.xmap_readers(lambda x: x, _boom, 2, 4), RuntimeError),
    (lambda R: R.buffered(_boom, 2), RuntimeError),
    (lambda R: R.multiprocess_reader([c10, _boom]), RuntimeError),
], ids=["compose", "xmap_mapper", "xmap_source", "buffered",
        "multiprocess"])
def test_reader_errors_match_the_reference(build, exc):
    for R in (RR, PR):
        want = getattr(R, exc) if isinstance(exc, str) else exc
        with pytest.raises(want):
            list(build(R)())


@pytest.mark.parametrize("drop_last", [False, True])
def test_root_batch_matches_the_reference(drop_last):
    want = list(pt.batch(c10, 4, drop_last=drop_last)())
    assert list(ptt.batch(c10, 4, drop_last=drop_last)()) == want


# -- compat, version, sysconfig ---------------------------------------------

COMPAT_CASES = [
    ("to_text", (b"abc",)), ("to_text", (["a", b"b"],)),
    ("to_text", ({b"k": b"v"},)), ("to_text", ({b"x", "y"},)),
    ("to_bytes", ("abc",)), ("to_bytes", ({"a", "b"},)),
    ("to_bytes", ([bytearray(b"q"), "r"],)), ("round", (2.5,)),
    ("round", (-2.5,)), ("round", (2.345, 2)), ("round", (float("inf"),)),
    ("floor_division", (7, 2)),
    ("get_exception_message", (ValueError("boom"),)),
]


@pytest.mark.parametrize("fn,args", COMPAT_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(COMPAT_CASES)])
def test_compat_matches_the_reference(fn, args):
    assert_same(getattr(ptt.compat, fn)(*args), getattr(pt.compat, fn)(*args))


def test_compat_inplace_and_refusal():
    lst = [b"x"]
    assert ptt.compat.to_text(lst, inplace=True) is lst and lst == ["x"]
    with pytest.raises(ValueError):
        ptt.compat.get_exception_message(None)


def test_version_and_sysconfig():
    from paddle_tpu_torch import capi

    assert ptt.__version__ == ptt.version.full_version
    assert (ptt.version.major, ptt.version.minor, ptt.version.patch) == \
        tuple(int(p) for p in ptt.__version__.split("."))
    header = os.path.join(ptt.sysconfig.get_include(), "paddle_tpu_torch_c.h")
    with open(header) as f:
        text = f.read()
    with open(os.path.join(os.path.dirname(capi.__file__),
                           "paddle_tpu_torch_c.cpp")) as f:
        src = f.read()
    for fn in re.findall(r"\b(PD_\w+)\(", text):
        assert re.search(r"\b%s\(" % fn, src), fn
    assert ptt.sysconfig.get_lib() == os.path.dirname(capi.so_path())


# -- hub and download -------------------------------------------------------

@pytest.fixture()
def hub_repo(tmp_path):
    with open(tmp_path / "hubconf.py", "w") as f:
        f.write("dependencies = ['os']\n"
                "def net(scale=1):\n"
                "    'builds a net'\n"
                "    return scale * 2\n"
                "def _hidden():\n"
                "    pass\n")
    return str(tmp_path)


def test_hub_local_matches_the_reference(hub_repo):
    for hub in (pt.hub, ptt.hub):
        assert hub.list(hub_repo, source="local") == ["net"]
        assert hub.help(hub_repo, "net", source="local") == "builds a net"
        assert hub.load(hub_repo, "net", source="local", scale=3) == 6


@pytest.mark.parametrize("call,exc,match", [
    (lambda hub, d: hub.load(d, "missing", source="local"), RuntimeError,
     "Cannot find callable"),
    (lambda hub, d: hub.list(d, source="bitbucket"), ValueError,
     "Unknown source"),
    (lambda hub, d: hub.load("owner/repo", "net", source="github"),
     RuntimeError, "cache miss"),
], ids=["missing", "source", "remote"])
def test_hub_refusals_match_the_reference(hub_repo, tmp_path, monkeypatch,
                                          call, exc, match):
    from paddle_tpu.hapi import hub as rhub

    from paddle_tpu_torch.hapi import hub as phub

    for mod in (rhub, phub):
        monkeypatch.setattr(mod, "HUB_DIR", str(tmp_path / "hub"))
        with pytest.raises(exc, match=match):
            call(mod, hub_repo)


def test_hub_cached_remote_and_missing_deps(tmp_path, monkeypatch):
    from paddle_tpu_torch.hapi import hub as phub

    monkeypatch.setattr(phub, "HUB_DIR", str(tmp_path / "hub"))
    cached = tmp_path / "hub" / "owner_repo_main"
    cached.mkdir(parents=True)
    (cached / "hubconf.py").write_text("def net():\n    return 5\n")
    assert phub.load("owner/repo", "net", source="github") == 5
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "hubconf.py").write_text("dependencies = ['no_such_mod_xyz']\n")
    with pytest.raises(RuntimeError, match="Missing dependencies"):
        ptt.hub.list(str(bad), source="local")


def _make_tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name in members:
            add_member(tf, name, b"x")


def test_download_matches_the_reference(tmp_path, monkeypatch):
    from paddle_tpu.utils import download as RD

    from paddle_tpu_torch.utils import download as PD

    url = "https://paddle-hapi.bj.bcebos.com/models/lenet.pdparams"
    for D in (RD, PD):
        home = tmp_path / D.__name__.split(".")[0]
        monkeypatch.setattr(D, "WEIGHTS_HOME", str(home))
        assert D.is_url(url) and not D.is_url("/tmp/y")
        with pytest.raises(Exception, match="lenet.pdparams") as err:
            D.get_weights_path_from_url(url)
        assert type(err.value).__name__ == "InvalidArgumentError"
        (home / "lenet.pdparams").write_bytes(b"weights!")
        good = hashlib.md5(b"weights!").hexdigest()
        assert D.get_weights_path_from_url(url, md5sum=good) == \
            str(home / "lenet.pdparams")
        with pytest.raises(Exception, match="md5"):
            D.get_weights_path_from_url(url, md5sum="0" * 32)
        # archives: a single root, './'-prefixed, flat; extracted once
        for name, members, root in (
                ("m.tar", ["model/w.bin"], "model"),
                ("d.tar", ["./dotted/w.bin"], "dotted"),
                ("flat.tar", ["w1.bin", "w2.bin"], "flat")):
            _make_tar(home / name, members)
            out = D.get_path_from_url("https://x/" + name, str(home))
            assert out == str(home / root), (D.__name__, name, out)
        (home / "flat" / "w1.bin").write_bytes(b"kept")
        D.get_path_from_url("https://x/flat.tar", str(home))
        assert (home / "flat" / "w1.bin").read_bytes() == b"kept"


def test_cache_roots_follow_the_environment(tmp_path):
    import subprocess
    import sys

    env = dict(os.environ, PADDLE_DATA_HOME=str(tmp_path / "d"),
               PADDLE_WEIGHTS_HOME=str(tmp_path / "w"),
               PADDLE_HUB_DIR=str(tmp_path / "h"))
    code = ("from paddle_tpu_torch.dataset import common\n"
            "from paddle_tpu_torch.utils import download\n"
            "from paddle_tpu_torch.hapi import hub\n"
            "print(common.DATA_HOME, download.WEIGHTS_HOME, hub.HUB_DIR)")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.stdout.split() == [str(tmp_path / n) for n in "dwh"], \
        out.stderr


# -- dataset ------------------------------------------------------------------

@pytest.fixture(scope="module")
def legacy_home(tmp_path_factory):
    """Every corpus at its conventional place under one DATA_HOME."""
    home = tmp_path_factory.mktemp("data_home")
    rng = np.random.RandomState(0)
    for sub in ("mnist", "cifar", "uci_housing", "imdb", "imikolov",
                "movielens", "wmt14", "wmt16", "conll05st", "flowers",
                "voc2012"):
        (home / sub).mkdir()
    write_idx(str(home / "mnist"), "train", 6)
    write_idx(str(home / "mnist"), "t10k", 4)
    write_cifar(str(home / "cifar" / "cifar-10-python.tar.gz"), rng, 10)
    write_cifar(str(home / "cifar" / "cifar-100-python.tar.gz"), rng, 100)
    write_uci(str(home / "uci_housing" / "housing.data"), rng, rows=20)
    write_imdb(str(home / "imdb" / "aclImdb_v1.tar.gz"), rng)
    write_imikolov(str(home / "imikolov" / "simple-examples.tgz"))
    write_movielens_zip(str(home / "movielens" / "ml-1m.zip"))
    write_wmt14(str(home / "wmt14" / "wmt14.tgz"))
    write_wmt16(str(home / "wmt16" / "wmt16.tar.gz"))
    files = write_conll05(str(home / "conll05st"))
    for key, name in (("data_file", "conll05st-tests.tar.gz"),
                      ("word_dict_file", "wordDict.txt"),
                      ("verb_dict_file", "verbDict.txt"),
                      ("target_dict_file", "targetDict.txt")):
        os.replace(files[key], str(home / "conll05st" / name))
    flowers = write_flowers(str(home / "flowers"), rng)
    assert [os.path.basename(f) for f in flowers] == [
        "102flowers.tgz", "imagelabels.mat", "setid.mat"]
    voc = write_voc(str(home / "voc2012"), rng)
    os.replace(voc, str(home / "voc2012" / "VOCtrainval_11-May-2012.tar"))
    return str(home)


@pytest.fixture()
def data_home(legacy_home, monkeypatch):
    import paddle_tpu.dataset.movielens as rml
    import paddle_tpu.dataset.uci_housing as ruci

    import paddle_tpu_torch.dataset.movielens as pml
    import paddle_tpu_torch.dataset.uci_housing as puci

    for mod in (rcommon, pcommon):
        monkeypatch.setattr(mod, "DATA_HOME", legacy_home)
    for mod in (rml, pml):
        for name in ("MOVIE_INFO", "MOVIE_TITLE_DICT", "CATEGORIES_DICT",
                     "USER_INFO"):
            monkeypatch.setattr(mod, name, None)
    for mod in (ruci, puci):
        monkeypatch.setattr(mod, "_cache", {})
    return legacy_home


def _imdb_dict(D):
    return D.imdb.build_dict(re.compile(r"aclImdb/train/.*\.txt$"), 2)


# (name, function of the ``dataset`` package giving a reader creator)
LEGACY_READERS = [
    ("mnist_train", lambda D: D.mnist.train()),
    ("mnist_test", lambda D: D.mnist.test()),
    ("cifar_train10", lambda D: D.cifar.train10()),
    ("cifar_test10", lambda D: D.cifar.test10()),
    ("cifar_train100", lambda D: D.cifar.train100()),
    ("cifar_test100", lambda D: D.cifar.test100()),
    ("uci_train", lambda D: D.uci_housing.train()),
    ("uci_test", lambda D: D.uci_housing.test()),
    ("imdb_train", lambda D: D.imdb.train(_imdb_dict(D))),
    ("imdb_test", lambda D: D.imdb.test(_imdb_dict(D))),
    ("imikolov_ngram", lambda D: D.imikolov.train(
        D.imikolov.build_dict(min_word_freq=1), 3)),
    ("imikolov_seq", lambda D: D.imikolov.test(
        D.imikolov.build_dict(min_word_freq=1), -1,
        D.imikolov.DataType.SEQ)),
    ("movielens_train", lambda D: D.movielens.train()),
    ("movielens_test", lambda D: D.movielens.test()),
    ("wmt14_train", lambda D: D.wmt14.train(10)),
    ("wmt14_test", lambda D: D.wmt14.test(10)),
    ("wmt16_train", lambda D: D.wmt16.train(10, 10)),
    ("wmt16_validation", lambda D: D.wmt16.validation(10, 10)),
    ("conll05_test", lambda D: D.conll05.test()),
    ("flowers_train", lambda D: D.flowers.train(use_xmap=False)),
    ("flowers_valid", lambda D: D.flowers.valid(use_xmap=False)),
    ("voc2012_train", lambda D: D.voc2012.train()),
    ("voc2012_val", lambda D: D.voc2012.val()),
]


@pytest.mark.parametrize("name,make", LEGACY_READERS,
                         ids=[c[0] for c in LEGACY_READERS])
def test_legacy_reader_samples_match_the_reference(data_home, name, make):
    import paddle_tpu.dataset as rdataset

    import paddle_tpu_torch.dataset as pdataset

    # the train mappers crop and flip at random: the same global seeds
    random.seed(0)
    np.random.seed(0)
    want = list(make(rdataset)())
    random.seed(0)
    np.random.seed(0)
    got = list(make(pdataset)())
    assert len(got) == len(want) > 0
    assert_same(got, want)


@pytest.mark.parametrize("name,call", [
    ("imdb_dict", _imdb_dict),
    ("imikolov_dict", lambda D: D.imikolov.build_dict(min_word_freq=1)),
    ("movielens_meta", lambda D: (
        D.movielens.max_movie_id(), D.movielens.max_user_id(),
        D.movielens.max_job_id(), D.movielens.movie_categories(),
        D.movielens.get_movie_title_dict())),
    ("wmt14_dict", lambda D: D.wmt14.get_dict(10)),
    ("wmt16_dict", lambda D: (D.wmt16.get_dict("en", 10),
                              D.wmt16.get_dict("de", 10, reverse=True))),
    ("conll05_dict", lambda D: D.conll05.get_dict()),
], ids=lambda v: v if isinstance(v, str) else "")
def test_legacy_dictionaries_match_the_reference(data_home, name, call):
    import paddle_tpu.dataset as rdataset

    import paddle_tpu_torch.dataset as pdataset

    assert_same(call(pdataset), call(rdataset))


def test_legacy_refusals_match_the_reference(tmp_path, monkeypatch):
    from paddle_tpu.core.errors import InvalidArgumentError as RefInvalid

    import paddle_tpu.dataset as rdataset

    import paddle_tpu_torch.dataset as pdataset
    from paddle_tpu_torch.core.errors import InvalidArgumentError

    for mod in (rcommon, pcommon):
        monkeypatch.setattr(mod, "DATA_HOME", str(tmp_path))
    for D, exc in ((rdataset, RefInvalid), (pdataset, InvalidArgumentError)):
        with pytest.raises(exc, match="expected"):
            list(D.mnist.train()())
        with pytest.raises(ValueError, match="language"):
            D.wmt16.train(10, 10, src_lang="fr")


def test_common_download_split_and_cluster_match(tmp_path, monkeypatch):
    out = {}
    for C in (rcommon, pcommon):
        home = tmp_path / C.__name__.split(".")[0]
        (home / "mod").mkdir(parents=True)
        monkeypatch.setattr(C, "DATA_HOME", str(home))
        with pytest.raises(Exception, match="place the file") as err:
            C.download("http://x/file.bin", "mod", "")
        assert type(err.value).__name__ == "InvalidArgumentError"
        (home / "mod" / "file.bin").write_bytes(b"hello")
        path = C.download("http://x/file.bin", "mod", C.md5file(
            str(home / "mod" / "file.bin")))
        with pytest.raises(Exception, match="md5"):
            C.download("http://x/file.bin", "mod", "0" * 32)
        n = C.split(c10, 4, suffix=str(home / "part-%05d.pickle"))
        readers = [C.cluster_files_reader(str(home / "part-*.pickle"), 2, i)
                   for i in range(2)]
        out[C] = (os.path.relpath(path, str(home)), n,
                  [list(r()) for r in readers])
    assert out[pcommon] == out[rcommon]


@pytest.mark.parametrize("fn,args", [
    ("resize_short", (20,)), ("to_chw", ()), ("center_crop", (16,)),
    ("left_right_flip", ()), ("simple_transform", (24, 16, False,
                                                   [1.0, 2.0, 3.0])),
])
def test_legacy_image_helpers_match_the_reference(fn, args):
    from paddle_tpu.dataset import image as RI

    from paddle_tpu_torch.dataset import image as PI

    im = np.arange(40 * 30 * 3, dtype=np.uint8).reshape(40, 30, 3)
    assert_same(getattr(PI, fn)(im, *args), getattr(RI, fn)(im, *args))
