"""``distributed.ps_compat`` and ``distributed.fleet.utils.fs`` of the
port against the reference's on the CPU: the slot-file generators'
text, ``QueueDataset``/``InMemoryDataset`` batches over the same files,
the sparse-table entries, ``LocalFS`` on the same tree, ``HDFSClient``'s
refusals and ``DistributedInfer``.  Everything is host-side: batches,
strings, listings and typed errors are equal.
"""
import os

import numpy as np
import pytest

import paddle_tpu.distributed as rdist
from paddle_tpu.core.errors import InvalidArgumentError as RefInvalid
from paddle_tpu.distributed.fleet.utils import fs as rfs

import paddle_tpu_torch.distributed as pdist
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.distributed.fleet.utils import fs as pfs

from torch_data import assert_same


class _Var:
    def __init__(self, name, dtype="int64"):
        self.name = name
        self.dtype = dtype


def _rows(rng, n=9):
    return [[("ids", [int(v) for v in rng.randint(1, 50,
                                                  rng.randint(1, 5))]),
             ("score", [round(float(rng.rand()), 3)]),
             ("label", [int(rng.randint(0, 2))])] for _ in range(n)]


@pytest.fixture(scope="module")
def slot_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("slots")
    rng = np.random.RandomState(0)
    paths = []
    gen = pdist.fleet.MultiSlotDataGenerator()
    for part in range(2):
        path = str(d / ("part-%03d" % part))
        with open(path, "w") as f:
            for row in _rows(rng):
                f.write(gen._gen_str(row))
        paths.append(path)
    return paths


def test_generators_write_the_reference_text():
    rows = _rows(np.random.RandomState(1), 4)
    for cls in ("MultiSlotDataGenerator", "MultiSlotStringDataGenerator"):
        ref = getattr(rdist.fleet, cls)()
        port = getattr(pdist.fleet, cls)()
        for row in rows:
            if cls.startswith("MultiSlotString"):
                row = [(k, [str(v) for v in vs]) for k, vs in row]
            assert port._gen_str(row) == ref._gen_str(row)


def _memory_generator(base):
    """A user generator whose samples come from memory (the line is
    None in ``run_from_memory``)."""

    class Memory(base):
        def generate_sample(self, line):
            def it():
                for ids in ([1, 2, 3], [4], [5, 6]):
                    yield [("ids", ids), ("label", [len(ids) % 2])]
            return it

    return Memory()


def test_run_from_memory_matches_the_reference(capsys):
    outs = []
    for pkg in (rdist, pdist):
        g = _memory_generator(pkg.fleet.MultiSlotDataGenerator)
        g.set_batch(2)
        g.run_from_memory()
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and outs[0].count("\n") == 3


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("kind", ["QueueDataset", "InMemoryDataset"])
def test_datasets_batch_like_the_reference(slot_files, kind, batch):
    got = []
    for pkg in (rdist, pdist):
        ds = getattr(pkg, kind)()
        ds.init(batch_size=batch, use_var=[
            _Var("ids"), _Var("score", "float32"), _Var("label")])
        ds.set_filelist(slot_files)
        if kind == "InMemoryDataset":
            ds.load_into_memory()
            assert ds.get_memory_data_size() == 18
            ds.local_shuffle(seed=3)
        got.append(list(ds))
    assert_same(got[1], got[0])


def test_inmemory_refusals_and_release(slot_files):
    for pkg, exc in ((rdist, RefInvalid), (pdist, InvalidArgumentError)):
        ds = pkg.InMemoryDataset()
        ds.init(batch_size=1, use_var=[_Var("ids"), _Var("label")])
        ds.set_filelist(slot_files)
        with pytest.raises(exc):
            list(ds)
        ds.load_into_memory()
        ds.release_memory()
        assert ds.get_memory_data_size() == 0


@pytest.mark.parametrize("cls,arg,ok", [
    ("CountFilterEntry", 5, True), ("CountFilterEntry", 0, False),
    ("ProbabilityEntry", 0.5, True), ("ProbabilityEntry", 1.5, False),
])
def test_entries_match_the_reference(cls, arg, ok):
    if ok:
        assert getattr(pdist, cls)(arg)._to_attr() == \
            getattr(rdist, cls)(arg)._to_attr()
        return
    with pytest.raises(RefInvalid):
        getattr(rdist, cls)(arg)
    with pytest.raises(InvalidArgumentError):
        getattr(pdist, cls)(arg)


def _fs_session(fs, root):
    """A fixed sequence of LocalFS calls under ``root``: what each
    returns, relative to ``root``."""
    rel = lambda p: os.path.relpath(p, root)  # noqa: E731
    out = []
    fs.mkdirs(os.path.join(root, "a", "b"))
    fs.touch(os.path.join(root, "a", "f.txt"))
    with open(os.path.join(root, "a", "g.txt"), "w") as f:
        f.write("hello\n")
    out.append(fs.ls_dir(os.path.join(root, "a")))
    out.append(fs.list_dirs(os.path.join(root, "a")))
    out.append(fs.cat(os.path.join(root, "a", "g.txt")))
    fs.rename(os.path.join(root, "a", "f.txt"), os.path.join(root, "a",
                                                              "h.txt"))
    fs.rename(os.path.join(root, "a", "h.txt"), os.path.join(root, "i.txt"))
    out.append(sorted(os.listdir(root)))
    out.append([fs.is_file(os.path.join(root, "i.txt")),
                fs.is_dir(os.path.join(root, "a")),
                fs.is_exist(os.path.join(root, "nope")),
                fs.need_upload_download()])
    fs.delete(os.path.join(root, "a"))
    out.append([rel(p) for p in sorted(
        os.path.join(root, n) for n in os.listdir(root))])
    try:
        fs.touch(os.path.join(root, "i.txt"), exist_ok=False)
    except Exception as e:  # noqa: BLE001 - the class name is compared
        out.append(type(e).__name__)
    return out


def test_local_fs_matches_the_reference(tmp_path):
    got = _fs_session(pfs.LocalFS(), str(tmp_path / "port"))
    want = _fs_session(rfs.LocalFS(), str(tmp_path / "ref"))
    assert got == want
    assert got[-1] == "InvalidArgumentError"


@pytest.mark.parametrize("method", ["ls_dir", "is_file", "mkdirs", "upload",
                                    "download", "cat", "anything_else"])
def test_hdfs_client_refuses_like_the_reference(method):
    for mod, exc in ((rfs, RefInvalid), (pfs, InvalidArgumentError)):
        client = mod.HDFSClient("/opt/hadoop", {"fs.default.name": "x"})
        with pytest.raises(exc, match="HDFSClient"):
            getattr(client, method)("/path")
    with pytest.raises(AttributeError):
        getattr(pfs.HDFSClient(), "_private")


def test_distributed_infer_clones_the_program():
    from paddle_tpu_torch import static

    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [None, 4], "float32")
        static.nn.fc(x, 2)
    infer = pfs.DistributedInfer(main_program=prog)
    infer.init_distributed_infer_env(exe=None, loss=None)
    clone = infer.get_dist_infer_program()
    assert clone is not prog
    assert [v.name for v in clone.list_vars()] == \
        [v.name for v in prog.list_vars()]
