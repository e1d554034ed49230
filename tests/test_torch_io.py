"""``io`` of the port against the reference's on the CPU: samplers and
splits give the reference's indices under the same numpy generator
(index for index), loaders give the same batches serially and through
forked workers (reordered to the sampler's order), a worker's error
reaches the caller, a loader can be iterated twice, and batches land on
the device asked for (None is the card, which raises here).  Each worker
test runs under a time limit of its own (``_within``); none asserts a
throughput.  Values compared exactly.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.core.errors import UnavailableError

WORKER_LIMIT_S = 60.0


def _within(fn, seconds=WORKER_LIMIT_S):
    """``fn()``'s result, failing the test if it takes over ``seconds``
    (a hung worker must not hang the suite)."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # handed to the test
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "loader did not finish in %.0f s" % seconds
    if "err" in box:
        raise box["err"]
    return box["out"]


def _data(n=37):
    rng = np.random.RandomState(0)
    return (rng.randn(n, 3, 4).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int64))


def _batches(loader):
    return [tuple(t.numpy() for t in b) for b in loader]


def _ref_batches(loader):
    return [tuple(np.asarray(t.value) for t in b) for b in loader]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("drop_last", [False, True])
def test_shuffled_order_matches_reference(drop_last):
    x, y = _data()
    ref = pt.io.DataLoader(pt.io.TensorDataset([x, y]), batch_sampler=pt.io.
                           BatchSampler(sampler=pt.io.RandomSampler(
                               list(range(37)),
                               generator=np.random.RandomState(5)),
                               batch_size=8, drop_last=drop_last))
    ds = pio.TensorDataset([x, y])
    port = pio.DataLoader(ds, batch_sampler=pio.BatchSampler(
        sampler=pio.RandomSampler(list(range(37)),
                                  generator=np.random.RandomState(5)),
        batch_size=8, drop_last=drop_last), device="cpu")
    got, want = _batches(port), _ref_batches(ref)
    _assert_same(got, want)
    assert len(got) == len(port) == (4 if drop_last else 5)
    assert all(b[0].shape[0] == 8 for b in got[:4])


def test_samplers_and_splits_match_reference():
    items = list(range(23))
    for replacement in (False, True):
        assert list(pio.RandomSampler(items, replacement=replacement,
                                      num_samples=11, generator=7)) == \
            list(pt.io.RandomSampler(items, replacement=replacement,
                                     num_samples=11, generator=7))
    w = np.random.RandomState(1).rand(23)
    assert list(pio.WeightedRandomSampler(w, 40, generator=3)) == \
        list(pt.io.WeightedRandomSampler(w, 40, generator=3))
    for rank in (0, 1, 2):
        for shuffle in (False, True):
            kw = dict(batch_size=4, num_replicas=3, rank=rank,
                      shuffle=shuffle, seed=11)
            ps = pio.DistributedBatchSampler(items, **kw)
            rs = pt.io.DistributedBatchSampler(items, **kw)
            ps.set_epoch(2)
            rs.set_epoch(2)
            assert list(ps) == list(rs) and len(ps) == len(rs)
    solo = pio.DistributedBatchSampler(items, batch_size=5)
    assert (solo.rank, solo.num_replicas) == (0, 1)
    parts = pio.random_split(items, [10, 13], generator=4)
    want = pt.io.random_split(items, [10, 13], generator=4)
    assert [p.indices for p in parts] == [p.indices for p in want]


def test_seeded_shuffle_is_reproducible():
    def order():
        ptt.seed(3)
        return list(pio.RandomSampler(list(range(50))))

    assert order() == order()
    ptt.seed(3)
    a = [s.indices for s in pio.random_split(list(range(9)), [4, 5])]
    ptt.seed(3)
    assert a == [s.indices for s in pio.random_split(list(range(9)),
                                                     [4, 5])]


def test_dataset_combinators():
    x, y = _data(6)
    a, b = pio.TensorDataset([x, y]), pio.TensorDataset([y])
    comp = pio.ComposeDataset([a, b])
    assert len(comp) == 6 and len(comp[2]) == 3
    cat = pio.ConcatDataset([a, a])
    assert len(cat) == 12 and cat[-1][1] == y[-1] and cat[7][1] == y[1]
    sub = pio.Subset(a, [5, 0])
    assert sub[0][1] == y[5]

    class Stream(pio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))

    assert [v for v in pio.ChainDataset([Stream(2), Stream(3)])] == \
        [0, 1, 0, 1, 2]


def test_workers_give_the_serial_order_and_a_loader_runs_twice():
    x, y = _data(70)
    ds = pio.TensorDataset([np.repeat(x, 300, axis=2), y])  # shm-sized
    serial = _batches(pio.DataLoader(ds, batch_size=8, device="cpu"))
    loader = pio.DataLoader(ds, batch_size=8, num_workers=2, device="cpu")
    first = _within(lambda: _batches(loader))
    second = _within(lambda: _batches(loader))
    _assert_same(first, serial)
    _assert_same(second, serial)
    # four small fields: a batch tuple shaped like a shared-memory record
    four = pio.TensorDataset([y, y * 2, y * 3, y * 4])
    _assert_same(_within(lambda: _batches(pio.DataLoader(
        four, batch_size=8, num_workers=2, device="cpu"))),
        _batches(pio.DataLoader(four, batch_size=8, device="cpu")))
    plain = pio.DataLoader(ds, batch_size=8, num_workers=3, device="cpu",
                           use_shared_memory=False, use_buffer_reader=False)
    _assert_same(_within(lambda: _batches(plain)), serial)
    assert all(b[0].dtype == torch.float32 and b[1].dtype == torch.int64
               for b in loader)


class _Stream(pio.IterableDataset):
    def __iter__(self):
        info = pio.get_worker_info()
        for i in range(20):
            yield np.array([i, -1 if info is None else info.id])


def test_iterable_dataset_serial_and_with_workers():
    serial = [b.numpy() for b in pio.DataLoader(_Stream(), batch_size=6,
                                                device="cpu")]
    assert [len(b) for b in serial] == [6, 6, 6, 2]
    assert (np.concatenate(serial)[:, 0] == np.arange(20)).all()
    assert (np.concatenate(serial)[:, 1] == -1).all()
    loader = pio.DataLoader(_Stream(), batch_size=3, num_workers=2,
                            drop_last=True, device="cpu")
    got = np.concatenate(_within(lambda: [b.numpy() for b in loader]))
    # each worker reads its round-robin slice, full batches only
    assert sorted(got[:, 0].tolist()) == [0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                          10, 11, 12, 13, 14, 15, 16, 17]
    assert set(got[:, 1].tolist()) == {0, 1}
    assert all(w == int(i) % 2 for i, w in got.tolist())


class _Faulty(pio.Dataset):
    def __len__(self):
        return 40

    def __getitem__(self, i):
        if i == 21:
            raise ValueError("bad sample 21")
        return np.full(2, i, np.float32)


def test_a_worker_error_reaches_the_caller():
    loader = pio.DataLoader(_Faulty(), batch_size=4, num_workers=2,
                            device="cpu")

    def run():
        with pytest.raises(RuntimeError, match="bad sample 21"):
            for _ in loader:
                pass
        return True

    assert _within(run)

    def init_fails(worker_id):
        raise OSError("no init for worker %d" % worker_id)

    bad_init = pio.DataLoader(_Faulty(), batch_size=4, num_workers=1,
                              worker_init_fn=init_fails, device="cpu")

    def run_init():
        with pytest.raises(RuntimeError, match="no init for worker"):
            next(iter(bad_init))
        return True

    assert _within(run_init)


def test_default_collate_and_device_choice():
    batch = pio.default_collate_fn(
        [{"a": np.ones(2), "b": 1, "s": "x"},
         {"a": np.zeros(2), "b": 2, "s": "y"}])
    want = pt.io.default_collate_fn(
        [{"a": np.ones(2), "b": 1, "s": "x"},
         {"a": np.zeros(2), "b": 2, "s": "y"}])
    np.testing.assert_array_equal(batch["a"], want["a"])
    np.testing.assert_array_equal(batch["b"], want["b"])
    assert batch["s"] == want["s"] == ["x", "y"]
    x, y = _data(8)
    ds = pio.TensorDataset([torch.from_numpy(x), y])
    out = next(iter(pio.DataLoader(ds, batch_size=4, places="cpu")))
    assert out[0].device.type == "cpu" and torch.equal(
        out[0], torch.from_numpy(x[:4]))
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError):
            pio.DataLoader(ds, batch_size=4)
        with pytest.raises(UnavailableError):
            pio.DataLoader(ds, batch_size=4, places=["gpu:0"])


def test_arrays_without_room_in_shared_memory_go_pickled(monkeypatch):
    from paddle_tpu_torch.io import dataloader as dl

    x, y = _data(40)
    ds = pio.TensorDataset([np.repeat(x, 300, axis=2), y])
    serial = _batches(pio.DataLoader(ds, batch_size=8, device="cpu"))
    monkeypatch.setattr(dl, "_SHM_DIR", "/nonexistent-shm")
    assert not dl._shm_fits(1)
    got = _within(lambda: _batches(pio.DataLoader(
        ds, batch_size=8, num_workers=2, device="cpu")))
    _assert_same(got, serial)
