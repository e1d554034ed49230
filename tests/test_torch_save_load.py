"""``save``/``load`` of the port: its own round trip (nested state, bf16
bit for bit, parameters kept as parameters), the reference's files read
by the port (``paddle_tpu.save`` output, and the ``.pdparams``/``.pdopt``
of the reference's ``Model.save`` after one step, loaded through the
port's ``Model.load``: its LeNet then gives the reference's logits
within 1e-5 of their largest magnitude, and its Adam moments equal the
reference's bit for bit), and a one-process sharded-fragment file with
its coverage check.
"""
import json
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.vision.models import LeNet as RefLeNet

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.framework.io import _ArrayRef
from paddle_tpu_torch.vision.models import LeNet


def test_round_trip_of_nested_state(tmp_path):
    rng = np.random.RandomState(0)
    bf = torch.from_numpy(rng.randn(3, 5).astype(np.float32)).bfloat16()
    state = {
        "w": torch.from_numpy(rng.randn(4, 4).astype(np.float32)),
        "p": torch.nn.Parameter(torch.arange(6.0).reshape(2, 3)),
        "nested": [bf, {"ids": np.arange(7, dtype=np.int64),
                        "half": torch.ones(2, dtype=torch.float16)}],
        "meta": {"step": 12, "name": "run", "pair": (1.5, None)},
    }
    ptt.save(state, str(tmp_path / "ck"))
    back = ptt.load(str(tmp_path / "ck"))
    assert torch.equal(back["w"], state["w"])
    assert isinstance(back["p"], torch.nn.Parameter) and \
        torch.equal(back["p"], state["p"])
    got_bf = back["nested"][0]
    assert got_bf.dtype == torch.bfloat16 and torch.equal(
        got_bf.view(torch.int16), bf.view(torch.int16))
    assert torch.equal(back["nested"][1]["ids"],
                       torch.arange(7, dtype=torch.int64))
    assert back["nested"][1]["half"].dtype == torch.float16
    assert back["meta"] == state["meta"]
    as_np = ptt.load(str(tmp_path / "ck"), return_numpy=True)
    assert as_np["nested"][0].dtype == np.dtype(ml_dtypes.bfloat16)
    with pytest.raises(InvalidArgumentError, match="not found"):
        ptt.load(str(tmp_path / "missing"))
    with pytest.raises(InvalidArgumentError, match="directory"):
        ptt.save(state, str(tmp_path) + "/")


def test_reads_the_reference_files(tmp_path):
    rng = np.random.RandomState(1)
    a = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(5).astype(ml_dtypes.bfloat16)
    pt.save({"a": pt.to_tensor(a), "b": pt.to_tensor(b),
             "layer": pt.nn.Linear(2, 3).state_dict(), "k": [1, "two"]},
            str(tmp_path / "ref"))
    got = ptt.load(str(tmp_path / "ref"))
    np.testing.assert_array_equal(got["a"].numpy(), a)
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"].view(torch.int16).numpy(),
                                  b.view(np.int16))
    assert isinstance(got["layer"]["weight"], torch.nn.Parameter)
    assert got["k"] == [1, "two"]


def test_reference_pdparams_load_into_the_port_model(tmp_path):
    pt.seed(4)
    ref = pt.Model(RefLeNet())
    ref.prepare(pt.optimizer.Adam(1e-3,
                                  parameters=ref.network.parameters()),
                pt.nn.CrossEntropyLoss())
    rng = np.random.RandomState(3)
    ref.train_batch([rng.rand(8, 1, 28, 28).astype(np.float32)],
                    [rng.randint(0, 10, 8).astype(np.int64)])
    ref.save(str(tmp_path / "lenet"))
    port = ptt.Model(LeNet(device="cpu", seed=9), device="cpu")
    port.prepare(ptt.optimizer.Adam(1e-3,
                                    parameters=port.network.parameters()),
                 ptt.nn.CrossEntropyLoss())
    port.load(str(tmp_path / "lenet"))
    x = np.random.RandomState(2).rand(4, 1, 28, 28).astype(np.float32)
    want = np.asarray(ref.predict_batch([pt.to_tensor(x)]).value)
    got = port.predict_batch(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    ref_state = [np.asarray(v.value) for k, v in
                 ref._optimizer.state_dict().items() if "moment1" in k]
    port_state = [v.numpy() for k, v in
                  port._optimizer.state_dict().items() if "moment1" in k]
    assert len(port_state) == len(ref_state) == 10
    for a, b in zip(port_state, ref_state):
        np.testing.assert_array_equal(a, b)


def _fragment_checkpoint(path, covered_rows):
    """A checkpoint in the reference's sharded layout written by one
    process: the array's rows in two chunks (``covered_rows`` of 4)."""
    full = np.arange(12, dtype=np.float32).reshape(4, 3)
    with open(path, "wb") as f:
        pickle.dump({"w": _ArrayRef("a0", "ndarray")}, f)
    np.savez(path + ".npz")
    chunks, arrays = [], {}
    for i, (r0, r1) in enumerate(covered_rows):
        key = "a0/p0/chunk%d" % i
        arrays[key] = full[r0:r1]
        chunks.append({"key": key, "index": [[r0, r1], [0, 3]]})
    np.savez(path + ".shard0.npz", **arrays)
    with open(path + ".index0.json", "w") as f:
        json.dump({"arrays": {"a0": {"shape": [4, 3], "dtype": "float32",
                                     "chunks": chunks}},
                   "nprocesses": 1, "process": 0}, f)
    return full


def test_one_process_fragment_file_loads_and_is_checked(tmp_path):
    path = str(tmp_path / "frag")
    full = _fragment_checkpoint(path, [(0, 2), (2, 4)])
    got = ptt.load(path)
    np.testing.assert_array_equal(got["w"].numpy(), full)
    holey = str(tmp_path / "holey")
    _fragment_checkpoint(holey, [(0, 2), (3, 4)])
    with pytest.raises(InvalidArgumentError, match="do not cover"):
        ptt.load(holey)
    # a later plain save at the path removes the stale fragments
    ptt.save({"w": torch.zeros(1)}, path)
    assert torch.equal(ptt.load(path)["w"], torch.zeros(1))
