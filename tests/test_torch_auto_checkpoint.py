"""``incubate.auto_checkpoint`` of the port on the CPU, mirroring
``tests/test_auto_checkpoint.py``'s cases: a run stopped after step 4
and resumed reproduces the uninterrupted losses exactly (bit for bit:
the model, the Momentum state and the generator that draws dropout are
restored); the last two snapshots are kept; a corrupt latest snapshot
falls back to the one before; ``train_epoch_range`` skips the finished
epochs; a snapshot that does not fit the registered state is refused;
a directory and state are required.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.incubate import AutoCheckpoint, train_epoch_range


def _model_opt():
    ptt.seed(7)
    m = ptt.nn.Sequential(ptt.nn.Linear(4, 8, device="cpu"),
                          ptt.nn.Tanh(), ptt.nn.Dropout(0.3),
                          ptt.nn.Linear(8, 2, device="cpu"))
    o = ptt.optimizer.Momentum(0.1, momentum=0.9,
                               parameters=m.parameters())
    return m, o


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 8, 4).astype("float32"),
            rng.randint(0, 2, (16, 8)).astype("int64"))


def _step(m, o, xs, ys, i):
    loss = ptt.nn.functional.cross_entropy(m(torch.from_numpy(xs[i])),
                                           torch.from_numpy(ys[i]))
    loss.backward()
    o.step()
    o.clear_grad()
    return float(loss)


def _train_steps(m, o, steps, start=0):
    xs, ys = _data()
    return [_step(m, o, xs, ys, i) for i in range(start, steps)]


def test_step_checkpoint_resume_exact(tmp_path):
    ref_m, ref_o = _model_opt()
    ref = _train_steps(ref_m, ref_o, 10)
    xs, ys = _data()
    m1, o1 = _model_opt()
    acp1 = AutoCheckpoint({"model": m1, "opt": o1},
                          checkpoint_dir=str(tmp_path), every_n_steps=1)
    assert not acp1.resumed and acp1.start_step == 0
    first = []
    for i in range(5):
        first.append(_step(m1, o1, xs, ys, i))
        acp1.after_step(i)
    torch.rand(100)  # the crashed run drew more before dying
    m2, o2 = _model_opt()
    acp2 = AutoCheckpoint({"model": m2, "opt": o2},
                          checkpoint_dir=str(tmp_path), every_n_steps=1)
    assert acp2.resumed and acp2.start_step == 5
    second = []
    for i in range(acp2.start_step, 10):
        second.append(_step(m2, o2, xs, ys, i))
        acp2.after_step(i)
    assert first + second == ref


def test_keeps_last_two_snapshots(tmp_path):
    m, o = _model_opt()
    acp = AutoCheckpoint({"model": m, "opt": o},
                         checkpoint_dir=str(tmp_path), every_n_steps=1)
    for i in range(4):
        _train_steps(m, o, i + 1, start=i)
        acp.after_step(i)
    serials = sorted({int(p.name.split(".ckpt.")[1].split(".")[0])
                      for p in tmp_path.glob("default.ckpt.*")})
    assert serials == [2, 3], serials


def test_corrupt_latest_falls_back_to_previous(tmp_path):
    m, o = _model_opt()
    acp = AutoCheckpoint({"model": m, "opt": o},
                         checkpoint_dir=str(tmp_path), every_n_steps=1)
    _train_steps(m, o, 1)
    acp.after_step(0)
    _train_steps(m, o, 2, start=1)
    acp.after_step(1)
    for p in tmp_path.glob("default.ckpt.1*"):
        p.write_bytes(b"garbage")
    m2, o2 = _model_opt()
    acp2 = AutoCheckpoint({"model": m2, "opt": o2},
                          checkpoint_dir=str(tmp_path), every_n_steps=1)
    assert acp2.resumed and acp2.meta["serial"] == 0
    assert acp2.start_step == 1


def test_train_epoch_range_skips_completed(tmp_path):
    m, o = _model_opt()
    seen = []
    for epoch in train_epoch_range(5, state={"model": m, "opt": o},
                                   checkpoint_dir=str(tmp_path)):
        seen.append(epoch)
        if epoch == 2:
            break  # a crash in epoch 2: its snapshot never runs
    assert seen == [0, 1, 2]
    m2, o2 = _model_opt()
    seen2 = list(train_epoch_range(5, state={"model": m2, "opt": o2},
                                   checkpoint_dir=str(tmp_path)))
    assert seen2 == [2, 3, 4], seen2


def test_mismatched_state_registration_refuses_half_restore(tmp_path):
    m, o = _model_opt()
    acp = AutoCheckpoint({"model": m, "opt": o},
                         checkpoint_dir=str(tmp_path), every_n_steps=1)
    _train_steps(m, o, 1)
    acp.after_step(0)
    m2, o2 = _model_opt()
    with pytest.raises(Exception, match="resume failed to apply"):
        AutoCheckpoint({"model": m2, "opt": o2, "extra": m2},
                       checkpoint_dir=str(tmp_path), every_n_steps=1)


def test_requires_dir_and_state(tmp_path, monkeypatch):
    m, _ = _model_opt()
    monkeypatch.delenv("PADDLE_AUTO_CHECKPOINT_DIR", raising=False)
    with pytest.raises(Exception):
        AutoCheckpoint({"model": m})
    with pytest.raises(Exception):
        AutoCheckpoint({}, checkpoint_dir=str(tmp_path))
    monkeypatch.setenv("PADDLE_AUTO_CHECKPOINT_DIR", str(tmp_path / "env"))
    assert AutoCheckpoint({"model": m}).dir == str(tmp_path / "env")
    assert os.path.isdir(tmp_path / "env")
