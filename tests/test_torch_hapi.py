"""``Model`` of the port against the reference's on the CPU: config #1
(``examples/01_mnist_lenet.py``: LeNet, Adam 1e-3, CrossEntropyLoss,
Accuracy, batch 64 over the example's 512 synthetic images, 2 epochs)
through ``fit``/``evaluate``/``predict``, gradient accumulation, the
callbacks' decisions, ``summary``/``flops`` and the refusals.

Both packages start from the same LeNet weights
(``load_reference_params``) and see the same batches (``shuffle=False``).
Tolerances, fp32: each step's loss within 1e-4 of the largest; the
final parameters within 1e-4 of each tensor's largest magnitude plus
1e-5 absolute, 1% of one Adam step at learning rate 1e-3 (Adam's
``m / sqrt(v)`` turns an element's gradient that sums to within rounding
of zero into an O(1) step, so such an element can move by a fraction of
a step more in one package); evaluate's loss and predict's logits within
1e-4 of the largest, its accuracy within one sample.  Callback decisions
and FLOP and parameter counts are equal.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.vision.models import LeNet as RefLeNet

import paddle_tpu_torch as ptt
from paddle_tpu_torch import load_reference_params
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          UnavailableError,
                                          UnimplementedError)
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.vision.models import LeNet

from paddle_tpu.hapi import callbacks as rcb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
PARAM_ATOL = 1e-5


def _example():
    spec = importlib.util.spec_from_file_location(
        "mnist_lenet_example",
        os.path.join(REPO, "examples", "01_mnist_lenet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arrays(ref):
    return {n: np.asarray(p.value) for n, p in ref.named_parameters()}


def _recorder(base):
    class Losses(base):
        """Records each step's loss."""

        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"][0]))

    return Losses


_Losses = _recorder(pcb.Callback)
_RefLosses = _recorder(rcb.Callback)


def _ref_model(seed=0, opt="Adam", lr=1e-3):
    pt.seed(seed)
    net = RefLeNet()
    m = pt.Model(net)
    m.prepare(getattr(pt.optimizer, opt)(lr, parameters=net.parameters()),
              pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    return m


def _port_model(ref_net, opt="Adam", lr=1e-3):
    net = LeNet(device="cpu")
    load_reference_params(net, _arrays(ref_net))
    m = ptt.Model(net, device="cpu")
    m.prepare(getattr(ptt.optimizer, opt)(
        lr, parameters=m.network.parameters()),
        ptt.nn.CrossEntropyLoss(), ptt.metric.Accuracy())
    return m


@pytest.fixture(scope="module")
def mnist_runs():
    """The example's training, in both packages, from the same weights
    and on the same batches; returns the two models and their losses."""
    images, labels = _example().synthetic_mnist()
    ref = _ref_model()
    port = _port_model(ref.network)
    rl, pl = _RefLosses(), _Losses()
    ref.fit(pt.io.TensorDataset([images, labels]), epochs=2,
            batch_size=64, verbose=0, shuffle=False, callbacks=[rl])
    port.fit(ptt.io.TensorDataset([images, labels]), epochs=2,
             batch_size=64, verbose=0, shuffle=False, callbacks=[pl])
    return dict(ref=ref, port=port, ref_losses=rl.losses,
                port_losses=pl.losses, images=images, labels=labels)


def _close(got, want, rtol=RTOL, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= rtol * scale + atol, \
        (np.abs(got - want).max(), scale)


def test_mnist_example_fit_matches_reference(mnist_runs):
    r = mnist_runs
    assert len(r["port_losses"]) == len(r["ref_losses"]) == 16
    _close(r["port_losses"], r["ref_losses"])
    assert r["port_losses"][-1] < r["port_losses"][0]
    want = _arrays(r["ref"].network)
    for name, p in r["port"].network.named_parameters():
        _close(p.detach().numpy(), want[name], atol=PARAM_ATOL)


def test_evaluate_and_predict_match_reference(mnist_runs):
    r = mnist_runs
    ds = (r["images"][:128], r["labels"][:128])
    want = r["ref"].evaluate(pt.io.TensorDataset(list(ds)), batch_size=64,
                             verbose=0)
    got = r["port"].evaluate(ptt.io.TensorDataset(list(ds)), batch_size=64,
                             verbose=0)
    assert set(got) == set(want) == {"eval_loss", "eval_acc"}
    _close(got["eval_loss"], want["eval_loss"])
    assert abs(got["eval_acc"] - want["eval_acc"]) <= 1 / 128
    pw = r["ref"].predict(pt.io.TensorDataset([ds[0]]), batch_size=64,
                          stack_outputs=True)[0]
    pg = r["port"].predict(ptt.io.TensorDataset([ds[0]]), batch_size=64,
                           stack_outputs=True)[0]
    assert pg.shape == pw.shape == (128, 10)
    _close(pg, pw)
    per_batch = r["port"].predict(ptt.io.TensorDataset([ds[0]]),
                                  batch_size=64)[0]
    assert [b.shape for b in per_batch] == [(64, 10), (64, 10)]


def test_gradient_accumulation_matches_reference():
    # SGD: an accumulated gradient within rounding of zero moves a weight
    # by a rounding, where Adam's first step would move it by +-lr
    images, labels = _example().synthetic_mnist(n=128)
    ref = _ref_model(seed=3, opt="SGD", lr=0.05)
    port = _port_model(ref.network, opt="SGD", lr=0.05)
    rl, pl = _RefLosses(), _Losses()
    ref.fit((images, labels), batch_size=32, verbose=0, shuffle=False,
            accumulate_grad_batches=2, callbacks=[rl])
    port.fit((images, labels), batch_size=32, verbose=0, shuffle=False,
             accumulate_grad_batches=2, callbacks=[pl])
    _close(pl.losses, rl.losses)
    want = _arrays(ref.network)
    for name, p in port.network.named_parameters():
        _close(p.detach().numpy(), want[name], atol=PARAM_ATOL)
    # the optimizer stepped on batches 2 and 4 only: not on an odd batch
    assert port._accum_pending is False


class _Opt:
    """An optimizer stand-in with a float learning rate."""

    def __init__(self, lr):
        self._learning_rate = lr

    def get_lr(self):
        return self._learning_rate

    def set_lr(self, v):
        self._learning_rate = v


class _FakeModel:
    def __init__(self):
        self.stop_training = False
        self._optimizer = _Opt(0.1)
        self.saved = []

    def save(self, path):
        self.saved.append(os.path.basename(path))


def _decisions(cbs_mod, seq, **kw):
    """Drive EarlyStopping and ReduceLROnPlateau over one eval-loss
    sequence: the epoch each stopped at, the saves, the learning rates."""
    es = cbs_mod.EarlyStopping(monitor="eval_loss", patience=2,
                               min_delta=0.01, verbose=0,
                               save_best_model=True)
    rp = cbs_mod.ReduceLROnPlateau(monitor="eval_loss", factor=0.5,
                                   patience=1, cooldown=1, min_lr=0.02,
                                   verbose=0)
    out = []
    for cb in (es, rp):
        m = _FakeModel()
        cb.set_model(m)
        cb.set_params({"save_dir": "/nowhere"})
        cb.on_train_begin()
        lrs, stop = [], None
        for epoch, v in enumerate(seq):
            cb.on_epoch_begin(epoch)
            cb.on_eval_end({"eval_loss": [v]})
            lrs.append(m._optimizer.get_lr())
            if m.stop_training and stop is None:
                stop = epoch
        out.append((stop, m.saved, lrs))
    return out


@pytest.mark.parametrize("seq", [
    [1.0, 0.9, 0.95, 0.91, 0.92, 0.5, 0.6, 0.61, 0.62, 0.63],
    [2.0, 1.5, 1.499, 1.2, 1.2, 1.2, 1.19, 1.18, 1.0, 1.0],
])
def test_early_stopping_and_plateau_decisions_match_reference(seq):
    assert _decisions(pcb, seq) == _decisions(rcb, seq)


def test_lr_scheduler_callback_steps_the_schedule():
    sched = ptt.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    net = LeNet(device="cpu")
    m = ptt.Model(net, device="cpu")
    m.prepare(ptt.optimizer.SGD(sched, parameters=net.parameters()),
              ptt.nn.CrossEntropyLoss())
    images, labels = _example().synthetic_mnist(n=64)
    m.fit((images, labels), batch_size=16, verbose=0, shuffle=False,
          callbacks=[pcb.LRScheduler(by_step=True)])
    assert sched.last_epoch == 4 and abs(sched() - 0.025) < 1e-12


def test_summary_and_flops_of_lenet_match_reference():
    pt.seed(0)
    ref = RefLeNet()
    port = LeNet(device="cpu")
    assert ptt.flops(port, [1, 1, 28, 28]) == pt.flops(ref, [1, 1, 28, 28])
    assert ptt.summary(port, (1, 1, 28, 28)) == pt.summary(ref,
                                                           (1, 1, 28, 28))


# the reference's totals at 64 x 64, from pt.flops/pt.summary on
# paddle_tpu.vision.models.resnet50() and mobilenet_v2() (each ~10-25 s of
# eager forward and construction on the CPU; recomputed live by the slow
# test below)
ZOO_AT_64 = {"resnet50": (338309120, 25557032),
             "mobilenet_v2": (27318528, 3504872)}


@pytest.mark.parametrize("name", sorted(ZOO_AT_64))
def test_zoo_flops_and_params_equal_the_reference_counts(name):
    from paddle_tpu_torch.vision import models as M

    net = getattr(M, name)(device="cpu")
    flops, params = ZOO_AT_64[name]
    assert ptt.flops(net, [1, 3, 64, 64]) == flops
    assert ptt.summary(net, (1, 3, 64, 64))["total_params"] == params


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(ZOO_AT_64))
def test_zoo_reference_counts_are_current(name):
    import paddle_tpu.vision.models as RM

    ref = getattr(RM, name)()
    assert (pt.flops(ref, [1, 3, 64, 64]),
            pt.summary(ref, (1, 3, 64, 64))["total_params"]) \
        == ZOO_AT_64[name]


def test_save_load_round_trip_and_refusals(tmp_path):
    net = LeNet(device="cpu")
    m = ptt.Model(net, device="cpu")
    m.prepare(ptt.optimizer.Adam(1e-3, parameters=net.parameters()),
              ptt.nn.CrossEntropyLoss())
    images, labels = _example().synthetic_mnist(n=64)
    m.fit((images, labels), batch_size=32, verbose=0, shuffle=False)
    m.save(str(tmp_path / "ck"))
    assert (tmp_path / "ck.pdparams").exists() \
        and (tmp_path / "ck.pdopt").exists()
    m2 = ptt.Model(LeNet(device="cpu", seed=5), device="cpu")
    opt2 = ptt.optimizer.Adam(1e-3, parameters=m2.network.parameters())
    m2.prepare(opt2, ptt.nn.CrossEntropyLoss())
    m2.load(str(tmp_path / "ck"))
    x = torch.from_numpy(images[:8])
    assert torch.equal(m2.predict_batch(x), m.predict_batch(x))
    # optimizer state maps by position (the parameter names differ)
    for (_, a), (_, b) in zip(m._optimizer.state_dict().items(),
                              opt2.state_dict().items()):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    with pytest.raises(UnimplementedError, match="jit.save"):
        m.save(str(tmp_path / "infer"), training=False)
    with pytest.raises(InvalidArgumentError, match="nn.Layer"):
        ptt.Model(torch.nn.Linear(2, 2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError):
            ptt.Model(LeNet(device="cpu"))


def test_visualdl_writes_train_and_eval_scalars(tmp_path):
    net = LeNet(device="cpu")
    m = ptt.Model(net, device="cpu")
    m.prepare(ptt.optimizer.SGD(0.01, parameters=net.parameters()),
              ptt.nn.CrossEntropyLoss(), ptt.metric.Accuracy())
    images, labels = _example().synthetic_mnist(n=64)
    m.fit((images, labels), eval_data=(images, labels), batch_size=32,
          verbose=0, shuffle=False,
          callbacks=[pcb.VisualDL(str(tmp_path))])
    recs = ptt.profiler.LogWriter.read(str(tmp_path))
    tags = {r["tag"] for r in recs}
    assert {"train/loss", "eval/eval_loss", "eval/eval_acc"} <= tags
    assert [r["step"] for r in recs if r["tag"] == "train/loss"] == [1, 2]


def test_model_checkpoint_and_num_iters(tmp_path):
    net = LeNet(device="cpu")
    m = ptt.Model(net, device="cpu")
    m.prepare(ptt.optimizer.SGD(0.01, parameters=net.parameters()),
              ptt.nn.CrossEntropyLoss())
    images, labels = _example().synthetic_mnist(n=64)
    seen = _Losses()
    m.fit((images, labels), batch_size=16, epochs=3, verbose=0,
          save_dir=str(tmp_path), num_iters=6, callbacks=[seen])
    assert len(seen.losses) == 6
    # epoch 0 ran 4 steps, epoch 1 stopped after 2 and still ended
    assert sorted(p.name for p in tmp_path.glob("*.pdparams")) == \
        ["0.pdparams", "1.pdparams", "final.pdparams"]
