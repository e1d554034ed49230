"""The high-level API on the card: ``DataLoader`` batches staged through
pinned buffers and a side stream (held after later batches reuse the
buffers), ``Int8Linear``'s ``torch._int_mm`` route against the exact
chunked route, a ``QuantedLinear`` scale and ASP masks inside a captured
``TrainStep``, and ``Model.fit`` of LeNet as one captured graph.
Skipped without a CUDA card.  Imports neither JAX nor the reference::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_hapi_cuda.py
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.incubate import asp
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.vision.models import LeNet


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_land_on_the_card_intact(cuda_device, workers):
    rng = np.random.RandomState(0)
    x = rng.randn(96, 3, 64, 64).astype(np.float32)
    y = np.arange(96)
    loader = DataLoader(TensorDataset([x, y]), batch_size=8,
                        num_workers=workers, prefetch_factor=1)
    held = []
    for bx, by in loader:
        assert bx.is_cuda and by.is_cuda
        torch.cuda._sleep(1000000)  # the consumer lags behind the copies
        held.append((bx * 1.0, by))
    torch.cuda.synchronize()
    assert len(held) == 12
    for i, (bx, by) in enumerate(held):
        np.testing.assert_array_equal(bx.cpu().numpy(), x[i * 8:i * 8 + 8])
        np.testing.assert_array_equal(by.cpu().numpy(), y[i * 8:i * 8 + 8])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 768, 3072), (32, 3072, 768),
                                   (8, 768, 768), (64, 100, 24)])
def test_int8_linear_routes_agree_on_the_card(cuda_device, m, k, n):
    gen = torch.Generator().manual_seed(m + k + n)
    w = torch.randint(-128, 128, (k, n), generator=gen).to(torch.int8)
    bias = torch.randn(n, generator=gen)
    x = torch.randn(2, m // 2, k, generator=gen) * 2
    cpu = Q.Int8Linear(w, 0.02, bias, 3.0)
    card = Q.Int8Linear(w.cuda(), 0.02, bias.cuda(), 3.0)
    before = dict(Q.Int8Linear.routes)
    got = card(x.cuda()).cpu()
    route = "int_mm" if m > 16 and k % 8 == 0 and n % 8 == 0 else "chunked"
    assert Q.Int8Linear.routes[route] == before[route] + 1
    want = cpu(x)
    assert torch.equal(got, want) or \
        (got - want).abs().max() <= 1e-6 * want.abs().max()
    a = torch.randint(-128, 128, (m, k), generator=gen).to(torch.int8)
    prod, _ = Q._int8_matmul(a.cuda(), w.cuda())
    assert torch.equal(prod.cpu(), a.long().matmul(w.long()).int())


def _net(dev):
    torch.manual_seed(0)
    return ptt.nn.Sequential(ptt.nn.Linear(32, 64, device=dev),
                             ptt.nn.ReLU(), ptt.nn.Linear(64, 8, device=dev))


def _batch(dev):
    gen = torch.Generator().manual_seed(1)
    return (torch.randn(16, 32, generator=gen).to(dev),
            torch.randint(0, 8, (16,), generator=gen).to(dev))


def _loss(m, x, y):
    return ptt.nn.functional.cross_entropy(m(x), y)


@pytest.mark.cuda
def test_qat_scales_advance_once_a_replay(cuda_device):
    net = _net(cuda_device)
    Q.ImperativeQuantAware().quantize(net)
    step = ptt.TrainStep(net, _loss, ptt.optimizer.SGD(
        0.1, parameters=net.parameters()))
    x, y = _batch(cuda_device)
    scales = []
    for i in range(4):
        step(x * (1 + i), y)
        scales.append(float(net[0]._act_scale))
    assert step._fn.graphs() == 1
    want, old = [], -1.0
    for i in range(4):
        cur = float((x * (1 + i)).abs().max())
        old = cur if old < 0 else 0.9 * old + 0.1 * cur
        want.append(old)
    np.testing.assert_allclose(scales, want, rtol=1e-6)


@pytest.mark.cuda
def test_asp_masks_hold_in_a_captured_step(cuda_device):
    net = _net(cuda_device)
    asp.reset_excluded_layers()
    try:
        masks = asp.prune_model(net)
        assert len(masks) == 2
        opt = asp.decorate(ptt.optimizer.Adam(
            0.01, parameters=net.parameters()))
        step = ptt.TrainStep(net, _loss, opt)
        x, y = _batch(cuda_device)
        for _ in range(4):
            step(x, y)
        assert step._fn.graphs() == 1
        assert asp.check_sparsity(net[0].weight)
        assert asp.check_sparsity(net[2].weight)
    finally:
        asp._masks.clear()


@pytest.mark.cuda
def test_model_fit_is_one_captured_graph(cuda_device):
    rng = np.random.RandomState(0)
    images = rng.rand(256, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, 256)
    model = ptt.Model(LeNet())
    assert next(iter(model.network.parameters())).is_cuda
    model.prepare(ptt.optimizer.Adam(
        1e-3, parameters=model.network.parameters()),
        ptt.nn.CrossEntropyLoss(), ptt.metric.Accuracy())
    model.fit((images, labels), batch_size=64, epochs=2, verbose=0,
              num_workers=2)
    assert model._train_step._fn.graphs() == 1
    res = model.evaluate((images, labels), batch_size=64, verbose=0)
    assert np.isfinite(res["eval_loss"][0])
    out = model.predict((images[:64],), batch_size=64,
                        stack_outputs=True)[0]
    with torch.no_grad():
        model.network.eval()
        want = model.network(torch.from_numpy(images[:64]).cuda())
    np.testing.assert_array_equal(out, want.cpu().numpy())
