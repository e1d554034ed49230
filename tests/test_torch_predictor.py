"""The port's deployment predictor (``paddle_tpu_torch.inference``: the
reference's ``Config``/``Predictor``/``create_predictor``/
``PredictorPool`` and their IO handles) over ``jit.save`` artifacts, held
to the reference's predictor on the same weights and inputs.  On this
machine the predictor runs on the CPU only when asked
(``Config.disable_gpu()``); without it, it raises ``UnavailableError``."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.core.errors import InvalidArgumentError

import torch_parity as tp


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    ref, port = tp.ernie_cls_pair(seed=3)
    d = tmp_path_factory.mktemp("pred")
    pt.jit.save(ref, str(d / "ref"), input_spec=tp.ernie_specs(pt.jit,
                                                                "int32"))
    jit.save(port, str(d / "port"), input_spec=tp.ernie_specs(jit))
    return ref, port, d


def _cpu_config(prefix):
    config = inference.Config(prefix)
    config.disable_gpu()
    return config


def test_handles_match_the_reference_predictor(artifacts):
    ref, port, d = artifacts
    rp = pt.inference.create_predictor(pt.inference.Config(str(d / "ref")))
    pred = inference.create_predictor(_cpu_config(str(d / "port")))
    assert pred.get_input_names() == rp.get_input_names() \
        == ["input_0", "input_1", "input_2"]
    for b in (2, 5):
        ids, mask, types = tp.ernie_batch(b, seed=10 + b)
        for name, arr in zip(pred.get_input_names(), (ids, mask, types)):
            pred.get_input_handle(name).copy_from_cpu(arr)
        for name, arr in zip(rp.get_input_names(), (ids.astype(np.int32),
                                                    mask,
                                                    types.astype(np.int32))):
            rp.get_input_handle(name).copy_from_cpu(arr)
        assert pred.run() is True and rp.run() is True
        assert pred.get_output_names() == rp.get_output_names() \
            == ["output_0"]
        out = pred.get_output_handle("output_0")
        got, want = out.copy_to_cpu(), rp.get_output_handle(
            "output_0").copy_to_cpu()
        assert out.shape() == [b, 3] and out.type() == "float32"
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_predictor_pool_and_config_surface(artifacts):
    ref, port, d = artifacts
    config = _cpu_config(str(d / "port"))
    assert not config.use_gpu() and config.device() == "cpu"
    assert config.model_dir() == config.prog_file() == str(d / "port")
    config.switch_ir_optim(False)
    config.enable_memory_optim()
    assert "cpu" in config.summary()
    pool = inference.PredictorPool(config, size=2)
    ids, mask, types = tp.ernie_batch(3)
    a = pool.retrieve(0).run([ids, mask, types])[0]
    b = pool.retrieve(1).run([ids, mask, types])[0]
    np.testing.assert_array_equal(a, b)
    with pytest.raises(InvalidArgumentError):
        pool.retrieve(2)
    pred = pool.retrieve(0)
    with pytest.raises(InvalidArgumentError, match="unknown input"):
        pred.get_input_handle("nope")
    with pytest.raises(InvalidArgumentError, match="takes 3 inputs"):
        pred.run([ids])
    pred.try_shrink_memory()
    pred.clear_intermediate_tensor()


def test_no_card_raises_without_disable_gpu(artifacts):
    ref, port, d = artifacts
    config = inference.Config(str(d / "port"))
    assert config.use_gpu() and config.device() == "cuda:0"
    if not torch.cuda.is_available():
        with pytest.raises(ptt.UnavailableError):
            inference.create_predictor(config)
    with pytest.raises(InvalidArgumentError, match="no artifact"):
        inference.create_predictor(_cpu_config(str(d / "missing")))
    with pytest.raises(InvalidArgumentError, match="no model"):
        inference.create_predictor(inference.Config())


def test_version_and_types():
    assert inference.get_version().startswith("paddle_tpu_torch inference")
    for dt in ("float32", "int64", "int32", "float16", "uint8", "int8",
               "bool"):
        assert inference.get_num_bytes_of_data_type(dt) \
            == pt.inference.get_num_bytes_of_data_type(dt)
    assert inference.get_num_bytes_of_data_type(
        inference.DataType.BFLOAT16) == 2
    assert inference.PlaceType.GPU == "gpu"
    assert inference.PrecisionType.Bfloat16 == "bfloat16"
    assert inference.Tensor is inference.PredictorTensor
    h = inference.PredictorTensor("x", torch.device("cpu"))
    with pytest.raises(InvalidArgumentError, match="Run"):
        h.copy_to_cpu()
    assert h.shape() is None and h.type() is None
