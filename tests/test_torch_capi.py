"""The port's C inference API (``paddle_tpu_torch.capi``), held to the
reference's ``tests/test_capi.py``: build the shared library, compile a
real C host against it with ``gcc``, and check its output against the
Python predictor on the same artifact.  The host asks for the CPU through
``PD_PredictorCreateOnDevice``, the one entry point the port adds (its
``PD_PredictorCreate`` runs on the card)."""
import os
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import capi, nn
from paddle_tpu_torch.jit import InputSpec, save

C_HOST = r"""
#include <stdio.h>
#include <string.h>

extern int PD_Init(const char*);
extern const char* PD_GetVersion(void);
extern void* PD_PredictorCreate(const char*);
extern void* PD_PredictorCreateOnDevice(const char*, const char*);
extern long long PD_PredictorRunFloat(void*, const float*, const long long*,
                                      int, float*, long long, long long*,
                                      int*);
extern void PD_PredictorDestroy(void*);
extern void PD_Finalize(void);

int main(int argc, char** argv) {
  if (PD_Init(argv[1]) != 0) return 2;
  printf("version=%s\n", PD_GetVersion());
  void* pred = strcmp(argv[3], "default") == 0
                   ? PD_PredictorCreate(argv[2])
                   : PD_PredictorCreateOnDevice(argv[2], argv[3]);
  if (!pred) return 3;
  float in[8];
  for (int i = 0; i < 8; ++i) in[i] = (float)i * 0.25f - 1.0f;
  long long shape[2] = {2, 4};
  float small[2];
  float out[64];
  long long out_shape[8];
  int out_ndim = 0;
  /* too small a buffer: the call returns the count it needs */
  long long need = PD_PredictorRunFloat(pred, in, shape, 2, small, 2,
                                        out_shape, &out_ndim);
  printf("need=%lld\n", need);
  long long rc = PD_PredictorRunFloat(pred, in, shape, 2, out, 64,
                                      out_shape, &out_ndim);
  if (rc != 0) return 4;
  printf("out_ndim=%d shape=%lld,%lld\n", out_ndim, out_shape[0],
         out_shape[1]);
  long long n = out_shape[0] * out_shape[1];
  for (long long i = 0; i < n; ++i) printf("%.6f\n", out[i]);
  PD_PredictorDestroy(pred);
  PD_Finalize();
  return 0;
}
"""


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    ptt.seed(0)
    net = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 3))
    prefix = str(tmp_path_factory.mktemp("capi") / "model")
    save(net, prefix, input_spec=[InputSpec([None, 4], "float32")])
    x = (np.arange(8, dtype=np.float32) * 0.25 - 1.0).reshape(2, 4)
    with torch.no_grad():
        expected = net(torch.from_numpy(x)).numpy()
    return prefix, expected


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    d = tmp_path_factory.mktemp("host")
    src, exe = str(d / "host.c"), str(d / "host")
    with open(src, "w") as f:
        f.write(C_HOST)
    subprocess.run(["gcc", src, "-o", exe] + capi.host_link_args(),
                   check=True, capture_output=True)
    return exe


def _run(host, prefix, device):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_TRAINER")}
    return subprocess.run([host, capi.embed_sys_paths(), prefix, device],
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_capi_builds():
    so = capi.build()
    assert os.path.exists(so) and so == capi.so_path()
    assert capi.build() == so  # newer than its source: not rebuilt


def test_capi_c_host_matches_python(artifact, host):
    from paddle_tpu_torch.inference import Config, create_predictor

    prefix, expected = artifact
    r = _run(host, prefix, "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [l for l in r.stdout.splitlines() if l.strip()]
    assert lines[0] == "version=paddle_tpu_torch-capi-0.1"
    assert lines[1] == "need=6"
    assert lines[2] == "out_ndim=2 shape=2,3"
    got = np.asarray([float(v) for v in lines[3:]]).reshape(2, 3)
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)
    config = Config(prefix)
    config.disable_gpu()
    x = (np.arange(8, dtype=np.float32) * 0.25 - 1.0).reshape(2, 4)
    np.testing.assert_allclose(got, create_predictor(config).run([x])[0],
                               rtol=1e-5, atol=1e-6)


def test_capi_default_is_the_card(artifact, host):
    """``PD_PredictorCreate`` runs on the card: without one it fails (the
    Python error printed), never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default succeeds there")
    prefix, _ = artifact
    r = _run(host, prefix, "default")
    assert r.returncode == 3, r.stdout + r.stderr
    assert "UnavailableError" in r.stderr or "CUDA" in r.stderr
