"""One run of each cell, at tiny sizes on the CPU: the result line's
schema; the guards (no card, JAX loaded); and the output check coming out
false when the timed path is broken underneath by each fault the cell can
have (a token altered where it is produced, the cache left unwritten)."""
import json
import os
import subprocess
import sys

import pytest

from harness.main import forbidden_modules, run_cell
from tiny import tiny_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = ["gpt3-1.3b.serve-chat", "gpt3-1.3b.serve-fewshot-batch"]
SEED = 2 ** 31 + 12345


def _run(name, trace=False, seed=SEED):
    result, checks, _ = run_cell(tiny_cell(name), seed, 2.0, trace, "cpu")
    return result, checks


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules(["paddle_tpu_torch", "paddle_tpu_torch.ops",
                              "numpy"]) == []
    assert forbidden_modules(["paddle_tpu.ops", "jaxlib.xla", "flax",
                              "jax"]) == ["flax", "jax", "jaxlib",
                                          "paddle_tpu"]
    assert forbidden_modules() == [], "a test loaded JAX or the reference"


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "gpt3-1.3b.serve-chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(name, trace):
    result, checks = _run(name, trace)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert isinstance(dev["memory_peak_bytes"], int)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert "setup_s" not in line["metrics"]
        assert set(line.get("breakdown", {})) <= {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert all({"value", "limit"} == set(c) for c in line["checks"].values())


def _token_altered(monkeypatch):
    from paddle_tpu_torch.inference.generation import GenerationPool

    deliver = GenerationPool._deliver

    def altered(self, tok):
        tok = tok.copy()
        if self.decode_steps_total % 3 == 0:
            tok[:] = (tok + 1) % 500
        return deliver(self, tok)

    monkeypatch.setattr(GenerationPool, "_deliver", altered)


def _cache_unchanged(monkeypatch):
    from paddle_tpu_torch.nn.layer import transformer

    monkeypatch.setattr(transformer, "_paged_write",
                        lambda *a, **k: None)


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", [_token_altered, _cache_unchanged])
def test_serving_fault_fails_the_check(monkeypatch, name, fault):
    fault(monkeypatch)
    result, checks = _run(name)
    assert result["correct"] is False, result["checks"]
