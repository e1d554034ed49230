"""The port stands alone: ``import paddle_tpu_torch`` pulls in neither JAX
nor the reference package, no source file of the port imports either,
and the entry points run on the card unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import (DecodeSession, GenerationPool, ServingEngine,
                              TransformerLM, UnavailableError, to_tensor)

PKG_DIR = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.ops.decode_kernels"
            ", paddle_tpu_torch.ops._build, paddle_tpu_torch.ops.flash_kernels"
            ", paddle_tpu_torch.optimizer, paddle_tpu_torch.jit.train_step"
            ", paddle_tpu_torch.nn.functional.loss, paddle_tpu_torch.nn.clip"
            ", paddle_tpu_torch.regularizer, paddle_tpu_torch.framework.engine"
            ", paddle_tpu_torch.tensor.creation, paddle_tpu_torch.autograd"
            ", paddle_tpu_torch.incubate.custom_op"
            ", paddle_tpu_torch.incubate.autograd"
            ", paddle_tpu_torch.incubate.operators"
            ", paddle_tpu_torch.ops.custom_kernels"
            ", paddle_tpu_torch.utils.cpp_extension"
            ", paddle_tpu_torch.amp, paddle_tpu_torch.core.flags"
            ", paddle_tpu_torch.core.amp_state"
            ", paddle_tpu_torch.framework.dispatch"
            ", paddle_tpu_torch.tensor.linalg\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r)\nprint(bad)\nsys.exit(1 if bad else 0)" % (FORBIDDEN,))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_imports_jax_or_reference():
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                elif isinstance(node, ast.Call) and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str) \
                        and getattr(node.func, "attr",
                                    getattr(node.func, "id", "")) in (
                                        "import_module", "__import__"):
                    names = [node.args[0].value]
                offenders += ["%s:%d %s" % (os.path.relpath(path, REPO),
                                            node.lineno, n)
                              for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_entry_points_default_to_cuda(monkeypatch):
    kw = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
              max_position=16)
    model = TransformerLM(device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: TransformerLM(**kw),
                  lambda: DecodeSession(model, max_len=16),
                  lambda: GenerationPool(model, max_len=16),
                  lambda: ServingEngine(model, max_len=16),
                  lambda: to_tensor([1.0])):
        with pytest.raises(UnavailableError, match='device="cpu"'):
            build()
    # asked for explicitly, the CPU runs
    out = GenerationPool(model, max_len=16, slots=1, buckets=[8],
                         device="cpu").generate([np.arange(1, 4)], 2)
    assert out[0].shape == (2,)
