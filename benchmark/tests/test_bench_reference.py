"""The plain reference against the program at tiny sizes on the CPU:
the same weights from the seed give the same logits.  The reference
imports nothing of the program."""
import ast
import glob
import os

import numpy as np
import torch

import paddle_tpu_torch as P
from harness import weights
from harness.serve import port_kwargs
from reference import lm_logits, served_gaps
from tiny import tiny_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lm():
    cfg = tiny_cell("gpt3-1.3b.serve-chat")["cfg"]
    model = P.TransformerLM(**port_kwargs(cfg), dropout=0.0, device="cpu",
                            seed=0)
    weights.load_into(model.named_parameters(), cfg, 17)
    return cfg, model.eval(), weights.make_all(cfg, 17, "cpu")


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")) + \
            glob.glob(os.path.join(BENCH, "cost", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for n in names:
                top = n.split(".")[0]
                assert top not in ("paddle_tpu_torch", "paddle_tpu", "jax",
                                   "harness"), (path, n)


def test_lm_logits_match_the_program():
    cfg, model, ref = _lm()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg["real_vocab_size"], (2, 40)))
    with torch.no_grad():
        got = model(ids)
    want = lm_logits(ref, cfg, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_served_gap_is_zero_for_the_reference_argmax():
    cfg, _, ref = _lm()
    prompt = torch.arange(3, 23)
    toks = []
    ids = prompt
    for _ in range(5):
        nxt = lm_logits(ref, cfg, ids[None])[0, -1].argmax()
        toks.append(int(nxt))
        ids = torch.cat([ids, nxt[None]])
    gaps = served_gaps(ref, cfg, prompt, torch.tensor(toks))
    assert gaps.shape == (5,) and float(gaps.max()) == 0.0
    wrong = torch.tensor(toks)
    wrong[2] += 1
    assert float(served_gaps(ref, cfg, prompt, wrong).max()) > 0
