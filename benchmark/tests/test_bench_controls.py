"""The serving control on the card: the reference put in the program's
place with TF32 on (the precision below the configuration's fp32), at a
cut depth, judged by the cell's own limits as a run's numbers are: it
has to fail one of them while the program passes.  Its full-size
readings, which the limits are set from, come from ``tools/calibrate.py``
(which judges them the same way)."""
import copy

import pytest
import torch

from harness import manifest
from harness.check import failed_by
from harness.main import run_cell

M = manifest.load_manifest()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpt3-1.3b.serve-chat",
                                  "gpt3-1.3b.serve-fewshot-batch"])
def test_serving_control_fails_the_cells_limits(card, name):
    cell = copy.deepcopy(manifest.cell(M, name))
    cell["cfg"]["num_layers"] = 4
    cell["mix"]["preroll_s"] = 2
    result, checks, info = run_cell(cell, 2 ** 31 + 7, 5.0, False, card,
                                    controls=True)
    assert result["correct"], result["checks"]
    assert failed_by(info["controls"]["tf32"], cell["limits"]) == \
        ["served_gap"], info["controls"]["tf32"]
