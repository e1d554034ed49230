"""Plain PyTorch reference of the benchmark's model, independent of the
program: a pre-LN transformer language model with a tied head, and the
check of served tokens against its logits.  It runs in float32 with TF32
off (``set_precision("fp32")``); the serving control runs the same code
with TF32 on (``"tf32"``)."""
from .lm import leaf_specs, lm_logits, served_gaps, set_precision

__all__ = ["leaf_specs", "lm_logits", "served_gaps", "set_precision"]
