"""Models of the port (counterpart of ``paddle_tpu.models``)."""
from .language_model import TransformerLM, gpt_1p3b_config  # noqa: F401
