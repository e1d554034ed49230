"""Models of the port (counterpart of ``paddle_tpu.models``)."""
from .language_model import (  # noqa: F401
    TransformerForSequenceClassification, TransformerLM,
    TransformerLMCriterion, bert_base_config, ernie_base_config,
    gpt_1p3b_config)
