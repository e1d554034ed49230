"""Attention ops and the hand-written CUDA kernels (counterpart of
``paddle_tpu.ops``)."""
from .flash_attention import (decode_attention, decode_route,  # noqa: F401
                              dequantize_kv, paged_decode_attention,
                              quantize_kv)
