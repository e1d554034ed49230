"""Distributed serving primitives (counterpart of the reference's
``paddle_tpu.distributed``): the quantized model-parallel collectives of
the sharded decode step, and ``fleet.utils.recompute``.  The
training-side collectives and process groups are not ported."""
from . import fleet  # noqa: F401
from . import qcollectives  # noqa: F401
from .qcollectives import (COLLECTIVE_QUANT_MODES,  # noqa: F401
                           COLLECTIVE_QUANT_SCALES, QUANT_BLOCK,
                           dequantize_int8, psum_wire_bytes, qall_gather,
                           qpsum, qpsum_wire_bytes, quantize_int8,
                           row_parallel_linear)

__all__ = ["fleet", "qcollectives", "COLLECTIVE_QUANT_MODES",
           "COLLECTIVE_QUANT_SCALES", "QUANT_BLOCK", "quantize_int8",
           "dequantize_int8", "qpsum", "qall_gather", "psum_wire_bytes",
           "qpsum_wire_bytes", "row_parallel_linear"]
