"""What one launch of a hand-written kernel asks of the card, reported to
the step cost count that is open around it.

``jit.aot`` counts a step's work once per shape key, on the key's first
(eager) call, under a ``TorchDispatchMode`` that sees every aten op.  A
kernel of this package is a ``ctypes`` call, which no dispatch mode sees,
so each wrapper reports its own count from its shapes where it launches,
as it counts its launches: :func:`report` hands the FLOPs and bytes to
every counting mode on the calling thread's dispatch-mode stack (the
autograd engine's threads inherit that stack, so a backward kernel is
counted too).  With no count open it does nothing."""
from __future__ import annotations

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["report", "nbytes"]


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None entries count 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def report(flops: float, bytes_accessed: float) -> None:
    """One kernel launch: ``flops`` operations and ``bytes_accessed`` bytes
    read and written, added to each open step cost count."""
    for mode in _get_current_dispatch_mode_stack():
        add = getattr(mode, "add_kernel_cost", None)
        if add is not None:
            add(float(flops), float(bytes_accessed))
