"""Tensor arrays: ``create_array``, ``array_write``, ``array_read``,
``array_length`` and ``TensorArray`` (counterpart of the reference's
``tensor/array.py``).

Two forms, as the reference's:

- eagerly an array is a plain Python ``list`` of tensors (the
  reference's dygraph mode): a read returns the tensor written, so
  autograd flows through it;
- ``TensorArray`` is a fixed-capacity stacked buffer ``[capacity,
  *element_shape]`` and a 0-d int32 length, for loop state that
  ``while_loop`` carries while ``torch.export`` traces.  Its writes return
  a new array (``index_copy`` out of place), as the reference's functional
  update.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError

__all__ = ["create_array", "array_write", "array_read", "array_length",
           "TensorArray"]


def _index(i):
    """A scalar integer index as a 0-d int64 tensor, or a Python int."""
    if not torch.is_tensor(i):
        if isinstance(i, bool) or not float(i).is_integer():
            raise InvalidArgumentError(
                "array index must be an integer, got %r" % (i,))
        return int(i)
    if tuple(i.shape) not in ((), (1,)):
        raise InvalidArgumentError(
            "array index must be a scalar (shape [] or [1]), got %s"
            % (tuple(i.shape),))
    if i.is_floating_point() or i.dtype == torch.bool:
        raise InvalidArgumentError(
            "array index must be an integer, got dtype %s" % (i.dtype,))
    return i.reshape(()).to(torch.int64)


def _concrete(idx) -> Optional[int]:
    """The index's value when it can be read without a trace."""
    if not torch.is_tensor(idx):
        return idx
    return None if torch.compiler.is_compiling() else int(idx)


class TensorArray:
    """Stacked fixed-capacity tensor array: ``buffer`` is ``[capacity,
    *element_shape]``, ``length`` the 0-d int32 ``max(written index + 1)``.
    Every operation returns a new array."""

    def __init__(self, buffer, length):
        self.buffer = buffer
        self.length = length

    @staticmethod
    def create(capacity: int, element_shape, dtype="float32", device=None):
        buf = torch.zeros((int(capacity),) + tuple(int(s) for s in
                                                   element_shape),
                          dtype=convert_dtype(dtype or "float32"),
                          device=device)
        return TensorArray(buf, torch.zeros((), dtype=torch.int32,
                                            device=buf.device))

    @property
    def capacity(self) -> int:
        return self.buffer.shape[0]

    def _check_bounds(self, idx) -> None:
        # a traced index cannot be checked; index_copy / index_select keep
        # a traced index's access inside the buffer
        c = _concrete(idx)
        if c is not None and not 0 <= c < self.capacity:
            raise InvalidArgumentError(
                "TensorArray index %d out of capacity [0, %d)"
                % (c, self.capacity))

    def write(self, i, x) -> "TensorArray":
        idx = _index(i)
        self._check_bounds(idx)
        x = torch.as_tensor(x, device=self.buffer.device) \
            .to(self.buffer.dtype)
        pos = torch.as_tensor(idx, device=self.buffer.device).reshape(1)
        buf = self.buffer.index_copy(0, pos, x.reshape(
            (1,) + tuple(self.buffer.shape[1:])))
        length = torch.maximum(self.length, (pos[0] + 1).to(torch.int32))
        return TensorArray(buf, length)

    def read(self, i):
        idx = _index(i)
        self._check_bounds(idx)
        pos = torch.as_tensor(idx, device=self.buffer.device).reshape(1)
        return self.buffer.index_select(0, pos)[0]

    def stack(self):
        """The stacked buffer [capacity, *element_shape] (slots past
        ``length`` are zeros)."""
        return self.buffer

    def __len__(self):
        return int(self.length)


def _as_tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def create_array(dtype: str = "float32", initialized_list=None, *,
                 capacity: Optional[int] = None, element_shape=None,
                 place=None):
    """A plain list eagerly; with ``capacity=`` and ``element_shape=`` the
    stacked :class:`TensorArray` (on ``place``, the CPU when None) for loop
    state under a trace."""
    if capacity is not None:
        if element_shape is None:
            raise InvalidArgumentError(
                "stacked TensorArray needs element_shape= with capacity=")
        ta = TensorArray.create(capacity, element_shape, dtype, place)
        for idx, x in enumerate(initialized_list or ()):
            ta = ta.write(idx, x)
        return ta
    return [_as_tensor(x) for x in initialized_list or ()]


def array_write(x, i, array=None):
    """Write ``x`` at position ``i`` and return the array; a list takes
    ``i <= len`` (an append at ``len``), as the reference's dygraph
    branch."""
    if array is None:
        array = []
    if isinstance(array, TensorArray):
        return array.write(i, x)
    if not isinstance(array, list):
        raise InvalidArgumentError(
            "array must be a list or TensorArray, got %r" % type(array))
    idx = int(_index(i))
    if idx > len(array):
        raise InvalidArgumentError(
            "array_write index %d beyond array length %d" % (idx, len(array)))
    x = _as_tensor(x)
    if idx == len(array):
        array.append(x)
    else:
        array[idx] = x
    return array


def array_read(array, i):
    """The tensor at position ``i``."""
    if isinstance(array, TensorArray):
        return array.read(i)
    if not isinstance(array, list):
        raise InvalidArgumentError(
            "array must be a list or TensorArray, got %r" % type(array))
    idx = int(_index(i))
    if not 0 <= idx < len(array):
        raise InvalidArgumentError(
            "array_read index %d out of range [0, %d)" % (idx, len(array)))
    return array[idx]


def array_length(array):
    """The length as a 0-d integer tensor (int32 for a TensorArray, as the
    reference's x32 mode; int64 for a list)."""
    if isinstance(array, TensorArray):
        return array.length
    if not isinstance(array, list):
        raise InvalidArgumentError(
            "array must be a list or TensorArray, got %r" % type(array))
    return torch.tensor(len(array), dtype=torch.int64)


# these manage their own tensors and operate on containers: the op shim
# leaves them as they are
for _f in (create_array, array_write, array_read, array_length):
    _f.__paddle_tpu_op__ = True  # type: ignore[attr-defined]
