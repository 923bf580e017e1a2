"""The unsigned-lane policy of the port.

Clock planes are stored as ``torch.uint32`` — the same bits and bytes
as the JAX package's ``jnp.uint32`` lanes — but eager torch implements
almost no arithmetic on unsigned 32/64-bit tensors (``maximum``, ``>``,
``<=``, ``masked_fill``, ``gather`` and ``nonzero`` all raise on the
CPU). The plain torch code therefore computes through a wide signed
view and narrows again on the way out:

- ``uint32`` ↔ ``int64``: zero extension. Every u32 value fits, so the
  signed order IS the unsigned order.
- ``uint64`` ↔ ``int64``: a bit view with the sign bit flipped, an
  order-preserving bijection (``0 → -2⁶³``, ``2⁶⁴-1 → 2⁶³-1``).

Both directions go through ``int32``/``int64`` views and casts only, so
no kernel ever runs on an unsigned dtype (CUDA's unsigned support is as
thin as the CPU's). The hand-written CUDA kernels read ``uint32_t``
natively. Values never exceed the lane width, so narrowing never wraps
a real counter.
"""

from __future__ import annotations

import torch

_SIGN64 = -(1 << 63)
_MASK32 = 0xFFFFFFFF


def to_wide(x: torch.Tensor) -> torch.Tensor:
    """An ``int64`` tensor with the same order as ``x``'s lanes."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & _MASK32
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ _SIGN64
    return x.to(torch.int64)


def from_wide(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_wide` for lanes of ``dtype``."""
    if dtype == torch.uint32:
        return y.to(torch.int32).view(torch.uint32)
    if dtype == torch.uint64:
        return (y ^ _SIGN64).view(torch.uint64)
    return y.to(dtype)


def wide_scalar(value: int, dtype: torch.dtype) -> int:
    """A Python counter cast to ``dtype`` (wrapping, as ``astype`` does)
    and then widened like :func:`to_wide`."""
    if dtype == torch.uint32:
        return int(value) & _MASK32
    if dtype == torch.uint64:
        return (int(value) & ((1 << 64) - 1)) + _SIGN64
    return int(value)


def zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeros of an unsigned (or any other) lane dtype."""
    if dtype == torch.uint32:
        return torch.zeros(shape, dtype=torch.int32, device=device).view(torch.uint32)
    if dtype == torch.uint64:
        return torch.zeros(shape, dtype=torch.int64, device=device).view(torch.uint64)
    return torch.zeros(shape, dtype=dtype, device=device)


def bits(x: torch.Tensor) -> torch.Tensor:
    """A signed view of ``x`` with the same bytes, for copies, slicing
    assignment and bit-exact comparison (``torch.equal``)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    return x


def umax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The unsigned max of a ``uint32``/``uint64`` tensor along ``dim``,
    in one temporary of the signed width: flipping the sign bit maps the
    unsigned order onto the signed one (``amax`` then runs on a signed
    dtype, which every device implements)."""
    s = bits(x)
    flip = -(1 << (8 * s.element_size() - 1))
    return ((s ^ flip).amax(dim=dim) ^ flip).view(x.dtype)


def raw(x: torch.Tensor) -> torch.Tensor:
    """The lane values of an unsigned tensor as ``int64`` bits for
    wrapping arithmetic: ``uint32`` zero-extended (wrap with
    :func:`from_raw`), ``uint64`` as its two's-complement bit view."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    return to_wide(x)


def from_raw(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`raw`, wrapping modulo the lane width."""
    if dtype == torch.uint64:
        return y.view(torch.uint64)
    return (y & _MASK32).to(torch.int32).view(torch.uint32)


def mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for ``int64`` lanes in ``[0, 2**32)``, without
    overflowing ``int64``: the product is taken in 16-bit halves of
    ``a``."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _MASK32
