"""Canonical forms for bit-exact law comparison — the port of the JAX
package's ``analysis/canon.py``.

The joins keep their state canonical where cheap (sorted segment tables,
valid-first slot compaction), but two buffers are ordered by join
*operand order*, not by content: the masked-epoch deferred buffers
(parked removes concatenate left-then-right before compaction) and the
MVReg sibling slot table. ``join(a, b)`` and ``join(b, a)`` then hold
the same set of slots in different lanes. The law engine compares
``canon(state)`` instead: content-ordered, bit-exact, dead lanes zeroed.

Both helpers take any leading batch axes, so the engine canonicalises a
whole stacked pair table at once. Clock lanes are ``uint32``; the sort
keys run on the ``int64`` view (``_dtypes``), the gathers on the raw bits.
"""

from __future__ import annotations

import torch

from .._dtypes import bits, to_wide
from ..ops.map import _lexsort


def _take(x: torch.Tensor, order: torch.Tensor, dim: int) -> torch.Tensor:
    idx = order if dim == -1 else order[..., None]
    return torch.take_along_dim(bits(x), idx, dim=dim).view(x.dtype)


def canon_epochs(dcl, payload, dvalid, payload_fill=0):
    """Canonicalise a masked-epoch deferred buffer: dead slots carry no
    payload, then valid slots first, ordered lexicographically by rm clock
    (unique among valid slots after every join's dedupe).

    ``dcl [..., D, A]`` clocks, ``payload [..., D, X]`` member masks, key
    masks or id lists (``payload_fill`` is the kind's dead value: 0/False
    for masks, -1 for id lists), ``dvalid [..., D]``. Returns the three
    canonical tensors."""
    dead = ~dvalid[..., None]
    dcl = torch.where(dead, 0, bits(dcl)).view(dcl.dtype)
    if payload.dtype == torch.bool:
        payload = payload & ~dead if not payload_fill else payload | dead
    else:
        payload = torch.where(dead, payload_fill, bits(payload)).view(payload.dtype)
    wide = to_wide(dcl)
    a = wide.shape[-1]
    keys = tuple(wide[..., i] for i in range(a - 1, -1, -1)) + ((~dvalid).to(torch.uint8),)
    order = _lexsort(*keys)
    return _take(dcl, order, -2), _take(payload, order, -2), _take(dvalid, order, -1)


def canon_mvreg(state):
    """Content-order an MVReg slot table: valid first, then by witness dot
    (actor, counter); dead payload zeroed (``ops.map._canon_child``, which
    the map kinds apply inside their joins)."""
    from ..ops import mvreg

    return mvreg.canon(state)


__all__ = ["canon_epochs", "canon_mvreg"]
