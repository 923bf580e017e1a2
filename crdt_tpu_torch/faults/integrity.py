"""The link-integrity checksum: a position-weighted modular sum over the
u32 lanes of a shipped tree. Counterpart of the JAX package's
``faults/integrity.py`` (``_lanes_u32``, ``checksum``, ``verify``), bit
for bit.

Lane ``i`` of each leaf is weighted by the odd constant ``2*i + 1`` and
leaf sums chain through multiplication by an odd (hence invertible mod
2^32) mixing constant, so any single-lane perturbation changes the
digest. The fused wire kernel K3 computes the same weighted sum of the
words it writes (its ``chk`` output), and ``parallel/wire.py`` chains
those partials into a digest equal to :func:`checksum` of the wire tree.

The port's sums run on ``int64`` lanes in ``[0, 2**32)`` and reduce
modulo 2^32 (``_dtypes.mul32`` keeps each product inside ``int64``).
"""

from __future__ import annotations

import torch

from .._dtypes import from_wide, mul32, to_wide

# Invertible-mod-2^32 leaf chaining constant (odd; the golden-ratio
# mixing constant).
_MIX = 0x9E3779B1
_MASK32 = 0xFFFFFFFF


def _leaves(tree):
    """The tensor leaves of a NamedTuple/tuple tree, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for child in tree:
        out += _leaves(child)
    return out


def _lanes_u32(leaf: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """A leaf's lanes as u32 words (``int64`` values in ``[0, 2**32)``),
    covering every payload bit: 8-byte leaves become two words per lane
    (low word first, as a little-endian bitcast gives them), 4-byte
    leaves their bits, bool and 1/2-byte leaves widen (floats of 2 bytes
    by their bits). The first ``batch_dims`` axes are kept; the rest
    flatten in row-major order."""
    lead = leaf.shape[:batch_dims]
    leaf = leaf.contiguous().reshape(*lead, -1)
    if leaf.dtype == torch.bool:
        lanes = leaf.to(torch.int64)
    elif leaf.element_size() in (4, 8):
        lanes = leaf.view(torch.int32).to(torch.int64) & _MASK32
    elif leaf.dtype in (torch.float16, torch.bfloat16):
        lanes = leaf.view(torch.int16).to(torch.int64) & 0xFFFF
    else:
        lanes = leaf.to(torch.int64) & _MASK32
    return lanes


def leaf_sum(leaf: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """One leaf's position-weighted sum ``Σ lane_i·(2i + 1) mod 2^32``
    (``int64``, one per batch lane)."""
    lanes = _lanes_u32(leaf, batch_dims)
    w = torch.arange(lanes.shape[-1], dtype=torch.int64, device=lanes.device) * 2 + 1
    return mul32(lanes, w & _MASK32).sum(dim=-1) & _MASK32


def chain(total: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """``total * MIX + part mod 2^32`` on ``int64`` lanes."""
    return (mul32(total, torch.full_like(total, _MIX)) + part) & _MASK32


def checksum(tree, batch_dims: int = 0) -> torch.Tensor:
    """The u32 digest of a shipped tree (packet or whole state):
    deterministic in content and leaf order. Returns an ``int64`` tensor
    holding the u32 value: 0-d, or one per lane of the first
    ``batch_dims`` axes (a ring's ``[P, ...]`` links)."""
    leaves = _leaves(tree)
    dev = leaves[0].device if leaves else "cpu"
    lead = leaves[0].shape[:batch_dims] if leaves else ()
    total = torch.zeros(lead, dtype=torch.int64, device=dev)
    for leaf in leaves:
        total = chain(total, leaf_sum(leaf, batch_dims))
    return total


def verify(tree, shipped_digest, batch_dims: int = 0) -> torch.Tensor:
    """Receiver-side check: recompute over what arrived and compare with
    the digest that rode the wire. A bool tensor (True = intact), 0-d or
    one per batch lane."""
    got = checksum(tree, batch_dims)
    if isinstance(shipped_digest, torch.Tensor):
        want = to_wide(shipped_digest.to(got.device))
    else:
        want = torch.tensor(int(shipped_digest), dtype=torch.int64, device=got.device)
    return got == (want & _MASK32)


def checksum_detects(fn=checksum, device="cuda") -> bool:
    """The DETECTOR for checksum implementations (run by the ``faults``
    static-check section): mint a small multi-leaf packet on ``device``,
    perturb one lane at a time the way ``inject.corrupt_tree`` does, and
    require the digest to change every time. One leaf per
    :func:`_lanes_u32` branch — u32 and i32 pass-through, bool widen, f32
    and bf16 by their bits — and an 8-byte leaf whose HIGH word is
    perturbed separately, so a digest that truncates 8-byte lanes to their
    low words fails here. The broken twin
    ``analysis.fixtures.checksum_ignores_corruption`` (a constant digest)
    fails this."""

    def u32(*v):
        return torch.tensor(v, dtype=torch.int64, device=device).to(torch.int32).view(torch.uint32)

    sample = (
        u32(*range(6)).reshape(2, 3),
        torch.tensor([1, 0, 3], dtype=torch.int32, device=device),
        torch.tensor([True, False], device=device),
        torch.tensor([1.5, -2.0], dtype=torch.float32, device=device),
        torch.tensor([0.5, 3.0], dtype=torch.bfloat16, device=device),
        torch.tensor([5, 9], dtype=torch.int64, device=device),
    )

    def bumped(leaf, amount=1):
        flat = to_wide(leaf).reshape(-1) if leaf.dtype == torch.uint32 else leaf.reshape(-1).clone()
        if leaf.dtype == torch.bool:
            flat[0] = ~flat[0]
        else:
            flat[0] += amount
        return (from_wide(flat, torch.uint32) if leaf.dtype == torch.uint32 else flat).reshape(
            leaf.shape)

    def digest(tree) -> int:
        return int(fn(tree))

    base = digest(sample)
    for i in range(len(sample)):
        if digest(tuple(bumped(x) if j == i else x for j, x in enumerate(sample))) == base:
            return False
    hi = bumped(sample[-1], 1 << 32)
    return digest(sample[:-1] + (hi,)) != base


__all__ = ["checksum", "checksum_detects", "verify"]
