"""Lattice-join collectives over the virtual rank axis — counterpart of
the JAX package's ``parallel/collectives.py``.

A rank tensor is a NamedTuple of tensors (or one tensor) whose leading
axis is the P ranks of a :class:`.mesh.VirtualMesh`. ``ppermute`` is a
gather along that axis, ``psum``/``pmax`` reduce it away (the value every
rank would hold). The reductions of the JAX package follow:

- power-of-two P: **recursive doubling** — log2(P) rounds in which rank i
  joins its state with rank ``i ^ 2^k``'s; idempotence makes the overlap
  harmless, and every rank ends with the global join;
- any other P: all-gather, then every rank folds the gathered stack (one
  fold here, replicated).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

from .._dtypes import bits, umax
from ..ops import orswot as ops
from ..ops.lattice import tree_map


def _leaf(tree) -> torch.Tensor:
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree


def _size(tree) -> int:
    return _leaf(tree).shape[0]


def ppermute(tree, perm: Sequence[Tuple[int, int]]):
    """``lax.ppermute`` on the rank axis: rank ``dst`` receives rank
    ``src``'s slice for every ``(src, dst)`` pair; a rank no pair
    targets receives zeros. A ring shift (every ring round) is a roll,
    recursive doubling's exchange ``i <-> i ^ k`` a swap of halves; any
    other permutation gathers through an index table."""
    leaf = _leaf(tree)
    return permuter(perm, leaf.shape[0], leaf.device)(tree)


def permuter(perm: Sequence[Tuple[int, int]], p: int, device):
    """:func:`ppermute` over ``p`` ranks as a function of the tree, its
    index table (when the permutation is neither a roll nor a swap of
    halves: a ring over the live ranks of a faulted run) copied to the
    device once, here, so a round that calls it reads no host value."""
    src = [-1] * p
    for s, d in perm:
        src[d] = s
    shift = -src[0] % p
    if all(s == (d - shift) % p for d, s in enumerate(src)):
        return lambda tree: tree_map(lambda x: torch.roll(bits(x), shift, 0).view(x.dtype), tree)
    k = src[0]
    if k > 0 and k & (k - 1) == 0 and p % (2 * k) == 0 and all(
            s == d ^ k for d, s in enumerate(src)):
        # Recursive doubling's exchange i <-> i ^ k: swap the two halves of
        # every group of 2k ranks (no index table to copy to the device).
        return lambda tree: tree_map(
            lambda x: bits(x).reshape(p // (2 * k), 2, k, *x.shape[1:]).flip(1)
            .reshape(x.shape).view(x.dtype), tree)
    table = torch.tensor([max(s, 0) for s in src], device=device)
    hole = torch.tensor([s < 0 for s in src], device=device)

    def move(x):
        out = bits(x).index_select(0, table)
        return out.masked_fill(hole.reshape(-1, *([1] * (x.dim() - 1))), 0).view(x.dtype)

    return lambda tree: tree_map(move, tree)


def psum(x: torch.Tensor) -> torch.Tensor:
    """``lax.psum`` over the rank axis (integer or bool lanes)."""
    return x.sum(dim=0) if x.dtype != torch.bool else x.to(torch.int64).sum(dim=0)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """``lax.pmax`` over the rank axis; unsigned lanes keep their order."""
    if x.dtype in (torch.uint32, torch.uint64):
        return umax(x, 0)
    return x.amax(dim=0)


def all_reduce_lattice(
    local: Any,
    join_fn: Callable[[Any, Any], Tuple[Any, torch.Tensor]],
    fold_fn: Callable[[Any], Tuple[Any, torch.Tensor]],
) -> Tuple[Any, torch.Tensor]:
    """All-reduce with a lattice-join monoid over the rank axis of
    ``local`` (``[P, ...]`` leaves). Returns every rank's global join
    (``[P, ...]``) and the overflow flags OR-reduced over the ranks (one
    per flag of ``join_fn``: a scalar for ORSWOT, ``[2]`` for the Map and
    the sparse ORSWOT)."""
    size = _size(local)
    overflow = torch.zeros((), dtype=torch.bool, device=_leaf(local).device)
    if size & (size - 1) == 0 and size > 1:
        k = 1
        while k < size:
            other = ppermute(local, [(i, i ^ k) for i in range(size)])
            local, of = join_fn(local, other)
            overflow = overflow | torch.any(of, dim=0)
            k *= 2
    elif size > 1:
        folded, overflow = fold_fn(local)
        local = tree_map(lambda x: bits(x).expand(size, *x.shape).contiguous().view(x.dtype),
                         folded)
        overflow = torch.as_tensor(overflow, device=_leaf(local).device).to(torch.bool)
    return local, overflow


def all_reduce_clock(clock: torch.Tensor) -> torch.Tensor:
    """All-reduce with the VClock join (lane-wise max): ``[P, A]`` →
    every rank's ``[P, A]`` max."""
    top = pmax(clock)
    return bits(top).expand(clock.shape).contiguous().view(clock.dtype)


def all_reduce_join(local: ops.OrswotState) -> Tuple[ops.OrswotState, torch.Tensor]:
    """All-reduce with the ORSWOT lattice join over the rank axis: every
    rank's global join and the overflow flag (True if a deferred buffer
    overflowed anywhere)."""
    return all_reduce_lattice(local, ops.join, ops.fold)


def ring_round(
    local: ops.OrswotState,
    shift: int = 1,
    reduce_overflow: bool = True,
    join_fn: Callable[[Any, Any], Tuple[Any, torch.Tensor]] = ops.join,
):
    """One gossip round: every rank joins in the state of the rank
    ``shift`` positions up-ring. P-1 unit-shift rounds converge all
    ranks. ``reduce_overflow=False`` keeps the per-rank flags."""
    size = _size(local)
    other = ppermute(local, [(i, (i + shift) % size) for i in range(size)])
    joined, of = join_fn(local, other)
    if reduce_overflow:
        of = torch.any(of)
    return joined, of


__all__ = [
    "all_reduce_clock", "all_reduce_join", "all_reduce_lattice", "permuter", "pmax",
    "ppermute", "psum", "ring_round",
]
