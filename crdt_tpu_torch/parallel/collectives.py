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

Handed a cross-process mesh (``multihost.GlobalMesh`` as ``procs``), the
all-reduce adds a process step after the rank step — rank 0's join
through ``multihost.all_reduce_processes`` (recursive doubling over the
processes, or gather and fold) —, ``psum``/``pmax``/``pmin`` add the
processes' sums, maxima and minima (``multihost.gather_processes``),
``preduce`` gathers per-rank vectors whole for a float sum that must
keep the single-process order, and a ring shift over every process's
ranks (:func:`ring_permuter`: the gossip round, the δ ring's packet
shift and its inverse, a faulted ring's shift over the live ranks)
sends each row whose sender and receiver sit on different processes
point to point (``multihost.exchange_rows``): one row a process for the
unit shift.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from .._dtypes import bits, from_wide, to_wide, umax
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


def process_schedule(perm: Sequence[Tuple[int, int]], p: int, me: int):
    """Process ``me``'s part of ``perm`` (pairs of GLOBAL ranks, ``p``
    local ranks a process, global rank ``process · p + local rank``):
    ``(local pairs, sends, recvs)`` — the pairs whose two ranks are its
    own, as local indices; ``(local sender, destination process, tag)``
    of each row it sends; ``(local receiver, source process, tag)`` of
    each row it receives. The tag is the receiving global rank, so a send
    and its receive carry the same one. Every process derives its part
    from ``perm`` alone."""
    lo = me * p
    local = [(s - lo, d - lo) for s, d in perm if s // p == me and d // p == me]
    sends = [(s - lo, d // p, d) for s, d in perm if s // p == me and d // p != me]
    recvs = [(d - lo, s // p, d) for s, d in perm if d // p == me and s // p != me]
    return local, sends, recvs


def ring_permuter(perm: Sequence[Tuple[int, int]], p: int, procs=None, device=None) -> Callable:
    """:func:`permuter` of ``perm``, a permutation of the GLOBAL rank axis
    of ``procs`` (a ``multihost.GlobalMesh``: ``p`` local ranks a process,
    global rank ``process · p + local rank``), as a function of this
    process's ``[p, ...]`` tree: a ring round's shift over every rank, or
    a faulted ring's over the live ranks (``faults.ring_perm`` /
    ``inv_ring_perm`` of the global rank count). A pair whose two ranks
    sit on this process moves through :func:`permuter`'s index table; the
    row of every pair that crosses processes goes point to point
    (``multihost.exchange_rows``), on a schedule every process derives
    from ``perm`` alone: each process sends the rows of its ranks whose
    receiver is elsewhere and receives those of its ranks whose sender
    is. The unit shift sends one row a process; a process whose ranks all
    self-loop (evicted) neither sends nor receives. Without processes to
    cross, ``permuter(perm, p, device)``."""
    if procs is None or procs.process_count == 1:
        return permuter(perm, p, device)
    me = procs.process_index
    local, sends, recvs = process_schedule(perm, p, me)
    move = permuter(local, p, device)
    if not (sends or recvs):
        return move
    from .multihost import exchange_rows

    at = torch.tensor([d for d, _, _ in recvs], device=device)

    def moved(tree):
        out = move(tree)
        got = exchange_rows([(tree_map(lambda x: x[i:i + 1], tree), dst, tag)
                             for i, dst, tag in sends],
                            [(src, tag) for _, src, tag in recvs], tree_map(lambda x: x[:1], tree))
        came = tree_map(lambda *xs: torch.cat([bits(x) for x in xs]), *got)
        return tree_map(lambda o, c: bits(o).index_copy(0, at, c).view(o.dtype), out, came)

    return moved


def _psum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=0) if x.dtype != torch.bool else x.to(torch.int64).sum(dim=0)


def _pmax(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in (torch.uint32, torch.uint64):
        return umax(x, 0)
    return x.amax(dim=0)


def _pmin(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in (torch.uint32, torch.uint64):
        return from_wide(to_wide(x).amin(dim=0), x.dtype)
    return x.amin(dim=0)


def preduce(sums: Sequence[torch.Tensor] = (), maxes: Sequence[torch.Tensor] = (), procs=None,
            mins: Sequence[torch.Tensor] = (), cats: Sequence[torch.Tensor] = ()):
    """:func:`psum` of each of ``sums``, :func:`pmax` of each of ``maxes``
    and :func:`pmin` of each of ``mins``, over the rank axis and then the
    processes of ``procs``, and each of ``cats`` (per-rank values, the
    rank axis LAST) concatenated along its rank axis over the processes
    in process order — all in ONE exchange (``multihost.gather_processes``).
    A float sum that must be the single-process sum bit for bit gathers
    its per-rank vector as a ``cat`` and sums the global vector once:
    adding every process's partial sum would change the order. Returns
    the four lists."""
    s, m, n = [_psum(x) for x in sums], [_pmax(x) for x in maxes], [_pmin(x) for x in mins]
    if procs is None or procs.process_count == 1:
        return s, m, n, list(cats)
    from .multihost import gather_processes

    rows = gather_processes(s + m + n + list(cats), procs)
    i, j, k = len(s), len(s) + len(m), len(s) + len(m) + len(n)
    return ([_psum(x) for x in rows[:i]], [_pmax(x) for x in rows[i:j]],
            [_pmin(x) for x in rows[j:k]],
            [torch.cat([bits(v) for v in x.unbind(0)], dim=-1).view(x.dtype) for x in rows[k:]])


def psum(x: torch.Tensor, procs=None) -> torch.Tensor:
    """``lax.psum`` over the rank axis (integer or bool lanes), and over
    the processes of ``procs``."""
    return preduce((x,), (), procs)[0][0]


def pmax(x: torch.Tensor, procs=None) -> torch.Tensor:
    """``lax.pmax`` over the rank axis, and over the processes of
    ``procs``; unsigned lanes keep their order."""
    return preduce((), (x,), procs)[1][0]


def pmin(x: torch.Tensor, procs=None) -> torch.Tensor:
    """``lax.pmin`` over the rank axis, and over the processes of
    ``procs``; unsigned lanes keep their order."""
    return preduce(procs=procs, mins=(x,))[2][0]


def all_reduce_lattice(
    local: Any,
    join_fn: Callable[[Any, Any], Tuple[Any, torch.Tensor]],
    fold_fn: Callable[[Any], Tuple[Any, torch.Tensor]],
    procs=None,
    flags: Optional[torch.Tensor] = None,
    rank_rows: Optional[list] = None,
) -> Tuple[Any, torch.Tensor]:
    """All-reduce with a lattice-join monoid over the rank axis of
    ``local`` (``[P, ...]`` leaves). Returns every rank's global join
    (``[P, ...]``) and the overflow flags OR-reduced over the ranks (one
    per flag of ``join_fn``: a scalar for ORSWOT, ``[2]`` for the Map and
    the sparse ORSWOT), ORed with ``flags`` (the ranks' own, e.g. their
    local folds') — and over every process of ``procs`` (a
    ``multihost.GlobalMesh``) when given; across processes every rank
    holds rank 0's bits.

    ``rank_rows``, a list, receives the rows each rank holds after a
    single-process all-reduce over every rank — where the join's bits
    depend on its order (an LWW tie, a sibling order) rank i holds
    ``join(own, partner)``, for the Telemetry's per-rank count. Across a
    power-of-two mesh of processes that carries every local rank's row
    through the process step."""
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
    if flags is not None:
        overflow = overflow | flags
    rows = local
    if procs is not None and procs.process_count > 1:
        from .multihost import all_reduce_processes

        n = procs.process_count
        doubling = rank_rows is not None and size & (size - 1) == 0 and n & (n - 1) == 0
        one, overflow, rows = all_reduce_processes(
            tree_map(lambda x: x[:1], local), overflow, join_fn, fold_fn, procs,
            rows=local if doubling else None)
        local = tree_map(lambda x: bits(x).expand(size, *x.shape[1:]).contiguous().view(x.dtype),
                         one)
        rows = local if rows is None else rows
    if rank_rows is not None:
        rank_rows.append(rows)
    return local, overflow


def all_reduce_clock(clock: torch.Tensor, procs=None) -> torch.Tensor:
    """All-reduce with the VClock join (lane-wise max): ``[P, A]`` →
    every rank's ``[P, A]`` max, over the processes of ``procs`` too."""
    top = pmax(clock, procs)
    return bits(top).expand(clock.shape).contiguous().view(clock.dtype)


def all_reduce_join(local: ops.OrswotState, procs=None, flags: Optional[torch.Tensor] = None,
                    rank_rows: Optional[list] = None) -> Tuple[ops.OrswotState, torch.Tensor]:
    """All-reduce with the ORSWOT lattice join over the rank axis (and the
    processes of ``procs``): every rank's global join and the overflow
    flag (True if a deferred buffer overflowed anywhere, ``flags``
    included); ``rank_rows`` as in :func:`all_reduce_lattice`."""
    return all_reduce_lattice(local, ops.join, ops.fold, procs, flags, rank_rows)


def ring_round(
    local: ops.OrswotState,
    shift: int = 1,
    reduce_overflow: bool = True,
    join_fn: Callable[[Any, Any], Tuple[Any, torch.Tensor]] = ops.join,
    procs=None,
):
    """One gossip round: every rank joins in the state of the rank
    ``shift`` positions up-ring. P-1 unit-shift rounds converge all
    ranks. ``reduce_overflow=False`` keeps the per-rank flags. With
    ``procs`` (a ``multihost.GlobalMesh``) the ring runs over every
    process's ranks, process-major (:func:`ring_permuter`)."""
    size = _size(local)
    total = size if procs is None else size * procs.process_count
    move = ring_permuter([(i, (i + shift) % total) for i in range(total)], size, procs,
                         _leaf(local).device)
    other = move(local)
    joined, of = join_fn(local, other)
    if reduce_overflow:
        of = torch.any(of)
    return joined, of


__all__ = [
    "all_reduce_clock", "all_reduce_join", "all_reduce_lattice", "permuter", "pmax", "pmin",
    "ppermute", "preduce", "process_schedule", "psum", "ring_permuter", "ring_round",
]
