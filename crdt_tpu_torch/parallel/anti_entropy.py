"""Full-state anti-entropy over the virtual rank axis — the entries
``mesh_fold`` and ``mesh_gossip`` (dense ORSWOT), ``mesh_fold_map`` and
``mesh_gossip_map`` (Map<K, MVReg>) and ``mesh_fold_sparse`` (the
segment-encoded ORSWOT) of the JAX package's ``parallel/anti_entropy.py``.

Each rank folds its own replica block first (``fold_auto``: kernel K1
plus the epilogue on a card; ``ops.map.fold``: kernel K2 plus its
epilogue; the plain tree folds on the CPU; the sparse join, which has no
kernel, in one batched tree for all ranks); then one lattice all-reduce
(``mesh_fold*``) or ``rounds`` ring rounds (``mesh_gossip*``) join the
ranks. K1 and K2 have no rank axis, so the local fold is one launch per
rank, each streaming that rank's contiguous replica block.
``mesh_gossip_sparse`` is the ring for the segment-encoded ORSWOT;
``mesh_fold_sparse_mvmap`` / ``mesh_gossip_sparse_mvmap`` (the sparse
``Map<K, MVReg>``) and ``mesh_fold_sparse_nested`` /
``mesh_gossip_sparse_nested`` (any sparse nest, e.g. ``Map<K, Orswot>``)
are the sparse Map kinds' pair, the state replicated over the element
axis (their element-sharded folds are ``sparse_shard.py``'s);
``mesh_fold_map_orswot`` / ``mesh_gossip_map_orswot``,
``mesh_fold_map3`` / ``mesh_gossip_map3`` and ``mesh_fold_nested_map`` /
``mesh_gossip_nested_map`` are the dense nests' (``ops.nest``; each rank's
local fold is the fused level fold, K1 or K2 on the leaf, on a card);
``mesh_fold_clocks``, ``mesh_fold_gset``, ``mesh_fold_lww`` and
``mesh_fold_mvreg`` converge the clock, set and register kinds (no
kernel: a max, an ``any``, the kinds' tree folds); and
``gossip_elastic`` is the ring entries' overflow → widen → re-enter loop
(``elastic.py``).

``donate=True`` (the JAX entries' zero-copy mode) says the caller yields
the input state. A ring entry keeps the ``[P, ...]`` layout, so when the
padded replica axis equals P its outputs are written into the caller's
tensors and returned in them: one copy of the state outlives the call.
Any other batch counts ``anti_entropy.donate_unaliasable``. A fold entry
reduces the replica axis away, so no output can take the input's place.
Every input the outputs do not live in is freed after the run
(:func:`_consume`).

``telemetry=True`` returns the JAX entries' :class:`~crdt_tpu_torch.telemetry.Telemetry`
as the third element of the tuple: ``merges`` counts the JAX package's
joins (each rank's ``R/P - 1`` local-fold joins plus log2(P) or P-1
exchange joins for an all-reduce, plus one per ring round), whatever the
port's ``collectives`` run inside; ``slots_changed`` the kind's changed
lanes (``changed_members``, ``changed_keys``, ``changed_dots``,
``changed_cells``, every plane's changed entries for a nest);
``bytes_exchanged`` one rank's shipped state per exchange, over all
ranks — and, for the sparse kinds, over the mesh's ``s`` element shards,
each of which holds and ships a replicated copy (the JAX sums over
``(REPLICA_AXIS, ELEMENT_AXIS)``).

``stability=True`` on the ring entries (``reclaim/``) takes the mesh-wide
stable frontier — one ``amin`` over every rank's PRE-fold input tops, the
knowledge each replica entered with, so a straggler row pins it — runs
the kind's ``compact`` on the converged rows before they are returned,
and appends the frontier as the last tuple element. With
``telemetry=True`` too, the Telemetry's ``reclaimed_slots`` /
``reclaimed_bytes`` are the ranks' sums and ``frontier_lag`` their max.
``lag_threshold=`` (it needs ``stability=``) watches the lag once per
call from one host read (``reclaim.watch_lag``).

Every entry feeds the host metrics registry at the JAX entries' points:
a rounds counter, ``anti_entropy.merges`` (the folds),
``anti_entropy.state_bytes`` and the ``<kind>.deferred_depth`` gauge of
the padded input, and the ``anti_entropy.<kind>`` timer around the
device work (the card is synchronised before it stops).

``faults=`` (a ``faults.FaultPlan``) on the ring entries and
``gossip_elastic`` injects the plan's link faults into every exchange:
each shipped state carries a checksum lane, corrupted arrivals are
rejected (local state kept), dropped ones missed, delayed ones joined a
round late; the ring runs over the plan's live ranks, and with
``stability=`` the frontier leaves out evicted ranks' tops while their
own rows stay uncompacted. The fates come from a table built and
uploaded before the first round. The ``FaultCounters`` come back as the
LAST element. Full-state loss is never unsound: a missed round only
slows convergence.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Tuple

import torch

from .. import telemetry as tele
from .._dtypes import bits, from_raw, from_wide, raw, to_wide, umax
from ..utils.metrics import metrics, observe_depth, state_nbytes
from ..ops import map as map_ops
from ..ops import map3 as m3_ops
from ..ops import map_map as mm_ops
from ..ops import lwwreg as lww_ops
from ..ops import map_orswot as mo_ops
from ..ops import mvreg as mv_ops
from ..ops import nest as nest_ops
from ..ops import orswot as ops
from ..ops import sparse_mvmap as smv
from ..ops import sparse_nest as sparse_nest_ops
from ..ops import sparse_orswot as sp
from ..ops.fold_kernels import fold_auto
from ..ops.lattice import tree_leaves, tree_map
from ..ops.lwwreg import LWWState
from ..ops.map import MapState
from ..ops.mvreg import MVRegState
from ..ops.orswot import OrswotState
from ..ops.sparse_mvmap import SparseMVMapState
from ..ops.sparse_nest import SparseNestState
from ..ops.sparse_orswot import SparseOrswotState
from ..faults import inject as flt
from ..faults.integrity import checksum
from ..reclaim.frontier import frontier_lag, top_of, watch_lag
from .collectives import (
    all_reduce_clock, all_reduce_join, all_reduce_lattice, permuter, psum, ring_round,
)
from .mesh import VirtualMesh, pad_replicas, pad_replicas_map, pad_replicas_sparse

#: The kinds whose join takes any leading batch: a rank block folds in one
#: tree with the P ranks as a batch (:func:`local_folds`).
_BATCHED_JOINS = (SparseOrswotState, SparseMVMapState, SparseNestState)


def _record(counter: str, n: int, blocks, depth_name: str, merges: bool = True) -> None:
    """An entry's registry counts before its run (the JAX entries'): the
    rounds ``counter`` by ``n``, ``anti_entropy.merges`` (a fold's
    padded rows - 1), and the padded input's bytes and parked depth."""
    metrics.count(counter, n)
    if merges:
        rows = tree_leaves(blocks)[0].shape[:2].numel()
        metrics.count("anti_entropy.merges", max(rows - 1, 0))
    metrics.observe("anti_entropy.state_bytes", state_nbytes(blocks))
    observe_depth(depth_name, blocks)


@contextlib.contextmanager
def _timed(name: str, device):
    """The entry's ``<name>_seconds`` timer around its device work (the
    card is synchronised before the clock stops, as the JAX entries block
    until ready)."""
    with metrics.time(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _exchange_count(p: int) -> int:
    """The JAX all-reduce's exchanges per rank: log2(P) recursive-doubling
    hops on a power-of-two axis, P-1 shards otherwise (the telemetry's
    merge and byte count, whatever the port's all-reduce runs)."""
    if p <= 1:
        return 0
    if p & (p - 1) == 0:
        return p.bit_length() - 1
    return p - 1


def _tel_reduced(folded, slots, merges_per_rank: int, bytes_per_rank, p: int, residue=None,
                 useful_per_rank=None, copies: int = 1) -> tele.Telemetry:
    """The JAX ``_tel_reduced`` on the virtual mesh: ``slots`` (0-d,
    already summed over the ranks), ``merges`` P times the per-rank count,
    the wire bytes (a Python count, the same on every rank, or a ``[P]``
    float32 tensor) summed over the ranks and the ``copies`` element
    shards that hold a replicated state (each ships its copy), the gauges
    of ``folded`` (the ``[P, ...]`` rank rows) maxed. ``useful_per_rank``
    None = no mask, wire == useful."""
    dev = slots.device

    def per_rank(x):
        if not isinstance(x, torch.Tensor):
            x = torch.full((p,), float(x), dtype=torch.float32, device=dev)
        return x.repeat(copies) if copies > 1 else x

    wire = per_rank(bytes_per_rank).sum()
    return tele.fill(
        tele.zeros(dev), merges=p * merges_per_rank, slots_changed=slots,
        deferred_depth=tele.device_depth(folded), bytes_exchanged=wire,
        bytes_useful=wire if useful_per_rank is None else per_rank(useful_per_rank).sum(),
        residue=0 if residue is None else residue, widen_pressure=tele.device_pressure(folded),
    )


def _fold_tel(kind: str, folded, joined, blocks, slots_fn, p: int, t0: float,
              copies: int = 1):
    """The telemetry of an all-reduce fold entry (JAX ``mesh_fold`` /
    ``_mesh_fold_lattice``): the kind's changed lanes between each rank's
    local fold and the joined state, recorded under ``kind``."""
    n_ex = _exchange_count(p)
    rl = tree_leaves(blocks)[0].shape[1]
    tel = _tel_reduced(joined, slots_fn(folded, joined), max(rl - 1, 0) + n_ex,
                       tele.shipped_bytes(folded, batch_dims=1) * n_ex, p, copies=copies)
    return tele.finish_dispatch(kind, tel, t0)


def _donation(state, mesh: VirtualMesh, donate: bool) -> bool:
    """Whether a ring entry's ``[P, ...]`` outputs can take the donated
    input's place: exactly when the padded replica axis equals P (one
    replica row per rank, the steady-state mesh shape). A donating call
    with any other batch counts ``anti_entropy.donate_unaliasable`` (the
    JAX package's ``_ring_donate_argnums``)."""
    if not donate:
        return False
    r = tree_leaves(state)[0].shape[0]
    if r + (-r) % mesh.p != mesh.p:
        metrics.count("anti_entropy.donate_unaliasable")
        return False
    return True


def _write_back(dst, src):
    """Copy every leaf of ``src`` into the matching leaf of ``dst`` (same
    shape, dtype and device) and return the tree of the leaves that now
    hold the result: ``dst``'s where they matched, ``src``'s elsewhere."""
    if isinstance(src, torch.Tensor):
        if (dst.shape != src.shape or dst.dtype != src.dtype or dst.device != src.device):
            return src
        if src.untyped_storage().data_ptr() == dst.untyped_storage().data_ptr():
            if src.data_ptr() == dst.data_ptr() and src.stride() == dst.stride():
                return dst
            src = src.clone()
        bits(dst).copy_(bits(src))
        return dst
    out = [_write_back(a, b) for a, b in zip(dst, src)]
    return type(src)(*out) if hasattr(src, "_fields") else tuple(out)


def _consume(donated, keep=()) -> None:
    """Donation's end: free the storage of every donated input leaf that
    no output in ``keep`` lives in — the caller yielded it. A storage
    torch cannot resize (one borrowed from numpy) is left to the caller's
    reference."""
    kept = {leaf.untyped_storage().data_ptr() for leaf in tree_leaves(keep)}
    for leaf in tree_leaves(donated):
        storage = leaf.untyped_storage()
        if storage.data_ptr() in kept or storage.nbytes() == 0:
            continue
        try:
            storage.resize_(0)
        except RuntimeError:
            pass


def _donate_ring(donate: bool, aliasable: bool, state, out):
    """A ring entry's donation: write the ``[P, ...]`` outputs into the
    caller's state when aliasable, then free what is left of it."""
    if not donate:
        return out
    if aliasable:
        out = _write_back(state, out)
    _consume(state, keep=out)
    return out


def rank_blocks(state, mesh: VirtualMesh):
    """``state [R, ...]`` (an ``OrswotState``, ``MapState``,
    ``SparseOrswotState``, ``SparseMVMapState``, ``SparseNestState``, or
    any state whose join identity is all zeros: a dense nest of
    ``ops.nest``, ``LWWState``, ``MVRegState``) on the mesh's device,
    padded with identities of its kind to a multiple of P and viewed as
    ``[P, R/P, ...]`` rank blocks."""
    pad = (pad_replicas_map if isinstance(state, MapState)
           else pad_replicas_sparse if isinstance(state, _BATCHED_JOINS)
           else pad_replicas if isinstance(state, OrswotState)
           else nest_ops.pad_replicas)
    state = pad(tree_map(lambda x: x.to(mesh.device), state), mesh.p)
    return tree_map(lambda x: x.reshape(mesh.p, -1, *x.shape[1:]), state)


def stack(states, dtype_like) -> OrswotState:
    """Stack per-rank unbatched states into ``[P, ...]`` leaves."""
    return tree_map(
        lambda like, *xs: torch.stack([bits(x) for x in xs]).view(like.dtype),
        dtype_like, *states,
    )


def local_folds(blocks: OrswotState, fold_fn) -> Tuple[OrswotState, torch.Tensor]:
    """Every rank's fold of its own replica block (``fold_fn`` on one
    ``[R/P, ...]`` block → ``(state, overflow)``): ``[P, ...]`` states and
    the per-rank overflow flags ``[P]`` (``[P, 2]`` for two-lane flags).

    A sparse block folds in ONE tree over the row axis with the P ranks
    as a batch (the sparse kinds' joins take any leading batch): the same
    pairs as P separate folds, so the same bits, in 1/P of the launches."""
    if isinstance(blocks, _BATCHED_JOINS):
        return fold_fn(tree_map(lambda x: x.transpose(0, 1).contiguous(), blocks))
    p = tree_leaves(blocks)[0].shape[0]
    outs = [fold_fn(tree_map(lambda x: x[q], blocks)) for q in range(p)]
    folded = stack([s for s, _ in outs], outs[0][0])
    flags = [torch.as_tensor(of) for _, of in outs]
    return folded, torch.stack([of.reshape(()) if of.numel() == 1 else of for of in flags])


def _fold_fn(prefer: str):
    """The local fold of one rank block: ``fold_auto`` with ``prefer``
    ("auto" | "fused" | "tree")."""
    return lambda block: fold_auto(block, prefer=prefer)


def mesh_fold(
    state: OrswotState, mesh: VirtualMesh, local_fold: str = "auto",
    telemetry: bool = False, donate: bool = False,
) -> Tuple[OrswotState, torch.Tensor]:
    """Full-mesh anti-entropy: every replica's state joined into one
    converged state — each rank folds its block, then one lattice-join
    all-reduce over the ranks, on ``mesh.device``. Returns ``(converged
    state, overflow)``, with the Telemetry third when ``telemetry=True``."""
    t0 = time.perf_counter()
    blocks = rank_blocks(state, mesh)
    _record("anti_entropy.fold_rounds", 1, blocks, "anti_entropy.orswot_fold")
    with _timed("anti_entropy.fold", mesh.device):
        folded, of_local = local_folds(blocks, _fold_fn(local_fold))
        joined, of_cross = all_reduce_join(folded)
    out = tree_map(lambda x: x[0], joined)
    if donate:
        _consume(state, keep=out)
    of = torch.any(of_local) | of_cross
    if telemetry:
        return out, of, _fold_tel("orswot_fold", folded, joined, blocks, ops.changed_members,
                                  mesh.p, t0)
    return out, of


def mesh_gossip(
    state: OrswotState,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    local_fold: str = "auto",
    telemetry: bool = False,
    donate: bool = False,
    stability: bool = False,
    faults=None,
    lag_threshold=None,
) -> Tuple[OrswotState, torch.Tensor]:
    """Ring anti-entropy: each rank folds its block, then ``rounds``
    (default P-1) unit-shift ring rounds, each shipping one state per
    link. Returns ``(states [P, ...], overflow)``; with P-1 rounds every
    row is the full join. ``donate=True``: see the module docstring."""
    return _gossip("orswot_gossip", state, mesh, rounds, donate, _fold_fn(local_fold), ops.join,
                   telemetry, ops.changed_members, stability=stability, compact_fn=ops.compact,
                   lag_threshold=lag_threshold, faults=faults)


def _gossip(kind: str, state, mesh: VirtualMesh, rounds: Optional[int], donate: bool, fold_fn,
            join_fn, telemetry: bool = False, slots_fn=None, copies: int = 1,
            stability: bool = False, compact_fn=None, lag_threshold=None, faults=None):
    """The ring scaffold of the ``mesh_gossip*`` entries: each rank folds
    its block, then ``rounds`` (default P-1) unit-shift ring rounds.
    Returns ``(states [P, ...], overflow)`` with the flags OR-reduced over
    the ranks; ``telemetry=True`` adds the Telemetry (``slots_fn``'s
    changed lanes summed over the rounds); ``stability=True`` compacts the
    converged rows with ``compact_fn`` against the frontier of the input
    tops and appends the frontier; ``faults=`` runs the faulted exchange
    and appends the ``FaultCounters`` last (module docstring)."""
    if lag_threshold is not None and not stability:
        raise ValueError(
            "lag_threshold= needs stability=True: the stall alert watches the stable "
            "frontier, which only exists on the stability path — without it the alert "
            "would silently never arm")
    t0 = time.perf_counter()
    aliasable = _donation(state, mesh, donate)
    if rounds is None:
        rounds = mesh.p - 1
    faulted = faults is not None
    evicted = set(faults.evicted) if faulted else set()
    blocks = rank_blocks(state, mesh)
    _record(f"anti_entropy.{kind}_rounds", rounds, blocks, f"anti_entropy.{kind}", merges=False)
    with _timed(f"anti_entropy.{kind}", mesh.device):
        if stability:
            # The frontier over the PRE-fold input tops of every rank:
            # the knowledge each replica entered with (a straggler pins
            # it); an evicted rank's tops leave the minimum (eviction
            # unpins it).
            top = top_of(blocks)
            tmin = to_wide(top).reshape(mesh.p, -1, top.shape[-1]).amin(dim=1)
            if evicted:
                ev = flt.evicted_mask(faults, mesh.p, mesh.device)
                tmin = tmin.masked_fill(ev[:, None], torch.iinfo(torch.int64).max)
            frontier = from_wide(tmin.amin(dim=0), top.dtype)
        folded, of = local_folds(blocks, fold_fn)
        slots = 0
        if faulted:
            folded, of, slots, fc = _faulted_rounds(folded, of, rounds, join_fn, faults, mesh,
                                                    slots_fn if telemetry else None)
        for _ in range(0 if faulted else rounds):
            new, of_r = ring_round(folded, reduce_overflow=False, join_fn=join_fn)
            if telemetry:
                slots = slots + to_wide(slots_fn(folded, new))
            folded, of = new, of | of_r
        if stability:
            folded, freed, freed_b = _compact_ranks(compact_fn, folded, frontier, skip=evicted)
        if telemetry:
            rl = tree_leaves(blocks)[0].shape[1]
            slots = tele.scalar("slots_changed", slots, mesh.device)
            tel = _tel_reduced(folded, slots, max(rl - 1, 0) + rounds,
                               tele.shipped_bytes(folded, batch_dims=1) * rounds, mesh.p,
                               copies=copies)
            if stability:
                tel = tel._replace(reclaimed_slots=freed, reclaimed_bytes=freed_b,
                                   frontier_lag=frontier_lag(top_of(folded), frontier))
            if faulted:
                tel = tel._replace(faults_dropped=fc.packets_dropped,
                                   faults_rejected=fc.packets_rejected,
                                   faults_delayed=fc.packets_delayed)
        out = _donate_ring(donate, aliasable, state, folded), torch.any(of, dim=0)
    if telemetry:
        out = (*out, tele.finish_dispatch(kind, tel, t0))
    if stability:
        out = (*out, frontier)
        if lag_threshold is not None:
            watch_lag(kind, int(frontier_lag(top_of(out[0]), frontier)), lag_threshold)
    if faulted:
        flt.record(fc)
        out = (*out, fc)
    return out


def _faulted_rounds(folded, of, rounds: int, join_fn, faults, mesh: VirtualMesh, slots_fn):
    """The faulted exchange of the gossip ring (JAX ``_mesh_gossip_lattice``
    under ``faults=``): every round each rank ships its state with a
    checksum lane over the live ring, each receiver takes the round's
    fates from a table built before the first round, corrupts, verifies,
    joins and deselects the join where the state was dropped, rejected or
    held; a delayed state joins the next round (the last round delivers
    it at once). Full-state loss is never unsound: a missed round only
    slows convergence. Returns ``(rows, overflow, changed slots,
    FaultCounters)``."""
    p = mesh.p
    shift = permuter(flt.ring_perm(p, faults.evicted), p, mesh.device)
    fates = flt.LinkFates(faults, rounds, p, mesh.device)
    fc = flt.zero_counters(p, mesh.device)[:4]
    delay_mode = faults.delay > 0
    held = heldv = None
    slots = 0

    def flag(x, keep):
        return x & keep.reshape(-1, *([1] * (x.dim() - 1)))

    for r in range(rounds):
        other, chk = shift((folded, checksum(folded, batch_dims=1)))
        other, keep, fts = flt.receive_wire(fates, r, other, chk,
                                            delay_ok=delay_mode and r < rounds - 1)
        base = folded
        if held is not None:
            joined, of_h = join_fn(folded, held)
            folded = flt.tree_select(heldv, joined, folded)
            of = of | flag(of_h, heldv)
        joined, of_r = join_fn(folded, other)
        new = flt.tree_select(keep, joined, folded)
        if delay_mode:
            held, heldv = other, fts[2]
        fc = flt.tick_counters(fc, fts)
        if slots_fn is not None:
            slots = slots + to_wide(slots_fn(base, new))
        folded, of = new, of | flag(of_r, keep)
    return folded, of, slots, flt.finish_counters(fc)


def _compact_ranks(compact_fn, folded, frontier, skip=()):
    """Each rank's compaction of its converged row (the JAX per-device
    ``compact_fn``): the ``[P, ...]`` rows compacted, and the freed slots
    and bytes summed over the ranks once (the ``psum``; ``float32``
    bytes). The ranks in ``skip`` (evicted: the frontier may exceed
    their knowledge) keep their rows and free nothing."""
    p = tree_leaves(folded)[0].shape[0]
    outs = [compact_fn(tree_map(lambda x: x[q], folded), frontier) for q in range(p)]
    rows = stack([tree_map(lambda x: x[q], folded) if q in skip else o[0]
                  for q, o in enumerate(outs)], outs[0][0])
    kept = [o for q, o in enumerate(outs) if q not in skip]
    freed = from_raw(torch.stack([raw(o[1]) for o in kept]).sum(), torch.uint32)
    freed_b = torch.stack([o[2] for o in kept]).sum()
    return rows, freed, freed_b


def _mesh_fold_replicated(kind: str, states, mesh: VirtualMesh, join_fn, fold_fn, slots_fn,
                          telemetry: bool, donate: bool, copies: int = 1):
    """The all-reduce fold of a kind whose state the element axis
    replicates (the JAX ``_mesh_fold_lattice``): each rank folds its block
    (one batched tree for a sparse kind, the fused level fold for a dense
    nest on a card, the kind's tree fold otherwise), one lattice
    all-reduce joins the ranks. Returns ``(state, flags)`` — the flags
    OR-reduced over the ranks — and the Telemetry third when asked, its
    wire bytes summed over ``copies`` replicated element shards (the
    sparse kinds': ``mesh.s``)."""
    t0 = time.perf_counter()
    blocks = rank_blocks(states, mesh)
    _record(f"anti_entropy.{kind}_rounds", 1, blocks, f"anti_entropy.{kind}")
    with _timed(f"anti_entropy.{kind}", mesh.device):
        folded, of_local = local_folds(blocks, fold_fn)
        joined, of_cross = all_reduce_lattice(folded, join_fn, fold_fn)
    out = tree_map(lambda x: x[0], joined)
    if donate:
        _consume(states, keep=out)
    of = torch.any(of_local, dim=0) | of_cross
    if telemetry:
        return out, of, _fold_tel(kind, folded, joined, blocks, slots_fn, mesh.p, t0,
                                  copies=copies)
    return out, of


def mesh_fold_map(
    state: MapState, mesh: VirtualMesh, telemetry: bool = False, donate: bool = False,
) -> Tuple[MapState, torch.Tensor]:
    """Full-mesh anti-entropy for Map<K, MVReg> (BASELINE config 4): each
    rank folds its block (``ops.map.fold``: K2 and its epilogue on a
    card), then one lattice-join all-reduce over the ranks, on
    ``mesh.device``. Returns ``(converged state, overflow [2])`` —
    [sibling slab, deferred buffer] as in ``ops.map.join``; the Telemetry
    third with ``telemetry=True``."""
    return _mesh_fold_replicated("map_fold", state, mesh, map_ops.join, map_ops.fold,
                                 map_ops.changed_keys, telemetry, donate)


def mesh_gossip_map(
    state: MapState,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    telemetry: bool = False,
    donate: bool = False,
    stability: bool = False,
    faults=None,
    lag_threshold=None,
) -> Tuple[MapState, torch.Tensor]:
    """Ring anti-entropy for Map<K, MVReg>: each rank folds its block,
    then ``rounds`` (default P-1) unit-shift ring rounds, each shipping
    one state per link. Returns ``(states [P, ...], overflow [2])``; with
    P-1 rounds every row is the full join."""
    return _gossip("map_gossip", state, mesh, rounds, donate, map_ops.fold, map_ops.join,
                   telemetry, map_ops.changed_keys, stability=stability,
                   compact_fn=map_ops.compact, lag_threshold=lag_threshold, faults=faults)


def mesh_fold_sparse(
    states: SparseOrswotState, mesh: VirtualMesh, telemetry: bool = False,
    donate: bool = False,
) -> Tuple[SparseOrswotState, torch.Tensor]:
    """Converge a SPARSE (segment-encoded) ORSWOT replica batch over the
    mesh's replica axis, the segment table replicated (the element axis
    is 1): each rank folds its block (one batched log tree, see
    :func:`local_folds`), then one lattice-join all-reduce over the ranks,
    on ``mesh.device``. Returns ``(converged state, overflow [2])`` —
    [dot capacity, deferred capacity]; the Telemetry third with
    ``telemetry=True``."""
    return _mesh_fold_replicated("sparse_orswot_fold", states, mesh, sp.join, sp.fold,
                                 sp.changed_dots, telemetry, donate, copies=mesh.s)


def mesh_gossip_sparse(
    states: SparseOrswotState,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    telemetry: bool = False,
    donate: bool = False,
    stability: bool = False,
    faults=None,
    lag_threshold=None,
) -> Tuple[SparseOrswotState, torch.Tensor]:
    """Ring anti-entropy for SPARSE (segment-encoded) ORSWOT replica
    batches, the segment table replicated as in :func:`mesh_fold_sparse`:
    each rank folds its block, then ``rounds`` (default P-1) unit-shift
    ring rounds of ``ops.sparse_orswot.join``, one segment table per link
    per round (traffic proportional to live dots, not the universe).
    Returns ``(states [P, ...], overflow [2])``."""
    return _gossip("sparse_gossip", states, mesh, rounds, donate, sp.fold, sp.join, telemetry,
                   sp.changed_dots, copies=mesh.s, stability=stability, compact_fn=sp.compact,
                   lag_threshold=lag_threshold, faults=faults)


def mesh_fold_sparse_mvmap(
    states: SparseMVMapState, mesh: VirtualMesh, sibling_cap: int = 4, telemetry: bool = False,
    donate: bool = False,
) -> Tuple[SparseMVMapState, torch.Tensor]:
    """Converge a SPARSE ``Map<K, MVReg>`` replica batch
    (``ops.sparse_mvmap``) over the mesh's replica axis, the cell table
    replicated over the element axis: each rank folds its block (one
    batched tree), then one lattice all-reduce, on ``mesh.device``.
    Returns ``(state, flags [3])`` — [cell capacity, deferred capacity,
    sibling capacity]; the Telemetry third with ``telemetry=True``
    (``slots_changed``: ``changed_cells``)."""
    return _mesh_fold_replicated(
        f"sparse_mvmap_fold_s{sibling_cap}", states, mesh,
        lambda a, b: smv.join(a, b, sibling_cap=sibling_cap),
        lambda x: smv.fold(x, sibling_cap=sibling_cap), smv.changed_cells, telemetry, donate,
        copies=mesh.s)


def mesh_gossip_sparse_mvmap(
    states: SparseMVMapState,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    sibling_cap: int = 4,
    telemetry: bool = False,
    donate: bool = False,
    stability: bool = False,
    faults=None,
    lag_threshold=None,
) -> Tuple[SparseMVMapState, torch.Tensor]:
    """Ring anti-entropy for SPARSE ``Map<K, MVReg>`` replica batches:
    each rank folds its block, then ``rounds`` (default P-1) unit-shift
    ring rounds, one cell table per link per round (traffic proportional
    to live cells, not the key universe). Returns ``(states [P, ...],
    flags [3])``."""
    return _gossip(f"sparse_mvmap_gossip_s{sibling_cap}", states, mesh, rounds, donate,
                   lambda x: smv.fold(x, sibling_cap=sibling_cap),
                   lambda a, b: smv.join(a, b, sibling_cap=sibling_cap), telemetry,
                   smv.changed_cells, copies=mesh.s, stability=stability,
                   compact_fn=smv.compact, lag_threshold=lag_threshold, faults=faults)


def _nested_kind(level, op: str) -> str:
    """The JAX entries' kind key of a nested sparse level: its spans from
    the outside in, and the leaf's sibling cap (0 for an ORSWOT leaf)."""
    spans, core = [], level
    while hasattr(core, "core"):
        spans.append(str(core.span))
        core = core.core
    return f"sparse_nested_{op}_{'x'.join(spans)}_s{getattr(core, 'sibling_cap', 0)}"


def mesh_fold_sparse_nested(
    states: SparseNestState, mesh: VirtualMesh, level, telemetry: bool = False,
    donate: bool = False,
) -> Tuple[SparseNestState, torch.Tensor]:
    """Converge a SPARSE nested-map replica batch (any
    ``sparse_nest.SparseNestLevel`` composition, e.g.
    ``level_map_orswot(span)``) over the mesh's replica axis, the state
    replicated over the element axis; ``level`` carries the join and fold.
    Returns ``(state, flags [L+1])``; the Telemetry third with
    ``telemetry=True`` (``slots_changed``: every plane's changed
    entries)."""
    return _mesh_fold_replicated(_nested_kind(level, "fold"), states, mesh, level.join,
                                 level.fold, tele.generic_slots_changed, telemetry, donate,
                                 copies=mesh.s)


def mesh_gossip_sparse_nested(
    states: SparseNestState,
    mesh: VirtualMesh,
    level,
    rounds: Optional[int] = None,
    telemetry: bool = False,
    donate: bool = False,
    stability: bool = False,
    faults=None,
    lag_threshold=None,
) -> Tuple[SparseNestState, torch.Tensor]:
    """Ring anti-entropy for SPARSE nested-map replica batches (any
    ``SparseNestLevel`` composition): each rank folds its block, then
    ``rounds`` (default P-1) unit-shift ring rounds of ``level.join``.
    Returns ``(states [P, ...], flags [L+1])``."""
    return _gossip(_nested_kind(level, "gossip"), states, mesh, rounds, donate, level.fold,
                   level.join, telemetry, tele.generic_slots_changed, copies=mesh.s,
                   stability=stability, compact_fn=sparse_nest_ops.compact,
                   lag_threshold=lag_threshold, faults=faults)


# ---- the dense nests (ops.nest) ------------------------------------------------

def _leaf_members_changed(core_of):
    """The nest's ``slots_fn``: ``changed_members`` of the ORSWOT leaf."""
    return lambda a, b: ops.changed_members(core_of(a), core_of(b))


def mesh_fold_map_orswot(state, mesh: VirtualMesh, telemetry: bool = False,
                         donate: bool = False):
    """Full-mesh anti-entropy for ``Map<K, Orswot>`` (``ops.map_orswot``):
    each rank folds its block (the fused level fold: K1 on the K·M leaf,
    then the outer keyset level, on a card), then one lattice-join
    all-reduce over the ranks. Returns ``(state, flags [2])``; the
    Telemetry third with ``telemetry=True`` (``slots_changed``: the leaf's
    ``changed_members``)."""
    return _mesh_fold_replicated("map_orswot_fold", state, mesh, mo_ops.join, mo_ops.fold,
                                 _leaf_members_changed(lambda s: s.core), telemetry, donate)


def mesh_gossip_map_orswot(state, mesh: VirtualMesh, rounds: Optional[int] = None,
                           telemetry: bool = False, donate: bool = False,
                           stability: bool = False, faults=None, lag_threshold=None):
    """Ring anti-entropy for ``Map<K, Orswot>`` replica blocks: each rank
    folds its block, then ``rounds`` (default P-1) unit-shift ring rounds
    of ``map_orswot.join``. Returns ``(states [P, ...], flags [2])``."""
    return _gossip("map_orswot_gossip", state, mesh, rounds, donate, mo_ops.fold, mo_ops.join,
                   telemetry, _leaf_members_changed(lambda s: s.core), stability=stability,
                   compact_fn=mo_ops.compact, lag_threshold=lag_threshold, faults=faults)


def mesh_fold_map3(state, mesh: VirtualMesh, telemetry: bool = False, donate: bool = False):
    """Full-mesh anti-entropy for ``Map<K1, Map<K2, Orswot>>``
    (``ops.map3``): each rank's fused level fold (K1 on the leaf, two
    ``settle_outer`` levels), then one lattice-join all-reduce. Returns
    ``(state, flags [3])``; the Telemetry third with ``telemetry=True``."""
    return _mesh_fold_replicated("map3_fold", state, mesh, m3_ops.join, m3_ops.fold,
                                 _leaf_members_changed(lambda s: s.mo.core), telemetry, donate)


def mesh_gossip_map3(state, mesh: VirtualMesh, rounds: Optional[int] = None,
                     telemetry: bool = False, donate: bool = False, stability: bool = False,
                     faults=None, lag_threshold=None):
    """Ring anti-entropy for ``Map<K1, Map<K2, Orswot>>`` replica blocks.
    Returns ``(states [P, ...], flags [3])``."""
    return _gossip("map3_gossip", state, mesh, rounds, donate, m3_ops.fold, m3_ops.join,
                   telemetry, _leaf_members_changed(lambda s: s.mo.core), stability=stability,
                   compact_fn=m3_ops.compact, lag_threshold=lag_threshold, faults=faults)


def mesh_fold_nested_map(state, mesh: VirtualMesh, telemetry: bool = False,
                         donate: bool = False):
    """Full-mesh anti-entropy for ``Map<K1, Map<K2, MVReg>>``
    (``ops.map_map``): each rank's fused level fold (``decode_cells`` → K2
    → the Map epilogue, then the outer keyset level), then one
    lattice-join all-reduce. Returns ``(state, flags [3])``; the Telemetry
    third with ``telemetry=True`` (``slots_changed``: the flat map's
    ``changed_keys``)."""
    return _mesh_fold_replicated("nested_map_fold", state, mesh, mm_ops.join, mm_ops.fold,
                                 lambda a, b: map_ops.changed_keys(a.m, b.m), telemetry, donate)


def mesh_gossip_nested_map(state, mesh: VirtualMesh, rounds: Optional[int] = None,
                           telemetry: bool = False, donate: bool = False,
                           stability: bool = False, faults=None, lag_threshold=None):
    """Ring anti-entropy for ``Map<K1, Map<K2, MVReg>>`` replica blocks.
    Returns ``(states [P, ...], flags [3])``."""
    return _gossip("nested_map_gossip", state, mesh, rounds, donate, mm_ops.fold, mm_ops.join,
                   telemetry, lambda a, b: map_ops.changed_keys(a.m, b.m), stability=stability,
                   compact_fn=mm_ops.compact, lag_threshold=lag_threshold, faults=faults)


# ---- the clock, set and register kinds ----------------------------------------

def mesh_fold_clocks(clocks: torch.Tensor, mesh: VirtualMesh) -> torch.Tensor:
    """Converge a batch of vector clocks ``[R, A]`` (VClock / GCounter /
    PNCounter states) over the mesh: each rank's max over its block, then
    the clock all-reduce over the ranks, on ``mesh.device``. BASELINE
    configs 1–2 at mesh scale. Returns the converged clock ``[A]``."""
    pad = (-clocks.shape[0]) % mesh.p
    x = bits(clocks.to(mesh.device))
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    blocks = x.view(clocks.dtype).reshape(mesh.p, -1, clocks.shape[1])
    return all_reduce_clock(umax(blocks, 1))[0]


def mesh_fold_gset(present: torch.Tensor, mesh: VirtualMesh) -> torch.Tensor:
    """Converge a GSet replica batch ``present[R, M]`` over the mesh: set
    union (logical OR), each rank's ``any`` over its block, then an int32
    sum over the ranks, ``> 0`` — the simplest lattice (reference:
    src/gset.rs ``CvRDT::merge``). Both axes are padded as the JAX entry
    pads them (the member axis to the mesh's ``s`` shards). Returns the
    converged membership ``[M]``. Counts ``anti_entropy.gset_fold_rounds``,
    observes ``anti_entropy.state_bytes`` and times
    ``anti_entropy.gset_fold`` (device work included)."""
    m = present.shape[1]
    x = present.to(mesh.device)
    pad_r, pad_m = (-x.shape[0]) % mesh.p, (-m) % mesh.s
    if pad_r or pad_m:
        x = torch.nn.functional.pad(x, (0, pad_m, 0, pad_r))
    metrics.count("anti_entropy.gset_fold_rounds")
    metrics.observe("anti_entropy.state_bytes", float(x.numel() * x.element_size()))
    with metrics.time("anti_entropy.gset_fold"):
        local = torch.any(x.reshape(mesh.p, -1, x.shape[1]), dim=1)
        out = psum(local.to(torch.int32)) > 0
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    return out[:m]


def mesh_fold_lww(states: LWWState, mesh: VirtualMesh, telemetry: bool = False,
                  donate: bool = False):
    """Converge an LWWReg replica batch (``LWWState`` with leading axis R)
    over the mesh's replica axis: each rank folds its block, one lattice
    all-reduce joins the ranks. Returns ``(state, conflict)``; conflict
    marks an equal-marker/different-value merge anywhere (reference:
    src/lwwreg.rs validate_merge); the Telemetry third with
    ``telemetry=True``."""
    return _mesh_fold_replicated("lww_fold", states, mesh, lww_ops.join, lww_ops.fold,
                                 tele.generic_slots_changed, telemetry, donate)


def mesh_fold_mvreg(states: MVRegState, mesh: VirtualMesh, telemetry: bool = False,
                    donate: bool = False):
    """Converge an MVReg replica batch (``MVRegState`` with leading axis R)
    over the mesh's replica axis: dominated contents die, concurrent
    siblings survive (reference: src/mvreg.rs ``CvRDT::merge``). Returns
    ``(state, overflow)``; the Telemetry third with ``telemetry=True``."""
    return _mesh_fold_replicated("mvreg_fold", states, mesh, mv_ops.join, mv_ops.fold,
                                 tele.generic_slots_changed, telemetry, donate)


def gossip_elastic(model, mesh: VirtualMesh, rounds: Optional[int] = None, policy=None,
                   telemetry: bool = False, donate: bool = False, stability: bool = False,
                   reclaim=None, faults=None, lag_threshold=None):
    """Ring anti-entropy with elastic capacity recovery — the
    overflow → widen → resume loop at mesh scale (``elastic.py``): run the
    model family's ring gossip on ``model.state``; when a capacity lane
    overflows, the attempt's result is discarded (the gossip entries never
    commit to the model), the implicated axes widen by ``policy.factor``
    with the live state re-encoded on the device, and the ring re-enters.
    The widened state is bit-identical to a wider-born one, so the
    re-entered ring converges to the full join of the wider family.

    Covers ``BatchedOrswot`` (``mesh_gossip``; the deferred lane),
    ``BatchedSparseOrswot`` (``mesh_gossip_sparse``; dot and deferred
    lanes), ``BatchedMap`` (``mesh_gossip_map``; sibling and deferred
    lanes), ``BatchedSparseMap`` (``mesh_gossip_sparse_mvmap`` at the
    model's ``sibling_cap``; cell, deferred and sibling lanes) and
    ``BatchedSparseNestedMap`` (``mesh_gossip_sparse_nested`` with the
    model's level; cell, inner deferred, sibling and outer deferred
    lanes).
    ``donate=True`` donates each attempt's state into the ring and
    restores ``model.state`` from a pre-round copy afterwards (a failed
    attempt needs the pre-round state). Returns ``(rows, widened)``: the
    ``[P, ...]`` rows and the axes grown (empty when capacity sufficed);
    ``telemetry=True`` appends a Telemetry folded across every attempt
    (``telemetry.combine``: a discarded attempt's counters were real work
    and count, the gauges are the last attempt's).

    ``stability=True`` threads into the ring: the rows come back
    compacted and the frontier rides as the LAST tuple element.
    ``reclaim=`` takes an ``elastic.Hysteresis``, the shrink half of the
    loop: after the attempt that succeeds, the converged rows are
    committed into the model (:func:`_commit_rows`) and the tracker
    observes it, narrowing cleared axes in place — after a reclaim round,
    read the model, not the returned rows. ``lag_threshold=`` is the
    frontier-stall alert (it needs ``stability=``). ``faults=`` threads a
    ``FaultPlan`` into every attempt; the LAST element is then the
    ``FaultCounters`` with the packet counts summed over the attempts."""
    from .. import elastic
    from ..models.map import BatchedMap
    from ..models.orswot import BatchedOrswot
    from ..models.sparse_mvmap import BatchedSparseMap
    from ..models.sparse_nested_map import BatchedSparseNestedMap
    from ..models.sparse_orswot import BatchedSparseOrswot
    policy = policy or elastic.DEFAULT_POLICY

    def plan(m):
        """The ring of ``m``'s family (read afresh each attempt: a widen
        may have grown the sibling cap) and its overflow lanes' axes."""
        if isinstance(m, BatchedOrswot):
            return mesh_gossip, ("deferred_cap",)
        if isinstance(m, BatchedSparseOrswot):
            return mesh_gossip_sparse, ("dot_cap", "deferred_cap")
        if isinstance(m, BatchedMap):
            return mesh_gossip_map, ("sibling_cap", "deferred_cap")
        if isinstance(m, BatchedSparseMap):
            cap = m.sibling_cap
            return ((lambda *a, **k: mesh_gossip_sparse_mvmap(*a, sibling_cap=cap, **k)),
                    ("cell_cap", "deferred_cap", "sibling_cap"))
        if isinstance(m, BatchedSparseNestedMap):
            level = m.level
            return ((lambda st, msh, rnd, **k: mesh_gossip_sparse_nested(st, msh, level, rnd,
                                                                        **k)),
                    ("cell_cap", "deferred_cap", "sibling_cap", "key_deferred_cap"))
        raise TypeError(
            f"gossip_elastic covers BatchedOrswot, BatchedSparseOrswot, BatchedMap, "
            f"BatchedSparseMap and BatchedSparseNestedMap, got {type(m).__name__}")

    widened: dict = {}
    migrations = 0
    tel = fcs = None
    while True:
        run, lanes = plan(model)
        if donate:
            snap = tree_map(torch.clone, model.state)
        out = run(model.state, mesh, rounds, donate=donate, telemetry=telemetry,
                  stability=stability, lag_threshold=lag_threshold, faults=faults)
        if faults is not None:
            fcs = flt.accumulate_counters(fcs, out[-1])
            out = out[:-1]
        rows, flags = out[:2]
        if telemetry:
            tel = out[2] if tel is None else tele.combine(tel, out[2])
        if donate:
            model.state = snap
        flags = torch.atleast_1d(flags).tolist()
        hot = tuple(axis for lane, axis in enumerate(lanes) if flags[lane])
        if not hot:
            if reclaim is not None:
                # The shrink half: commit the converged rows (the shrink
                # must narrow the state the model carries into its next
                # round), then let the hysteresis decide.
                _commit_rows(model, rows)
                reclaim.observe(model)
            ret = (rows, widened)
            if telemetry:
                ret = (*ret, tel)
            if stability:
                ret = (*ret, out[-1])
            if fcs is not None:
                ret = (*ret, fcs)
            return ret
        if migrations >= policy.max_migrations:
            raise RuntimeError(
                f"gossip still overflowing after {migrations} migrations (axes grown: "
                f"{widened}); raise policy.factor or max_migrations")
        metrics.count("elastic.gossip_migrations")
        widened.update(elastic.widen(model, hot, policy))
        migrations += 1


def _commit_rows(model, rows) -> None:
    """Commit gossip rows into a model for the reclaim path: slice the
    identity-padded tail off and assign — the model is left as it was when
    the shapes cannot line up (shrinking the pre-round state is still
    sound; narrowing refuses anything unfit)."""
    lead = tree_leaves(model.state)[0].shape[0]
    sliced = tree_map(lambda x: x[:lead], rows)
    if all(a.shape == b.shape and a.dtype == b.dtype
           for a, b in zip(tree_leaves(sliced), tree_leaves(model.state))):
        model.state = sliced


__all__ = ["gossip_elastic", "local_folds", "mesh_fold", "mesh_fold_clocks", "mesh_fold_gset",
           "mesh_fold_lww", "mesh_fold_map", "mesh_fold_map3", "mesh_fold_map_orswot",
           "mesh_fold_mvreg", "mesh_fold_nested_map", "mesh_fold_sparse",
           "mesh_fold_sparse_mvmap", "mesh_fold_sparse_nested", "mesh_gossip", "mesh_gossip_map",
           "mesh_gossip_map3", "mesh_gossip_map_orswot", "mesh_gossip_nested_map",
           "mesh_gossip_sparse", "mesh_gossip_sparse_mvmap", "mesh_gossip_sparse_nested",
           "rank_blocks"]
