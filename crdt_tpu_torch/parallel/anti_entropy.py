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

Every fold and gossip entry here also takes a cross-process mesh
(``multihost.global_mesh``): the state is this process's rows, each
process folds them on its own ranks, the all-reduce adds a process step
(``mesh_fold_clocks`` a process max, ``mesh_fold_gset`` a process sum)
and the gossip ring runs over every process's ranks (``collectives``),
P-1 rounds by default with P the global rank count; the fold returns the
global join on every process, the ring this process's rows, and the
flags are OR-reduced over every process. ``telemetry=True`` there
returns the mesh-wide Telemetry on every process: each process reduces
its own ranks, then one gather (``telemetry.reduce_processes``) sums the
counters, maxes the gauges and sums every float32 byte count over the
GLOBAL per-rank vector, the single-process order. ``stability=True``
takes the minimum of every process's input tops (one gather before the
rounds, the JAX ``lax.pmin``) and compacts each process's rows against
it; the frontier lag is the maximum over the processes, so
``lag_threshold=`` warns on every process alike. ``faults=`` runs the
live ring over every process's ranks: the plan names global ranks, each
process draws the global fate table and keeps its own receivers'
columns, a state whose sender sits on another process crosses point to
point (``collectives.ring_permuter``), and the flags and the fault
counters are reduced over every process in one gather (the streaks
gathered whole, in global rank order), so every process returns the
single-process counters. ``gossip_elastic`` takes all of these too,
re-entering the cross-process rings (its docstring).

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
    all_reduce_clock, all_reduce_join, all_reduce_lattice, pmax, pmin, preduce, psum,
    ring_permuter, ring_round,
)
from . import multihost
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


def _split_mesh(mesh, entry: str, wal=None):
    """``(procs, local mesh)`` of a mesh entry: ``(None, mesh)`` for a
    :class:`~.mesh.VirtualMesh`; for a cross-process
    :class:`~.multihost.GlobalMesh`, the mesh itself (the process step's
    group) and its local ranks, after refusing ``wal=``, which the
    cross-process entries do not take."""
    if not isinstance(mesh, multihost.GlobalMesh):
        return None, mesh
    if wal is not None:
        raise NotImplementedError(
            f"{entry} on a cross-process mesh does not take wal (ROADMAP item 32: the JAX "
            f"package's Wal.append_state cannot copy an array that spans processes to the host "
            f"either)")
    return mesh, mesh.local


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
                 useful_per_rank=None, copies: int = 1, procs=None, ranks=None,
                 **fields) -> tele.Telemetry:
    """The JAX ``_tel_reduced`` on the virtual mesh: ``slots`` (0-d,
    already summed over the ranks), ``merges`` P times the per-rank count,
    the wire bytes (a Python count, the same on every rank, or a ``[P]``
    float32 tensor) summed over the ranks and the ``copies`` element
    shards that hold a replicated state (each ships its copy), the gauges
    of ``folded`` (the ``[P, ...]`` rank rows) maxed; ``fields`` are
    further partial fields (0-d tensors) and ``ranks`` further per-rank
    float32 sums (``telemetry.reduce_processes``). ``useful_per_rank``
    None = no mask, wire == useful. With ``procs`` (a ``GlobalMesh``)
    ``p`` is this process's ranks and the result is reduced over every
    process: the mesh-wide Telemetry on every process."""
    dev = slots.device

    def per_rank(x):
        if not isinstance(x, torch.Tensor):
            x = torch.full((p,), float(x), dtype=torch.float32, device=dev)
        # Each element shard ships its copy: the rank vector once a shard.
        return x.expand(copies, p) if copies > 1 else x

    wire = per_rank(bytes_per_rank)
    tel = tele.fill(
        tele.zeros(dev), merges=p * merges_per_rank, slots_changed=slots,
        deferred_depth=tele.device_depth(folded), residue=0 if residue is None else residue,
        widen_pressure=tele.device_pressure(folded),
    )._replace(**fields)
    useful = wire if useful_per_rank is None else per_rank(useful_per_rank)
    return tele.reduce_processes(
        tel, procs, {"bytes_exchanged": wire, "bytes_useful": useful, **(ranks or {})})


def _fold_tel(kind: str, folded, joined, blocks, slots_fn, p: int, t0: float,
              copies: int = 1, procs=None):
    """The telemetry of an all-reduce fold entry (JAX ``mesh_fold`` /
    ``_mesh_fold_lattice``): the kind's changed lanes between each rank's
    local fold and its joined row (``joined``: the all-reduce's
    ``rank_rows``), recorded under ``kind``. Across the processes of
    ``procs`` the exchanges are the global rank count's."""
    n_ex = _exchange_count(p * (1 if procs is None else procs.process_count))
    rl = tree_leaves(blocks)[0].shape[1]
    tel = _tel_reduced(joined, slots_fn(folded, joined), max(rl - 1, 0) + n_ex,
                       tele.shipped_bytes(folded, batch_dims=1) * n_ex, p, copies=copies,
                       procs=procs)
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
    state, overflow)``, with the Telemetry third when ``telemetry=True``.
    On a cross-process mesh ``state`` is this process's rows (module
    docstring)."""
    t0 = time.perf_counter()
    procs, mesh = _split_mesh(mesh, "mesh_fold")
    blocks = rank_blocks(state, mesh)
    _record("anti_entropy.fold_rounds", 1, blocks, "anti_entropy.orswot_fold")
    rank_rows = [] if telemetry else None
    with _timed("anti_entropy.fold", mesh.device):
        folded, of_local = local_folds(blocks, _fold_fn(local_fold))
        joined, of = all_reduce_join(folded, procs, flags=torch.any(of_local),
                                     rank_rows=rank_rows)
    out = tree_map(lambda x: x[0], joined)
    if donate:
        _consume(state, keep=out)
    if telemetry:
        return out, of, _fold_tel("orswot_fold", folded, rank_rows[0], blocks,
                                  ops.changed_members, mesh.p, t0, procs=procs)
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
    row is the full join. ``donate=True``: see the module docstring. On a
    cross-process mesh the ring spans every process's ranks (P is the
    global count) and the rows returned are this process's."""
    procs, mesh = _split_mesh(mesh, "mesh_gossip")
    return _gossip("orswot_gossip", state, mesh, rounds, donate, _fold_fn(local_fold), ops.join,
                   telemetry, ops.changed_members, stability=stability, compact_fn=ops.compact,
                   lag_threshold=lag_threshold, faults=faults, procs=procs)


def _gossip(kind: str, state, mesh: VirtualMesh, rounds: Optional[int], donate: bool, fold_fn,
            join_fn, telemetry: bool = False, slots_fn=None, copies: int = 1,
            stability: bool = False, compact_fn=None, lag_threshold=None, faults=None,
            procs=None):
    """The ring scaffold of the ``mesh_gossip*`` entries: each rank folds
    its block, then ``rounds`` (default P-1) unit-shift ring rounds, over
    every process's ranks with ``procs`` (a ``GlobalMesh``).
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
        rounds = mesh.p * (1 if procs is None else procs.process_count) - 1
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
                ev = flt.evicted_mask(faults, mesh.p, mesh.device, procs)
                tmin = tmin.masked_fill(ev[:, None], torch.iinfo(torch.int64).max)
            # Across processes the minimum of every process's (JAX ``lax.pmin``).
            frontier = from_wide(pmin(tmin, procs), top.dtype)
        folded, of = local_folds(blocks, fold_fn)
        slots = 0
        if faulted:
            folded, of, slots, fc = _faulted_rounds(folded, of, rounds, join_fn, faults, mesh,
                                                    slots_fn if telemetry else None, procs)
            # The flags and the counter carry over every process in one
            # exchange: the packet totals and the streaks in global rank
            # order (the rank axis spans the processes).
            sums, _, _, cats = preduce((of, *fc[:3]), procs=procs, cats=(fc[3],))
            of, fc = sums[0] > 0, flt.finish_counters((*sums[1:], cats[0]))
        for _ in range(0 if faulted else rounds):
            new, of_r = ring_round(folded, reduce_overflow=False, join_fn=join_fn, procs=procs)
            if telemetry:
                slots = slots + to_wide(slots_fn(folded, new))
            folded, of = new, of | of_r
        if stability:
            # The plan names global ranks; this process skips its own.
            lo = 0 if procs is None else procs.process_index * mesh.p
            folded, freed, freed_b = _compact_ranks(
                compact_fn, folded, frontier, skip={q - lo for q in evicted})
            lag = frontier_lag(top_of(folded), frontier)
        if telemetry:
            rl = tree_leaves(blocks)[0].shape[1]
            fields, ranks = {}, {}
            if stability:
                fields.update(reclaimed_slots=freed, frontier_lag=lag)
                ranks["reclaimed_bytes"] = freed_b
            tel = _tel_reduced(folded, tele.scalar("slots_changed", slots, mesh.device),
                               max(rl - 1, 0) + rounds,
                               tele.shipped_bytes(folded, batch_dims=1) * rounds, mesh.p,
                               copies=copies, procs=procs, ranks=ranks, **fields)
            if faulted:
                # Already the totals over every process.
                tel = tel._replace(faults_dropped=fc.packets_dropped,
                                   faults_rejected=fc.packets_rejected,
                                   faults_delayed=fc.packets_delayed)
        if not faulted:
            of = torch.any(of, dim=0) if procs is None else psum(of, procs) > 0
        out = _donate_ring(donate, aliasable, state, folded), of
    if telemetry:
        out = (*out, tele.finish_dispatch(kind, tel, t0))
    if stability:
        out = (*out, frontier)
        if lag_threshold is not None:
            # The lag is the maximum over every process, so every process
            # warns alike.
            lag = tel.frontier_lag if telemetry else pmax(lag[None], procs)
            watch_lag(kind, int(lag), lag_threshold)
    if faulted:
        flt.record(fc)
        out = (*out, fc)
    return out


def _faulted_rounds(folded, of, rounds: int, join_fn, faults, mesh: VirtualMesh, slots_fn,
                    procs=None):
    """The faulted exchange of the gossip ring (JAX ``_mesh_gossip_lattice``
    under ``faults=``): every round each rank ships its state with a
    checksum lane over the live ring, each receiver takes the round's
    fates from a table built before the first round, corrupts, verifies,
    joins and deselects the join where the state was dropped, rejected or
    held; a delayed state joins the next round (the last round delivers
    it at once). Full-state loss is never unsound: a missed round only
    slows convergence. With ``procs`` (a ``GlobalMesh``) the live ring
    spans every process's ranks (``collectives.ring_permuter``) and the
    fates are this process's columns of the global table. Returns
    ``(rows, overflow [P, ...], changed slots, the per-rank counter
    carry)``: the caller reduces the last over every process."""
    p = mesh.p
    total = p * (1 if procs is None else procs.process_count)
    shift = ring_permuter(flt.ring_perm(total, faults.evicted), p, procs, mesh.device)
    fates = flt.LinkFates(faults, rounds, p, mesh.device, procs)
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
    return folded, of, slots, fc


def _compact_ranks(compact_fn, folded, frontier, skip=()):
    """Each rank's compaction of its converged row (the JAX per-device
    ``compact_fn``): the ``[P, ...]`` rows compacted, the freed slots
    summed over the ranks once (the ``psum``) and the freed bytes of
    every rank (``float32 [P]``, for the Telemetry's one sum over the
    ranks). The ranks in ``skip`` (evicted: the frontier may exceed
    their knowledge) keep their rows and free nothing: their counts are
    0, as the JAX ranks mask theirs."""
    p = tree_leaves(folded)[0].shape[0]
    outs = [compact_fn(tree_map(lambda x: x[q], folded), frontier) for q in range(p)]
    rows = stack([tree_map(lambda x: x[q], folded) if q in skip else o[0]
                  for q, o in enumerate(outs)], outs[0][0])
    kept = torch.tensor([q not in skip for q in range(p)], device=tree_leaves(folded)[0].device)
    freed = torch.stack([raw(o[1]) for o in outs]).masked_fill(~kept, 0)
    freed_b = torch.stack([o[2] for o in outs]).masked_fill(~kept, 0.0)
    return rows, from_raw(freed.sum(), torch.uint32), freed_b


def _mesh_fold_replicated(kind: str, states, mesh: VirtualMesh, join_fn, fold_fn, slots_fn,
                          telemetry: bool, donate: bool, copies: int = 1, procs=None):
    """The all-reduce fold of a kind whose state the element axis
    replicates (the JAX ``_mesh_fold_lattice``): each rank folds its block
    (one batched tree for a sparse kind, the fused level fold for a dense
    nest on a card, the kind's tree fold otherwise), one lattice
    all-reduce joins the ranks. Returns ``(state, flags)`` — the flags
    OR-reduced over the ranks — and the Telemetry third when asked, its
    wire bytes summed over ``copies`` replicated element shards (the
    sparse kinds': ``mesh.s``). ``procs`` (a ``GlobalMesh``) adds the
    process step and ORs the flags over every process."""
    t0 = time.perf_counter()
    blocks = rank_blocks(states, mesh)
    _record(f"anti_entropy.{kind}_rounds", 1, blocks, f"anti_entropy.{kind}")
    rank_rows = [] if telemetry else None
    with _timed(f"anti_entropy.{kind}", mesh.device):
        folded, of_local = local_folds(blocks, fold_fn)
        joined, of = all_reduce_lattice(folded, join_fn, fold_fn, procs,
                                        flags=torch.any(of_local, dim=0), rank_rows=rank_rows)
    out = tree_map(lambda x: x[0], joined)
    if donate:
        _consume(states, keep=out)
    if telemetry:
        return out, of, _fold_tel(kind, folded, rank_rows[0], blocks, slots_fn, mesh.p, t0,
                                  copies=copies, procs=procs)
    return out, of


def mesh_fold_map(
    state: MapState, mesh: VirtualMesh, telemetry: bool = False, donate: bool = False,
) -> Tuple[MapState, torch.Tensor]:
    """Full-mesh anti-entropy for Map<K, MVReg> (BASELINE config 4): each
    rank folds its block (``ops.map.fold``: K2 and its epilogue on a
    card), then one lattice-join all-reduce over the ranks, on
    ``mesh.device``. Returns ``(converged state, overflow [2])`` —
    [sibling slab, deferred buffer] as in ``ops.map.join``; the Telemetry
    third with ``telemetry=True``. Takes a cross-process mesh (module
    docstring)."""
    procs, mesh = _split_mesh(mesh, "mesh_fold_map")
    return _mesh_fold_replicated("map_fold", state, mesh, map_ops.join, map_ops.fold,
                                 map_ops.changed_keys, telemetry, donate, procs=procs)


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
    procs, mesh = _split_mesh(mesh, "mesh_gossip_map")
    return _gossip("map_gossip", state, mesh, rounds, donate, map_ops.fold, map_ops.join,
                   telemetry, map_ops.changed_keys, stability=stability,
                   compact_fn=map_ops.compact, lag_threshold=lag_threshold, faults=faults,
                   procs=procs)


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
    procs, mesh = _split_mesh(mesh, "mesh_fold_sparse")
    return _mesh_fold_replicated("sparse_orswot_fold", states, mesh, sp.join, sp.fold,
                                 sp.changed_dots, telemetry, donate, copies=mesh.s, procs=procs)


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
    procs, mesh = _split_mesh(mesh, "mesh_gossip_sparse")
    return _gossip("sparse_gossip", states, mesh, rounds, donate, sp.fold, sp.join, telemetry,
                   sp.changed_dots, copies=mesh.s, stability=stability, compact_fn=sp.compact,
                   lag_threshold=lag_threshold, faults=faults, procs=procs)


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
    (``slots_changed``: ``changed_cells``). Takes a cross-process mesh
    (module docstring)."""
    procs, mesh = _split_mesh(mesh, "mesh_fold_sparse_mvmap")
    return _mesh_fold_replicated(
        f"sparse_mvmap_fold_s{sibling_cap}", states, mesh,
        lambda a, b: smv.join(a, b, sibling_cap=sibling_cap),
        lambda x: smv.fold(x, sibling_cap=sibling_cap), smv.changed_cells, telemetry, donate,
        copies=mesh.s, procs=procs)


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
    procs, mesh = _split_mesh(mesh, "mesh_gossip_sparse_mvmap")
    return _gossip(f"sparse_mvmap_gossip_s{sibling_cap}", states, mesh, rounds, donate,
                   lambda x: smv.fold(x, sibling_cap=sibling_cap),
                   lambda a, b: smv.join(a, b, sibling_cap=sibling_cap), telemetry,
                   smv.changed_cells, copies=mesh.s, stability=stability,
                   compact_fn=smv.compact, lag_threshold=lag_threshold, faults=faults,
                   procs=procs)


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
    procs, mesh = _split_mesh(mesh, "mesh_fold_sparse_nested")
    return _mesh_fold_replicated(_nested_kind(level, "fold"), states, mesh, level.join,
                                 level.fold, tele.generic_slots_changed, telemetry, donate,
                                 copies=mesh.s, procs=procs)


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
    procs, mesh = _split_mesh(mesh, "mesh_gossip_sparse_nested")
    return _gossip(_nested_kind(level, "gossip"), states, mesh, rounds, donate, level.fold,
                   level.join, telemetry, tele.generic_slots_changed, copies=mesh.s,
                   stability=stability, compact_fn=sparse_nest_ops.compact,
                   lag_threshold=lag_threshold, faults=faults, procs=procs)


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
    procs, mesh = _split_mesh(mesh, "mesh_fold_map_orswot")
    return _mesh_fold_replicated("map_orswot_fold", state, mesh, mo_ops.join, mo_ops.fold,
                                 _leaf_members_changed(lambda s: s.core), telemetry, donate,
                                 procs=procs)


def mesh_gossip_map_orswot(state, mesh: VirtualMesh, rounds: Optional[int] = None,
                           telemetry: bool = False, donate: bool = False,
                           stability: bool = False, faults=None, lag_threshold=None):
    """Ring anti-entropy for ``Map<K, Orswot>`` replica blocks: each rank
    folds its block, then ``rounds`` (default P-1) unit-shift ring rounds
    of ``map_orswot.join``. Returns ``(states [P, ...], flags [2])``."""
    procs, mesh = _split_mesh(mesh, "mesh_gossip_map_orswot")
    return _gossip("map_orswot_gossip", state, mesh, rounds, donate, mo_ops.fold, mo_ops.join,
                   telemetry, _leaf_members_changed(lambda s: s.core), stability=stability,
                   compact_fn=mo_ops.compact, lag_threshold=lag_threshold, faults=faults,
                   procs=procs)


def mesh_fold_map3(state, mesh: VirtualMesh, telemetry: bool = False, donate: bool = False):
    """Full-mesh anti-entropy for ``Map<K1, Map<K2, Orswot>>``
    (``ops.map3``): each rank's fused level fold (K1 on the leaf, two
    ``settle_outer`` levels), then one lattice-join all-reduce. Returns
    ``(state, flags [3])``; the Telemetry third with ``telemetry=True``."""
    procs, mesh = _split_mesh(mesh, "mesh_fold_map3")
    return _mesh_fold_replicated("map3_fold", state, mesh, m3_ops.join, m3_ops.fold,
                                 _leaf_members_changed(lambda s: s.mo.core), telemetry, donate,
                                 procs=procs)


def mesh_gossip_map3(state, mesh: VirtualMesh, rounds: Optional[int] = None,
                     telemetry: bool = False, donate: bool = False, stability: bool = False,
                     faults=None, lag_threshold=None):
    """Ring anti-entropy for ``Map<K1, Map<K2, Orswot>>`` replica blocks.
    Returns ``(states [P, ...], flags [3])``."""
    procs, mesh = _split_mesh(mesh, "mesh_gossip_map3")
    return _gossip("map3_gossip", state, mesh, rounds, donate, m3_ops.fold, m3_ops.join,
                   telemetry, _leaf_members_changed(lambda s: s.mo.core), stability=stability,
                   compact_fn=m3_ops.compact, lag_threshold=lag_threshold, faults=faults,
                   procs=procs)


def mesh_fold_nested_map(state, mesh: VirtualMesh, telemetry: bool = False,
                         donate: bool = False):
    """Full-mesh anti-entropy for ``Map<K1, Map<K2, MVReg>>``
    (``ops.map_map``): each rank's fused level fold (``decode_cells`` → K2
    → the Map epilogue, then the outer keyset level), then one
    lattice-join all-reduce. Returns ``(state, flags [3])``; the Telemetry
    third with ``telemetry=True`` (``slots_changed``: the flat map's
    ``changed_keys``)."""
    procs, mesh = _split_mesh(mesh, "mesh_fold_nested_map")
    return _mesh_fold_replicated("nested_map_fold", state, mesh, mm_ops.join, mm_ops.fold,
                                 lambda a, b: map_ops.changed_keys(a.m, b.m), telemetry, donate,
                                 procs=procs)


def mesh_gossip_nested_map(state, mesh: VirtualMesh, rounds: Optional[int] = None,
                           telemetry: bool = False, donate: bool = False,
                           stability: bool = False, faults=None, lag_threshold=None):
    """Ring anti-entropy for ``Map<K1, Map<K2, MVReg>>`` replica blocks.
    Returns ``(states [P, ...], flags [3])``."""
    procs, mesh = _split_mesh(mesh, "mesh_gossip_nested_map")
    return _gossip("nested_map_gossip", state, mesh, rounds, donate, mm_ops.fold, mm_ops.join,
                   telemetry, lambda a, b: map_ops.changed_keys(a.m, b.m), stability=stability,
                   compact_fn=mm_ops.compact, lag_threshold=lag_threshold, faults=faults,
                   procs=procs)


# ---- the clock, set and register kinds ----------------------------------------

def mesh_fold_clocks(clocks: torch.Tensor, mesh: VirtualMesh) -> torch.Tensor:
    """Converge a batch of vector clocks ``[R, A]`` (VClock / GCounter /
    PNCounter states) over the mesh: each rank's max over its block, then
    the clock all-reduce over the ranks, on ``mesh.device``. BASELINE
    configs 1–2 at mesh scale. Returns the converged clock ``[A]``.
    Across processes the ranks' max is maxed over every process (the
    clocks ride the exchange as bytes)."""
    procs, mesh = _split_mesh(mesh, "mesh_fold_clocks")
    pad = (-clocks.shape[0]) % mesh.p
    x = bits(clocks.to(mesh.device))
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    blocks = x.view(clocks.dtype).reshape(mesh.p, -1, clocks.shape[1])
    return all_reduce_clock(umax(blocks, 1), procs)[0]


def mesh_fold_gset(present: torch.Tensor, mesh: VirtualMesh) -> torch.Tensor:
    """Converge a GSet replica batch ``present[R, M]`` over the mesh: set
    union (logical OR), each rank's ``any`` over its block, then an int32
    sum over the ranks, ``> 0`` — the simplest lattice (reference:
    src/gset.rs ``CvRDT::merge``). Both axes are padded as the JAX entry
    pads them (the member axis to the mesh's ``s`` shards). Returns the
    converged membership ``[M]``. Counts ``anti_entropy.gset_fold_rounds``,
    observes ``anti_entropy.state_bytes`` and times
    ``anti_entropy.gset_fold`` (device work included). Across processes
    the sum adds every process's ranks."""
    procs, mesh = _split_mesh(mesh, "mesh_fold_gset")
    m = present.shape[1]
    x = present.to(mesh.device)
    pad_r, pad_m = (-x.shape[0]) % mesh.p, (-m) % mesh.s
    if pad_r or pad_m:
        x = torch.nn.functional.pad(x, (0, pad_m, 0, pad_r))
    metrics.count("anti_entropy.gset_fold_rounds")
    metrics.observe("anti_entropy.state_bytes", float(x.numel() * x.element_size()))
    with metrics.time("anti_entropy.gset_fold"):
        local = torch.any(x.reshape(mesh.p, -1, x.shape[1]), dim=1)
        out = psum(local.to(torch.int32), procs) > 0
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
    procs, mesh = _split_mesh(mesh, "mesh_fold_lww")
    return _mesh_fold_replicated("lww_fold", states, mesh, lww_ops.join, lww_ops.fold,
                                 tele.generic_slots_changed, telemetry, donate, procs=procs)


def mesh_fold_mvreg(states: MVRegState, mesh: VirtualMesh, telemetry: bool = False,
                    donate: bool = False):
    """Converge an MVReg replica batch (``MVRegState`` with leading axis R)
    over the mesh's replica axis: dominated contents die, concurrent
    siblings survive (reference: src/mvreg.rs ``CvRDT::merge``). Returns
    ``(state, overflow)``; the Telemetry third with ``telemetry=True``."""
    procs, mesh = _split_mesh(mesh, "mesh_fold_mvreg")
    return _mesh_fold_replicated("mvreg_fold", states, mesh, mv_ops.join, mv_ops.fold,
                                 tele.generic_slots_changed, telemetry, donate, procs=procs)


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
    ``FaultCounters`` with the packet counts summed over the attempts.

    On a cross-process mesh ``model`` holds this process's rows: every
    attempt runs a cross-process ring, whose flags are global, so every
    process widens the same axes and re-enters as often, and
    ``max_migrations`` fails on every process together. One gather at
    entry checks that every process's model has the same kind, rows and
    capacities (``ValueError`` on every process otherwise). The rings'
    ``telemetry=``, ``stability=`` and ``lag_threshold=`` are mesh-wide
    there, and ``reclaim=``'s hysteresis decides on every process's
    occupancy at once (``elastic.Hysteresis.observe(procs=)``), so every
    process shrinks the same axes to the same capacities; ``faults=``
    counts every process's links in each attempt's counters."""
    procs, _ = _split_mesh(mesh, "gossip_elastic")
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

    if procs is not None:
        _same_models("gossip_elastic", model, procs)
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
                reclaim.observe(model, procs=procs)
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


def _same_models(entry: str, model, procs) -> None:
    """An elastic loop's check at entry across processes: one gather of
    the model's kind, rows and capacities, which must agree; a model of
    no elastic kind is refused. Every process raises alike
    (``multihost.require_same``)."""
    import zlib

    from .. import elastic

    try:
        caps = elastic.capacities(model)
        values = (zlib.crc32(elastic.kind_of(model).encode()),
                  tree_leaves(model.state)[0].shape[0], *caps.values())
        refused = None
    except (TypeError, ValueError) as exc:
        values, refused = (), exc
    multihost.require_same(f"{entry}: the models' kind, rows and capacities", values, procs,
                           refused)


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
