"""Replica-streaming fold — anti-entropy for populations that do not fit
on the card. Counterpart of the JAX package's ``parallel/stream.py``: its
sparse (segment-encoded ORSWOT), dense ORSWOT, sparse ``Map<K, MVReg>``
and element-sharded sparse plans.

    acc = identity (or init)
    for block in blocks:              # [B, ...] replica blocks
        acc = join(acc, mesh_fold(block))

One step on the mesh's P virtual ranks: each rank folds its rows of the
block (``anti_entropy.local_folds``: the sparse join as one batched log
tree for all ranks; ``fold_auto`` per rank for dense blocks — kernel K1
and its epilogue on a card), one lattice all-reduce joins the ranks
(``collectives.all_reduce_lattice``), and the result joins into the
accumulator. Rank q folds block rows ``[q·B/P, (q+1)·B/P)``, the rows a
``P(REPLICA_AXIS)`` sharding gives device q in the JAX package, and the
folds pair the same rows, so the bits are the JAX stream's. The JAX
package keeps the accumulator on every device (``shard_map``'s layout);
the port keeps ONE, rank 0's, which is what the JAX package reads back.
The sparse ``Map<K, MVReg>`` plan folds like the sparse ORSWOT's (its
sibling lane is a join argument, not a state axis: a sibling overflow is
re-entered with a larger ``sibling_cap``, never widened mid-stream). The
element-sharded plan takes ``[B, S, ...]`` blocks (``sparse_shard.
split_segments``, S == ``mesh.s``) into an ``[S, ...]`` accumulator:
shard-local joins are exact, so each shard streams on its own batch lane
and the flags OR over the shards.
A sparse step waits for nothing on the host (overflow flags stay device
tensors until the caller reads them); the dense join's parked-slot dedupe
(``ops.orswot._dedupe_deferred``) does.

- ``pipeline=True`` (default): a block that arrives as a CPU tensor is
  staged onto the card on a side CUDA stream from pinned memory
  (``non_blocking``); the step's stream waits on an event the copy
  records, and ``record_stream`` keeps the block alive until the step
  has read it. Block k+1 is fetched and staged right after block k's
  step is enqueued, so the copy overlaps the step. ``stream.overlap_hit``
  counts stagings issued while the previous step was still in flight. A
  block already on the card is not copied. ``pipeline=False`` copies on
  the step's stream and synchronises after every step (the counter stays
  0).
- ``donate=True`` (default): the running accumulator is ONE set of
  buffers for the whole stream, as the JAX step's ``input_output_alias``
  keeps it: each step's new accumulator is written into the old one's
  storage (where the shapes hold; a widened step starts a new buffer).
  The caller's ``init`` is copied into that buffer once and never
  consumed. With ``donate=False`` the ``init`` tensors are the first
  accumulator and each step's result is a new one (no op writes in
  place).
- Residency: the accumulator, the block in its step and the next staged
  block — independent of the population.
- A block that fails to fetch or stage raises :class:`StreamInterrupted`
  carrying the accumulator (the exact join of the blocks before it) and
  the resume index; ``init=exc.acc`` with the remaining blocks completes
  the fold bit-identically.
- ``wal=`` (a ``durability.Wal``) makes that contract DURABLE: every
  ``StreamInterrupted`` first persists a fsynced resume record (the
  accumulator plus the resume index), ``wal_every=k`` persists one every k
  blocks as well, and the finished pass persists its last one, so a hard
  kill (no exception path at all: a preemption) still resumes from the
  last persisted block through ``durability.recover.load_stream_resume``.
  Records carry the ABSOLUTE block index ``wal_base + blocks_done``: a
  resumed run passes the index it resumed from as ``wal_base=``. Each
  persist copies the accumulator to the host (a sync: size ``wal_every``
  like a checkpoint cadence).

Block contract: the first block fixes the template (caps and rows, rows
rounded up to a multiple of P). A later block may be SMALLER
(identity-padded: the ragged tail) or carry NARROWER caps (widened on
arrival), both counted in ``stream.repacked_blocks``; a larger one
refuses (re-chunk the source).

- ``telemetry=True`` returns the JAX stream's Telemetry third: its steps'
  Telemetry folded over the blocks (``telemetry.combine``), then
  ``stream_blocks``, ``stream_staged_bytes``, ``stream_overlap_hit`` and,
  with ``wal=``, the ``wal_*`` fields filled on the host, the whole
  recorded under the plan's kind. Every block has the template's shape,
  so a step's counts are static but one: the kind's changed slots
  between the accumulator before and after it, summed on the device
  (the only work a step adds). ``merges`` is the JAX count of each rank's
  ``B/P - 1`` fold joins, the all-reduce's exchanges and the accumulator
  join; the wire is one rank's folded state per exchange, summed in
  float32 step by step as ``combine`` sums it; the gauges are the last
  step's.

- ``compact_every=N`` compacts the accumulator after every N-th block
  against ``frontier`` (the all-zeros frontier when None: a scrub and
  repack that retires nothing), through the plan's kind ``compact``; the
  freed counts add up on the device (no host sync inside a step) and feed
  ``reclaim.reclaimed_*.stream.<kind>`` and, with ``telemetry=True``, the
  Telemetry's ``reclaimed_slots`` / ``reclaimed_bytes`` once at the end.

- ``widen_policy=`` (an ``elastic.ElasticPolicy``) — elastic retry, one
  block at a time: after each step the overflow flags are read (a host
  sync), the implicated axes of the accumulator and the block widen by
  ``policy.factor`` and the step re-enters, counting
  ``stream.widen_retries``; later blocks widen on arrival. A plan with no
  recoverable lane (the sharded one) refuses the policy.
- ``faults=`` (a ``faults.FaultPlan``) — every block crosses the upload
  wire (``faults.block_wire``: one drop/corrupt draw keyed on the block's
  index in this call, the checksum verify over what arrived); a lost
  block's join is deselected and its flags do not count. One host read
  per block records its fate. The entry returns a
  :class:`StreamFaultReport` last (the Telemetry's ``faults_dropped`` /
  ``faults_rejected`` carry it too, and ``faults.packets_*`` count it);
  an interrupt carries the partial report. Healing is a re-stream of the
  lost blocks with ``init=`` the faulted accumulator.

Across processes (``mesh`` a ``multihost.GlobalMesh``) each process
streams its own rows of each block: global block k is the process-order
concatenation of every process's block k, global rank ``process ·
P_local + local rank`` — the layout of ``multihost.host_to_global`` and
every cross-process entry, and what a stream is for: each host reads
only its own replicas. (The JAX stream instead stages each whole block
onto the global block sharding with ``jax.device_put``.) Each process
pads its own first block to a multiple of its local ranks; the
template's caps and padded rows are the maxima over the processes,
agreed in one gather at entry, where ``init=`` shapes, ``compact_every=``
and ``widen_policy=`` that differ across processes raise ``ValueError``
on every process. Before every step one small gather
(``multihost.agree``) shares each process's status — staged, source
ended, failed or refused: a process whose source has ended steps an
identity block while another still has blocks; the stream ends when
every source has; a refusal (a ``ValueError`` of the source or of the
staging checks) raises ``ValueError`` on every process; a failure raises
:class:`StreamInterrupted` on every process with the same
``blocks_done`` and the same (replicated) accumulator, so ``init=exc.acc``
plus each process's remaining blocks resumes it. The step's all-reduce
gains the process step with the local flags riding it, so the flags are
global and ``widen_policy=`` widens the same axes on every process.
``frontier=`` must be stable over the whole population (the caller's
promise, as in the JAX package). The process step synchronises the card
before its exchange, so less of a step overlaps the next block's upload:
``stream.overlap_hit`` counts what each process saw. ``telemetry=True``
counts the global mesh (its ranks, every process's share of a global
block): every field but ``stream_staged_bytes`` reads the replicated
accumulator and host counts every process shares, so only that one
rides a gather, once at the end; the partial Telemetry of a
``StreamInterrupted`` needs none and is the same on every process;
``stream_overlap_hit`` stays each process's own. ``faults=`` draws
each block's fate keyed on ``(seed, block index)``, and every process
steps its share of the same global block in lockstep, so every process
draws the same fate, and a corruption (each process perturbs the first
lane of its own share) fails every process's verify: every process
deselects the same blocks and returns the same
:class:`StreamFaultReport` with no exchange (the JAX stream takes the
``pmax`` of the code over the mesh, which is then the code itself); the
re-stream of ``lost_blocks`` with ``init=acc`` runs across processes
like any other. ``wal=`` raises ``NotImplementedError`` there: the JAX
package's log cannot copy a global array to the host either.

The stream feeds the ``stream.<kind>.deferred_depth`` gauge (of the first
block) and the ``stream.<kind>`` timer around the block loop, and counts
``stream.unaliasable_blocks`` for a repacked block of a donating stream,
as the JAX stream does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from .. import elastic
from .. import telemetry as tele
from .._dtypes import bits, from_raw, raw, to_wide
from ..faults import inject as flt
from ..ops import orswot as ops
from ..ops import sparse_mvmap as smv
from ..ops import sparse_orswot as sp
from ..ops.fold_kernels import fold_auto
from ..ops.lattice import tree_map
from ..utils.metrics import metrics, observe_depth
from . import multihost
from .anti_entropy import _exchange_count, _split_mesh, _write_back, local_folds
from .collectives import all_reduce_lattice
from .mesh import VirtualMesh

# A process's block status, agreed before every step (``multihost.agree``).
_STAGED, _ENDED, _FAILED, _REFUSED = 0, 1, 2, 3


@dataclass
class StreamFaultReport:
    """One faulted stream run's accounting (``faults=``): the block
    indices (in this call's delivery order) lost to an injected upload
    drop, and those that arrived corrupted and were REJECTED by the
    checksum verify (corrupted content is never joined). The accumulator
    is the exact join of the blocks not lost, so healing is a re-stream of
    ``lost_blocks`` with ``init=acc`` and the faults off."""

    dropped_blocks: list
    rejected_blocks: list

    @property
    def lost_blocks(self) -> list:
        return sorted(set(self.dropped_blocks) | set(self.rejected_blocks))


class StreamInterrupted(RuntimeError):
    """A block failed to fetch or stage mid-stream. ``acc`` is the
    accumulator — the exact lattice join of the blocks already applied
    and not lost, a valid joinable state — and the stream resumes from
    block ``blocks_done`` via ``init=exc.acc`` on a fresh call.
    ``telemetry`` carries the partial Telemetry when the run asked for
    one; ``fault_report`` is the partial :class:`StreamFaultReport` of a
    faulted run: the blocks lost before the interrupt, which the resume
    must re-stream too."""

    def __init__(self, cause: BaseException, acc, blocks_done: int, telemetry=None,
                 fault_report=None):
        super().__init__(
            f"replica stream interrupted at block {blocks_done} "
            f"({type(cause).__name__}: {cause}); .acc holds the join of "
            f"blocks [0, {blocks_done}) — resume with init=exc.acc"
        )
        self.cause = cause
        self.acc = acc
        self.blocks_done = blocks_done
        self.telemetry = telemetry
        self.fault_report = fault_report


@dataclass(frozen=True)
class _StreamPlan:
    """The per-kind closure set the generic block loop composes."""

    kind: str                # metrics name
    join_fn: Callable        # (a, b) -> (state, flags)
    fold_fn: Callable        # [rows, ...] -> (state, flags)
    local_fold: Callable     # [P, rows, ...] -> ([P, ...], flags [P, ...])
    caps_of: Callable        # state -> {axis: cap}
    empty: Callable          # (caps, batch, device) -> identity batch
    widen_state: Callable    # (state, {axis: cap}) -> state
    slots_fn: Callable       # (a, b) -> u32 changed lanes (the telemetry's)
    axes: Tuple[str, ...]    # the keys of caps_of, in its order
    # overflow lane -> the elastic axis that widening recovers ("" = the
    # lane is not a state axis); read by widen_policy=.
    flag_axes: Tuple[str, ...] = ()
    sharded: bool = False    # blocks [B, S, ...], accumulator [S, ...]
    compact_fn: Callable = None  # (state, frontier) -> (state, freed_slots, freed_bytes)


def _plan_sparse() -> _StreamPlan:
    return _StreamPlan(
        kind="sparse_stream_fold",
        join_fn=sp.join,
        fold_fn=sp.fold,
        local_fold=lambda blocks: local_folds(blocks, sp.fold),
        caps_of=lambda s: {
            "dot_cap": s.eid.shape[-1], "n_actors": s.top.shape[-1],
            "deferred_cap": s.didx.shape[-2], "rm_width": s.didx.shape[-1],
        },
        empty=lambda caps, batch, device: sp.empty(
            caps["dot_cap"], caps["n_actors"], caps["deferred_cap"], caps["rm_width"],
            batch=batch, device=device,
        ),
        widen_state=lambda s, caps: sp.widen(s, **caps),
        slots_fn=sp.changed_dots,
        axes=("dot_cap", "n_actors", "deferred_cap", "rm_width"),
        flag_axes=("dot_cap", "deferred_cap"),
        compact_fn=sp.compact,
    )


def _plan_sparse_mvmap(sibling_cap: int) -> _StreamPlan:
    return _StreamPlan(
        kind=f"sparse_mvmap_stream_fold_s{sibling_cap}",
        join_fn=lambda a, b: smv.join(a, b, sibling_cap=sibling_cap),
        fold_fn=lambda x: smv.fold(x, sibling_cap=sibling_cap),
        local_fold=lambda blocks: local_folds(blocks, lambda x: smv.fold(x, sibling_cap)),
        caps_of=lambda s: {
            "cell_cap": s.kid.shape[-1], "n_actors": s.top.shape[-1],
            "deferred_cap": s.kidx.shape[-2], "rm_width": s.kidx.shape[-1],
        },
        empty=lambda caps, batch, device: smv.empty(
            caps["cell_cap"], caps["n_actors"], caps["deferred_cap"], caps["rm_width"],
            batch=batch, device=device,
        ),
        widen_state=lambda s, caps: smv.widen(s, **caps),
        slots_fn=smv.changed_cells,
        axes=("cell_cap", "n_actors", "deferred_cap", "rm_width"),
        # The sibling lane is a join argument, not a state axis.
        flag_axes=("cell_cap", "deferred_cap", ""),
        compact_fn=smv.compact,
    )


def _plan_sparse_sharded() -> _StreamPlan:
    # Widening a sharded stream would have to repack every shard
    # consistently: the shard caps are sized up front (no flag axes).
    return replace(_plan_sparse(), kind="sparse_sharded_stream_fold", flag_axes=(),
                   sharded=True)


def _plan_dense() -> _StreamPlan:
    return _StreamPlan(
        kind="orswot_stream_fold",
        join_fn=ops.join,
        fold_fn=ops.fold,
        local_fold=lambda blocks: local_folds(blocks, fold_auto),
        caps_of=lambda s: {
            "n_elems": s.ctr.shape[-2], "n_actors": s.top.shape[-1],
            "deferred_cap": s.dvalid.shape[-1],
        },
        empty=lambda caps, batch, device: ops.empty(
            caps["n_elems"], caps["n_actors"], caps["deferred_cap"], batch=batch, device=device,
        ),
        widen_state=lambda s, caps: ops.widen(s, **caps),
        slots_fn=ops.changed_members,
        axes=("n_elems", "n_actors", "deferred_cap"),
        flag_axes=("deferred_cap",),
        compact_fn=ops.compact,
    )


def _leaves(tree):
    return list(tree) if isinstance(tree, tuple) else [tree]


def _rows_of(tree) -> int:
    return _leaves(tree)[0].shape[0]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def _widen_to(plan: _StreamPlan, state, caps: Dict[str, int]):
    """Widen ``state`` up to ``caps`` where narrower (the same object when
    nothing grows)."""
    have = plan.caps_of(state)
    grow = {k: v for k, v in caps.items() if have[k] < v}
    return plan.widen_state(state, grow) if grow else state


def _step(plan: _StreamPlan, acc, block, p: int, procs=None):
    """One block on P virtual ranks: rank-local folds, the lattice
    all-reduce (over the processes of ``procs`` too, the local flags
    riding its process step), the join into the accumulator. ``block``
    has a multiple of P rows on the accumulator's device. Returns ``(acc,
    overflow)``; a sharded plan's flags are ORed over the shards too."""
    ranks = tree_map(lambda x: x.reshape(p, -1, *x.shape[1:]), block)
    folded, of_local = plan.local_fold(ranks)
    joined, of = all_reduce_lattice(folded, plan.join_fn, plan.fold_fn, procs,
                                    flags=torch.any(of_local, dim=0))
    acc, of_join = plan.join_fn(acc, tree_map(lambda x: x[0], joined))
    of = of | of_join
    return acc, torch.any(of, dim=0) if plan.sharded else of


def _step_wire(acc, p: int, shards: int = 0) -> np.float32:
    """One step's wire bytes in the JAX stream's Telemetry: each device's
    folded state (the accumulator's shape, one shard of it when sharded)
    per exchange, summed over the devices in float32."""
    per_rank = np.float32(tele.shipped_bytes(acc, batch_dims=1 if shards else 0)
                          * _exchange_count(p))
    step = np.float32(0)
    for _ in range(p * max(shards, 1)):
        step = np.float32(step + per_rank)
    return step


def _stream_tel(acc, slots, steps: int, rows: int, p: int, wire: np.float32) -> tele.Telemetry:
    """The JAX stream's per-step Telemetry folded over ``steps`` steps of
    ``rows``-row blocks (``slots``: the changed slots summed over them;
    ``acc``: the accumulator after the last; ``wire``: the steps'
    :func:`_step_wire` summed step after step, as ``combine`` sums them)."""
    if steps == 0:
        return tele.zeros(acc[0].device)
    n_ex = _exchange_count(p)
    # Each step: every rank's fold joins, its exchanges, the accumulator join.
    merges = steps * p * (max(rows // p - 1, 0) + n_ex + 1)
    return tele.fill(tele.zeros(acc[0].device), merges=merges,
                     slots_changed=tele.scalar("slots_changed", slots, acc[0].device),
                     deferred_depth=tele.device_depth(acc), bytes_exchanged=float(wire),
                     bytes_useful=float(wire), widen_pressure=tele.device_pressure(acc))


def _upload(raw, device: torch.device, side):
    """``raw`` on ``device``. With a ``side`` stream (pipelined, on a card)
    a CPU block is copied from pinned memory on that stream and comes back
    with the copy's event; otherwise the block is moved on the current
    stream (a no-op for a block already there) and comes back with None."""
    if side is None or _leaves(raw)[0].device.type != "cpu":
        return tree_map(lambda x: x.to(device), raw), None
    with torch.cuda.stream(side):
        block = tree_map(
            lambda x: (x if x.is_pinned() else x.pin_memory()).to(device, non_blocking=True),
            raw,
        )
        copied = torch.cuda.Event()
        copied.record(side)
    return block, copied


def _stream_fold(
    plan: _StreamPlan,
    blocks: Iterable,
    mesh: VirtualMesh,
    *,
    entry: str,
    init=None,
    telemetry: bool = False,
    donate: bool = True,
    pipeline: bool = True,
    widen_policy=None,
    frontier=None,
    compact_every: int = 0,
    faults=None,
    wal=None,
    wal_every: int = 0,
    wal_base: int = 0,
):
    """The shared scaffold: template derivation, upload and repack of each
    block, the double-buffered step loop and the interrupt protocol, on
    one process or across the processes of a cross-process mesh (see the
    module docstring)."""
    procs, mesh = _split_mesh(mesh, entry, wal=wal)
    me = 0 if procs is None else procs.process_index
    device, p = mesh.device, mesh.p
    # The Telemetry counts the global mesh: its ranks and a global block's
    # rows (every process's share of it).
    n_procs = 1 if procs is None else procs.process_count
    p_all = p * n_procs
    faulted = faults is not None
    dropped_blocks: list = []
    rejected_blocks: list = []

    def partial_report():
        """The lost-so-far snapshot an interrupt carries (copies: the
        exception's view must not change afterwards)."""
        return StreamFaultReport(list(dropped_blocks), list(rejected_blocks)) if faulted else None

    on_card = device.type == "cuda"
    it = iter(blocks)

    def persist_resume(acc_now, done: int) -> None:
        """One fsynced resume record at the absolute index ``wal_base +
        done`` (module docstring)."""
        if wal is None or acc_now is None:
            return
        wal.append_resume(plan.kind, acc_now, wal_base + done)
        wal.sync()

    def fetch():
        """The source's next block as ``(status, block, error)``: a
        ``ValueError`` (a caller bug) refuses it, any other exception
        fails it, and the end of the source is ``_ENDED``."""
        try:
            raw_block = next(it, None)
        except ValueError as exc:
            return _REFUSED, None, exc
        except Exception as exc:
            return _FAILED, None, exc
        return (_ENDED, None, None) if raw_block is None else (_STAGED, raw_block, None)

    def halt(codes, error, acc_now, done: int, part=lambda: None) -> None:
        """Act on every process's agreed status ``codes`` before block
        ``done``: a refusal raises ``ValueError`` on every process (this
        process's own where it refused), a failure ``StreamInterrupted``
        carrying ``acc_now`` (and the partial Telemetry ``part()``)."""
        if _REFUSED in codes:
            if codes[me] == _REFUSED:
                raise error
            raise ValueError(f"process {codes.index(_REFUSED)} refused its stream block {done}")
        if _FAILED in codes:
            cause = error if codes[me] == _FAILED else RuntimeError(
                f"process {codes.index(_FAILED)} failed to fetch or stage its stream block {done}")
            metrics.count("stream.interrupted")
            persist_resume(acc_now, done)
            raise StreamInterrupted(cause, acc_now, done, part(),
                                    fault_report=partial_report()) from cause

    status, first, error = fetch()

    # ---- template: caps and padded row count from the first blocks -----
    # One agreement of every process's first block (its status, padded
    # rows, caps and shard count) and init= shape: the caps and rows are
    # the maxima over the processes; init= and the options must agree.
    first_caps = plan.caps_of(first) if first is not None else {}
    rows = _rows_of(first) if first is not None else 0
    shards = 0
    if plan.sharded and first is not None:
        shards = _leaves(first)[0].shape[1]
    elif plan.sharded and init is not None:
        shards = _rows_of(init)
    table = multihost.agree(
        (status, rows + (-rows) % p if first is not None else p,
         *(first_caps.get(a, 0) for a in plan.axes), shards, init is not None,
         multihost.shape_digest(init, skip=0) if procs is not None and init is not None else 0,
         compact_every, widen_policy is not None), procs)
    halt([t[0] for t in table], error, init, 0)
    if len({t[-4:] for t in table}) != 1:
        raise ValueError(
            f"{entry}: init= shapes, compact_every= or widen_policy= differ across processes: "
            f"{[t[-4:] for t in table]}")
    if all(t[0] == _ENDED for t in table) and init is None:
        raise ValueError("empty block stream and no init accumulator")
    staged_firsts = [t for t in table if t[0] == _STAGED]
    caps = {a: max((t[2 + i] for t in staged_firsts), default=0)
            for i, a in enumerate(plan.axes)}
    template_rows = max(t[1] for t in table)
    if init is not None:
        caps = {k: max(v, plan.caps_of(init)[k]) for k, v in caps.items()}
    shard_batch = ()
    if plan.sharded:
        for got in (t[2 + len(plan.axes)] for t in table):
            if got and got != mesh.s:
                raise ValueError(f"stream blocks carry {got} element shards, mesh axis is "
                                 f"{mesh.s}")
        shard_batch = (mesh.s,)

    side = torch.cuda.Stream(device) if on_card and pipeline else None

    def stage(raw_block):
        """Check ``raw_block`` against the template and start its upload."""
        raw_caps = plan.caps_of(raw_block)
        if any(raw_caps[k] > v for k, v in caps.items()):
            raise ValueError(
                f"block caps {raw_caps} exceed the stream template {caps} — widen the "
                f"template (stream from the widest block first) or re-chunk"
            )
        if _rows_of(raw_block) > template_rows:
            raise ValueError(
                f"block has {_rows_of(raw_block)} rows > stream template {template_rows} "
                f"— re-chunk the source"
            )
        return _upload(raw_block, device, side)

    def put(fetched):
        """Start the upload of a fetched block: ``(status, staged,
        error)``, a staging ``ValueError`` refusing it and any other
        exception failing it."""
        status, raw_block, error = fetched
        if status != _STAGED:
            return status, None, error
        try:
            return _STAGED, stage(raw_block), None
        except ValueError as exc:
            return _REFUSED, None, exc
        except Exception as exc:
            return _FAILED, None, exc

    def arrive(staged):
        """The staged block, ready for its step: the step's stream waits
        for the copy, the block is marked in use there, and a narrow or
        short block is widened and identity-padded to the template."""
        block, copied = staged
        if copied is not None:
            main = torch.cuda.current_stream(device)
            main.wait_event(copied)
            for x in _leaves(block):
                x.record_stream(main)
        widened = _widen_to(plan, block, caps)
        rows = _rows_of(widened)
        if rows < template_rows:
            pad = plan.empty(caps, (template_rows - rows, *shard_batch), device)
            widened = tree_map(
                lambda x, e: torch.cat([bits(x), bits(e).to(bits(x).dtype)]).view(x.dtype),
                widened, pad,
            )
        if widened is not block:
            metrics.count("stream.repacked_blocks")
            if donate:
                metrics.count("stream.unaliasable_blocks")
        return widened

    # ---- accumulator -------------------------------------------------
    if init is not None:
        acc = tree_map(lambda x: x.to(device), _widen_to(plan, init, caps))
        if donate:
            acc = tree_map(torch.clone, acc)  # never consume the caller's buffers
    else:
        acc = plan.empty(caps, shard_batch, device)

    reclaimed = None
    if compact_every:
        if plan.compact_fn is None:
            raise ValueError(f"{plan.kind}: no compaction kernel")
        top = acc.top[0] if plan.sharded else acc.top
        frontier_t = torch.zeros_like(top) if frontier is None else frontier
        reclaimed = (torch.zeros((), dtype=torch.int64, device=device),
                     torch.zeros((), dtype=torch.float32, device=device))

    if widen_policy is not None and not plan.flag_axes:
        raise ValueError(
            f"{plan.kind}: mid-stream widening is not supported for this kind (size "
            f"capacities up front)")

    def step(acc, block, bix: int):
        """One step; a faulted run first sends the block over the upload
        wire (``faults.block_wire``: the draw keyed on the block index,
        the checksum verify over what arrived) and deselects the join of
        a lost block, whose flags then do not count. Returns the
        accumulator, the flags and the fate code (None unfaulted)."""
        code = None
        if faulted:
            block, code = flt.block_wire(faults, bix, block)
        new, of = _step(plan, acc, block, p, procs)
        if faulted:
            landed = code == 0
            new = flt.tree_select(landed, new, acc)
            of = of & landed
        return new, of, code

    metrics.count(f"stream.{plan.kind}_rounds")
    status, staged, error = put((status, first, error))

    overflow = None
    blocks_done = staged_bytes = stepped_bytes = overlap_hits = 0
    slots = 0
    wire = np.float32(0)
    if wal is not None:
        wal_b0, wal_f0 = wal.bytes_appended, wal.fsyncs
    observe_depth(f"stream.{plan.kind}", first if first is not None else acc)
    t_loop = time.perf_counter()
    while True:
        # Every process's status of this block (one small gather across
        # processes): a refusal or a failure anywhere stops every process
        # at the same block; a process whose source has ended steps an
        # identity block while another still has blocks.
        codes = [t[0] for t in multihost.agree((status,), procs)]
        halt(codes, error, acc, blocks_done,
             lambda: (_stream_tel(acc, slots, blocks_done, template_rows * n_procs, p_all, wire)
                      if telemetry else None))
        if all(c == _ENDED for c in codes):
            break
        if status == _STAGED:
            block = arrive(staged)
            staged_bytes += _nbytes(block)
        else:
            block = plan.empty(caps, (template_rows, *shard_batch), device)
        # This process's share of the global block, identity rows included.
        stepped_bytes += _nbytes(block)
        new, of, code = step(acc, block, blocks_done)
        attempts = 0
        while widen_policy is not None:
            # Elastic retry, one block at a time (gossip_elastic's
            # overflow → widen → resume loop): read the flags (a host
            # sync), widen the implicated axes of the accumulator and the
            # block, re-enter. The step consumed nothing, so the old
            # accumulator is the snapshot; the join is idempotent.
            flags = torch.atleast_1d(of).tolist()
            if not any(flags):
                break
            hot = tuple(axis for lane, axis in enumerate(plan.flag_axes)
                        if lane < len(flags) and flags[lane] and axis)
            if not hot:
                raise RuntimeError(
                    f"{plan.kind}: overflow lane not recoverable by widening (flags={flags})")
            if attempts >= widen_policy.max_migrations:
                raise RuntimeError(
                    f"stream still overflowing after {attempts} migrations (caps: {caps}) — "
                    f"raise policy.factor or max_migrations")
            caps.update({ax: elastic._grown(caps[ax], widen_policy.factor) for ax in hot})
            metrics.count("stream.widen_retries")
            acc, block = _widen_to(plan, acc, caps), _widen_to(plan, block, caps)
            new, of, code = step(acc, block, blocks_done)
            attempts += 1
        if faulted:
            # One host read per block — the faults mode's price; the fate
            # feeds the report the caller re-streams from.
            fate = int(code)
            if fate == 1:
                dropped_blocks.append(blocks_done)
            elif fate == 2:
                rejected_blocks.append(blocks_done)
        if telemetry:
            slots = slots + to_wide(plan.slots_fn(acc, new))
            wire = np.float32(wire + _step_wire(new, p_all,
                                                shards=mesh.s if plan.sharded else 0))
        # Donated: the new accumulator takes the old one's buffers.
        acc = _write_back(acc, new) if donate else new
        overflow = of if overflow is None else overflow | of
        blocks_done += 1
        del block, staged
        if compact_every and blocks_done % compact_every == 0:
            acc, freed, freed_b = plan.compact_fn(acc, frontier_t)
            reclaimed = (reclaimed[0] + raw(freed), reclaimed[1] + freed_b)
        if wal_every and blocks_done % wal_every == 0:
            persist_resume(acc, blocks_done)
        if not pipeline:
            if on_card:
                torch.cuda.synchronize(device)
        elif on_card:
            enqueued = torch.cuda.Event()
            enqueued.record()
            if not enqueued.query():
                # The next staging is issued while this step is still in
                # flight: its upload overlaps the step's kernels.
                overlap_hits += 1
        status, staged, error = put(fetch())
    persist_resume(acc, blocks_done)
    if on_card:
        torch.cuda.synchronize(device)
    metrics.observe(f"stream.{plan.kind}_seconds", time.perf_counter() - t_loop)

    if overflow is None:
        overflow = torch.zeros((), dtype=torch.bool, device=device)
    metrics.count("stream.blocks", blocks_done)
    metrics.count("stream.staged_bytes", staged_bytes)
    metrics.count("stream.overlap_hit", overlap_hits)
    metrics.observe("stream.acc_bytes", _nbytes(acc))
    if compact_every:
        from ..reclaim import record_reclaim

        reclaimed = (from_raw(reclaimed[0], torch.uint32), reclaimed[1])
        record_reclaim(f"stream.{plan.kind}", int(reclaimed[0]), float(reclaimed[1]))
    report = partial_report()
    if faulted:
        if dropped_blocks:
            metrics.count("faults.packets_dropped", len(dropped_blocks))
        if rejected_blocks:
            metrics.count("faults.packets_rejected", len(rejected_blocks))
        if dropped_blocks or rejected_blocks:
            # A non-empty fault report is a postmortem boundary: the
            # caller must re-stream these blocks — record which, and
            # write the flight artifact (no-ops with no recorder).
            from .. import obs

            obs.emit("stream_fault_report", dropped=list(dropped_blocks),
                     rejected=list(rejected_blocks))
            obs.auto_dump("stream_fault_report", dropped=len(dropped_blocks),
                          rejected=len(rejected_blocks))
    if not telemetry:
        return (acc, overflow, report) if faulted else (acc, overflow)
    if n_procs > 1:
        # The global blocks' bytes: every process's share, in one gather.
        stepped_bytes = sum(t[0] for t in multihost.agree((stepped_bytes,), procs))
    tel = tele.fill(_stream_tel(acc, slots, blocks_done, template_rows * n_procs, p_all, wire),
                    stream_blocks=blocks_done, stream_staged_bytes=stepped_bytes,
                    stream_overlap_hit=overlap_hits)
    if compact_every:
        tel = tel._replace(reclaimed_slots=reclaimed[0], reclaimed_bytes=reclaimed[1])
    if wal is not None:
        tel = tele.fill(tel, wal_bytes=wal.bytes_appended - wal_b0,
                        wal_fsyncs=wal.fsyncs - wal_f0)
    if faulted:
        tel = tele.fill(tel, faults_dropped=len(dropped_blocks),
                        faults_rejected=len(rejected_blocks))
    tele.record(plan.kind, tel)
    return (acc, overflow, tel, report) if faulted else (acc, overflow, tel)


# ---- public entry points --------------------------------------------------

def mesh_stream_fold_sparse(
    blocks: Iterable, mesh: VirtualMesh, *, init=None, telemetry: bool = False,
    donate: bool = True, pipeline: bool = True, widen_policy=None, frontier=None,
    compact_every: int = 0, faults=None, wal=None, wal_every: int = 0, wal_base: int = 0,
) -> Tuple[Any, torch.Tensor]:
    """Stream-fold SPARSE (segment-encoded) ORSWOT replica blocks
    ``[B, ...]`` into one converged state on ``mesh.device`` — the
    arbitrary-N fold the flagship shape (10,240 replicas × a 1M-element
    universe) runs through. Returns ``(state, overflow [2])``: [dot
    capacity, deferred capacity]; the Telemetry third with
    ``telemetry=True``."""
    return _stream_fold(
        _plan_sparse(), blocks, mesh, entry="mesh_stream_fold_sparse", init=init,
        telemetry=telemetry, donate=donate, pipeline=pipeline, widen_policy=widen_policy,
        frontier=frontier, compact_every=compact_every, faults=faults, wal=wal,
        wal_every=wal_every, wal_base=wal_base,
    )


def mesh_stream_fold(
    blocks: Iterable, mesh: VirtualMesh, *, init=None, telemetry: bool = False,
    donate: bool = True, pipeline: bool = True, widen_policy=None, frontier=None,
    compact_every: int = 0, faults=None, wal=None, wal_every: int = 0, wal_base: int = 0,
) -> Tuple[Any, torch.Tensor]:
    """Stream-fold DENSE ORSWOT replica blocks ``[B, E, A]`` on
    ``mesh.device``; each rank's local fold is ``fold_auto`` (kernel K1
    and its epilogue on a card). Returns ``(state, overflow)``; the
    Telemetry third with ``telemetry=True``."""
    return _stream_fold(
        _plan_dense(), blocks, mesh, entry="mesh_stream_fold", init=init, telemetry=telemetry,
        donate=donate, pipeline=pipeline, widen_policy=widen_policy, frontier=frontier,
        compact_every=compact_every, faults=faults, wal=wal, wal_every=wal_every,
        wal_base=wal_base,
    )


def mesh_stream_fold_sparse_mvmap(
    blocks: Iterable, mesh: VirtualMesh, *, sibling_cap: int = 4, init=None,
    telemetry: bool = False, donate: bool = True, pipeline: bool = True, widen_policy=None,
    frontier=None, compact_every: int = 0, faults=None, wal=None, wal_every: int = 0,
    wal_base: int = 0,
) -> Tuple[Any, torch.Tensor]:
    """Stream-fold SPARSE ``Map<K, MVReg>`` replica blocks ``[B, ...]``
    (``ops.sparse_mvmap``) into one converged state on ``mesh.device``.
    Returns ``(state, flags [3])``: [cell capacity, deferred capacity,
    sibling capacity]; the Telemetry third with ``telemetry=True``. A
    sibling overflow is not recoverable mid-stream (``sibling_cap`` is a
    join argument): re-enter with a larger one."""
    return _stream_fold(
        _plan_sparse_mvmap(sibling_cap), blocks, mesh, entry="mesh_stream_fold_sparse_mvmap",
        init=init, telemetry=telemetry, donate=donate, pipeline=pipeline, widen_policy=widen_policy, frontier=frontier,
        compact_every=compact_every, faults=faults, wal=wal, wal_every=wal_every,
        wal_base=wal_base,
    )


def mesh_stream_fold_sparse_sharded(
    blocks: Iterable, mesh: VirtualMesh, *, init=None, telemetry: bool = False,
    donate: bool = True, pipeline: bool = True, frontier=None, compact_every: int = 0,
    faults=None, wal=None, wal_every: int = 0, wal_base: int = 0,
) -> Tuple[Any, torch.Tensor]:
    """Stream-fold element-SHARDED sparse ORSWOT blocks ``[B, S, ...]``
    (``sparse_shard.split_segments``; S must equal ``mesh.s``) into an
    ``[S, ...]`` accumulator on ``mesh.device``: shard-local joins are
    exact, so streaming composes with element sharding at no extra
    collective. Size the shard caps up front (no mid-stream widening).
    Returns ``(state [S, ...], flags [2])``; the Telemetry third with
    ``telemetry=True`` (the changed slots summed over the shards)."""
    return _stream_fold(
        _plan_sparse_sharded(), blocks, mesh, entry="mesh_stream_fold_sparse_sharded",
        init=init, telemetry=telemetry, donate=donate, pipeline=pipeline, frontier=frontier, compact_every=compact_every, faults=faults,
        wal=wal, wal_every=wal_every, wal_base=wal_base,
    )


def iter_blocks(states, block_rows: int):
    """Slice a co-resident ``[N, ...]`` batch into ``[block_rows, ...]``
    stream blocks (views) — the bridge for populations that do fit (tests,
    subsampled gates) and the reference shape for real sources."""
    n = _rows_of(states)
    for lo in range(0, n, block_rows):
        yield tree_map(lambda x: x[lo: lo + block_rows], states)


__all__ = ["StreamFaultReport", "StreamInterrupted", "iter_blocks", "mesh_stream_fold",
           "mesh_stream_fold_sparse", "mesh_stream_fold_sparse_mvmap",
           "mesh_stream_fold_sparse_sharded"]
