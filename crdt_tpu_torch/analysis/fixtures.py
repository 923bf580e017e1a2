"""Deliberately broken kernels — proof that each detector fires; the
port of the twins of the JAX package's ``analysis/fixtures.py`` that the
law engine, the SEC schedule checker, the compaction and decomposition
laws, every package's static-check section and the host-concurrency plane
run, and the twins of the program lint, the δ digest-gate check and the
cost gate (``analysis/jit_lint.py``, ``cost.py``), which run over the
port's op trace. None of this is imported by production code.

The law twins are scalar ``uint32`` lattices whose honest join is max;
each broken kind violates exactly the law it is named for. Their states
are minted on ``device`` like every kind's.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .._dtypes import bits, from_wide, to_wide
from ..delta_opt.decompose import Compactor
from ..ops.lattice import mask_slots, tree_leaves, tree_map
from .registry import MergeKind

_U32 = torch.uint32
_MASK32 = 0xFFFFFFFF


def _u32(v: int, device="cuda") -> torch.Tensor:
    return from_wide(torch.tensor(int(v), dtype=torch.int64, device=device), _U32)


def _max(a, b):
    return from_wide(torch.maximum(to_wide(a), to_wide(b)), _U32)


def _add(a, b):
    """``a + b`` wrapping at 2^32, as ``uint32`` addition does."""
    return from_wide((to_wide(a) + to_wide(b)) & _MASK32, _U32)


# ---- broken merges (law-engine fixtures) ---------------------------------

def _scalar_states(device="cuda"):
    return [_u32(v, device) for v in (0, 1, 2, 3, 5)]


GOOD_MAX = MergeKind(
    name="fixture_good_max", join=_max, states=_scalar_states, module=__name__,
)

# Keeps the left operand: idempotent and associative, NOT commutative.
NOT_COMMUTATIVE = MergeKind(
    name="fixture_not_commutative", join=lambda a, b: a,
    states=_scalar_states, module=__name__,
)

# Addition: commutative and associative, NOT idempotent.
NOT_IDEMPOTENT = MergeKind(
    name="fixture_not_idempotent", join=_add,
    states=_scalar_states, module=__name__,
)

# Truncated mean: commutative and idempotent, NOT associative.
NOT_ASSOCIATIVE = MergeKind(
    name="fixture_not_associative",
    join=lambda a, b: from_wide(((to_wide(a) + to_wide(b)) & _MASK32) // 2, _U32),
    states=_scalar_states, module=__name__,
)


# ---- broken schedule fixtures (SEC model checker, schedules.py) ----------

# A δ-mutator that is not an inflation: delivery REPLACES instead of
# joining, so a stale δ replayed late deflates the state.
DELTA_NOT_INFLATION = MergeKind(
    name="fixture_delta_not_inflation", join=lambda a, b: b,
    states=_scalar_states, module=__name__,
)

# A non-commuting op-based apply (2s + d): causal interleavings of ops
# from different origins reach different values. The join is an honest
# max; only delivery by apply is broken.
NON_COMMUTING_APPLY = MergeKind(
    name="fixture_non_commuting_apply", join=_max,
    states=_scalar_states, module=__name__,
    apply=lambda s, d: _add(_add(s, s), d),
    deltas=lambda device="cuda": [
        (0, _u32(1, device)), (1, _u32(2, device)),
        (0, _u32(3, device)), (2, _u32(4, device)),
    ],
)

# A degenerate generator: every state is the same canonical point, so
# every law and every schedule holds vacuously.
DEGENERATE_GENERATOR = MergeKind(
    name="fixture_degenerate_generator", join=_max,
    states=lambda device="cuda": [_u32(0, device), _u32(0, device), _u32(0, device)],
    module=__name__,
)


# ---- broken compactors (compaction-invariance fixtures) ------------------

def _fixture_compact_ok(s, frontier):
    return s, _u32(0, s.device), torch.zeros((), dtype=torch.float32, device=s.device)


def _fixture_compact_lossy(s, frontier):
    """Discards observable state (halves the value): the read changes, so
    compact-read-invariance must fire."""
    return (from_wide(to_wide(s) // 2, _U32), _u32(1, s.device),
            torch.zeros((), dtype=torch.float32, device=s.device))


GOOD_COMPACTOR = Compactor(compact=_fixture_compact_ok, observe=lambda s: s, top_of=None)

LOSSY_COMPACTOR = Compactor(compact=_fixture_compact_lossy, observe=lambda s: s, top_of=None)


# ---- broken decompositions (decomposition-law fixtures) ------------------
#
# Both twins wrap the honest ORSWOT row decomposition and break exactly
# one law each. They take and return ``[N, ...]`` batches (the law engine
# runs them over the whole pair grid at once).

class FixtureDecomposer(NamedTuple):
    """A decomposer given as its own batched ``decompose(state, since)``
    and ``reconstruct(since, d)`` pair."""

    name: str
    decompose: Callable[[Any, Any], Any]
    reconstruct: Callable[[Any, Any], Any]


def _orswot_split(s):
    from ..ops.orswot import _decomp_split

    return _decomp_split(s)


def _orswot_unsplit(rows, res):
    from ..ops.orswot import _decomp_unsplit

    return _decomp_unsplit(rows, res)


def _decompose_lossy(state, since):
    """Silently drops the FIRST changed δ lane of every decomposition:
    reconstruction misses that row's inflation, so decomp-reconstruction
    must fire."""
    from ..delta_opt.decompose import Decomposition, decompose_rows

    d = decompose_rows(state, since, _orswot_split, batched=True)
    lanes = torch.arange(d.valid.shape[-1], device=d.valid.device)
    first = torch.argmax(d.valid.to(torch.uint8), dim=-1)
    valid = d.valid & (lanes != first[..., None])
    dropped = Decomposition(
        lanes=tuple(mask_slots(valid, x) for x in d.lanes), valid=valid, residual=d.residual,
    )
    has = torch.any(d.valid, dim=-1)

    def pick(a, b):
        sel = has.reshape(*has.shape, *([1] * (a.dim() - has.dim())))
        return torch.where(sel, bits(a), bits(b)).view(a.dtype)

    return tree_map(pick, dropped, d)


def _decompose_redundant(state, since):
    """Marks EVERY row lane valid (changed or not): dropping an unchanged
    lane still reconstructs exactly, so decomp-irredundancy must fire."""
    from ..delta_opt.decompose import Decomposition

    rows, res = _orswot_split(state)
    n = rows[0].shape[-2]
    return Decomposition(
        lanes=rows, valid=torch.ones((*rows[0].shape[:-2], n), dtype=torch.bool,
                                     device=rows[0].device),
        residual=res,
    )


def _reconstruct_rows(since, d):
    from ..delta_opt.decompose import reconstruct_rows

    return reconstruct_rows(since, d, _orswot_split, _orswot_unsplit)


LOSSY_DECOMPOSER = FixtureDecomposer(
    name="fixture_lossy_decomposer", decompose=_decompose_lossy,
    reconstruct=_reconstruct_rows,
)

REDUNDANT_DECOMPOSER = FixtureDecomposer(
    name="fixture_redundant_decomposer", decompose=_decompose_redundant,
    reconstruct=_reconstruct_rows,
)


# ---- program-lint twins (analysis/jit_lint.py) ----------------------------
#
# Each broken kernel trips exactly the check it is named for; its honest
# twin stays clean. Lanes are ``uint32`` as in the JAX twins, computed
# through signed views (``_dtypes``) where eager torch has no unsigned op.

def kernel_traced_branch(x):
    """A host ``if`` on a device value: the host waits for the device and
    branches on its data."""
    if to_wide(x).sum() > 0:
        return from_wide(to_wide(x) + 1, x.dtype)
    return x


def kernel_unstable_sort(x):
    """An unstable argsort whose order gathers the values: tie order is
    device-dependent."""
    order = torch.argsort(to_wide(x))
    return bits(x)[order].view(x.dtype)


def kernel_float_accum(x):
    """Sums ``uint32`` counters through float32 — non-associative bits."""
    return torch.sum(to_wide(x).to(torch.float32))


def kernel_exact_bool_accum(sel, mask):
    """Honest twin of the above: 0/1 masks through a bf16 matmul with an
    f32 result (the dedupe group-OR idiom), exact at any realistic slot
    count. Must NOT be flagged."""
    merged = torch.einsum("ij,ie->je", sel.to(torch.bfloat16),
                          mask.to(torch.bfloat16)).to(torch.float32)
    return merged > 0.5, torch.sum(mask.to(torch.float32))


def kernel_u8_counter(x):
    """Increments a ``uint8`` counter lane — wraps at 256 ops (the JAX
    twin's ``uint16`` lane; eager torch adds no ``uint16``)."""
    return x + 1


def kernel_narrowing_convert(x):
    """A ``uint32`` clock truncated to ``uint16`` — dot comparisons
    reorder."""
    return x.to(torch.uint16)


def donating_reshape(n: int = 8, device="cuda"):
    """A donating callable whose output is a fresh tensor, not the donated
    input's storage — the donation silently degrades to a copy. Returns
    ``(fn, args)`` for ``lint_callable(n_donated_leaves=1)``."""
    def fn(s):
        return (bits(s).reshape(2, n // 2) + 1).view(s.dtype)

    return fn, (torch.zeros((n,), dtype=torch.int32, device=device).view(_U32),)


def donating_aligned(n: int = 8, device="cuda"):
    """Honest twin: writes into the donated input in place and returns it
    — must stay clean."""
    def fn(s):
        bits(s).add_(1)
        return s

    return fn, (torch.zeros((n,), dtype=torch.int32, device=device).view(_U32),)


# ---- collective-semantics twins (jit_lint collective checks) --------------
#
# Each returns ``(fn, args)`` for ``lint_callable(axis_sizes=..., allowed_
# axes=...)`` over a ``VirtualMesh(4, s=2)``; the broken kernels run fine —
# only the lint sees the wiring hazard.

def _ranked(mesh):
    return (torch.zeros((mesh.p, 8), dtype=torch.int32, device=mesh.device).view(_U32),)


def _ring(p: int, links: int):
    return [(i, (i + 1) % p) for i in range(links)]


def collective_bad_ppermute(mesh):
    """A ring missing one link: the uncovered rank receives zeros and its
    state silently resets."""
    from ..parallel.collectives import ppermute

    perm = _ring(mesh.p, mesh.p - 1)
    return (lambda x: ppermute(x, perm)), _ranked(mesh)


def collective_good_ppermute(mesh):
    """Honest twin: the full ring bijection — must stay clean."""
    from ..parallel.collectives import ppermute

    perm = _ring(mesh.p, mesh.p)
    return (lambda x: ppermute(x, perm)), _ranked(mesh)


def collective_wrong_axis(mesh):
    """A psum over the replica (rank) axis — lint with
    ``allowed_axes=("element",)``."""
    from ..parallel.collectives import psum

    return (lambda x: psum(bits(x))), _ranked(mesh)


def collective_read_after_donation(mesh):
    """The donated state feeds a shift, the shift's output is written into
    the donated storage (the donation taking its place), and the state is
    then read again: ``x + y`` reads the written data, not the input —
    lint with ``n_donated_leaves=1``."""
    from ..parallel.collectives import ppermute

    perm = _ring(mesh.p, mesh.p)

    def fn(x):
        y = ppermute(x, perm)
        bits(x).copy_(bits(y))  # the shift's output takes the donated storage
        total = to_wide(x) + to_wide(y)  # stale: x now holds y
        bits(x).copy_(bits(from_wide(total, x.dtype)))
        return x

    return fn, _ranked(mesh)


def collective_read_before_donation(mesh):
    """Honest twin: the donated state is consumed BEFORE the shift and the
    result written back last (the ring discipline) — must stay clean."""
    from ..parallel.collectives import ppermute

    perm = _ring(mesh.p, mesh.p)

    def fn(x):
        y = from_wide(to_wide(x) + 1, x.dtype)
        bits(x).copy_(bits(ppermute(y, perm)))
        return x

    return fn, _ranked(mesh)


# ---- unsound δ digest gate (jit_lint.check_gates) -------------------------

def gate_top_covered_unsound(pkt, digest):
    """The wider gate: it masks every slot the receiver's top covers,
    ignoring that a context lane above the row is removal knowledge a top
    digest can never vouch for. ``check_orswot_gate`` must report
    gate-removal-dropped."""
    covered = torch.all(to_wide(pkt.rows) <= to_wide(digest)[None, :], dim=-1)
    keep = pkt.valid & ~covered
    return pkt._replace(valid=keep, rows=mask_slots(keep, pkt.rows),
                        ctxs=mask_slots(keep, pkt.ctxs))


# ---- cost-budget twins (analysis/cost.py) ---------------------------------

def kernel_budget_pad(x):
    """Budget-buster: pads an 8-lane input out to 1M lanes and keeps the
    pad live across an elementwise op — peak_bytes grows ~1e5× over the
    lean twin while the I/O signature stays the same."""
    big = torch.nn.functional.pad(to_wide(x), (0, 1_000_000 - x.shape[0]))
    return torch.sum(big * big)


def kernel_budget_lean(x):
    """Honest twin of the same contract (sum of squares of 8 lanes)."""
    w = to_wide(x)
    return torch.sum(w * w)


# ---- broken fused-wire twins (parallel/wire_checks.py) --------------------

def fused_mask_drops_removals(pkt):
    """The wider-gate unsoundness rebuilt inside the fused wire kernel: a
    know function that returns the slot CONTEXTS instead of the content
    knowledge makes every slot read as add-only, so the in-kernel digest
    verdict masks removal-carrying slots the receiver's top can never
    vouch for. ``wire_checks.check_fused_gate`` must report
    wire-removal-dropped for this twin."""
    from ..delta_opt.ackwin import _core

    return _core(pkt).ctxs


def bitmap_truncates_lanes(flags):
    """A bit-packer that silently drops the last bitmap word: presence
    masks shorter than the packet's bool lanes turn valid slots invisible
    on the wire. ``wire_checks.check_bitmaps`` must catch it."""
    from ..ops.wire_kernels import pack_bits

    return pack_bits(flags)[:-1]


# ---- fault-tolerance twins (crdt_tpu_torch/faults/) -----------------------

def checksum_ignores_corruption(tree):
    """Broken link-integrity twin: a constant digest that verifies EVERY
    payload, corrupted or not. ``integrity.checksum_detects`` must fail
    it."""
    del tree
    return torch.zeros((), dtype=torch.int64)


def eviction_drops_ranks(p: int, evicted=()):
    """Broken membership twin: rebuilds the ring by OMITTING evicted ranks
    from the permutation instead of self-looping them — no longer a
    bijection of the full axis. ``membership.validate_perm`` must fail
    it."""
    live = [i for i in range(p) if i not in set(evicted)]
    return sorted((live[i], live[(i + 1) % len(live)]) for i in range(len(live)))


# ---- durability twins (crdt_tpu_torch/durability/) ------------------------

def wal_skips_fsync(path, **kwargs):
    """Broken durability twin: a WAL whose fsync seam silently drops the
    ``os.fsync`` (and still counts it). ``durability.wal.fsync_honored``
    must fail it."""
    from ..durability.wal import Wal

    class _NoFsyncWal(Wal):
        def _fsync(self, f):  # the barrier that never happens
            self.fsyncs += 1  # it even lies in its own accounting

    return _NoFsyncWal(path, **kwargs)


def snapshot_load_unchecked(path, template=None):
    """Broken durability twin: a snapshot loader that takes the newest
    generation's payload at face value — no manifest CRC, no per-array
    checksums — so a corrupt newest generation loads "successfully".
    ``durability.snapshot.loader_detects_corruption`` must fail it."""
    import io

    import numpy as np

    from ..convert import leaf_from_numpy
    from ..durability.snapshot import _gen_paths, generations
    from ..ops.lattice import tree_unflatten

    payload_path, _ = _gen_paths(path, generations(path)[-1])
    with open(payload_path, "rb") as f:
        raw = f.read()
    with np.load(io.BytesIO(raw)) as z:
        arrays = {k: z[k] for k in z.files if k != "meta"}
    if template is None:
        return arrays
    dev = tree_leaves(template)[0].device
    n = sum(1 for k in arrays if k.startswith("a_"))
    return tree_unflatten(template, [leaf_from_numpy(arrays[f"a_{i}"], dev) for i in range(n)])


# ---- scale-out twins (crdt_tpu_torch/scaleout/) ---------------------------

def bootstrap_skips_checksum(kind, live, **kwargs):
    """Broken scale-out twin: a newcomer bootstrap that trusts the wire —
    checksum-rejected segments are JOINED instead of re-shipped.
    ``scaleout.bootstrap_rejects_corruption`` must fail it."""
    from ..scaleout.bootstrap import bootstrap

    kwargs["verify_checksums"] = False
    return bootstrap(kind, live, **kwargs)


def drain_ignores_unacked(kind, rank, rows, residue, counters=None, **kw):
    """Broken scale-out twin: a drain certifier that zeroes the
    unacked-out-lane count, certifying a rank that still holds content no
    survivor has confirmed. ``scaleout.drain_refuses_unflushed`` must
    fail it."""
    from dataclasses import replace

    from ..scaleout.mesh_scale import certify_drain

    return replace(certify_drain(kind, rank, rows, residue, counters, **kw), lanes_unacked=0)


# ---- serving-tier twins (crdt_tpu_torch/serve/) ---------------------------

def serve_dispatch_before_wal(queue, built):
    """Broken serving twin: a flush that issues the device dispatch BEFORE
    the slab's WAL record is group-committed — every op acked in the
    window between the scatter and the fsync is lost by a kill, exactly
    the log-before-dispatch ordering bug the dirty-tenant WAL exists to
    prevent. Never executed: ``serve.wal.wal_order_violations`` reads its
    source and must report it while the honest ``IngestQueue`` and
    ``ServeLoop.step`` pass (its findings' line numbers equal the JAX
    twin's)."""
    pending = queue.sb.apply_async(  # dispatch first — the bug
        built.slab, built.idx, built.tenants
    )
    seq = queue.wal.log_slab(  # durable only AFTER the scatter is off
        built.kind, built.actor, built.ctr, built.clock, built.member, built.tenants,
    )
    return pending, seq


def evictor_drops_dirt(evictor, tenants):
    """Broken serving twin: an evictor that clears a tenant's lane WITHOUT
    persisting its dirty row first, so the next touch restores a stale
    record. ``serve.evictor_preserves_dirt`` must fail it."""
    return evictor.evict(tenants, _persist_dirty=False)


# ---- fan-out twins (crdt_tpu_torch/fanout/) -------------------------------

def fanout_skips_watermark_bucket(plane):
    """Broken fan-out twin: a pusher that skips the ⊥-watermark cohort
    bucket, starving subscribers still acked at version 0.
    ``fanout.fanout_covers_cohorts`` must fail it."""
    return plane.push(_skip_versions=(0,))


# ---- geo-federation twins (crdt_tpu_torch/geo/) ---------------------------

def region_serves_unwatermarked_read(fed, region, tenant):
    """Broken geo twin: a region-local read path that serves whatever the
    mirror holds while claiming ``fresh`` unconditionally — the
    certificate says lag 0 whether or not the home→here link's acked
    watermark ever caught the home version. ``geo.reads.
    watermark_reads_sound`` must fail it."""
    from ..geo.reads import ReadCertificate, read_local

    value, cert = read_local(fed, region, tenant)
    return value, ReadCertificate(
        tenant=cert.tenant, region=cert.region, home=cert.home,
        fresh=True, watermark=cert.home_version,
        home_version=cert.home_version, lag=0,
    )


# ---- observability twins (crdt_tpu_torch/obs/) ----------------------------

def recorder_drops_events(capacity: int = 8, **kwargs):
    """Broken observability twin: a flight recorder whose ring silently
    discards every third event and never counts a drop.
    ``obs.recorder_conformant`` must fail it."""
    from ..obs.recorder import FlightRecorder

    class _Lossy(FlightRecorder):
        def __init__(self):
            super().__init__(capacity=capacity, **kwargs)
            self._n = 0

        def record(self, etype, **fields):
            self._n += 1
            if self._n % 3 == 0:
                return None  # silently gone — and dropped never moves
            return super().record(etype, **fields)

    return _Lossy()


def histogram_miscounts(h, value):
    """Broken observability twin: a histogram observe that buckets by
    FLOATING log2 with a truncating floor instead of the exact edge
    comparisons — every value strictly between two edges lands one bucket
    low (3.0 counts under ``le="2"`` instead of ``le="4"``).
    ``obs.histogram_conformant`` must fail it."""
    from ..obs import hist as _h

    v = torch.clamp(torch.as_tensor(value, dtype=torch.float32).to(h.counts.device), min=0.0)
    idx = torch.clamp(torch.floor(torch.log2(torch.clamp(v, min=1.0))).to(torch.int64),
                      0, _h.NBUCKETS - 1)
    counts = to_wide(h.counts).index_add(0, idx.reshape(1), torch.ones(1, dtype=torch.int64,
                                                                        device=v.device))
    return _h.Hist(counts=from_wide(counts, _U32), total=h.total + v)


def tracer_skips_stage(**kwargs):
    """Broken trace-plane twin: a tracer that silently drops every
    ``durable`` stamp, so the dispatch→durable leg reads as instantaneous.
    ``obs.trace.tracer_conformant`` must fail it."""
    from ..obs.trace import Tracer

    class _SkipsDurable(Tracer):
        def stamp(self, stage, **fields):
            if stage == "durable":
                return None  # silently gone — the leg never existed
            return super().stamp(stage, **fields)

    return _SkipsDurable(**kwargs)


def tracer_clock_regresses(**kwargs):
    """Broken trace-plane twin: a tracer whose stamp clock runs BACKWARDS
    (a wall clock straddling a step), so per-stage deltas go negative.
    ``obs.trace.tracer_conformant`` must fail it."""
    from ..obs.trace import Tracer

    ticks = [10_000_000_000]

    def backwards():
        ticks[0] -= 1000
        return ticks[0]

    kwargs.pop("clock_ns", None)  # discard the honest injected clock
    return Tracer(clock_ns=backwards, **kwargs)


# ---- host-concurrency twins (analysis/concur.py, interleave.py) -----------

class UnorderedWalLoop:
    """Broken concurrency twin: a pipelined serving loop that issues the
    device dispatch before group-committing the slab's WAL record — the
    loop form of ``serve_dispatch_before_wal``, so the generalized
    ``concur.call_order_violations`` (the ``wal_commit_precedes_dispatch``
    contract, first entry of ``concur.HB_CONTRACTS``) proves the ordering
    over the whole method body and must report it. Never executed (its
    findings' line numbers equal the JAX twin's)."""

    def step(self, q, built):
        pend = q._issue(built)        # dispatch first — the bug
        seq = q._log(built)           # durable only after the scatter
        return q._finish(built, pend, seq)


class PersistFreesLanes:
    """Broken concurrency twin: a background persister whose drain ALSO
    frees the persisted tenants' lanes — lane-table writes from the
    persist thread with no ordering contract against the driver's
    assemble/issue path. ``concur.uncovered_conflicts`` must report both
    sites (with ``extra=(PersistFreesLanes,)`` and
    ``extra_threads={"PersistFreesLanes": ("persist",)}``). Never
    executed."""

    def drain(self):
        for t in list(self._queue):
            self.evictor.persist([t])
            lane = int(self.sb.lane_of[t])
            self.sb.lane_of[t] = -1        # the bug: lane-table writes
            self.sb.tenant_of[lane] = -1   # off-thread, unordered
            self.sb._free.append(lane)     # against the driver's picks
            self.persisted += 1


def regressing_ack_promoter_cls():
    """Broken concurrency twin: a fan-out plane whose ack promotion
    TRUSTS the claimed version — no clamp to ``[watermark, shipped]`` —
    so a stale ack regresses the watermark and an overclaim promotes past
    what was shipped. ``concur.ack_window_probe`` must fail it."""
    from ..fanout.plane import FanoutPlane

    class _RegressingAckPlane(FanoutPlane):
        def ack(self, ids, versions=None):
            import numpy as np

            ids = np.atleast_1d(np.asarray(ids, np.int64))
            v = (self.sub_pend[ids] if versions is None
                 else np.broadcast_to(np.asarray(versions, np.int64), ids.shape))
            self.sub_ver[ids] = v          # the bug: no clamp
            self.sub_pend[ids] = -1

    return _RegressingAckPlane


class RogueCounterMutator:
    """Broken concurrency twin: a host-surface class mutating a
    self-attribute (``rogue_counter``) outside ``__init__`` that no
    shared-field row covers. ``effects.unregistered_shared_mutations(
    extra=(...,))`` must name ``RogueCounterMutator.rogue_counter`` and
    the mutating site. Never executed."""

    def __init__(self):
        self.rogue_counter = 0

    def bump(self):
        self.rogue_counter += 1   # the unregistered shared write


def racy_fanout_world(device="cuda"):
    """Broken concurrency twin: the lane-eviction race rebuilt as an
    explorable world. ``_RacyPlane`` restores pushed tenants WITHOUT the
    ``_exclude`` pin and, where the honest plane raises on a mid-cycle
    residency loss, silently WRAPS the -1 lane to the last lane, so a
    snapshot or dispatch after a preempting eviction gathers ANOTHER
    tenant's row as the shipped δ base. ``interleave.explore`` must find
    a counterexample within 2 preemptions."""
    from .interleave import fanout_world

    def _racy_plane_cls():
        from ..fanout.plane import FanoutPlane

        class _RacyPlane(FanoutPlane):
            def _ensure_resident(self, tenant, _exclude=()):
                super()._ensure_resident(tenant)  # pin dropped — bug

            def _wrap_lost(self, tenants):
                import numpy as np

                lanes = self.sb.lane_of
                healed = [int(t) for t in np.atleast_1d(tenants) if int(lanes[int(t)]) < 0]
                for t in healed:
                    # the -1 lane silently wraps to the last lane — another
                    # tenant's row
                    lanes[t] = self.sb.n_lanes - 1
                return healed

            def _snapshot(self, tenants):
                lanes = self.sb.lane_of
                healed = self._wrap_lost(tenants)
                try:
                    return super()._snapshot(tenants)
                finally:
                    for t in healed:
                        lanes[t] = -1

            def _dispatch(self, cohorts, telemetry=False):
                lanes = self.sb.lane_of
                healed = self._wrap_lost([co[0] for co in cohorts])
                try:
                    return super()._dispatch(cohorts, telemetry)
                finally:
                    for t in healed:
                        lanes[t] = -1

        return _RacyPlane

    return fanout_world(plane_cls=_racy_plane_cls(), evict_pushed=True, device=device)


__all__ = [
    "DEGENERATE_GENERATOR", "DELTA_NOT_INFLATION", "FixtureDecomposer", "GOOD_COMPACTOR",
    "GOOD_MAX", "LOSSY_COMPACTOR", "LOSSY_DECOMPOSER", "NON_COMMUTING_APPLY",
    "NOT_ASSOCIATIVE", "NOT_COMMUTATIVE", "NOT_IDEMPOTENT", "PersistFreesLanes",
    "REDUNDANT_DECOMPOSER", "RogueCounterMutator", "UnorderedWalLoop",
    "bitmap_truncates_lanes", "bootstrap_skips_checksum", "checksum_ignores_corruption",
    "drain_ignores_unacked", "eviction_drops_ranks", "evictor_drops_dirt",
    "fanout_skips_watermark_bucket", "fused_mask_drops_removals", "histogram_miscounts",
    "racy_fanout_world", "recorder_drops_events", "region_serves_unwatermarked_read",
    "regressing_ack_promoter_cls", "serve_dispatch_before_wal", "snapshot_load_unchecked",
    "tracer_clock_regresses", "tracer_skips_stage", "wal_skips_fsync",
]
