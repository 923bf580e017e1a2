"""δ-state anti-entropy for dense ORSWOT: ship bounded deltas, not whole
states — counterpart of the JAX package's ``parallel/delta.py``.

Each replica carries a ``dirty[E]`` row mask and an ``fctx[E, A]`` per-row
forwarding context (the clock of every dot whose fate it can attest for
that element). A δ round ships a ``DeltaPacket`` of up to ``cap``
(index, row, row-context) slots plus the parked-remove buffer whole; the
receiver joins the slots under (its frozen top, the slot context),
re-marks every row the packet carried (domain forwarding) and settles the
parked removes. The top stays frozen through the ring; the final closure
adopts the mesh-wide top (``close_top_orswot``). The JAX module's
docstring gives the soundness argument; the port follows it line for
line.

Every function here takes leading batch axes: the JAX package runs them
once per device inside ``shard_map``, the port once per round over the
``[P]`` rank axis of a :class:`.mesh.VirtualMesh`. Index planes are
``int32`` per batch lane; clock planes ``uint32`` (arithmetic on the
``_dtypes`` wide view).

Tracking contract (as in the JAX package): accumulate ``(dirty, fctx)``
with :func:`interval_accumulate` at op granularity — or any granularity
at which no dot is both born and removed between two accumulation
points — starting from a moment the replicas were mutually synced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._dtypes import bits, from_wide, to_wide
from ..ops.lattice import mask_slots, put_rows, take_rows
from ..ops.orswot import (
    DTYPE,
    OrswotState,
    _apply_parked,
    _compact_deferred,
    _dedupe_deferred_fixed,
    changed_members,
)
from .mesh import VirtualMesh


class DeltaPacket(NamedTuple):
    """One replica's bounded delta."""

    idx: torch.Tensor     # [.., C] int32
    rows: torch.Tensor    # [.., C, A] live dots of the shipped elements
    ctxs: torch.Tensor    # [.., C, A] per-row causal context
    valid: torch.Tensor   # [.., C] bool
    dcl: torch.Tensor     # [.., D, A] parked removes ride whole
    dmask: torch.Tensor   # [.., D, E]
    dvalid: torch.Tensor  # [.., D]


def interval_accumulate(
    dirty: torch.Tensor, fctx: torch.Tensor, old: OrswotState, new: OrswotState
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one mutation step into the ``(dirty, fctx)`` tracking pair:
    changed rows become dirty and their context absorbs both endpoint
    rows (a dot the old row held and the new row lacks is one this
    replica saw removed)."""
    o, n = to_wide(old.ctr), to_wide(new.ctr)
    changed = torch.any(o != n, dim=-1)
    grown = torch.maximum(to_wide(fctx), torch.maximum(o, n))
    f = torch.where(changed[..., None], grown, to_wide(fctx))
    return dirty | changed, from_wide(f, fctx.dtype)


def dirty_between(old: OrswotState, new: OrswotState) -> torch.Tensor:
    """Row mask of elements whose dot rows differ."""
    return torch.any(bits(old.ctr) != bits(new.ctr), dim=-1)


def extract_delta(
    state: OrswotState, dirty: torch.Tensor, fctx: torch.Tensor, cap: int, start: int = 0,
) -> Tuple[DeltaPacket, torch.Tensor, torch.Tensor]:
    """Pack up to ``cap`` dirty rows with their contexts and clear them
    locally. ``start`` rotates the scan origin (the ring passes ``round ·
    cap``) so a small cap round-robins every row. Rows are ordered by a
    stable argsort over rotated positions, the JAX package's
    ``jnp.argsort`` order. Returns ``(packet, dirty, fctx)``; ``fctx`` is
    a monotone knowledge cache and is never cleared."""
    e = dirty.shape[-1]
    pos = torch.remainder(torch.arange(e, device=dirty.device) - start, e)
    order = torch.argsort(torch.where(dirty, pos, e + pos), dim=-1, stable=True)
    idx = order[..., :cap].to(torch.int32)
    valid = torch.gather(dirty, -1, idx.long())
    rows = to_wide(take_rows(state.ctr, idx))
    ctxs = torch.maximum(to_wide(take_rows(fctx, idx)), rows)
    pkt = DeltaPacket(
        idx=idx,
        rows=from_wide(torch.where(valid[..., None], rows, 0), DTYPE),
        ctxs=from_wide(torch.where(valid[..., None], ctxs, 0), fctx.dtype),
        valid=valid,
        dcl=state.dcl, dmask=state.dmask, dvalid=state.dvalid,
    )
    return pkt, put_rows(dirty, idx, torch.zeros_like(valid)), fctx


def apply_delta(
    state: OrswotState, pkt: DeltaPacket, dirty: torch.Tensor, fctx: torch.Tensor
) -> Tuple[OrswotState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Join a delta into ``state``: per-row survival under (receiver top,
    packet row context) — ``ops.orswot.join`` restricted to the packet
    rows — then the deferred union/dedupe/replay/compaction. The top
    stays frozen; the row's forwarding context absorbs the packet's.
    Returns ``(state, dirty, fctx, overflow)`` (overflow per batch lane)."""
    ctr, top, fw = to_wide(state.ctr), to_wide(state.top), to_wide(fctx)
    idx = pkt.idx
    recv = take_rows(ctr, idx)
    rctx = torch.maximum(top[..., None, :], take_rows(fw, idx))
    prow, pctx = to_wide(pkt.rows), to_wide(pkt.ctxs)
    wa = torch.where(recv > pctx, recv, 0)
    wb = torch.where(prow > rctx, prow, 0)
    pa = torch.any(recv > 0, dim=-1)[..., None]
    pb = torch.any(prow > 0, dim=-1)[..., None]
    common = torch.maximum(torch.minimum(recv, prow), torch.maximum(wa, wb))
    new = torch.where(pa & pb, common, torch.where(pa & ~pb, wa, torch.where(pb & ~pa, wb, 0)))
    valid = pkt.valid[..., None]
    new = torch.where(valid, new, recv)
    ctr = put_rows(ctr, idx, new)

    # Deferred union — the same tail as ops.orswot.join (rm clocks are
    # their own contexts, so parked removes ship whole and stay sound).
    dcl = torch.cat([to_wide(state.dcl), to_wide(pkt.dcl)], dim=-2)
    dmask = torch.cat([state.dmask, pkt.dmask], dim=-2)
    dvalid = torch.cat([state.dvalid, pkt.dvalid], dim=-1)
    dcl, dmask, dvalid = _dedupe_deferred_fixed(dcl, dmask, dvalid)
    before = ctr
    ctr = _apply_parked(ctr, dcl, dmask, dvalid)
    dvalid = dvalid & ~torch.all(dcl <= top[..., None, :], dim=-1)
    dcl, dmask, dvalid, overflow = _compact_deferred(dcl, dmask, dvalid, state.dcl.shape[-2])

    # Forward on packet DOMAIN, not on content change: the (row, context)
    # pair keeps riding the ring even where nothing changed here.
    old_f = take_rows(fw, idx)
    new_f = torch.where(valid, torch.maximum(torch.maximum(old_f, pctx), new), old_f)
    fw = put_rows(fw, idx, new_f)
    dirty = put_rows(dirty, idx, torch.gather(dirty, -1, idx.long()) | pkt.valid)
    changed = torch.any(ctr != before, dim=-1)
    dirty = dirty | changed
    fw = torch.maximum(fw, torch.where(changed[..., None], before, 0))
    out = OrswotState(
        top=state.top, ctr=from_wide(ctr, DTYPE), dcl=from_wide(dcl, DTYPE),
        dmask=dmask, dvalid=dvalid,
    )
    return out, dirty, from_wide(fw, fctx.dtype), overflow


def gate_delta(pkt: DeltaPacket, digest: torch.Tensor) -> DeltaPacket:
    """Digest gate: invalidate slots that provably cannot change the
    receiver, judged against its frozen top ``digest [.., A]``: a slot is
    redundant only when it attests no removals (``ctxs == rows``) and the
    receiver's top covers every live dot (``rows <= digest``). Masked
    slots are zeroed; removal-carrying slots always ship."""
    rows = to_wide(pkt.rows)
    covered = torch.all(bits(pkt.ctxs) == bits(pkt.rows), dim=-1) & torch.all(
        rows <= to_wide(digest)[..., None, :], dim=-1
    )
    keep = pkt.valid & ~covered
    return pkt._replace(valid=keep, rows=mask_slots(keep, pkt.rows),
                        ctxs=mask_slots(keep, pkt.ctxs))


def close_top_orswot(folded: OrswotState, top: torch.Tensor) -> OrswotState:
    """Adopt the mesh-wide ``top`` and re-replay the parked removes under
    it; slots the new top covers are dropped."""
    dcl = to_wide(folded.dcl)
    ctr = _apply_parked(to_wide(folded.ctr), dcl, folded.dmask, folded.dvalid)
    dvalid = folded.dvalid & ~torch.all(dcl <= to_wide(top)[..., None, :], dim=-1)
    return OrswotState(
        top=top,
        ctr=from_wide(ctr, DTYPE),
        dcl=from_wide(torch.where(dvalid[..., None], dcl, 0), DTYPE),
        dmask=folded.dmask & dvalid[..., None],
        dvalid=dvalid,
    )


def mesh_delta_gossip(
    state: OrswotState,
    dirty: torch.Tensor,
    fctx: torch.Tensor,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    cap: int = 64,
    local_fold: str = "auto",
    telemetry: bool = False,
    pipeline: bool = True,
    digest: bool = True,
    donate: bool = False,
    faults=None,
    ack_window=False,
    wal=None,
    fused: bool = True,
    stats: Optional[dict] = None,
):
    """Ring δ anti-entropy over the mesh's P ranks: each rank folds its
    replica block (OR-folding ``dirty``, max-folding ``fctx``), then runs
    ``rounds`` unit-shift ring rounds shipping one bounded ``DeltaPacket``
    per link per round.

    ``dirty [R, E]`` / ``fctx [R, E, A]`` come from
    :func:`interval_accumulate` since the replicas last synced. The ring
    runs on ``mesh.device`` (a ``VirtualMesh`` defaults to ``"cuda"``);
    inputs held elsewhere are copied there.

    ROUNDS BUDGET (as in the JAX package): ``rounds`` defaults to the
    certificate window, P-1 sequential or ``2(P-1)-1`` pipelined, which
    suffices only when ``cap`` covers each rank's dirty backlog. Budget
    ``(P-1)·(1 + ceil(backlog/cap))`` rounds for a capped drain, doubled
    under ``pipeline=True``; ``residue == 0`` certifies convergence, ``>
    0`` means re-run with more rounds.

    ``pipeline=True`` double-buffers (round r+1's packet ships before
    round r's merges); ``digest=True`` masks slots the receiver's frozen
    top covers (``gate_delta``); ``fused=True`` ships every packet through
    the fused wire pass (kernel K3 on a card) in the bit-packed format of
    ``parallel/wire.py``, ``fused=False`` through the layered path — the
    converged states are bit-identical. ``ack_window=True`` adds the
    per-link acked-interval window (``delta_opt/ackwin.py``): slots the
    peer positively confirmed joining stop shipping, removals included;
    the converged states stay bit-identical. ``donate=True`` yields
    ``(state, dirty)``: at R == P the outputs come back in the caller's
    tensors. ``wal=`` (a ``durability.Wal``) logs the run's converged rows
    as one δ record of kind ``orswot`` + a round barrier. ``stats``, when a
    dict, receives the run's counts (``delta_ring.run_delta_ring``
    documents the modes and the counts). ``telemetry=True`` appends the
    run's Telemetry (slots counted by ``ops.orswot.changed_members``);
    ``faults=`` (a ``faults.FaultPlan``) injects the plan's link faults
    and appends the ``FaultCounters`` last. ``mesh`` may be a
    ``multihost.GlobalMesh``: the ring then spans every process and
    returns this process's rows (``delta_ring``'s module docstring).

    Returns ``(states [P, ...], dirty [P, E], overflow, residue)``."""
    from ..ops.fold_kernels import fold_auto
    from .delta_ring import run_delta_ring

    return run_delta_ring(
        "delta_gossip", state, dirty, fctx, mesh, rounds, cap,
        local_fold=lambda s: fold_auto(s, prefer=local_fold),
        extract=extract_delta, apply_fn=apply_delta, close_top=close_top_orswot,
        telemetry=telemetry, pipeline=pipeline, digest=digest, gate=gate_delta,
        donate=donate, faults=faults, ack_window=ack_window, wal=wal, wal_kind="orswot",
        fused=fused, stats=stats, slots_fn=changed_members,
    )


__all__ = [
    "DeltaPacket", "apply_delta", "close_top_orswot", "dirty_between", "extract_delta",
    "gate_delta", "interval_accumulate", "mask_slots", "mesh_delta_gossip", "put_rows",
    "take_rows",
]
