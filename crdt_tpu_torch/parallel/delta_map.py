"""δ-state anti-entropy for ``Map<K, MVReg>`` — counterpart of the JAX
package's ``parallel/delta_map.py``.

The discipline of :mod:`.delta` applied to the config-4 map slabs: a
packet ships up to ``cap`` (key index, content slots, per-key causal
context) triples plus the parked keyset-remove buffer whole. Per-key
survival is the ``ops.map.join`` rule restricted to the packet keys —
content survives iff the peer holds the same witness dot or the dot is
unseen by the peer's per-key context — so convergence is inherited from
the join.

A key's forwarding context covers the dots the replica can attest for
that key: the witness dots it saw there (live or since superseded) plus
any keyset-remove clocks applied there, and nothing cross-key
(:func:`_key_knowledge`). Track with :func:`interval_accumulate_map` or
from op logs at op granularity, as in ``delta.py``'s contract.

Every function takes leading batch axes (the ring runs them once per round
over the ``[P]`` rank axis). Clock planes are ``uint32`` at every public
function and the int64 view (``_dtypes.to_wide``) inside, as in
``ops/map.py``. No function syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._dtypes import bits, from_wide, to_wide
from ..ops import map as map_ops
from ..ops import mvreg as mvreg_ops
from ..ops.map import MapState, _apply_parked, _canon_child, _dot_in, _drop_stale_deferred
from ..ops.mvreg import MVRegState
from ..ops.orswot import _compact_deferred, _dedupe_deferred_fixed
from .delta import mask_slots, put_rows, take_rows
from .mesh import VirtualMesh


class MapDeltaPacket(NamedTuple):
    """One replica's bounded map delta."""

    idx: torch.Tensor     # [.., C] int32
    child: MVRegState     # [.., C, S(, A)] content slots of the shipped keys
    ctxs: torch.Tensor    # [.., C, A] per-key causal context
    valid: torch.Tensor   # [.., C] bool
    dcl: torch.Tensor     # [.., D, A] parked keyset-removes ride whole
    dkeys: torch.Tensor   # [.., D, K]
    dvalid: torch.Tensor  # [.., D]


def _key_knowledge(child: MVRegState) -> torch.Tensor:
    """Per-key clock of the WITNESS DOTS the content slots attest:
    ``child [.., K, S]`` → ``[.., K, A]``, in ``child.wctr``'s dtype (u32
    or wide). It leaves out the slots' write clocks: a put's stored clock
    is its minter's whole-map top at mint time, cross-key knowledge that
    would let a delta claim dots of other keys (the JAX module documents
    the failure)."""
    a = child.clk.shape[-1]
    actors = torch.arange(a, device=child.wact.device)
    wctr = to_wide(child.wctr)
    out = torch.zeros((*child.wact.shape[:-1], a), dtype=torch.int64, device=wctr.device)
    for s in range(child.wact.shape[-1]):  # a slot's dot at its actor's lane
        hit = (child.wact[..., s, None] == actors) & child.valid[..., s, None]
        out = torch.maximum(out, torch.where(hit, wctr[..., s, None], 0))
    return from_wide(out, child.wctr.dtype)


def _child_rows(child: MVRegState, idx: torch.Tensor) -> MVRegState:
    return MVRegState(*(take_rows(x, idx) for x in child))


def interval_accumulate_map(
    dirty: torch.Tensor, fctx: torch.Tensor, old: MapState, new: MapState
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one mutation step into ``(dirty, fctx)``: changed keys become
    dirty and their context absorbs both endpoints' per-key knowledge."""
    o, n = old.child, new.child
    changed = (
        torch.any(o.wact != n.wact, dim=-1)
        | torch.any(bits(o.wctr) != bits(n.wctr), dim=-1)
        | torch.any(o.valid != n.valid, dim=-1)
        | torch.any(bits(o.clk) != bits(n.clk), dim=(-2, -1))
        | torch.any(o.val != n.val, dim=-1)
    )
    grown = torch.maximum(
        to_wide(fctx),
        torch.maximum(to_wide(_key_knowledge(o)), to_wide(_key_knowledge(n))),
    )
    f = torch.where(changed[..., None], grown, to_wide(fctx))
    return dirty | changed, from_wide(f, fctx.dtype)


def extract_delta_map(
    state: MapState, dirty: torch.Tensor, fctx: torch.Tensor, cap: int, start: int = 0,
) -> Tuple[MapDeltaPacket, torch.Tensor, torch.Tensor]:
    """Pack up to ``cap`` dirty keys with their contexts and clear them
    locally; the rotation and the stable argsort order of
    ``delta.extract_delta``. Returns ``(packet, dirty, fctx)``; ``fctx`` is
    never cleared."""
    k = dirty.shape[-1]
    pos = torch.remainder(torch.arange(k, device=dirty.device) - start, k)
    order = torch.argsort(torch.where(dirty, pos, k + pos), dim=-1, stable=True)
    idx = order[..., :cap].to(torch.int32)
    valid = torch.gather(dirty, -1, idx.long())
    rows = _child_rows(state.child, idx)
    ctxs = torch.maximum(to_wide(take_rows(fctx, idx)), to_wide(_key_knowledge(rows)))
    pkt = MapDeltaPacket(
        idx=idx,
        child=MVRegState(*(mask_slots(valid, x) for x in rows)),
        ctxs=from_wide(torch.where(valid[..., None], ctxs, 0), fctx.dtype),
        valid=valid,
        dcl=state.dcl, dkeys=state.dkeys, dvalid=state.dvalid,
    )
    return pkt, put_rows(dirty, idx, torch.zeros_like(valid)), fctx


def _cov(clock: torch.Tensor, act: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """``ctr <= clock[act]`` per slot: ``[.., C, A]`` clock vs ``[.., C, S]``
    (act, ctr), wide lanes."""
    return ctr <= torch.gather(clock, -1, act.long())


def _replay_on_rows(rows: MVRegState, idx, dcl, dkeys, dvalid) -> MVRegState:
    """Kill covered content among the packet-key rows ``[.., C, S]`` under
    every parked (clock, keyset) slot, keysets gathered at ``idx`` — the
    per-row form of ``ops.map._apply_parked`` (wide lanes)."""
    valid = rows.valid
    for d in range(dcl.shape[-2]):
        kmask = torch.gather(dkeys[..., d, :], -1, idx.long())  # [.., C]
        clock = dcl[..., d, None, :].expand(*idx.shape, dcl.shape[-1])
        dead = kmask[..., None] & _cov(clock, rows.wact, rows.wctr) & dvalid[..., d, None, None]
        valid = valid & ~dead
    return rows._replace(valid=valid)


def apply_delta_map(
    state: MapState, pkt: MapDeltaPacket, dirty: torch.Tensor, fctx: torch.Tensor
) -> Tuple[MapState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Join a map delta into ``state``: the ``ops.map.join`` content rule
    restricted to the packet keys, with the per-key packet contexts
    standing in for the sender's top. The top stays frozen. Returns
    ``(state, dirty, fctx, overflow [.., 2])`` — [sibling slab, deferred]
    as in ``ops.map.join``."""
    st = map_ops._wide(state)
    pchild = mvreg_ops._wide(pkt.child)
    pctx, fw = to_wide(pkt.ctxs), to_wide(fctx)
    idx = pkt.idx
    recv = _child_rows(st.child, idx)
    # Per-key receiver knowledge: its honest top joined with what packets
    # taught about THIS key (the top must not grow mid-ring).
    rctx = torch.maximum(st.top[..., None, :], take_rows(fw, idx))

    keep_r = recv.valid & (_dot_in(recv, pchild) | ~_cov(pctx, recv.wact, recv.wctr))
    keep_p = pchild.valid & (_dot_in(pchild, recv) | ~_cov(rctx, pchild.wact, pchild.wctr))
    union = map_ops._cat_child(recv, pchild, keep_r, keep_p)
    s2 = union.wact.shape[-1]
    dup = (
        (union.wact[..., :, None] == union.wact[..., None, :])
        & (union.wctr[..., :, None] == union.wctr[..., None, :])
        & union.valid[..., :, None]
        & union.valid[..., None, :]
    )
    first = mvreg_ops._first_true(dup, dim=-1)  # first valid slot holding this dot
    union = union._replace(valid=union.valid & (first == torch.arange(s2, device=first.device)))

    # Union the parked buffers FIRST and replay them on the double-width
    # union before the capacity check, as ops.map.join does. The dedupe
    # keeps fixed shapes: a round holds no sync with the host.
    dcl = torch.cat([st.dcl, to_wide(pkt.dcl)], dim=-2)
    dkeys = torch.cat([st.dkeys, pkt.dkeys], dim=-2)
    dvalid = torch.cat([st.dvalid, pkt.dvalid], dim=-1)
    dcl, dkeys, dvalid = _dedupe_deferred_fixed(dcl, dkeys, dvalid)
    union = _canon_child(_replay_on_rows(union, idx, dcl, dkeys, dvalid))
    scap = st.child.wact.shape[-1]
    slab_of = torch.any((union.valid.sum(dim=-1) > scap) & pkt.valid, dim=-1)
    merged = MVRegState(*(x[..., :scap, :] if x.dim() == union.clk.dim() else x[..., :scap]
                          for x in union))
    child = MVRegState(*(
        put_rows(whole, idx, torch.where(
            pkt.valid.reshape(*pkt.valid.shape, *([1] * (rows.dim() - pkt.valid.dim()))),
            rows, old))
        for whole, rows, old in zip(st.child, merged, recv)
    ))

    st = MapState(top=st.top, child=child, dcl=dcl, dkeys=dkeys, dvalid=dvalid)
    before = st.child
    st = _drop_stale_deferred(_apply_parked(st))
    dcl, dkeys, dvalid, d_of = _compact_deferred(st.dcl, st.dkeys, st.dvalid,
                                                 state.dcl.shape[-2])
    st = st._replace(child=_canon_child(st.child), dcl=dcl, dkeys=dkeys, dvalid=dvalid)

    # Domain forwarding and context accumulation (see delta.py).
    old_f = take_rows(fw, idx)
    row_know = _key_knowledge(_child_rows(st.child, idx))
    new_f = torch.where(pkt.valid[..., None],
                        torch.maximum(torch.maximum(old_f, pctx), row_know), old_f)
    fw = put_rows(fw, idx, new_f)
    dirty = put_rows(dirty, idx, torch.gather(dirty, -1, idx.long()) | pkt.valid)
    # A parked-remove replay that killed content is removal knowledge the
    # killed keys must forward: absorb the pre-replay witness dots.
    replay_changed = torch.any(st.child.valid != before.valid, dim=-1)
    dirty = dirty | replay_changed
    fw = torch.maximum(fw, torch.where(replay_changed[..., None], _key_knowledge(before), 0))
    overflow = torch.stack([slab_of, d_of], dim=-1)
    return map_ops._narrow(st), dirty, from_wide(fw, fctx.dtype), overflow


def gate_delta_map(pkt: MapDeltaPacket, digest: torch.Tensor) -> MapDeltaPacket:
    """Digest gate for map deltas: a slot is redundant only when its
    context carries no knowledge beyond its live content's witness dots
    (``ctxs == _key_knowledge(child)``) and the receiver's frozen top
    ``digest [.., A]`` covers those dots. Masked slots are zeroed."""
    know = _key_knowledge(pkt.child)
    covered = torch.all(bits(pkt.ctxs) == bits(know), dim=-1) & torch.all(
        to_wide(know) <= to_wide(digest)[..., None, :], dim=-1)
    keep = pkt.valid & ~covered
    return pkt._replace(
        valid=keep,
        child=MVRegState(*(mask_slots(keep, x) for x in pkt.child)),
        ctxs=mask_slots(keep, pkt.ctxs),
    )


def close_top_map(folded: MapState, top: torch.Tensor) -> MapState:
    """Adopt the mesh-wide ``top`` and re-replay the parked keyset-removes
    under it; slots the new top covers are dropped."""
    st = map_ops._wide(folded._replace(top=top))
    st = _drop_stale_deferred(_apply_parked(st))
    return map_ops._narrow(st._replace(child=_canon_child(st.child)))


def packet_template_map(folded: MapState, cap: int, fctx_dtype: torch.dtype) -> MapDeltaPacket:
    """One link's ``MapDeltaPacket`` shapes (meta tensors) — the wire
    codec's plan input, where the JAX ring uses ``jax.eval_shape`` of
    :func:`extract_delta_map`."""
    k, a = folded.dkeys.shape[-1], folded.top.shape[-1]
    s, d = folded.child.wact.shape[-1], folded.dcl.shape[-2]
    c = min(cap, k)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    ch = folded.child
    return MapDeltaPacket(
        idx=meta((c,), torch.int32),
        child=MVRegState(wact=meta((c, s), ch.wact.dtype), wctr=meta((c, s), ch.wctr.dtype),
                         clk=meta((c, s, a), ch.clk.dtype), val=meta((c, s), ch.val.dtype),
                         valid=meta((c, s), torch.bool)),
        ctxs=meta((c, a), fctx_dtype), valid=meta((c,), torch.bool),
        dcl=meta((d, a), folded.dcl.dtype), dkeys=meta((d, k), torch.bool),
        dvalid=meta((d,), torch.bool),
    )


def mesh_delta_gossip_map(
    state: MapState,
    dirty: torch.Tensor,
    fctx: torch.Tensor,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    cap: int = 64,
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
    """Ring δ anti-entropy for Map<K, MVReg> replica batches over the
    mesh's P ranks: each rank folds its replica block (``ops.map.fold``:
    K2 and its epilogue on a card), then ``rounds`` unit-shift rounds ship
    one bounded ``MapDeltaPacket`` per link per round; ``fused=True`` puts
    every packet through the bit-packed wire (K3 with the Map lane layout
    on a card). ``dirty [R, K]`` / ``fctx [R, K, A]`` come from
    :func:`interval_accumulate_map` or op logs. See
    ``delta.mesh_delta_gossip`` for the modes, the ROUNDS BUDGET and
    ``stats``, ``ack_window=`` (the Map ring ships removal-carrying
    slots, which only the ack window can mask), ``donate=`` and ``wal=``
    (δ records of kind ``map``); ``telemetry=True`` appends the run's
    Telemetry (slots counted by ``ops.map.changed_keys``); ``faults=``
    appends the ``FaultCounters`` last. Returns ``(states [P, ...],
    dirty [P, K], overflow [2], residue)``."""
    from .delta_ring import run_delta_ring

    return run_delta_ring(
        "map_delta_gossip", state, dirty, fctx, mesh, rounds, cap,
        local_fold=map_ops.fold,
        extract=extract_delta_map, apply_fn=apply_delta_map, close_top=close_top_map,
        telemetry=telemetry, pipeline=pipeline, digest=digest, gate=gate_delta_map,
        donate=donate, faults=faults, ack_window=ack_window, wal=wal, wal_kind="map",
        fused=fused, stats=stats, template=packet_template_map, slots_fn=map_ops.changed_keys,
    )


__all__ = [
    "MapDeltaPacket", "apply_delta_map", "close_top_map", "extract_delta_map",
    "gate_delta_map", "interval_accumulate_map", "mesh_delta_gossip_map",
    "packet_template_map",
]
