"""The δ ring on P virtual ranks — counterpart of the JAX package's
``parallel/delta_ring.py`` (``run_delta_ring``).

The JAX package runs the ring as one ``shard_map`` program: each device
folds its replica block, then ``rounds`` rounds of extract → ``ppermute``
→ apply, then the top-closure collective. Here the P ranks are the
leading axis of every tensor (``mesh.VirtualMesh``), so one call of
``extract``/``apply``/the wire pass serves all P links of a round: the
fused wire is one K3 launch per round (slot and parked instances in one
group), whatever P is. ``ppermute`` is a roll (ring shifts) or a gather
along the rank axis, ``psum``/``pmax`` reduce it. Only the local fold loops over ranks (K1 has no rank axis:
``anti_entropy.local_folds``).

Modes ported (the JAX module docstring gives their soundness):

- ``pipeline=True`` — round r+1's packet is extracted from the pre-apply
  state and put on the wire before round r's packet merges (sends one
  apply stale); the certificate window and default budget are
  ``2(P-1)-1`` rounds, P-1 sequentially;
- ``digest=True`` — the frozen receiver tops cross one inverse hop before
  the loop, and the flavor's gate masks slots the receiver's top covers;
- ``fused=True`` — every packet goes through the fused wire pass and the
  bit-packed format (``parallel/wire.py``); deferred slots are re-marked
  dirty before the backlog count, unencodable parked removes count as
  wire loss (residue forced >= 1, mesh top not adopted). ``fused=False``
  is the layered path, the port's in-package oracle. A fused ring of a
  kind without a registered codec raises. The codec's plan comes from the
  flavor's packet template (``template=``: meta tensors of one link's
  packet, where the JAX ring takes ``jax.eval_shape`` of the extract).

The residue certificate, the overflow OR, the narrow-lost parked count and
the guarded top adoption follow the JAX ring exactly. ``telemetry=``,
``faults=`` (and its delay mode), ``ack_window=``, ``wal=`` and
``donate=True`` are still to port (ROADMAP item 7) and raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .._dtypes import bits, umax
from . import wire as _wire
from .anti_entropy import local_folds, rank_blocks
from .collectives import pmax, ppermute, psum
from .delta import DeltaPacket
from .mesh import VirtualMesh


def _packet_template(folded, cap: int, fctx_dtype: torch.dtype) -> DeltaPacket:
    """One link's dense ``DeltaPacket`` shapes (meta tensors) — the
    codec's plan input, where the JAX ring uses ``jax.eval_shape`` of
    extract."""
    e, a = folded.ctr.shape[-2:]
    d = folded.dcl.shape[-2]
    c = min(cap, e)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    return DeltaPacket(
        idx=meta((c,), torch.int32), rows=meta((c, a), folded.ctr.dtype),
        ctxs=meta((c, a), fctx_dtype), valid=meta((c,), torch.bool),
        dcl=meta((d, a), folded.dcl.dtype), dmask=meta((d, e), torch.bool),
        dvalid=meta((d,), torch.bool),
    )


def _nbytes(tree) -> int:
    """Bytes of one link's slice of a ``[P, ...]`` tree."""
    if isinstance(tree, torch.Tensor):
        return tree[0].numel() * tree.element_size()
    return sum(_nbytes(x) for x in tree)


def run_delta_ring(
    kind: str,
    state,
    dirty: torch.Tensor,
    fctx: torch.Tensor,
    mesh: VirtualMesh,
    rounds: Optional[int],
    cap: int,
    local_fold: Callable,     # unbatched states -> (folded, overflow)
    extract: Callable,        # (state, dirty, fctx, cap, start) -> (pkt, dirty, fctx)
    apply_fn: Callable,       # (state, pkt, dirty, fctx) -> (state, dirty, fctx, of)
    close_top: Callable,      # (state, full_top) -> state
    telemetry: bool = False,
    pipeline: bool = True,
    digest: bool = True,
    gate: Optional[Callable] = None,  # (pkt, digest_clock) -> pkt
    donate: bool = False,
    faults=None,
    ack_window=False,
    wal=None,
    fused: bool = True,
    stats: Optional[dict] = None,
    template: Callable = _packet_template,  # (folded [P, ...], cap, fctx dtype) -> packet
):
    """Run the δ ring; returns ``(states [P, ...], dirty [P, E], overflow,
    residue)``. ``residue`` is the mesh-wide count of slot-starved
    row-rounds within the final certificate window (rows still dirty right
    after an extract): 0 proves the gossip equals the full join; > 0 means
    the run cannot be certified (re-run with more rounds). A budget below
    the window forces it >= 1.

    ``stats``, when a dict, receives the run's counts: ``rounds``,
    ``links`` (P), ``slots_shipped`` (slots on the wire, all links and
    rounds), ``slots_deferred``, ``parked_lost``, ``packet_bytes`` (one
    link's layered ``DeltaPacket``) and, fused, ``wire_bytes`` (one link's
    ``WirePacket``) — shapes are static, so both are per link-round."""
    off = dict(telemetry=telemetry, donate=donate, faults=faults is not None,
               ack_window=bool(ack_window), wal=wal is not None)
    on = [name for name, value in off.items() if value]
    if on:
        raise NotImplementedError(
            f"run_delta_ring: {', '.join(on)} not ported yet (ROADMAP item 7)"
        )
    if fused and kind not in _wire.WIRE_SURFACES:
        raise NotImplementedError(
            f"run_delta_ring: fused=True needs a wire codec for {kind!r}; only "
            f"{sorted(_wire.WIRE_SURFACES)} are ported (ROADMAP item 7)"
        )
    p = mesh.p
    gated = digest and gate is not None
    win = (p - 1) if not pipeline else max(2 * (p - 1) - 1, 0)
    if rounds is None:
        rounds = win
    perm = [(i, (i + 1) % p) for i in range(p)]
    # Digest exchange runs against the ring: rank i's packets land on
    # i+1, so i needs i+1's frozen top.
    inv_perm = [(i, (i - 1) % p) for i in range(p)]

    blocks = rank_blocks(state, mesh)
    rl = blocks.top.shape[1]
    pad_r = p * rl - dirty.shape[0]
    dirty = dirty.to(mesh.device)
    fctx = fctx.to(mesh.device)
    if pad_r:
        dirty = torch.cat([dirty, dirty.new_zeros((pad_r, *dirty.shape[1:]))])
        fctx = torch.cat([bits(fctx), bits(fctx).new_zeros((pad_r, *fctx.shape[1:]))]).view(
            fctx.dtype)
    folded, of = local_folds(blocks, local_fold)
    dirty = dirty.reshape(p, rl, -1)
    fctx = fctx.reshape(p, rl, *fctx.shape[1:])
    d = torch.any(dirty, dim=1)
    # One rank at a time: the max-fold's signed temporary stays one
    # rank block.
    f = torch.stack([bits(umax(fctx[q], 0)) for q in range(p)]).view(fctx.dtype)
    rtop = ppermute(folded.top, inv_perm) if gated else None

    counts = {"shipped": torch.zeros((), dtype=torch.int64, device=mesh.device),
              "deferred": torch.zeros((), dtype=torch.int64, device=mesh.device)}
    if fused:
        codec = _wire.WireCodec(
            template(folded, cap, fctx.dtype), d.shape[-1],
            _wire.WIRE_SURFACES[kind], gated=gated, acked=False,
        )

        def send(pkt):
            wired, aux = codec.pack(pkt, rtop=rtop)
            counts["shipped"] += aux.keep.sum()
            counts["deferred"] += aux.defer.sum()
            return ppermute(wired, perm), aux

        def receive(wired, st):
            return codec.unpack(wired, own_top=st.top if gated else None)
    else:
        def send(pkt):
            if gated:
                pkt = gate(pkt, rtop)
            counts["shipped"] += pkt.valid.sum()
            return ppermute(pkt, perm), None

        def receive(wired, st):
            return wired

    def out_step(pkt, d):
        """Put one extracted packet on the wire: re-mark its deferred
        slots (fused) before the backlog count."""
        wired, aux = send(pkt)
        if "packet_bytes" not in counts:
            counts["packet_bytes"], counts["wire_bytes"] = _nbytes(pkt), _nbytes(wired)
        lost = torch.zeros((p,), dtype=torch.int32, device=mesh.device)
        if fused:
            d = _wire.remark_deferred(d, _wire.core_idx(pkt), aux.defer)
            lost = aux.parked_lost
        return wired, d, lost

    starved = torch.zeros((p,), dtype=torch.int64, device=mesh.device)
    nlost = torch.zeros((p,), dtype=torch.int32, device=mesh.device)
    if pipeline and rounds > 0:
        # Prologue: round 0's packet goes in flight before the loop.
        pkt, d, f = extract(folded, d, f, cap, start=0)
        flight, d, nlost = out_step(pkt, d)
        if 0 >= rounds - win:
            starved = starved + d.sum(dim=-1)
        for r in range(rounds - 1):
            # Extract round r+1's packet from the pre-apply state and put
            # it in flight, then merge round r's in-flight packet.
            pkt, d, f = extract(folded, d, f, cap, start=(r + 1) * cap)
            nxt, d, lost = out_step(pkt, d)
            nlost = nlost + lost
            if (r + 1) >= rounds - win:
                starved = starved + d.sum(dim=-1)
            folded, d, f, of_r = apply_fn(folded, receive(flight, folded), d, f)
            of = of | of_r
            flight = nxt
        folded, d, f, of_r = apply_fn(folded, receive(flight, folded), d, f)
        of = of | of_r
    else:
        for r in range(rounds):
            pkt, d, f = extract(folded, d, f, cap, start=r * cap)
            wired, d, lost = out_step(pkt, d)
            nlost = nlost + lost
            if r >= rounds - win:
                starved = starved + d.sum(dim=-1)
            folded, d, f, of_r = apply_fn(folded, receive(wired, folded), d, f)
            of = of | of_r

    own_top = folded.top
    top_all = bits(pmax(own_top)).expand(own_top.shape).view(own_top.dtype)
    if fused:
        # Unencodable parked removes never reached the wire: count them as
        # loss mesh-wide and keep each rank's own top if any was lost.
        nlost_tot = psum(nlost)
        top = torch.where(nlost_tot == 0, bits(top_all), bits(own_top)).view(own_top.dtype)
    else:
        top = top_all.contiguous()
    folded = close_top(folded, top)
    overflow = torch.any(of, dim=0)
    residue = psum(starved)
    if fused:
        residue = torch.maximum(residue, (nlost_tot > 0).to(residue.dtype))
    if rounds < win:
        residue = torch.clamp_min(residue, 1)
    if stats is not None:
        stats.update(
            rounds=rounds, links=p, slots_shipped=int(counts["shipped"]),
            slots_deferred=int(counts["deferred"]), parked_lost=int(nlost.sum()),
            packet_bytes=counts.get("packet_bytes", 0),
        )
        if fused:
            stats["wire_bytes"] = counts.get("wire_bytes", 0)
    return folded, d, overflow, residue.to(torch.int32)
