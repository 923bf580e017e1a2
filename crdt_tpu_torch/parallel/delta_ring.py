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

- ``ack_window=True`` — the per-link acked-interval window
  (``delta_opt/ackwin.py``): after each apply the receiver ships one
  bool per slot back one inverse hop (a u32 bitmap on the fused wire),
  the sender promotes the confirmed slots of its own shipped copy into
  the window, and later slots whose content and context the peer has
  positively confirmed are masked — removals included. The fused wire
  takes the window as K3's acked verdict and per-slot watermark (the
  receiver decodes against its mirror, ``wire.mirror_promote``; under
  ``pipeline=True`` the mirror from before this round's promotion); the
  layered wire masks with ``gate_window`` after the digest gate. Counts
  ``delta_opt.ack_window_runs``; ``stats`` gets ``slots_acked_skipped``.
- ``donate=True`` — the caller yields ``state`` and ``dirty``: when the
  padded replica axis equals P (one replica row per rank) the ``[P,
  ...]`` outputs are written into the caller's tensors and returned in
  them, so one copy of the state outlives the call; otherwise the miss
  counts ``anti_entropy.donate_unaliasable`` and the inputs are freed
  after the run (``anti_entropy._consume``). ``fctx`` is never donated.

- ``wal=`` (a ``durability.Wal``) — crash durability: the log's diff
  base is attached (a device clone of the padded input, since a donating
  run consumes it) when the log has none, and after the run — never
  inside a round — the converged ``[P, ...]`` rows are appended as one δ
  record under ``wal_kind`` and the round barrier is marked
  (``Wal.mark_round``, the ``on_round`` policy's one fsync). A crash then
  recovers to the last durable run through ``durability.recover``.

- ``telemetry=True`` — the in-loop sidecar (:class:`RingTelemetry`): per
  round, each rank's wire bytes, post-mask useful bytes and (fused) K3's
  nonzero-word count ×4 accumulate in float32, its backlog, useful bytes,
  packed bytes and ack-window depth are observed into per-rank
  histograms, and the kind's changed slots add up; all on the device,
  summed over the ranks once after the ring (the JAX ring's ``psum`` of
  its per-device carries). The Telemetry comes back as a fifth output.

The residue certificate, the overflow OR, the narrow-lost parked count and
the guarded top adoption follow the JAX ring exactly. The ring feeds the
host registry as the JAX ring does: ``anti_entropy.<kind>_rounds``, the
padded input's ``anti_entropy.state_bytes``, the ``anti_entropy.<kind>``
timer, ``wire.fused_runs``, the ``durability.wal_append`` timer, and — from
one host read of the residue at the ring's end, never inside a round —
the ``anti_entropy.<kind>.residue`` gauge, ``residue_runs`` and a
once-per-kind warning that an under-budgeted ring is not converged
(:func:`reset_residue_warnings` re-arms it; a faulted run records the
gauge and never warns: its residue is injected loss).

- ``faults=`` (a ``faults.FaultPlan``) — the fault plane
  (:func:`run_delta_ring`'s docstring): the ring over the live ranks, a
  checksum lane on every packet (K3's chained ``chk`` on the fused wire),
  the fates of a table built before the first round, the held packet of a
  delayed link, and the ``FaultCounters`` as the last output.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from .. import telemetry as tele
from .._dtypes import bits, from_wide, to_wide, umax
from ..delta_opt import ackwin as _ackwin
from ..faults import inject as flt
from ..faults.integrity import checksum
from ..obs import hist as _hist
from ..ops import wire_kernels as _wk
from ..ops.lattice import tree_leaves, tree_map
from ..utils.metrics import metrics, state_nbytes
from . import wire as _wire
from .anti_entropy import (
    _consume, _donation, _tel_reduced, _write_back, local_folds, rank_blocks,
)
from .collectives import permuter, pmax, psum
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


class RingTelemetry:
    """The δ ring's in-loop sidecar, the JAX ring's telemetry carry: per
    rank (``[P]``) float32 wire, useful and packed byte counters and
    histograms, plus the changed-slot count, all device tensors. A round
    calls :meth:`begin`, :meth:`sent`, :meth:`acked` (ack window only),
    :meth:`applied` and :meth:`end`, in the JAX body's order, so each
    float32 sum runs in the JAX order; :meth:`telemetry` reduces over the
    ranks once, after the ring. The histograms count in int64 while the
    ring runs (one scatter-add an observation) and narrow to the u32
    planes at the end."""

    def __init__(self, p: int, device, slots_fn: Callable, slot_price: float = 0.0):
        f32 = lambda: torch.zeros((p,), dtype=torch.float32, device=device)  # noqa: E731
        h = lambda: _hist.Hist(torch.zeros((p, _hist.NBUCKETS), dtype=torch.int64,  # noqa: E731
                                           device=device), f32())
        self.p, self.slots_fn, self.slot_price = p, slots_fn, slot_price
        self.slots = torch.zeros((), dtype=torch.int64, device=device)
        self.shipped, self.useful, self.packed, self.skip = f32(), f32(), f32(), f32()
        self.hresid, self.huseful, self.hpacked, self.hack = h(), h(), h(), h()
        self._u0 = self._w0 = None
        _hist.bucket_index(torch.zeros((), device=device))  # the edges' one copy, before a round

    def begin(self) -> None:
        self._u0, self._w0 = self.useful, self.packed

    def sent(self, backlog, wire_bytes: int, useful, packed_words=None, covered=None,
             chk_bytes: int = 0) -> None:
        """One round's packet on the wire: the backlog after the extract
        (``[P]``), one link's static wire bytes, each rank's useful bytes,
        and (fused) K3's nonzero-word counts; ``covered`` the slots the
        ack window masked; ``chk_bytes`` the checksum lane of a faulted
        run (4: useful, and one packed word)."""
        self.hresid = _hist.observe_lanes(self.hresid, backlog)
        if covered is not None:
            self.skip = self.skip + covered.sum(dim=-1, dtype=torch.float32) * self.slot_price
        self.shipped = self.shipped + float(wire_bytes)
        self.useful = self.useful + useful
        if chk_bytes:
            self.useful = self.useful + float(chk_bytes)
        if packed_words is not None:
            words = to_wide(packed_words) + (chk_bytes // 4)
            self.packed = self.packed + 4.0 * words.to(torch.float32)

    def acked(self, ack_bytes: int, words, depth) -> None:
        """The ack lane of one round: its static bytes per link, the
        received ack words (fused: their nonzero words go on the packed
        count; None on the layered wire) and each rank's window depth."""
        self.shipped = self.shipped + float(ack_bytes)
        self.useful = self.useful + float(ack_bytes)
        if words is not None:
            self.packed = self.packed + 4.0 * (bits(words) != 0).sum(dim=-1).to(torch.float32)
        self.hack = _hist.observe_lanes(self.hack, depth)

    def applied(self, before, after) -> None:
        self.slots = self.slots + to_wide(self.slots_fn(before, after))

    def end(self, fused: bool) -> None:
        self.huseful = _hist.observe_lanes(self.huseful, self.useful - self._u0)
        if fused:
            self.hpacked = _hist.observe_lanes(self.hpacked, self.packed - self._w0)

    def digest(self, dig_bytes: int) -> None:
        """The digest exchange rides the wire once."""
        self.shipped = self.shipped + float(dig_bytes)
        self.useful = self.useful + float(dig_bytes)

    def telemetry(self, folded, merges_per_rank: int, residue, fused: bool, awin=None):
        """The mesh-wide Telemetry of the run (``folded``: the closed
        ``[P, ...]`` rows)."""
        tel = _tel_reduced(folded, tele.scalar("slots_changed", self.slots, self.slots.device),
                           merges_per_rank, self.shipped, self.p, residue=residue,
                           useful_per_rank=self.useful)
        psum = lambda h: _hist.psum(h._replace(  # noqa: E731
            counts=from_wide(h.counts, torch.uint32)))
        tel = tel._replace(hist_residue=psum(self.hresid), hist_useful_bytes=psum(self.huseful))
        if fused:
            tel = tel._replace(wire_packed_bytes=self.packed.sum(),
                               hist_packed_bytes=psum(self.hpacked))
        if awin is not None:
            tel = tel._replace(
                bytes_acked_skipped=self.skip.sum(),
                ack_window_depth=tele.scalar("ack_window_depth",
                                             _ackwin.window_depth(awin).max(), self.slots.device),
                hist_ack_depth=psum(self.hack))
        return tel


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
    wal_kind: Optional[str] = None,   # merge kind the δ records decompose under
    fused: bool = True,
    stats: Optional[dict] = None,
    template: Callable = _packet_template,  # (folded [P, ...], cap, fctx dtype) -> packet
    slots_fn: Optional[Callable] = None,    # (before, after) -> u32 changed lanes
    top_of: Callable = lambda s: s.top,     # state -> its top clock (a nest's is its leaf's)
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
    link's layered ``DeltaPacket``), fused ``wire_bytes`` (one link's
    ``WirePacket``) — shapes are static, so both are per link-round — and,
    with ``ack_window=``, ``slots_acked_skipped`` (slots the window
    masked, all links and rounds; times ``ackwin.slot_bytes`` it is the
    JAX ring's ``bytes_acked_skipped``) and ``ack_bytes`` (one link's ack
    lane per round). The counts stay on the device until this read.

    ``telemetry=True`` appends the run's Telemetry as a fifth output
    (:class:`RingTelemetry`; ``slots_fn`` counts a round's changed
    lanes, ``telemetry.generic_slots_changed`` by default), recorded under
    ``kind``.

    ``faults=`` (a ``faults.FaultPlan``) runs the ring over the plan's
    live ranks with a checksum lane on every packet (fused: the digest
    chained from K3's in-pass partials; layered: ``integrity.checksum`` of
    the packet) and the plan's fates, looked up in a table built and
    uploaded before the first round: each receiver corrupts what its link
    corrupts, verifies, applies and deselects the apply where the packet
    was dropped, rejected or held (``torch.where``, no host branch); a
    delayed packet lands the next round, or in the epilogue. Lost packets
    force ``residue >= 1`` and keep each rank's own top (evicted ranks
    never adopt, and their tops stay out of the live maximum). The
    :class:`~crdt_tpu_torch.faults.FaultCounters` come back as the LAST
    output, recorded under the ``faults.*`` names; the Telemetry's
    ``faults_*`` fields carry them too."""
    t0 = time.perf_counter()
    if wal is not None and wal_kind is None:
        raise ValueError("wal= needs wal_kind= (the merge kind δ records decompose under)")
    if fused and kind not in _wire.WIRE_SURFACES:
        raise NotImplementedError(
            f"run_delta_ring: fused=True needs a wire codec for {kind!r}; the registered "
            f"codecs are {sorted(_wire.WIRE_SURFACES)}"
        )
    p = mesh.p
    gated = digest and gate is not None
    acked = bool(ack_window)
    faulted = faults is not None
    delay_mode = faulted and faults.delay > 0
    win = (p - 1) if not pipeline else max(2 * (p - 1) - 1, 0)
    if rounds is None:
        rounds = win
    evicted = faults.evicted if faulted else ()
    # Digest exchange and acks run against the ring: rank i's packets land
    # on i+1, so i needs i+1's frozen top and i+1's acks. A faulted ring
    # runs over the live ranks (evicted ranks self-loop).
    shift = permuter(flt.ring_perm(p, evicted), p, mesh.device)
    unshift = permuter(flt.inv_ring_perm(p, evicted), p, mesh.device)
    aliasable = _donation(state, mesh, donate)
    caller = (state, dirty)

    blocks = rank_blocks(state, mesh)
    if wal is not None and wal.tail is None:
        # The diff base, before the run: a donating run consumes the input.
        wal.attach(tree_map(lambda x: x.reshape(-1, *x.shape[2:]), blocks))
    metrics.count(f"anti_entropy.{kind}_rounds", rounds)
    metrics.observe("anti_entropy.state_bytes", state_nbytes(blocks))
    t_run = time.perf_counter()
    rl = tree_leaves(blocks)[0].shape[1]
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
    rtop = unshift(top_of(folded)) if gated else None
    if faulted:
        # The whole run's fates, drawn and uploaded before the first round.
        fates = flt.LinkFates(faults, rounds, p, mesh.device)
        fc = flt.zero_counters(p, mesh.device)
        # The checksum word rides every packet (one u32 per link).
        chk_bytes = 4
    else:
        chk_bytes = 0

    counts = {"shipped": torch.zeros((), dtype=torch.int64, device=mesh.device),
              "deferred": torch.zeros((), dtype=torch.int64, device=mesh.device),
              "skipped": torch.zeros((), dtype=torch.int64, device=mesh.device)}
    tmpl = template(folded, cap, fctx.dtype)
    n_rows = d.shape[-1]
    rt = RingTelemetry(p, mesh.device, slots_fn or tele.generic_slots_changed,
                       _ackwin.slot_bytes(tmpl) if acked else 0.0) if telemetry else None
    if acked:
        awin = _ackwin.init_window(tmpl, n_rows, batch=(p,), device=mesh.device)
    if fused:
        codec = _wire.WireCodec(tmpl, n_rows, _wire.WIRE_SURFACES[kind], gated=gated,
                                acked=acked)
        # The receiver's mirror of its up-ring sender's window ctx.
        mctx = mctx_prev = torch.zeros((p, n_rows, codec.a), dtype=codec.ct, device=mesh.device) \
            if acked else None

        def send(pkt, aw):
            wired, aux = codec.pack(pkt, rtop=rtop, win=aw)
            counts["shipped"] += aux.keep.sum()
            counts["deferred"] += aux.defer.sum()
            if acked:
                counts["skipped"] += aux.covered.sum()
            sent = codec.mask(pkt, aux.keep) if acked else None
            useful = codec.useful_bytes(pkt, aux.keep) if telemetry else None
            # K3's chained checksum is the integrity lane of a faulted run.
            chk = shift(aux.checksum) if faulted else None
            return shift(wired), chk, aux, sent, useful, aux.covered if acked else None

        def receive(wired, st, mirror):
            return codec.unpack(wired, own_top=top_of(st) if gated else None, mirror_ctx=mirror)
    else:
        def send(pkt, aw):
            covered = None
            if gated:
                pkt = gate(pkt, rtop)
            if aw is not None:
                # Layering: the digest gate fired first; the window masks
                # what the peer has positively confirmed, removals too.
                pkt, covered = _ackwin.gate_window(pkt, aw)
                counts["skipped"] += covered.sum()
            counts["shipped"] += _ackwin._core(pkt).valid.sum()
            chk = shift(checksum(pkt, batch_dims=1)) if faulted else None
            wired = shift(pkt)
            # The JAX layered ring prices the packet each rank receives.
            useful = tele.packet_useful_bytes(wired, batch_dims=1) if telemetry else None
            return wired, chk, None, pkt, useful, covered

        def receive(wired, st, mirror):
            return wired

    def ack_exchange(sent, rcvd, keep):
        """Back-propagate the applied packet's per-slot confirmation one
        inverse hop (a u32 bitmap on the fused wire) and promote the
        sender's own shipped copy into its window (a faulted run acks
        only what it joined)."""
        acks = _ackwin.ack_bits(rcvd, keep)
        words = None
        if fused:
            words = unshift(_wk.pack_bits(acks))
            counts.setdefault("ack_bytes", _nbytes(words))
            acks = _wk.unpack_bits(words, acks.shape[-1])
        else:
            acks = unshift(acks)
            counts.setdefault("ack_bytes", _nbytes(acks))
        _ackwin.update_window(awin, sent, acks)
        if telemetry:
            rt.acked(counts["ack_bytes"], words, _ackwin.window_depth(awin))

    def out_step(pkt, d, aw):
        """Put one extracted packet on the wire: re-mark its deferred
        slots (fused) before the backlog count. Returns the wire (with its
        checksum lane when faulted), the tracking, the parked loss and
        the sender's shipped copy."""
        wired, chk, aux, sent, useful, covered = send(pkt, aw)
        if "packet_bytes" not in counts:
            counts["packet_bytes"], counts["wire_bytes"] = _nbytes(pkt), _nbytes(wired)
        lost = torch.zeros((p,), dtype=torch.int32, device=mesh.device)
        if fused:
            d = _wire.remark_deferred(d, _wire.core_idx(pkt), aux.defer)
            lost = aux.parked_lost
        if telemetry:
            rt.sent(d.sum(dim=-1), _nbytes(wired) + chk_bytes, useful,
                    packed_words=aux.packed_words if fused else None, covered=covered,
                    chk_bytes=chk_bytes)
        return (wired, chk), d, lost, sent

    held = heldv = None

    def merge(r, flight, st, d, f, of, mirror, final=False):
        """Round ``r``'s delivery at each receiver: the faulted wire (fates,
        corruption, verify), the decode, the held packet of a delayed
        link, then the apply — deselected where the packet did not land.
        Returns the new rows, tracking, overflow, the decoded packet and
        its keep mask (None on a reliable ring)."""
        nonlocal fc, held, heldv
        wired, chk = flight
        keep = fts = None
        if faulted:
            wired, keep, fts = flt.receive_wire(fates, r, wired, chk,
                                                delay_ok=delay_mode and not final)
        rcvd = receive(wired, st, mirror)
        if held is not None:
            # The one-round-late link buffer lands (delay faults).
            st, d, f, of = _select_apply(apply_fn(st, held, d, f), (st, d, f), of, heldv)
        if not faulted:
            st, d, f, of_r = apply_fn(st, rcvd, d, f)
            return st, d, f, of | of_r, rcvd, None
        st, d, f, of = _select_apply(apply_fn(st, rcvd, d, f), (st, d, f), of, keep)
        fc = flt.tick_counters(fc, fts)
        fc = fc[:4] + (fc[4] + (fts[0] | fts[1]),)
        if delay_mode and not final:
            # The held packet of a delayed link (only a rank whose link
            # delayed it applies it next round; the rest is deselected).
            held, heldv = rcvd, fts[2]
        return st, d, f, of, rcvd, keep[:, None]

    starved = torch.zeros((p,), dtype=torch.int64, device=mesh.device)
    nlost = torch.zeros((p,), dtype=torch.int32, device=mesh.device)
    if pipeline and rounds > 0:
        # Prologue: round 0's packet goes in flight before the loop; the
        # round-0 window is empty, so nothing is masked and the receiver's
        # round-0 mirror matches by construction.
        if telemetry:
            rt.begin()
        pkt, d, f = extract(folded, d, f, cap, start=0)
        flight, d, nlost, sent = out_step(pkt, d, awin if acked else None)
        if telemetry:
            rt.end(fused)
        if 0 >= rounds - win:
            starved = starved + d.sum(dim=-1)
        for r in range(rounds - 1):
            # Extract round r+1's packet from the pre-apply state and put
            # it in flight (against the current window), then merge round
            # r's in-flight packet, decoded with the mirror from before the
            # last promotion.
            if telemetry:
                rt.begin()
            pkt, d, f = extract(folded, d, f, cap, start=(r + 1) * cap)
            nxt, d, lost, sent_nxt = out_step(pkt, d, awin if acked else None)
            nlost = nlost + lost
            if (r + 1) >= rounds - win:
                starved = starved + d.sum(dim=-1)
            before = folded
            folded, d, f, of, rcvd, keep = merge(
                r, flight, folded, d, f, of, mctx_prev if fused and acked else None)
            if acked:
                # The ack is for the packet applied this round, shipped
                # last round: the window lags one round more, like
                # knowledge itself.
                if fused:
                    mctx_prev, mctx = mctx, _wire.mirror_promote(
                        mctx, rcvd, _ackwin.ack_bits(rcvd, keep))
                ack_exchange(sent, rcvd, keep)
                sent = sent_nxt
            if telemetry:
                rt.applied(before, folded)
                rt.end(fused)
            flight = nxt
        before = folded
        folded, d, f, of, _, _ = merge(rounds - 1, flight, folded, d, f, of,
                                       mctx_prev if fused and acked else None, final=True)
        if telemetry:
            rt.applied(before, folded)
    else:
        for r in range(rounds):
            if telemetry:
                rt.begin()
            pkt, d, f = extract(folded, d, f, cap, start=r * cap)
            wired, d, lost, sent = out_step(pkt, d, awin if acked else None)
            nlost = nlost + lost
            if r >= rounds - win:
                starved = starved + d.sum(dim=-1)
            # The mirror before this round's promotion matches the
            # sender's encode state.
            before = folded
            folded, d, f, of, rcvd, keep = merge(r, wired, folded, d, f, of,
                                                 mctx if fused and acked else None)
            if acked:
                if fused:
                    mctx = _wire.mirror_promote(mctx, rcvd, _ackwin.ack_bits(rcvd, keep))
                ack_exchange(sent, rcvd, keep)
            if telemetry:
                rt.applied(before, folded)
                rt.end(fused)
        if held is not None:
            # A packet still held when the loop ends arrives now (one round
            # late past the ring's edge, not lost).
            folded, d, f, of = _select_apply(apply_fn(folded, held, d, f), (folded, d, f), of,
                                             heldv)

    if telemetry and gated:
        rt.digest(_nbytes(rtop))
    own_top = top_of(folded)
    if fused:
        # Unencodable parked removes never reached the wire: count them as
        # loss mesh-wide and keep each rank's own top if any was lost.
        nlost_tot = psum(nlost)
    if faulted:
        # Adopt the live ranks' top only when the run lost nothing:
        # adoption after loss would claim observed-and-removed for dots a
        # receiver never got. Evicted ranks never adopt and stay out of
        # the live maximum.
        ev = fates.evicted.reshape(p, *([1] * (own_top.dim() - 1)))
        live_top = pmax(from_wide(torch.where(ev, 0, to_wide(own_top)), own_top.dtype))
        lost_tot = psum(fc[4])
        adopt = (lost_tot == 0) & ~fates.evicted
        if fused:
            adopt = adopt & (nlost_tot == 0)
        top = flt.tree_select(adopt, bits(live_top).expand(own_top.shape).view(own_top.dtype),
                              own_top)
    else:
        top_all = bits(pmax(own_top)).expand(own_top.shape).view(own_top.dtype)
        if fused:
            top = torch.where(nlost_tot == 0, bits(top_all), bits(own_top)).view(own_top.dtype)
        else:
            top = top_all.contiguous()
    folded = close_top(folded, top)
    overflow = torch.any(of, dim=0)
    residue = psum(starved)
    if faulted:
        # Lost packets void the certificate: a degraded run must never
        # read as certified.
        residue = torch.maximum(residue, (lost_tot > 0).to(residue.dtype))
    if fused:
        residue = torch.maximum(residue, (nlost_tot > 0).to(residue.dtype))
    if rounds < win:
        residue = torch.clamp_min(residue, 1)
    if faulted:
        counters = flt.finish_counters(fc)
    if telemetry:
        tel = rt.telemetry(folded, max(rl - 1, 0) + rounds, residue, fused,
                           awin if acked else None)
        if faulted:
            tel = tel._replace(faults_dropped=counters.packets_dropped,
                               faults_rejected=counters.packets_rejected,
                               faults_delayed=counters.packets_delayed)
    if donate:
        if aliasable:
            folded, d = _write_back(caller, (folded, d))
        _consume(caller, keep=(folded, d))
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    metrics.observe(f"anti_entropy.{kind}_seconds", time.perf_counter() - t_run)
    # The one host read of the run's counts (never inside a round). A
    # faulted run's residue is forced by design: it records the gauge
    # but never warns about the budget.
    _warn_residue(kind, int(residue), warn=not faulted)
    if wal is not None:
        # The host-side durability append, after the run.
        b0, f0 = wal.bytes_appended, wal.fsyncs
        with metrics.time("durability.wal_append"):
            wal.append_state(wal_kind, folded)
            wal.mark_round()
        if telemetry:
            tel = tele.fill(tel, wal_bytes=wal.bytes_appended - b0, wal_fsyncs=wal.fsyncs - f0)
    if stats is not None:
        stats.update(
            rounds=rounds, links=p, slots_shipped=int(counts["shipped"]),
            slots_deferred=int(counts["deferred"]), parked_lost=int(nlost.sum()),
            packet_bytes=counts.get("packet_bytes", 0),
        )
        if fused:
            stats["wire_bytes"] = counts.get("wire_bytes", 0)
        if acked:
            stats["slots_acked_skipped"] = int(counts["skipped"])
            stats["ack_bytes"] = counts.get("ack_bytes", 0)
    if acked:
        metrics.count("delta_opt.ack_window_runs")
    if fused:
        metrics.count("wire.fused_runs")
    out = (folded, d, overflow, residue.to(torch.int32))
    if telemetry:
        d_tel = tele.to_dict(tel)
        if acked:
            metrics.count("delta_opt.acked_skipped", int(d_tel["bytes_acked_skipped"]))
            metrics.count(f"delta_opt.acked_skipped.{kind}", int(d_tel["bytes_acked_skipped"]))
        if fused:
            # The registry twins of the packed-bytes counter.
            metrics.count("wire.packed_bytes", int(d_tel["wire_packed_bytes"]))
            metrics.count(f"wire.packed_bytes.{kind}", int(d_tel["wire_packed_bytes"]))
        out = (*out, tele.finish_dispatch(kind, tel, t0))
    if faulted:
        flt.record(counters)
        out = (*out, counters)
    return out


def _select_apply(applied, prior, of, keep):
    """Keep an apply's outputs only on the ranks where ``keep`` holds (the
    packet landed): the rows, dirty marks and contexts of the others stay
    as they were, and their overflow does not count."""
    st2, d2, f2, of_r = applied
    st, d, f = flt.tree_select(keep, (st2, d2, f2), prior)
    return st, d, f, of | (of_r & keep.reshape(-1, *([1] * (of_r.dim() - 1))))


# Kinds whose residue warning already fired this process; repeats only
# count in the registry (see _warn_residue).
_RESIDUE_WARNED: set = set()


def reset_residue_warnings() -> None:
    """Re-arm the once-per-kind residue warning (tests; or after an
    operator fixed the budget and wants fresh signal)."""
    _RESIDUE_WARNED.clear()


def _warn_residue(kind: str, residue, warn: bool = True) -> None:
    """The ring's residue accounting on the host: the
    ``anti_entropy.<kind>.residue`` gauge on every run; a run with residue
    counts ``anti_entropy.<kind>.residue_runs`` and warns once per kind per
    process that the ring is not guaranteed converged. ``residue`` is an
    int, or a ring's result tuple (its fourth element). ``warn=False`` (a
    faulted run, whose residue is injected loss) records the gauge only."""
    if isinstance(residue, tuple):
        residue = residue[3]
    residue = int(residue)
    metrics.observe(f"anti_entropy.{kind}.residue", float(residue))
    if not residue or not warn:
        return
    metrics.count(f"anti_entropy.{kind}.residue_runs")
    if kind in _RESIDUE_WARNED:
        return
    _RESIDUE_WARNED.add(kind)
    import warnings

    warnings.warn(
        f"{kind}: round budget left residue ({residue} slot-starved row-rounds) — the "
        f"ring is NOT guaranteed converged; raise `rounds` (see the ROUNDS BUDGET note in "
        f"parallel/delta.py; pipeline=True budgets are ~2x) or `cap`. Warned once per "
        f"kind; repeats count in anti_entropy.{kind}.residue_runs",
        stacklevel=4,
    )


def delta_gossip_elastic(
    model,
    dirty: torch.Tensor,
    fctx: torch.Tensor,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    cap: int = 64,
    local_fold: str = "auto",
    policy=None,
    telemetry: bool = False,
    pipeline: bool = True,
    digest: bool = True,
    donate: bool = False,
    reclaim=None,
    faults=None,
    ack_window=False,
    wal=None,
    fused: bool = True,
    stats: Optional[dict] = None,
):
    """δ-ring anti-entropy with elastic capacity recovery for dense ORSWOT
    replica batches (``BatchedOrswot``): when a run flags parked-buffer
    overflow its result is discarded (the δ entry never commits to the
    model), ``deferred_cap`` widens by ``policy.factor`` with the live
    state re-encoded on the device (``elastic.widen``), and the ring
    re-enters with the SAME ``(dirty, fctx)`` — sound because the rejected
    run mutated nothing and the widened state is bit-identical to a
    wider-born one. The re-entered ring's ``residue == 0`` still certifies
    the full join.

    ``pipeline``/``digest``/``fused``/``ack_window`` thread into every
    attempt (each attempt starts a fresh ack window). ``donate=True``
    donates each attempt's ``(state, dirty)`` into the ring and restores
    ``model.state`` and ``dirty`` from a pre-round device copy afterwards,
    since a failed attempt needs the pre-round state. ``stats`` holds the
    last attempt's counts.

    ``wal=`` logs ONLY the committed attempt (a rejected overflowing run
    mutated nothing, so it must not reach the log either); the log's diff
    base is ``model.state`` when it has none, and a widen changes the
    shapes, which the log absorbs as a full-``state`` record
    (``Wal.append_state``'s fallback) — replay re-anchors there.

    Returns ``(states, dirty, overflow, residue, widened)``: the
    ``mesh_delta_gossip`` tuple plus the axes grown (empty when capacity
    sufficed); ``telemetry=True`` appends a Telemetry folded across every
    attempt (``telemetry.combine``).

    ``reclaim=`` takes an ``elastic.Hysteresis``, composing as in
    ``anti_entropy.gossip_elastic``: after the attempt that succeeds the
    rows are committed into the model, compacted on the host side against
    the committed rows' own frontier (``reclaim.compact_model``: the
    certified ring has no spare output for a frontier, and the batch is
    the replica set), and the tracker observes the model and narrows
    cleared axes in place. ``faults=`` threads a ``FaultPlan`` into every
    attempt; the LAST element is then the ``FaultCounters`` with the
    packet counts summed over the attempts (``faults.combine_counters``)."""
    from .. import elastic
    from .delta import mesh_delta_gossip

    if wal is not None and wal.tail is None:
        wal.attach(model.state)
    policy = policy or elastic.DEFAULT_POLICY
    widened: dict = {}
    migrations = 0
    tel = fcs = None
    while True:
        if donate:
            snap = tree_map(torch.clone, model.state)
            snap_dirty = dirty.clone()
        out = mesh_delta_gossip(
            model.state, dirty, fctx, mesh, rounds, cap, local_fold, telemetry=telemetry,
            pipeline=pipeline, digest=digest, donate=donate, faults=faults,
            ack_window=ack_window, fused=fused, stats=stats,
        )
        if faults is not None:
            fcs = flt.accumulate_counters(fcs, out[-1])
            out = out[:-1]
        if telemetry:
            tel = out[4] if tel is None else tele.combine(tel, out[4])
        if donate:
            model.state, dirty = snap, snap_dirty
        if not bool(torch.any(out[2])):
            if reclaim is not None:
                from ..reclaim import compact_model
                from .anti_entropy import _commit_rows

                _commit_rows(model, out[0])
                compact_model(model)
                reclaim.observe(model)
            if wal is not None:
                # The committed attempt is the durable transition.
                wal.append_state("orswot", out[0])
                wal.mark_round()
            ret = (*out[:4], widened) + ((tel,) if telemetry else ())
            return ret + ((fcs,) if fcs is not None else ())
        if migrations >= policy.max_migrations:
            raise RuntimeError(
                f"δ ring still overflowing after {migrations} migrations (axes grown: "
                f"{widened}); raise policy.factor or max_migrations"
            )
        metrics.count("elastic.delta_migrations")
        widened.update(elastic.widen(model, ("deferred_cap",), policy))
        migrations += 1


__all__ = ["delta_gossip_elastic", "reset_residue_warnings", "run_delta_ring"]
