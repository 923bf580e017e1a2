"""The bit-packed δ wire format and the fused send path — counterpart of
the JAX package's ``parallel/wire.py`` for the dense ORSWOT, the
Map<K, MVReg> and the nested (``Map<K, Orswot>``, ``Map3``) flavors.

:class:`WireCodec` lowers a flavor's packet (``delta.DeltaPacket``,
``delta_map.MapDeltaPacket``) onto an all-u32 wire tree in one fused pass
over the slot clock lanes plus a second instance over the parked-remove
clocks, both in one launch (``ops.wire_kernels.wire_pack_many``: kernel
K3 on a card), and the receiver inverts it with plain torch. Wire layout
(``WirePacket``, every leaf u32, leaf order static):

    slots  [C, Ws]   slot clock lanes (dense: rows; map: wctr, clk) and
                     the ctxs last, as biased-u16 deltas against the link
                     watermark, two per word
    parked [D, Wp]   parked-remove clocks, same encoding (a nested packet:
                     every level's buffer, innermost first, in one
                     matrix)
    ids    [..]      slot indices and actor ids (map: wact) as u16 pairs
                     when the key universe and A are <= 2^16, else raw
    raws   [..]      unbounded non-clock lanes (map: the payload ``val``),
                     bit-cast, masked slots zeroed
    bits   [..]      every bool plane — slot validity, content validity
                     (map), parked masks and dvalid — as one u32 bitmap

A clock plane's watermark is the link's per-slot base in its column
layout: an A-wide plane takes the base itself, an S·A-wide plane (map
``clk``) the base tiled S times, the map's witness counters ``wctr`` the
base gathered at each slot's actor id ``wact``. Where every plane takes
the base itself and the base is one row per link (the dense flavor under
the digest), K3 reads it as that one row broadcast over the slots.

The watermark is the receiver's frozen digest top when ``digest=`` is on
(joined, under ``ack_window=``, with the link's acked window ctx at each
slot: the sender's ``AckWindow.ctx`` and the receiver's mirror of it,
:func:`mirror_promote`) and zero otherwise; both ends derive it from
knowledge they share, so the round trip is bit-exact. A slot outside the ±32 Ki window is DEFERRED: shipped
invalid and re-marked dirty before the round's backlog count
(:func:`remark_deferred`), so the residue certificate prices it. An
unencodable parked remove is wire LOSS: the ring forces ``residue >= 1``
and does not adopt the mesh top. The checksum (:func:`wire_checksum`)
chains K3's in-pass partials into ``faults.integrity.checksum`` of the
wire tree.

Every method takes packets with one leading batch axis (the ring's P
links) or none.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .._dtypes import bits, from_wide, to_wide
from ..delta_opt.ackwin import AckWindow, _content_names, _core
from ..faults.integrity import chain
from ..ops import wire_kernels as wk
from ..ops.lattice import tree_map
from .delta import mask_slots, put_rows, take_rows

_U16_SPAN = 65536


class WirePacket(NamedTuple):
    """The all-u32 wire tree (module docstring layout). Fields hold
    tuples so a flavor without a plane class contributes no leaf."""

    slots: Tuple[torch.Tensor, ...]
    parked: Tuple[torch.Tensor, ...]
    ids: Tuple[torch.Tensor, ...]
    raws: Tuple[torch.Tensor, ...]
    bits: Tuple[torch.Tensor, ...]


class WireAux(NamedTuple):
    """Sender-side byproducts of one fused pack."""

    keep: torch.Tensor          # [.., C] bool — slots on the wire
    defer: torch.Tensor         # [.., C] bool — narrow-deferred (re-mark dirty)
    covered: torch.Tensor       # [.., C] bool — ack verdicts
    parked_lost: torch.Tensor   # [..] int32 — unencodable parked slots
    packed_words: torch.Tensor  # [..] u32 — nonzero wire words
    checksum: torch.Tensor      # [..] u32 — integrity digest of the wire tree


# Leaf classes, decided by field name + shape (the JAX package's packet
# conventions).
(_CLOCK, _CTX, _PDCL, _ID, _RAW, _SLOTVALID, _CBOOL, _PVALID, _PBOOL) = range(9)
_PARKED_SUFFIXES = ("dcl", "dmask", "dkeys", "dvalid")


def _classify(name: str, shape, dtype) -> int:
    if name in ("idx", "wact"):
        return _ID
    if name == "ctxs":
        return _CTX
    if name.endswith("dcl"):
        return _PDCL
    if name.endswith("dvalid"):
        return _PVALID
    if name.endswith("dmask") or name.endswith("dkeys"):
        return _PBOOL
    if dtype == torch.bool:
        return _SLOTVALID if len(shape) == 1 else _CBOOL
    if name in ("rows", "wctr", "clk"):
        return _CLOCK
    return _RAW


def _named_leaves(tree, out=None):
    """Depth-first (field order) list of ``(field name, leaf)``."""
    if out is None:
        out = []
    for f in tree._fields:
        child = getattr(tree, f)
        if hasattr(child, "_fields"):
            _named_leaves(child, out)
        else:
            out.append((f, child))
    return out


def _rebuild(template, leaves):
    """A packet of ``template``'s (nested NamedTuple) structure from its
    leaves in :func:`_named_leaves` order."""
    it = iter(leaves)

    def build(node):
        return type(node)(*(build(getattr(node, f)) if hasattr(getattr(node, f), "_fields")
                            else next(it) for f in node._fields))

    return build(template)


class _Rec(NamedTuple):
    """One packet leaf's static plan row."""

    i: int
    name: str
    cls: int
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


class WireCodec:
    """The static pack/unpack plan for one flavor's packet template (one
    link's packet: leaves without the batch axis; ``torch.empty(...,
    device="meta")`` leaves will do). ``know_fn`` maps a packet to its
    per-slot knowledge clock ``[.., C, A]`` (the digest-gate subject)."""

    def __init__(self, template, n_rows: int, know_fn: Callable, gated: bool, acked: bool):
        self.n_rows = n_rows
        self.know_fn = know_fn
        self.gated = gated
        self.acked = acked
        core = _core(template)
        self.c = core.idx.shape[0]
        self.a = core.ctxs.shape[-1]
        self.ct = core.ctxs.dtype
        self.content_names = _content_names(core)
        self.template = template
        named = _named_leaves(template)
        self.records: List[_Rec] = [
            _Rec(i, name, _classify(name, tuple(leaf.shape), leaf.dtype), tuple(leaf.shape),
                 leaf.dtype)
            for i, (name, leaf) in enumerate(named)
        ]
        by_cls = lambda *cls: [r for r in self.records if r.cls in cls]  # noqa: E731
        self.clock_recs = by_cls(_CLOCK)
        self.ctx_rec = by_cls(_CTX)[0]
        self.id_recs = by_cls(_ID)
        self.raw_recs = by_cls(_RAW)
        self.bool_recs = by_cls(_SLOTVALID, _CBOOL, _PVALID, _PBOOL)
        self.parked_recs = by_cls(_PDCL)
        self.pvalid_recs = by_cls(_PVALID)

        # Slot clock matrix columns: content planes in walk order, the
        # ctx plane last (the kernel's [ctx_lo, ctx_hi) range).
        cols = 0
        self.clock_cols: List[Tuple[int, int]] = []
        for r in self.clock_recs:
            n = _numel(r.shape) // self.c
            self.clock_cols.append((cols, cols + n))
            cols += n
        self.ctx_lo, self.ctx_hi = cols, cols + self.a
        self.lc = cols + self.a
        # The dense gate's subject (know_dense) is the rows plane: K3 reads
        # it in place, as that column range of the slot matrix.
        self.rows_cols = dict(zip((r.name for r in self.clock_recs), self.clock_cols)).get("rows")
        # Witness counters take their base at the slot's actor id; with
        # none, every plane takes the base itself or tiles it.
        self.gathered = "wctr" in {r.name for r in self.clock_recs} and any(
            r.name == "wact" for r in self.id_recs)

        # Parked groups: prefix -> row offset in the concatenated parked
        # matrix, in walk order.
        self.pd = 0
        self.pgroup_row = {}
        for r in self.parked_recs:
            self.pgroup_row[r.name[: -len("dcl")]] = self.pd
            self.pd += r.shape[0]

        self.n_bits = sum(_numel(r.shape) for r in self.bool_recs)
        # u16 ids need their static bound proven: slot indices by the row
        # universe. A wider universe ships ids raw.
        self.narrow_ids = n_rows <= _U16_SPAN and self.a <= _U16_SPAN
        self.slot_spec = wk.WireLaneSpec(
            lc=self.lc, ctx_lo=self.ctx_lo, ctx_hi=self.ctx_hi, gated=gated, acked=acked,
        )
        self.parked_spec = wk.WireLaneSpec(lc=self.a, parked=True)

        # Static byte prices (telemetry.packet_useful_bytes' group sums).
        parked_cls = (_PDCL, _PVALID, _PBOOL)
        self.slot_price = sum(
            (_numel(r.shape) // self.c) * r.dtype.itemsize
            for r in self.records if r.cls not in parked_cls
        )
        self.parked_prices = {}
        for pref in self.pgroup_row:
            group = [r for r in self.records
                     if r.name in tuple(pref + s for s in _PARKED_SUFFIXES)]
            d = group[0].shape[0]
            self.parked_prices[pref] = (
                d, sum((_numel(r.shape) // d) * r.dtype.itemsize for r in group))

    # ---- shared base/watermark derivation --------------------------------

    def _slot_base(self, idx, rtop, mctx):
        """The slot watermark (wide): acked-window ctx (when on) joined
        with the digest top (when gated), zero otherwise — ``[B, C, A]``
        with the ack window, else one row per link, ``[B, 1, A]``."""
        base = torch.zeros((idx.shape[0], 1, self.a), dtype=torch.int64, device=idx.device)
        if self.gated and rtop is not None:
            base = torch.maximum(base, to_wide(rtop)[:, None, :])
        if self.acked and mctx is not None:
            base = torch.maximum(base, to_wide(take_rows(mctx, idx)))
        return base

    def _base_matrix(self, basemat, wact2=None):
        """Per-lane bases ``[B, C, LC]`` in the slot matrix's column
        layout, from the watermark ``basemat [B, 1 or C, A]``: an A-wide
        plane takes it, a wider plane of whole A-blocks tiles it, witness
        counters ``wctr`` gather it at the actor ids ``wact2 [B, C, S]``,
        any other plane takes 0; the ctx plane takes it last. A per-link
        watermark with no gathered plane stays one stored row, broadcast
        over the slots; otherwise the matrix is materialised."""
        src = basemat.expand(-1, self.c, -1) if self.gathered else basemat
        bases = []
        for r, (lo, hi) in zip(self.clock_recs, self.clock_cols):
            n = hi - lo
            if r.name == "wctr" and self.gathered:
                bases.append(torch.gather(src, -1, wact2.long()))
            elif n % self.a == 0:
                bases.append(src.repeat(1, 1, n // self.a))
            else:
                bases.append(src.new_zeros((*src.shape[:2], n)))
        return _narrow(torch.cat(bases + [src], dim=-1), self.ct).expand(-1, self.c, -1)

    def _wact2(self, leaves, b):
        """The slot actor ids ``[B, C, S]`` the gathered bases read (None
        without a gathered plane)."""
        if not self.gathered:
            return None
        r = next(r for r in self.id_recs if r.name == "wact")
        return leaves[r.i].reshape(b, self.c, -1)

    def _parked_base(self, rtop, lead, device):
        """The parked instance's watermark ``[B, PD, A]``: the link's
        digest top (or zero), one row broadcast over the parked slots."""
        if self.gated and rtop is not None:
            row = bits(rtop)[:, None, :]
        else:
            row = torch.zeros((lead, 1, self.a), dtype=_signed(self.ct), device=device)
        return row.expand(lead, self.pd, self.a).view(self.ct)

    # ---- sender ----------------------------------------------------------

    def slot_inputs(self, pkt, rtop=None, win: Optional[AckWindow] = None) -> dict:
        """The slot K3 instance's arguments for a batched packet: ``spec,
        clocks, base, valid`` and ``know``/``dig`` (gated) or
        ``winc``/``ack_ok`` (acked)."""
        leaves = [leaf for _, leaf in _named_leaves(pkt)]
        core = _core(pkt)
        idx = core.idx
        b = idx.shape[0]
        mctx = win.ctx if win is not None else None
        basemat = self._slot_base(idx, rtop, mctx)
        clocks = torch.cat(
            [bits(leaves[r.i]).reshape(b, self.c, hi - lo)
             for r, (lo, hi) in zip(self.clock_recs, self.clock_cols)]
            + [bits(leaves[self.ctx_rec.i]).reshape(b, self.c, self.a)],
            dim=-1,
        ).view(self.ct)
        base = self._base_matrix(basemat, self._wact2(leaves, b))
        out = dict(spec=self.slot_spec, clocks=clocks, base=base, valid=core.valid.contiguous())
        if self.gated:
            if self.know_fn is know_dense and self.rows_cols is not None:
                out["know"] = clocks[..., self.rows_cols[0]:self.rows_cols[1]]
            else:
                out["know"] = self.know_fn(pkt).contiguous()
            out["dig"] = bits(rtop)[:, None, :].expand(b, self.c, self.a).view(self.ct)
        if self.acked:
            out["winc"], same_rest = self._win_matrix(win, idx, leaves)
            out["ack_ok"] = (torch.gather(win.ackd, -1, idx.long()) & same_rest).contiguous()
        return out

    def parked_inputs(self, pkt, rtop=None) -> dict:
        """The parked K3 instance's arguments for a batched packet: the
        parked clock planes concatenated over the levels, against the
        digest watermark, and their validity."""
        leaves = [leaf for _, leaf in _named_leaves(pkt)]
        b = _core(pkt).idx.shape[0]
        pcl = torch.cat([bits(leaves[r.i]).reshape(b, -1, self.a) for r in self.parked_recs],
                        dim=1).view(self.ct)
        pvalid = torch.cat([leaves[r.i] for r in self.pvalid_recs], dim=-1)
        return dict(spec=self.parked_spec, clocks=pcl,
                    base=self._parked_base(rtop, b, pcl.device), valid=pvalid.contiguous())

    def pack(self, pkt, rtop=None, win: Optional[AckWindow] = None):
        """One fused pass from the flavor packet to the wire tree.
        ``rtop`` is the receiver's frozen digest top ``[.., A]``
        (``digest=``), ``win`` the link's ack window. Returns
        ``(WirePacket, WireAux)``."""
        batched = _core(pkt).idx.dim() == 2
        if not batched:
            pkt, rtop, win = _add_batch(pkt), _add_batch(rtop), _add_batch(win)
        wire, aux = self._pack(pkt, rtop, win)
        if not batched:
            wire, aux = _drop_batch(wire), _drop_batch(aux)
        return wire, aux

    def _pack(self, pkt, rtop, win):
        leaves = [leaf for _, leaf in _named_leaves(pkt)]
        b = _core(pkt).idx.shape[0]
        # The slot and parked instances in one launch; an unencodable
        # valid parked slot is wire loss.
        parked = self.parked_inputs(pkt, rtop)
        pvalid = parked["valid"]
        out, pout = wk.wire_pack_many([self.slot_inputs(pkt, rtop, win), parked])
        pvalid_wire = pvalid & ~pout.defer

        def slotmask(leaf):
            return mask_slots(out.keep, leaf.reshape(b, self.c, -1)).reshape(b, -1)

        ids = []
        for r in self.id_recs:
            # Masked/invalid slots ship zero ids; the receiver fills them
            # with distinct no-op indices (fill_invalid_idx).
            flat = slotmask(leaves[r.i])
            ids.append(wk.pack_u16_pairs(flat) if self.narrow_ids
                       else flat.to(torch.int32).view(torch.uint32))
        raws = [slotmask(leaves[r.i]).view(torch.uint32) for r in self.raw_recs]
        flags = []
        for r in self.bool_recs:
            x = leaves[r.i]
            if r.cls == _SLOTVALID:
                x = out.keep
            elif r.cls == _CBOOL:
                x = slotmask(x)
            elif r.cls == _PVALID:
                lo = self.pgroup_row[r.name[: -len("dvalid")]]
                x = pvalid_wire[:, lo:lo + r.shape[0]]
            else:  # parked masks: zero the rows whose slot left the wire
                pref = r.name[: -len("dmask")] if r.name.endswith("dmask") else r.name[: -len("dkeys")]
                lo = self.pgroup_row[pref]
                sel = pvalid_wire[:, lo:lo + r.shape[0]]
                x = x & sel.reshape(b, r.shape[0], *([1] * (x.dim() - 2)))
            flags.append(x.reshape(b, -1))
        wire = WirePacket(slots=(out.words,), parked=(pout.words,), ids=tuple(ids),
                          raws=tuple(raws), bits=(wk.pack_bits(torch.cat(flags, dim=-1)),))

        nnz = to_wide(out.nnz) + to_wide(pout.nnz)
        for x in list(ids) + raws + list(wire.bits):
            nnz = nnz + (bits(x) != 0).sum(dim=-1)
        aux = WireAux(
            keep=out.keep, defer=out.defer, covered=out.covered,
            parked_lost=(pvalid & pout.defer).sum(dim=-1).to(torch.int32),
            packed_words=from_wide(nnz & 0xFFFFFFFF, torch.uint32),
            checksum=wire_checksum(wire, {0: out.chk, 1: pout.chk}, batch_dims=1),
        )
        return wire, aux

    def _win_matrix(self, win: AckWindow, idx, leaves):
        """The ack verdict's inputs: the window's confirmed content planes
        gathered at ``idx`` in the clock columns + its ctx in the ctx
        columns, and the one-bool-per-slot equality of the non-clock
        content lanes (map: ids, payload, content validity)."""
        core = _core(self.template)
        by_name = {}
        for f, rows in zip(self.content_names, win.rows):
            node = getattr(core, f)
            if hasattr(node, "_fields"):
                for (n, _), v in zip(_named_leaves(node), rows):
                    by_name.setdefault(n, []).append(v)
            else:
                by_name.setdefault(f, []).append(rows)
        b = idx.shape[0]
        cols = [bits(take_rows(by_name[r.name].pop(0), idx)).reshape(b, self.c, hi - lo)
                for r, (lo, hi) in zip(self.clock_recs, self.clock_cols)]
        cols.append(bits(take_rows(win.ctx, idx)))
        winc = torch.cat(cols, dim=-1).view(self.ct)
        same = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        for r in self.records:
            vals = by_name.get(r.name)
            if not vals or r.cls in (_CLOCK, _CTX):
                continue
            w = bits(take_rows(vals.pop(0), idx)).reshape(b, self.c, -1)
            same = same & torch.all(w == bits(leaves[r.i]).reshape(b, self.c, -1), dim=-1)
        return winc, same

    # ---- receiver --------------------------------------------------------

    def unpack(self, wire: WirePacket, own_top=None, mirror_ctx=None):
        """Invert :meth:`pack` with the receiver's copy of the watermark —
        its own frozen top (≡ the digest the sender held) and its ack
        mirror ctx. Returns the flavor packet, bit-identical to the
        sender's gated/masked packet."""
        batched = wire.slots[0].dim() == 3
        if not batched:
            wire, own_top, mirror_ctx = (
                _add_batch(wire), _add_batch(own_top), _add_batch(mirror_ctx))
        pkt = self._unpack(wire, own_top, mirror_ctx)
        return pkt if batched else _drop_batch(pkt)

    def _unpack(self, wire: WirePacket, own_top, mirror_ctx):
        leaves = [None] * len(self.records)
        b = wire.slots[0].shape[0]
        flat = wk.unpack_bits(wire.bits[0], self.n_bits)
        off = 0
        keep = None
        pvalid_parts = []
        for r in self.bool_recs:
            n = _numel(r.shape)
            x = flat[:, off:off + n].reshape(b, *r.shape)
            off += n
            leaves[r.i] = x
            if r.cls == _SLOTVALID:
                keep = x
            if r.cls == _PVALID:
                pvalid_parts.append(x)
        for k, r in enumerate(self.id_recs):
            w = wire.ids[k]
            vals = (wk.unpack_u16_pairs(w, _numel(r.shape), r.dtype) if self.narrow_ids
                    else bits(w).to(r.dtype))
            vals = vals.reshape(b, *r.shape)
            if r.name == "idx":
                vals = fill_invalid_idx(vals, keep, self.n_rows)
            leaves[r.i] = vals
        for k, r in enumerate(self.raw_recs):
            leaves[r.i] = wire.raws[k].view(r.dtype).reshape(b, *r.shape)
        idx = leaves[self.id_recs[0].i]  # idx walks first by convention
        base = self._base_matrix(self._slot_base(idx, own_top, mirror_ctx),
                                 self._wact2(leaves, b))
        dec = wk.wire_unpack(self.slot_spec, wire.slots[0], base, keep, self.ct)
        for r, (lo, hi) in zip(self.clock_recs, self.clock_cols):
            leaves[r.i] = dec[..., lo:hi].reshape(b, *r.shape).view(r.dtype)
        rc = self.ctx_rec
        leaves[rc.i] = dec[..., self.ctx_lo:self.ctx_hi].reshape(b, *rc.shape).view(rc.dtype)
        pdec = wk.wire_unpack(self.parked_spec, wire.parked[0],
                              self._parked_base(own_top, b, dec.device),
                              torch.cat(pvalid_parts, dim=-1), self.ct)
        lo = 0
        for r in self.parked_recs:
            d = r.shape[0]
            leaves[r.i] = pdec[:, lo:lo + d].reshape(b, *r.shape).view(r.dtype)
            lo += d
        return _rebuild(self.template, leaves)

    # ---- sender-side bookkeeping ----------------------------------------

    def mask(self, pkt, keep):
        """The sender's gated packet (content zeroed where the fused pass
        masked or deferred) — the ack window's bookkeeping copy."""
        out = []
        for r, (_, leaf) in zip(self.records, _named_leaves(pkt)):
            if r.cls in (_PDCL, _PVALID, _PBOOL) or r.name == "idx":
                out.append(leaf)
            elif r.cls == _SLOTVALID:
                out.append(keep)
            else:
                out.append(mask_slots(keep, leaf))
        return _rebuild(self.template, out)

    def useful_bytes(self, pkt, keep) -> torch.Tensor:
        """``telemetry.packet_useful_bytes`` of the gated packet from the
        keep mask and the static prices (float32, per batch lane)."""
        leaves = [leaf for _, leaf in _named_leaves(pkt)]
        total = keep.sum(dim=-1).to(torch.float32) * self.slot_price
        for r in self.pvalid_recs:
            _, price = self.parked_prices[r.name[: -len("dvalid")]]
            total = total + leaves[r.i].sum(dim=-1).to(torch.float32) * price
        return total


def _signed(dtype: torch.dtype) -> torch.dtype:
    return torch.int64 if dtype == torch.uint64 else torch.int32


def _narrow(wide: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Wide (``_dtypes.to_wide``) lanes → ``dtype`` lanes, contiguous."""
    return from_wide(wide, dtype).contiguous()


def _add_batch(tree):
    if tree is None:
        return None
    return tree_map(lambda x: x[None], tree)


def _drop_batch(tree):
    return tree_map(lambda x: x[0], tree)


def wire_checksum(wire: WirePacket, partials, batch_dims: int = 0) -> torch.Tensor:
    """``faults.integrity.checksum`` of the wire tree, with K3's in-pass
    partials standing in for the big leaves (``partials`` maps leaf index
    → u32 partial): same leaf walk, same odd-constant chaining. Returns
    u32, one per batch lane."""
    leaves = [x for group in wire for x in group]
    total = None
    for i, leaf in enumerate(leaves):
        part = partials.get(i)
        part = to_wide(part) if part is not None else to_wide(
            wk.leaf_checksum(leaf, batch_dims))
        total = part if total is None else chain(total, part)
    return from_wide(total, torch.uint32)


def fill_invalid_idx(idx: torch.Tensor, keep: torch.Tensor, e: int) -> torch.Tensor:
    """Distinct no-op scatter targets for the invalid slots whose indices
    shipped as zeros: the first free (un-kept) element positions,
    ascending, per batch lane."""
    taken = torch.zeros((*idx.shape[:-1], e), dtype=torch.int32, device=idx.device)
    taken = taken.scatter_add(-1, idx.long(), keep.to(torch.int32)) > 0
    free = torch.argsort(taken.to(torch.uint8), dim=-1, stable=True)
    rank = torch.cumsum((~keep).to(torch.int64), dim=-1) - 1
    filler = torch.gather(free, -1, rank.clamp_min(0)).to(idx.dtype)
    return torch.where(keep, idx, filler)


def core_idx(pkt):
    """The leaf slot packet's element indices."""
    return _core(pkt).idx


def remark_deferred(dirty, idx, defer):
    """Re-mark narrow-deferred slots dirty (they never reached the wire),
    before the round's backlog count."""
    return put_rows(dirty, idx, torch.gather(dirty, -1, idx.long()) | defer)


def mirror_promote(mctx, pkt, acks, keep=None):
    """The receiver-side twin of ``ackwin.update_window``'s ctx
    promotion, driven by knowledge the receiver holds: the packet it just
    applied and the ack bits it computed itself (``keep``: a faulted
    run's fate, None for reliable delivery). Keeps the mirror
    bit-identical to the sender's window ctx, the other half of the acked
    encode watermark. Returns a new tensor: the pipelined ring keeps the
    mirror from before the promotion too."""
    core = _core(pkt)
    ok = core.valid & acks if keep is None else core.valid & acks & keep
    old = to_wide(take_rows(mctx, core.idx))
    new = torch.where(ok[..., None], torch.maximum(old, to_wide(core.ctxs)), old)
    return put_rows(mctx, core.idx, from_wide(new, mctx.dtype))


def know_dense(pkt):
    """``delta.gate_delta``'s subject: the slot's live dot rows."""
    return _core(pkt).rows


def know_map(pkt):
    """``delta_map.gate_delta_map``'s subject: the witness-dot knowledge
    of the shipped content slots."""
    from .delta_map import _key_knowledge

    return _key_knowledge(_core(pkt).child)


# One registered codec per δ flavor; a fused ring of a kind missing here
# raises. The nested flavors' packets wrap the dense one: their slot
# instance is the dense slot spec, and each level's parked buffer joins
# the parked instance of the same grouped launch.
WIRE_SURFACES = {
    "delta_gossip": know_dense,
    "map_delta_gossip": know_map,
    "map_orswot_delta_gossip": know_dense,
    "map3_delta_gossip": know_dense,
}


__all__ = [
    "WIRE_SURFACES", "WireAux", "WireCodec", "WirePacket", "core_idx", "fill_invalid_idx",
    "know_dense", "know_map", "mirror_promote", "remark_deferred", "wire_checksum",
]
