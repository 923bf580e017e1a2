"""Ack-window back-propagation for the δ rings (Enes et al., arXiv
1803.02750 §4.2) — counterpart of the JAX package's
``delta_opt/ackwin.py``.

The digest gate masks only add-only slots the receiver's frozen top
covers: a top can never vouch for a removal. The ack window does. Each
receiver, after applying a packet, ships one bool per slot back up-ring
on the inverse-ring channel (``ack_bits``); the sender promotes the
confirmed slots of its own shipped copy into a per-link window
(``update_window``):

- ``rows`` — the content planes of the last slot the peer confirmed
  joining, per row;
- ``ctx``  — the join of the confirmed slots' causal contexts per row;
- ``ackd`` — which rows were ever positively confirmed.

Extraction then masks every slot whose content equals the confirmed
``rows`` AND whose context the confirmed ``ctx`` covers
(``gate_window``): the peer provably joined an identical-content slot
under an equal-or-stronger context, and re-marked the row dirty at apply
time, so transitive delivery survives the masked re-ship. Content
equality is required, not just context coverage: a sender-side removal
of an acked dot does not grow the slot context.

Every function takes packets and windows with a leading rank axis (the
ring's P links, as ``parallel/wire.py`` does) or none: one call serves
all links of a round. Scatters write rows of a packet's ``idx``, distinct
within a link (extract takes the first ``cap`` of an argsort, and
``wire.fill_invalid_idx`` gives unpacked invalid slots distinct
targets), so no two writes of a call hit one element.

The JAX module's ``AckWindowKey`` marks acked programs in its jit cache;
the port runs eagerly and has no such cache, so it has no counterpart
here.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._dtypes import bits, from_wide, to_wide, zeros
from ..ops.lattice import mask_slots, row_index, take_rows, tree_leaves, tree_map


class AckWindow(NamedTuple):
    """One link's acked-interval watermark."""

    rows: Any           # confirmed content planes, [.., E, ...] per plane
    ctx: torch.Tensor   # [.., E, A] — join of confirmed slot contexts
    ackd: torch.Tensor  # [.., E] bool — rows ever positively confirmed


def _core(pkt):
    """The leaf slot packet (wrapper packets nest it first)."""
    return pkt if hasattr(pkt, "idx") else _core(pkt[0])


def _with_core(pkt, core):
    """``pkt`` with its leaf slot packet replaced by ``core``."""
    if hasattr(pkt, "idx"):
        return core
    return pkt._replace(**{pkt._fields[0]: _with_core(pkt[0], core)})


def _content_names(core) -> tuple:
    """The slot content field names: every field except the slot
    bookkeeping (``idx``/``valid``/``ctxs``) and the whole-riding parked
    groups (``[prefix]d{cl,mask,keys,valid}``)."""
    names = core._fields
    parked = set()
    for f in names:
        if f.endswith("dvalid"):
            pref = f[: -len("dvalid")]
            parked |= {
                pref + s for s in ("dcl", "dmask", "dkeys", "dvalid") if pref + s in names
            }
    return tuple(f for f in names if f not in parked and f not in ("idx", "valid", "ctxs"))


def _content(core) -> tuple:
    return tuple(getattr(core, f) for f in _content_names(core))


def _put_(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> None:
    """Rows ``idx`` of ``x`` set to ``v`` in place (indices distinct)."""
    bits(x).scatter_(idx.dim() - 1, row_index(x, idx), bits(v))


def init_window(pkt_shape, n_rows: int, batch: tuple = (), device="cuda") -> AckWindow:
    """The empty window for a row universe of ``n_rows``, shaped from one
    link's packet planes (``pkt_shape``: a packet without its batch axis;
    ``device="meta"`` leaves will do), with leading ``batch`` axes."""
    core = _core(pkt_shape)
    lead = tuple(batch)
    rows = tree_map(lambda a: zeros(lead + (n_rows,) + tuple(a.shape[1:]), a.dtype, device),
                    _content(core))
    ctx = zeros(lead + (n_rows,) + tuple(core.ctxs.shape[1:]), core.ctxs.dtype, device)
    return AckWindow(rows=rows, ctx=ctx,
                     ackd=torch.zeros(lead + (n_rows,), dtype=torch.bool, device=device))


def gate_window(pkt, win: AckWindow):
    """Mask every slot the ack window covers: content identical to the
    confirmed rows AND context covered by the confirmed ctx, on a row the
    peer has positively acked. Masked slots are zeroed so the packet
    stays canonical; the wire shape is unchanged. Returns ``(packet,
    covered)``."""
    core = _core(pkt)
    idx = core.idx
    lead = idx.dim()
    same = None
    for w, p in zip(tree_leaves(win.rows), tree_leaves(_content(core))):
        g = take_rows(w, idx)
        eq = torch.all((bits(g) == bits(p)).reshape(*p.shape[:lead], -1), dim=-1)
        same = eq if same is None else same & eq
    covered = (
        core.valid
        & torch.gather(win.ackd, -1, idx.long())
        & same
        & torch.all(to_wide(core.ctxs) <= to_wide(take_rows(win.ctx, idx)), dim=-1)
    )
    keep = core.valid & ~covered
    masked = core._replace(
        valid=keep,
        ctxs=mask_slots(keep, core.ctxs),
        **{f: tree_map(lambda x: mask_slots(keep, x), getattr(core, f))
           for f in _content_names(core)},
    )
    return _with_core(pkt, masked), covered


def ack_bits(pkt, keep=None) -> torch.Tensor:
    """The receiver's per-slot confirmation for one applied packet: slots
    actually joined this round (``keep`` is a faulted run's fate; None is
    reliable delivery, every valid slot applied)."""
    valid = _core(pkt).valid
    return valid if keep is None else valid & keep


def update_window(win: AckWindow, sent, acks: torch.Tensor) -> AckWindow:
    """Promote the confirmed slots of the sender's own shipped copy into
    the window (``acks`` is the peer's ack for ``sent``, back-propagated
    one inverse hop): rows adopt the confirmed content, ctx joins the
    confirmed context, ackd latches. Writes ``win``'s tensors in place
    and returns them."""
    core = _core(sent)
    ok = core.valid & acks
    idx = core.idx
    for w, p in zip(tree_leaves(win.rows), tree_leaves(_content(core))):
        sel = ok.reshape(*ok.shape, *([1] * (p.dim() - ok.dim())))
        _put_(w, idx, torch.where(sel, bits(p), bits(take_rows(w, idx))).view(p.dtype))
    old = take_rows(win.ctx, idx)
    grown = torch.maximum(to_wide(old), to_wide(core.ctxs))
    new = torch.where(ok[..., None], grown, to_wide(old))
    _put_(win.ctx, idx, from_wide(new, win.ctx.dtype))
    _put_(win.ackd, idx, torch.gather(win.ackd, -1, idx.long()) | ok)
    return win


def window_depth(win: AckWindow) -> torch.Tensor:
    """Rows with a live acked watermark, per link (``[..]`` int64)."""
    return win.ackd.sum(dim=-1)


def slot_bytes(pkt) -> int:
    """Static per-slot byte price of one packet's maskable planes (the
    content fields plus the ctx row): what a window-masked slot stops
    shipping, the unit of the JAX ring's ``bytes_acked_skipped``."""
    core = _core(pkt)
    c = max(core.idx.numel(), 1)
    per = sum((leaf.numel() // c) * leaf.element_size()
              for leaf in tree_leaves(_content(core)))
    return per + (core.ctxs.numel() // c) * core.ctxs.element_size()


__all__ = [
    "AckWindow", "ack_bits", "gate_window", "init_window", "slot_bytes", "update_window",
    "window_depth",
]
