"""The ack window's state and the packet walk helpers the wire codec
needs — the part of the JAX package's ``delta_opt/ackwin.py`` that
``parallel/wire.py`` imports (``AckWindow``, ``_core``,
``_content_names``).

An ack window is one link's positively confirmed knowledge: the content
planes of the last slot the peer confirmed joining, per row (``rows``),
the join of the confirmed slots' causal contexts (``ctx``) and which rows
were ever confirmed (``ackd``). The wire codec takes it as the acked
verdict's inputs and the encode watermark. The ring's ``ack_window=``
mode itself (ack exchange, window promotion) is still to port (ROADMAP
item 7).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class AckWindow(NamedTuple):
    """One link's acked-interval watermark."""

    rows: Any           # confirmed content planes, [E, ...] per plane
    ctx: torch.Tensor   # [E, A] — join of confirmed slot contexts
    ackd: torch.Tensor  # [E] bool — rows ever positively confirmed


def _core(pkt):
    """The leaf slot packet (wrapper packets nest it first)."""
    return pkt if hasattr(pkt, "idx") else _core(pkt[0])


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


__all__ = ["AckWindow"]
