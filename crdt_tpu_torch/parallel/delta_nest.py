"""The δ-state induction step — the delta-side twin of ``ops.nest.NestLevel``.
Counterpart of the JAX package's ``parallel/delta_nest.py``, bit for bit.

Every nesting level wraps the core's delta machinery the same way:
packets gain the level's whole (bounded) parked-keyset buffer; apply
joins the core delta, then settles the level's buffer (union → dedupe →
replay → compact → scrub); rows the level's replay killed forward their
pre-replay knowledge (the ``delta.py`` invariant). Depth N needs no new
flavor: ``nested_delta(level, *nested_delta(inner, leaf_extract,
leaf_apply))`` composes (``delta_map3`` is exactly that).

Only ORSWOT-leaf chains close generically (``close_top_nested`` ends in
``delta.close_top_orswot``). Every function takes the ring's leading rank
axis; the level's ``settle_outer`` dedupes with the linear
``ops.orswot._dedupe_deferred``, one host sync per level and round.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from .._dtypes import from_wide, to_wide
from ..ops.nest import NestLevel
from .delta import close_top_orswot


class NestedDeltaPacket(NamedTuple):
    """The core's delta packet + one level's parked-keyset buffer riding
    whole (bounded). Flavors substitute their own 4-field class (same
    positional layout) to keep their packet types."""

    core: Any
    dcl: torch.Tensor     # [.., D, A]
    dkeys: torch.Tensor   # [.., D, K]
    dvalid: torch.Tensor  # [.., D]


def nested_delta(level: NestLevel, core_extract: Callable, core_apply: Callable,
                 packet_cls=NestedDeltaPacket) -> Tuple[Callable, Callable]:
    """Wrap a core ``(extract, apply)`` δ pair with one nesting level.
    ``core_apply`` takes ``(state, pkt, dirty, fctx, element_axis=None)``
    (adapt a leaf applier with a lambda). Returns the level's pair with
    the same signatures, so the construction composes to any depth."""

    def extract(state, dirty, fctx, cap, start=0):
        core_pkt, dirty, fctx = core_extract(state[0], dirty, fctx, cap, start)
        return packet_cls(core_pkt, state[1], state[2], state[3]), dirty, fctx

    def apply_fn(state, pkt, dirty, fctx, element_axis=None):
        core, dirty, fctx, core_of = core_apply(state[0], pkt[0], dirty, fctx, element_axis)
        before = to_wide(level.core.leaf_ctr(core))
        st = level._make(core, *level.concat_bufs(state, pkt))
        st, outer_of = level.settle_outer(st, state[1].shape[-2], element_axis)
        # Rows this level's replay killed forward their pre-replay
        # knowledge (the delta.py invariant); the parked slots ride every
        # packet, so the removal clocks propagate regardless.
        after = to_wide(level.leaf_ctr(st))
        replay_changed = torch.any(after != before, dim=-1)
        dirty = dirty | replay_changed
        fw = torch.maximum(to_wide(fctx), torch.where(replay_changed[..., None], before, 0))
        of = torch.cat([core_of.reshape(*outer_of.shape, -1), outer_of[..., None]], dim=-1)
        return st, dirty, from_wide(fw, fctx.dtype), of

    return extract, apply_fn


def nested_gate(core_gate: Callable, packet_cls=NestedDeltaPacket) -> Callable:
    """Lift a core digest gate through one nesting level: only the core
    packet's slots gate; the level's parked buffer rides whole (parked
    rm clocks are their own context, with a per-slot validity mask)."""

    def gate(pkt, digest):
        return packet_cls(core_gate(pkt[0], digest), *pkt[1:])

    return gate


def close_top_nested(level, folded, top, element_axis=None):
    """Adopt the mesh-wide top and re-replay the parked removes at EVERY
    level, innermost first, then scrub (``delta_ring`` documents why the
    closure is needed and sound). ORSWOT-leaf chains only."""

    def rec(lv, s):
        if isinstance(lv, NestLevel):
            core = rec(lv.core, s[0])
            return lv.replay_outer(lv._make(core, s[1], s[2], s[3]))
        return close_top_orswot(s, top)

    return level.scrub_self(rec(level, folded), element_axis)


def nested_template(core_template: Callable, packet_cls=NestedDeltaPacket) -> Callable:
    """The codec's plan input for a nested flavor (the JAX ring's
    ``jax.eval_shape`` of the extract): ``core_template`` on the core of
    the folded ``[P, ...]`` rows, wrapped with meta tensors of the level's
    buffers without the rank axis."""

    def template(folded, cap: int, fctx_dtype: torch.dtype):
        meta = lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta")  # noqa: E731
        return packet_cls(core_template(folded[0], cap, fctx_dtype),
                          meta(folded[1]), meta(folded[2]), meta(folded[3]))

    return template


__all__ = ["NestedDeltaPacket", "close_top_nested", "nested_delta", "nested_gate",
           "nested_template"]
