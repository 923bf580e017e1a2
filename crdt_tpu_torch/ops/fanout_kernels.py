"""Cohort δ fan-out kernels — the port of the JAX package's
``ops/fanout_kernels.py``: the fused δ wire of the rings (kernel K3)
generalised from P ring links to millions of client links.

The subscription plane (``crdt_tpu_torch/fanout/``) buckets subscribers
by acked watermark so ONE join-irreducible decomposition serves a whole
cohort: a dispatch gathers B superblock rows next to their B cohort base
rows (each base is the bit-exact state the cohort's clients positively
acked) and

- :func:`cohort_deltas` decomposes the whole batch at once —
  ``decompose(kind, rows, bases, batched=True)``, the counterpart of the
  JAX ``vmap``: B independent ``decompose(live, acked_base)`` lanes;
- :func:`cohort_wire_encode` runs the WHOLE batch's δ clock lanes through
  ONE launch of K3 (:func:`~crdt_tpu_torch.ops.wire_kernels.wire_pack`):
  the ``[B, E, A]`` element birth-clock planes flatten to ``B·E`` wire
  rows of ``A`` columns (biased-u16 delta against the acked base — a
  per-row base, two lanes per u32 word, checksum and packed-word count in
  the same read). A leading rank axis ``[P, B/P, E, A]`` packs as K3's
  ``[P, (B/P)·E, A]`` stack, still one launch, with ``nnz``/``chk`` per
  rank: the JAX package packs each device's local batch as its own call,
  so the checksum's row weights restart on every rank;
- rows outside the u16 window DEFER to a raw-lane fallback (``raw``
  carries them verbatim — a fan-out client has no ring to re-mark dirty);
- the residual planes (top clock + bounded parked buffers) ride whole per
  cohort, bool planes bit-packed 8× by
  :func:`~crdt_tpu_torch.ops.wire_kernels.pack_bits`.

:func:`cohort_wire_decode` inverts the wire bit-exactly against the
client's own acked base (plain torch through ``wire_unpack``, as in the
JAX package: the kernel earns its keep on the send side), and
``reconstruct(kind, client_state, d)`` then lands the client replica
bit-identical to the served tenant row. :func:`cohort_push_bytes` is the
per-cohort wire price.

On CUDA tensors the encode launches K3 or raises; on CPU tensors it
takes K3's plain version (``wire_pack_plain``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .._dtypes import bits
from ..delta_opt.decompose import Decomposition, decompose
from ..utils import ophooks
from .lattice import tree_leaves, tree_map
from .wire_kernels import WireLaneSpec, pack_bits, unpack_bits, wire_pack, wire_unpack


class CohortWire(NamedTuple):
    """One dispatch's packed fan-out payload: B cohorts, E δ lanes per
    cohort, A clock columns per lane (``W = (A + 1) // 2`` packed words).
    ``keep`` / ``defer`` partition ``valid`` (a changed lane either fits
    the biased-u16 window or ships raw); ``residual`` is the per-cohort
    residual tree with bool planes bit-packed. ``nnz`` / ``chk`` are K3's
    packed-word count and checksum partial, summed over the ranks per
    dispatch. Leaves are tensors on the device, or numpy arrays once the
    plane has read a dispatch back to the host."""

    words: Any      # [B, E, W] u32 — packed biased-u16 δ lanes
    keep: Any       # [B, E] bool — lanes on the packed wire
    defer: Any      # [B, E] bool — changed lanes shipping raw
    valid: Any      # [B, E] bool — the decomposition's lane mask
    raw: Any        # [B, E, A] — deferred lanes verbatim, else 0
    residual: Any   # per-cohort residual, bool planes bit-packed
    nnz: Any        # u32 — nonzero packed words
    chk: Any        # u32 — checksum partial over the packed words


def cohort_deltas(kind: str, rows, bases) -> Decomposition:
    """B independent ``decompose(live_row, acked_base)`` lanes in one
    batched pass (leading batch axis on every leaf of ``rows`` /
    ``bases``): ``valid`` is ``[B, L]``."""
    return decompose(kind, rows, bases, batched=True)


def _ctr_plane(d: Decomposition) -> torch.Tensor:
    lanes = tree_leaves(d.lanes)
    if len(lanes) != 1 or lanes[0].dim() not in (3, 4):
        raise ValueError(
            "cohort wire encode needs a single [B, E, A] clock row plane (dense "
            f"orswot-family decomposition), got {[tuple(x.shape) for x in lanes]}"
        )
    return lanes[0]


def _pack_residual(res, lead: int):
    """Bool residual planes as per-cohort little-endian bitmaps (the
    ``pack_bits`` wire form, 8× over byte-per-bool); other planes ride
    unchanged. ``lead`` leading axes index the cohort."""
    return tree_map(
        lambda x: pack_bits(x.reshape(*x.shape[:lead], -1)) if x.dtype == torch.bool else x,
        res,
    )


def _unpack_residual(packed, like):
    """Invert :func:`_pack_residual` given any tree with the original
    residual's shapes and dtypes (the client's own split residual works —
    shapes are capacity-static); one leading cohort axis."""
    def un(p, l):
        if l.dtype != torch.bool:
            return p
        n = math.prod(l.shape[1:]) if l.dim() > 1 else 1
        return unpack_bits(p, n).reshape(l.shape)

    return tree_map(un, packed, like)


def cohort_pack_args(d: Decomposition, base_ctr: torch.Tensor) -> dict:
    """K3's arguments for one dispatch (the :func:`wire_pack` keywords):
    the fan-out instance, ``WireLaneSpec(lc=A)`` with no gate and no ack,
    over the ``[B·E, A]`` rows (``[B, E, A]`` input) or the ``[P,
    (B/P)·E, A]`` stack (``[P, B/P, E, A]`` input), with a per-row base."""
    ctr = _ctr_plane(d)
    a = ctr.shape[-1]
    n = -1 if ctr.dim() == 3 else ctr.shape[1] * ctr.shape[2]
    head = () if ctr.dim() == 3 else (ctr.shape[0],)
    return dict(
        spec=WireLaneSpec(lc=a),
        clocks=ctr.reshape(*head, n, a),
        base=base_ctr.reshape(*head, n, a),
        valid=d.valid.reshape(*head, n),
    )


@ophooks.kernel("cohort_wire_encode")
def cohort_wire_encode(d: Decomposition, base_ctr: torch.Tensor) -> CohortWire:
    """Encode one dispatch's stacked decomposition against the cohort
    bases' clock plane ``base_ctr [B, E, A]`` (or ``[P, B/P, E, A]``, one
    batch of K3's stack per rank) — ONE launch of K3 over all ``B·E`` δ
    lanes (module docstring)."""
    ctr = _ctr_plane(d)
    lead = ctr.shape[:-2]
    args = cohort_pack_args(d, base_ctr)
    out = wire_pack(**args)
    defer = out.defer.reshape(ctr.shape[:-1])
    return CohortWire(
        words=out.words.reshape(*ctr.shape[:-1], args["spec"].w),
        keep=out.keep.reshape(ctr.shape[:-1]),
        defer=defer,
        valid=d.valid,
        raw=torch.where(defer[..., None], bits(ctr), 0).view(ctr.dtype),
        residual=_pack_residual(d.residual, len(lead)),
        nnz=out.nnz,
        chk=out.chk,
    )


def cohort_wire_decode(wire: CohortWire, base_ctr: torch.Tensor, res_like) -> Decomposition:
    """Invert :func:`cohort_wire_encode` bit-exactly: kept lanes decode
    ``base + (enc16 - BIAS)`` against the client's own clock plane
    ``base_ctr [B, E, A]`` (== the acked base, the plane's promote-on-ack
    invariant), deferred lanes adopt the raw fallback, bool residual
    planes unpack against ``res_like``. Plain torch; the wire's tensors
    must lie on ``base_ctr``'s device."""
    b, e, a = base_ctr.shape
    spec = WireLaneSpec(lc=a)
    dec = wire_unpack(spec, wire.words.reshape(b * e, spec.w), base_ctr.reshape(b * e, a),
                      wire.keep.reshape(b * e), base_ctr.dtype).reshape(b, e, a)
    ctr = torch.where(wire.defer[..., None], bits(wire.raw), bits(dec)).view(base_ctr.dtype)
    return Decomposition(lanes=(ctr,), valid=wire.valid,
                         residual=_unpack_residual(wire.residual, res_like))


def cohort_push_bytes(wire: CohortWire) -> torch.Tensor:
    """The per-cohort wire price ``[B] f32`` (the ``delta_push_bytes``
    unit): packed words for kept lanes, raw lanes for deferred ones, plus
    the static framing — the keep/defer bitmaps and the (bit-packed)
    residual riding whole. Any leading cohort axes (``[P, B/P]`` too)."""
    lead, (e, w) = wire.words.shape[:-2], wire.words.shape[-2:]
    b = math.prod(lead)
    a = wire.raw.shape[-1]
    framing = 2 * ((e + 31) // 32) * 4 + sum(
        (leaf.numel() // b) * leaf.element_size() for leaf in tree_leaves(wire.residual)
    )
    f32 = torch.float32
    return (wire.keep.sum(dim=-1, dtype=f32) * (4 * w)
            + wire.defer.sum(dim=-1, dtype=f32) * (a * wire.raw.element_size()) + framing)


def wire_lane(wire: CohortWire, b: int) -> CohortWire:
    """One cohort's slice of a dispatch wire (leading batch axis kept at
    1 — the shape :func:`cohort_wire_decode` expects): what the plane
    hands every subscriber of cohort ``b``. Works on tensor and numpy
    leaves alike."""
    sl = lambda x: x[b:b + 1]  # noqa: E731
    return CohortWire(
        words=sl(wire.words), keep=sl(wire.keep), defer=sl(wire.defer), valid=sl(wire.valid),
        raw=sl(wire.raw), residual=tree_map(sl, wire.residual), nnz=wire.nnz, chk=wire.chk,
    )


__all__ = [
    "CohortWire", "cohort_deltas", "cohort_pack_args", "cohort_push_bytes",
    "cohort_wire_decode", "cohort_wire_encode", "wire_lane",
]
