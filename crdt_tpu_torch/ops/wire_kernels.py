"""The fused δ wire pass — counterpart of the JAX package's
``ops/wire_kernels.py``.

One read of each packet slot's clock lanes computes everything the send
side of a δ round needs:

- the **gate verdicts**: digest-covered (``ctxs == know`` ∧ ``know <=
  dig``, the ``parallel/delta.gate_delta`` rule) and ack-covered
  (non-ctx lanes equal to the confirmed window ``winc``, ctx lanes
  covered by it, on an acked row);
- the **bit-packed encoding**: every clock lane as a biased u16 delta
  against the link watermark, ``(value - base) + 32768`` wrapping in the
  clock dtype, two lanes per u32 word (word ``j`` = lane ``j`` | lane
  ``W + j`` << 16, ``W = ceil(LC / 2)``), masked slots zeroed;
- the **fit mask**: a valid, ungated slot whose lanes do not all fit the
  ±32 Ki window is deferred (shipped invalid);
- the **checksum partial** ``Σ words·(2·(row·W + col) + 1) mod 2^32`` over
  each batch's own unpadded rows (``faults.integrity``'s leaf sum of the
  words), and the **nonzero-word count**.

``wire_pack`` dispatches on the tensors: CUDA tensors launch kernel K3
(``csrc/wire.cu``) or raise; CPU tensors take ``wire_pack_plain``. Both
take one ``[N, LC]`` slot matrix or a ``[B, N, LC]`` stack (the δ ring
stacks its P links), and ``wire_pack_many`` packs several such instances
in one launch (a round's slot and parked instances). The unpack side and
the bitmap / u16-pair helpers are plain torch, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .._dtypes import bits, from_raw, from_wide, mul32, raw, to_wide
from ..utils import ophooks

# The biased-u16 window: a clock lane encodes exactly when its value is
# within [-BIAS, BIAS - 1] of the link watermark (wrapping arithmetic).
BIAS = 32768
_U16 = 65536
_MASK32 = 0xFFFFFFFF
# K3 packs a row with one thread per wire word, at most a warp: at most
# this many clock lanes per slot (the dense ORSWOT flavor has LC = 2A,
# A <= 32).
LC_MAX = 64


class WireLaneSpec(NamedTuple):
    """The static lane map of one flavor's slot clock matrix: ``lc``
    clock columns per slot, the causal-context plane at columns
    ``[ctx_lo, ctx_hi)``; ``gated`` / ``acked`` select the verdicts,
    ``parked`` marks the parked-buffer instance (no gates: a fit failure
    there is a lost slot, not a deferral)."""

    lc: int
    ctx_lo: int = 0
    ctx_hi: int = 0
    gated: bool = False
    acked: bool = False
    parked: bool = False

    @property
    def w(self) -> int:
        """Output wire words per slot (two u16 lanes per u32 word)."""
        return (self.lc + 1) // 2


class WirePackOut(NamedTuple):
    """One fused pack pass's outputs (leading ``[B]`` when stacked)."""

    words: torch.Tensor    # [.., N, W] u32 — the bit-packed wire lanes
    keep: torch.Tensor     # [.., N] bool — slots that ship
    defer: torch.Tensor    # [.., N] bool — valid, ungated, unencodable
    covered: torch.Tensor  # [.., N] bool — ack-window verdicts
    nnz: torch.Tensor      # [..] u32 — nonzero wire words
    chk: torch.Tensor      # [..] u32 — checksum partial of ``words``


def _u32(x: torch.Tensor) -> torch.Tensor:
    """``int64`` lanes in ``[0, 2**32)`` → ``uint32``."""
    return from_wide(x, torch.uint32)


def wire_pack_plain(
    spec: WireLaneSpec,
    clocks: torch.Tensor,
    base: torch.Tensor,
    valid: torch.Tensor,
    know: Optional[torch.Tensor] = None,
    dig: Optional[torch.Tensor] = None,
    winc: Optional[torch.Tensor] = None,
    ack_ok: Optional[torch.Tensor] = None,
) -> WirePackOut:
    """Plain torch version of K3, written from the JAX package's
    ``_wire_kernel``: same inputs and outputs as :func:`wire_pack`."""
    w = spec.w
    lc2 = 2 * w
    pad = lc2 - clocks.shape[-1]

    def lanes(x, view):
        # The odd-LC padding column holds 0 in clocks, base and winc, so
        # it always fits and encodes as BIAS in a kept slot.
        y = view(x)
        return torch.nn.functional.pad(y, (0, pad)) if pad else y

    # raw: wrapping arithmetic; to_wide: the unsigned order (and equality).
    encb = lanes(clocks, raw) - lanes(base, raw) + BIAS
    if clocks.dtype != torch.uint64:
        encb = encb & _MASK32
    fits = (encb >= 0) & (encb < _U16)
    fit_slot = fits.all(dim=-1)

    c = lanes(clocks, to_wide)
    cols = torch.arange(lc2, device=clocks.device)
    is_ctx = (cols >= spec.ctx_lo) & (cols < spec.ctx_hi)
    false = torch.zeros_like(valid)
    if spec.gated:
        kw = to_wide(know)
        addonly = (c[..., spec.ctx_lo:spec.ctx_hi] == kw).all(dim=-1)
        under = (kw <= to_wide(dig)).all(dim=-1)
        cov_d = valid & addonly & under
    else:
        cov_d = false
    if spec.acked:
        wc = lanes(winc, to_wide)
        same = torch.where(is_ctx, True, c == wc).all(dim=-1)
        covc = torch.where(is_ctx, c <= wc, True).all(dim=-1)
        cov_a = valid & ~cov_d & ack_ok & same & covc
    else:
        cov_a = false

    keep = valid & ~cov_d & ~cov_a & fit_slot
    defer = valid & ~cov_d & ~cov_a & ~fit_slot
    enc = torch.where(keep[..., None] & fits, encb, 0) & 0xFFFF
    words = enc[..., :w] | (enc[..., w:] << 16)

    n = words.shape[-2]
    wts = (torch.arange(n * w, dtype=torch.int64, device=words.device) * 2 + 1) & _MASK32
    chk = mul32(words.reshape(*words.shape[:-2], -1), wts).sum(dim=-1) & _MASK32
    nnz = (words != 0).sum(dim=(-2, -1)) & _MASK32
    return WirePackOut(
        words=_u32(words), keep=keep, defer=defer, covered=cov_a,
        nnz=_u32(nnz), chk=_u32(chk),
    )


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, rows: bool = False) -> None:
    """Refuse what K3 cannot read: ``rows=True`` admits a strided view
    (broadcast rows, a column range of ``clocks``) whose lanes are
    unit-stride; anything else must be contiguous."""
    if not t.is_cuda:
        raise ValueError(f"wire_pack: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"wire_pack: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"wire_pack: {name} has shape {tuple(t.shape)}, expected {shape}")
    if rows and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"wire_pack: {name} must have contiguous lanes (unit last stride)")
    if not rows and not t.is_contiguous():
        raise ValueError(f"wire_pack: {name} must be contiguous")


def _check_call(spec, clocks, base, valid, know, dig, winc, ack_ok) -> None:
    """Check one ``[B, N, LC]`` instance against what K3 takes; raises on
    anything it cannot take."""
    b, n, lc = clocks.shape
    dt = clocks.dtype
    if dt not in (torch.uint32, torch.uint64):
        raise TypeError(f"wire_pack: clocks must be uint32 or uint64, got {dt}")
    if not 1 <= lc <= LC_MAX:
        raise ValueError(f"wire_pack: the kernel takes 1..{LC_MAX} clock lanes, got {lc}")
    if n < 1 or b < 1:
        raise ValueError(f"wire_pack: needs at least one slot row, got [B={b}, N={n}]")
    if n > MAX_ROWS:
        raise ValueError(f"wire_pack: the kernel takes at most {MAX_ROWS} rows per batch, got {n}")
    if not 0 <= spec.ctx_lo <= spec.ctx_hi <= lc:
        raise ValueError(f"wire_pack: ctx columns [{spec.ctx_lo}, {spec.ctx_hi}) outside {lc}")
    _check("clocks", clocks, (b, n, lc), dt)
    _check("base", base, (b, n, lc), dt, rows=True)
    _check("valid", valid, (b, n), torch.bool)
    a = spec.ctx_hi - spec.ctx_lo
    if spec.gated:
        if know is None or dig is None:
            raise ValueError("wire_pack: a gated spec needs know and dig")
        _check("know", know, (b, n, a), dt, rows=True)
        _check("dig", dig, (b, n, a), dt, rows=True)
    if spec.acked:
        if winc is None or ack_ok is None:
            raise ValueError("wire_pack: an acked spec needs winc and ack_ok")
        _check("winc", winc, (b, n, lc), dt)
        _check("ack_ok", ack_ok, (b, n), torch.bool)


# Instances one launch packs (csrc/wire.cu ``kMaxInst``), rows per batch
# (``kMaxRows``), batches per launch (``kMaxBatches``), and the stats
# scratch in int32 words: two uint64 counters per batch.
MAX_GROUP = 4
MAX_ROWS = 1 << 28
MAX_BATCHES = 65536
_SCRATCH = 4 * MAX_BATCHES
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _scratch_buffer(dev: torch.device, stream: int) -> torch.Tensor:
    """The stats scratch of EAGER K3 launches on (``dev``, ``stream``):
    the per-batch counters of ``nnz``/``chk``, zeroed once here and left
    at 0 by every launch. The rule the scratch keeps is that no two
    launches that can be in flight together share counters. Eager launches
    on one stream run one after another, so they share that stream's
    buffer, and launches on two streams take two buffers. A launch
    captured into a CUDA graph does not come here: it takes the scratch
    of its capture (:func:`_scratch_ptr`), since a graph is replayed on
    whatever stream its caller names, beside other graphs captured on the
    same stream, while its own replays run one after another."""
    key = (dev.index, stream)
    t = _scratch.get(key)
    if t is None:
        t = _scratch[key] = torch.zeros(_SCRATCH, dtype=torch.int32, device=dev)
    return t


def _scratch_ptr(lib: ctypes.CDLL, dev: torch.device, stream: int) -> int:
    """The address of the stats scratch of a launch on ``stream`` now: the
    stream's own buffer (:func:`_scratch_buffer`), or, while the stream
    captures a graph, a buffer that belongs to that capture — allocated
    and zeroed outside the graph, so the graph gains no node, and freed
    with the graph (``csrc/wire.cu`` ``crdt_wire_graph_scratch``)."""
    if not torch.cuda.is_current_stream_capturing():
        return _scratch_buffer(dev, stream).data_ptr()
    out = ctypes.c_void_p()
    err = lib.crdt_wire_graph_scratch(stream, 4 * _SCRATCH, ctypes.byref(out))
    if err != 0 or not out.value:
        raise RuntimeError(f"wire_pack: no scratch for the captured launch (cudaError {err})")
    return out.value


def _launch(calls) -> List[WirePackOut]:
    """Check ``[B, N, LC]`` instances ``(spec, clocks, base, valid, know,
    dig, winc, ack_ok)`` against what K3 takes, launch them as one group
    on the current stream, and return their outputs; raises on anything
    it cannot take and on a failed launch."""
    if not 1 <= len(calls) <= MAX_GROUP:
        raise ValueError(f"wire_pack: one launch packs 1..{MAX_GROUP} instances, got {len(calls)}")
    for c in calls:
        _check_call(*c)
    dt = calls[0][1].dtype
    if any(c[1].dtype != dt for c in calls):
        raise TypeError("wire_pack: a group's instances must share one clock dtype")
    devs = {t.device for c in calls for t in c[1:] if t is not None}
    if len(devs) != 1:
        raise ValueError(f"wire_pack: inputs on several devices: {sorted(map(str, devs))}")
    total_b = sum(c[1].shape[0] for c in calls)
    if total_b > MAX_BATCHES:
        raise ValueError(f"wire_pack: one launch takes at most {MAX_BATCHES} batches, got {total_b}")

    lib = _kernel()
    # One allocation for every output: per instance its words and stats
    # (u32), then all flag planes (bytes).
    plan, n32, nflag = [], 0, 0
    for spec, clocks, *_ in calls:
        b, n, _ = clocks.shape
        plan.append((b, n, n32, n32 + b * n * spec.w, nflag))
        n32 += b * n * spec.w + 2 * b
        nflag += 3 * b * n
    dev = calls[0][1].device
    buf = torch.empty(n32 + -(-nflag // 4), dtype=torch.uint32, device=dev)
    flag_buf = buf[n32:].view(torch.bool)
    base_ptr, flag_ptr = buf.data_ptr(), flag_buf.data_ptr()

    desc = []
    for (spec, clocks, base, valid, know, dig, winc, ack_ok), (b, n, ow, os_, of) in zip(
            calls, plan):
        g, ac = spec.gated, spec.acked
        desc += [
            clocks.data_ptr(), base.data_ptr(), valid.data_ptr(),
            know.data_ptr() if g else 0, dig.data_ptr() if g else 0,
            winc.data_ptr() if ac else 0, ack_ok.data_ptr() if ac else 0,
            base_ptr + 4 * ow, flag_ptr + of, base_ptr + 4 * os_,
            b, n, spec.lc, spec.ctx_hi - spec.ctx_lo, spec.ctx_lo, spec.ctx_hi, int(g), int(ac),
            base.stride(0), base.stride(1), know.stride(0) if g else 0,
            know.stride(1) if g else 0, dig.stride(0) if g else 0, dig.stride(1) if g else 0,
        ]
    ctx = torch.cuda.device(dev) if dev.index != torch.cuda.current_device() else nullcontext()
    with ctx:
        stream = torch.cuda.current_stream().cuda_stream
        scratch = _scratch_ptr(lib, dev, stream)
        err = lib.crdt_wire_pack_many(dt.itemsize, len(calls), (ctypes.c_longlong * len(desc))(
            *desc), scratch, _SCRATCH, stream)
    if err != 0:
        raise RuntimeError(f"wire_pack: kernel launch failed (cudaError {err})")
    outs = []
    for spec, (b, n, ow, os_, of) in zip((c[0] for c in calls), plan):
        outs.append(WirePackOut(
            buf[ow:ow + b * n * spec.w].view(b, n, spec.w),
            *flag_buf[of:of + 3 * b * n].view(3, b, n).unbind(0),
            *buf[os_:os_ + 2 * b].view(b, 2).unbind(1),
        ))
    return outs


_ARGS = ("clocks", "base", "valid", "know", "dig", "winc", "ack_ok")


@ophooks.kernel("wire_pack")
def wire_pack_many(calls: Sequence[dict]) -> List[WirePackOut]:
    """Several fused pack passes in ONE launch of K3: ``calls`` holds each
    instance's :func:`wire_pack` keyword arguments (``spec``, ``clocks``,
    ``base``, ``valid`` and the optional inputs), and the result one
    :class:`WirePackOut` each, in order. CUDA instances share a clock
    dtype and a device (at most ``MAX_GROUP`` of them); CPU tensors take
    :func:`wire_pack_plain` for each. ``wire_pack.launches`` counts the
    launches, one per group, and ``wire_pack.acked_launches`` those whose
    group holds an acked instance."""
    items = []
    for c in calls:
        spec = c["spec"]
        args = tuple(c.get(k) for k in _ARGS)
        clocks = args[0]
        if clocks.dim() not in (2, 3):
            raise ValueError(
                f"wire_pack: clocks must be [N, LC] or [B, N, LC], got {tuple(clocks.shape)}")
        if clocks.shape[-1] != spec.lc:
            raise ValueError(
                f"wire_pack: clocks have {clocks.shape[-1]} lanes, spec.lc is {spec.lc}")
        items.append((spec, args))
    if not items:
        raise ValueError("wire_pack: nothing to pack")
    if all(t.device.type == "cpu" for _, args in items for t in args if t is not None):
        return [wire_pack_plain(spec, *args) for spec, args in items]
    stacked = [(spec, *(t if t is None or args[0].dim() == 3 else t[None] for t in args))
               for spec, args in items]
    outs = _launch(stacked)
    wire_pack.launches += 1
    wire_pack.acked_launches += any(spec.acked for spec, _ in items)
    return [out if args[0].dim() == 3 else WirePackOut(*(x[0] for x in out))
            for out, (_, args) in zip(outs, items)]


def wire_pack(
    spec: WireLaneSpec,
    clocks: torch.Tensor,
    base: torch.Tensor,
    valid: torch.Tensor,
    know: Optional[torch.Tensor] = None,
    dig: Optional[torch.Tensor] = None,
    winc: Optional[torch.Tensor] = None,
    ack_ok: Optional[torch.Tensor] = None,
) -> WirePackOut:
    """One fused pack pass over a flavor's slot clock matrix ``clocks
    [N, LC]`` (or a ``[B, N, LC]`` stack) with per-lane watermark
    ``base`` and per-slot ``valid``; ``know``/``dig`` ``[.., N, A]`` feed
    the digest verdict (``spec.gated``), ``winc [.., N, LC]`` /
    ``ack_ok [.., N]`` the ack verdict (``spec.acked``). Clock planes are
    ``uint32`` or ``uint64``. ``base``, ``know`` and ``dig`` may be strided
    views with contiguous lanes — one row per batch broadcast over the
    slots, or ``know`` a column range of ``clocks`` — and K3 reads them in
    place; every other input is contiguous.

    Replaces the TPU kernel ``_wire_kernel`` (crdt_tpu/ops/wire_kernels.py,
    launched by its ``wire_pack``). CPU tensors take
    :func:`wire_pack_plain`; CUDA tensors launch K3 on the current stream
    (a group of one, :func:`wire_pack_many`), and anything the kernel
    cannot take raises. ``wire_pack.launches`` counts the launches."""
    return wire_pack_many([dict(spec=spec, clocks=clocks, base=base, valid=valid, know=know,
                                dig=dig, winc=winc, ack_ok=ack_ok)])[0]


wire_pack.launches = 0
wire_pack.acked_launches = 0


def _kernel() -> ctypes.CDLL:
    from ._build import library

    lib = library("wire.cu")
    if lib.crdt_wire_pack_many.argtypes is None:
        p = ctypes.c_void_p
        lib.crdt_wire_pack_many.argtypes = [ctypes.c_int, ctypes.c_int, p, p,
                                            ctypes.c_longlong, p]
        lib.crdt_wire_pack_many.restype = ctypes.c_int
        lib.crdt_wire_graph_scratch.argtypes = [p, ctypes.c_longlong, ctypes.POINTER(p)]
        lib.crdt_wire_graph_scratch.restype = ctypes.c_int
    return lib


def wire_unpack(
    spec: WireLaneSpec, words: torch.Tensor, base: torch.Tensor,
    keep: torch.Tensor, ct: torch.dtype,
) -> torch.Tensor:
    """Invert the encoding for the kept slots: ``value = base + (enc16 -
    BIAS)`` wrapping in the clock dtype ``ct``, zeros elsewhere."""
    wd = to_wide(words)
    enc = torch.cat([wd & 0xFFFF, wd >> 16], dim=-1)[..., :spec.lc]
    dec = from_raw(raw(base[..., :spec.lc]) + enc - BIAS, ct)
    return torch.where(keep[..., None], bits(dec), 0).view(ct)


# ---- bitmaps and u16 pairs: plain torch ------------------------------------

def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """Bool lanes ``[.., n]`` as little-endian u32 bitmap words
    ``[.., ceil(n / 32)]`` (at least one word)."""
    n = flags.shape[-1]
    wn = max((n + 31) // 32, 1)
    x = torch.nn.functional.pad(flags.to(torch.int64), (0, wn * 32 - n))
    x = x.reshape(*flags.shape[:-1], wn, 32) << _shifts(flags.device)
    return _u32(x.sum(dim=-1))


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Invert :func:`pack_bits` to the first ``n`` bools."""
    x = (to_wide(words)[..., None] >> _shifts(words.device)) & 1
    return x.reshape(*words.shape[:-1], -1)[..., :n] != 0


def pack_u16_pairs(vals: torch.Tensor) -> torch.Tensor:
    """Lanes ``[.., n]`` of values < 2^16 as half-split u16 pairs in u32
    words ``[.., ceil(n / 2)]``: word ``j`` carries lanes ``j`` and
    ``H + j`` (the clock lanes' pairing)."""
    n = vals.shape[-1]
    h = (n + 1) // 2
    v = torch.nn.functional.pad(vals.to(torch.int64) & _MASK32, (0, 2 * h - n)) & 0xFFFF
    return _u32(v[..., :h] | (v[..., h:] << 16))


def unpack_u16_pairs(words: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """Invert :func:`pack_u16_pairs` to the first ``n`` lanes."""
    wd = to_wide(words)
    return torch.cat([wd & 0xFFFF, wd >> 16], dim=-1)[..., :n].to(dtype)


def leaf_checksum(leaf: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """``faults.integrity``'s per-leaf partial (position-weighted modular
    sum) of a wire leaf, as u32 — the chaining twin of K3's ``chk``."""
    from ..faults.integrity import leaf_sum

    return _u32(leaf_sum(leaf, batch_dims))


__all__ = [
    "BIAS", "LC_MAX", "WireLaneSpec", "WirePackOut", "leaf_checksum", "pack_bits",
    "pack_u16_pairs", "unpack_bits", "unpack_u16_pairs", "wire_pack", "wire_pack_many",
    "wire_pack_plain", "wire_unpack",
]
