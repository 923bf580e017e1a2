"""The fused replica folds — counterpart of the JAX package's
``ops/pallas_kernels.py``.

``ops.orswot.fold`` and ``ops.map.fold`` join a replica batch in a log2
tree, and every tree level reads and writes a half-size batch:
O(R·E·A·log R) bytes. The fused folds stream every replica's dense
counter matrix once through a hand-written CUDA kernel (``csrc/fold.cu``)
and settle the small deferred-removal buffers in a plain-torch epilogue:

- dense ORSWOT: kernel K1 (``fold_entries``, the orswot element rule) over
  ``ctr[R, E, A]``, then union all parked removes, replay once against
  the folded entries, drop caught-up slots, compact;
- Map<K, MVReg>: the slot tables decode to dense per-(key, actor) witness
  counters ``[R, K, A]`` (``_decode_wide``), kernel K2 (``fold_cells``,
  the cell rule) folds them, the surviving counter's replica supplies the
  payload (winner select), the parked keyset-removes replay once, and the
  cells go back to canonical slot tables (``_wide_to_slots``);
- the nested kinds (``ops.nest`` levels: ``Map<K, Orswot>``, ``Map3``,
  ``Map<K1, Map<K2, MVReg>>``, any depth): the leaf folds as above (K1
  for an ORSWOT leaf, K2 for a ``Map<K, MVReg>`` leaf), then each wrapper
  level, innermost first, settles its flattened ``R·D`` parked keyset
  slots once through the level's own ``settle_outer``
  (``fold_fused_level``).

Replaying once at the end equals the pairwise join's replay at every
node because replay is idempotent, monotone zeroing, and a slot is always
replayed before the catch-up drop — the CPU tests pin fused == tree fold
bit for bit.

Dispatch is by the tensor's device: a CUDA tensor runs the kernel (or
the call raises — there is no fallback), a CPU tensor runs the kernel's
plain torch version (``fold_entries_plain``, ``fold_cells_plain``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .._dtypes import bits, from_wide, to_wide, zeros
from ..utils import ophooks
from .lattice import tree_map
from .mvreg import MVRegState
from .orswot import (
    DTYPE,
    OrswotState,
    _compact_deferred,
    _dedupe_deferred,
    _join_entries,
    _settle,
)


def _halving_fold(top: torch.Tensor, ctr: torch.Tensor, join):
    """A log2 halving tree of ``join`` over the replica axis (the TPU
    kernel's in-chunk order): ``top[R, A]``, ``ctr[R, N, A]`` (u32) →
    wide ``(top[A], ctr[N, A])``."""
    tops, ctrs = to_wide(top), to_wide(ctr)
    while tops.shape[0] > 1:
        h = tops.shape[0] // 2
        jt, jc = join(tops[:h], ctrs[:h], tops[h:2 * h], ctrs[h:2 * h])
        if tops.shape[0] % 2:
            jt, jc = torch.cat([jt, tops[2 * h:]]), torch.cat([jc, ctrs[2 * h:]])
        tops, ctrs = jt, jc
    return tops[0], ctrs[0]


def fold_entries_plain(
    top: torch.Tensor, ctr: torch.Tensor, n_passes: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K1: ``top[R, A]``, ``ctr[R, E, A]`` (u32)
    → ``(top[A], ctr[E, A])``. A log2 halving tree of entry joins over
    the replica axis; ``n_passes`` joins the result with a re-fold that
    many times, which idempotence turns into the same bits."""
    r, e, a = ctr.shape
    if r == 0:
        return zeros((a,), DTYPE, ctr.device), zeros((e, a), DTYPE, ctr.device)
    once = None
    for _ in range(n_passes):
        part = _halving_fold(top, ctr, _join_entries)
        once = part if once is None else _join_entries(*once, *part)
    return from_wide(once[0], DTYPE), from_wide(once[1], DTYPE)


def _join_cells(a_top, a_w, b_top, b_w):
    """K2's cell rule on wide lanes (the JAX package's
    ``_join_step_cells``): cell (k, y) holds actor y's sole live witness
    counter at key k, so equal counters are the same dot (keep); else a
    side's counter survives only if the other side's top never saw it —
    at most one side can win. No presence term: absent is 0."""
    wa = torch.where(a_w > b_top[..., None, :], a_w, 0)
    wb = torch.where(b_w > a_top[..., None, :], b_w, 0)
    return torch.maximum(a_top, b_top), torch.where(a_w == b_w, a_w, torch.maximum(wa, wb))


def fold_cells_plain(top: torch.Tensor, wctr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K2: ``top[R, A]``, ``wctr[R, K, A]`` (u32)
    → ``(top[A], wctr[K, A])``, a log2 halving tree of cell joins."""
    r, k, a = wctr.shape
    if r == 0:
        return zeros((a,), DTYPE, wctr.device), zeros((k, a), DTYPE, wctr.device)
    t, w = _halving_fold(top, wctr, _join_cells)
    return from_wide(t, DTYPE), from_wide(w, DTYPE)


def _check(fn: str, name: str, t: torch.Tensor, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.uint32:
        raise TypeError(f"{fn}: {name} must be uint32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _launch(fn: str, entry: str, top: torch.Tensor, ctr: torch.Tensor, n_passes: int):
    """Check ``top[R, A]``, ``ctr[R, N, A]`` against what fold.cu's
    kernels take, and launch ``entry`` on the current stream. Returns
    ``(top_out[A], ctr_out[N, A])``; raises on anything it cannot take
    and on a failed launch."""
    r, n, a = ctr.shape
    _check(fn, "top", top, (r, a))
    _check(fn, "ctr", ctr, (r, n, a))
    if top.device != ctr.device:
        raise ValueError(f"{fn}: top on {top.device}, ctr on {ctr.device}")
    if not 1 <= a <= 32:
        raise ValueError(f"{fn}: the kernel takes 1..32 actor lanes, got {a}")
    if n_passes < 1:
        raise ValueError(f"{fn}: n_passes must be >= 1, got {n_passes}")
    lib = _kernel()
    with torch.cuda.device(ctr.device):
        top_out = torch.empty((a,), dtype=torch.uint32, device=ctr.device)
        ctr_out = torch.empty((n, a), dtype=torch.uint32, device=ctr.device)
        vec = a % 4 == 0 and top.data_ptr() % 16 == 0 and ctr.data_ptr() % 16 == 0
        err = getattr(lib, entry)(
            top.data_ptr(), ctr.data_ptr(), top_out.data_ptr(), ctr_out.data_ptr(),
            r, n, a, n_passes, int(vec), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {err})")
    return top_out, ctr_out


@ophooks.kernel("fold_entries")
def fold_entries(
    top: torch.Tensor, ctr: torch.Tensor, n_passes: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused fold of the entry matrices: ``top[R, A]``, ``ctr[R, E, A]``
    (u32) → ``(top[A], ctr[E, A])``.

    Replaces the TPU kernel ``_fold_kernel`` + ``_join_step``
    (crdt_tpu/ops/pallas_kernels.py, via ``_fold_entries_fused``). Bound
    on an H100 by device-memory bandwidth: it reads R·E·A·4 bytes once
    (33.55 GB at config 3, R=10240 E=102400 A=8: ≈10.0 ms at the
    nominal 3.35 TB/s). CPU tensors take ``fold_entries_plain``; CUDA
    tensors launch K1 on the current stream, and anything the kernel
    cannot take raises. ``fold_entries.launches`` counts the launches."""
    if ctr.dim() != 3:
        raise ValueError(f"fold_entries: ctr must be [R, E, A], got {tuple(ctr.shape)}")
    if ctr.device.type == "cpu" and top.device.type == "cpu":
        return fold_entries_plain(top, ctr, n_passes)
    out = _launch("fold_entries", "crdt_fold_entries", top, ctr, n_passes)
    fold_entries.launches += 1
    return out


fold_entries.launches = 0


@ophooks.kernel("fold_cells")
def fold_cells(top: torch.Tensor, wctr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused fold of the Map<K, MVReg> witness-counter cells:
    ``top[R, A]``, ``wctr[R, K, A]`` (u32) → ``(top[A], wctr[K, A])``.

    Replaces the TPU kernel ``_fold_kernel`` + ``_join_step_cells``
    (crdt_tpu/ops/pallas_kernels.py, via ``_fold_entries_fused(...,
    cellwise=True)`` from ``_fold_fused_map_jit``). Bound on an H100 by
    device-memory bandwidth: it reads R·K·A·4 bytes once and writes
    K·A·4 (config 4, R=8 K=1M A=4: 144 MB, ≥ 0.043 ms at the nominal
    3.35 TB/s). CPU tensors take ``fold_cells_plain``; CUDA tensors
    launch K2 on the current stream, and anything the kernel cannot take
    raises. ``fold_cells.launches`` counts the launches."""
    if wctr.dim() != 3:
        raise ValueError(f"fold_cells: wctr must be [R, K, A], got {tuple(wctr.shape)}")
    if wctr.device.type == "cpu" and top.device.type == "cpu":
        return fold_cells_plain(top, wctr)
    out = _launch("fold_cells", "crdt_fold_cells", top, wctr, 1)
    fold_cells.launches += 1
    return out


fold_cells.launches = 0


def _kernel() -> ctypes.CDLL:
    from ._build import library

    lib = library("fold.cu")
    for fn in (lib.crdt_fold_entries, lib.crdt_fold_cells):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


# ---- dense ORSWOT ----------------------------------------------------------

def settle_folded(top: torch.Tensor, ctr: torch.Tensor, states: OrswotState):
    """The fused fold's deferred epilogue: the folded entries ``(top[A],
    ctr[E, A])`` plus every replica's parked removes → the converged
    state and overflow flag (the JAX package's ``_fold_fused_jit``
    epilogue). Only valid slots are gathered, in their original order:
    invalid slots never key a dedupe group, replay nothing and are
    compacted away, so the result is the same bits as settling all R·D
    slots, in memory linear in the valid ones."""
    dcl, dmask, dvalid = _valid_slots(states.dcl, states.dmask, states.dvalid)
    return _settle(to_wide(top), to_wide(ctr), dcl, dmask, dvalid, states.dvalid.shape[-1])


def _valid_slots(dcl, dmask, dvalid):
    """The valid parked slots of ``[R, D, ...]`` buffers, flattened in
    their original order: wide clocks, masks, and an all-True valid."""
    pos = torch.nonzero(dvalid.reshape(-1)).squeeze(1)
    dcl = to_wide(dcl.reshape(-1, dcl.shape[-1]))[pos]
    dmask = dmask.reshape(-1, dmask.shape[-1])[pos]
    return dcl, dmask, torch.ones(pos.shape, dtype=torch.bool, device=pos.device)


def fold_fused(states: OrswotState, n_passes: int = 1) -> Tuple[OrswotState, torch.Tensor]:
    """Drop-in replacement for ``ops.orswot.fold`` (same result, same
    overflow flag) with the replica reduction fused into one pass over
    the entry matrices. ``n_passes`` re-walks the replica batch (same
    result by idempotence)."""
    top, ctr = fold_entries(states.top, states.ctr, n_passes)
    return settle_folded(top, ctr, states)


def _pick(prefer: str, states_on_card: bool) -> bool:
    """True for the fused fold: "fused", or "auto" on a CUDA state (or on
    any state inside ``utils.ophooks.card_routes``)."""
    if prefer not in ("auto", "fused", "tree"):
        raise ValueError(f"prefer must be auto|fused|tree, got {prefer!r}")
    return prefer == "fused" or (prefer == "auto" and (states_on_card
                                                       or ophooks.on_card_routes()))


def fold_auto(states: OrswotState, prefer: str = "auto"):
    """Local replica-batch fold with device dispatch: the fused fold (K1
    + epilogue) for CUDA states, the plain log-tree fold for CPU states.
    ``prefer``: "auto" (device pick), "fused" (on the CPU: K1's plain
    version + the same epilogue), or "tree". Same ``(state, overflow)``
    contract as ``ops.orswot.fold``; bit-identical either way."""
    from .orswot import fold as tree_fold

    if _pick(prefer, states.ctr.is_cuda):
        return fold_fused(states)
    return tree_fold(states)


# ---- Map<K, MVReg> -----------------------------------------------------------

def _owners(child: MVRegState, a: int) -> torch.Tensor:
    """``own[..., K, S, A]``: slot s of key k is actor a's live sibling."""
    ids = torch.arange(a, dtype=child.wact.dtype, device=child.wact.device)
    return (child.wact[..., None] == ids) & child.valid[..., None]


def _cell_max(own: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per (key, actor) cell, the max over the slots the actor owns of
    ``x`` (0 where it owns none): ``[..., K, S]`` → ``[..., K, A]``, or
    ``[..., K, S, L]`` → ``[..., K, A, L]``. Wide lanes."""
    if x.dim() == own.dim() - 1:
        return torch.where(own, x[..., None], 0).amax(dim=-2)
    return torch.where(own[..., None], x[..., :, None, :], 0).amax(dim=-3)


def _decode_wide(child: MVRegState, a: int):
    """Slot table ``MVRegState [..., K, S…]`` → dense per-(key, actor)
    cells, wide lanes: ``wctr [..., K, A]``, ``val1 [..., K, A]`` (value
    id + 1; 0 = absent), ``clk [..., K, A, A]``.

    Sound because a key holds at most one live sibling per actor: a
    later write by the same actor carries a clock ≥ its earlier write's,
    so apply-time domination evicts the older one, and the merge
    survival rule kills the smaller counter against the witnessing
    side's top (``_join_cells``). The JAX package lays the cells out
    K-minor to dodge the TPU's lane padding; here A is the minor axis,
    as in K1's entry matrices, so K2 shares K1's loads."""
    own = _owners(child, a)
    return (
        _cell_max(own, to_wide(child.wctr)),
        _cell_max(own, child.val.to(torch.int64) + 1),
        _cell_max(own, to_wide(child.clk)),
    )


def _wide_to_slots(wctr: torch.Tensor, val1: torch.Tensor, clk: torch.Tensor, s: int) -> MVRegState:
    """Dense cells (unbatched, wide: ``wctr [K, A]``, ``val1 [K, A]``,
    ``clk [K, A, A]``) → the canonical slot table fitted to S slots,
    ``[K, S(, A)]``, u32 clock planes."""
    k, a = wctr.shape
    present = wctr > 0
    # Canonical slot order (ops/map._canon_child): valid first, then by
    # actor (unique per key, so no further tiebreak is needed).
    order = torch.argsort((~present).to(torch.uint8), dim=-1, stable=True)  # [K, A] actor ids
    take = lambda x: torch.take_along_dim(x, order, dim=-1)  # noqa: E731
    valid = take(present)
    slots = MVRegState(
        wact=torch.where(valid, order, 0).to(torch.int32),
        wctr=torch.where(valid, take(wctr), 0),
        clk=torch.where(valid[..., None], torch.take_along_dim(clk, order[..., None], dim=-2), 0),
        val=torch.where(valid, take(val1) - 1, 0).to(torch.int32),
        valid=valid,
    )

    # Back to the slot capacity: truncate (A > S) or zero-pad (A < S) —
    # canonical form keeps dead slots zeroed either way.
    def fit(x):
        if x.dim() == 3:
            return x[:, :s] if a >= s else F.pad(x, (0, 0, 0, s - a))
        return x[:, :s] if a >= s else F.pad(x, (0, s - a))

    slots = MVRegState(*(fit(x) for x in slots))
    return slots._replace(wctr=from_wide(slots.wctr, DTYPE), clk=from_wide(slots.clk, DTYPE))


# Replicas decoded at once by the fused Map fold: the payload decode of
# one replica holds K·S·A·A int64 lanes, so chunks keep it near this size.
_DECODE_BYTES = 1 << 30


def _replica_chunks(child: MVRegState, a: int):
    """``(lo, child[lo:lo + step])`` over the replica axis, ``step`` sized
    so one chunk's payload decode stays near ``_DECODE_BYTES``."""
    r, k, s = child.wact.shape
    step = max(1, _DECODE_BYTES // max(1, k * s * a * a * 8))
    return [(lo, tree_map(lambda x: x[lo:lo + step], child)) for lo in range(0, r, step)]


def decode_cells(states) -> torch.Tensor:
    """K2's input: the slot tables of ``states`` (``ops.map.MapState``,
    ``[R, K, S…]``) as dense witness-counter cells ``wctr[R, K, A]``,
    u32. Decoded chunk by chunk into one preallocated tensor."""
    r, k, _ = states.child.wact.shape
    a = states.top.shape[-1]
    cells = zeros((r, k, a), DTYPE, states.top.device)
    for lo, part in _replica_chunks(states.child, a):
        w = _cell_max(_owners(part, a), to_wide(part.wctr))
        bits(cells)[lo:lo + w.shape[0]] = bits(from_wide(w, DTYPE))
    return cells


def fold_fused_map(states):
    """Fused fold for ``Map<K, MVReg>`` (``ops.map.MapState``) — the
    config-4 hot loop with one streamed pass over the counter cells.

    The slot tables decode to a dense per-(key, actor) witness-counter
    slab (``decode_cells``), narrowed to u32, whose replica fold is the
    cell rule — kernel K2 (``fold_cells``). ``settle_folded_map`` then
    rebuilds the payload and settles the parked removes. Returns
    ``(state, flags[2])`` like ``ops.map.fold``."""
    top, folded = fold_cells(states.top, decode_cells(states))
    return settle_folded_map(top, folded, states)


def settle_folded_map(top: torch.Tensor, folded: torch.Tensor, states):
    """The fused Map fold's epilogue: the folded cells ``(top[A],
    wctr[K, A])`` plus every replica's slot tables and parked removes →
    the converged state and flags (the JAX package's
    ``_fold_fused_map_jit`` after its kernel). Payload (val, clk) follows
    the surviving counter by a winner-select reduction, then the parked
    keyset-removes replay once on the cells BEFORE the sibling-capacity
    check (the tree join's transient-overflow semantics). The winner
    select walks the replicas in chunks, so its memory stays near
    ``_DECODE_BYTES`` whatever R is."""
    from .map import MapState

    k, s = states.child.wact.shape[1:]
    a = states.top.shape[-1]
    dev = states.top.device

    # Winner-select payload: the surviving counter's replica supplies
    # val and clk (ties ⇒ same dot ⇒ same payload, max is safe).
    fw = to_wide(folded)
    live = fw > 0
    val1 = torch.zeros((k, a), dtype=torch.int64, device=dev)
    clk = torch.zeros((k, a, a), dtype=torch.int64, device=dev)
    for _, part in _replica_chunks(states.child, a):
        w, v, c = _decode_wide(part, a)
        match = (w == fw) & live
        val1 = torch.maximum(val1, torch.where(match, v, 0).amax(dim=0))
        clk = torch.maximum(clk, torch.where(match[..., None], c, 0).amax(dim=0))

    # Parked keyset-removes: union → dedupe → replay on the cells (cell
    # (k, y) dies iff some parked slot masks key k with a clock covering
    # its dot) → drop caught-up → compact, then the capacity check.
    d = states.dvalid.shape[-1]
    dcl, dkeys, dvalid = _dedupe_deferred(*_valid_slots(states.dcl, states.dkeys, states.dvalid))
    maxcov = torch.zeros_like(fw)
    for cl, keys in zip(dcl[dvalid], dkeys[dvalid]):
        maxcov = torch.maximum(maxcov, torch.where(keys[:, None], cl[None, :], 0))
    kill = live & (fw <= maxcov)
    fw = torch.where(kill, 0, fw)
    val1 = torch.where(kill, 0, val1)
    clk = torch.where(kill[..., None], 0, clk)

    dvalid = dvalid & ~torch.all(dcl <= to_wide(top)[None, :], dim=-1)
    dcl, dkeys, dvalid, d_of = _compact_deferred(dcl, dkeys, dvalid, d)

    c_of = torch.any((fw > 0).sum(dim=-1) > s)
    state = MapState(
        top=top, child=_wide_to_slots(fw, val1, clk, s),
        dcl=from_wide(dcl, DTYPE), dkeys=dkeys, dvalid=dvalid,
    )
    return state, torch.stack([c_of, torch.any(d_of)])


def fold_auto_map(states, prefer: str = "auto"):
    """Replica-batch fold dispatch for ``Map<K, MVReg>``: the fused fold
    (K2 + epilogue) for CUDA states, the plain log-tree fold for CPU
    states; "fused" on the CPU runs K2's plain version + the same
    epilogue. Same ``(state, flags)`` contract as ``ops.map.fold``."""
    from .map import _tree_fold

    if _pick(prefer, states.top.is_cuda):
        return fold_fused_map(states)
    return _tree_fold(states)


# ---- nested levels (ops.nest) ------------------------------------------------

def _level_chain(level, states):
    """``(outermost-first [(level, state)], leaf state)`` of a nested
    state."""
    from .nest import NestLevel

    chain, st, lv = [], states, level
    while isinstance(lv, NestLevel):
        chain.append((lv, st))
        lv, st = lv.core, st[0]
    return chain, st


def fold_fused_level(level, states, element_axis=None):
    """Drop-in fused replacement for ``NestLevel.fold`` (the JAX package's
    ``fold_fused_level``) on any nested level (``map_orswot``, ``map3``,
    ``map_map``, deeper compositions): the leaf folds in one streamed pass
    (an ORSWOT leaf through ``fold_fused``: K1, then ``settle_folded``; a
    ``Map<K, MVReg>`` leaf through ``fold_fused_map``: ``decode_cells`` →
    K2 → ``settle_folded_map``), then every wrapper level, innermost
    first, flattens its ``[R, D, …]`` buffers to ``R·D`` slots and settles
    them once through its own ``settle_outer`` (dedupe → replay → compact
    → scrub). Only the valid slots are gathered, in their original order:
    an invalid slot keys no dedupe group, replays nothing and compacts
    away, so the bits are those of settling all ``R·D``. Replaying once at
    the end equals the tree's replay at every node (monotone, idempotent
    zeroing, always before the catch-up drop); parked slots come out in
    another order than the tree fold's, the same set.

    ``states`` carry the replica axis first and no element-shard axis
    (``element_axis`` is passed through to the levels' scrubs, for
    shard axes inside the state's own leading axes). Returns ``(state,
    flags [L])``, innermost level first (``NestLevel.fold``'s order)."""
    from .orswot import OrswotState

    _, leaf = _level_chain(level, states)
    if isinstance(leaf, OrswotState):
        folded, leaf_of = fold_fused(leaf)
    else:
        folded, leaf_of = fold_fused_map(leaf)
    return settle_levels(level, states, folded, leaf_of, element_axis)


def settle_levels(level, states, folded_leaf, leaf_of, element_axis=None):
    """The fused level fold's wrapper epilogue: the folded leaf (and its
    flags) plus every wrapper level's ``[R, D, …]`` parked buffers → the
    converged nest and its flags, innermost level first. Each level,
    innermost first, settles its valid slots (flattened, in their
    original order) once through ``settle_outer``."""
    chain, _ = _level_chain(level, states)
    folded = folded_leaf
    flags = [torch.atleast_1d(leaf_of)]
    for lv, bst in reversed(chain):  # innermost wrapper first
        dcl, dkeys, dvalid = _valid_slots(bst[1], bst[2], bst[3])
        wrapped = lv._make(folded, from_wide(dcl, DTYPE), dkeys, dvalid)
        folded, of = lv.settle_outer(wrapped, bst[1].shape[-2], element_axis)
        flags.append(torch.atleast_1d(of))
    return folded, torch.cat(flags)


def fold_auto_level(level, states, prefer: str = "auto", element_axis=None):
    """Replica-batch fold dispatch for the nested kinds — the
    ``fold_auto`` of composed slabs: the fused level fold for CUDA states,
    the plain log-tree fold (``level.fold``) for CPU states; "fused" on
    the CPU runs K1's / K2's plain version + the same epilogue. Same
    ``(state, flags)`` contract as ``NestLevel.fold``."""
    from .lattice import tree_leaves

    if _pick(prefer, tree_leaves(states)[0].is_cuda):
        return fold_fused_level(level, states, element_axis)
    return level.fold(states, element_axis)
