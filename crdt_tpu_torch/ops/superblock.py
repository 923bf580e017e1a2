"""Tenant-packed superblocks — many independent CRDTs, one dispatch. The
port of the JAX package's ``ops/superblock.py``, bit for bit.

A superblock prepends a TENANT (lane) axis to a per-kind state layout —
``T`` independent ORSWOTs live in one ``[T, ...]`` state on the card —
and applies a whole coalesced batch of per-tenant CmRDT ops at once:

    gather touched rows -> S sequential op slots, each the lane-batched
    add AND rm over all B lanes, picked per lane -> scatter rows back.

The op container is :class:`OpSlab`: ``B`` tenant lanes × ``S``
sequential slots. Within one slab a tenant occupies AT MOST ONE lane
(the ingest queue, ``serve/ingest.py``, enforces it), so the row scatter
has unique targets; a lane's ``S`` slots apply in submission order,
which is why the coalesced apply is bit-identical to the per-tenant
:func:`sequential_oracle` over the unbatched op functions.

The JAX package's slot step is ``jax.vmap`` of the per-tenant
``apply_add``/``apply_rm``; here it is those functions called once with
a leading lane axis (``ops.orswot.apply_add`` takes a per-lane actor and
counter, ``ops.sparse_orswot``'s appliers run along the last axis), so a
slot is a fixed number of launches whatever B is, and nothing in a slab
apply waits for the host. Per-kind support rides the adapter table
:data:`TENANT_KINDS`.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch

from .._dtypes import bits
from ..convert import leaf_from_numpy, leaf_to_numpy
from . import orswot as dense_ops
from . import sparse_orswot as sparse_ops

# Op slot kinds. NOOP lanes/slots apply the identity — padding never
# touches state, so a partially filled slab is sound by construction.
NOOP, ADD, RM = 0, 1, 2


class OpSlab(NamedTuple):
    """One coalesced batch of per-tenant ops: ``B`` tenant lanes × ``S``
    sequential slots (the slot axis applies in order). ``member`` is the
    kind's member descriptor: ``bool[B, S, E]`` element masks for the
    dense kind, ``int32[B, S, W]`` element-id lists (-1 = pad) for the
    sparse kind."""

    kind: torch.Tensor    # [B, S] uint8 — NOOP / ADD / RM
    actor: torch.Tensor   # [B, S] int32 — add mint site
    ctr: torch.Tensor     # [B, S] uint32 — add counter
    clock: torch.Tensor   # [B, S, A] uint32 — rm clock
    member: torch.Tensor  # [B, S, *] — per-kind member descriptor


class TenantKind(NamedTuple):
    """One superblock-capable kind: the per-kind functions the slab apply
    composes, normalised so ADD and RM both return ``(state, overflow)``.
    ``member_plane(caps)`` gives the op member descriptor's trailing
    shape, numpy dtype and pad fill; ``caps`` is the kind's capacity dict
    (the ``empty`` kwargs minus ``batch`` and ``device``)."""

    name: str
    empty: Callable          # (**caps, batch=..., device=...) -> state
    apply_add: Callable      # (state, actor, ctr, member) -> (state, of)
    apply_rm: Callable       # (state, clock, member) -> (state, of)
    member_plane: Callable   # caps -> (shape tuple, numpy dtype, fill)
    changed: Callable        # (a, b) -> uint32 changed-lane count
    join: Callable           # (a, b) -> (state, overflow)
    compact: Callable        # (state, frontier) -> (state, n, bytes)
    widen: Callable
    narrow: Callable
    observe: Callable        # state -> observable read tree
    n_actors_of: Callable    # state -> A (clock lane width)
    caps_of: Callable        # state -> its capacity dict (empty kwargs)


def _dense_add(state, actor, ctr, member):
    return (dense_ops.apply_add(state, actor, ctr, member),
            torch.zeros(state.top.shape[:-1], dtype=torch.bool, device=state.top.device))



TENANT_KINDS: Dict[str, TenantKind] = {
    "orswot": TenantKind(
        name="orswot",
        empty=dense_ops.empty,
        apply_add=_dense_add,
        apply_rm=dense_ops.apply_rm,
        member_plane=lambda caps: ((caps["n_elems"],), np.bool_, False),
        changed=dense_ops.changed_members,
        join=dense_ops.join,
        compact=dense_ops.compact,
        widen=dense_ops.widen,
        narrow=dense_ops.narrow,
        observe=lambda s: torch.any(bits(s.ctr) != 0, dim=-1),
        n_actors_of=lambda s: s.top.shape[-1],
        caps_of=lambda s: dict(
            n_elems=s.ctr.shape[-2], n_actors=s.top.shape[-1], deferred_cap=s.dvalid.shape[-1],
        ),
    ),
    "sparse_orswot": TenantKind(
        name="sparse_orswot",
        empty=sparse_ops.empty,
        apply_add=sparse_ops.apply_add,
        apply_rm=sparse_ops.apply_rm,
        # One list width for ADD and RM: the rm width bounds both, so a
        # parked remove's element list always fits its didx lanes.
        member_plane=lambda caps: ((caps["rm_width"],), np.int32, -1),
        changed=sparse_ops.changed_dots,
        join=sparse_ops.join,
        compact=sparse_ops.compact,
        widen=sparse_ops.widen,
        narrow=sparse_ops.narrow,
        observe=lambda s: (s.eid, s.act, s.ctr, s.valid),
        n_actors_of=lambda s: s.top.shape[-1],
        caps_of=lambda s: dict(
            dot_cap=s.eid.shape[-1], n_actors=s.top.shape[-1],
            deferred_cap=s.dvalid.shape[-1], rm_width=s.didx.shape[-1],
        ),
    ),
}


def tenant_kind(name: str) -> TenantKind:
    if name not in TENANT_KINDS:
        raise KeyError(f"no superblock adapter for kind {name!r} (know {sorted(TENANT_KINDS)})")
    return TENANT_KINDS[name]


# ---- pack / unpack --------------------------------------------------------

def pack(states: Sequence):
    """Stack per-tenant states (uniform shapes) into one superblock — the
    tenant axis prepended on every plane. Exact inverse of :func:`unpack`
    row-wise."""
    states = list(states)
    if not states:
        raise ValueError("pack() of zero tenants")
    if len({tuple(x.shape for x in s) for s in states}) != 1:
        raise ValueError(
            "pack() needs uniform per-tenant shapes — widen the narrow tenants first"
        )
    return type(states[0])(*(torch.stack([bits(x) for x in xs]).view(xs[0].dtype)
                             for xs in zip(*states)))


def unpack(superblock, tenant: int):
    """One tenant's state, sliced off the tenant axis."""
    return type(superblock)(*(x[tenant] for x in superblock))


def _lane_index(idx, like: torch.Tensor) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(device=like.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx, np.int64), device=like.device)


def gather_rows(superblock, idx):
    """Rows ``idx`` of the superblock, indexed as the JAX gather is: a
    negative index counts from the end, and what is still out of range
    clamps. Callers mask separately (the slab path routes invalid lanes to
    NOOP ops, so a clamped gather is never observable)."""
    t = superblock[0].shape[0]
    idx = _lane_index(idx, superblock[0])
    idx = torch.where(idx < 0, idx + t, idx).clamp(0, t - 1)
    return type(superblock)(*(bits(x).index_select(0, idx).view(x.dtype) for x in superblock))


def write_rows(superblock, idx, rows):
    """Scatter per-tenant rows back into a copy of the superblock (unique
    ``idx`` by the ingest contract; ``-1`` lanes drop)."""
    out = type(superblock)(*(x.clone() for x in superblock))
    write_rows_(out, idx, rows)
    return out


def write_rows_(superblock, idx, rows) -> None:
    """:func:`write_rows` in place, on the superblock's own tensors. A
    dropped lane (``-1`` or out of range) writes what the first valid
    lane writes, to that lane's target — or, when no lane is valid, the
    current content of one row back to it — so every duplicate target
    receives identical bytes and nothing waits for the host to count the
    valid lanes."""
    ref = superblock[0]
    idx = _lane_index(idx, ref)
    t = ref.shape[0]
    valid = (idx >= 0) & (idx < t)
    first = torch.argmax(valid.to(torch.uint8)).view(1)
    any_valid = valid.gather(0, first)
    tgt0 = idx.gather(0, first).clamp(0, t - 1)
    tgt = torch.where(valid, idx, tgt0)
    for x, r in zip(superblock, rows):
        if not idx.shape[0]:
            return
        src = bits(r.to(ref.device))
        lane_shape = (-1, *([1] * (src.dim() - 1)))
        fill = torch.where(any_valid.view(lane_shape), src.index_select(0, first),
                           bits(x).index_select(0, tgt0))
        bits(x).index_copy_(0, tgt, torch.where(valid.view(lane_shape), src, fill))


def to_host(state):
    """A state as the same tree of numpy leaves (u32 stays ``<u4``)."""
    return type(state)(*(leaf_to_numpy(x) for x in state))


def to_device(row, device):
    """A tree of numpy or tensor leaves as tensors on ``device``."""
    return type(row)(*(x.to(device) if isinstance(x, torch.Tensor) else
                       leaf_from_numpy(np.asarray(x), device) for x in row))


# ---- the coalesced slab apply --------------------------------------------

def empty_slab(tk: TenantKind, caps: dict, lanes: int, depth: int, device="cuda") -> OpSlab:
    """An all-NOOP slab of ``lanes`` × ``depth`` for capacity dict
    ``caps`` — the fill target the ingest queue writes into."""
    a = caps["n_actors"]
    mshape, mdtype, mfill = tk.member_plane(caps)
    return OpSlab(
        kind=torch.zeros((lanes, depth), dtype=torch.uint8, device=device),
        actor=torch.zeros((lanes, depth), dtype=torch.int32, device=device),
        ctr=torch.zeros((lanes, depth), dtype=torch.int32, device=device).view(torch.uint32),
        clock=torch.zeros((lanes, depth, a), dtype=torch.int32, device=device).view(torch.uint32),
        member=leaf_from_numpy(np.full((lanes, depth, *mshape), mfill, mdtype), device),
    )


def _pick(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where(cond[lane], a, b)`` over a leaf's trailing axes, bit for bit
    on any dtype (unsigned lanes through their signed view)."""
    c = cond.view(-1, *([1] * (a.dim() - 1)))
    return torch.where(c, bits(a), bits(b)).view(a.dtype)


def apply_slab_rows(tk: TenantKind, rows, slab: OpSlab):
    """Apply one slab to its gathered tenant rows: ``S`` sequential steps,
    each computing the add AND the rm for all ``B`` lanes and picking per
    lane (NOOP keeps the row bit-identical). Returns ``(rows,
    overflow[B])`` — overflow, OR-ed over the steps, is the per-tenant
    deferred / dot-capacity pressure signal the serve layer widens on."""
    of = torch.zeros(slab.kind.shape[0], dtype=torch.bool, device=slab.kind.device)
    for s in range(slab.kind.shape[1]):
        k = slab.kind[:, s]
        is_add, is_rm = k == ADD, k == RM
        added, of_a = tk.apply_add(rows, slab.actor[:, s], slab.ctr[:, s], slab.member[:, s])
        removed, of_r = tk.apply_rm(rows, slab.clock[:, s], slab.member[:, s])
        rows = type(rows)(*(_pick(is_add, a, _pick(is_rm, r, x))
                            for a, r, x in zip(added, removed, rows)))
        of = of | (is_add & of_a) | (is_rm & of_r)
    return rows, of


def compact_tenants(tk: TenantKind, superblock, frontier):
    """Causal-stability compaction lifted over the tenant axis: the kind's
    compact over every tenant in one batched pass. ``frontier [T, A]`` is
    per tenant (each tenant is its own causal domain: a single-replica
    tenant's own top IS its stable frontier). Returns ``(superblock,
    freed_slots, freed_bytes)`` summed over the tenants."""
    return tk.compact(superblock, frontier)


def sequential_oracle(tk: TenantKind, state, ops_list):
    """The per-tenant SEQUENTIAL oracle: apply one tenant's op stream one
    op at a time on its unbatched state, through the unbatched op
    functions — the bit-identity reference for the coalesced slab apply.
    ``ops_list`` entries are ``(kind, actor, ctr, clock, member)`` host
    tuples."""
    for k, actor, ctr, clock, member in ops_list:
        if k == ADD:
            state, _ = tk.apply_add(state, int(actor), int(ctr), np.asarray(member))
        elif k == RM:
            state, _ = tk.apply_rm(state, np.asarray(clock, np.uint32), np.asarray(member))
    return state


__all__ = [
    "ADD", "NOOP", "OpSlab", "RM", "TENANT_KINDS", "TenantKind", "apply_slab_rows",
    "compact_tenants", "empty_slab", "gather_rows", "pack", "sequential_oracle",
    "tenant_kind", "to_device", "to_host", "unpack", "write_rows",
    "write_rows_",
]
