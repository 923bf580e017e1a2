"""``mesh_serve_apply`` — the tenant-packed serving dispatch, the port of
the JAX package's ``parallel/serve_apply.py``.

One call applies a whole coalesced :class:`~crdt_tpu_torch.ops.superblock.OpSlab`
to a tenant superblock whose lane axis is split over the P virtual
ranks of a :class:`~crdt_tpu_torch.parallel.mesh.VirtualMesh` (rank r
owns lanes ``[r·L/P, (r+1)·L/P)``, the block a ``P(REPLICA_AXIS)``
sharding gives device r). Tenants are independent — no cross-tenant
collective exists — so the P ranks' gathers, slot steps and scatters
run as one batch over all B slab lanes.

Index convention (the JAX one): ``idx[B] int32`` carries LOCAL row
indices — slab lane block ``[r·B/P, (r+1)·B/P)`` belongs to rank r and
its values index that rank's lane block; ``-1`` lanes are empty (their
slots are NOOP and their scatter drops). The host-side ingest queue
(``serve/ingest.py``) owns this layout and the at-most-one-lane-per-
tenant contract that makes the scatter conflict-free.

``donate=True`` (the JAX buffer donation) writes the new rows into the
caller's tensors in place and returns them; ``donate=False`` leaves the
caller's state untouched. Nothing in a call waits for the host.
``telemetry=True`` adds the JAX dispatch's Telemetry: the lanes the slab
changed, the slab as the serving tier's wire (``bytes_exchanged``), its
non-NOOP slots at one slot's price (``bytes_useful``), the touched rows'
parked depth and pressure.
"""

from __future__ import annotations

import time

import torch

from .. import telemetry as tele
from ..ops import superblock as sb_ops
from .mesh import VirtualMesh


def _validate(state, slab: sb_ops.OpSlab, idx, p: int) -> None:
    t = state[0].shape[0]
    b = slab.kind.shape[0]
    if t % p:
        raise ValueError(f"{t} tenant rows do not divide the {p}-way replica axis")
    if b % p or idx.shape[0] != b:
        raise ValueError(
            f"slab lanes ({b}) and idx ({idx.shape[0]}) must match and "
            f"divide the {p}-way replica axis"
        )


def global_rows(idx: torch.Tensor, lanes: int, b: int, p: int) -> torch.Tensor:
    """Each slab lane's global superblock row: rank ``lane // (B/P)``'s
    block offset plus the local index clamped into it (the JAX per-rank
    ``clip(idx, 0, L/P - 1)``), as int64 on ``idx``'s device."""
    lpr = lanes // p
    rank = torch.arange(b, device=idx.device) // (b // p)
    return rank * lpr + idx.to(torch.int64).clamp(0, lpr - 1)


def mesh_serve_apply(
    state,
    slab: sb_ops.OpSlab,
    idx,
    mesh: VirtualMesh,
    *,
    kind: str = "orswot",
    donate: bool = False,
    telemetry: bool = False,
    sync: bool = True,
):
    """Apply one coalesced op slab to a tenant superblock split over the
    mesh's virtual ranks. Returns ``(state, overflow[B])``: ``overflow``
    flags tenants whose bounded buffers could not take an op (deferred
    parking / sparse dot capacity) — the serve layer's widen-before-retry
    signal (``serve/superblock.py``). Every input must lie on the mesh's
    device. ``telemetry=True`` returns ``(state, overflow, Telemetry)``;
    with ``sync=True`` the call then waits for the card and folds its
    wall-clock into ``hist_dispatch_us``, with ``sync=False`` (the
    pipelined serving loop's issue half) it returns at once and the
    caller times the dispatch."""
    t0 = time.perf_counter()
    tk = sb_ops.tenant_kind(kind)
    p = mesh.p
    idx = idx if isinstance(idx, torch.Tensor) else torch.as_tensor(idx)
    _validate(state, slab, idx, p)
    idx = idx.to(device=state[0].device)
    b, lanes = slab.kind.shape[0], state[0].shape[0]
    rows = sb_ops.gather_rows(state, global_rows(idx, lanes, b, p))
    new_rows, of = sb_ops.apply_slab_rows(tk, rows, slab)
    valid = idx >= 0
    # A local index past the rank's block drops, as the JAX scatter does.
    tgt = torch.where(valid & (idx < lanes // p), global_rows(idx, lanes, b, p), -1)
    out = state if donate else type(state)(*(x.clone() for x in state))
    sb_ops.write_rows_(out, tgt, new_rows)
    if not telemetry:
        return out, of & valid
    tel = _dispatch_tel(tk, slab, rows, new_rows, p)
    if sync:
        if state[0].device.type == "cuda":
            torch.cuda.synchronize(state[0].device)
        tel = tele.time_dispatch(tel, time.perf_counter() - t0)
    return out, of & valid, tel


def _dispatch_tel(tk, slab: sb_ops.OpSlab, rows, new_rows, p: int) -> tele.Telemetry:
    """The JAX dispatch's Telemetry: changed lanes, the slab's bytes (each
    rank receives its shard), its non-NOOP slots priced at one slot's
    bytes, the touched rows' depth and pressure."""
    b, s = slab.kind.shape
    slot_bytes = tele.shipped_bytes(slab) // max(b * s, 1)
    per_rank = torch.full((p,), float(tele.shipped_bytes(slab) // p), dtype=torch.float32,
                          device=slab.kind.device)
    n_ops = (slab.kind != sb_ops.NOOP).reshape(p, -1).sum(dim=-1, dtype=torch.float32)
    return tele.fill(
        tele.zeros(slab.kind.device), slots_changed=tk.changed(rows, new_rows),
        bytes_exchanged=per_rank.sum(), bytes_useful=(n_ops * slot_bytes).sum(),
        deferred_depth=tele.device_depth(new_rows), widen_pressure=tele.device_pressure(new_rows),
    )


__all__ = ["global_rows", "mesh_serve_apply"]
