"""``mesh_fanout_push`` — the cohort δ fan-out dispatch, the port of the
JAX package's ``parallel/fanout_push.py``.

One call computes a whole dispatch of per-cohort join-irreducible δ
payloads against the serve superblock, its lane axis split over the P
virtual ranks of a :class:`~crdt_tpu_torch.parallel.mesh.VirtualMesh`
(cohorts are independent — no cross-cohort collective exists): the P
ranks' gathers of their touched tenant rows and the decomposition against
the cohort base rows (``ops/fanout_kernels.cohort_deltas``) run as one
batch over all B lanes, and the WHOLE dispatch packs in ONE launch of K3
(``cohort_wire_encode`` over K3's ``[P, (B/P)·E, A]`` stack, one batch per
rank). ``nnz``/``chk`` are then summed over the P ranks mod 2³², as the
JAX ``lax.psum`` sums the per-device partials — the checksum's row
weights restart on every rank, so flattening the B·E rows into one batch
would give another ``chk``.

Index convention (the JAX one, ``serve_apply.global_rows``): ``idx[B]
int32`` carries LOCAL row indices — lane block ``[r·B/P, (r+1)·B/P)``
belongs to rank r and its values index that rank's tenant rows ``[0,
T/P)``; ``-1`` lanes are empty. An empty lane gathers its rank's local row
0 (the JAX clip): its lane mask and wire lanes are zero and its byte
price drops, while its residual is that row's, as in the JAX package.
``bases[B, ...]`` stacks each cohort's acked base row (the plane's
promote-on-ack copy).

The dispatch only READS the superblock; nothing is donated.
``telemetry=True`` adds the JAX dispatch's Telemetry: the cohorts it
decomposed (``cohorts_per_dispatch``), each cohort's push bytes times its
weight, the subscribers it fans out to (``delta_push_bytes``), and the
per-cohort push-bytes histogram (``hist_push_bytes``), each summed per
rank and then over the ranks.
"""

from __future__ import annotations

import time

import torch

from .. import telemetry as tele
from .._dtypes import from_wide, to_wide
from ..delta_opt.decompose import Decomposition, get_decomposer
from ..obs import hist as obs_hist
from ..ops import superblock as sb_ops
from ..ops.fanout_kernels import CohortWire, cohort_deltas, cohort_push_bytes, cohort_wire_encode
from ..ops.lattice import mask_slots, tree_leaves, tree_map
from .mesh import VirtualMesh
from .serve_apply import global_rows


def _validate(state, bases, idx, p: int) -> None:
    t = tree_leaves(state)[0].shape[0]
    b = tree_leaves(bases)[0].shape[0]
    if t % p:
        raise ValueError(f"{t} tenant rows do not divide the {p}-way replica axis")
    if b % p or idx.shape[0] != b:
        raise ValueError(
            f"base lanes ({b}) and idx ({idx.shape[0]}) must match and divide the "
            f"{p}-way replica axis"
        )


def fanout_deltas(kind: str, state, bases, idx: torch.Tensor, p: int):
    """The dispatch before the pack: gather each lane's row (rank-local
    index, clipped) → decompose against the cohort bases → empty lanes
    (``idx < 0``) out of the lane mask and the lanes. Returns ``(d,
    base_ctr [B, E, A], lane_ok [B])``."""
    b = idx.shape[0]
    rows = sb_ops.gather_rows(state, global_rows(idx, tree_leaves(state)[0].shape[0], b, p))
    lane_ok = idx >= 0
    d = cohort_deltas(kind, rows, bases)
    valid = d.valid & lane_ok[:, None]
    d = Decomposition(lanes=tree_map(lambda x: mask_slots(valid, x), d.lanes), valid=valid,
                      residual=d.residual)
    base_rows, _ = get_decomposer(kind).split(bases)
    return d, tree_leaves(base_rows)[0], lane_ok


def by_rank(d: Decomposition, base_ctr: torch.Tensor, p: int):
    """A dispatch's decomposition and base plane with the lane axis split
    as ``[P, B/P, ...]``: one batch of K3's stack per rank."""
    b = base_ctr.shape[0]
    split = lambda x: x.reshape(p, b // p, *x.shape[1:])  # noqa: E731
    return (Decomposition(lanes=tree_map(split, d.lanes), valid=split(d.valid),
                          residual=tree_map(split, d.residual)), split(base_ctr))


def _sum32(x: torch.Tensor) -> torch.Tensor:
    return from_wide(to_wide(x).sum() & 0xFFFFFFFF, torch.uint32)


def mesh_fanout_push(
    state,
    bases,
    idx,
    mesh: VirtualMesh,
    *,
    kind: str = "orswot",
    weights=None,
    telemetry: bool = False,
):
    """Compute one dispatch of cohort δ pushes against a tenant superblock
    split over the mesh's virtual ranks. Returns ``(wire, push_bytes[B])``
    (module docstring). ``bases`` lie on the superblock's device; CUDA
    tensors launch K3 once or raise. ``weights[B]`` (cohort sizes, 1 by
    default) price subscriber deliveries in the telemetry sidecar:
    ``telemetry=True`` returns ``(wire, push_bytes, Telemetry)``, after
    waiting for the card (``hist_dispatch_us``)."""
    t0 = time.perf_counter()
    sb_ops.tenant_kind(kind)  # fail fast on a kind with no superblock adapter
    p = mesh.p
    idx = idx if isinstance(idx, torch.Tensor) else torch.as_tensor(idx)
    _validate(state, bases, idx, p)
    idx = idx.to(device=tree_leaves(state)[0].device, dtype=torch.int32)
    d, base_ctr, lane_ok = fanout_deltas(kind, state, bases, idx, p)
    b = idx.shape[0]
    wire = cohort_wire_encode(*by_rank(d, base_ctr, p))
    flat = lambda x: x.reshape(b, *x.shape[2:])  # noqa: E731
    wire = CohortWire(
        words=flat(wire.words), keep=flat(wire.keep), defer=flat(wire.defer),
        valid=flat(wire.valid), raw=flat(wire.raw), residual=tree_map(flat, wire.residual),
        nnz=_sum32(wire.nnz), chk=_sum32(wire.chk),
    )
    pb = torch.where(lane_ok, cohort_push_bytes(wire), 0.0)
    if not telemetry:
        return wire, pb
    wts = (torch.ones(b, dtype=torch.float32, device=pb.device) if weights is None
           else torch.as_tensor(weights, dtype=torch.float32).to(pb.device))
    # Per rank, then over the ranks: the JAX body's sums and psum.
    h = obs_hist.observe_vec(obs_hist.zeros(pb.device), pb, lane_ok)
    h = h._replace(total=torch.where(lane_ok, pb, 0.0).reshape(p, -1).sum(dim=-1).sum())
    tel = tele.fill(tele.zeros(pb.device), cohorts_per_dispatch=lane_ok.sum(),
                    delta_push_bytes=(pb * wts).reshape(p, -1).sum(dim=-1).sum())
    tel = tel._replace(hist_push_bytes=h)
    if pb.device.type == "cuda":
        torch.cuda.synchronize(pb.device)
    return wire, pb, tele.time_dispatch(tel, time.perf_counter() - t0)


__all__ = ["by_rank", "fanout_deltas", "mesh_fanout_push"]
