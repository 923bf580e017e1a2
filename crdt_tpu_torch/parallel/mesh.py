"""The replica mesh of one card, and the pads that fit a batch to it.

The JAX package runs anti-entropy as a mesh program: ``shard_map`` over a
``(replica, element)`` device mesh, with ``ppermute``/``psum``/``pmax``
over the replica axis. One card cannot hold two NCCL ranks, so here the
replica axis is a leading tensor axis of length P — **P virtual ranks on
one device**: rank q owns replica rows ``[q·R/P, (q+1)·R/P)``, exactly
the block a ``P(REPLICA_AXIS)`` sharding gives device q, and a collective
is a gather or a reduction along that axis (``collectives.py``). The
element axis has ``s`` shards (1 unless a sharded entry asks for more):
the element-sharded sparse entries (``sparse_shard.py``) hold them as a
tensor axis ``[R, S, ...]`` of the state, and every other entry keeps
the element axis replicated, as the JAX package does on a ``(P, S)``
mesh.
"""

from __future__ import annotations

import torch

from .._dtypes import bits
from ..ops import map as map_ops
from ..ops.lattice import tree_leaves, tree_map
from ..ops.map import MapState
from ..ops.orswot import OrswotState, empty


class VirtualMesh:
    """P virtual replica ranks on one device, ``s`` element shards — where
    the JAX package's ``make_mesh(P, S)`` stands."""

    def __init__(self, p: int, device="cuda", s: int = 1):
        if p < 1 or s < 1:
            raise ValueError(f"a mesh needs at least one rank and one shard, got ({p}, {s})")
        self.p = int(p)
        self.s = int(s)
        self.device = torch.device(device)


def pad_replicas(state: OrswotState, multiple: int) -> OrswotState:
    """Pad the replica axis up to a multiple with join identities (the
    empty state), so it divides the mesh's replica axis; the join absorbs
    identity rows."""
    r = state.top.shape[0]
    pad = (-r) % multiple
    if pad == 0:
        return state
    ident = empty(
        state.ctr.shape[-2], state.ctr.shape[-1], state.dcl.shape[-2], batch=(pad,),
        device=state.top.device,
    )
    return OrswotState(*(torch.cat([bits(x), bits(p)]).view(x.dtype) for x, p in zip(state, ident)))


def pad_elements(state: OrswotState, multiple: int) -> OrswotState:
    """Pad the element axis with never-present slots so it divides the
    mesh's element axis (1 on a virtual mesh: a no-op there)."""
    pad = (-state.ctr.shape[-2]) % multiple
    if pad == 0:
        return state
    f = torch.nn.functional.pad
    return state._replace(
        ctr=f(bits(state.ctr), (0, 0, 0, pad)).view(state.ctr.dtype),
        dmask=f(state.dmask, (0, pad)),
    )


def pad_replicas_map(state: MapState, multiple: int) -> MapState:
    """Pad a Map batch's replica axis with join identities (see
    :func:`pad_replicas`)."""
    pad = (-state.top.shape[0]) % multiple
    if pad == 0:
        return state
    ident = map_ops.empty(
        state.dkeys.shape[-1], state.top.shape[-1], state.child.wact.shape[-1],
        state.dcl.shape[-2], batch=(pad,), device=state.top.device,
    )
    return tree_map(lambda x, p: torch.cat([bits(x), bits(p).to(bits(x).dtype)]).view(x.dtype),
                    state, ident)


def pad_replicas_sparse(state, multiple: int):
    """Pad the replica axis of a sparse state — the segment-encoded
    ORSWOT, the sparse ``Map<K, MVReg>`` or any sparse nest, sharded
    ``[R, S, ...]`` or not — up to a multiple with join identities built
    like one row of ``state`` (the JAX package's identity pads of
    ``_sparse_pad_and_template`` and ``_pad_replica_axis``)."""
    from ..ops.sparse_nest import identity_batch

    pad = (-tree_leaves(state)[0].shape[0]) % multiple
    if pad == 0:
        return state
    return tree_map(lambda x, p: torch.cat([bits(x), bits(p)]).view(x.dtype), state,
                    identity_batch(state, pad))


def pad_keys(state: MapState, multiple: int) -> MapState:
    """Pad a Map batch's key axis with never-written slots so it divides
    the mesh's element axis (1 on a virtual mesh: a no-op there); padded
    keys hold no dots, so the join never surfaces them."""
    pad = (-state.dkeys.shape[-1]) % multiple
    if pad == 0:
        return state
    f = torch.nn.functional.pad
    r = state.top.dim() - 1  # leading batch axes

    def kpad(x):  # the key axis sits right after the batch axes
        widths = [0, 0] * (x.dim() - r - 1) + [0, pad]
        return f(bits(x), widths).view(x.dtype)

    return state._replace(child=tree_map(kpad, state.child),
                          dkeys=f(state.dkeys, (0, pad)))


__all__ = ["VirtualMesh", "pad_elements", "pad_keys", "pad_replicas", "pad_replicas_map",
           "pad_replicas_sparse"]
