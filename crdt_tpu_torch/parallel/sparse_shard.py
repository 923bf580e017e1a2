"""Element sharding for the sparse (segment-encoded) kinds — counterpart
of the JAX package's ``parallel/sparse_shard.py``.

Each replica's leaf table is partitioned by ``id % S``. The restriction
of a sparse ORSWOT to an element subuniverse is itself a sparse ORSWOT
and every join rule is per element, so

    restrict(join(a, b), s)  ==  join(restrict(a, s), restrict(b, s))

and shard-local joins are exact. Per shard: the shard's lanes, the
shard's parked entries, and a replicated top clock. The sparse
``Map<K, MVReg>`` partitions by ``kid % S`` (a key lives wholly in one
shard). For the NESTED kind the parked KEY lists stay replicated (a
key's members span all shards), and the only cross-shard coupling is the
scrub's key-liveness test (``ops.sparse_nest._ids_alive`` with
``element_axis``).

Layout: states are ``[R, S, ...]`` on every leaf — axis 0 the replicas,
axis 1 the S element shards, the JAX package's ``P(REPLICA_AXIS,
ELEMENT_AXIS)`` layout with the element axis a tensor axis — and S must
equal the mesh's ``s`` (``VirtualMesh(p, s=S)``, the JAX
``make_mesh(P, S)``). A sharded fold (:func:`_sharded_fold`) pads the
replica axis with join identities, folds each rank's block per shard,
all-reduces the lattice over the P ranks per shard
(``collectives.all_reduce_lattice``) and ORs the overflow flags over both
axes; the result keeps the shard axis, ``[S, ...]``. The split functions
read the occupancy back to the host, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._dtypes import to_wide
from ..ops import sparse_mvmap as smv
from ..ops import sparse_nest as nest
from ..ops import sparse_orswot as sp
from ..ops.lattice import tree_leaves, tree_map
from ..ops.sparse_mvmap import SparseMVMapState
from ..ops.sparse_nest import SparseNestState
from ..ops.sparse_orswot import SparseOrswotState, _canon, _canon_rmlist
from ..utils.metrics import metrics, state_nbytes
from .anti_entropy import local_folds
from .collectives import all_reduce_lattice
from .mesh import VirtualMesh, pad_replicas_sparse

# The shard axis of a ``[R, S, ...]`` block is its last batch axis.
_ELEMENT_AXIS = -1


def _stack_shards(shards):
    return tree_map(lambda *xs: torch.stack(xs, dim=1), *shards)


def _check_fits(overflow: torch.Tensor, shard: int, cap: int, what: str) -> None:
    if bool(torch.any(overflow)):
        raise ValueError(f"shard {shard}: live {what} exceed the per-shard cap {cap}")


def split_segments(state: SparseOrswotState, n_shards: int,
                   dot_cap: Optional[int] = None) -> SparseOrswotState:
    """Partition a batched segment table by ``eid % n_shards`` into
    per-shard restrictions: ``[R, ...] -> [R, S, ...]``. ``dot_cap`` sizes
    the per-shard lane count (default the full cap, conservative against
    skew). Raises ValueError when a shard's live dots exceed it."""
    cap = dot_cap or state.eid.shape[-1]
    n_act = state.top.shape[-1]
    ctr = to_wide(state.ctr)

    def restrict(shard: int) -> SparseOrswotState:
        keep = state.valid & (state.eid % n_shards == shard)
        eid, act, ctr_s, valid, overflow = _canon(
            torch.where(keep, state.eid, -1), torch.where(keep, state.act, 0),
            torch.where(keep, ctr, 0), keep, cap, n_act)
        _check_fits(overflow, shard, cap, "dots")
        didx = _canon_rmlist(torch.where((state.didx >= 0) & (state.didx % n_shards == shard),
                                         state.didx, -1))
        dvalid = state.dvalid & torch.any(didx >= 0, dim=-1)
        return SparseOrswotState(
            top=state.top,  # replicated per shard
            eid=eid, act=act, ctr=ctr_s, valid=valid,
            dcl=nest._where(dvalid, state.dcl, 0),
            didx=torch.where(dvalid[..., None], didx, -1),
            dvalid=dvalid,
        )

    return _stack_shards([restrict(s) for s in range(n_shards)])


def split_cells(states: SparseMVMapState, n_shards: int,
                cell_cap: Optional[int] = None) -> SparseMVMapState:
    """Partition a batched sparse ``Map<K, MVReg>`` cell table by ``kid %
    n_shards``: ``[R, ...] -> [R, S, ...]``. Keys are wholly within one
    shard, so restriction commutes with the cell-wise join; the top clock
    replicates per shard, parked key lists partition with their keys.
    Raises ValueError when a shard's live cells exceed the cap."""
    cap = cell_cap or states.kid.shape[-1]
    n_act = states.top.shape[-1]
    ctr = to_wide(states.ctr)

    def restrict(shard: int) -> SparseMVMapState:
        keep = states.valid & (states.kid % n_shards == shard)
        kid, act, ctr_s, val, clk, valid, overflow = smv._canon(
            torch.where(keep, states.kid, -1), torch.where(keep, states.act, 0),
            torch.where(keep, ctr, 0), torch.where(keep, states.val, 0),
            nest._where(keep, states.clk, 0), keep, cap, n_act)
        _check_fits(overflow, shard, cap, "cells")
        kidx = _canon_rmlist(torch.where((states.kidx >= 0) & (states.kidx % n_shards == shard),
                                         states.kidx, -1))
        dvalid = states.dvalid & torch.any(kidx >= 0, dim=-1)
        return SparseMVMapState(
            top=states.top,  # replicated per shard
            kid=kid, act=act, ctr=ctr_s, val=val, clk=clk, valid=valid,
            dcl=nest._where(dvalid, states.dcl, 0),
            kidx=torch.where(dvalid[..., None], kidx, -1),
            dvalid=dvalid,
        )

    return _stack_shards([restrict(s) for s in range(n_shards)])


def split_nested(state: SparseNestState, n_shards: int,
                 dot_cap: Optional[int] = None) -> SparseNestState:
    """Partition a batched nested sparse state: the leaf table splits by
    ``id % n_shards`` (:func:`split_segments` for the ORSWOT leaf,
    :func:`split_cells` for the register-map leaf), every level's parked
    KEY lists replicate to each shard (``[R, ...] -> [R, S, ...]``)."""
    if isinstance(state.core, SparseNestState):
        core = split_nested(state.core, n_shards, dot_cap)
    elif isinstance(state.core, SparseMVMapState):
        core = split_cells(state.core, n_shards, dot_cap)
    else:
        core = split_segments(state.core, n_shards, dot_cap)
    rep = lambda x: x[:, None].expand(x.shape[0], n_shards, *x.shape[1:]).contiguous()  # noqa: E731
    return SparseNestState(core=core, kcl=rep(state.kcl), kidx=rep(state.kidx),
                           kdvalid=rep(state.kdvalid))


def _sharded_fold(kind: str, states, mesh: VirtualMesh, join_fn, fold_fn):
    """The scaffold of every element-sharded fold: the shard-count check,
    the replica axis padded with identities, each rank's block folded per
    shard (one batched tree, ranks and shards as batch axes), the lattice
    all-reduce over the ranks per shard, and the flags ORed over ranks
    and shards. ``join_fn``/``fold_fn`` may name the shard axis (-1) for
    the nest's cross-shard scrub. Returns ``(state [S, ...], flags)``."""
    leaf = tree_leaves(states)[0]
    if leaf.dim() < 2 or leaf.shape[1] != mesh.s:
        got = leaf.shape[1] if leaf.dim() > 1 else None
        raise ValueError(f"state has {got} element shards, mesh axis is {mesh.s}")
    metrics.count(f"anti_entropy.{kind}_rounds")
    metrics.observe("anti_entropy.state_bytes", state_nbytes(states))
    with metrics.time(f"anti_entropy.{kind}"):
        states = pad_replicas_sparse(tree_map(lambda x: x.to(mesh.device), states), mesh.p)
        blocks = tree_map(lambda x: x.reshape(mesh.p, -1, *x.shape[1:]), states)
        folded, of_local = local_folds(blocks, fold_fn)        # [P, S, ...], [P, S, L]
        joined, of_cross = all_reduce_lattice(folded, join_fn, fold_fn)  # [S, L]
        of = torch.any(of_local.flatten(0, 1), dim=0) | torch.any(of_cross, dim=0)
    return tree_map(lambda x: x[0], joined), of


def mesh_fold_sparse_sharded(states: SparseOrswotState,
                             mesh: VirtualMesh) -> Tuple[SparseOrswotState, torch.Tensor]:
    """Converge an element-SHARDED sparse ORSWOT batch ``[R, S, ...]``
    (from :func:`split_segments`; S == ``mesh.s``) over the mesh.
    Shard-local joins are exact, so the only collective is the replica
    axis's lattice all-reduce. Returns ``(state [S, ...], flags [2])``."""
    return _sharded_fold("sparse_sharded_fold", states, mesh, sp.join, sp.fold)


def mesh_fold_sparse_mvmap_sharded(states: SparseMVMapState, mesh: VirtualMesh,
                                   sibling_cap: int = 4):
    """Converge a key-SHARDED sparse ``Map<K, MVReg>`` batch ``[R, S, ...]``
    (from :func:`split_cells`) over the mesh. Returns ``(state [S, ...],
    flags [3])``."""
    return _sharded_fold(f"sparse_mvmap_sharded_fold_s{sibling_cap}", states, mesh,
                         lambda a, b: smv.join(a, b, sibling_cap=sibling_cap),
                         lambda x: smv.fold(x, sibling_cap=sibling_cap))


def mesh_fold_sparse_nested_sharded(states: SparseNestState, mesh: VirtualMesh, level):
    """Converge a leaf-SHARDED sparse NESTED batch ``[R, S, ...]`` (from
    :func:`split_nested`; any ``SparseNestLevel`` composition) over the
    mesh. Shard-local joins are exact except the scrub's key liveness,
    which sums over the shard axis. Returns ``(state [S, ...], flags
    [L+1])``."""
    from .anti_entropy import _nested_kind

    return _sharded_fold(_nested_kind(level, "sharded"), states, mesh,
                         lambda a, b: level.join(a, b, element_axis=_ELEMENT_AXIS),
                         lambda x: level.fold(x, element_axis=_ELEMENT_AXIS))


def mesh_fold_sparse_map(states: SparseNestState, mesh: VirtualMesh,
                         span: int) -> Tuple[SparseNestState, torch.Tensor]:
    """Converge an element-sharded SPARSE ``Map<K, Orswot>`` batch ``[R, S,
    ...]`` (from :func:`split_nested`) over the mesh; ``span`` is the
    level's leaf ids per key (``BatchedSparseMapOrswot.span``). The nested
    join and fold take the shard axis as their ``element_axis``. Returns
    ``(state [S, ...], flags [3])``."""
    level = nest.level_map_orswot(span)
    return _sharded_fold("sparse_map_fold", states, mesh,
                         lambda a, b: level.join(a, b, element_axis=_ELEMENT_AXIS),
                         lambda x: level.fold(x, element_axis=_ELEMENT_AXIS))


__all__ = [
    "mesh_fold_sparse_map", "mesh_fold_sparse_mvmap_sharded", "mesh_fold_sparse_nested_sharded",
    "mesh_fold_sparse_sharded", "split_cells", "split_nested", "split_segments",
]
