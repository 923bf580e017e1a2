"""Full-state anti-entropy over the virtual rank axis — the entries
``mesh_fold`` and ``mesh_gossip`` (dense ORSWOT), ``mesh_fold_map`` and
``mesh_gossip_map`` (Map<K, MVReg>) and ``mesh_fold_sparse`` (the
segment-encoded ORSWOT) of the JAX package's ``parallel/anti_entropy.py``.

Each rank folds its own replica block first (``fold_auto``: kernel K1
plus the epilogue on a card; ``ops.map.fold``: kernel K2 plus its
epilogue; the plain tree folds on the CPU; the sparse join, which has no
kernel, in one batched tree for all ranks); then one lattice all-reduce
(``mesh_fold*``) or ``rounds`` ring rounds (``mesh_gossip*``) join the
ranks. K1 and K2 have no rank axis, so the local fold is one launch per
rank, each streaming that rank's contiguous replica block. The JAX
entries' ``telemetry=``, ``donate=``, ``stability=``, ``faults=`` and
``lag_threshold=`` modes are still to port (ROADMAP item 15) and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._dtypes import bits
from ..ops import map as map_ops
from ..ops import orswot as ops
from ..ops import sparse_orswot as sp
from ..ops.fold_kernels import fold_auto
from ..ops.lattice import tree_map
from ..ops.map import MapState
from ..ops.orswot import OrswotState
from ..ops.sparse_orswot import SparseOrswotState
from .collectives import all_reduce_join, all_reduce_lattice, ring_round
from .mesh import VirtualMesh, pad_replicas, pad_replicas_map, pad_replicas_sparse


def _refuse(item: str = "15", **modes) -> None:
    """Raise for a mode of the JAX entry that the port does not run yet,
    naming the ROADMAP item that ports it."""
    on = [name for name, value in modes.items() if value]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: not ported yet (ROADMAP item {item}); call without it"
        )


def rank_blocks(state, mesh: VirtualMesh):
    """``state [R, ...]`` (an ``OrswotState``, ``MapState`` or
    ``SparseOrswotState``) on the mesh's device, padded with identities of
    its kind to a multiple of P and viewed as ``[P, R/P, ...]`` rank
    blocks."""
    pad = (pad_replicas_map if isinstance(state, MapState)
           else pad_replicas_sparse if isinstance(state, SparseOrswotState)
           else pad_replicas)
    state = pad(tree_map(lambda x: x.to(mesh.device), state), mesh.p)
    return tree_map(lambda x: x.reshape(mesh.p, -1, *x.shape[1:]), state)


def stack(states, dtype_like) -> OrswotState:
    """Stack per-rank unbatched states into ``[P, ...]`` leaves."""
    return tree_map(
        lambda like, *xs: torch.stack([bits(x) for x in xs]).view(like.dtype),
        dtype_like, *states,
    )


def local_folds(blocks: OrswotState, fold_fn) -> Tuple[OrswotState, torch.Tensor]:
    """Every rank's fold of its own replica block (``fold_fn`` on one
    ``[R/P, ...]`` block → ``(state, overflow)``): ``[P, ...]`` states and
    the per-rank overflow flags ``[P]`` (``[P, 2]`` for two-lane flags).

    A sparse block folds in ONE tree over the row axis with the P ranks
    as a batch (``fold_fn`` is ``ops.sparse_orswot.fold``, whose join takes
    any leading batch): the same pairs as P separate folds, so the same
    bits, in 1/P of the launches."""
    if isinstance(blocks, SparseOrswotState):
        return fold_fn(tree_map(lambda x: x.transpose(0, 1).contiguous(), blocks))
    p = blocks.top.shape[0]
    outs = [fold_fn(tree_map(lambda x: x[q], blocks)) for q in range(p)]
    folded = stack([s for s, _ in outs], outs[0][0])
    flags = [torch.as_tensor(of) for _, of in outs]
    return folded, torch.stack([of.reshape(()) if of.numel() == 1 else of for of in flags])


def _fold_fn(prefer: str):
    """The local fold of one rank block: ``fold_auto`` with ``prefer``
    ("auto" | "fused" | "tree")."""
    return lambda block: fold_auto(block, prefer=prefer)


def mesh_fold(
    state: OrswotState, mesh: VirtualMesh, local_fold: str = "auto",
    telemetry: bool = False, donate: bool = False,
) -> Tuple[OrswotState, torch.Tensor]:
    """Full-mesh anti-entropy: every replica's state joined into one
    converged state — each rank folds its block, then one lattice-join
    all-reduce over the ranks, on ``mesh.device``. Returns ``(converged
    state, overflow)``."""
    _refuse(telemetry=telemetry, donate=donate)
    folded, of_local = local_folds(rank_blocks(state, mesh), _fold_fn(local_fold))
    joined, of_cross = all_reduce_join(folded)
    return tree_map(lambda x: x[0], joined), torch.any(of_local) | of_cross


def mesh_gossip(
    state: OrswotState,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    local_fold: str = "auto",
    telemetry: bool = False,
    donate: bool = False,
    stability: bool = False,
    faults=None,
    lag_threshold=None,
) -> Tuple[OrswotState, torch.Tensor]:
    """Ring anti-entropy: each rank folds its block, then ``rounds``
    (default P-1) unit-shift ring rounds, each shipping one state per
    link. Returns ``(states [P, ...], overflow)``; with P-1 rounds every
    row is the full join."""
    _refuse(telemetry=telemetry, donate=donate, stability=stability,
            faults=faults is not None, lag_threshold=lag_threshold is not None)
    if rounds is None:
        rounds = mesh.p - 1
    folded, of = local_folds(rank_blocks(state, mesh), _fold_fn(local_fold))
    for _ in range(rounds):
        folded, of_r = ring_round(folded, reduce_overflow=False, join_fn=ops.join)
        of = of | of_r
    return folded, torch.any(of)


def mesh_fold_map(
    state: MapState, mesh: VirtualMesh, telemetry: bool = False, donate: bool = False,
) -> Tuple[MapState, torch.Tensor]:
    """Full-mesh anti-entropy for Map<K, MVReg> (BASELINE config 4): each
    rank folds its block (``ops.map.fold``: K2 and its epilogue on a
    card), then one lattice-join all-reduce over the ranks, on
    ``mesh.device``. Returns ``(converged state, overflow [2])`` —
    [sibling slab, deferred buffer] as in ``ops.map.join``."""
    _refuse(telemetry=telemetry, donate=donate)
    folded, of_local = local_folds(rank_blocks(state, mesh), map_ops.fold)
    joined, of_cross = all_reduce_lattice(folded, map_ops.join, map_ops.fold)
    return tree_map(lambda x: x[0], joined), torch.any(of_local, dim=0) | of_cross


def mesh_gossip_map(
    state: MapState,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    telemetry: bool = False,
    donate: bool = False,
    stability: bool = False,
    faults=None,
    lag_threshold=None,
) -> Tuple[MapState, torch.Tensor]:
    """Ring anti-entropy for Map<K, MVReg>: each rank folds its block,
    then ``rounds`` (default P-1) unit-shift ring rounds, each shipping
    one state per link. Returns ``(states [P, ...], overflow [2])``; with
    P-1 rounds every row is the full join."""
    _refuse(telemetry=telemetry, donate=donate, stability=stability,
            faults=faults is not None, lag_threshold=lag_threshold is not None)
    if rounds is None:
        rounds = mesh.p - 1
    folded, of = local_folds(rank_blocks(state, mesh), map_ops.fold)
    for _ in range(rounds):
        folded, of_r = ring_round(folded, reduce_overflow=False, join_fn=map_ops.join)
        of = of | of_r
    return folded, torch.any(of, dim=0)


def mesh_fold_sparse(
    states: SparseOrswotState, mesh: VirtualMesh, telemetry: bool = False,
    donate: bool = False,
) -> Tuple[SparseOrswotState, torch.Tensor]:
    """Converge a SPARSE (segment-encoded) ORSWOT replica batch over the
    mesh's replica axis, the segment table replicated (the element axis
    is 1): each rank folds its block (one batched log tree, see
    :func:`local_folds`), then one lattice-join all-reduce over the ranks,
    on ``mesh.device``. Returns ``(converged state, overflow [2])`` —
    [dot capacity, deferred capacity]."""
    _refuse(telemetry=telemetry, donate=donate)
    folded, of_local = local_folds(rank_blocks(states, mesh), sp.fold)
    joined, of_cross = all_reduce_lattice(folded, sp.join, sp.fold)
    return tree_map(lambda x: x[0], joined), torch.any(of_local, dim=0) | of_cross


__all__ = ["local_folds", "mesh_fold", "mesh_fold_map", "mesh_fold_sparse", "mesh_gossip",
           "mesh_gossip_map", "rank_blocks"]
