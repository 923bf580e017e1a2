"""Full-state anti-entropy over the virtual rank axis — the dense ORSWOT
entries ``mesh_fold`` and ``mesh_gossip`` of the JAX package's
``parallel/anti_entropy.py``.

Each rank folds its own replica block first (``fold_auto``: kernel K1
plus the epilogue on a card, the plain tree fold on the CPU); then one
lattice all-reduce (``mesh_fold``) or ``rounds`` ring rounds
(``mesh_gossip``) join the ranks. K1 has no rank axis, so the local fold
is one launch per rank, each streaming that rank's contiguous replica
block. The JAX entries' ``telemetry=``, ``donate=``, ``stability=``,
``faults=`` and ``lag_threshold=`` modes are still to port (ROADMAP
item 15) and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._dtypes import bits
from ..ops import orswot as ops
from ..ops.fold_kernels import fold_auto
from ..ops.lattice import tree_map
from ..ops.orswot import OrswotState
from .collectives import all_reduce_join, ring_round
from .mesh import VirtualMesh, pad_replicas


def _refuse(**modes) -> None:
    """Raise for a mode of the JAX entry that the port does not run yet."""
    on = [name for name, value in modes.items() if value]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: not ported yet (ROADMAP item 15); call without it"
        )


def rank_blocks(state: OrswotState, mesh: VirtualMesh) -> OrswotState:
    """``state [R, ...]`` on the mesh's device, padded with identities to
    a multiple of P and viewed as ``[P, R/P, ...]`` rank blocks."""
    state = pad_replicas(tree_map(lambda x: x.to(mesh.device), state), mesh.p)
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
    the per-rank overflow flags ``[P]``."""
    p = blocks.top.shape[0]
    outs = [fold_fn(tree_map(lambda x: x[q], blocks)) for q in range(p)]
    folded = stack([s for s, _ in outs], outs[0][0])
    return folded, torch.stack([torch.as_tensor(of).reshape(()) for _, of in outs])


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


__all__ = ["local_folds", "mesh_fold", "mesh_gossip", "rank_blocks"]
