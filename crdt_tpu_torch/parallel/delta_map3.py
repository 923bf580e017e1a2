"""δ-state anti-entropy for ``Map<K1, Map<K2, Orswot<M>>>`` — counterpart of
the JAX package's ``parallel/delta_map3.py``: the δ induction
(``delta_nest.nested_delta``) applied once more, the ``map_orswot`` δ
machinery on the flat ``mo`` slab (cells over K1 × K2 × M) plus the K1
level's parked keyset buffer riding whole, settled and scrubbed as
``map3.join`` does."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import map3 as m3_ops
from ..ops.map3 import Map3State
from ..ops.orswot import changed_members
from .delta import interval_accumulate
from .delta_map_orswot import (
    MapOrswotDeltaPacket, apply_delta_mo, extract_delta_mo, gate_delta_mo, packet_template_mo,
)
from .delta_nest import close_top_nested, nested_delta, nested_gate, nested_template
from .mesh import VirtualMesh


class Map3DeltaPacket(NamedTuple):
    """The ``map_orswot`` packet on the flat slab + the K1 buffer."""

    mo: MapOrswotDeltaPacket
    odcl: torch.Tensor     # [.., D, A]
    odkeys: torch.Tensor   # [.., D, K1]
    odvalid: torch.Tensor  # [.., D]


def interval_accumulate_m3(dirty: torch.Tensor, fctx: torch.Tensor, old: Map3State,
                           new: Map3State) -> Tuple[torch.Tensor, torch.Tensor]:
    """``delta.interval_accumulate`` on the flat leaf cells (K1·K2·M)."""
    return interval_accumulate(dirty, fctx, old.mo.core, new.mo.core)


extract_delta_m3, apply_delta_m3 = nested_delta(m3_ops.LEVEL, extract_delta_mo, apply_delta_mo,
                                                packet_cls=Map3DeltaPacket)
gate_delta_m3 = nested_gate(gate_delta_mo, Map3DeltaPacket)


def close_top_m3(folded: Map3State, top: torch.Tensor) -> Map3State:
    """Adopt the mesh-wide top, re-replay all three parked levels, scrub."""
    return close_top_nested(m3_ops.LEVEL, folded, top)


def packet_template_m3(folded, cap: int, fctx_dtype: torch.dtype) -> Map3DeltaPacket:
    """One link's ``Map3DeltaPacket`` shapes (meta tensors)."""
    return nested_template(packet_template_mo, Map3DeltaPacket)(folded, cap, fctx_dtype)


def mesh_delta_gossip_map3(
    state: Map3State,
    dirty: torch.Tensor,
    fctx: torch.Tensor,
    mesh: VirtualMesh,
    rounds: Optional[int] = None,
    cap: int = 64,
    telemetry: bool = False,
    pipeline: bool = True,
    digest: bool = True,
    donate: bool = False,
    faults=None,
    ack_window=False,
    wal=None,
    fused: bool = True,
    stats: Optional[dict] = None,
):
    """Ring δ anti-entropy for depth-3 map replica batches (see
    ``delta_map_orswot.mesh_delta_gossip_map_orswot``): ``dirty`` /
    ``fctx`` at leaf (k1, k2, member) cell granularity; K3's parked
    instance carries all three parked levels; ``wal=`` logs δ records of
    kind ``map3``. Returns ``(states [P, ...], dirty, overflow [3],
    residue)``."""
    from .delta_ring import run_delta_ring

    return run_delta_ring(
        "map3_delta_gossip", state, dirty, fctx, mesh, rounds, cap,
        local_fold=m3_ops.fold,
        extract=extract_delta_m3, apply_fn=apply_delta_m3, close_top=close_top_m3,
        telemetry=telemetry, pipeline=pipeline, digest=digest, gate=gate_delta_m3,
        donate=donate, faults=faults, ack_window=ack_window, wal=wal, wal_kind="map3",
        fused=fused, stats=stats, template=packet_template_m3,
        slots_fn=lambda a, b: changed_members(a.mo.core, b.mo.core),
        top_of=lambda s: s.mo.core.top,
    )


__all__ = [
    "Map3DeltaPacket", "apply_delta_m3", "close_top_m3", "extract_delta_m3", "gate_delta_m3",
    "interval_accumulate_m3", "mesh_delta_gossip_map3", "packet_template_m3",
]
