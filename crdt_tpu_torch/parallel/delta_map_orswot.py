"""δ-state anti-entropy for ``Map<K, Orswot<M>>`` — counterpart of the JAX
package's ``parallel/delta_map_orswot.py``.

A ``MapOrswotState`` IS a flat ORSWOT over the K × M product space plus one
outer keyset-remove buffer (``ops.map_orswot``), so the δ packet is
``delta.py``'s row machinery on the core — rows at (key, member)
granularity — with the outer parked buffer riding whole next to the leaf
buffer, replayed and dead-key-scrubbed at apply time as
``map_orswot.join`` does: one application of ``delta_nest.nested_delta``.

Tracking contract as in ``delta.py`` (op granularity): an inner add or
remove marks its (key, member) rows; an outer keyset-remove marks the
key's whole row block with its clock.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import map_orswot as mo_ops
from ..ops.map_orswot import MapOrswotState
from ..ops.orswot import changed_members
from .delta import DeltaPacket, apply_delta, extract_delta, gate_delta, interval_accumulate
from .delta_nest import close_top_nested, nested_delta, nested_gate, nested_template
from .mesh import VirtualMesh


class MapOrswotDeltaPacket(NamedTuple):
    """``delta.py``'s row packet on the K·M core + the outer keyset buffer."""

    core: DeltaPacket
    kdcl: torch.Tensor     # [.., D, A]
    kdkeys: torch.Tensor   # [.., D, K]
    kdvalid: torch.Tensor  # [.., D]


def interval_accumulate_mo(dirty: torch.Tensor, fctx: torch.Tensor, old: MapOrswotState,
                           new: MapOrswotState) -> Tuple[torch.Tensor, torch.Tensor]:
    """``delta.interval_accumulate`` on the flat core (rows are (key,
    member) cells: inner adds and removes and outer keyset-removes all
    change core rows only)."""
    return interval_accumulate(dirty, fctx, old.core, new.core)


extract_delta_mo, apply_delta_mo = nested_delta(
    mo_ops.LEVEL, extract_delta,
    lambda s, p, d, f, element_axis=None: apply_delta(s, p, d, f),
    packet_cls=MapOrswotDeltaPacket,
)
gate_delta_mo = nested_gate(gate_delta, MapOrswotDeltaPacket)


def close_top_mo(folded: MapOrswotState, top: torch.Tensor) -> MapOrswotState:
    """Adopt the mesh-wide top, re-replay both parked levels, scrub."""
    return close_top_nested(mo_ops.LEVEL, folded, top)


def packet_template_mo(folded, cap: int, fctx_dtype: torch.dtype) -> MapOrswotDeltaPacket:
    """One link's ``MapOrswotDeltaPacket`` shapes (meta tensors), the
    codec's plan input."""
    from .delta_ring import _packet_template

    return nested_template(_packet_template, MapOrswotDeltaPacket)(folded, cap, fctx_dtype)


def mesh_delta_gossip_map_orswot(
    state: MapOrswotState,
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
    """Ring δ anti-entropy for ``Map<K, Orswot>`` replica batches over the
    mesh's P ranks: each rank folds its block (the fused level fold, K1 on
    the leaf, on a card), then ``rounds`` unit-shift rounds ship one
    bounded ``MapOrswotDeltaPacket`` per link per round; ``fused=True``
    puts every packet through the bit-packed wire (K3 on a card: the
    dense slot instance, the leaf's and the outer level's parked buffers
    in the parked instance of the same launch). ``dirty [R, K·M]`` /
    ``fctx [R, K·M, A]`` are at (key, member) cell granularity. The modes,
    the ROUNDS BUDGET and ``stats`` are ``delta.mesh_delta_gossip``'s;
    ``wal=`` logs δ records of kind ``map_orswot``. Returns ``(states [P,
    ...], dirty, overflow [2], residue)`` — residue 0 certifies the full
    join."""
    from .delta_ring import run_delta_ring

    return run_delta_ring(
        "map_orswot_delta_gossip", state, dirty, fctx, mesh, rounds, cap,
        local_fold=mo_ops.fold,
        extract=extract_delta_mo, apply_fn=apply_delta_mo, close_top=close_top_mo,
        telemetry=telemetry, pipeline=pipeline, digest=digest, gate=gate_delta_mo,
        donate=donate, faults=faults, ack_window=ack_window, wal=wal, wal_kind="map_orswot",
        fused=fused, stats=stats, template=packet_template_mo,
        slots_fn=lambda a, b: changed_members(a.core, b.core), top_of=lambda s: s.core.top,
    )


__all__ = [
    "MapOrswotDeltaPacket", "apply_delta_mo", "close_top_mo", "extract_delta_mo",
    "gate_delta_mo", "interval_accumulate_mo", "mesh_delta_gossip_map_orswot",
    "packet_template_mo",
]
