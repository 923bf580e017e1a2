"""Anti-entropy over a replica mesh — the port's ``parallel`` package.

One card holds the mesh as P virtual ranks (``mesh.VirtualMesh``): the
replica axis is a leading tensor axis, a collective a gather or a
reduction along it (``collectives``). Entries: ``mesh_fold`` and
``mesh_gossip`` (full-state, dense ORSWOT) and ``mesh_fold_map`` and
``mesh_gossip_map`` (full-state, Map<K, MVReg>; ``anti_entropy``);
``mesh_delta_gossip`` and ``mesh_delta_gossip_map`` (the δ rings,
``delta`` / ``delta_map`` + ``delta_ring``, with the bit-packed wire of
``wire`` and kernel K3).
"""

from .anti_entropy import mesh_fold, mesh_fold_map, mesh_gossip, mesh_gossip_map
from .delta import DeltaPacket, interval_accumulate, mesh_delta_gossip
from .delta_map import MapDeltaPacket, interval_accumulate_map, mesh_delta_gossip_map
from .mesh import VirtualMesh, pad_elements, pad_keys, pad_replicas, pad_replicas_map

__all__ = [
    "DeltaPacket", "MapDeltaPacket", "VirtualMesh", "interval_accumulate",
    "interval_accumulate_map", "mesh_delta_gossip", "mesh_delta_gossip_map", "mesh_fold",
    "mesh_fold_map", "mesh_gossip", "mesh_gossip_map", "pad_elements", "pad_keys",
    "pad_replicas", "pad_replicas_map",
]
