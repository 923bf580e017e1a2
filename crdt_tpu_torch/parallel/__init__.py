"""Anti-entropy over a replica mesh — the port's ``parallel`` package.

One card holds the mesh as P virtual ranks (``mesh.VirtualMesh``): the
replica axis is a leading tensor axis, a collective a gather or a
reduction along it (``collectives``). Entries: ``mesh_fold`` and
``mesh_gossip`` (full-state, ``anti_entropy``), ``mesh_delta_gossip``
(the δ ring, ``delta`` + ``delta_ring``, with the bit-packed wire of
``wire`` and kernel K3).
"""

from .anti_entropy import mesh_fold, mesh_gossip
from .delta import DeltaPacket, interval_accumulate, mesh_delta_gossip
from .mesh import VirtualMesh, pad_elements, pad_replicas

__all__ = [
    "DeltaPacket", "VirtualMesh", "interval_accumulate", "mesh_delta_gossip", "mesh_fold",
    "mesh_gossip", "pad_elements", "pad_replicas",
]
