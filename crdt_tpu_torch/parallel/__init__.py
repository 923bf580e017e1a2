"""Anti-entropy over a replica mesh — the port's ``parallel`` package.

One card holds the mesh as P virtual ranks (``mesh.VirtualMesh``): the
replica axis is a leading tensor axis, a collective a gather or a
reduction along it (``collectives``). Entries: ``mesh_fold`` and
``mesh_gossip`` (full-state, dense ORSWOT) and ``mesh_fold_map`` and
``mesh_gossip_map`` (full-state, Map<K, MVReg>; ``anti_entropy``);
``mesh_delta_gossip`` and ``mesh_delta_gossip_map`` (the δ rings,
``delta`` / ``delta_map`` + ``delta_ring``, with the bit-packed wire of
``wire``, kernel K3 and the ack window); ``mesh_fold_sparse`` and
``mesh_gossip_sparse`` (full-state, the segment-encoded ORSWOT);
``gossip_elastic`` and ``delta_gossip_elastic`` (the overflow → widen →
re-enter loops of ``elastic``); ``mesh_stream_fold_sparse`` and
``mesh_stream_fold`` (a population streamed through the mesh in replica
blocks, ``stream``); ``mesh_serve_apply`` (one coalesced op slab applied to
a tenant superblock, ``serve_apply``); ``mesh_fanout_push`` (one dispatch
of cohort δ payloads against a superblock, K3 over B·E client lanes,
``fanout_push``).
"""

from .anti_entropy import (
    gossip_elastic, mesh_fold, mesh_fold_map, mesh_fold_sparse, mesh_gossip, mesh_gossip_map,
    mesh_gossip_sparse,
)
from .delta import DeltaPacket, interval_accumulate, mesh_delta_gossip
from .delta_map import MapDeltaPacket, interval_accumulate_map, mesh_delta_gossip_map
from .delta_ring import delta_gossip_elastic
from .fanout_push import mesh_fanout_push
from .mesh import (
    VirtualMesh, pad_elements, pad_keys, pad_replicas, pad_replicas_map, pad_replicas_sparse,
)
from .serve_apply import mesh_serve_apply
from .stream import StreamInterrupted, iter_blocks, mesh_stream_fold, mesh_stream_fold_sparse

__all__ = [
    "DeltaPacket", "MapDeltaPacket", "StreamInterrupted", "VirtualMesh", "delta_gossip_elastic",
    "gossip_elastic", "interval_accumulate", "interval_accumulate_map", "iter_blocks",
    "mesh_delta_gossip", "mesh_delta_gossip_map", "mesh_fanout_push", "mesh_fold", "mesh_fold_map",
    "mesh_fold_sparse", "mesh_gossip", "mesh_gossip_map", "mesh_gossip_sparse", "mesh_serve_apply",
    "mesh_stream_fold", "mesh_stream_fold_sparse", "pad_elements", "pad_keys", "pad_replicas",
    "pad_replicas_map", "pad_replicas_sparse",
]
