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
``mesh_fold_sparse_mvmap``, ``mesh_gossip_sparse_mvmap``,
``mesh_fold_sparse_nested`` and ``mesh_gossip_sparse_nested`` (full-state,
the sparse Map kinds); ``mesh_fold_map_orswot``, ``mesh_fold_map3``,
``mesh_fold_nested_map`` and their ``mesh_gossip_*`` rings (full-state,
the dense nests); ``mesh_fold_clocks``, ``mesh_fold_gset``,
``mesh_fold_lww`` and ``mesh_fold_mvreg`` (the clock, set and register
kinds) and ``mesh_delta_gossip_map_orswot`` /
``mesh_delta_gossip_map3`` (their δ rings, ``delta_map_orswot`` /
``delta_map3`` over ``delta_nest``); ``split_segments``, ``split_cells``,
``split_nested`` and the element-sharded folds ``mesh_fold_sparse_sharded``,
``mesh_fold_sparse_mvmap_sharded``, ``mesh_fold_sparse_map`` and
``mesh_fold_sparse_nested_sharded`` (``sparse_shard``, ``[R, S, ...]``
states on a ``VirtualMesh(p, s=S)``);
``gossip_elastic`` and ``delta_gossip_elastic`` (the overflow → widen →
re-enter loops of ``elastic``); ``mesh_stream_fold_sparse`` and
``mesh_stream_fold``, ``mesh_stream_fold_sparse_mvmap`` and
``mesh_stream_fold_sparse_sharded`` (a population streamed through the
mesh in replica blocks, ``stream``); ``mesh_serve_apply`` (one coalesced op slab applied to
a tenant superblock, ``serve_apply``); ``mesh_fanout_push`` (one dispatch
of cohort δ payloads against a superblock, K3 over B·E client lanes,
``fanout_push``).
"""

from .anti_entropy import (
    gossip_elastic, mesh_fold, mesh_fold_clocks, mesh_fold_gset, mesh_fold_lww, mesh_fold_map,
    mesh_fold_map3, mesh_fold_map_orswot, mesh_fold_mvreg, mesh_fold_nested_map, mesh_fold_sparse, mesh_fold_sparse_mvmap, mesh_fold_sparse_nested,
    mesh_gossip, mesh_gossip_map, mesh_gossip_map3, mesh_gossip_map_orswot,
    mesh_gossip_nested_map, mesh_gossip_sparse, mesh_gossip_sparse_mvmap,
    mesh_gossip_sparse_nested,
)
from .collectives import all_reduce_clock, all_reduce_join, all_reduce_lattice, ring_round
from .delta import (
    DeltaPacket, apply_delta, dirty_between, extract_delta, interval_accumulate,
    mesh_delta_gossip,
)
from .delta_map import (
    MapDeltaPacket, apply_delta_map, extract_delta_map, interval_accumulate_map,
    mesh_delta_gossip_map,
)
from .delta_map3 import (
    Map3DeltaPacket, apply_delta_m3, extract_delta_m3, interval_accumulate_m3,
    mesh_delta_gossip_map3,
)
from .delta_map_orswot import (
    MapOrswotDeltaPacket, apply_delta_mo, extract_delta_mo, interval_accumulate_mo,
    mesh_delta_gossip_map_orswot,
)
from .delta_ring import delta_gossip_elastic
from .fanout_push import mesh_fanout_push
from .mesh import (
    VirtualMesh, pad_elements, pad_keys, pad_replicas, pad_replicas_map, pad_replicas_sparse,
)
from .serve_apply import mesh_serve_apply
from .sparse_shard import (
    mesh_fold_sparse_map, mesh_fold_sparse_mvmap_sharded, mesh_fold_sparse_nested_sharded,
    mesh_fold_sparse_sharded, split_cells, split_nested, split_segments,
)
from .stream import (
    StreamFaultReport, StreamInterrupted, iter_blocks, mesh_stream_fold, mesh_stream_fold_sparse,
    mesh_stream_fold_sparse_mvmap, mesh_stream_fold_sparse_sharded,
)

__all__ = [
    "DeltaPacket", "Map3DeltaPacket", "MapDeltaPacket", "MapOrswotDeltaPacket",
    "interval_accumulate_m3", "interval_accumulate_mo", "mesh_delta_gossip_map3",
    "mesh_delta_gossip_map_orswot", "mesh_fold_clocks", "mesh_fold_gset", "mesh_fold_lww",
    "mesh_fold_map3", "mesh_fold_map_orswot", "mesh_fold_mvreg",
    "mesh_fold_nested_map", "mesh_gossip_map3", "mesh_gossip_map_orswot",
    "mesh_gossip_nested_map", "StreamFaultReport", "StreamInterrupted", "VirtualMesh",
    "delta_gossip_elastic",
    "gossip_elastic", "interval_accumulate", "interval_accumulate_map", "iter_blocks",
    "mesh_delta_gossip", "mesh_delta_gossip_map", "mesh_fanout_push", "mesh_fold", "mesh_fold_map",
    "mesh_fold_sparse", "mesh_fold_sparse_map", "mesh_fold_sparse_mvmap",
    "mesh_fold_sparse_mvmap_sharded", "mesh_fold_sparse_nested", "mesh_fold_sparse_nested_sharded",
    "mesh_fold_sparse_sharded", "mesh_gossip", "mesh_gossip_map", "mesh_gossip_sparse",
    "mesh_gossip_sparse_mvmap", "mesh_gossip_sparse_nested", "mesh_serve_apply",
    "mesh_stream_fold", "mesh_stream_fold_sparse", "mesh_stream_fold_sparse_mvmap",
    "mesh_stream_fold_sparse_sharded", "pad_elements", "pad_keys", "pad_replicas",
    "pad_replicas_map", "pad_replicas_sparse", "split_cells", "split_nested", "split_segments",
    "all_reduce_clock", "all_reduce_join", "all_reduce_lattice", "apply_delta", "apply_delta_m3",
    "apply_delta_map", "apply_delta_mo", "dirty_between", "extract_delta", "extract_delta_m3",
    "extract_delta_map", "extract_delta_mo", "ring_round",
]
