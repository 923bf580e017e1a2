"""crdt_tpu_torch — the PyTorch/CUDA port of crdt_tpu, for NVIDIA Hopper.

The same CRDT lattices as the JAX package ``crdt_tpu`` (which stays the
reference), held to it bit for bit. Plain tensor code is torch; the
replica-fold kernel the JAX package wrote in Pallas for the TPU is a
hand-written CUDA kernel here (``csrc/fold.cu``, built with ``nvcc`` at
first use). Entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``.

Layers of the dense ORSWOT slice: ``pure`` (the sequential oracle) →
``ops.orswot`` (batched join / apply / tree fold) → ``ops.fold_kernels``
(the fused fold: kernel K1 + plain-torch epilogue) → ``models.orswot``
(``BatchedOrswot``). ``convert`` carries states across packages as numpy.
Later slices add the Map<K, MVReg> (``ops.map``, ``models.map``), the δ
rings (``parallel``), the segment-encoded ORSWOT (``ops.sparse_orswot``,
``models.sparse_orswot``), the replica stream (``parallel.stream``) and
the sparse Map kinds (``ops.sparse_mvmap``, ``ops.sparse_nest``,
``models.sparse_mvmap``, ``models.sparse_map``, ``parallel.sparse_shard``)
and nested composition (``ops.nest`` with ``ops.map_orswot``,
``ops.map3``, ``ops.map_map``; ``models.map_nested``, ``models.map3``,
``models.sparse_nested_map``; ``parallel.delta_nest``) and the remaining
kinds: clocks and counters (``ops.vclock``, ``models.vclock``,
``models.counters``), ``ops.gset``/``models.gset``, the registers
(``ops.lwwreg``, ``models.registers``) and the sequences
(``models.list``, ``models.glist`` over the host engine of ``native``),
causal-stability reclamation (``reclaim``, each kind's ``compact``) and
the actor lifecycle (``lifecycle``), the fault plane (``faults``), the
observability plane (``obs``: flight recorder, op tracing, dump audit;
``analysis.slo``, the freshness SLO gate) and live scale-out
(``scaleout``). The host metrics registry (``metrics``), the Telemetry
sidecar and its spans (``telemetry``), the Prometheus/JSONL drain
(``exporter``) and the wire encoding (``serde``) ride at the root, as in
the JAX package.
"""

from .traits import CvRDT, CmRDT, ResetRemove, Causal, ValidationError, DotRange
from .dot import Dot, OrdDot
from .vclock import VClock
from .ctx import ReadCtx, AddCtx, RmCtx
from .pure import (
    Dir, GCounter, GList, GSet, Identifier, List, LWWReg, Map, MerkleReg, MVReg, Orswot,
    PNCounter,
)

# Wire and storage encoding, the actor lifecycle, the host registry, the
# Telemetry sidecar with its span tracing, and the Prometheus/JSONL drain.
from . import exporter, lifecycle, serde, telemetry
from .telemetry import Telemetry, span
from .utils.metrics import metrics

__all__ = [
    "CvRDT", "CmRDT", "ResetRemove", "Causal", "ValidationError", "DotRange",
    "Dot", "OrdDot", "VClock", "ReadCtx", "AddCtx", "RmCtx",
    "GCounter", "PNCounter", "Dir", "GSet", "LWWReg", "MVReg", "Orswot", "Map", "Identifier",
    "List", "GList", "MerkleReg",
    "serde", "lifecycle", "metrics", "Telemetry", "exporter", "span", "telemetry",
]
