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
``models.sparse_nested_map``; ``parallel.delta_nest``).
"""

from .traits import CvRDT, CmRDT, ResetRemove, Causal, ValidationError, DotRange
from .dot import Dot
from .vclock import VClock
from .ctx import ReadCtx, AddCtx, RmCtx
from .pure.orswot import Orswot

__all__ = [
    "CvRDT", "CmRDT", "ResetRemove", "Causal", "ValidationError", "DotRange",
    "Dot", "VClock", "ReadCtx", "AddCtx", "RmCtx", "Orswot",
]
