"""Batched device-resident CRDT models."""

from .counters import BatchedGCounter, BatchedPNCounter
from .glist import BatchedGList
from .gset import BatchedGSet
from .list import BatchedList
from .map import BatchedMap
from .map3 import BatchedMap3
from .map_nested import BatchedMapOrswot, BatchedNestedMap
from .orswot import BatchedOrswot, DeferredOverflow
from .registers import BatchedLWWReg, BatchedMVReg, SlotOverflow
from .sparse_map import BatchedSparseMapOrswot
from .sparse_mvmap import BatchedSparseMap
from .sparse_nested_map import BatchedSparseNestedMap
from .sparse_orswot import BatchedSparseOrswot, DotCapacityOverflow
from .vclock import BatchedVClock

__all__ = ["BatchedGCounter", "BatchedGList", "BatchedGSet", "BatchedList", "BatchedLWWReg",
           "BatchedMap", "BatchedMap3", "BatchedMapOrswot", "BatchedMVReg", "BatchedNestedMap",
           "BatchedOrswot", "BatchedPNCounter", "BatchedSparseMap", "BatchedSparseMapOrswot",
           "BatchedSparseNestedMap", "BatchedSparseOrswot", "BatchedVClock", "DeferredOverflow",
           "DotCapacityOverflow", "SlotOverflow"]
