"""Batched device-resident CRDT models."""

from .map import BatchedMap
from .map3 import BatchedMap3
from .map_nested import BatchedMapOrswot, BatchedNestedMap
from .orswot import BatchedOrswot, DeferredOverflow
from .registers import SlotOverflow
from .sparse_map import BatchedSparseMapOrswot
from .sparse_mvmap import BatchedSparseMap
from .sparse_nested_map import BatchedSparseNestedMap
from .sparse_orswot import BatchedSparseOrswot, DotCapacityOverflow

__all__ = ["BatchedMap", "BatchedMap3", "BatchedMapOrswot", "BatchedNestedMap", "BatchedOrswot",
           "BatchedSparseMap", "BatchedSparseMapOrswot", "BatchedSparseNestedMap",
           "BatchedSparseOrswot", "DeferredOverflow", "DotCapacityOverflow", "SlotOverflow"]
