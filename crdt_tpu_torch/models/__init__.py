"""Batched device-resident CRDT models."""

from .map import BatchedMap
from .orswot import BatchedOrswot, DeferredOverflow
from .registers import SlotOverflow
from .sparse_map import BatchedSparseMapOrswot
from .sparse_mvmap import BatchedSparseMap
from .sparse_orswot import BatchedSparseOrswot, DotCapacityOverflow

__all__ = ["BatchedMap", "BatchedOrswot", "BatchedSparseMap", "BatchedSparseMapOrswot",
           "BatchedSparseOrswot", "DeferredOverflow", "DotCapacityOverflow", "SlotOverflow"]
