"""Batched device-resident CRDT models."""

from .map import BatchedMap
from .orswot import BatchedOrswot, DeferredOverflow
from .registers import SlotOverflow
from .sparse_orswot import BatchedSparseOrswot, DotCapacityOverflow

__all__ = ["BatchedMap", "BatchedOrswot", "BatchedSparseOrswot", "DeferredOverflow",
           "DotCapacityOverflow", "SlotOverflow"]
