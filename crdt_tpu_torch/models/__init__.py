"""Batched device-resident CRDT models."""

from .map import BatchedMap
from .orswot import BatchedOrswot, DeferredOverflow
from .registers import SlotOverflow

__all__ = ["BatchedMap", "BatchedOrswot", "DeferredOverflow", "SlotOverflow"]
