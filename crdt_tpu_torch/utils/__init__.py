"""Host-side utilities: interning and metrics."""

from .interner import (
    Interner,
    UniverseFull,
    clock_lanes,
    pad_id_list,
    transactional,
    transactional_apply,
)

__all__ = [
    "Interner", "UniverseFull", "clock_lanes", "pad_id_list",
    "transactional", "transactional_apply",
]
