"""Link faults — the port carries only the integrity checksum so far
(``integrity.py``: ``checksum`` and ``verify``); fault injection,
membership and retry are still to port (ROADMAP item 15.4)."""

from .integrity import checksum, verify

__all__ = ["checksum", "verify"]
