"""Link faults — the port carries only the integrity checksum so far
(``integrity.py``); fault injection, membership and retry are still to
port (ROADMAP item 15.4)."""
