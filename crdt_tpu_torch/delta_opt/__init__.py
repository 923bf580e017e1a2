"""Optimal δ synchronization — the port holds the ack-window types the
wire codec reads (``ackwin.py``); decomposition and the ring's ack mode
are still to port (ROADMAP item 7)."""
