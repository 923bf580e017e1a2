"""The thin-client replica — the receive half of the fan-out plane, the
port of the JAX package's ``fanout/client.py``.

A :class:`ClientReplica` is what one of the million subscribers runs: its
CRDT row plus the two-version discipline that makes the wire decode
exact. ``base`` is the state at the client's ACKED watermark —
bit-identical to the snapshot the plane stored when it shipped that
version (the promote-on-ack invariant, ``fanout/plane.py``) — and
``state`` is the latest APPLIED payload, possibly ahead of ``base`` while
the ack is in flight. Every δ payload decodes against ``base`` (the
encoder's base for this cohort, by construction), so applying is
idempotent and a payload re-shipped after a lost ack lands on the same
decode base instead of a drifted one. :meth:`ack` promotes ``base`` to the
applied state — call it exactly when the ack is handed to the plane.

Plain torch on the receive path (``wire_unpack``'s convention: the kernel
earns its keep on the send side). The replica's rows live on its
``device``; payloads may arrive with numpy leaves (the plane's host
wire) or tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import cohort_wire_from_numpy, leaf_from_numpy, leaf_to_numpy
from ..delta_opt.decompose import Decomposition, get_decomposer, reconstruct
from ..ops.fanout_kernels import CohortWire, cohort_wire_decode
from ..ops.lattice import tree_leaves, tree_map


def _on(row, device):
    """A state tree with numpy or tensor leaves, as tensors on ``device``."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else leaf_from_numpy(np.asarray(x), device), row)


def _host(leaf) -> np.ndarray:
    return leaf_to_numpy(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _host_leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _host_leaves(x)]
    return [_host(tree)]


class ClientReplica:
    """One subscriber's replica: ``state`` (latest applied), ``base``
    (acked watermark state), ``ver`` (acked version) and ``pend`` (the
    last applied-but-unacked version). Start it from the tenant kind's
    empty row — version 0 is ⊥ everywhere in the plane."""

    def __init__(self, kind: str, empty_row, device="cuda"):
        self.kind = kind
        self.device = torch.device(device)
        self.base = _on(empty_row, self.device)
        self.state = self.base
        self.ver = 0
        self.pend = 0

    def apply_wire(self, wire: CohortWire, to_ver: int) -> None:
        """Apply one cohort payload (leading batch axis 1 — the
        ``wire_lane`` slice the plane hands out). Decodes against the
        acked ``base``, never the possibly-ahead ``state``, so a re-shipped
        payload after a lost ack is harmless."""
        wire = cohort_wire_from_numpy(wire, self.device)
        lanes, res = get_decomposer(self.kind).split(tree_map(lambda x: x[None], self.base))
        d = cohort_wire_decode(wire, tree_leaves(lanes)[0], res)
        d1 = Decomposition(lanes=tree_map(lambda x: x[0], d.lanes), valid=d.valid[0],
                           residual=tree_map(lambda x: x[0], d.residual))
        self.state = reconstruct(self.kind, self.base, d1)
        self.pend = int(to_ver)

    def adopt(self, state, to_ver: int) -> None:
        """The snapshot+suffix resync landing (bootstrap path): adopt the
        shipped state wholesale — it is bit-identical to the served row by
        the bootstrap contract."""
        self.state = _on(state, self.device)
        self.pend = int(to_ver)

    def ack(self) -> None:
        """Promote the acked watermark to the applied state — call exactly
        when the ack is handed to ``FanoutPlane.ack`` (the two promotions
        are the one protocol step, split across the wire)."""
        self.base = self.state
        self.ver = self.pend

    def equals(self, row) -> bool:
        """Bit-exact leaf-wise comparison against a served row (numpy or
        tensor leaves): a subscriber replaying its δ stream from the acked
        watermark IS the served tenant."""
        mine, theirs = _host_leaves(self.state), _host_leaves(row)
        return len(mine) == len(theirs) and all(
            a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(mine, theirs))


__all__ = ["ClientReplica"]
