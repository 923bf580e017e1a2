"""BatchedGList — N device GList replicas over a shared identifier
universe. Counterpart of the JAX package's ``models/glist.py``.

Oracle: ``crdt_tpu_torch.pure.glist.GList`` (reference: src/glist.rs). A
GList is a grow-only ordered SET of identifiers: the shared universe
(host engine, insert-only trace) fixes every identifier's slot in total
order and its element payload, and a replica is just an
``alive bool[R, N]`` membership mask. Merge is set union — one
elementwise OR — and full-mesh anti-entropy over R replicas is
``alive.any(0)``. Per-replica updates write the batch in place.

Identifier allocation note: the engine mints LSEQ-style (index, actor,
counter) tree paths while the pure ``between`` embeds the element as the
final marker, so the gates drive both sides with engine-minted
identifiers (``to_pure``-shaped ops).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..dot import OrdDot
from ..native import INSERT, ListEngine
from ..pure.glist import GList, Insert
from ..pure.identifier import Identifier
from .list import growth_permutation, upload


def _remap_alive(alive: torch.Tensor, src: np.ndarray) -> torch.Tensor:
    s = upload(src, alive.device)
    return alive.index_select(1, s.clamp(min=0)).masked_fill((s < 0)[None], False)


class BatchedGList:
    def __init__(self, n_replicas: int, device="cuda"):
        self.engine = ListEngine()
        self.slots = np.empty(0, np.int64)  # rank per handle
        self.uvals = np.empty(0, np.int32)  # element payload per handle
        self.alive = torch.zeros((n_replicas, 1), dtype=torch.bool, device=device)

    @property
    def n_replicas(self) -> int:
        return self.alive.shape[0]

    # ---- universe growth (identifier minting) -------------------------
    def mint_inserts(self, indices: Sequence[int], values: Sequence[int],
                     actors: Sequence[int]) -> np.ndarray:
        """Mint identifiers for inserts at positions in the UNIVERSE
        sequence (every identifier ever minted — grow-only, nothing
        dies), growing the shared slot space. Returns the ops' handles;
        deliver them to replicas with :meth:`apply_inserts`."""
        kinds = np.full(len(indices), INSERT, np.uint8)
        handles = self.engine.apply_trace(kinds, indices, values, actors)
        self.uvals = np.concatenate([self.uvals, np.ascontiguousarray(values, np.int32)])
        new_rank = self.engine.total_order()
        self.alive = _remap_alive(self.alive, growth_permutation(self.slots, new_rank))
        self.slots = new_rank
        return handles

    # ---- op path (CmRDT: Insert delivery) -----------------------------
    def apply_inserts(self, replica_handles: np.ndarray) -> None:
        """One epoch: ``replica_handles[r]`` lists identifier handles
        replica ``r`` receives (shape [R, C]; -1 pads). The valid lanes go
        up as flat ``r·N + slot`` indices: one fill for all replicas."""
        replica_handles = np.asarray(replica_handles)
        if replica_handles.ndim != 2 or replica_handles.shape[0] != self.n_replicas:
            raise ValueError(f"expected [R={self.n_replicas}, C] handles")
        rows, cols = np.nonzero(replica_handles >= 0)
        flat = rows * self.alive.shape[1] + self.slots[replica_handles[rows, cols]]
        self.alive.view(-1).index_fill_(0, upload(flat.astype(np.int64), self.alive.device),
                                        True)

    # ---- state path (CvRDT: union merge) ------------------------------
    def union_from(self, dst: int, src: int) -> None:
        """Set-union merge (reference: src/glist.rs ``CvRDT::merge``)."""
        self.alive[dst] |= self.alive[src]

    def fold(self) -> np.ndarray:
        """Full-mesh anti-entropy: the union of every replica's set."""
        return torch.any(self.alive, dim=0).cpu().numpy()

    def _mask(self, replica: Optional[int]) -> np.ndarray:
        return self.fold() if replica is None else self.alive[replica].cpu().numpy()

    # ---- reads ---------------------------------------------------------
    def read(self, replica: Optional[int] = None) -> list:
        """The replica's element sequence (None = the folded union)."""
        mask = self._mask(replica)
        if len(self.slots) == 0:
            return []
        vals_in_slot_order = np.empty(len(self.slots), np.int32)
        vals_in_slot_order[self.slots] = self.uvals
        return vals_in_slot_order[mask[: len(self.slots)]].tolist()

    def identifier(self, handle: int) -> Identifier:
        """The engine-minted identifier for a handle, in oracle form."""
        path = self.engine.identifier_path(int(handle))
        return Identifier(tuple((ix, OrdDot(a, c)) for ix, a, c in path))

    def to_pure(self, replica: Optional[int] = None) -> GList:
        """Oracle form of one replica (None = the folded union) with the
        engine's identifiers."""
        mask = self._mask(replica)
        out = GList()
        handle_of_slot = np.argsort(self.slots, kind="stable")
        for slot in np.nonzero(mask[: len(self.slots)])[0]:
            out.apply(Insert(id=self.identifier(handle_of_slot[slot])))
        return out
