"""BatchedGSet — N G-Set replicas as a device membership bitmask.

Oracle: ``crdt_tpu_torch.pure.gset.GSet`` (reference: src/gset.rs). The
replica batch is ``present[R, E]`` over a fixed interned member universe;
merge is logical OR and full-mesh anti-entropy is one ``any`` reduction.
Counterpart of the JAX package's ``models/gset.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import gset as ops
from ..pure.gset import GSet
from ..utils import Interner


class BatchedGSet:
    def __init__(self, n_replicas: int, n_members: int, members: Optional[Interner] = None,
                 device="cuda"):
        self.members = members if members is not None else Interner()
        self.present = ops.zeros(n_members, batch=(n_replicas,), device=device)

    @property
    def n_replicas(self) -> int:
        return self.present.shape[0]

    @classmethod
    def from_pure(cls, pures: Sequence[GSet], members: Optional[Interner] = None,
                  n_members: int = 0, device="cuda") -> "BatchedGSet":
        """``n_members`` sets a capacity FLOOR above the members present
        in ``pures`` — spare lanes later inserts intern into."""
        members = members if members is not None else Interner()
        for p in pures:
            for m in sorted(p.value, key=repr):
                members.intern(m)
        arr = np.zeros((len(pures), max(len(members), n_members, 1)), bool)
        for i, p in enumerate(pures):
            for m in p.value:
                arr[i, members.id_of(m)] = True
        out = cls(len(pures), arr.shape[1], members=members, device="meta")
        out.present = torch.tensor(arr, device=device)
        return out

    def _set_of(self, row: torch.Tensor) -> GSet:
        return GSet(self.members[int(e)] for e in np.nonzero(row.cpu().numpy())[0])

    def to_pure(self, i: int) -> GSet:
        return self._set_of(self.present[i])

    def insert(self, replica: int, member) -> None:
        # bounded_intern raises BEFORE allocating when the universe is
        # full — a rejected insert is side-effect free.
        mid = self.members.bounded_intern(member, self.present.shape[-1], "member")
        self.present[replica, mid] = True

    def contains(self, replica: int, member) -> bool:
        if member not in self.members:
            return False
        mid = self.members.id_of(member)
        if mid >= self.present.shape[-1]:
            # A shared-interner name beyond this model's lanes.
            return False
        return bool(self.present[replica, mid])

    def merge_from(self, dst: int, src: int) -> None:
        self.present[dst] = ops.join(self.present[dst], self.present[src])

    def fold(self) -> GSet:
        return self._set_of(ops.fold(self.present))
