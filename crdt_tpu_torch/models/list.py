"""BatchedList — N device-resident List replicas over a shared
identifier universe. Counterpart of the JAX package's ``models/list.py``.

Oracle: ``crdt_tpu_torch.pure.list.List`` (reference: src/list.rs).
Identifier allocation is inherently sequential per edit trace and runs
in the host engine (``crdt_tpu_torch.native.ListEngine``, C++); the
per-replica op application is batched on the device as scatters over an
order-maintenance array.

Layout: the engine's total identifier order (immutable — dense
identifiers never move relative to each other) gives every identifier a
*slot*; the device holds ``vals int32[R, N]`` + ``alive bool[R, N]`` in
slot order. An insert is ``alive[slot] = True, vals[slot] = v``; a
delete is ``alive[slot] = False``; a read is a host-side compress of
``vals`` by ``alive`` (already in sequence order).

The epoch scatter: the JAX package scatters ``[R, C]`` lanes with
``mode="drop"``, pad lanes routed past the last slot. torch has no
dropping scatter, so the host (which holds the epoch as numpy) keeps only
the valid lanes before the upload: :meth:`apply_ops` compresses them to
flat ``r·N + slot`` indices, and :meth:`apply_trace_to_all`, whose epoch
is the same for every replica, ships one slot list for all rows. No pad
lane reaches the device and, the host having deduped each epoch, no index
repeats, so the scatter's result does not depend on its order. An epoch
is two host-to-device copies and three launches (``index_copy_`` of the
inserts' values, ``index_fill_`` of their liveness, ``index_fill_`` of
the deletes'), with no host sync.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..dot import OrdDot
from ..native import DELETE, INSERT, ListEngine
from ..pure.identifier import Identifier
from ..pure.list import List


def growth_permutation(old_slots: np.ndarray, new_rank: np.ndarray) -> np.ndarray:
    """After the engine mints more identifiers, map the new total order
    back onto the old one: ``src[s]`` is the old slot feeding new slot
    ``s`` (-1 = freshly minted). Handles are stable and ordered
    first-n-minted-first, so the old handles are ``new_rank[:n_old]``."""
    src = np.full(len(new_rank), -1, np.int64)
    src[new_rank[: len(old_slots)]] = old_slots
    return src


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``. To a card it goes through pinned
    memory, so the copy is asynchronous: a copy from pageable memory
    would first wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _remap_slots(vals: torch.Tensor, alive: torch.Tensor, src: np.ndarray):
    """Permute replica state to a new total order: ``src[s]`` is the old
    slot feeding new slot ``s`` (-1 = freshly minted identifier, empty on
    every replica)."""
    s = upload(src, vals.device)
    safe, fresh = s.clamp(min=0), (s < 0)[None]
    return (vals.index_select(1, safe).masked_fill(fresh, 0),
            alive.index_select(1, safe).masked_fill(fresh, False))


def _apply_epoch(vals: torch.Tensor, alive: torch.Tensor, index: np.ndarray,
                 kinds: np.ndarray, epoch_vals: np.ndarray, dim: int) -> int:
    """Scatter one epoch of ops in place: inserts set value and alive,
    deletes clear alive; any other kind is a no-op. ``index`` holds the
    valid lanes' distinct positions along ``dim`` of ``vals``/``alive``
    (flat ``r·N + slot`` over the flattened state for ``dim`` 0, slots
    shared by every replica for ``dim`` 1). Returns the bytes uploaded."""
    ins, dele = kinds == INSERT, kinds == DELETE
    n_ins = int(ins.sum())
    idx = upload(np.concatenate([index[ins], index[dele]]).astype(np.int64), vals.device)
    v = upload(epoch_vals[ins].astype(np.int32), vals.device)
    tv, ta = (vals.view(-1), alive.view(-1)) if dim == 0 else (vals, alive)
    if n_ins:
        src = v if dim == 0 else v.expand(vals.shape[0], n_ins)
        tv.index_copy_(dim, idx[:n_ins], src)
        ta.index_fill_(dim, idx[:n_ins], True)
    if len(idx) > n_ins:
        ta.index_fill_(dim, idx[n_ins:], False)
    return idx.numel() * idx.element_size() + v.numel() * v.element_size()


class BatchedList:
    def __init__(self, n_replicas: int, device="cuda"):
        self.engine = ListEngine()
        # rank per identifier handle (the current total order)
        self.slots = np.empty(0, np.int64)
        self.vals = torch.zeros((n_replicas, 1), dtype=torch.int32, device=device)
        self.alive = torch.zeros((n_replicas, 1), dtype=torch.bool, device=device)
        self._mesh = None  # set by place()
        # The op log: stable identifier handles (slots move when later
        # inserts interleave the order; handles never do).
        self.op_handles = np.empty(0, np.int64)
        self.op_kinds = np.empty(0, np.uint8)
        self.op_vals = np.empty(0, np.int32)
        self._applied = 0  # watermark: ops [0, _applied) are on device
        self.uploaded_bytes = 0  # host-to-device bytes of the epoch scatters

    def place(self, mesh) -> None:
        """Lay the replica state out for a ``VirtualMesh``: the replica
        count must divide its P ranks, and the slot axis is padded with
        dead slots to a multiple of its ``s`` element shards (never
        addressed: scatters stop at the last slot, reads mask on
        ``alive``), as the JAX package's placement pads it, so shapes,
        reads and checkpoints agree. Streamed universe growth re-pads
        after every slot re-permutation. Placement is per-session: a
        checkpoint records only that the model was placed."""
        # Validate BEFORE installing: a rejected place() must leave the
        # model untouched.
        if self.vals.shape[0] % mesh.p:
            raise ValueError(
                f"{self.vals.shape[0]} replicas do not divide the {mesh.p}-way replica mesh axis"
            )
        self._mesh = mesh
        self.vals, self.alive = self._placed(self.vals, self.alive)

    def _placed(self, vals, alive):
        if self._mesh is None:
            return vals, alive
        device = self._mesh.device
        pad_n = (-vals.shape[1]) % self._mesh.s
        f = torch.nn.functional.pad
        return f(vals, (0, pad_n)).to(device), f(alive, (0, pad_n)).to(device)

    @classmethod
    def from_trace(cls, kinds: Sequence[int], indices: Sequence[int], values: Sequence[int],
                   actors: Sequence[int], n_replicas: int, device="cuda") -> "BatchedList":
        """Build the shared identifier universe by running the edit trace
        through the engine, then stand up ``n_replicas`` empty device
        replicas over it. For streamed ingestion start from
        ``BatchedList(n_replicas)`` and call :meth:`extend_trace` per
        chunk instead."""
        out = cls(n_replicas, device=device)
        out.extend_trace(kinds, indices, values, actors)
        return out

    def _grow(self) -> None:
        """Re-permute the device slots to the engine's grown total order;
        applied state moves with its identifiers."""
        new_rank = self.engine.total_order()
        if len(new_rank) != len(self.slots):
            src = growth_permutation(self.slots, new_rank)
            self.vals, self.alive = self._placed(*_remap_slots(self.vals, self.alive, src))
            self.slots = new_rank

    def _log(self, handles, kinds, values) -> None:
        self.op_handles = np.concatenate([self.op_handles, handles])
        self.op_kinds = np.concatenate([self.op_kinds, np.ascontiguousarray(kinds, np.uint8)])
        self.op_vals = np.concatenate([self.op_vals, np.ascontiguousarray(values, np.int32)])

    def extend_trace(self, kinds: Sequence[int], indices: Sequence[int], values: Sequence[int],
                     actors: Sequence[int]) -> None:
        """Grow the shared identifier universe with further local edit
        ops (streamed ingestion — the trace need not be known up front).
        New identifiers may interleave existing ones, so device slots are
        re-permuted to the new total order."""
        handles = self.engine.apply_trace(kinds, indices, values, actors)
        self._grow()
        self._log(handles, kinds, values)

    @property
    def op_slots(self) -> np.ndarray:
        """Current slot of every logged op (recomputed: slots move as the
        universe grows, handles don't)."""
        return self.slots[self.op_handles]

    @property
    def n_replicas(self) -> int:
        return self.vals.shape[0]

    # ---- batched op application (the device hot path) -----------------
    def apply_ops(self, replica_ops: np.ndarray, op_slots: Optional[np.ndarray] = None) -> None:
        """One epoch: ``replica_ops[r]`` lists trace-op indices for
        replica ``r`` (shape [R, C]; -1 pads). Within one epoch a replica
        must not touch the same slot twice (the scatter's order on
        duplicates is unspecified) — chunk the trace accordingly. The
        valid lanes go up as flat indices; the whole epoch is one scatter
        for ALL replicas.

        ``op_slots`` lets loop callers pass the op→slot table computed
        once (it is an O(oplog) gather otherwise)."""
        replica_ops = np.asarray(replica_ops)
        if replica_ops.ndim != 2 or replica_ops.shape[0] != self.n_replicas:
            raise ValueError(f"expected [R={self.n_replicas}, C] op indices")
        from ..config import config

        if config.strict:
            # The device analog of pure.list.List.validate_op's dup
            # rejection: a trace-op index delivered twice to one replica
            # in one epoch is a duplicate dot.
            from ..traits import DotRange

            for r in range(replica_ops.shape[0]):
                live = replica_ops[r][replica_ops[r] >= 0]
                uniq, counts = np.unique(live, return_counts=True)
                if (counts > 1).any():
                    dup = int(uniq[counts > 1][0])
                    raise DotRange(f"replica {r} trace op", dup, dup)
        if op_slots is None:
            op_slots = self.op_slots
        rows, cols = np.nonzero(replica_ops >= 0)
        ops = replica_ops[rows, cols]
        flat = rows * self.vals.shape[1] + op_slots[ops]
        self.uploaded_bytes += _apply_epoch(self.vals, self.alive, flat, self.op_kinds[ops],
                                            self.op_vals[ops], dim=0)

    def apply_trace_to_all(self, chunk: int = 4096) -> int:
        """Apply the not-yet-applied tail of the op log to every replica
        in epochs of ``chunk`` ops (streamed calls pick up where the last
        one stopped). Within an epoch, ops on the same slot compose to
        the LAST one (a slot's lifecycle is insert → delete, so the final
        write wins exactly) — the host dedupes, and each epoch lands as
        one conflict-free scatter of one slot list for all replicas (the
        JAX package's ``apply_ops`` of the broadcast epoch, whose strict
        duplicate check cannot fire on a deduped epoch). Returns the
        number of epochs."""
        n_ops = len(self.op_handles)
        op_slots = self.op_slots  # one gather; slots are stable herein
        epochs = 0
        for start in range(self._applied, n_ops, chunk):
            ep = np.arange(start, min(start + chunk, n_ops))
            # keep the last op per slot: first occurrence in the reversed
            # window is the last in trace order
            rev = ep[::-1]
            _, first = np.unique(op_slots[rev], return_index=True)
            keep = rev[first]
            self.uploaded_bytes += _apply_epoch(self.vals, self.alive, op_slots[keep],
                                                self.op_kinds[keep], self.op_vals[keep], dim=1)
            epochs += 1
        self._applied = n_ops
        return epochs

    # ---- cross-process op exchange ------------------------------------
    def export_ops(self, start: int = 0, end: Optional[int] = None):
        """Flatten ops ``[start, end)`` of the local log to plain numpy
        arrays (kind, value, path length, flattened (index, actor,
        counter) components) — the wire form. Identifier paths are
        globally unique and totally ordered by construction, so a remote
        engine ingesting them reproduces the same total order."""
        end = len(self.op_handles) if end is None else end
        paths = [self.engine.identifier_path(int(h)) for h in self.op_handles[start:end]]
        flat = [c for p in paths for c in p]
        return {
            "kinds": np.ascontiguousarray(self.op_kinds[start:end], np.uint8),
            "values": np.ascontiguousarray(self.op_vals[start:end], np.int32),
            "counts": np.asarray([len(p) for p in paths], np.int64),
            "cidx": np.asarray([c[0] for c in flat], np.int64),
            "cactor": np.asarray([c[1] for c in flat], np.int32),
            "cctr": np.asarray([c[2] for c in flat], np.uint64),
        }

    def ingest_remote_ops(self, wire) -> None:
        """Apply a remote process's exported ops into the local engine
        (idempotent: duplicate identifiers no-op) and append them to the
        op log; device slots re-permute to the grown total order."""
        counts = wire["counts"]
        if len(counts) == 0:
            return
        offsets = np.concatenate([[0], np.cumsum(counts)])
        cidx, cactor, cctr = wire["cidx"], wire["cactor"], wire["cctr"]
        paths = [[(int(cidx[i]), int(cactor[i]), int(cctr[i]))
                  for i in range(offsets[j], offsets[j + 1])] for j in range(len(counts))]
        handles = self.engine.apply_remote(wire["kinds"], paths, wire["values"])
        self._grow()
        # A delete of an identifier the engine never saw is an idempotent
        # no-op and yields handle -1 — it must NOT enter the op log
        # (self.slots[-1] would wrap to the highest-ranked identifier and
        # the scatter would clear an unrelated element).
        ok = handles >= 0
        self._log(handles[ok], np.ascontiguousarray(wire["kinds"], np.uint8)[ok],
                  np.ascontiguousarray(wire["values"], np.int32)[ok])

    # ---- reads ---------------------------------------------------------
    def _row(self, replica: int):
        return self.vals[replica].cpu().numpy(), self.alive[replica].cpu().numpy()

    def read(self, replica: int) -> list:
        """The replica's sequence of value ids (slot order == identifier
        order)."""
        vals, alive = self._row(replica)
        return vals[alive].tolist()

    def to_pure(self, replica: int, actors_table=None) -> List:
        """Reconstruct the oracle form (identifiers from the engine,
        values from device state). ``actors_table`` maps dense actor ids
        back to caller actors (identity if omitted)."""
        vals, alive = self._row(replica)
        out = List()
        handle_of_slot = np.argsort(self.slots, kind="stable")
        for slot in np.nonzero(alive[: len(self.slots)])[0]:
            path = self.engine.identifier_path(int(handle_of_slot[slot]))
            ident = Identifier(tuple(
                (ix, OrdDot(actors_table[a] if actors_table is not None else a, c))
                for ix, a, c in path
            ))
            out.seq.append(ident)
            out.vals[ident] = int(vals[slot])
        return out
