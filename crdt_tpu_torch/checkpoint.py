"""Checkpoint / resume for device-resident replica state — the port's
copy of the JAX package's ``checkpoint.py``, in its on-disk format.

A model's struct-of-arrays state goes into one ``.npz`` (host numpy
copies, dtypes as the JAX package stores them: u32 lanes ``<u4``, bools
``|b1``), and the host-side tables (interners) ride along as a
canonical-JSON ``meta`` member of the same file, interned items written
through ``serde.encode``. Every array carries a content checksum
(:func:`array_checksum`) recorded in the meta. Files written by either
package load in the other. ``load`` rebuilds the model on ``device``;
resuming is then ordinary anti-entropy (``merge``/``fold`` with the live
replicas).

Ported kinds: ``BatchedOrswot`` (``orswot``), ``BatchedSparseOrswot``
(``sparse_orswot``), ``BatchedMap`` (``map``), ``BatchedSparseMapOrswot``
(``sparse_map_orswot``), ``BatchedSparseMap`` (``sparse_map``), the dense
nests ``BatchedMapOrswot`` (``map_orswot``), ``BatchedNestedMap``
(``map_map``) and ``BatchedMap3`` (``map3``) — their leaves numbered
``a_0, a_1, ...`` in the JAX package's pytree order, the model's widths
under ``dims`` — ``BatchedSparseNestedMap`` (``sparse_map_map``), and the
sequences ``BatchedList`` (``list``) and ``BatchedGList`` (``glist``),
whose host engine rides along as every identifier's path, the live
handles and the mint clock (``_engine_dump``), re-ingested on load.
``compact=True`` compacts the model against its own rows' frontier
before the dump (``reclaim.compact_model``); a model outside the
compactable family saves as it is and counts
``reclaim.compact_on_save_unsupported``.
"""

from __future__ import annotations

import io
import json
import os
import warnings
import zlib
from typing import Union

import numpy as np

from . import serde
from .convert import leaf_from_numpy, leaf_to_numpy
from .models.glist import BatchedGList
from .models.list import BatchedList
from .models.map import BatchedMap
from .models.map3 import BatchedMap3
from .models.map_nested import BatchedMapOrswot, BatchedNestedMap
from .models.orswot import BatchedOrswot
from .models.sparse_map import BatchedSparseMapOrswot
from .models.sparse_mvmap import BatchedSparseMap
from .models.sparse_nested_map import BatchedSparseNestedMap
from .models.sparse_orswot import BatchedSparseOrswot
from .ops.map import MapState
from .ops.mvreg import MVRegState
from .ops.lattice import tree_leaves, tree_unflatten
from .ops.orswot import OrswotState
from .ops.sparse_mvmap import SparseMVMapState
from .ops.sparse_nest import SparseNestState
from .ops.sparse_orswot import SparseOrswotState
from .native import DELETE, INSERT
from .utils import Interner
from .utils.metrics import metrics


class CheckpointCorrupt(RuntimeError):
    """A checkpoint's stored bytes fail their recorded content checksum.
    ``array`` names the offending array so the operator knows WHAT
    rotted, not just that something did. Raised by :func:`load` instead
    of silently reconstructing a model from rotten bytes; recovery is a
    matter for the generational snapshot tier (``durability.snapshot``
    falls back one generation)."""

    def __init__(self, path, array: str, expect: int, got=None):
        detail = (
            "is MISSING from the file" if got is None
            else f"fails its content checksum (recorded {expect:#010x}, "
                 f"stored bytes hash to {got:#010x})"
        )
        super().__init__(
            f"checkpoint {os.fspath(path)!r}: array {array!r} {detail} — "
            f"the file is corrupt; restore from an older generation "
            f"instead of loading rotten state"
        )
        self.path = os.fspath(path)
        self.array = array


def array_checksum(v: np.ndarray) -> int:
    """CRC-32 of one array's dtype, shape, and content bytes — the
    per-array integrity unit ``save`` records and ``load`` verifies
    (also the manifest unit of ``durability.snapshot``)."""
    v = np.ascontiguousarray(v)
    crc = zlib.crc32(f"{v.dtype.str}:{v.shape}".encode("ascii"))
    # crc32 takes any buffer: hash the array's memory in place instead
    # of a tobytes() copy (flagship-scale content planes are GBs).
    return zlib.crc32(v.reshape(-1).view(np.uint8).data, crc) & 0xFFFFFFFF


def fsync_dir(path) -> None:
    """fsync a DIRECTORY so a just-renamed/created entry inside it is
    durable across power loss (write-then-rename alone only orders the
    data, not the directory entry). Best-effort on platforms whose
    directories refuse O_RDONLY opens."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(os.fspath(path), flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _interner_items(interner: Interner):
    return [serde.encode(item) for item in interner.items()]


def _interner_from(items) -> Interner:
    return Interner(serde.decode(item) for item in items)


def _fields(prefix: str, state) -> dict:
    return {f"{prefix}{k}": leaf_to_numpy(v) for k, v in state._asdict().items()}


def _state_arrays(state) -> dict:
    """A state's leaves as numbered host arrays ``a_0, a_1, ...`` in the
    JAX package's pytree order (NamedTuple fields, depth first)."""
    return {f"a_{i}": leaf_to_numpy(x) for i, x in enumerate(tree_leaves(state))}


def _state_from_arrays(template, arrays: dict, device):
    """The inverse of :func:`_state_arrays` through a template state of
    the same structure."""
    n = sum(1 for k in arrays if k.startswith("a_"))
    return tree_unflatten(template, [leaf_from_numpy(arrays[f"a_{i}"], device)
                                     for i in range(n)])


def _engine_dump(engine) -> dict:
    """Host-side identifier-tree state: every minted identifier's path
    (ragged, as counts + flat components) plus the live handle set —
    enough to re-ingest into a fresh engine via ``apply_remote``."""
    counts, cidx, cactor, cctr = [], [], [], []
    for h in range(engine.total_ids()):
        path = engine.identifier_path(h)
        counts.append(len(path))
        for ix, a, c in path:
            cidx.append(ix)
            cactor.append(a)
            cctr.append(c)
    live, _ = engine.read()
    clk_actors, clk_ctrs = engine.clock_dump()
    return {
        "e_counts": np.asarray(counts, np.int64),
        "e_cidx": np.asarray(cidx, np.int64),
        "e_cactor": np.asarray(cactor, np.int32),
        "e_cctr": np.asarray(cctr, np.uint64),
        "e_live": np.asarray(live, np.int64),
        # The mint clock rides separately: deletes consume counters no
        # surviving identifier path records, and a resumed engine must
        # not re-mint spent dots.
        "e_clk_actors": clk_actors,
        "e_clk_ctrs": clk_ctrs,
    }


def _engine_restore(engine, arrays, values: np.ndarray) -> None:
    """Re-ingest a dumped identifier tree: INSERT every identifier by
    path (in mint order, reproducing handle numbering), then DELETE the
    ones that were dead. ``values[h]`` is identifier ``h``'s payload."""
    for actor, ctr in zip(arrays["e_clk_actors"], arrays["e_clk_ctrs"]):
        engine.clock_seed(int(actor), int(ctr))
    paths, pos = [], 0
    for c in arrays["e_counts"]:
        c = int(c)
        paths.append([(int(arrays["e_cidx"][i]), int(arrays["e_cactor"][i]),
                       int(arrays["e_cctr"][i])) for i in range(pos, pos + c)])
        pos += c
    if not paths:
        return
    handles = engine.apply_remote(np.full(len(paths), INSERT, np.uint8), paths,
                                  np.asarray(values, np.int32))
    if not (handles == np.arange(len(paths))).all():
        raise ValueError("restored identifier handles drifted from the checkpoint's")
    live = set(int(h) for h in arrays["e_live"])
    dead = [h for h in range(len(paths)) if h not in live]
    if dead:
        engine.apply_remote(np.full(len(dead), DELETE, np.uint8), [paths[h] for h in dead],
                            np.zeros(len(dead), np.int32))


def _check_order(engine, slots) -> None:
    if not (engine.total_order() == slots).all():
        raise ValueError("restored identifier order drifted from the checkpoint")


def _dump(model) -> tuple:
    """``(meta, arrays)`` for a checkpointable model — the type dispatch
    :func:`save` serializes and ``durability.snapshot`` layers generations
    on. ``arrays`` values are host numpy; ``meta`` is JSON-serializable."""
    if isinstance(model, BatchedOrswot):
        meta = {"kind": "orswot", "members": _interner_items(model.members),
                "actors": _interner_items(model.actors)}
        arrays = _fields("s_", model.state)
    elif isinstance(model, BatchedSparseOrswot):
        meta = {"kind": "sparse_orswot", "members": _interner_items(model.members),
                "actors": _interner_items(model.actors)}
        arrays = _fields("s_", model.state)
    elif isinstance(model, BatchedMap):
        meta = {"kind": "map", "keys": _interner_items(model.keys),
                "actors": _interner_items(model.actors),
                "values": _interner_items(model.values)}
        arrays = {f"s_{k}": leaf_to_numpy(v) for k, v in model.state._asdict().items()
                  if k != "child"}
        arrays.update(_fields("c_", model.state.child))
    elif isinstance(model, BatchedSparseMapOrswot):
        meta = {"kind": "sparse_map_orswot", "span": model.span,
                "keys": _interner_items(model.keys), "members": _interner_items(model.members),
                "actors": _interner_items(model.actors)}
        arrays = _fields("c_", model.state.core)
        arrays.update({f"s_{k}": leaf_to_numpy(v) for k, v in model.state._asdict().items()
                       if k != "core"})
    elif isinstance(model, BatchedSparseMap):
        meta = {"kind": "sparse_map", "n_keys": model.n_keys, "sibling_cap": model.sibling_cap,
                "keys": _interner_items(model.keys), "actors": _interner_items(model.actors),
                "values": _interner_items(model.values)}
        arrays = _fields("s_", model.state)
    elif isinstance(model, BatchedMapOrswot):
        meta = {"kind": "map_orswot", "keys": _interner_items(model.keys),
                "members": _interner_items(model.members),
                "actors": _interner_items(model.actors),
                "dims": [model.n_replicas, model.n_keys, model.n_members,
                         int(model.state.core.top.shape[-1]), int(model.state.kdcl.shape[-2])]}
        arrays = _state_arrays(model.state)
    elif isinstance(model, BatchedNestedMap):
        meta = {"kind": "map_map", "keys1": _interner_items(model.keys1),
                "keys2": _interner_items(model.keys2), "actors": _interner_items(model.actors),
                "values": _interner_items(model.values),
                "dims": [model.n_replicas, model.n_keys1, model.n_keys2,
                         int(model.state.m.top.shape[-1]),
                         int(model.state.m.child.wact.shape[-1]),
                         int(model.state.odcl.shape[-2])]}
        arrays = _state_arrays(model.state)
    elif isinstance(model, BatchedMap3):
        meta = {"kind": "map3", "keys1": _interner_items(model.keys1),
                "keys2": _interner_items(model.keys2), "members": _interner_items(model.members),
                "actors": _interner_items(model.actors),
                "dims": [model.n_replicas, model.n_keys1, model.n_keys2, model.n_members,
                         int(model.state.mo.core.top.shape[-1]),
                         int(model.state.odcl.shape[-2])]}
        arrays = _state_arrays(model.state)
    elif isinstance(model, BatchedSparseNestedMap):
        meta = {"kind": "sparse_map_map", "span": model.span, "sibling_cap": model.sibling_cap,
                "n_keys1": model.n_keys1, "keys1": _interner_items(model.keys1),
                "keys2": _interner_items(model.keys2), "actors": _interner_items(model.actors),
                "values": _interner_items(model.values)}
        arrays = _fields("c_", model.state.core)
        arrays.update({f"s_{k}": leaf_to_numpy(v) for k, v in model.state._asdict().items()
                       if k != "core"})
    elif isinstance(model, BatchedList):
        ins = model.op_kinds == INSERT
        values = np.zeros(model.engine.total_ids(), np.int32)
        values[model.op_handles[ins]] = model.op_vals[ins]
        # Placement is not persisted (it names a live mesh); ``placed``
        # records that the caller should re-``place`` after load.
        meta = {"kind": "list", "n_replicas": model.n_replicas, "applied": model._applied,
                "placed": model._mesh is not None}
        arrays = {"slots": model.slots, "vals": leaf_to_numpy(model.vals),
                  "alive": leaf_to_numpy(model.alive), "op_handles": model.op_handles,
                  "op_kinds": model.op_kinds, "op_vals": model.op_vals, "id_values": values,
                  **_engine_dump(model.engine)}
    elif isinstance(model, BatchedGList):
        meta = {"kind": "glist", "n_replicas": model.n_replicas}
        arrays = {"slots": model.slots, "uvals": model.uvals,
                  "alive": leaf_to_numpy(model.alive), **_engine_dump(model.engine)}
    else:
        raise TypeError(
            f"cannot checkpoint {type(model).__name__}: the port checkpoints BatchedOrswot, "
            f"BatchedSparseOrswot, BatchedMap, BatchedSparseMapOrswot, BatchedSparseMap, "
            f"BatchedMapOrswot, BatchedNestedMap, BatchedMap3, BatchedSparseNestedMap, "
            f"BatchedList and BatchedGList"
        )
    return meta, {k: np.asarray(v) for k, v in arrays.items()}


def to_npz_bytes(meta: dict, arrays: dict) -> bytes:
    """One .npz image of ``(meta, arrays)`` with per-array content
    checksums recorded in the meta — the byte format ``save`` writes
    and ``durability.snapshot`` frames into generations."""
    meta = dict(meta)
    meta["checksums"] = {k: array_checksum(v) for k, v in arrays.items()}
    buf = io.BytesIO()
    np.savez(
        buf,
        meta=np.frombuffer(json.dumps(meta, sort_keys=True).encode("utf-8"), dtype=np.uint8),
        **arrays,
    )
    return buf.getvalue()


_WARNED_NO_CHECKSUMS = False


def from_npz_bytes(path, raw) -> tuple:
    """Parse + integrity-check one .npz image: returns ``(meta,
    arrays)`` or raises :class:`CheckpointCorrupt` naming the first
    array whose stored bytes fail their recorded checksum. Checkpoints
    predating the checksums load with a one-shot warning — their
    integrity is UNKNOWN, not verified."""
    global _WARNED_NO_CHECKSUMS
    with np.load(io.BytesIO(raw) if isinstance(raw, bytes) else raw) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != "meta"}
    sums = meta.get("checksums")
    if sums is None:
        if not _WARNED_NO_CHECKSUMS:
            _WARNED_NO_CHECKSUMS = True
            warnings.warn(
                f"checkpoint {os.fspath(path)!r} predates per-array "
                f"content checksums — integrity NOT verified (re-save to "
                f"upgrade). Warned once per process.",
                stacklevel=3,
            )
        metrics.count("checkpoint.loaded_unverified")
        return meta, arrays
    # Iterate the RECORDED set, not the stored one: a rotten file that
    # dropped an array entirely must fail here with its name, not leak
    # a bare KeyError out of the restore dispatch.
    missing = sorted(set(sums) - set(arrays))
    if missing:
        raise CheckpointCorrupt(path, missing[0], int(sums[missing[0]]))
    for name, v in arrays.items():
        got = array_checksum(v)
        expect = int(sums.get(name, -1))
        if got != expect:
            raise CheckpointCorrupt(path, name, expect, got)
    return meta, arrays


def compact_on_save(model) -> None:
    """``save(compact=True)``'s compaction, shared with
    ``durability.snapshot.save``. Only the family check softens to a
    counter: an error raised inside a compaction surfaces."""
    from . import elastic
    from .reclaim import compact_model

    try:
        elastic.kind_of(model)
    except TypeError:
        metrics.count("reclaim.compact_on_save_unsupported")
    else:
        compact_model(model)


def save(path: Union[str, os.PathLike], model, compact: bool = False) -> None:
    """Checkpoint a device model to ``path`` (one .npz file) with
    per-array content checksums, atomically AND durably: the tmp file
    (and its directory) is fsynced BEFORE the rename — write-then-rename
    without the fsync orders nothing across power loss, so a crash
    could leave the renamed file empty.

    ``compact=True`` runs causal-stability compaction against the model's
    OWN replica rows first (``reclaim.compact_model`` — sound because the
    checkpointed batch is the replica set the frontier is taken over):
    retired parked slots and stale dead payload never reach disk. Models
    outside the compactable family (lists, counters) save as they are,
    counting ``reclaim.compact_on_save_unsupported``."""
    if compact:
        compact_on_save(model)
    meta, arrays = _dump(model)
    tmp = f"{os.fspath(path)}.tmp"
    with open(tmp, "wb") as f:
        f.write(to_npz_bytes(meta, arrays))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(os.fspath(path))))


def load(path: Union[str, os.PathLike], device="cuda"):
    """Restore a model checkpointed by ``save`` (either package's) onto
    ``device``; raises :class:`CheckpointCorrupt` (naming the array) when
    the stored bytes fail their recorded content checksums instead of
    silently reconstructing from rotten state."""
    with open(path, "rb") as f:
        meta, arrays = from_npz_bytes(path, f.read())
    return _restore(meta, arrays, device)


def _prefixed(arrays: dict, prefix: str, device) -> dict:
    return {k[len(prefix):]: leaf_from_numpy(v, device)
            for k, v in arrays.items() if k.startswith(prefix)}


def _restore(meta: dict, arrays: dict, device="cuda"):
    """Rebuild the model from a parsed ``(meta, arrays)`` image on
    ``device`` (the inverse of :func:`_dump`; shared with
    ``durability.snapshot``)."""
    kind = meta["kind"]
    if kind == "orswot":
        state = OrswotState(**_prefixed(arrays, "s_", device))
        model = BatchedOrswot(
            state.top.shape[0], state.ctr.shape[-2], state.ctr.shape[-1], state.dcl.shape[-2],
            members=_interner_from(meta["members"]), actors=_interner_from(meta["actors"]),
            device="meta",
        )
    elif kind == "sparse_orswot":
        state = SparseOrswotState(**_prefixed(arrays, "s_", device))
        model = BatchedSparseOrswot(
            state.top.shape[0], state.eid.shape[-1], state.top.shape[-1], state.dcl.shape[-2],
            state.didx.shape[-1], members=_interner_from(meta["members"]),
            actors=_interner_from(meta["actors"]), device="meta",
        )
    elif kind == "map":
        state = MapState(child=MVRegState(**_prefixed(arrays, "c_", device)),
                         **_prefixed(arrays, "s_", device))
        model = BatchedMap(
            state.top.shape[0], state.dkeys.shape[-1], state.top.shape[-1],
            state.child.wact.shape[-1], state.dcl.shape[-2],
            keys=_interner_from(meta["keys"]), actors=_interner_from(meta["actors"]),
            values=_interner_from(meta["values"]), device="meta",
        )
    elif kind == "sparse_map_orswot":
        core = SparseOrswotState(**_prefixed(arrays, "c_", device))
        state = SparseNestState(core=core, **_prefixed(arrays, "s_", device))
        model = BatchedSparseMapOrswot(
            core.top.shape[0], int(meta["span"]), core.eid.shape[-1], core.top.shape[-1],
            core.dcl.shape[-2], core.didx.shape[-1], state.kcl.shape[-2], state.kidx.shape[-1],
            keys=_interner_from(meta["keys"]), members=_interner_from(meta["members"]),
            actors=_interner_from(meta["actors"]), device="meta",
        )
    elif kind == "sparse_map":
        state = SparseMVMapState(**_prefixed(arrays, "s_", device))
        model = BatchedSparseMap(
            state.top.shape[0], int(meta["n_keys"]), state.top.shape[-1], state.kid.shape[-1],
            int(meta["sibling_cap"]), state.dcl.shape[-2], state.kidx.shape[-1],
            keys=_interner_from(meta["keys"]), actors=_interner_from(meta["actors"]),
            values=_interner_from(meta["values"]), device="meta",
        )
    elif kind == "map_orswot":
        r, nk, nm, na, d = meta["dims"]
        model = BatchedMapOrswot(
            r, nk, nm, na, d, keys=_interner_from(meta["keys"]),
            members=_interner_from(meta["members"]), actors=_interner_from(meta["actors"]),
            device="meta")
        state = _state_from_arrays(model.state, arrays, device)
    elif kind == "map_map":
        r, nk1, nk2, na, s, d = meta["dims"]
        model = BatchedNestedMap(
            r, nk1, nk2, na, s, d, keys1=_interner_from(meta["keys1"]),
            keys2=_interner_from(meta["keys2"]), actors=_interner_from(meta["actors"]),
            values=_interner_from(meta["values"]), device="meta")
        state = _state_from_arrays(model.state, arrays, device)
    elif kind == "map3":
        r, nk1, nk2, nm, na, d = meta["dims"]
        model = BatchedMap3(
            r, nk1, nk2, nm, na, d, keys1=_interner_from(meta["keys1"]),
            keys2=_interner_from(meta["keys2"]), members=_interner_from(meta["members"]),
            actors=_interner_from(meta["actors"]), device="meta")
        state = _state_from_arrays(model.state, arrays, device)
    elif kind == "sparse_map_map":
        core = SparseMVMapState(**_prefixed(arrays, "c_", device))
        state = SparseNestState(core=core, **_prefixed(arrays, "s_", device))
        model = BatchedSparseNestedMap(
            core.top.shape[0], int(meta["span"]), core.kid.shape[-1], core.top.shape[-1],
            int(meta["sibling_cap"]), core.dcl.shape[-2], core.kidx.shape[-1],
            state.kcl.shape[-2], state.kidx.shape[-1],
            # Older files predate the persisted bound: 0 is the packing's
            # widest universe, their save-time value.
            n_keys1=int(meta.get("n_keys1", 0)), keys1=_interner_from(meta["keys1"]),
            keys2=_interner_from(meta["keys2"]), actors=_interner_from(meta["actors"]),
            values=_interner_from(meta["values"]), device="meta")
    elif kind == "list":
        model = BatchedList(int(meta["n_replicas"]), device=device)
        if meta.get("placed"):
            warnings.warn(
                "checkpointed BatchedList was mesh-placed; placement is not persisted — call "
                "place(mesh) again on the restored model before large-scale use",
                stacklevel=2,
            )
        _engine_restore(model.engine, arrays, arrays["id_values"])
        _check_order(model.engine, arrays["slots"])
        model.slots = arrays["slots"]
        model.vals = leaf_from_numpy(arrays["vals"], device)
        model.alive = leaf_from_numpy(arrays["alive"], device)
        model.op_handles = arrays["op_handles"]
        model.op_kinds = arrays["op_kinds"]
        model.op_vals = arrays["op_vals"]
        model._applied = int(meta["applied"])
        return model
    elif kind == "glist":
        model = BatchedGList(int(meta["n_replicas"]), device=device)
        _engine_restore(model.engine, arrays, arrays["uvals"])
        _check_order(model.engine, arrays["slots"])
        model.slots = arrays["slots"]
        model.uvals = arrays["uvals"]
        model.alive = leaf_from_numpy(arrays["alive"], device)
        return model
    else:
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    model.state = state
    return model


__all__ = [
    "CheckpointCorrupt", "array_checksum", "fsync_dir", "from_npz_bytes", "load", "save",
    "to_npz_bytes",
]
