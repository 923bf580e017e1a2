"""Generational atomic snapshots layered on ``checkpoint`` — the port's
copy of the JAX package's ``durability/snapshot.py``, in its on-disk
format (either package loads the other's generations).

One snapshot DIRECTORY holds K generations; each generation ``g`` is a
payload file plus a manifest, committed in a strict order that gives
every crash window a defined meaning:

1. payload bytes → ``.tmp-payload-<g>`` (crash: no generation exists);
2. payload fsync, then ``os.replace`` → ``gen-<g>.npz`` (crash: a
   payload without a manifest — NOT a generation, ignored by load);
3. manifest JSON (per-array content checksums —
   ``checkpoint.array_checksum`` — payload byte length + whole-file CRC,
   the WAL watermark ``wal_seq``, payload kind) → ``.tmp-manifest-<g>``,
   fsync, ``os.replace`` → ``gen-<g>.json`` — THE COMMIT POINT;
4. directory fsync, then prune generations older than ``retain`` (crash
   mid-prune: extra old generations, harmless).

``load_newest`` walks generations newest-first and takes the first VALID
one — manifest parses, payload present, every checksum matches —
counting ``durability.snapshot_fallback`` for each corrupt generation it
skips; recovery then replays a LONGER WAL suffix (the older generation's
``wal_seq``) instead of failing. Two payload kinds:

- ``model`` — a ``checkpoint``-able model (``checkpoint._dump`` /
  ``_restore``), loaded onto ``device``;
- ``state`` — a raw mesh state tree (numbered leaves; loading needs a
  congruent ``template`` to unflatten through, and lands on the
  template's device — the caller that resumes a mesh knows its shapes).

Crashpoints (``durability.crashpoints``) bracket every boundary; the fuzz
loop kills at each and recovery must land bit-identical.
"""

from __future__ import annotations

import io
import json
import os
import re
import tempfile
import zlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..checkpoint import _dump, _restore, array_checksum, from_npz_bytes, fsync_dir, to_npz_bytes
from ..convert import leaf_from_numpy, leaf_to_numpy
from ..ops.lattice import tree_leaves, tree_unflatten
from ..utils.metrics import metrics
from . import crashpoints as cp

_GEN_RE = re.compile(r"^gen-(\d{8})\.json$")

CP_PRE_WRITE = cp.register(
    "snapshot.pre_write", "before any payload byte is written"
)
CP_MID_WRITE = cp.register(
    "snapshot.mid_snapshot_write",
    "half the payload flushed to the tmp file — a torn snapshot",
)
CP_POST_WRITE_PRE_FSYNC = cp.register(
    "snapshot.post_write_pre_fsync",
    "payload fully flushed, fsync barrier not yet issued",
)
CP_PRE_RENAME = cp.register(
    "snapshot.pre_rename", "payload fsynced, still under the tmp name"
)
CP_POST_RENAME_PRE_MANIFEST = cp.register(
    "snapshot.post_rename_pre_manifest",
    "payload renamed into place, manifest (the commit point) absent",
)
CP_MID_MANIFEST = cp.register(
    "snapshot.mid_manifest_write",
    "half the manifest flushed to the tmp file",
)
CP_PRE_MANIFEST_RENAME = cp.register(
    "snapshot.pre_manifest_rename",
    "manifest fsynced, still under the tmp name — one rename from commit",
)
CP_POST_COMMIT_PRE_PRUNE = cp.register(
    "snapshot.post_commit_pre_prune",
    "generation committed, retain-K prune not yet run",
)
CP_MID_PRUNE = cp.register(
    "snapshot.mid_prune", "one old generation unlinked, others pending"
)


class SnapshotCorrupt(RuntimeError):
    """No VALID generation survives in the snapshot directory (every
    manifest/payload pair is damaged, or none was ever committed)."""


class Generation(NamedTuple):
    gen: int
    wal_seq: int
    payload_kind: str       # "model" | "state"
    merge_kind: str         # merge kind ("" for model payloads)


def _gen_paths(path, gen: int) -> Tuple[str, str]:
    d = os.fspath(path)
    return os.path.join(d, f"gen-{gen:08d}.npz"), os.path.join(d, f"gen-{gen:08d}.json")


def generations(path) -> List[int]:
    """Committed generation numbers (manifest present), ascending."""
    try:
        names = os.listdir(os.fspath(path))
    except OSError:
        return []
    return sorted(int(m.group(1)) for n in names if (m := _GEN_RE.match(n)))


def _write_payload_and_manifest(path, gen: int, raw: bytes, manifest: dict, retain: int) -> int:
    """Steps 1-4 of the commit protocol (module docstring)."""
    d = os.fspath(path)
    os.makedirs(d, exist_ok=True)
    payload_path, manifest_path = _gen_paths(path, gen)
    tmp_payload = os.path.join(d, f".tmp-payload-{gen:08d}")
    tmp_manifest = os.path.join(d, f".tmp-manifest-{gen:08d}")

    cp.hit(CP_PRE_WRITE)
    with open(tmp_payload, "wb") as f:
        half = len(raw) // 2
        f.write(raw[:half])
        f.flush()  # the torn half really reached the OS (crash model)
        cp.hit(CP_MID_WRITE)
        f.write(raw[half:])
        f.flush()
        cp.hit(CP_POST_WRITE_PRE_FSYNC)
        os.fsync(f.fileno())
    cp.hit(CP_PRE_RENAME)
    os.replace(tmp_payload, payload_path)
    fsync_dir(d)
    cp.hit(CP_POST_RENAME_PRE_MANIFEST)

    mraw = json.dumps(manifest, sort_keys=True).encode("utf-8")
    with open(tmp_manifest, "wb") as f:
        half = len(mraw) // 2
        f.write(mraw[:half])
        f.flush()
        cp.hit(CP_MID_MANIFEST)
        f.write(mraw[half:])
        f.flush()
        os.fsync(f.fileno())
    cp.hit(CP_PRE_MANIFEST_RENAME)
    os.replace(tmp_manifest, manifest_path)  # THE commit point
    fsync_dir(d)
    metrics.count("durability.snapshots_written")
    obs.emit("snapshot_commit", gen=gen, wal_seq=manifest.get("wal_seq", 0))
    cp.hit(CP_POST_COMMIT_PRE_PRUNE)

    gens = generations(path)
    stale = gens[:-retain] if retain > 0 else []
    for i, old in enumerate(stale):
        p_old, m_old = _gen_paths(path, old)
        # Manifest first: a crash mid-prune must never leave a manifest
        # pointing at an unlinked payload looking "corrupt" — a missing
        # manifest just means "not a generation".
        for victim in (m_old, p_old):
            try:
                os.unlink(victim)
            except OSError:
                pass
        if i == 0:
            cp.hit(CP_MID_PRUNE)
    if stale:
        fsync_dir(d)
    return gen


def _manifest_for(raw: bytes, arrays: dict, *, wal_seq: int, payload_kind: str,
                  merge_kind: str) -> dict:
    return {
        "version": 1,
        "payload": payload_kind,
        "kind": merge_kind,
        "wal_seq": int(wal_seq),
        "payload_bytes": len(raw),
        "payload_crc32": zlib.crc32(raw) & 0xFFFFFFFF,
        "checksums": {k: array_checksum(v) for k, v in arrays.items()},
    }


def save(path, model, *, wal_seq: int = 0, retain: int = 3, compact: bool = False) -> int:
    """Commit a new generation holding a checkpointable MODEL; returns its
    generation number. ``wal_seq`` is the WAL watermark the payload
    includes (replay starts after it); ``retain`` keeps the newest K
    generations (older ones prune after commit). ``compact=True`` composes
    ``checkpoint.save``'s compact-on-save."""
    if compact:
        from ..checkpoint import compact_on_save

        compact_on_save(model)
    meta, arrays = _dump(model)
    raw = to_npz_bytes(meta, arrays)
    gen = (generations(path) or [0])[-1] + 1
    manifest = _manifest_for(raw, arrays, wal_seq=wal_seq, payload_kind="model", merge_kind="")
    return _write_payload_and_manifest(path, gen, raw, manifest, retain)


def save_state(path, kind: str, state, *, wal_seq: int = 0, retain: int = 3) -> int:
    """Commit a new generation holding a RAW mesh state tree of merge
    ``kind`` (numbered leaves; ``load_newest`` needs a congruent template
    to unflatten)."""
    arrays = {f"a_{i}": leaf_to_numpy(x) for i, x in enumerate(tree_leaves(state))}
    raw = to_npz_bytes({"payload": "state", "kind": kind}, arrays)
    gen = (generations(path) or [0])[-1] + 1
    manifest = _manifest_for(raw, arrays, wal_seq=wal_seq, payload_kind="state", merge_kind=kind)
    return _write_payload_and_manifest(path, gen, raw, manifest, retain)


def _load_generation(path, gen: int, template=None, device="cuda"):
    """One generation's ``(payload, Generation)`` — raises on ANY integrity
    failure (the caller falls back a generation)."""
    payload_path, manifest_path = _gen_paths(path, gen)
    with open(manifest_path, "rb") as f:
        mraw = f.read()
    try:
        manifest = json.loads(mraw.decode("utf-8"))
    except ValueError as exc:  # torn/garbled manifest IS corruption — it
        # must fall back a generation, not escape as a caller error
        raise SnapshotCorrupt(f"generation {gen}: manifest does not parse ({exc})") from exc
    with open(payload_path, "rb") as f:
        raw = f.read()
    if (len(raw) != int(manifest["payload_bytes"])
            or zlib.crc32(raw) & 0xFFFFFFFF != int(manifest["payload_crc32"])):
        raise SnapshotCorrupt(f"generation {gen}: payload bytes fail the manifest CRC")
    meta, arrays = from_npz_bytes(payload_path, raw)  # npz-level checksums
    sums = manifest.get("checksums", {})
    for name, v in arrays.items():
        if array_checksum(v) != int(sums.get(name, -1)):
            raise SnapshotCorrupt(f"generation {gen}: array {name!r} fails its manifest checksum")
    info = Generation(
        gen=gen,
        wal_seq=int(manifest["wal_seq"]),
        payload_kind=manifest["payload"],
        merge_kind=manifest.get("kind", ""),
    )
    if info.payload_kind == "model":
        return _restore(meta, arrays, device), info
    if template is None:
        raise ValueError("state-payload generation needs a congruent `template` to unflatten "
                         "through")
    dev = tree_leaves(template)[0].device
    n = sum(1 for k in arrays if k.startswith("a_"))
    return tree_unflatten(template, [leaf_from_numpy(arrays[f"a_{i}"], dev)
                                     for i in range(n)]), info


def load_newest(path, template=None, device="cuda"):
    """The newest VALID generation's ``(payload, Generation)`` — corrupt
    generations fall back one at a time (counting
    ``durability.snapshot_fallback`` each; recovery then
    replays the older generation's longer WAL suffix). A model payload
    loads onto ``device``, a state payload onto its template's device.
    Raises :class:`SnapshotCorrupt` when nothing valid survives."""
    gens = generations(path)
    last_err: Optional[BaseException] = None
    for gen in reversed(gens):
        try:
            return _load_generation(path, gen, template, device)
        except (ValueError, TypeError):
            raise  # caller bugs (missing template) are not corruption
        except Exception as exc:
            # Any other failure of one generation (a missing payload, a
            # CheckpointCorrupt, a truncated zip) is that generation's
            # corruption: count it and fall back to the next older one.
            metrics.count("durability.snapshot_fallback")
            obs.emit("snapshot_fallback", gen=gen)
            last_err = exc
    raise SnapshotCorrupt(
        f"no valid generation in {os.fspath(path)!r} "
        f"(saw {gens or 'none'}; last error: {last_err})"
    )


def corrupt_generation(path, gen: int) -> None:
    """Rot one generation's payload in the way only the MANIFEST can catch:
    perturb an array and re-serialize the npz so the file stays internally
    parseable (a naive byte-flip would trip the zip layer's own entry CRC
    and even a checksum-blind loader would "detect" it — masking the
    gate). The manifest's recorded checksums / payload CRC are left stale,
    exactly the cross-file inconsistency a torn replacement or buggy
    re-writer produces."""
    payload_path, _ = _gen_paths(path, gen)
    with open(payload_path, "rb") as f:
        raw = f.read()
    with np.load(io.BytesIO(raw)) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        arrays = {k: np.array(z[k]) for k in z.files if k != "meta"}
    name = sorted(k for k in arrays if k != "meta")[0]
    flat = arrays[name].reshape(-1)
    if flat.size:
        flat[0] = np.bitwise_xor(flat[0], np.ones((), flat.dtype)) \
            if flat.dtype.kind in "iu" else flat[0] + 1
    buf = io.BytesIO()
    np.savez(
        buf,
        meta=np.frombuffer(json.dumps(meta, sort_keys=True).encode("utf-8"), dtype=np.uint8),
        **arrays,
    )
    with open(payload_path, "wb") as f:
        f.write(buf.getvalue())


def loader_detects_corruption(load_fn) -> bool:
    """The loader-integrity detector: commit a single-generation snapshot
    into a scratch dir, rot its payload (:func:`corrupt_generation`), and
    require ``load_fn(dir, template)`` to REFUSE (any exception). A
    checksum-ignoring loader must fail here — it would hand rotten state
    to a resuming mesh."""
    state = (torch.arange(64, dtype=torch.int32).view(torch.uint32),)
    with tempfile.TemporaryDirectory() as d:
        gen = save_state(d, "probe", state, wal_seq=0)
        corrupt_generation(d, gen)
        try:
            load_fn(d, state)
        except Exception:
            return True
        return False


__all__ = [
    "Generation", "SnapshotCorrupt", "corrupt_generation", "generations", "load_newest",
    "loader_detects_corruption", "save", "save_state",
]
