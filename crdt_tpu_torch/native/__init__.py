"""crdt_tpu_torch.native — the host-side list engine, compiled.

``listseq.cpp`` (the JAX package's source, copied unchanged) allocates
dense identifiers and keeps the ordered sequence for List/GList: the
inherently sequential half of BASELINE config 5, which no device runs.
``ListEngine`` is its Python face, over a plain ``extern "C"`` surface
through ctypes.

The shared library is built with ``g++ -O2 -shared -fPIC -std=c++17`` at
first use, into ``crdt_tpu_torch/csrc/build/`` (git-ignored), keyed by a
hash of the source and the command so an edited source is rebuilt. The
build writes a temporary file and renames it, so processes that share a
checkout never load a half-written library. A failed build or load
raises: there is no quiet fallback to the pure-Python engine, which is
reached only by ``ListEngine(impl="python")`` (the tests hold it against
the native one).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "listseq.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "csrc", "build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

INSERT, DELETE = 0, 1

_lock = threading.Lock()
_lib = None


def _target() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join((CXX, *CXX_FLAGS)).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"liblistseq-{digest[:16]}.so")


def _build(out: str) -> None:
    """Compile ``listseq.cpp`` into ``out`` through a temporary file and a
    rename. Raises RuntimeError when the compiler is missing or fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"crdt_tpu_torch.native: cannot run {CXX!r} ({exc})") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"crdt_tpu_torch.native: {CXX} failed on listseq.cpp:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib) -> None:
    i64, i32, u8, u64 = (np.ctypeslib.ndpointer(t, flags="C")
                         for t in (np.int64, np.int32, np.uint8, np.uint64))
    p = ctypes.c_void_p
    lib.ls_new.restype = p
    lib.ls_free.argtypes = [p]
    lib.ls_apply_trace.restype = ctypes.c_int64
    lib.ls_apply_trace.argtypes = [p, u8, i64, i32, i32, ctypes.c_int64, i64]
    lib.ls_apply_remote.restype = ctypes.c_int64
    lib.ls_apply_remote.argtypes = [p, u8, i64, i64, i32, u64, i32, ctypes.c_int64, i64]
    lib.ls_len.restype = ctypes.c_int64
    lib.ls_len.argtypes = [p]
    lib.ls_total_ids.restype = ctypes.c_int64
    lib.ls_total_ids.argtypes = [p]
    lib.ls_read.argtypes = [p, i64, i32]
    lib.ls_total_order.argtypes = [p, i64]
    lib.ls_id_len.restype = ctypes.c_int64
    lib.ls_id_len.argtypes = [p, ctypes.c_int64]
    lib.ls_id_path.argtypes = [p, ctypes.c_int64, i64, i32, u64]
    lib.ls_clock_get.restype = ctypes.c_int64
    lib.ls_clock_get.argtypes = [p, ctypes.c_int32]
    lib.ls_clock_count.restype = ctypes.c_int64
    lib.ls_clock_count.argtypes = [p]
    lib.ls_clock_dump.argtypes = [p, i32, u64]
    lib.ls_clock_seed.argtypes = [p, ctypes.c_int32, ctypes.c_uint64]


def library():
    """The loaded engine library, built on first use. A library that does
    not load (one built elsewhere) is rebuilt once; raises RuntimeError
    when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            out = _target()
            if not os.path.exists(out):
                _build(out)
            try:
                lib = ctypes.CDLL(out)
            except OSError:
                os.unlink(out)
                _build(out)
                try:
                    lib = ctypes.CDLL(out)
                except OSError as exc:
                    raise RuntimeError(f"crdt_tpu_torch.native: cannot load {out} ({exc})") \
                        from exc
            _declare(lib)
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the engine library builds and loads here (never raises)."""
    try:
        library()
    except Exception:
        return False
    return True


class ListEngine:
    """The sequence engine: the host half of the device List.

    Actors are dense int ids (callers intern, as everywhere else); for
    bit-identical identifier parity with the pure oracle the interned id
    order must agree with the actors' natural ordering (OrdDot markers
    compare by actor first). ``impl="python"`` runs the pure-Python engine
    (``_PyEngine``, driving the oracle types) instead of the native one.
    """

    def __init__(self, impl: str = "native"):
        if impl not in ("native", "python"):
            raise ValueError(f"impl must be 'native' or 'python', got {impl!r}")
        self._impl = _PyEngine() if impl == "python" else None
        self._lib = library() if impl == "native" else None
        self._e = ctypes.c_void_p(self._lib.ls_new()) if self._lib is not None else None

    def __del__(self):
        if getattr(self, "_e", None) is not None:
            self._lib.ls_free(self._e)
            self._e = None

    @property
    def is_native(self) -> bool:
        return self._e is not None

    # ---- local edit trace (mint + apply) ------------------------------
    def apply_trace(self, kinds: Sequence[int], indices: Sequence[int], values: Sequence[int],
                    actors: Sequence[int]) -> np.ndarray:
        """Apply a local edit trace (INSERT at index with value / DELETE
        at index), minting identifiers; returns each op's identifier
        handle (the stable device slot)."""
        kinds = np.ascontiguousarray(kinds, np.uint8)
        indices = np.ascontiguousarray(indices, np.int64)
        values = np.ascontiguousarray(values, np.int32)
        actors = np.ascontiguousarray(actors, np.int32)
        n = len(kinds)
        out = np.empty(n, np.int64)
        if self._impl is not None:
            self._impl.apply_trace(kinds, indices, values, actors, out)
            return out
        rc = self._lib.ls_apply_trace(self._e, kinds, indices, values, actors, n, out)
        if rc < 0:
            raise IndexError(f"trace op {-rc - 1}: index out of range")
        return out

    # ---- remote op delivery (CmRDT apply by identifier) ----------------
    def apply_remote(self, kinds, paths, values) -> np.ndarray:
        """Apply remote ops: each op is (kind, identifier path, value).
        Paths are sequences of (index, actor, counter) components.
        Duplicate inserts / absent deletes are idempotent no-ops."""
        n = len(kinds)
        counts = np.asarray([len(p) for p in paths], np.int64)
        flat = [c for p in paths for c in p]
        cidx = np.asarray([c[0] for c in flat], np.int64)
        cactor = np.asarray([c[1] for c in flat], np.int32)
        cctr = np.asarray([c[2] for c in flat], np.uint64)
        if (counts <= 0).any():
            bad = int(np.argmax(counts <= 0))
            raise ValueError(f"remote op {bad}: empty identifier path")
        kinds = np.ascontiguousarray(kinds, np.uint8)
        values = np.ascontiguousarray(values, np.int32)
        out = np.empty(n, np.int64)
        if self._impl is not None:
            self._impl.apply_remote(kinds, counts, cidx, cactor, cctr, values, out)
            return out
        rc = self._lib.ls_apply_remote(self._e, kinds, counts, cidx, cactor, cctr, values, n, out)
        if rc < 0:
            raise ValueError(f"remote op {-rc - 1}: malformed identifier path")
        return out

    # ---- reads ---------------------------------------------------------
    def __len__(self) -> int:
        if self._impl is not None:
            return len(self._impl)
        return int(self._lib.ls_len(self._e))

    def total_ids(self) -> int:
        if self._impl is not None:
            return self._impl.total_ids()
        return int(self._lib.ls_total_ids(self._e))

    def read(self) -> Tuple[np.ndarray, np.ndarray]:
        """(handles, value ids) of the live sequence, in order."""
        n = len(self)
        handles = np.empty(n, np.int64)
        vals = np.empty(n, np.int32)
        if self._impl is not None:
            self._impl.read(handles, vals)
        else:
            self._lib.ls_read(self._e, handles, vals)
        return handles, vals

    def total_order(self) -> np.ndarray:
        """rank[handle] over ALL allocated identifiers (live or dead) —
        the device order-maintenance permutation."""
        out = np.empty(self.total_ids(), np.int64)
        if self._impl is not None:
            self._impl.total_order(out)
        else:
            self._lib.ls_total_order(self._e, out)
        return out

    def identifier_path(self, handle: int):
        """The (index, actor, counter) components of a handle's path."""
        if self._impl is not None:
            return self._impl.identifier_path(handle)
        n = int(self._lib.ls_id_len(self._e, handle))
        if n < 0:
            raise IndexError(f"no identifier with handle {handle}")
        idx = np.empty(n, np.int64)
        act = np.empty(n, np.int32)
        ctr = np.empty(n, np.uint64)
        self._lib.ls_id_path(self._e, handle, idx, act, ctr)
        return [(int(i), int(a), int(c)) for i, a, c in zip(idx, act, ctr)]

    def clock_get(self, actor: int) -> int:
        if self._impl is not None:
            return self._impl.clock_get(actor)
        return int(self._lib.ls_clock_get(self._e, int(actor)))

    def clock_dump(self) -> Tuple[np.ndarray, np.ndarray]:
        """(actors, counters) of the mint clock — checkpoint payload
        (deletes consume counters no identifier path records)."""
        if self._impl is not None:
            return self._impl.clock_dump()
        n = int(self._lib.ls_clock_count(self._e))
        actors = np.empty(n, np.int32)
        ctrs = np.empty(n, np.uint64)
        self._lib.ls_clock_dump(self._e, actors, ctrs)
        return actors, ctrs

    def clock_seed(self, actor: int, ctr: int) -> None:
        """Raise an actor's mint clock to at least ``ctr`` (resume)."""
        if self._impl is not None:
            self._impl.clock_seed(actor, ctr)
        else:
            self._lib.ls_clock_seed(self._e, int(actor), int(ctr))


class _PyEngine:
    """The pure-Python engine with the same surface, driving the oracle
    types — correctness-equal, oracle-speed (``ListEngine(impl="python")``)."""

    def __init__(self):
        from ..pure.identifier import Identifier, between

        self._between = between
        self._Identifier = Identifier
        self.ids = []       # handle -> Identifier
        self.vals = []
        self.alive = []
        self.seq = []       # handles in order
        self.clock = {}

    def apply_trace(self, kinds, indices, values, actors, out):
        from ..dot import OrdDot

        for i in range(len(kinds)):
            p = int(indices[i])
            actor = int(actors[i])
            self.clock[actor] = self.clock.get(actor, 0) + 1
            if kinds[i] == INSERT:
                if p < 0 or p > len(self.seq):
                    raise IndexError(f"trace op {i}: index out of range")
                lo = self.ids[self.seq[p - 1]] if p > 0 else None
                hi = self.ids[self.seq[p]] if p < len(self.seq) else None
                ident = self._between(lo, hi, OrdDot(actor, self.clock[actor]))
                handle = len(self.ids)
                self.ids.append(ident)
                self.vals.append(int(values[i]))
                self.alive.append(True)
                self.seq.insert(p, handle)
                out[i] = handle
            else:
                if p < 0 or p >= len(self.seq):
                    raise IndexError(f"trace op {i}: index out of range")
                handle = self.seq.pop(p)
                self.alive[handle] = False
                out[i] = handle

    def apply_remote(self, kinds, counts, cidx, cactor, cctr, values, out):
        import bisect
        from ..dot import OrdDot

        off = 0
        for i in range(len(kinds)):
            comps = tuple(
                (int(cidx[off + c]), OrdDot(int(cactor[off + c]), int(cctr[off + c])))
                for c in range(int(counts[i]))
            )
            off += int(counts[i])
            ident = self._Identifier(comps)
            marker = comps[-1][1]
            self.clock[marker.actor] = max(
                self.clock.get(marker.actor, 0), marker.counter
            )
            keys = [self.ids[h] for h in self.seq]
            pos = bisect.bisect_left(keys, ident)
            present = pos < len(self.seq) and keys[pos] == ident
            if kinds[i] == INSERT:
                if not present:
                    handle = len(self.ids)
                    self.ids.append(ident)
                    self.vals.append(int(values[i]))
                    self.alive.append(True)
                    self.seq.insert(pos, handle)
                    out[i] = handle
                else:
                    out[i] = self.seq[pos]
            else:
                if present:
                    handle = self.seq.pop(pos)
                    self.alive[handle] = False
                    out[i] = handle
                else:
                    out[i] = -1

    def __len__(self):
        return len(self.seq)

    def total_ids(self):
        return len(self.ids)

    def read(self, handles, vals):
        for i, h in enumerate(self.seq):
            handles[i] = h
            vals[i] = self.vals[h]

    def total_order(self, out):
        order = sorted(range(len(self.ids)), key=lambda h: self.ids[h])
        for r, h in enumerate(order):
            out[h] = r

    def identifier_path(self, handle):
        return [(i, m.actor, m.counter) for i, m in self.ids[handle].path]

    def clock_get(self, actor):
        return self.clock.get(int(actor), 0)

    def clock_dump(self):
        actors = np.asarray(list(self.clock.keys()), np.int32)
        ctrs = np.asarray(list(self.clock.values()), np.uint64)
        return actors, ctrs

    def clock_seed(self, actor, ctr):
        actor, ctr = int(actor), int(ctr)
        if ctr > self.clock.get(actor, 0):
            self.clock[actor] = ctr


__all__ = ["DELETE", "INSERT", "ListEngine", "library", "native_available"]
