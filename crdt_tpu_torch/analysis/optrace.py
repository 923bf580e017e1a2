"""The op trace — the port's counterpart of a jaxpr.

The JAX package's program checks walk the jaxpr of each traced program.
An eager torch program has none, so :func:`record` runs a callable once
and returns its :class:`OpTrace`: the sequence of what it did, from
three layers.

- **aten ops** (``TorchDispatchMode``): each op's name, and each input's
  and output's dtype, shape and storage. Storages are keyed by weak
  reference (``StorageWeakRef``), never by address — the caching
  allocator hands a freed block's address to the next tensor. Each event
  keeps the port frame that issued it (``file:line``, the counterpart of
  ``report.slice_jaxpr``).
- **host reads** (``TorchFunctionMode``): ``item``, ``tolist``,
  ``numpy``, ``cpu``, ``to`` a CPU target from another device,
  ``__bool__``, ``__int__``, ``__float__``, ``__index__`` and
  ``__array__`` on a tensor, each its own event, its inner ops not
  recorded. A read is taken at the Python level because ``.cpu()`` on a
  CPU tensor dispatches nothing: the count is then the same on either
  device. The ops whose output shape depends on the data are reads too
  (``sync`` ops): ``nonzero``, ``unique*``, ``masked_select``,
  ``repeat_interleave`` without ``output_size``, indexing by a bool mask,
  and ``equal`` (a Python bool). A scalar a composite op takes inside C++
  (``_local_scalar_dense``) is not counted: which of them run depends on
  the device (``one_hot`` checks its range on the CPU only).
- **collectives and hand kernels** (``utils/ophooks.py``): each call of a
  collective of ``parallel/collectives.py`` is one event (its rank count,
  a shift's permutation, its output bytes); each call of a kernel wrapper
  (``fold_entries``, ``fold_cells``, ``wire_pack_many``,
  ``cohort_wire_encode``) is one event with its input and output bytes
  and none of its inner ops — on the CPU a wrapper runs its plain
  version, so a trace is the same program on the card and on the CPU.

With no recorder active the hooks cost one global read each; no launch
moves.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..utils import ophooks

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_SKIP_FILES = {os.path.abspath(__file__), os.path.abspath(ophooks.__file__)}


class TensorRef(NamedTuple):
    """One tensor an event touched: its storage's trace id (None for a
    tensor without one), dtype, shape and bytes (the view's)."""

    sid: Optional[int]
    dtype: torch.dtype
    shape: Tuple[int, ...]
    nbytes: int


@dataclass
class Event:
    """One step of the trace.

    ``kind`` is ``"op"`` (an aten op; ``info["sync"]`` when its output
    shape or value reaches the host), ``"read"`` (a host read),
    ``"collective"`` or ``"kernel"``. ``info`` holds the rest: an op's
    ``written`` storage ids, ``view``, ``scalars`` and ``stable``; a
    collective's ``primitive``, ``ranks``, ``perm``, ``axis`` and
    ``bytes``; a kernel's ``in_bytes`` and ``out_bytes``."""

    kind: str
    name: str
    ins: Tuple[TensorRef, ...]
    outs: Tuple[TensorRef, ...]
    where: str
    info: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OpTrace:
    """A callable's trace: its events in order, its argument leaves
    (``inputs``, flattening order), its result leaves (``outputs``) and
    the result itself."""

    events: List[Event]
    inputs: Tuple[TensorRef, ...]
    outputs: Tuple[TensorRef, ...]
    result: Any
    storage_bytes: Dict[int, int]

    @property
    def ops(self) -> int:
        """aten ops plus kernel events: the launch proxy."""
        return sum(e.kind in ("op", "kernel") for e in self.events)

    @property
    def host_syncs(self) -> int:
        """Host reads plus the ops whose output reaches the host."""
        return sum(e.kind == "read" or (e.kind == "op" and bool(e.info.get("sync")))
                   for e in self.events)


def tensor_leaves(tree) -> List[torch.Tensor]:
    """Every tensor in ``tree`` (tuples, NamedTuples, lists, dict values),
    in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensor_leaves(x)]
    return []


def _scalars(tree) -> list:
    if isinstance(tree, bool):
        return []
    if isinstance(tree, (int, float)):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [s for x in tree for s in _scalars(x)]
    return []


# Python-level host reads (TorchFunctionMode); ``to`` counts only with a
# CPU target from another device.
_READS = {
    torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu,
    torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__,
    torch.Tensor.__index__, torch.Tensor.__array__,
}
# aten ops whose result shape or value is read back by the host.
_SYNC_OPS = {
    "nonzero", "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "unique_dim_consecutive", "masked_select", "equal",
}


def _is_cpu_target(args, kwargs) -> bool:
    dev = kwargs.get("device")
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            dev = a
        elif isinstance(a, torch.Tensor):
            dev = a.device
    if dev is None:
        return False
    try:
        return torch.device(dev).type == "cpu"
    except (RuntimeError, TypeError):
        return False


class Recorder:
    """Takes one trace (:func:`record` drives it)."""

    def __init__(self):
        self.events: List[Event] = []
        self._refs: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.storage_bytes: Dict[int, int] = {}
        self._ids = itertools.count()
        self._quiet = 0
        self._prim = 0

    # ---- storages and frames ------------------------------------------
    def ref(self, t: torch.Tensor) -> TensorRef:
        sid = None
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            st = None
        if st is not None and t.device.type != "meta":
            key = st._cdata
            hit = self._refs.get(key)
            if hit is None or hit[0].expired():
                sid = next(self._ids)
                self._refs[key] = (StorageWeakRef(st), sid)
                self.storage_bytes[sid] = st.nbytes()
            else:
                sid = hit[1]
        return TensorRef(sid, t.dtype, tuple(t.shape), t.numel() * t.element_size())

    def refs(self, tree) -> Tuple[TensorRef, ...]:
        return tuple(self.ref(t) for t in tensor_leaves(tree))

    @staticmethod
    def where() -> str:
        f = sys._getframe(2)
        while f is not None:
            path = os.path.abspath(f.f_code.co_filename)
            if path.startswith(_PKG_ROOT) and path not in _SKIP_FILES:
                return f"{os.path.relpath(path, _REPO_ROOT)}:{f.f_lineno}"
            f = f.f_back
        return "<outside the port>"

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # ---- the three layers ---------------------------------------------
    def op_event(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        schema = func._schema
        written = []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written += [self.ref(t).sid for t in tensor_leaves(v)]
        info: Dict[str, Any] = {"written": tuple(written), "view": bool(func.is_view),
                                "scalars": tuple(_scalars(list(args) + list(kwargs.values())))}
        sync = name in _SYNC_OPS
        if name == "repeat_interleave" and kwargs.get("output_size") is None and (
                len(args) < 4 or args[3] is None):
            sync = True
        if name in ("index", "index_put", "index_put_") and len(args) > 1:
            sync = any(t is not None and isinstance(t, torch.Tensor)
                       and t.dtype in (torch.bool, torch.uint8) for t in args[1])
        if sync:
            info["sync"] = True
        if name == "sort":
            info["stable"] = bool(kwargs.get("stable") or False)
        self.events.append(Event("op", f"aten.{name}", self.refs((args, kwargs)),
                                 self.refs(out), self.where(), info))

    def read_event(self, func, args, kwargs):
        with self.quiet():
            out = func(*args, **kwargs)
        self.events.append(Event("read", func.__name__, self.refs(args[:1]), (), self.where()))
        return out

    def kernel_event(self, name, fn, args, kwargs):
        if self._quiet:
            return fn(*args, **kwargs)
        ins = self.refs((args, kwargs))
        where = self.where()
        with self.quiet():
            out = fn(*args, **kwargs)
        outs = self.refs(out)
        self.events.append(Event("kernel", name, ins, outs, where, {
            "in_bytes": sum(r.nbytes for r in ins), "out_bytes": sum(r.nbytes for r in outs)}))
        return out

    def collective_event(self, name, fn, args, kwargs, primitive, ranks, perm):
        if self._quiet or (primitive and self._prim):
            return fn(*args, **kwargs)
        ins = self.refs((args, kwargs))
        where = self.where()
        if ranks is None:
            lead = next((t for t in tensor_leaves(args) if t.dim() > 0), None)
            ranks = None if lead is None else int(lead.shape[0])
        self._prim += primitive
        try:
            out = fn(*args, **kwargs)
        finally:
            self._prim -= primitive
        outs = self.refs(out)
        self.events.append(Event("collective", name, ins, outs, where, {
            "primitive": primitive, "ranks": ranks, "perm": perm, "axis": "replica",
            "bytes": sum(r.nbytes for r in outs) if primitive else 0}))
        return out


class _Dispatch(TorchDispatchMode):
    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.rec._quiet:
            self.rec.op_event(func, args, kwargs, out)
        return out


class _Reads(TorchFunctionMode):
    def __init__(self, rec: Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        if rec._quiet or not args or not isinstance(args[0], torch.Tensor):
            return func(*args, **kwargs)
        if func in _READS or (func is torch.Tensor.to and args[0].device.type != "cpu"
                              and _is_cpu_target(args, kwargs)):
            return rec.read_event(func, args, kwargs)
        return func(*args, **kwargs)


def record(fn, *args, **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and return its trace."""
    rec = Recorder()
    inputs = rec.refs((args, kwargs))
    prev = ophooks.activate(rec)
    try:
        with _Reads(rec), _Dispatch(rec):
            result = fn(*args, **kwargs)
    finally:
        ophooks.activate(prev)
    return OpTrace(rec.events, inputs, rec.refs(result), result, rec.storage_bytes)


__all__ = ["Event", "OpTrace", "Recorder", "TensorRef", "record", "tensor_leaves"]
