"""Carry dense states across packages as numpy arrays.

A state of the JAX package goes through ``np.asarray`` leaf by leaf into
a dict; the ``*_from_numpy`` functions turn that dict into the port's
state on a device, and the ``*_to_numpy`` functions turn a port state
back into such a dict. The leaves map exactly, dtypes included, and
both directions copy:

- ``OrswotState``: ``top``/``ctr``/``dcl`` u32, ``dmask``/``dvalid`` bool;
- ``MapState``: ``top``/``dcl`` u32, ``dkeys``/``dvalid`` bool, and
  ``child``, a dict of the ``MVRegState`` leaves ``wact`` i32, ``wctr``
  u32, ``clk`` u32, ``val`` i32, ``valid`` bool;
- ``SparseOrswotState``: ``top``/``ctr``/``dcl`` u32, ``eid``/``act``/
  ``didx`` i32, ``valid``/``dvalid`` bool;
- ``SparseMVMapState``: ``top``/``ctr``/``clk``/``dcl`` u32, ``kid``/
  ``act``/``val``/``kidx`` i32, ``valid``/``dvalid`` bool;
- ``SparseNestState`` (any depth): ``core``, a dict of the level inside
  (itself nested, or the leaf's — an ORSWOT segment table has ``eid``, a
  register-map cell table ``kid``), and ``kcl`` u32, ``kidx`` i32,
  ``kdvalid`` bool;
- the dense nests (``nest_from_numpy``: ``MapOrswotState``, ``Map3State``,
  ``NestedMapState``, ``ops.nest.NestedState`` at any depth): a dict
  with the core's dict under its field name (``core``, ``mo`` or ``m``)
  and the level's buffer — ``*dcl`` u32, ``*dkeys`` bool, ``*dvalid``
  bool — under the level's field names; the leaf dict is an
  ``OrswotState``'s or a ``MapState``'s above;
- δ tracking (``tracking_from_numpy``): ``dirty`` bool, ``fctx`` u32 or
  u64;
- a serving superblock (``superblock_from_numpy``): the ``orswot`` or
  ``sparse_orswot`` leaves above with the lane axis leading;
- an ``OpSlab`` (``opslab_from_numpy``): ``kind`` u8, ``actor`` i32,
  ``ctr``/``clock`` u32, ``member`` bool (dense masks) or i32 (sparse id
  lists);
- a clock batch (``clocks_from_numpy``): ``counters`` u32 or u64 (the
  configured lane width, kept as given);
- ``LWWState`` (``lww_from_numpy``): ``hi``/``lo`` u32, ``val`` i32,
  ``has`` bool;
- G-Set membership (``gset_from_numpy``): ``present`` bool;
- ``MVRegState`` (``mvreg_from_numpy``): the ``child`` leaves above;
- a ``BatchedList``'s replicas (``list_from_numpy``): ``vals`` i32,
  ``alive`` bool, and the host ``slots`` i64 (the rank of each
  identifier handle), which stays numpy;
- a fan-out ``CohortWire`` (``cohort_wire_from_numpy``): ``words``/``raw``
  /``nnz``/``chk`` u32, ``keep``/``defer``/``valid`` bool, ``residual``
  the tuple of the kind's residual planes with bool planes bit-packed
  (u32), so either package's client decodes the other's payload.

:func:`leaf_to_numpy` / :func:`leaf_from_numpy` carry one leaf of any
dtype (the durability files' leaves: u32 stays ``<u4``, u64 ``<u8``, bool
``|b1``), through a signed view for the unsigned lanes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.lwwreg import LWWState
from .ops.map import MapState
from .ops.mvreg import MVRegState
from .ops.orswot import OrswotState
from .ops.sparse_mvmap import SparseMVMapState
from .ops.sparse_nest import SparseNestState
from .ops.sparse_orswot import SparseOrswotState

_DTYPES = {
    "top": np.uint32, "ctr": np.uint32, "dcl": np.uint32,
    "dmask": np.bool_, "dvalid": np.bool_,
}
_MAP_DTYPES = {"top": np.uint32, "dcl": np.uint32, "dkeys": np.bool_, "dvalid": np.bool_}
_SPARSE_DTYPES = {
    "top": np.uint32, "eid": np.int32, "act": np.int32, "ctr": np.uint32, "valid": np.bool_,
    "dcl": np.uint32, "didx": np.int32, "dvalid": np.bool_,
}
_SPARSE_MVMAP_DTYPES = {
    "top": np.uint32, "kid": np.int32, "act": np.int32, "ctr": np.uint32, "val": np.int32,
    "clk": np.uint32, "valid": np.bool_, "dcl": np.uint32, "kidx": np.int32, "dvalid": np.bool_,
}
_NEST_DTYPES = {"kcl": np.uint32, "kidx": np.int32, "kdvalid": np.bool_}
_CHILD_DTYPES = {
    "wact": np.int32, "wctr": np.uint32, "clk": np.uint32, "val": np.int32, "valid": np.bool_,
}
_LWW_DTYPES = {"hi": np.uint32, "lo": np.uint32, "val": np.int32, "has": np.bool_}
_LIST_DTYPES = {"vals": np.int32, "alive": np.bool_}


_UNSIGNED = {torch.uint32: (torch.int32, np.uint32), torch.uint64: (torch.int64, np.uint64)}
_SIGNED_VIEW = {np.dtype(np.uint32): (np.int32, torch.uint32),
                np.dtype(np.uint64): (np.int64, torch.uint64)}


def leaf_to_numpy(x: torch.Tensor) -> np.ndarray:
    """One tensor → a host numpy copy with the same dtype and bytes."""
    if x.dtype in _UNSIGNED:
        signed, unsigned = _UNSIGNED[x.dtype]
        return x.view(signed).cpu().numpy().copy().view(unsigned)
    return x.cpu().numpy().copy()


def leaf_from_numpy(x: np.ndarray, device="cuda") -> torch.Tensor:
    """One numpy array → a tensor on ``device`` with the same dtype and
    bytes (inverse of :func:`leaf_to_numpy`); a 0-d array stays 0-d."""
    x = np.asarray(x, order="C")
    if x.dtype in _SIGNED_VIEW:
        signed, unsigned = _SIGNED_VIEW[x.dtype]
        return torch.tensor(x.view(signed), device=device).view(unsigned)
    return torch.tensor(x, device=device)


def _leaves_from_numpy(kind: str, arrays, dtypes: dict, device) -> dict:
    """Each named leaf of ``arrays`` as a tensor on ``device``. Raises on a
    missing leaf or a dtype other than the leaf's (no silent casts)."""
    leaves = {}
    for name, dtype in dtypes.items():
        x = np.asarray(arrays[name])
        if x.dtype != dtype:
            raise TypeError(f"{kind} leaf {name!r} must be {np.dtype(dtype)}, got {x.dtype}")
        leaves[name] = leaf_from_numpy(x, device)
    return leaves


def _leaves_to_numpy(state, dtypes: dict) -> dict:
    return {name: leaf_to_numpy(getattr(state, name)) for name in dtypes}


def orswot_from_numpy(arrays: Dict[str, np.ndarray], device="cuda") -> OrswotState:
    """``{"top", "ctr", "dcl", "dmask", "dvalid"}`` numpy arrays → an
    ``OrswotState`` on ``device``. Raises on a missing leaf or a dtype
    other than the leaf's (no silent casts)."""
    return OrswotState(**_leaves_from_numpy("orswot", arrays, _DTYPES, device))


def orswot_to_numpy(state: OrswotState) -> Dict[str, np.ndarray]:
    """A port ``OrswotState`` → a dict of numpy arrays (u32 / bool)."""
    return _leaves_to_numpy(state, _DTYPES)


def sparse_orswot_from_numpy(arrays: Dict[str, np.ndarray], device="cuda") -> SparseOrswotState:
    """``{"top", "eid", "act", "ctr", "valid", "dcl", "didx", "dvalid"}``
    numpy arrays → a ``SparseOrswotState`` on ``device``. Raises on a
    missing leaf or a dtype other than the leaf's (no silent casts)."""
    return SparseOrswotState(**_leaves_from_numpy("sparse orswot", arrays, _SPARSE_DTYPES,
                                                  device))


def sparse_orswot_to_numpy(state: SparseOrswotState) -> Dict[str, np.ndarray]:
    """A port ``SparseOrswotState`` → a dict of numpy arrays (u32 / i32 /
    bool)."""
    return _leaves_to_numpy(state, _SPARSE_DTYPES)


def sparse_mvmap_from_numpy(arrays: Dict[str, np.ndarray], device="cuda") -> SparseMVMapState:
    """``{"top", "kid", "act", "ctr", "val", "clk", "valid", "dcl", "kidx",
    "dvalid"}`` numpy arrays → a ``SparseMVMapState`` on ``device``.
    Raises on a missing leaf or a dtype other than the leaf's."""
    return SparseMVMapState(**_leaves_from_numpy("sparse mvmap", arrays, _SPARSE_MVMAP_DTYPES,
                                                 device))


def sparse_mvmap_to_numpy(state: SparseMVMapState) -> Dict[str, np.ndarray]:
    """A port ``SparseMVMapState`` → a dict of numpy arrays."""
    return _leaves_to_numpy(state, _SPARSE_MVMAP_DTYPES)


def sparse_nest_from_numpy(arrays: dict, device="cuda") -> SparseNestState:
    """``{"core": {...}, "kcl", "kidx", "kdvalid"}`` numpy arrays → a
    ``SparseNestState`` on ``device``, at any depth: ``core`` is the next
    level's dict (it has a ``core`` of its own) or the leaf's (``eid``:
    the ORSWOT segment table; ``kid``: the register-map cell table).
    Raises on a missing leaf or a dtype other than the leaf's."""
    core = arrays["core"]
    if "core" in core:
        inner = sparse_nest_from_numpy(core, device)
    elif "eid" in core:
        inner = sparse_orswot_from_numpy(core, device)
    else:
        inner = sparse_mvmap_from_numpy(core, device)
    return SparseNestState(core=inner, **_leaves_from_numpy("sparse nest", arrays, _NEST_DTYPES,
                                                             device))


def sparse_nest_to_numpy(state: SparseNestState) -> dict:
    """A port ``SparseNestState`` (any depth) → the nested dict of numpy
    arrays :func:`sparse_nest_from_numpy` takes."""
    core = state.core
    if isinstance(core, SparseNestState):
        inner = sparse_nest_to_numpy(core)
    elif isinstance(core, SparseOrswotState):
        inner = sparse_orswot_to_numpy(core)
    else:
        inner = sparse_mvmap_to_numpy(core)
    return {"core": inner, **_leaves_to_numpy(state, _NEST_DTYPES)}


def map_from_numpy(arrays: dict, device="cuda") -> MapState:
    """``{"top", "child": {"wact", "wctr", "clk", "val", "valid"}, "dcl",
    "dkeys", "dvalid"}`` numpy arrays → a ``MapState`` on ``device``.
    Raises on a missing leaf or a dtype other than the leaf's."""
    child = MVRegState(**_leaves_from_numpy("map child", arrays["child"], _CHILD_DTYPES, device))
    return MapState(child=child, **_leaves_from_numpy("map", arrays, _MAP_DTYPES, device))


def map_to_numpy(state: MapState) -> dict:
    """A port ``MapState`` → a dict of numpy arrays, ``child`` nested."""
    out = _leaves_to_numpy(state, _MAP_DTYPES)
    out["child"] = _leaves_to_numpy(state.child, _CHILD_DTYPES)
    return out


def clocks_from_numpy(counters: np.ndarray, device="cuda") -> torch.Tensor:
    """A clock batch ``[..., A]`` (u32 or u64) → a tensor on ``device``;
    any other dtype raises (no silent casts)."""
    counters = np.asarray(counters)
    if counters.dtype not in (np.uint32, np.uint64):
        raise TypeError(f"clock lanes must be uint32 or uint64, got {counters.dtype}")
    return leaf_from_numpy(counters, device)


def clocks_to_numpy(clocks: torch.Tensor) -> np.ndarray:
    return leaf_to_numpy(clocks)


def lww_from_numpy(arrays: Dict[str, np.ndarray], device="cuda") -> LWWState:
    """``{"hi", "lo", "val", "has"}`` numpy arrays → an ``LWWState`` on
    ``device``. Raises on a missing leaf or a dtype other than the
    leaf's."""
    return LWWState(**_leaves_from_numpy("lwwreg", arrays, _LWW_DTYPES, device))


def lww_to_numpy(state: LWWState) -> Dict[str, np.ndarray]:
    return _leaves_to_numpy(state, _LWW_DTYPES)


def gset_from_numpy(present: np.ndarray, device="cuda") -> torch.Tensor:
    """G-Set membership ``present[..., E]`` (bool) → a tensor on
    ``device``."""
    return _leaves_from_numpy("gset", {"present": present}, {"present": np.bool_},
                              device)["present"]


def gset_to_numpy(present: torch.Tensor) -> np.ndarray:
    return leaf_to_numpy(present)


def mvreg_from_numpy(arrays: Dict[str, np.ndarray], device="cuda") -> MVRegState:
    """``{"wact", "wctr", "clk", "val", "valid"}`` numpy arrays → an
    ``MVRegState`` on ``device``. Raises on a missing leaf or a dtype
    other than the leaf's."""
    return MVRegState(**_leaves_from_numpy("mvreg", arrays, _CHILD_DTYPES, device))


def mvreg_to_numpy(state: MVRegState) -> Dict[str, np.ndarray]:
    return _leaves_to_numpy(state, _CHILD_DTYPES)


def list_from_numpy(arrays: Dict[str, np.ndarray], device="cuda") -> dict:
    """``{"vals", "alive", "slots"}`` numpy arrays (a ``BatchedList``'s
    replicas and its identifiers' ranks) → ``vals``/``alive`` tensors on
    ``device`` and ``slots`` as an int64 numpy copy."""
    out = _leaves_from_numpy("list", arrays, _LIST_DTYPES, device)
    slots = np.asarray(arrays["slots"])
    if slots.dtype != np.int64:
        raise TypeError(f"list leaf 'slots' must be int64, got {slots.dtype}")
    out["slots"] = slots.copy()
    return out


def list_to_numpy(model) -> Dict[str, np.ndarray]:
    """A ``BatchedList``'s ``vals``/``alive`` (host copies) and ``slots``."""
    return {"vals": leaf_to_numpy(model.vals), "alive": leaf_to_numpy(model.alive),
            "slots": np.array(model.slots, dtype=np.int64)}


def _nest_classes() -> dict:
    """Each dense nest class by its field names."""
    from .ops.map3 import Map3State
    from .ops.map_map import NestedMapState
    from .ops.map_orswot import MapOrswotState
    from .ops.nest import NestedState

    return {cls._fields: cls for cls in (MapOrswotState, Map3State, NestedMapState, NestedState)}


def nest_from_numpy(arrays: dict, device="cuda"):
    """A dense nest's numpy dict (module docstring) → the port's state on
    ``device``: the class whose field names the dict's keys are
    (``MapOrswotState``, ``Map3State``, ``NestedMapState`` or the generic
    ``NestedState``), its core decoded the same way down to the leaf (an
    ``OrswotState`` dict has ``ctr``, a ``MapState`` dict ``child``).
    Raises on a missing leaf or a dtype other than the leaf's."""
    if "ctr" in arrays:
        return orswot_from_numpy(arrays, device)
    if "child" in arrays:
        return map_from_numpy(arrays, device)
    for fields, cls in _nest_classes().items():
        if set(fields) == set(arrays):
            core, dcl, dkeys, dvalid = fields
            bufs = _leaves_from_numpy(cls.__name__, arrays,
                                      {dcl: np.uint32, dkeys: np.bool_, dvalid: np.bool_}, device)
            return cls(nest_from_numpy(arrays[core], device), bufs[dcl], bufs[dkeys], bufs[dvalid])
    raise ValueError(f"no dense nest has the fields {sorted(arrays)}")


def nest_to_numpy(state) -> dict:
    """A port dense nest (any depth) → the dict :func:`nest_from_numpy`
    takes."""
    if isinstance(state, OrswotState):
        return orswot_to_numpy(state)
    if isinstance(state, MapState):
        return map_to_numpy(state)
    core, *bufs = state._fields
    return {core: nest_to_numpy(state[0]),
            **{name: leaf_to_numpy(getattr(state, name)) for name in bufs}}


_SLAB_DTYPES = {"kind": np.uint8, "actor": np.int32, "ctr": np.uint32, "clock": np.uint32}


def superblock_from_numpy(kind: str, arrays, device="cuda"):
    """A superblock of serving ``kind`` (``"orswot"`` or
    ``"sparse_orswot"``) from the JAX package's numpy leaves, lane axis
    leading, onto ``device``."""
    if kind == "orswot":
        return orswot_from_numpy(arrays, device)
    if kind == "sparse_orswot":
        return sparse_orswot_from_numpy(arrays, device)
    raise KeyError(f"no superblock kind {kind!r}")


def superblock_to_numpy(state) -> Dict[str, np.ndarray]:
    """A port superblock (either kind) → a dict of numpy arrays."""
    dtypes = _SPARSE_DTYPES if isinstance(state, SparseOrswotState) else _DTYPES
    return _leaves_to_numpy(state, dtypes)


def opslab_from_numpy(arrays, device="cuda"):
    """``{"kind", "actor", "ctr", "clock", "member"}`` numpy arrays (the JAX
    ``OpSlab``'s leaves) → the port's ``OpSlab`` on ``device``. Raises on
    a dtype other than the leaf's; ``member`` is bool or int32."""
    from .ops.superblock import OpSlab

    leaves = _leaves_from_numpy("op slab", arrays, _SLAB_DTYPES, device)
    member = np.asarray(arrays["member"])
    if member.dtype not in (np.bool_, np.int32):
        raise TypeError(f"op slab leaf 'member' must be bool or int32, got {member.dtype}")
    return OpSlab(member=leaf_from_numpy(member, device), **leaves)


def opslab_to_numpy(slab) -> Dict[str, np.ndarray]:
    """A port ``OpSlab`` → a dict of numpy arrays."""
    return {name: leaf_to_numpy(getattr(slab, name)) for name in (*_SLAB_DTYPES, "member")}


def tracking_from_numpy(dirty: np.ndarray, fctx: np.ndarray, device="cuda"):
    """The δ tracking pair of the JAX package (``dirty [R, E]`` bool,
    ``fctx [R, E, A]`` u32 or u64, e.g. from its
    ``parallel.delta.interval_accumulate``) → ``(dirty, fctx)`` tensors on
    ``device``. Raises on any other dtype (no silent casts)."""
    dirty, fctx = np.asarray(dirty), np.asarray(fctx)
    if dirty.dtype != np.bool_:
        raise TypeError(f"tracking leaf 'dirty' must be bool, got {dirty.dtype}")
    if fctx.dtype not in (np.uint32, np.uint64):
        raise TypeError(f"tracking leaf 'fctx' must be uint32 or uint64, got {fctx.dtype}")
    return leaf_from_numpy(dirty, device), leaf_from_numpy(fctx, device)


def cohort_wire_to_numpy(wire):
    """A fan-out ``CohortWire`` with tensor (or numpy) leaves → the same
    ``CohortWire`` with numpy leaves, one read-back per leaf; the JAX
    package's ``CohortWire(*...)`` takes its fields in this order."""
    from .ops.lattice import tree_map

    return tree_map(lambda x: leaf_to_numpy(x) if isinstance(x, torch.Tensor)
                    else np.asarray(x), wire)


def cohort_wire_from_numpy(wire, device="cuda"):
    """A fan-out wire — the port's or the JAX package's ``CohortWire``,
    leaves numpy, tensors or anything ``np.asarray`` takes — as the
    port's ``CohortWire`` of tensors on ``device`` (tensors already there
    are used as they are)."""
    from .ops.fanout_kernels import CohortWire
    from .ops.lattice import tree_map

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return leaf_from_numpy(np.asarray(x), device)

    return CohortWire(*(tree_map(leaf, f) for f in wire))
