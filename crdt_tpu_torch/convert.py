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
- δ tracking (``tracking_from_numpy``): ``dirty`` bool, ``fctx`` u32 or
  u64.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ._dtypes import bits
from .ops.map import MapState
from .ops.mvreg import MVRegState
from .ops.orswot import OrswotState
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
_CHILD_DTYPES = {
    "wact": np.int32, "wctr": np.uint32, "clk": np.uint32, "val": np.int32, "valid": np.bool_,
}


def _leaves_from_numpy(kind: str, arrays, dtypes: dict, device) -> dict:
    """Each named leaf of ``arrays`` as a tensor on ``device``. Raises on a
    missing leaf or a dtype other than the leaf's (no silent casts)."""
    leaves = {}
    for name, dtype in dtypes.items():
        x = np.asarray(arrays[name])
        if x.dtype != dtype:
            raise TypeError(f"{kind} leaf {name!r} must be {np.dtype(dtype)}, got {x.dtype}")
        if dtype is np.uint32:
            leaves[name] = torch.tensor(x.view(np.int32), device=device).view(torch.uint32)
        else:
            leaves[name] = torch.tensor(x, device=device)
    return leaves


def _leaves_to_numpy(state, dtypes: dict) -> dict:
    out = {}
    for name, dtype in dtypes.items():
        x = bits(getattr(state, name)).cpu().numpy().copy()
        out[name] = x.view(np.uint32) if dtype is np.uint32 else x
    return out


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


def tracking_from_numpy(dirty: np.ndarray, fctx: np.ndarray, device="cuda"):
    """The δ tracking pair of the JAX package (``dirty [R, E]`` bool,
    ``fctx [R, E, A]`` u32 or u64, e.g. from its
    ``parallel.delta.interval_accumulate``) → ``(dirty, fctx)`` tensors on
    ``device``. Raises on any other dtype (no silent casts)."""
    dirty, fctx = np.asarray(dirty), np.asarray(fctx)
    if dirty.dtype != np.bool_:
        raise TypeError(f"tracking leaf 'dirty' must be bool, got {dirty.dtype}")
    if fctx.dtype == np.uint32:
        f = torch.tensor(fctx.view(np.int32), device=device).view(torch.uint32)
    elif fctx.dtype == np.uint64:
        f = torch.tensor(fctx.view(np.int64), device=device).view(torch.uint64)
    else:
        raise TypeError(f"tracking leaf 'fctx' must be uint32 or uint64, got {fctx.dtype}")
    return torch.tensor(dirty, device=device), f
