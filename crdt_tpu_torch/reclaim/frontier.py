"""The mesh-wide stable frontier — counterpart of the JAX package's
``reclaim/frontier.py``.

A dot ``(actor, c)`` is causally stable once every replica's top clock
covers it: no replica can treat it as unseen any more, so metadata whose
only job is to decide seen-or-unseen for dots at or below it can go
(Almeida et al., "Delta State Replicated Data Types"; Enes et al.,
"Efficient Synchronization of State-based CRDTs"). The frontier is the
per-actor minimum over all replicas' tops:

    frontier[a] = min over replicas r of top_r[a]

The min is monotone in each input, so a straggler or a partitioned
replica pins the frontier at its stale top: compaction reclaims less,
but never claims stability for a dot some replica has not seen. And
``frontier <= top_r`` for every participant, which keeps frontier-gated
compaction read-invariant (``compaction.py``).

Three ways to compute it:

- :func:`stable_frontier` — over a batched state's leading replica axes,
  on the state's device;
- ``stability=True`` on the ring entries (``parallel/anti_entropy.py``):
  one ``amin`` over every rank's PRE-fold input tops (the JAX
  ``jnp.min`` then ``lax.pmin``), returned as the last output;
- :func:`host_frontier` — numpy over an explicit collection of tops, for
  the oracle paths; :func:`model_frontier` over one model's own rows;
  :func:`mesh_frontier` over every process's rows of one model (one
  gather of the tops, then :func:`host_frontier`).

Clock planes are unsigned; the comparisons run on the ``_dtypes`` wide
view, never on a ``uint32`` tensor.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from .._dtypes import from_raw, from_wide, raw, to_wide


def top_of(state):
    """The replica's top clock ``[..., A]`` of any state tree: the
    outermost ``top`` field, found by walking wrapper levels inward (a
    nest's levels share the innermost slab's top; the core rides first).
    None for kinds without a clock (a G-Set, an LWW register)."""
    seen = set()
    node = state
    while hasattr(node, "_fields") and id(node) not in seen:
        seen.add(id(node))
        if "top" in node._fields:
            return node.top
        node = node[0]
    return None


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    from ..convert import leaf_from_numpy

    return leaf_from_numpy(np.asarray(x), "cpu")


def stable_frontier(state_or_top, n_lead: Optional[int] = None):
    """Per-actor min over a batched state's replica axes: a state tree
    (top found by :func:`top_of`) or a top ``[R, ..., A]`` directly.
    ``n_lead`` pins how many leading axes are replica axes (default: all
    but the last). Returns ``[A]``, or None for a clockless kind."""
    top = state_or_top if hasattr(state_or_top, "ndim") else top_of(state_or_top)
    if top is None:
        return None
    top = _as_tensor(top)
    lead = top.dim() - 1 if n_lead is None else n_lead
    if not lead:
        return top
    return from_wide(to_wide(top).amin(dim=tuple(range(lead))), top.dtype)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        from ..convert import leaf_to_numpy

        return leaf_to_numpy(t)
    return np.asarray(t)


def host_frontier(tops: Iterable) -> Optional[np.ndarray]:
    """The frontier over an explicit collection of top clocks (one per
    replica, each ``[A]`` or a batch ``[R, A]``), in numpy. A missing or
    stale participant's old top pins the result. Ragged actor widths are
    right-padded with 0 (an actor a participant never saw has min 0)."""
    mats = [np.atleast_2d(_host(t)) for t in tops]
    if not mats:
        return None
    width = max(m.shape[-1] for m in mats)
    padded = [
        np.pad(m.reshape(-1, m.shape[-1]), ((0, 0), (0, width - m.shape[-1])))
        for m in mats
    ]
    return np.concatenate(padded, axis=0).min(axis=0)


def model_frontier(model) -> Optional[np.ndarray]:
    """The frontier of one batched model's OWN replica rows (numpy ``[A]``)
    — sound when the model's batch is the whole replica set, as for
    compact-on-save and :func:`..reclaim.compact_model`. For a model that
    is one shard of a larger mesh, use :func:`host_frontier` over every
    shard's tops."""
    top = top_of(model.state)
    if top is None:
        return None
    return _host(top).reshape(-1, top.shape[-1]).min(axis=0)


def mesh_frontier(model, procs=None) -> Optional[np.ndarray]:
    """The frontier of a model whose rows are spread over the processes
    of ``procs`` (a ``multihost.GlobalMesh``; this process's ``model``
    holds its rows): :func:`host_frontier` over every process's tops,
    gathered once (``multihost._allgather_host``) — this process's rows
    alone would claim stability for a dot another process's straggler
    has not seen. Without processes to cross, :func:`model_frontier`."""
    if procs is None or procs.process_count == 1:
        return model_frontier(model)
    from ..parallel.multihost import _allgather_host

    top = top_of(model.state)
    if top is None:
        return None
    return host_frontier(_allgather_host(_host(top).reshape(-1, top.shape[-1])))


def frontier_lag(top, frontier) -> torch.Tensor:
    """How far knowledge has run ahead of stability: the max over replicas
    and actor lanes of ``top - frontier`` (0 = a fully stable mesh), as a
    0-d ``uint32`` tensor on ``top``'s device. The frontier is cast to the
    top's lane dtype first (wrapping, as ``astype`` does); lanes behind
    the frontier clamp to 0; the result is cast to ``uint32``, which
    keeps the low 32 bits of a ``uint64`` lag."""
    t = _as_tensor(top)
    f = _as_tensor(frontier).to(t.device)
    if f.dtype != t.dtype:
        f = from_raw(raw(f), t.dtype) if t.dtype in (torch.uint32, torch.uint64) else f.to(t.dtype)
    tw, fw = to_wide(t), to_wide(f)
    return from_raw(torch.maximum(tw, fw).sub(fw).max(), torch.uint32)


# Kinds whose frontier-stall warning already fired this process; repeats
# only count in the registry (the residue warning's dedupe).
_STALL_WARNED: set = set()


def reset_stall_warnings() -> None:
    """Re-arm the once-per-kind frontier-stall warning."""
    _STALL_WARNED.clear()


def watch_lag(kind: str, lag: int, lag_threshold) -> None:
    """The stall alert over ``frontier_lag``, called on the host by the
    ring entries when ``lag_threshold=`` is set (it needs
    ``stability=``): a lag at or past the threshold counts
    ``reclaim.frontier_stalled`` every time and warns once per kind per
    process. A sustained stall means some replica is pinning the
    frontier."""
    from ..utils.metrics import metrics

    if lag_threshold is None or lag < lag_threshold:
        return
    metrics.count("reclaim.frontier_stalled")
    if kind in _STALL_WARNED:
        return
    _STALL_WARNED.add(kind)
    import warnings

    warnings.warn(
        f"{kind}: frontier_lag={lag} >= lag_threshold={lag_threshold} — "
        f"a straggler is pinning the stable frontier and reclamation is "
        f"stalled; investigate or evict the rank (faults.Membership). "
        f"Warned once per kind; repeats count in reclaim.frontier_stalled",
        stacklevel=3,
    )


__all__ = [
    "frontier_lag", "host_frontier", "mesh_frontier", "model_frontier",
    "reset_stall_warnings", "stable_frontier", "top_of", "watch_lag",
]
