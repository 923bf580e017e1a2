"""The gate geometry of the program checks — the port of the JAX
package's ``analysis/gate_states.py``.

Every registered mesh entry (``registry.ENTRY_POINTS``) runs on an
R == P batch of join identities in ONE agreed geometry: aliasing, op
counts and bytes are properties of shapes, not content. The ``mk_*`` functions take
``p`` (the replica rows, one a rank) and ``device``; the states they mint
live there. The element-sharded entries split these batches over the
mesh's ``s`` shards (``parallel.sparse_shard``).
"""

from __future__ import annotations

import torch

from .._dtypes import zeros

# Gate geometry: element/actor/deferred widths and the nested key split.
GE, GA, GD = 8, 4, 4
GK1, GK2, GM = 4, 2, 2
# The gate mesh: P ranks, S element shards (the committed budget table's).
GP, GS = 4, 2


def replicas(mesh) -> int:
    """R == P: one replica row per virtual rank."""
    return mesh.p


def mk_dense(p, device):
    from ..ops import orswot

    return orswot.empty(GE, GA, GD, batch=(p,), device=device)


def mk_map(p, device):
    from ..ops import map as map_ops

    return map_ops.empty(GE, GA, 2, GD, batch=(p,), device=device)


def mk_map_orswot(p, device):
    from ..ops import map_orswot

    return map_orswot.empty(GK1, GM, GA, GD, batch=(p,), device=device)


def mk_nested_map(p, device):
    from ..ops import map_map

    return map_map.empty(GK1, GK2, GA, 2, GD, batch=(p,), device=device)


def mk_map3(p, device):
    from ..ops import map3

    return map3.empty(GK1, GK2, GM, GA, GD, batch=(p,), device=device)


def mk_sparse(p, device):
    from ..ops import sparse_orswot as sp

    return sp.empty(GE, GA, GD, 8, batch=(p,), device=device)


def mk_sparse_mvmap(p, device):
    from ..ops import sparse_mvmap as smv

    return smv.empty(GE, GA, GD, 8, batch=(p,), device=device)


def mk_sparse_nested(p, device):
    from ..ops import sparse_nest as snest

    return snest.empty_map_orswot(GM, GE, GA, GD, 8, GD, 8, batch=(p,), device=device)


def sparse_nested_level():
    from ..ops import sparse_nest as snest

    return snest.level_map_orswot(GM)


def mk_gset(p, device):
    return torch.zeros((p, GE), dtype=torch.bool, device=device)


def mk_lww(p, device):
    from ..ops import lwwreg

    return lwwreg.empty(batch=(p,), device=device)


def mk_mvreg(p, device):
    from ..ops import mvreg

    return mvreg.empty(GD, GA, batch=(p,), device=device)


def mk_clocks(p, device):
    return zeros((p, GA), torch.uint32, device)


# The serving and fan-out dispatches (the JAX ``_example`` functions): a
# tenant superblock of 4 lanes a rank, 2 cohort (or slab) lanes a rank.
_CAPS = dict(n_elems=4, n_actors=2, deferred_cap=2)


def _lanes(mesh, device):
    p = mesh.p
    idx = torch.arange(2, dtype=torch.int32, device=device).repeat(p)
    return p * 4, p * 2, idx


def mk_serve_args(mesh, device, kind: str = "orswot"):
    """``(state, slab, idx)`` of one ``mesh_serve_apply`` dispatch: an
    all-NOOP slab of depth 2."""
    from ..ops import superblock as sb_ops

    tk = sb_ops.tenant_kind(kind)
    t, b, idx = _lanes(mesh, device)
    return (tk.empty(**_CAPS, batch=(t,), device=device),
            sb_ops.empty_slab(tk, _CAPS, b, 2, device=device), idx)


def mk_fanout_args(mesh, device, kind: str = "orswot"):
    """``(state, bases, idx, weights)`` of one ``mesh_fanout_push``
    dispatch."""
    from ..ops import superblock as sb_ops

    tk = sb_ops.tenant_kind(kind)
    t, b, idx = _lanes(mesh, device)
    return (tk.empty(**_CAPS, batch=(t,), device=device),
            tk.empty(**_CAPS, batch=(b,), device=device), idx,
            torch.ones(idx.shape, dtype=torch.float32, device=device))


__all__ = [
    "GA", "GD", "GE", "GK1", "GK2", "GM", "GP", "GS", "mk_clocks", "mk_dense", "mk_fanout_args",
    "mk_gset", "mk_lww", "mk_map", "mk_map3", "mk_map_orswot", "mk_mvreg", "mk_nested_map",
    "mk_serve_args", "mk_sparse", "mk_sparse_mvmap", "mk_sparse_nested", "replicas",
    "sparse_nested_level",
]
