"""Depth-4 nesting from the combinator + sparse mode for huge universes
(the port of ``examples/06_deep_nesting_and_sparse.py``).

Three capabilities in one tour:

1. ``Map<org, Map<team, Map<channel, Orswot<member>>>>`` — FOUR causal
   levels — built by composing ``ops.nest.NestLevel`` around the
   depth-3 slab: no depth-4 module exists anywhere in the package; the
   induction step is code (reference: src/map.rs arbitrary ``V: Val<A>``
   nesting).
2. A presence set over a 1M-member universe in SPARSE mode: state size
   tracks live members, not the universe (``ops/sparse_orswot.py``).
3. A sparse document store ``Map<doc, Map<field, MVReg>>`` — the
   register-map family sparse too, virtual universes on BOTH key
   levels (``ops/sparse_mvmap.py`` under the sparse nest).

Run:  python -m crdt_tpu_torch.examples.ex06_deep_nesting_and_sparse [--device cpu]
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from crdt_tpu_torch import Map, MVReg
from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.examples._tour import cli
from crdt_tpu_torch.models import BatchedSparseNestedMap, BatchedSparseOrswot
from crdt_tpu_torch.ops import map3 as m3_ops
from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map
from crdt_tpu_torch.ops.nest import NestLevel
from crdt_tpu_torch.pure.orswot import Orswot


def deep_nesting(device="cuda") -> dict:
    LEVEL4 = NestLevel(m3_ops.LEVEL)  # depth 4 = one more induction step

    k1, k2, k3, m, a = 2, 2, 2, 3, 3
    state = LEVEL4.empty(
        m3_ops.empty(k1 * k2, k3, m, a, deferred_cap=4, batch=(3,), device=device),
        k1, a, 4, (3,),
    )
    # Three replicas each add one member at a distinct (org, team,
    # channel) path under their own actor lane (one dot shared by all
    # four causal levels).
    rows = []
    for r in range(3):
        row = tree_map(lambda x: x[r], state)
        core3 = m3_ops.apply_member_add(
            row.core, r, 1, r % (k1 * k2), r % k3,
            torch.as_tensor(np.eye(m, dtype=bool)[r % m], device=device),
        )
        rows.append(LEVEL4.cascade(row, core3))
    # Fold the three replicas with the generic level join.
    acc = rows[0]
    for row in rows[1:]:
        acc, flags = LEVEL4.join(acc, row)
        assert not bool(flags.any())
    live = int((bits(acc.core.mo.core.ctr) != 0).any(-1).sum())
    assert live == 3, live
    print(f"depth-4 map: 3 replicas folded, {live} live leaf cells "
          f"(no ops/map4.py exists — NestLevel composed it)")
    return {"live_leaf_cells": live}


def sparse_presence(device="cuda") -> dict:
    universe = 1_000_000  # members are interned on demand; never densified
    rng = np.random.default_rng(4)
    sites = [Orswot() for _ in range(4)]
    for step in range(200):
        i = int(rng.integers(4))
        s = sites[i]
        member = f"user-{int(rng.integers(universe))}"
        if rng.random() < 0.8 or not s.read().val:
            s.apply(s.add(member, s.read().derive_add_ctx(f"site-{i}")))
        else:
            victim = sorted(s.read().val)[0]
            s.apply(s.rm(victim, s.contains(victim).derive_rm_ctx()))
    model = BatchedSparseOrswot.from_pure(sites, dot_cap=512, rm_width=16, device=device)
    expect = sites[0].clone()
    for s in sites[1:]:
        expect.merge(s.clone())
    assert model.fold() == expect
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(model.state))
    dense_bytes = 4 * len(sites) * universe * model.state.top.shape[-1]
    print(
        f"sparse presence: {len(expect.entries)} live of {universe:,} possible "
        f"members; device state {nbytes/1024:.0f} KiB vs "
        f"{dense_bytes/1e9:.1f} GB dense — converged == oracle"
    )
    return {"live_members": len(expect.entries), "universe": universe,
            "state_bytes": nbytes, "dense_bytes": dense_bytes}


def sparse_documents(device="cuda") -> dict:
    """The register-map family is sparse too: a document store
    ``Map<doc, Map<field, MVReg>>`` over virtual universes on BOTH key
    levels — live-cell-proportional state (ops/sparse_mvmap.py under the
    sparse nest), same oracle, same op surface."""
    rng = random.Random(6)
    mk = lambda: Map(lambda: Map(MVReg))  # noqa: E731
    sites = [mk() for _ in range(3)]
    for step in range(30):
        i = rng.randrange(3)
        m = sites[i]
        doc = f"doc-{rng.randrange(1_000_000)}" if rng.random() < 0.4 else "doc-hot"
        field = rng.choice(["title", "body", "owner"])
        ctx = m.len().derive_add_ctx(f"site-{i}")
        op = m.update(doc, ctx, lambda im, c, f=field, v=f"r{step}":
                      im.update(f, c, lambda reg, c2: reg.write(v, c2)))
        m.apply(op)
    model = BatchedSparseNestedMap.from_pure(
        sites, span=1 << 16, cell_cap=128, sibling_cap=8, device=device
    )
    expect = sites[0].clone()
    for site in sites[1:]:
        expect.merge(site.clone())
    assert model.fold() == expect
    hot = expect.entries["doc-hot"]
    print(
        f"sparse documents: {len(expect.entries)} live docs over a "
        f"2^31/A-key product space; {model.nbytes()/1024:.0f} KiB device "
        f"state; doc-hot holds {len(hot.entries)} fields — converged == "
        f"oracle"
    )
    return {"live_docs": len(expect.entries), "state_bytes": model.nbytes(),
            "hot_fields": len(hot.entries)}


def main(device="cuda") -> dict:
    return {"deep_nesting": deep_nesting(device), "sparse_presence": sparse_presence(device),
            "sparse_documents": sparse_documents(device)}


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
