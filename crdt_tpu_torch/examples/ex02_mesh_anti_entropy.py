"""Full-mesh anti-entropy on a replica mesh: 16 ORSWOT replicas on
(replica × element) virtual ranks, converged in one lattice-join
all-reduce, plus the bounded-bandwidth ring-gossip alternative (the port
of ``examples/02_mesh_anti_entropy.py``).

The JAX tour runs on 8 host devices; here the mesh is 8 virtual ranks of
one device (``parallel.mesh.VirtualMesh``), shaped as the JAX mesh is.

Run:  python -m crdt_tpu_torch.examples.ex02_mesh_anti_entropy [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.convert import leaf_from_numpy
from crdt_tpu_torch.examples._tour import VIRTUAL_RANKS, cli, same
from crdt_tpu_torch.ops import orswot as ops
from crdt_tpu_torch.ops.lattice import tree_leaves
from crdt_tpu_torch.parallel import (
    VirtualMesh, mesh_fold, mesh_gossip, pad_elements, pad_replicas,
)


def main(device="cuda") -> dict:
    n = VIRTUAL_RANKS
    mesh = VirtualMesh(n // 2, device, s=2)  # the JAX tours' make_mesh(n // 2, 2)
    shape = {"replica": mesh.p, "element": mesh.s}
    print(f"mesh: {shape} over {n} virtual ranks on {mesh.device}")

    # 16 replicas, each minting adds under its own actor lane for a
    # random half of a 256-member universe (a replica's top covers only
    # its own history, so nothing it never saw can be dropped — the
    # fold is the union of everyone's live adds).
    rng = np.random.default_rng(0)
    r, e, a = 16, 256, 16  # one actor lane per replica: no forks
    lane = np.arange(r) % a
    ctr = np.zeros((r, e, a), np.uint32)
    mine = rng.random((r, e)) < 0.5
    stamp = rng.integers(1, 50, (r, e)).astype(np.uint32)
    np.put_along_axis(
        ctr, lane[:, None, None] * np.ones((r, e, 1), np.int64),
        np.where(mine, stamp, 0)[..., None], axis=-1,
    )
    top = ctr.max(axis=1)
    state = ops.empty(e, a, deferred_cap=4, batch=(r,), device=device)
    state = state._replace(top=leaf_from_numpy(top, device), ctr=leaf_from_numpy(ctr, device))

    sharded = pad_elements(pad_replicas(state, mesh.p), mesh.s)

    folded, overflow = mesh_fold(sharded, mesh)  # one all-reduce round
    assert not bool(overflow)
    members = int(torch.any(bits(folded.ctr) != 0, dim=-1).sum())
    print(f"all-reduce fold: {members}/{e} members in the converged set")

    gossiped, g_of = mesh_gossip(sharded, mesh)  # P-1 one-neighbor rounds
    assert not bool(torch.any(g_of))
    rows_equal = all(
        same(leaf_g[i], leaf_f)
        for leaf_g, leaf_f in zip(tree_leaves(gossiped), tree_leaves(folded))
        for i in range(leaf_g.shape[0])
    )
    assert rows_equal
    print("ring gossip (P-1 rounds) reaches the identical converged state")
    return {"mesh": shape, "ranks": n, "members": members, "universe": e,
            "gossip_rows_equal_fold": rows_equal}


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
