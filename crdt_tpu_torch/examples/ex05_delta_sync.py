"""δ-state synchronization: after a burst of local edits, replicas
exchange bounded delta packets (dirty rows + per-row causal contexts —
the delta-CRDT discipline) over the ring instead of whole states, and
still land bit-identical to the full-state fold (the port of
``examples/05_delta_sync.py``).

The JAX tour runs on 8 host devices; here the mesh is 8 virtual ranks of
one device (``parallel.mesh.VirtualMesh``), shaped as the JAX mesh is.

Run:  python -m crdt_tpu_torch.examples.ex05_delta_sync [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from crdt_tpu_torch._dtypes import bits, zeros
from crdt_tpu_torch.examples._tour import VIRTUAL_RANKS, cli, same
from crdt_tpu_torch.models.orswot import BatchedOrswot
from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map
from crdt_tpu_torch.parallel import (
    VirtualMesh, interval_accumulate, mesh_delta_gossip, mesh_fold, pad_elements, pad_replicas,
)
from crdt_tpu_torch.pure.orswot import Orswot
from crdt_tpu_torch.utils import Interner


def main(device="cuda") -> dict:
    n = VIRTUAL_RANKS
    mesh = VirtualMesh(n // 2, device, s=2)  # the JAX tours' make_mesh(n // 2, 2)
    shape = {"replica": mesh.p, "element": mesh.s}
    print(f"mesh: {shape} over {n} virtual ranks on {mesh.device}")

    # A large, mostly-quiet member universe: 8 replicas, 4096 members,
    # but this sync interval only touched a handful of rows per replica.
    rng = np.random.default_rng(3)
    members = [f"item-{i}" for i in range(4096)]
    sites = [Orswot() for _ in range(8)]

    interners = dict(
        members=Interner(members),
        actors=Interner([f"site-{i}" for i in range(8)]),
    )
    base = BatchedOrswot.from_pure(sites, **interners, device=device)

    # Local burst: each site adds ~6 members and removes one, tracked at
    # op granularity with interval_accumulate.
    e, a = base.state.ctr.shape[-2], base.state.ctr.shape[-1]
    dirty = torch.zeros((8, e), dtype=torch.bool, device=device)
    fctx = zeros((8, e, a), torch.uint32, device)
    model = BatchedOrswot(8, e, a, base.state.dcl.shape[-2], **interners, device=device)
    for i, site in enumerate(sites):
        for _ in range(6):
            m = members[int(rng.integers(0, len(members)))]
            op = site.add(m, site.read().derive_add_ctx(f"site-{i}"))
            site.apply(op)
            old = tree_map(lambda x: x[i].clone(), model.state)  # apply writes the row in place
            model.apply(i, op)
            new = tree_map(lambda x: x[i], model.state)
            d_i, f_i = interval_accumulate(dirty[i], fctx[i], old, new)
            dirty[i], bits(fctx)[i] = d_i, bits(f_i)

    n_dirty = int(dirty.sum())
    sharded = pad_elements(pad_replicas(model.state, mesh.p), mesh.s)
    folded, _ = mesh_fold(sharded, mesh)

    cap = 16
    gossiped, _, overflow, residue = mesh_delta_gossip(
        sharded, dirty, fctx, mesh, rounds=2 * mesh.p, cap=cap
    )
    assert not bool(overflow)
    for g, f in zip(tree_leaves(gossiped), tree_leaves(folded)):
        for row in range(g.shape[0]):
            assert same(g[row], f), f"row {row} differs from the full-state fold"

    ctr = model.state.ctr
    full_bytes = ctr.numel() * ctr.element_size() // 8  # one replica's row slab
    d = model.state.dcl.shape[-2]
    # Real device bytes throughout (bool masks are 1 byte/element on
    # device; a bitpacked wire encoding would divide the dmask term by 8).
    pkt_bytes = (
        cap * (a * 4 * 2 + 4 + 1)  # rows + ctxs + idx + valid
        + d * (a * 4 + e + 1)      # parked removes ride whole: dcl + dmask + dvalid
    )
    print(
        f"{n_dirty} dirty rows of {dirty.numel()}; delta packet ≈ "
        f"{pkt_bytes/1024:.1f} KiB per link per round vs "
        f"{full_bytes/1024:.0f} KiB full row slab "
        f"({full_bytes/pkt_bytes:.0f}x less traffic)"
    )
    print("delta gossip converged bit-identical to the full-state fold")
    return {"mesh": shape, "ranks": n, "dirty_rows": n_dirty, "tracked_rows": dirty.numel(),
            "packet_bytes": pkt_bytes, "row_slab_bytes": full_bytes,
            "residue": int(residue), "gossip_rows_equal_fold": True}


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
