"""Operating the lattice over time: actor lifecycle migrations and the
δ-ring convergence certificate (the port of
``examples/07_lifecycle_and_certificates.py``).

Two operational subsystems the reference never needed (src/vclock.rs is
u64 end to end and ships no runtime), but a device lattice does:

1. **Actor lifecycle** (``crdt_tpu_torch/lifecycle.py``): the device
   lanes default to u32 for bandwidth; strict mode traps an approaching
   overflow with ``CounterSaturation``. The two prescribed remedies as
   code — widen u32 → u64 in place (reference width), or retire the hot
   actor into the ``__retired__`` aggregate lane and compact the
   universe.
2. **Convergence certificates** (``crdt_tpu_torch/parallel/delta.py``):
   a bounded δ-ring under-converges silently when the dirty backlog
   exceeds the packet cap × round budget. Every ring returns a
   ``residue`` count — 0 certifies the result equals the full join; > 0
   says exactly how many slot-starved row-rounds remain.

The tour switches ``counter_dtype`` to ``uint64`` as the JAX tour does;
``main`` gives the caller's configuration back on every exit path.

Run:  python -m crdt_tpu_torch.examples.ex07_lifecycle_and_certificates [--device cpu]
"""

from __future__ import annotations

import sys
import warnings

import numpy as np
import torch

from crdt_tpu_torch._dtypes import bits, umax, zeros
from crdt_tpu_torch.config import configure, configured
from crdt_tpu_torch.examples._tour import VIRTUAL_RANKS, cli
from crdt_tpu_torch.lifecycle import RETIRED, compact_actors, retire_actor, widen_counters
from crdt_tpu_torch.models.counters import BatchedPNCounter
from crdt_tpu_torch.models.orswot import BatchedOrswot
from crdt_tpu_torch.ops.lattice import tree_map
from crdt_tpu_torch.parallel import (
    VirtualMesh, interval_accumulate, mesh_delta_gossip, mesh_fold, pad_elements, pad_replicas,
)
from crdt_tpu_torch.pure.orswot import Orswot
from crdt_tpu_torch.vclock import VClock


def _tour(device) -> dict:
    # ---- 1. lifecycle: a counter fleet nearing the u32 ceiling -------
    # Four tills, one hot actor ("till-0") whose lane is close to
    # saturating after years of increments.
    fleet = BatchedPNCounter(n_replicas=4, n_actors=8, device=device)
    for t in range(4):
        fleet.inc(t, "till-0", steps=2**31 - 1)  # the hot legacy lane
        fleet.inc(t, f"till-{t}", steps=100 + t)
        if t:
            fleet.dec(t, f"till-{t}", steps=t)
    before = fleet.fold_read()
    print(f"fleet converged read before migration: {before:,}")

    # Remedy A: widen to the reference's u64 width (bit-identical).
    configure(counter_dtype="uint64")
    widen_counters(fleet)
    assert fleet.fold_read() == before
    widened = fleet.fold_read()
    print(f"widened u32 -> u64 in place; read unchanged: {widened:,}")

    # Remedy B: retire the hot actor. Converge its lane first (retire
    # moves a lane sum, so rows must agree), then fold its count into
    # the __retired__ aggregate and reclaim its lane.
    for vc in (fleet.p, fleet.n):
        folded = umax(vc.clocks, 0)
        vc.clocks = folded.expand(vc.clocks.shape).clone()
    retire_actor(fleet, "till-0")
    assert fleet.fold_read() == before
    compact_actors(fleet)
    assert fleet.fold_read() == before
    lanes = [fleet.p.actors[i] for i in range(len(fleet.p.actors))]
    retired = fleet.fold_read()
    print(f"retired till-0 into {RETIRED!r}; lanes now {lanes}; "
          f"read still {retired:,}")

    # Remedy C — causal types (ORSWOT/MVReg/Map/VClock): counters can't
    # fold into an aggregate lane (clock comparisons are per-actor), so
    # retirement is the reference's ``Causal::reset_remove`` — forget
    # the departed actor's causal history on every replica; the A/B
    # gates pin device == oracle.
    carts = [Orswot() for _ in range(3)]
    for i, site in enumerate(carts):
        op = site.add(f"item-{i}", site.read().derive_add_ctx(f"till-{i}"))
        site.apply(op)
    for dst in range(3):
        for src in range(3):
            if src != dst:
                carts[dst].merge(carts[src].clone())
    model = BatchedOrswot.from_pure(carts, device=device)
    gone = VClock({"till-0": carts[0].clock.get("till-0")})
    for i in range(3):
        model.reset_remove(i, gone)
    kept = sorted(model.members_of(0))
    top = model.to_pure(0).clock
    print(f"reset_remove(till-0) on every replica; members now "
          f"{kept}; top {top}")
    assert model.to_pure(0).clock.get("till-0") == 0

    # ---- 2. δ-ring residue: the convergence certificate --------------
    n = VIRTUAL_RANKS
    mesh = VirtualMesh(n, device)
    p = mesh.p

    # A burst that dirties MANY rows per replica — more than one packet
    # can carry.
    rng = np.random.default_rng(11)
    sites = [Orswot() for _ in range(p)]
    for i, site in enumerate(sites):
        for m in rng.choice(512, size=96, replace=False):
            site.apply(site.add(int(m), site.read().derive_add_ctx(f"r{i}")))
    model = BatchedOrswot.from_pure(sites, n_members=512, device=device)
    state = pad_elements(pad_replicas(model.state, mesh.p), mesh.s)
    empty = tree_map(lambda x: zeros(x.shape, x.dtype, x.device), state)
    dirty0 = torch.zeros(state.ctr.shape[:2], dtype=torch.bool, device=state.ctr.device)
    ctx0 = zeros(state.ctr.shape, state.ctr.dtype, state.ctr.device)
    dirty, fctx = interval_accumulate(dirty0, ctx0, empty, state)

    cap = 16  # each packet carries 16 rows; backlog is 96 rows/replica
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the residue warning, expected
        _, _, _, residue = mesh_delta_gossip(
            state, dirty, fctx, mesh, rounds=p - 1, cap=cap
        )
    starved = int(residue)
    print(f"under-budgeted ring (P-1={p-1} rounds, cap {cap}): "
          f"residue {starved} row-rounds -> NOT certified converged")
    assert starved > 0

    # Certified re-run. Domain forwarding means the worst-case backlog
    # on any rank is the whole LOCAL row universe (everyone's rows
    # transit every rank), so budget generously — P ring latencies of
    # the worst-case per-rank drain. A bigger packet cap buys it down.
    cap = 128
    rounds = p * p * (-(-512 // cap) + 2)
    out, _, _, residue = mesh_delta_gossip(
        state, dirty, fctx, mesh, rounds=rounds, cap=cap
    )
    certified = int(residue)
    assert certified == 0

    full, _ = mesh_fold(state, mesh)
    same = bool(torch.all(bits(out.ctr) == bits(full.ctr)[None]))
    print(f"re-run with {rounds} rounds: residue 0 -> certified; "
          f"rows == full join: {same}")
    assert same
    return {"read_before": before, "read_widened": widened, "retired_lanes": lanes,
            "read_retired": retired, "reset_members": kept, "reset_top": str(top),
            "starved_rounds": p - 1, "starved_residue": starved, "certified_rounds": rounds,
            "certified_residue": certified, "rows_equal_full_join": same}


def main(device="cuda") -> dict:
    with configured():  # the tour's configure(counter_dtype=...) ends with it
        return _tour(device)


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
