"""Collaborative document tags: ``Map<doc, Orswot<tag>>`` across three
sites, concurrent remove-vs-add, then device-backed convergence (the
port of ``examples/01_collaborative_tags.py``).

Run:  python -m crdt_tpu_torch.examples.ex01_collaborative_tags [--device cpu]
"""

from __future__ import annotations

import sys

from crdt_tpu_torch import Map, Orswot
from crdt_tpu_torch.examples._tour import cli
from crdt_tpu_torch.models import BatchedMapOrswot


def main(device="cuda") -> dict:
    # --- three sites edit through the causal-context protocol ----------
    sites = [Map(Orswot) for _ in range(3)]
    log = []

    def do(i, mint):
        op = mint(sites[i])
        sites[i].apply(op)
        log.append((i, op))

    do(0, lambda m: m.update("doc1", m.len().derive_add_ctx("alice"),
                             lambda s, c: s.add("urgent", c)))
    do(1, lambda m: m.update("doc1", m.len().derive_add_ctx("bob"),
                             lambda s, c: s.add("draft", c)))
    do(2, lambda m: m.update("doc2", m.len().derive_add_ctx("carol"),
                             lambda s, c: s.add("done", c)))
    # alice removes doc1 while bob concurrently tags it again: add wins
    do(0, lambda m: m.rm("doc1", m.get("doc1").derive_rm_ctx()))
    do(1, lambda m: m.update("doc1", m.len().derive_add_ctx("bob"),
                             lambda s, c: s.add("final", c)))

    # --- full op exchange (per-actor causal order preserved) -----------
    for origin, op in log:
        for j in range(3):
            if j != origin:
                sites[j].apply(op)
    assert sites[0] == sites[1] == sites[2]
    converged = {k: sorted(sites[0].get(k).val.members()) for k in sorted(sites[0].keys())}
    print("pure sites converged:", converged)

    # --- same history on the batched device backend --------------------
    dev = BatchedMapOrswot.from_pure(
        [Map(Orswot) for _ in range(3)],
        n_keys=4, n_members=8, n_actors=4, deferred_cap=8, device=device,
    )
    for origin, op in log:
        dev.apply(origin, op)
    for origin, op in log:
        for j in range(3):
            if j != origin:
                dev.apply(j, op)
    assert dev.fold() == sites[0]
    print("device fold bit-identical to the converged pure state")
    return {"converged": converged, "fold_equals_pure": True}


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
