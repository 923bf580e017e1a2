"""The aliasing gate — the port's counterpart of the JAX package's
``tools/check_aliasing.py``.

Donation (``donate=True`` on the ring, gossip, stream and serving
entries) lets an entry run with ONE resident copy of its state: at
R == P (one replica row a rank) the outputs are written into the
caller's donated tensors (``anti_entropy._write_back``), at R != P the
donated inputs are freed (``anti_entropy._consume``) and
``anti_entropy.donate_unaliasable`` counts the call. A replica stream
copies its donated accumulator once and keeps every step's result in
that copy (the JAX stream's step donation: the caller's ``init``
survives). The property is easy to lose silently — an output reshaped or
rebuilt, and the entry quietly holds two copies — so this gate fails
instead.

Coverage is the entry table (``registry.entry_points``): every donating
entry runs once at R == P with ``donate=True`` under the op recorder, and
each donated input leaf's storage (a stream: its one copy's) must hold an
output leaf, with ``donate_unaliasable`` unmoved. Each ring entry (the
gossip and δ rings) runs again at R = 2P: every donated storage must then
be freed and ``donate_unaliasable`` counted once. A public ``mesh_*``
entry missing from the table is a failure row.

CLI: ``python -m crdt_tpu_torch.analysis.run --only aliasing``.
"""

from __future__ import annotations

from typing import List, Tuple

from ..utils import ophooks
from . import optrace
from .jit_lint import copies_of, gate_mesh


def _counted() -> float:
    from ..utils.metrics import metrics

    return metrics.snapshot()["counters"].get("anti_entropy.donate_unaliasable", 0)


def _ring(ep) -> bool:
    return ep.name.startswith(("mesh_gossip", "mesh_delta_gossip"))


def check_aliased(ep, mesh) -> Tuple[bool, str]:
    """One donating entry at R == P: every donated leaf's storage (or its
    one copy's) holds an output leaf; ``donate_unaliasable`` unmoved."""
    args = ep.make_args(mesh, mesh.device)
    n = len(optrace.tensor_leaves(args[:ep.n_donated]))
    before = _counted()
    with ophooks.card_routes():
        trace = optrace.record(ep.invoke, mesh, args)
    moved = _counted() - before
    outs = {r.sid for r in trace.outputs}
    lost = []
    for r in trace.inputs[:n]:
        holders = {r.sid} | (copies_of(trace, r.sid) if ep.copies_donated else set())
        if not holders & outs:
            lost.append(f"{r.dtype}{list(r.shape)}")
    if lost:
        return False, f"{len(lost)}/{n} donated leaves live in no output leaf: {lost}"
    if moved:
        return False, f"anti_entropy.donate_unaliasable moved by {moved} at R == P"
    how = "their one copy holds" if ep.copies_donated else "alias"
    return True, f"{n} donated leaves {how} the outputs"


def check_consumed(ep, mesh) -> Tuple[bool, str]:
    """One ring entry at R = 2P: every donated leaf's storage is freed and
    ``donate_unaliasable`` counts the call once."""
    from ..parallel.mesh import VirtualMesh

    args = ep.make_args(VirtualMesh(2 * mesh.p, mesh.device, s=mesh.s), mesh.device)
    donated = optrace.tensor_leaves(args[:ep.n_donated])
    before = _counted()
    with ophooks.card_routes():
        ep.invoke(mesh, args)
    moved = _counted() - before
    kept = [f"{t.dtype}{list(t.shape)}" for t in donated if t.untyped_storage().nbytes()]
    if kept or moved != 1:
        return False, (f"at R = 2P {len(kept)}/{len(donated)} donated leaves not freed "
                       f"{kept}, donate_unaliasable moved by {moved}")
    return True, f"at R = 2P {len(donated)} donated leaves freed"


def check_all(device="cuda") -> List[Tuple[str, bool, str]]:
    """Every donating entry's rows, ``[(kind, ok, detail)]``; a public
    ``mesh_*`` entry missing from the table is a failure row. A broken
    case is a failed row, loudly."""
    from .registry import entry_points, unregistered_entry_points

    mesh = gate_mesh(device)
    rows = [(name, False, "public mesh entry point not in crdt_tpu_torch.analysis.registry's "
                          "entry table — the gate cannot cover it")
            for name in unregistered_entry_points()]
    for ep in entry_points(donatable=True):
        checks = (check_aliased, check_consumed) if _ring(ep) else (check_aliased,)
        for check in checks:
            try:
                ok, detail = check(ep, mesh)
            except Exception as exc:
                ok, detail = False, f"{type(exc).__name__}: {exc}"
            rows.append((ep.kind, ok, detail))
    return rows


__all__ = ["check_aliased", "check_all", "check_consumed"]
