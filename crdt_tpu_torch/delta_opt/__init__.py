"""Optimal δ synchronization (Enes et al., "Efficient Synchronization of
State-based CRDTs", arXiv 1803.02750) — the port of the JAX package's
``delta_opt``:

- :mod:`.decompose` — per-kind join-irreducible decomposition: a state's
  inflation over a known lower bound split into changed row lanes plus a
  whole-riding residual;
- :mod:`.ackwin` — ack-window back-propagation for the δ rings
  (``ack_window=True`` on ``run_delta_ring``, ``mesh_delta_gossip`` and
  ``mesh_delta_gossip_map``);
- :mod:`.heal` — the post-heal resync that ships each rank's
  decomposition instead of full states, bit-identical to full-state
  gossip.

Plus :func:`static_checks` — the ``decomp`` section of the port's
static-check runner (``analysis/run.py``): decomposition coverage, the
reconstruction and irredundancy laws, and their two broken twins.
"""

from typing import List

from .ackwin import (
    AckWindow,
    ack_bits,
    gate_window,
    init_window,
    update_window,
    window_depth,
)
from .decompose import (
    Decomposition,
    decompose,
    decompose_rows,
    decomposition_bytes,
    drop_lane,
    reconstruct,
    reconstruct_rows,
)
from .heal import ResyncReport, resync


def static_checks(device="cuda") -> List:
    """The ``decomp`` static-check section (Finding list, empty = clean):

    1. **decomposition coverage** and 2. **decomposition laws** — every
       merge kind has a decomposer, and reconstruction and irredundancy
       hold over every kind's small domain on ``device``, bit-exact on
       canonical forms (``analysis.laws.check_decomposition_all``, which
       reports an uncovered kind once);
    3. **broken twins fire** — the lossy twin
       (``analysis.fixtures.LOSSY_DECOMPOSER``) fails reconstruction and the
       non-irredundant twin (``REDUNDANT_DECOMPOSER``) fails irredundancy.
    """
    from ..analysis import fixtures, laws
    from ..analysis.registry import get_merge_kind
    from ..analysis.report import Finding

    findings: List[Finding] = list(laws.check_decomposition_all(device=device))

    orswot = get_merge_kind("orswot")
    lossy = laws.check_decomposition_kind(orswot, dec=fixtures.LOSSY_DECOMPOSER, device=device)
    if not any(f.check == "decomp-reconstruction" for f in lossy):
        findings.append(Finding(
            "broken-fixture-missed", "LOSSY_DECOMPOSER",
            "the lane-dropping decomposition twin PASSED the "
            "reconstruction law — the decomp gate is not actually "
            "firing",
        ))
    redundant = laws.check_decomposition_kind(orswot, dec=fixtures.REDUNDANT_DECOMPOSER,
                                              device=device)
    if not any(f.check == "decomp-irredundancy" for f in redundant):
        findings.append(Finding(
            "broken-fixture-missed", "REDUNDANT_DECOMPOSER",
            "the unchanged-lane-emitting decomposition twin PASSED the "
            "irredundancy law — the minimality gate is not actually "
            "firing",
        ))
    return findings

__all__ = [
    "AckWindow", "Decomposition", "ResyncReport", "ack_bits", "decompose", "decompose_rows",
    "decomposition_bytes", "drop_lane", "gate_window", "init_window", "reconstruct",
    "reconstruct_rows", "resync", "static_checks", "update_window", "window_depth",
]
