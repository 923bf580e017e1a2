"""crdt_tpu_torch.analysis — the port of the JAX package's analysis engine:
the result type (:mod:`.report`), the committed freshness SLO gate
(:mod:`.slo`), the registry (:mod:`.registry`: the merge kinds, the
surfaces, the mesh entries, the trace stages and the host shared fields,
tables built on first use), the lattice-law engine (:mod:`.laws`, with the
compaction and decomposition laws), the bounded SEC schedule checker
(:mod:`.schedules`), their canonical forms (:mod:`.canon`), the
host-concurrency plane (:mod:`.effects`, :mod:`.concur`,
:mod:`.interleave`), the program checks over each mesh entry's op trace
(:mod:`.optrace`; the gate geometry :mod:`.gate_states`; the lint and the
δ digest-gate check :mod:`.jit_lint`; the cost budgets :mod:`.cost`; the
donation gate :mod:`.aliasing`), the broken twins that prove each detector
fires (:mod:`.fixtures`) and the static-check runner (:mod:`.run`,
``python -m crdt_tpu_torch.analysis.run``). Every check runs on
``device=`` (default the card).
"""

from . import (  # noqa: F401
    aliasing, canon, concur, cost, effects, gate_states, interleave, jit_lint, laws, optrace,
    registry, report, schedules, slo,
)
from .registry import (  # noqa: F401
    EntryPoint, MergeKind, entry_points, get_merge_kind, merge_kinds, unregistered_entry_points,
)
from .report import Finding, format_findings  # noqa: F401
