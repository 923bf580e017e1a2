"""The bounded SEC model checker — convergence under DELIVERY, not
algebra; the port of the JAX package's ``analysis/schedules.py``.

The law engine (:mod:`.laws`) proves the join is a semilattice on pairs
and triples; this module checks strong eventual consistency: replicas that
receive the same set of δ messages converge, whatever the order,
duplication and transient drops (Almeida et al., "Delta State Replicated
Data Types", arXiv 1603.01529), exhaustively up to a small bound.

**Model.** Each kind contributes ≤ :data:`MAX_OPS` δ increments minted by
≤ :data:`MAX_REPLICAS` origins (its ``deltas`` hook, or derived from its
small domain). A *schedule* is one replica's delivery history over the δ
set: every permutation (reorder), every permutation with one δ delivered
twice (at once, or as a stale replay at the end), and every permutation
with one δ dropped and the whole history replayed after (drop with
resync). A kind with an op-based ``apply`` is promised convergence only
under causal exactly-once delivery: those kinds also run the causal
interleavings through ``apply``.

If every delivery history folds to the same canonical state, any
assignment of histories to replicas converges, so the checker folds ALL
schedules at once and compares bit-exactly against the in-order fold.
The JAX checker runs one ``lax.scan`` of a vmapped deliver; here it is a
loop over the schedule's steps, each step ONE batched join over every
schedule (the joins take any leading batch axes), on ``device``.

A divergent schedule is greedily shrunk to an irreducible counterexample
(:func:`minimize_schedule`), reported with the divergent leaf path.
"""

from __future__ import annotations

import itertools
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._dtypes import bits
from ..convert import leaf_to_numpy
from ..ops.lattice import tree_leaves, tree_map
from .laws import _mismatches, _norm_join, _stack, _take
from .registry import MergeKind, merge_kinds
from .report import Finding

MAX_OPS = 4
MAX_REPLICAS = 3


# ---- δ/op derivation ------------------------------------------------------

def derive_ops(kind: MergeKind, max_ops: int = MAX_OPS, device="cuda") -> List[Tuple[int, Any]]:
    """The kind's bounded op set ``[(origin, δ-state), ...]``: its
    ``deltas`` hook, or the reachable states past the identity with
    round-robin origins (sound for every CvRDT kind)."""
    if kind.deltas is not None:
        ops = list(kind.deltas(device=device))
    else:
        ops = [(i % MAX_REPLICAS, s) for i, s in enumerate(kind.states(device=device)[1:])]
    return ops[:max_ops]


# ---- schedule enumeration -------------------------------------------------

def enumerate_schedules(n: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """All bounded δ-path delivery schedules over ``n`` ops:
    ``[(label, op-index sequence), ...]``, deduplicated. Every sequence
    delivers every op at least once."""
    out: dict = {}

    def add(label: str, seq: Tuple[int, ...]) -> None:
        out.setdefault(seq, label)

    for p in itertools.permutations(range(n)):
        add("reorder", p)
        for j in range(n):
            # A stale replay of op j after everything else ...
            add("dup-late", p + (p[j],))
            # ... and a network-level immediate duplicate.
            add("dup-now", p[: j + 1] + (p[j],) + p[j + 1:])
            # The replica missed op j; a later anti-entropy round replays
            # the full history in mint order.
            dropped = tuple(x for x in p if x != j)
            add("drop-resync", dropped + tuple(range(n)))
    return [(label, seq) for seq, label in out.items()]


def causal_schedules(origins: Sequence[int]) -> List[Tuple[int, ...]]:
    """Exactly-once interleavings respecting per-origin op order — the
    delivery space a CmRDT ``apply`` is promised."""
    n = len(origins)
    seqs = []
    for p in itertools.permutations(range(n)):
        pos = {op: t for t, op in enumerate(p)}
        if all(pos[i] < pos[j] for i in range(n) for j in range(i + 1, n)
               if origins[i] == origins[j]):
            seqs.append(p)
    return seqs


# ---- execution ------------------------------------------------------------

def _state_bytes(state) -> tuple:
    """Bit-exact fingerprint of a (canonicalised) state tree."""
    out = []
    for x in tree_leaves(state):
        a = leaf_to_numpy(x)
        out.append((a.tobytes(), a.shape, str(a.dtype)))
    return tuple(out)


def _run_batched(deliver, identity, table, sch: np.ndarray):
    """Fold ``deliver`` over every schedule row of the ``[B, L]`` index
    matrix at once: step ``t`` delivers row ``sch[:, t]`` of ``table`` to
    every schedule in one batched call. The sentinel index
    ``len(table)-1`` pads ragged schedules and is SKIPPED (the state rides
    through unchanged), not delivered as the identity — a broken join need
    not absorb the identity. Returns ``(finals, flags [B] bool)``."""
    first = tree_leaves(table)[0]
    sentinel = first.shape[0] - 1
    b = sch.shape[0]
    state = tree_map(lambda x: bits(x).expand(b, *x.shape).clone().view(x.dtype), identity)
    flag = torch.zeros(b, dtype=torch.bool, device=first.device)
    for t in range(sch.shape[1]):
        col = sch[:, t]
        live = torch.as_tensor(col != sentinel, device=first.device)
        nxt, f = deliver(state, _take(table, col))
        state = tree_map(
            lambda a, s: torch.where(live.reshape(b, *([1] * (a.dim() - 1))), bits(a),
                                     bits(s)).view(a.dtype),
            nxt, state)
        if f is not None:
            flag = flag | (f.reshape(b, -1).any(dim=1) & live)
    return state, flag


def _run_one(deliver, identity, deltas, seq: Sequence[int]):
    """Replay of a single schedule (counterexample shrinking: a handful of
    joins on tiny states)."""
    state = identity
    for i in seq:
        state, _ = deliver(state, deltas[i])
    return state


def minimize_schedule(seq: Sequence[int], n_ops: int, diverges) -> Tuple[int, ...]:
    """Greedy shrink: repeatedly delete any element whose removal keeps
    every op delivered at least once AND still diverges. The result is
    irreducible."""
    seq = tuple(seq)
    changed = True
    while changed:
        changed = False
        for p in range(len(seq)):
            cand = seq[:p] + seq[p + 1:]
            if set(range(n_ops)) - set(cand):
                continue  # would break eventual delivery
            if diverges(cand):
                seq = cand
                changed = True
                break
    return seq


# ---- the checker ----------------------------------------------------------

def _format_schedule(label: str, seq: Sequence[int], origins) -> str:
    steps = " ".join(f"d{i}@r{origins[i]}" for i in seq)
    return f"[{label}] deliver {steps}"


def check_kind_schedules(kind: MergeKind, ops: Optional[List[Tuple[int, Any]]] = None,
                         max_ops: int = MAX_OPS, device="cuda") -> List[Finding]:
    """Model-check one kind's convergence over the bounded schedule space
    on ``device``; findings carry a minimised counterexample schedule and
    the divergent leaf path."""
    ops = derive_ops(kind, max_ops, device) if ops is None else ops[:max_ops]
    if len(ops) < 2:
        return [Finding(
            "schedule-domain", kind.name,
            f"schedule generator yields {len(ops)} δ/op(s) — need >= 2 "
            "for a non-trivial delivery space (register a `deltas` hook "
            "or widen the state generator)",
        )]
    origins = [o for o, _ in ops]
    deltas = [d for _, d in ops]
    identity = kind.states(device=device)[0]
    join = _norm_join(kind.join)
    canon = kind.canon or (lambda s: s)

    findings: List[Finding] = []
    findings += _check_path(
        kind, "sec-divergence", join, identity, deltas, origins,
        enumerate_schedules(len(ops)), canon,
        # Reference: the in-order fold.
        ref_seq=tuple(range(len(ops))),
    )

    if kind.apply is not None:
        def _deliver_apply(state, d):
            return kind.apply(state, d), None

        causal = [("causal", seq) for seq in causal_schedules(origins)]
        findings += _check_path(
            kind, "causal-divergence", _deliver_apply, identity, deltas,
            origins, causal, canon, ref_seq=causal[0][1],
        )
    return findings


def _check_path(kind, check, deliver, identity, deltas, origins, labelled, canon,
                ref_seq) -> List[Finding]:
    labels = [lb for lb, _ in labelled]
    seqs = [sq for _, sq in labelled]
    width = max(len(s) for s in seqs)
    sentinel = len(deltas)                     # index of the identity row
    table = _stack(deltas + [identity])
    sch = np.full((len(seqs), width), sentinel, np.int64)
    for r, s in enumerate(seqs):
        sch[r, : len(s)] = s

    finals, flags = _run_batched(deliver, identity, table, sch)
    ref = canon(_run_one(deliver, identity, deltas, ref_seq))
    ref_b = tree_map(lambda x: bits(x).expand(len(seqs), *x.shape).view(x.dtype), ref)
    mism = _mismatches(canon(finals), ref_b)
    flags_np = flags.cpu().numpy()
    if not mism:
        if flags_np.any():
            return [Finding(
                "schedule-overflow", kind.name,
                "a capacity/conflict flag fired inside the bounded "
                "schedule space — convergence still held, but widen the "
                "δ generator's caps so the check is not vacuous at the "
                "margin", severity="warning",
            )]
        return []

    ref_bytes = _state_bytes(ref)

    def diverges(seq) -> bool:
        return _state_bytes(canon(_run_one(deliver, identity, deltas, seq))) != ref_bytes

    findings: List[Finding] = []
    seen_rows = set()
    seen_paths = set()
    for row, path in mism:
        row = max(row, 0)
        # One finding per DISTINCT divergent leaf path.
        if row in seen_rows or path in seen_paths:
            continue
        seen_rows.add(row)
        seen_paths.add(path)
        path = path or "<root>"
        if bool(flags_np[row]):
            findings.append(Finding(
                check, kind.name,
                f"{_format_schedule(labels[row], seqs[row], origins)} "
                f"diverged at leaf {path}, but a capacity flag fired on "
                "this schedule — widen the δ generator's caps to make "
                "the verdict meaningful", severity="warning",
            ))
            continue
        small = minimize_schedule(seqs[row], len(deltas), diverges)
        findings.append(Finding(
            check, kind.name,
            f"minimized counterexample "
            f"{_format_schedule(labels[row], small, origins)} "
            f"diverges from the in-order fold at leaf {path} "
            f"(found as {_format_schedule(labels[row], seqs[row], origins)})",
        ))
    return findings


def check_all_schedules(max_ops: int = MAX_OPS, device="cuda") -> List[Finding]:
    out: List[Finding] = []
    for kind in merge_kinds():
        out.extend(generator_degeneracy(kind, device=device))
        out.extend(check_kind_schedules(kind, max_ops=max_ops, device=device))
    return out


# ---- generator degeneracy (the vacuity gate) ------------------------------

def generator_degeneracy(kind: MergeKind, device="cuda") -> List[Finding]:
    """A degenerate small-domain generator vacates both the law engine and
    the schedule checker: fail loudly on an empty domain or on fewer than
    2 distinct canonical states."""
    states = kind.states(device=device)
    if not states:
        return [Finding(
            "generator-degenerate", kind.name,
            "small-domain generator yields NO states — the law engine "
            "and schedule checker have nothing to check",
        )]
    canon = kind.canon or (lambda s: s)
    distinct = {_state_bytes(canon(s)) for s in states}
    if len(distinct) < 2:
        return [Finding(
            "generator-degenerate", kind.name,
            f"small-domain generator yields {len(states)} state(s) but "
            f"only {len(distinct)} distinct canonical point(s) — every "
            "law holds vacuously on a one-point domain; make the "
            "generator mint genuinely different states",
        )]
    return []


__all__ = [
    "MAX_OPS", "MAX_REPLICAS", "causal_schedules", "check_all_schedules",
    "check_kind_schedules", "derive_ops", "enumerate_schedules", "generator_degeneracy",
    "minimize_schedule",
]
