"""The lattice-law engine — the port of the JAX package's
``analysis/laws.py``.

For every merge kind (``registry.merge_kinds``) this verifies, bit-exactly
on canonical forms, the algebraic laws the framework leans on:

- **idempotence**      ``a ∨ a = a``
- **commutativity**    ``a ∨ b = b ∨ a``
- **associativity**    ``(a ∨ b) ∨ c = a ∨ (b ∨ c)``
- **identity**         ``a ∨ ⊥ = a``
- **δ-inflation**      ``(a ∨ b) ∨ a = a ∨ b`` and ``(a ∨ b) ∨ b = a ∨ b``

over the kind's small domain (and its sampled larger one, where it has
one), plus the compaction-invariance laws (``reclaim/``) and the
join-decomposition laws (``delta_opt/``).

Execution: the M seed states are stacked and every law is phrased over the
M×M pair grid. The JAX engine runs one ``jax.vmap(join)`` over the grid;
here the joins take any leading batch axes, so ONE join call on the
stacked ``[M², ...]`` batch yields the pair table ``R[i, j] = S[i] ∨
S[j]`` (idempotence on the diagonal, commutativity on the transpose,
identity on column 0), and two more batched calls settle associativity
and inflation. Everything runs on ``device``; only the mismatching row
indices come back to the host.

A :class:`~.report.Finding` carries the JAX engine's ``check``,
``subject`` and ``detail`` — the first offending index pair or triple and
the first mismatching state leaf, named by the JAX tree path — and no
program slice (``jaxpr_slice`` stays empty).
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from .._dtypes import bits, from_wide, to_wide
from ..ops.lattice import tree_leaves, tree_map
from .registry import MergeKind, merge_kinds
from .report import Finding


def _norm_join(join):
    """Normalise ``join`` to ``(state, flags|None)``: the kinds return
    either a bare state (gset, vclock) or ``(state, flags)``."""
    def normed(a, b):
        out = join(a, b)
        if isinstance(out, tuple) and len(out) == 2:
            return out
        return out, None

    return normed


def _stack(states: Sequence[Any]):
    return tree_map(lambda *xs: torch.stack([bits(x) for x in xs]).view(xs[0].dtype), *states)


def _index(idx, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64), device=like.device)


def _take(stacked, idx):
    first = tree_leaves(stacked)[0]
    i = _index(idx, first)
    return tree_map(lambda x: bits(x)[i].view(x.dtype), stacked)


def _leaf_paths(tree, prefix: str = "") -> List[str]:
    """The JAX tree path of every leaf (``jax.tree_util.keystr``):
    ``.field`` for a NamedTuple field, ``[i]`` for a tuple item."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    if hasattr(tree, "_fields"):
        return [p for f, x in zip(tree._fields, tree) for p in _leaf_paths(x, f"{prefix}.{f}")]
    return [p for i, x in enumerate(tree) for p in _leaf_paths(x, f"{prefix}[{i}]")]


def _dtype_name(x: torch.Tensor) -> str:
    return str(x.dtype).replace("torch.", "")


def _mismatches(got, want) -> List[tuple]:
    """Compare two stacked trees leaf-wise; return ``[(batch_index,
    leaf_path), ...]`` for the first few differing batch rows of each
    leaf."""
    out = []
    for path, g, w in zip(_leaf_paths(got), tree_leaves(got), tree_leaves(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            out.append((-1, f"{path}: shape/dtype {tuple(g.shape)}/{_dtype_name(g)} vs "
                            f"{tuple(w.shape)}/{_dtype_name(w)}"))
            continue
        neq = bits(g) != bits(w)
        if g.dim() == 0:
            rows = [0] if bool(neq) else []
        else:
            rows = torch.nonzero(neq.reshape(neq.shape[0], -1).any(dim=1)).flatten().tolist()
        for r in rows[:3]:
            out.append((int(r), path))
    return out


def _grid(m: int):
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    return ii.ravel(), jj.ravel()


def check_kind(kind: MergeKind, big: bool = True, device="cuda") -> List[Finding]:
    """Run every law over the kind's domains, built on ``device``."""
    findings = _check_domain(kind, kind.states(device=device), "small")
    if big and kind.big_states is not None:
        findings += _check_domain(kind, kind.big_states(device=device), "sampled")
    return findings


def check_all(big: bool = True, device="cuda") -> List[Finding]:
    out: List[Finding] = []
    for kind in merge_kinds():
        out.extend(check_kind(kind, big=big, device=device))
    # The reclaim/ gate rides the same section.
    out.extend(check_compaction_all(device=device))
    return out


# ---- the compaction-invariance law (reclaim/) -----------------------------

def check_compaction_kind(kind: MergeKind, comp=None, device="cuda") -> List[Finding]:
    """The two halves of the compaction-invariance law over the kind's
    small domain, bit-exact on observable reads:

    - **read invariance**   ``observe(compact(s)) == observe(s)``;
    - **merge commutation** ``observe(compact(a ∨ b)) ==
      observe(compact(a) ∨ compact(b))``.

    The frontier is the per-actor min over every seed's top clock, so every
    seed is a frontier participant, as on a live mesh."""
    from ..delta_opt.decompose import get_compactor

    if comp is None:
        try:
            comp = get_compactor(kind.name)
        except KeyError:
            return [Finding(
                "compact-coverage", kind.name,
                "merge kind has no registered compactor "
                "(register_compactor — see registry.py)",
            )]
    join = _norm_join(kind.join)
    seeds = kind.states(device=device)
    frontier = None
    if comp.top_of is not None:
        tops = torch.stack([to_wide(comp.top_of(s)) for s in seeds])
        frontier = from_wide(tops.amin(dim=0), comp.top_of(seeds[0]).dtype)

    def compact1(s):
        return comp.compact(s, frontier)[0]

    findings: List[Finding] = []
    m = len(seeds)
    S = _stack(seeds)
    CS = compact1(S)

    def _report(check, got, want, describe):
        for row, path in _mismatches(got, want):
            i, j = describe(max(row, 0))
            pair = f"S{i}" + (f" ∨ S{j}" if j is not None else "")
            findings.append(Finding(
                check, kind.name,
                f"compact({pair}) observable mismatch at leaf {path}",
            ))
            break

    _report("compact-read-invariance", comp.observe(CS), comp.observe(S),
            lambda r: (int(r), None))

    def vj(a, b):
        return join(a, b)[0]

    ii, jj = _grid(m)
    joined = vj(_take(S, ii), _take(S, jj))
    _report(
        "compact-merge-commute",
        comp.observe(compact1(joined)),
        comp.observe(vj(_take(CS, ii), _take(CS, jj))),
        lambda r: (int(ii[r]), int(jj[r])),
    )
    return findings


def check_compaction_all(device="cuda") -> List[Finding]:
    out: List[Finding] = []
    for kind in merge_kinds():
        out.extend(check_compaction_kind(kind, device=device))
    return out


# ---- the join-decomposition laws (delta_opt/) -----------------------------

def _decomposer_fns(dec):
    """``(decompose(s, since), reconstruct(since, d))`` over ``[N, ...]``
    batches: the kind's split/unsplit row diff, or a twin's own pair."""
    from ..delta_opt.decompose import decompose, reconstruct

    if getattr(dec, "decompose", None) is not None:
        return dec.decompose, dec.reconstruct
    return (lambda s, o: decompose(dec, s, o, batched=True),
            lambda o, d: reconstruct(dec, o, d))


def check_decomposition_kind(kind: MergeKind, dec=None, device="cuda") -> List[Finding]:
    """The two laws every join-irreducible decomposition must satisfy,
    bit-exact on raw tensors over the kind's small domain paired as
    ``(s, since) = (S[i] ∨ S[j], S[i])``:

    - **reconstruction**  ``join(decompose(s, since)) ⊔ since == s``;
    - **irredundancy**    dropping any single valid δ lane breaks
      reconstruction.

    ``dec`` overrides the kind's decomposer (the broken twins
    ``fixtures.LOSSY_DECOMPOSER`` / ``REDUNDANT_DECOMPOSER``)."""
    from ..delta_opt.decompose import KINDS, drop_lane

    if dec is None:
        try:
            dec = KINDS[kind.name]
        except KeyError:
            return [Finding(
                "decomp-coverage", kind.name,
                "merge kind has no registered decomposition "
                "(register_decomposition — see registry.py)",
            )]
    decompose, reconstruct = _decomposer_fns(dec)
    join = _norm_join(kind.join)
    seeds = kind.states(device=device)
    m = len(seeds)
    S = _stack(seeds)
    ii, jj = _grid(m)
    A, B = _take(S, ii), _take(S, jj)
    R = join(A, B)[0]
    D = decompose(R, A)
    findings: List[Finding] = []

    got = reconstruct(A, D)
    for row, path in _mismatches(got, R):
        i, j = int(ii[max(row, 0)]), int(jj[max(row, 0)])
        findings.append(Finding(
            "decomp-reconstruction", kind.name,
            f"join(decompose(S{i} ∨ S{j}, S{i})) over S{i} does not "
            f"reproduce the state at leaf {path} — the decomposition "
            "is lossy",
        ))
        break

    def _eq_rows(got_l) -> np.ndarray:
        eq = torch.ones(m * m, dtype=torch.bool, device=D.valid.device)
        for g, w in zip(tree_leaves(got_l), tree_leaves(R)):
            eq &= (bits(g).reshape(g.shape[0], -1) == bits(w).reshape(w.shape[0], -1)).all(dim=1)
        return eq.cpu().numpy()

    valid_np = D.valid.cpu().numpy()
    for lane in range(valid_np.shape[-1]):
        if not valid_np[:, lane].any():
            continue
        still_exact = _eq_rows(reconstruct(A, drop_lane(D, lane))) & valid_np[:, lane]
        if still_exact.any():
            p0 = int(np.nonzero(still_exact)[0][0])
            findings.append(Finding(
                "decomp-irredundancy", kind.name,
                f"δ lane {lane} of decompose(S{int(ii[p0])} ∨ "
                f"S{int(jj[p0])}, S{int(ii[p0])}) is covered by the join "
                "of the others (dropping it still reconstructs exactly) "
                "— the decomposition is not irredundant",
            ))
            break
    return findings


def check_decomposition_all(device="cuda") -> List[Finding]:
    out: List[Finding] = []
    for kind in merge_kinds():
        out.extend(check_decomposition_kind(kind, device=device))
    return out


def pair_table(kind: MergeKind, seeds: list):
    """The canonicalised pair table ``canon(S[i] ∨ S[j])`` over the M×M
    grid, row-major, and the flags of its joins (None for a flagless
    kind)."""
    canon = kind.canon or (lambda s: s)
    S = _stack(seeds)
    ii, jj = _grid(len(seeds))
    R, flags = _norm_join(kind.join)(_take(S, ii), _take(S, jj))
    return canon(R), flags


def _check_domain(kind: MergeKind, seeds: list, domain: str) -> List[Finding]:
    join = _norm_join(kind.join)
    canon = kind.canon or (lambda s: s)
    findings: List[Finding] = []

    m = len(seeds)
    if m < 3:
        return [Finding(
            "domain", f"{kind.name}[{domain}]",
            f"generator produced only {m} states (need >= 3)",
        )]

    S = _stack(seeds)
    flagged = []

    def vj(a, b):
        """Batched join, accumulating the overflow/conflict flags of EVERY
        law's joins (the double joins can overflow where single joins did
        not)."""
        out, flags = join(a, b)
        if flags is not None:
            flagged.append(torch.any(flags))
        return out, flags

    ii, jj = _grid(m)
    A, B = _take(S, ii), _take(S, jj)
    R, _ = vj(A, B)                          # R[p] = join(S[ii[p]], S[jj[p]])
    CR = canon(R)
    CS = canon(S)

    def _report(check: str, got, want, describe) -> None:
        for row, path in _mismatches(got, want):
            i, j, k = describe(max(row, 0))
            trip = f"(S{i} ∨ S{j}" + (f") ∨ S{k}" if k is not None else ")")
            findings.append(Finding(
                check, f"{kind.name}[{domain}]",
                f"{trip} mismatch at leaf {path}",
            ))
            break  # one finding per law per domain is enough signal

    pair_at = {(int(ii[p]), int(jj[p])): p for p in range(m * m)}

    def idx(pairs):
        return np.array([pair_at[p] for p in pairs])

    # Idempotence: the diagonal of R against the seeds.
    diag = idx([(i, i) for i in range(m)])
    _report("idempotence", _take(CR, diag), CS, lambda r: (int(r), int(r), None))

    # Commutativity: R against its transpose.
    trans = idx([(int(j), int(i)) for i, j in zip(ii, jj)])
    _report("commutativity", CR, _take(CR, trans), lambda r: (int(ii[r]), int(jj[r]), None))

    # Identity absorption: column 0 (seeds[0] is the bottom).
    col0 = idx([(i, 0) for i in range(m)])
    _report("identity", _take(CR, col0), CS, lambda r: (int(r), 0, None))

    # Associativity over the triple family (i, j, k = (i+j+1) mod m):
    # (R[i,j] ∨ S[k]) against (S[i] ∨ R[j,k]), batched at m².
    kk = (ii + jj + 1) % m
    left, _ = vj(R, _take(S, kk))
    right, _ = vj(A, _take(R, idx(list(zip(jj.tolist(), kk.tolist())))))
    _report("associativity", canon(left), canon(right),
            lambda r: (int(ii[r]), int(jj[r]), int(kk[r])))

    # δ-inflation: re-joining either operand is a no-op on the join.
    for operand, describe in (
        (A, lambda r: (int(ii[r]), int(jj[r]), int(ii[r]))),
        (B, lambda r: (int(ii[r]), int(jj[r]), int(jj[r]))),
    ):
        again, _ = vj(R, operand)
        _report("delta-inflation", canon(again), CR, describe)

    if flagged and bool(torch.stack(flagged).any()):
        findings.append(Finding(
            "domain-overflow", f"{kind.name}[{domain}]",
            "a capacity/conflict flag fired inside the law domain "
            "(possibly only in a double join) — laws are only "
            "meaningful below capacity; widen the generator's caps",
            severity="warning",
        ))

    return findings


__all__ = [
    "check_all", "check_compaction_all", "check_compaction_kind", "check_decomposition_all",
    "check_decomposition_kind", "check_kind", "pair_table",
]
