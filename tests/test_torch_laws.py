"""The port's lattice-law engine (``crdt_tpu_torch.analysis``: ``canon``,
``registry``, ``laws``, ``fixtures``) against the JAX package's.

- The registry holds the JAX registry's twelve merge kinds, each with the
  same ``canon``, ``big_states`` and ``deltas`` presence.
- Every kind's small domain (and sampled big domain) equals the JAX one
  leaf for leaf, and so does its canonicalised pair table
  ``canon(S[i] ∨ S[j])`` over the M×M grid — the JAX tables built once per
  module.
- The port's law, compaction and decomposition checks return ``[]``.
- Every broken twin gives the JAX finding's ``(check, subject, detail)``.
"""

import numpy as np
import pytest

from crdt_tpu_torch.analysis import fixtures, laws
from crdt_tpu_torch.analysis.registry import (
    get_merge_kind, merge_kinds, uncompactable_kinds, undecomposable_kinds,
)
from crdt_tpu_torch.convert import leaf_to_numpy
from crdt_tpu_torch.ops.lattice import tree_leaves

CPU = "cpu"
KIND_NAMES = [k.name for k in merge_kinds()]


def _jax_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    return [leaf_to_numpy(x) for x in tree_leaves(tree)]


def _assert_leaves_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i, g.shape, w.shape, g.dtype,
                                                           w.dtype)
        assert np.array_equal(g, w), (what, i)


@pytest.fixture(scope="module")
def jax_tables():
    """The JAX package's domains and canonicalised pair tables, per kind
    and domain: ``{(name, domain): (seed leaves, pair-table leaves)}``."""
    import jax

    from crdt_tpu.analysis import laws as ref_laws
    from crdt_tpu.analysis.registry import merge_kinds as ref_kinds

    out = {}
    for kind in ref_kinds():
        doms = [("small", kind.states())]
        if kind.big_states is not None:
            doms.append(("sampled", kind.big_states()))
        join = ref_laws._norm_join(kind.join)
        canon = jax.jit(kind.canon) if kind.canon else (lambda s: s)
        vj = jax.jit(jax.vmap(lambda a, b: join(a, b)[0]))
        for domain, seeds in doms:
            m = len(seeds)
            ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
            S = ref_laws._stack(seeds)
            table = canon(vj(ref_laws._take(S, ii.ravel()), ref_laws._take(S, jj.ravel())))
            out[(kind.name, domain)] = ([_jax_leaves(s) for s in seeds], _jax_leaves(table))
    return out


def test_the_registry_holds_the_jax_kinds():
    from crdt_tpu.analysis.registry import merge_kinds as ref_kinds

    def shape(k):
        return (k.name, k.canon is not None, k.big_states is not None, k.deltas is not None,
                k.apply is not None)

    assert [shape(k) for k in merge_kinds()] == [shape(k) for k in ref_kinds()]
    assert len(KIND_NAMES) == 12
    assert undecomposable_kinds() == [] and uncompactable_kinds() == []


@pytest.mark.parametrize("name", KIND_NAMES)
def test_domains_and_pair_tables_equal_the_jax_ones(name, jax_tables):
    kind = get_merge_kind(name)
    doms = [("small", kind.states(device=CPU))]
    if kind.big_states is not None:
        doms.append(("sampled", kind.big_states(device=CPU)))
    assert {(name, d) for d, _ in doms} == {k for k in jax_tables if k[0] == name}
    for domain, seeds in doms:
        want_seeds, want_table = jax_tables[(name, domain)]
        assert len(seeds) == len(want_seeds)
        for i, (s, w) in enumerate(zip(seeds, want_seeds)):
            _assert_leaves_equal(_port_leaves(s), w, (name, domain, f"S{i}"))
        table, _flags = laws.pair_table(kind, seeds)
        _assert_leaves_equal(_port_leaves(table), want_table, (name, domain, "pair table"))


@pytest.mark.parametrize("name", KIND_NAMES)
def test_every_kind_passes_every_law(name):
    kind = get_merge_kind(name)
    assert laws.check_kind(kind, device=CPU) == []
    assert laws.check_compaction_kind(kind, device=CPU) == []
    assert laws.check_decomposition_kind(kind, device=CPU) == []


def test_the_all_sections_are_clean():
    assert laws.check_all(device=CPU) == []
    assert laws.check_decomposition_all(device=CPU) == []


def _triples(findings):
    return [(f.check, f.subject, f.detail, f.severity) for f in findings]


@pytest.mark.parametrize("twin", ["GOOD_MAX", "NOT_COMMUTATIVE", "NOT_IDEMPOTENT",
                                  "NOT_ASSOCIATIVE"])
def test_a_law_twin_gives_the_jax_findings(twin):
    from crdt_tpu.analysis import fixtures as ref_fixtures
    from crdt_tpu.analysis import laws as ref_laws

    ref = getattr(ref_fixtures, twin)
    want = _triples(ref_laws._check_domain(ref, ref.states(), "small"))
    kind = getattr(fixtures, twin)
    got = _triples(laws._check_domain(kind, kind.states(device=CPU), "small"))
    assert got == want
    assert bool(got) == (twin != "GOOD_MAX")


@pytest.mark.parametrize("comp", ["GOOD_COMPACTOR", "LOSSY_COMPACTOR"])
def test_a_compactor_twin_gives_the_jax_findings(comp):
    from crdt_tpu.analysis import fixtures as ref_fixtures
    from crdt_tpu.analysis import laws as ref_laws

    want = _triples(ref_laws.check_compaction_kind(ref_fixtures.GOOD_MAX,
                                                   comp=getattr(ref_fixtures, comp)))
    got = _triples(laws.check_compaction_kind(fixtures.GOOD_MAX, comp=getattr(fixtures, comp),
                                              device=CPU))
    assert got == want
    assert [f[0] for f in got] == ([] if comp == "GOOD_COMPACTOR"
                                   else ["compact-read-invariance"])


@pytest.mark.parametrize("dec,check", [("LOSSY_DECOMPOSER", "decomp-reconstruction"),
                                       ("REDUNDANT_DECOMPOSER", "decomp-irredundancy")])
def test_a_decomposer_twin_gives_the_jax_findings(dec, check):
    from crdt_tpu.analysis import fixtures as ref_fixtures
    from crdt_tpu.analysis import laws as ref_laws
    from crdt_tpu.analysis.registry import get_merge_kind as ref_kind

    want = _triples(ref_laws.check_decomposition_kind(ref_kind("orswot"),
                                                      dec=getattr(ref_fixtures, dec)))
    got = _triples(laws.check_decomposition_kind(get_merge_kind("orswot"),
                                                 dec=getattr(fixtures, dec), device=CPU))
    assert got == want and [f[0] for f in got] == [check]


def test_a_kind_without_a_compactor_or_decomposer_is_a_coverage_finding():
    bogus = fixtures.GOOD_MAX
    assert [f.check for f in laws.check_compaction_kind(bogus, device=CPU)] == \
        ["compact-coverage"]
    assert [f.check for f in laws.check_decomposition_kind(bogus, device=CPU)] == \
        ["decomp-coverage"]
