"""The fault plane on the port's replica streams and bootstrap wire against
the JAX package's, tolerance 0, on P = 4 virtual ranks vs
``make_mesh(4, 1)`` (``make_mesh(4, 2)`` for the element-sharded plan):
the four stream plans under ``faults=`` (accumulator, flags, the
``StreamFaultReport`` and every counted Telemetry field), the re-stream of
the lost blocks with ``init=`` the faulted accumulator equal to the
unfaulted pass, the partial report an interrupt carries, the sparse
stream's ``widen_policy=`` (``stream.widen_retries`` counted, the widened
accumulator equal to the JAX one), and the faulted ``bootstrap`` (the
landed state and the report field for field) with
``bootstrap_rejects_corruption`` True for the honest receiver and False
for ``verify_checksums=False``, in both packages."""

import functools

import numpy as np
import pytest

from crdt_tpu.elastic import ElasticPolicy as RefPolicy
from crdt_tpu.faults import FaultPlan as RefPlan
from crdt_tpu.parallel import (
    iter_blocks as ref_iter_blocks,
    make_mesh,
    mesh_stream_fold as ref_stream_dense,
    mesh_stream_fold_sparse as ref_stream,
    mesh_stream_fold_sparse_mvmap as ref_stream_mvmap,
    mesh_stream_fold_sparse_sharded as ref_stream_sharded,
    split_segments as ref_split_segments,
)
from crdt_tpu.scaleout import bootstrap as ref_bootstrap
from crdt_tpu.scaleout import bootstrap_rejects_corruption as ref_rejects
from crdt_tpu_torch.convert import orswot_from_numpy
from crdt_tpu_torch.elastic import ElasticPolicy
from crdt_tpu_torch.faults import FaultPlan
from crdt_tpu_torch.parallel import (
    StreamFaultReport,
    StreamInterrupted,
    VirtualMesh,
    iter_blocks,
    mesh_stream_fold,
    mesh_stream_fold_sparse,
    mesh_stream_fold_sparse_mvmap,
    mesh_stream_fold_sparse_sharded,
    split_segments,
)
from crdt_tpu_torch.scaleout import bootstrap, bootstrap_rejects_corruption
from crdt_tpu_torch.utils.metrics import metrics

from chip_smoke import kind_arrays, kind_state
from test_torch_convert import ref_numpy as dense_numpy
from test_torch_crashpoints import _ref
from test_torch_faults_ring import assert_leaves
from test_torch_recover import assert_tree
from test_torch_sparse_orswot import ref_states, to_port
from test_torch_telemetry import assert_tel

P = 4
LOSSY = dict(seed=5, drop=0.4, corrupt=0.4)


def counter(name):
    return metrics.snapshot()["counters"].get(name, 0)


def stream_case(plan):
    """``(ref_run(blocks_rows, **kw), port_run(blocks_rows, **kw))`` of one
    stream plan over a seeded population."""
    if plan == "sparse":
        states = ref_states(3, n=16)
        return (lambda rows, **kw: ref_stream(ref_iter_blocks(states, rows), make_mesh(P, 1),
                                              **kw),
                lambda rows, **kw: mesh_stream_fold_sparse(iter_blocks(to_port(states), rows),
                                                           VirtualMesh(P, "cpu"), **kw))
    if plan == "dense":
        from test_torch_collectives import replicas
        from test_torch_convert import ref_state

        arrays = replicas(4, n=16)
        return (lambda rows, **kw: ref_stream_dense(
                    ref_iter_blocks(ref_state(arrays), rows), make_mesh(P, 1), **kw),
                lambda rows, **kw: mesh_stream_fold(
                    iter_blocks(orswot_from_numpy(arrays, "cpu"), rows), VirtualMesh(P, "cpu"),
                    **kw))
    if plan == "mvmap":
        from test_torch_sparse_mvmap import pair, population

        r, p = pair(population(21, n=16)[0])
        return (lambda rows, **kw: ref_stream_mvmap(ref_iter_blocks(r.state, rows),
                                                    make_mesh(P, 1), sibling_cap=6, **kw),
                lambda rows, **kw: mesh_stream_fold_sparse_mvmap(
                    iter_blocks(p.state, rows), VirtualMesh(P, "cpu"), sibling_cap=6, **kw))
    states = ref_states(24, n=16)
    sharded = ref_split_segments(states, 2)
    port = split_segments(to_port(states), 2)
    return (lambda rows, **kw: ref_stream_sharded(ref_iter_blocks(sharded, rows),
                                                  make_mesh(P, 2), **kw),
            lambda rows, **kw: mesh_stream_fold_sparse_sharded(
                iter_blocks(port, rows), VirtualMesh(P, "cpu", s=2), **kw))


def assert_report(got, want):
    assert isinstance(got, StreamFaultReport)
    assert (got.dropped_blocks, got.rejected_blocks, got.lost_blocks) == \
        (want.dropped_blocks, want.rejected_blocks, want.lost_blocks)


@pytest.mark.parametrize("plan", ["sparse", "dense", "mvmap", "sharded"])
def test_a_faulted_stream_matches_the_jax_stream(plan):
    ref_run, port_run = stream_case(plan)
    want = ref_run(2, faults=RefPlan(**LOSSY), telemetry=True)
    before = (counter("faults.packets_dropped"), counter("faults.packets_rejected"))
    got = port_run(2, faults=FaultPlan(**LOSSY), telemetry=True)
    assert len(got) == len(want) == 4
    assert_leaves(got[0], want[0], f"{plan} accumulator")
    assert_leaves(got[1], want[1], f"{plan} flags")
    assert_report(got[3], want[3])
    assert_tel(got[2], want[2], f"{plan} telemetry")
    assert got[3].lost_blocks, "the plan must lose blocks"
    assert (counter("faults.packets_dropped") - before[0],
            counter("faults.packets_rejected") - before[1]) == \
        (len(got[3].dropped_blocks), len(got[3].rejected_blocks))
    # Without the sidecar the report comes back third.
    acc, _, report = port_run(2, faults=FaultPlan(**LOSSY))
    assert_leaves(acc, want[0])
    assert_report(report, want[3])


def test_re_streaming_the_lost_blocks_heals_to_the_unfaulted_pass():
    states = ref_states(3, n=16)
    port = to_port(states)
    blocks = list(iter_blocks(port, 2))
    pm = VirtualMesh(P, "cpu")
    acc, _, report = mesh_stream_fold_sparse(iter(blocks), pm, faults=FaultPlan(**LOSSY))
    assert report.lost_blocks
    healed, _ = mesh_stream_fold_sparse(iter([blocks[i] for i in report.lost_blocks]), pm,
                                        init=acc)
    clean, _ = mesh_stream_fold_sparse(iter(blocks), pm)
    want, _ = ref_stream(ref_iter_blocks(states, 2), make_mesh(P, 1))
    assert_leaves(healed, want, "healed")
    assert_leaves(clean, want, "unfaulted")


def test_an_interrupted_faulted_stream_carries_the_partial_report():
    states = ref_states(3, n=16)
    blocks = list(iter_blocks(to_port(states), 2))
    ref_blocks = list(ref_iter_blocks(states, 2))

    def dying(source, k):
        yield from source[:k]
        raise OSError("block source died mid-stream")

    with pytest.raises(StreamInterrupted) as got:
        mesh_stream_fold_sparse(dying(blocks, 6), VirtualMesh(P, "cpu"), faults=FaultPlan(**LOSSY))
    from crdt_tpu.parallel import StreamInterrupted as RefInterrupted

    with pytest.raises(RefInterrupted) as want:
        ref_stream(dying(ref_blocks, 6), make_mesh(P, 1), faults=RefPlan(**LOSSY))
    assert got.value.blocks_done == want.value.blocks_done == 6
    assert_report(got.value.fault_report, want.value.fault_report)
    assert got.value.fault_report.lost_blocks
    assert_leaves(got.value.acc, want.value.acc, "interrupted accumulator")
    with pytest.raises(StreamInterrupted) as clean:
        mesh_stream_fold_sparse(dying(blocks, 6), VirtualMesh(P, "cpu"))
    assert clean.value.fault_report is None


def test_widen_policy_recovers_a_mid_stream_overflow_like_jax():
    """Blocks of distinct actors on disjoint elements overflow a small dot
    cap once joined: the stream widens the accumulator and re-enters,
    counting ``stream.widen_retries``; the result is the JAX stream's."""
    from crdt_tpu_torch.convert import sparse_orswot_from_numpy
    from test_stream import _disjoint_blocks
    from test_torch_sparse_orswot import ref_numpy

    ref_blocks = _disjoint_blocks(n_blocks=4, cap=4)
    blocks = [sparse_orswot_from_numpy(ref_numpy(b), device="cpu") for b in ref_blocks]
    pm = VirtualMesh(P, "cpu")
    _, of = mesh_stream_fold_sparse(iter(blocks), pm)
    assert bool(of.any()), "the setup must overflow"
    want = ref_stream(iter(ref_blocks), make_mesh(P, 1), telemetry=True, widen_policy=RefPolicy())
    before = counter("stream.widen_retries")
    got = mesh_stream_fold_sparse(iter(blocks), pm, telemetry=True, widen_policy=ElasticPolicy())
    assert counter("stream.widen_retries") > before
    assert_leaves(got[0], want[0], "widened accumulator")
    assert_leaves(got[1], want[1], "flags")
    assert not bool(got[1].any())
    assert_tel(got[2], want[2], "telemetry")
    # Under faults too: the same fates, the same widened accumulator.
    want = ref_stream(iter(ref_blocks), make_mesh(P, 1), widen_policy=RefPolicy(),
                      faults=RefPlan(seed=3, drop=0.3))
    got = mesh_stream_fold_sparse(iter(blocks), pm, widen_policy=ElasticPolicy(),
                                  faults=FaultPlan(seed=3, drop=0.3))
    assert_leaves(got[0], want[0], "faulted widened accumulator")
    assert_report(got[2], want[2])
    with pytest.raises(RuntimeError, match="still overflowing after 0 migrations"):
        mesh_stream_fold_sparse(iter(blocks), pm,
                                widen_policy=ElasticPolicy(max_migrations=0))
    with pytest.raises(TypeError):
        mesh_stream_fold_sparse_sharded(iter([]), VirtualMesh(P, "cpu", s=2),
                                        widen_policy=ElasticPolicy())


def test_a_dense_stream_s_widen_policy_matches_like_jax():
    """The dense plan widens its parked-remove buffer mid-stream."""
    from crdt_tpu.models.orswot import BatchedOrswot as RefOrswot
    from test_elastic import _orswot_pures

    reps = _orswot_pures(8, parked_each=2)
    ref_model = RefOrswot.from_pure(reps, deferred_cap=2, n_members=8, n_actors=16)
    arrays = dense_numpy(ref_model.state)
    port = orswot_from_numpy(arrays, "cpu")
    want = ref_stream_dense(ref_iter_blocks(ref_model.state, 4), make_mesh(P, 1),
                            widen_policy=RefPolicy())
    got = mesh_stream_fold(iter_blocks(port, 4), VirtualMesh(P, "cpu"),
                           widen_policy=ElasticPolicy())
    assert_leaves(got[0], want[0], "dense widened accumulator")
    assert_leaves(got[1], want[1], "dense flags")


# ---- the faulted bootstrap ----------------------------------------------------------

BOOT_KINDS = ("orswot", "sparse_orswot", "map", "mvreg")
BOOT_PLANS = (dict(seed=23, corrupt=0.7), dict(seed=4, drop=0.5, corrupt=0.3))


@pytest.mark.parametrize("plan", BOOT_PLANS, ids=["corrupt", "drop_corrupt"])
@pytest.mark.parametrize("kind", BOOT_KINDS)
def test_a_faulted_bootstrap_matches_jax(kind, plan):
    arrays = kind_arrays(kind, np.random.default_rng(3))
    live = kind_state(kind, arrays, "cpu")
    got, rep = bootstrap(kind, live, faults=FaultPlan(**plan), segment_cap=3, max_attempts=256)
    want, ref_rep = ref_bootstrap(kind, _ref(kind, arrays), faults=RefPlan(**plan),
                                  segment_cap=3, max_attempts=256)
    assert tuple(rep) == tuple(ref_rep)
    assert rep.reshipped == rep.dropped + rep.rejected
    assert_tree(got, want)
    assert_tree(got, _ref(kind, arrays))


def test_bootstrap_rejects_corruption_passes_the_honest_receiver_only():
    """The detector's live state is the JAX merge-kind registry's last
    ``orswot`` example, and it passes the honest receiver only."""
    from crdt_tpu.analysis.registry import get_merge_kind

    from crdt_tpu_torch.scaleout.bootstrap import _orswot_examples

    assert_tree(_orswot_examples(device="cpu")[1], get_merge_kind("orswot").states()[-1])
    assert bootstrap_rejects_corruption(bootstrap, device="cpu") is ref_rejects(ref_bootstrap) is True
    blind = functools.partial(bootstrap, verify_checksums=False)
    ref_blind = functools.partial(ref_bootstrap, verify_checksums=False)
    assert bootstrap_rejects_corruption(blind, device="cpu") is ref_rejects(ref_blind) is False


def test_a_bootstrap_out_of_attempts_fails_like_jax():
    from crdt_tpu.scaleout import BootstrapFailed as RefFailed

    from crdt_tpu_torch.scaleout import BootstrapFailed

    arrays = kind_arrays("map", np.random.default_rng(4))
    kw = dict(segment_cap=2, max_attempts=2)
    with pytest.raises(RefFailed) as want:
        ref_bootstrap("map", _ref("map", arrays), faults=RefPlan(seed=1, drop=1.0), **kw)
    with pytest.raises(BootstrapFailed) as got:
        bootstrap("map", kind_state("map", arrays, "cpu"), faults=FaultPlan(seed=1, drop=1.0),
                  **kw)
    assert str(got.value) == str(want.value)
