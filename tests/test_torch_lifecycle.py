"""The port's actor lifecycle (``crdt_tpu_torch.lifecycle``) against the
JAX package's ``lifecycle.py``: the cases of the reference's
``tests/test_lifecycle.py``, each run in both packages on the same
counters, lanes compared bit for bit (dtypes included) and reads and
``reclaim.*`` counters equal."""

import numpy as np
import pytest
import torch

from crdt_tpu import lifecycle as ref_lc
from crdt_tpu.config import configured as ref_configured
from crdt_tpu.models import BatchedGCounter as RefG, BatchedPNCounter as RefPN
from crdt_tpu.models import BatchedVClock as RefVC
from crdt_tpu.pure.gcounter import GCounter as RefGCounter
from crdt_tpu.utils import Interner as RefInterner
from crdt_tpu.utils.metrics import metrics as ref_metrics
from crdt_tpu_torch import lifecycle as lc
from crdt_tpu_torch.config import configured
from crdt_tpu_torch.models import BatchedGCounter, BatchedPNCounter, BatchedVClock
from crdt_tpu_torch.pure.gcounter import GCounter
from crdt_tpu_torch.traits import CounterSaturation
from crdt_tpu_torch.utils import Interner
from crdt_tpu_torch.utils.metrics import metrics

from test_torch_convert import leaf_numpy


def _lanes(model):
    """Every clock plane of a counter model, as numpy."""
    clocks = lc._vclock_models(model) if isinstance(model, (BatchedGCounter, BatchedPNCounter,
                                                            BatchedVClock)) \
        else ref_lc._vclock_models(model)
    out = []
    for vc in clocks:
        x = vc.clocks
        if isinstance(x, torch.Tensor):
            out.append(x.view(torch.int64).numpy().view(np.uint64) if x.dtype == torch.uint64
                       else leaf_numpy(x))
        else:
            out.append(np.asarray(x))
    return out


def assert_same(port, ref, what=""):
    g, w = _lanes(port), _lanes(ref)
    assert len(g) == len(w), what
    for x, y in zip(g, w):
        assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=what)
    assert list(port.actors.items()) == list(ref.actors.items()), what


def _near_saturated():
    """A GCounter whose 'old' lane sits at the u32 ceiling, in both packages."""
    p, r = GCounter(), RefGCounter()
    for c in (p, r):
        c.inner.dots["old"] = 2**32 - 1
        c.inner.dots["young"] = 7
    return BatchedGCounter.from_pure([p, p.clone()], device="cpu"), RefG.from_pure([r, r.clone()])


def test_strict_mode_traps_saturation():
    m, _ = _near_saturated()
    with configured(strict=True):
        with pytest.raises(CounterSaturation):
            m.inc(0, "old")


def test_widen_counters_lifts_ceiling_bit_identically():
    m, r = _near_saturated()
    before = [m.to_pure(i) for i in range(m.n_replicas)]
    with configured(counter_dtype="uint64", strict=True), \
            ref_configured(counter_dtype="uint64", strict=True):
        lc.widen_counters(m)
        ref_lc.widen_counters(r)
        assert m.inner.clocks.dtype == torch.uint64
        assert_same(m, r, "widened")
        assert [m.to_pure(i) for i in range(m.n_replicas)] == before
        m.inc(0, "old")
        r.inc(0, "old")
        assert_same(m, r, "inc past 2^32")
        assert m.to_pure(0).read() == (2**32 - 1) + 1 + 7 == r.to_pure(0).read()


def test_widen_requires_x64():
    m, r = _near_saturated()
    with pytest.raises(RuntimeError, match="x64"):
        lc.widen_counters(m)
    with pytest.raises(RuntimeError, match="x64"):
        ref_lc.widen_counters(r)


def test_retire_actor_preserves_reads_exactly():
    m, r = _near_saturated()
    reads = [m.read(i) for i in range(m.n_replicas)]
    fold_before = m.fold_read()
    lc.retire_actor(m, "old")
    ref_lc.retire_actor(r, "old")
    assert_same(m, r, "retired")
    assert [m.read(i) for i in range(m.n_replicas)] == reads
    assert m.fold_read() == fold_before == r.fold_read()
    col = leaf_numpy(m.inner.clocks)
    assert (col[:, m.actors.id_of("old")] == 0).all()
    assert (col[:, m.actors.id_of(lc.RETIRED)] == 2**32 - 1).all()


def test_retire_diverged_lane_refused():
    p1, p2 = GCounter(), GCounter()
    p1.inner.dots["a"] = 5
    p2.inner.dots["a"] = 9
    m = BatchedGCounter.from_pure([p1, p2], device="cpu")
    with pytest.raises(ValueError, match="converge"):
        lc.retire_actor(m, "a")
    with pytest.raises(TypeError):
        lc.retire_actor(BatchedVClock(2, actors=Interner(["a"]), device="cpu"), "a")
    with pytest.raises(TypeError):
        ref_lc.retire_actor(RefVC(2, actors=RefInterner(["a"])), "a")


def test_retire_then_compact_pncounter():
    m = BatchedPNCounter(2, actors=Interner(["a", "b", "c"]), n_actors=8, device="cpu")
    r = RefPN(2, actors=RefInterner(["a", "b", "c"]), n_actors=8)
    for model in (m, r):
        for row in range(2):
            model.inc(row, "a", 10)
            model.dec(row, "a", 3)
            model.inc(row, "b", 5)
    reads = [m.read(i) for i in range(2)]
    lc.retire_actor(m, "a")
    ref_lc.retire_actor(r, "a")
    assert_same(m, r, "retired")
    metrics.reset()
    ref_metrics.reset()
    lc.compact_actors(m)
    ref_lc.compact_actors(r)
    assert_same(m, r, "compacted")
    assert "a" not in m.actors and "c" not in m.actors and lc.RETIRED in m.actors
    assert m.p.clocks.shape[-1] == 8 and m.p.actors is m.n.actors
    assert [m.read(i) for i in range(2)] == reads
    for name in ("reclaim.reclaimed_slots", "reclaim.reclaimed_slots.actors",
                 "reclaim.reclaimed_bytes", "reclaim.shrink_events",
                 "reclaim.shrink_events.actors"):
        assert (metrics.snapshot()["counters"][name]
                == ref_metrics.snapshot()["counters"][name]), name
    for model in (m, r):
        model.inc(0, "b", 2)
        model.inc(0, "fresh", 4)
    assert_same(m, r, "after compaction")
    assert m.read(0) == reads[0] + 6


def test_compact_never_used_lanes_only():
    m = BatchedGCounter(2, actors=Interner(["a", "b"]), n_actors=16, device="cpu")
    r = RefG(2, actors=RefInterner(["a", "b"]), n_actors=16)
    for model in (m, r):
        model.inc(0, "a")
        model.inc(1, "a")
    metrics.reset()
    lc.compact_actors(m)
    ref_lc.compact_actors(r)
    assert_same(m, r, "compacted")
    assert len(m.actors) == 1 and m.inner.clocks.shape == (2, 16)
    assert m.read(0) == 1 and m.read(1) == 1
    # Nothing left to free: no counts.
    metrics.reset()
    lc.compact_actors(m)
    assert "reclaim.shrink_events" not in metrics.snapshot()["counters"]
