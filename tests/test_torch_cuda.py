"""The port on a CUDA device: kernels K1, K2 and K3 against their plain
versions, the models' folds on the card against the same folds on the
CPU (the sparse ORSWOT's too), the δ ring on the card (fused == layered ==
mesh_fold), with its ack window (K3's acked instance once per round; an
acked Map round with no host sync) and donation (outputs in the inputs'
storage), and the replica stream from pinned host blocks against the
stream from blocks on the card and on the CPU; the durability core on the
card (a logged ring and its recovery, a stream resumed from its log, the
crashpoint diagonal and a checkpoint round trip); the serving tier's slab
apply on the card against the CPU, and one dispatch under sync debug
"error"; the fan-out plane's K3 instance through ``mesh_fanout_push``
(once a dispatch, == its plain version and the CPU), a resync through
``bootstrap`` on card tensors, and the fan-out probes; the telemetry
sidecar of a small δ ring and of one fan-out dispatch on the card equal
to the same calls on the CPU; the nested kinds' fused level fold (K1 or
K2 on the leaf) and K3's nested instance against their plain routes, the
nested scenarios and a nested ring on the card equal to the CPU's.

Marked ``cuda``; every test skips without a device. It imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import random

import pytest
import torch

import chip_smoke
from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.models import BatchedMap, BatchedOrswot
from crdt_tpu_torch.ops.fold_kernels import (
    fold_cells, fold_cells_plain, fold_entries, fold_entries_plain,
)
from crdt_tpu_torch.ops import wire_kernels
from crdt_tpu_torch.ops.wire_kernels import wire_pack, wire_pack_many, wire_pack_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("r,e,a,high,n_passes", chip_smoke.K1_CASES)
def test_k1_matches_its_plain_version(card, r, e, a, high, n_passes):
    gen = torch.Generator(device=card).manual_seed(r * 1000 + e + a)
    top, ctr = chip_smoke.random_entries(r, e, a, high, gen, card)
    before = fold_entries.launches
    kt, kc = fold_entries(top, ctr, n_passes)
    pt, pc = fold_entries_plain(top, ctr, n_passes)
    torch.cuda.synchronize(card)
    assert fold_entries.launches == before + 1
    assert torch.equal(bits(kt), bits(pt)) and torch.equal(bits(kc), bits(pc))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_model_fold_on_the_card_matches_the_cpu(card, seed):
    rng = random.Random(seed)
    sites, _ = chip_smoke.mint_sites(rng, 5, 30)
    on_card = BatchedOrswot.from_pure(sites, device=card)
    on_cpu = BatchedOrswot.from_pure(sites, device="cpu")
    before = fold_entries.launches
    assert on_card.fold() == on_cpu.fold()
    assert fold_entries.launches == before + 1


@pytest.mark.parametrize("r,k,a,high", chip_smoke.K2_CASES)
def test_k2_matches_its_plain_version(card, r, k, a, high):
    gen = torch.Generator(device=card).manual_seed(r * 1000 + k + a)
    top, wctr = chip_smoke.random_cells(r, k, a, high, gen, card)
    before = fold_cells.launches
    kt, kw = fold_cells(top, wctr)
    pt, pw = fold_cells_plain(top, wctr)
    torch.cuda.synchronize(card)
    assert fold_cells.launches == before + 1
    assert torch.equal(bits(kt), bits(pt)) and torch.equal(bits(kw), bits(pw))


def test_k2_refuses_what_it_cannot_take(card):
    gen = torch.Generator(device=card).manual_seed(5)
    top, wctr = chip_smoke.random_cells(3, 64, 33, False, gen, card)
    with pytest.raises(ValueError, match="1..32"):
        fold_cells(top, wctr)
    top, wctr = chip_smoke.random_cells(3, 64, 8, False, gen, card)
    with pytest.raises(ValueError, match="contiguous"):
        fold_cells(top, wctr.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError, match="uint32"):
        fold_cells(top, wctr.view(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        fold_cells(top, wctr.cpu())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_map_fold_on_the_card_matches_the_cpu(card, seed):
    rng = random.Random(seed)
    sites, _ = chip_smoke.mint_map_sites(rng, 4, 30)
    on_card = BatchedMap.from_pure(sites, sibling_cap=4, device=card)
    on_cpu = BatchedMap.from_pure(sites, sibling_cap=4, device="cpu")
    before = fold_cells.launches
    assert on_card.fold() == on_cpu.fold()
    assert fold_cells.launches == before + 1


@pytest.mark.parametrize("lc", [1, 16, 33])
@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64])
@pytest.mark.parametrize("flags", sorted(chip_smoke.K3_FLAGS))
def test_k3_matches_its_plain_version(card, flags, dtype, lc):
    gen = torch.Generator(device=card).manual_seed(lc * 10 + len(flags))
    spec = chip_smoke.k3_spec(flags, lc)
    for n in (31, 1024):
        for b, layout in chip_smoke.K3_LAYOUTS:
            case = chip_smoke.random_wire_case(spec, b, n, dtype, gen, card)
            if b == 1:
                case = {k: v[0] for k, v in case.items()}
            if layout == "ring":
                case = chip_smoke.ring_layout(spec, case)
            before = wire_pack.launches
            got = wire_pack(spec, **case)
            want = wire_pack_plain(spec, **case)
            torch.cuda.synchronize(card)
            assert wire_pack.launches == before + 1
            for x, y in zip(got, want):
                assert x.shape == y.shape and torch.equal(bits(x), bits(y))


def _same(x, y):
    return all(u.shape == v.shape and torch.equal(bits(u), bits(v)) for u, v in zip(x, y))


def _wire_call(card, gen, flags, lc, b, n, layout, dtype=torch.uint32):
    spec = chip_smoke.k3_spec(flags, lc)
    case = chip_smoke.random_wire_case(spec, b, n, dtype, gen, card)
    if layout == "ring":
        case = chip_smoke.ring_layout(spec, case)
    return dict(case, spec=spec)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64])
@pytest.mark.parametrize("group", range(len(chip_smoke.K3_GROUPS)))
def test_k3_grouped_launch_matches_its_plain_version(card, group, dtype):
    gen = torch.Generator(device=card).manual_seed(group)
    calls = [_wire_call(card, gen, *inst, dtype=dtype) for inst in chip_smoke.K3_GROUPS[group]]
    before = wire_pack.launches
    outs = wire_pack_many(calls)
    torch.cuda.synchronize(card)
    assert wire_pack.launches == before + 1
    for call, out in zip(calls, outs):
        assert _same(out, wire_pack_plain(**call))


def _counters(card):
    stream = torch.cuda.current_stream(card).cuda_stream
    return wire_kernels._scratch[(card.index, stream)]


def test_k3_back_to_back_launches_leave_the_counters_at_0(card):
    """Batches of many blocks finish through the scratch counters: two
    launches in a row give the same stats, and the counters read 0."""
    gen = torch.Generator(device=card).manual_seed(11)
    call = _wire_call(card, gen, "gated", 16, 3, 300_001, "ring")
    want = wire_pack_plain(**call)
    first, second = wire_pack(**call), wire_pack(**call)
    torch.cuda.synchronize(card)
    assert _same(first, want) and _same(second, want)
    assert int(bits(want.nnz).sum()) > 0
    assert not _counters(card).any()


def test_k3_on_a_second_stream(card):
    gen = torch.Generator(device=card).manual_seed(12)
    calls = [_wire_call(card, gen, "gated_acked", 33, 2, 70_001, "rows"),
             _wire_call(card, gen, "plain", 7, 8, 5_000, "ring")]
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        on_side = wire_pack_many(calls)
        on_side_counters = _counters(card)
    on_default = wire_pack_many(calls)  # in flight beside the side stream's launch
    torch.cuda.synchronize(card)
    for call, x, y in zip(calls, on_side, on_default):
        want = wire_pack_plain(**call)
        assert _same(x, want) and _same(y, want)
    assert not on_side_counters.any() and not _counters(card).any()


def test_k3_graphs_of_one_capture_stream_replayed_on_two_streams(card):
    """Two graphs captured with ``torch.cuda.graph`` and no stream share
    torch's one capture stream. Each holds 64 K3 launches small enough
    (2 batches of 128 blocks) that the two graphs' launches run side by
    side when they are replayed on two streams, many times, with an eager
    launch on the capture stream beside them: every launch's nnz/chk
    equals the plain version's, so no two launches in flight share stats
    counters."""
    gen = torch.Generator(device=card).manual_seed(13)
    calls = [_wire_call(card, gen, "gated", 16, 2, 4096, "ring") for _ in range(2)]
    wants = [wire_pack_plain(**c) for c in calls]
    assert not torch.equal(bits(wants[0].chk), bits(wants[1].chk))
    graphs, outs = [], []
    for call in calls:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append([wire_pack(**call) for _ in range(64)])
        graphs.append(graph)
    capture_stream = torch.cuda.graph.default_capture_stream
    streams = [torch.cuda.Stream(card) for _ in graphs]
    for s in streams + [capture_stream]:
        s.wait_stream(torch.cuda.current_stream(card))
    stat = lambda o: torch.stack([bits(o.nnz), bits(o.chk)])  # noqa: E731
    seen = [[] for _ in graphs]
    eager = []
    for _ in range(50):
        for graph, s in zip(graphs, streams):  # both in flight before any read
            with torch.cuda.stream(s):
                graph.replay()
        with torch.cuda.stream(capture_stream):
            eager.append(wire_pack(**calls[0]))
        for k, (s, out) in enumerate(zip(streams, outs)):
            with torch.cuda.stream(s):
                seen[k].append(torch.stack([stat(o) for o in out]))
    torch.cuda.synchronize(card)
    for want, got in zip(wants, seen):
        bad = sum(int((x != stat(want)).any(dim=(1, 2)).sum()) for x in got)
        assert bad == 0, f"{bad} of {64 * len(got)} replayed launches disagree"
    assert all(_same(x, wants[0]) for x in eager)


@pytest.mark.parametrize("lc", [2, 3, 8, 16, 17, 64])
def test_k3_rows_not_a_multiple_of_a_block(card, lc):
    """N one past a block's rows (256 / G) and one short of it, and a
    batch whose tiles outnumber a wave's share."""
    gen = torch.Generator(device=card).manual_seed(lc)
    rows = 256 // (1 << ((lc + 1) // 2 - 1).bit_length())
    for n in (rows + 1, 3 * rows - 1, 1000 * rows + 7):
        call = _wire_call(card, gen, "gated", lc, 4, n, "ring")
        out = wire_pack(**call)
        torch.cuda.synchronize(card)
        assert _same(out, wire_pack_plain(**call)), n


def test_k3_refuses_what_it_cannot_take(card):
    gen = torch.Generator(device=card).manual_seed(7)
    spec = chip_smoke.k3_spec("gated", 16)
    case = chip_smoke.random_wire_case(spec, 2, 64, torch.uint32, gen, card)
    with pytest.raises(ValueError, match="CUDA"):
        wire_pack(spec, **dict(case, base=case["base"].cpu()))
    with pytest.raises(ValueError, match="contiguous"):
        wire_pack(spec, **dict(case, clocks=case["clocks"].transpose(0, 1).contiguous()
                               .transpose(0, 1)))
    with pytest.raises(ValueError, match="lanes"):
        wire_pack(spec, **dict(case, base=case["base"].transpose(1, 2).contiguous()
                               .transpose(1, 2)))
    with pytest.raises(TypeError, match="uint32"):
        wire_pack(spec, **dict(case, clocks=case["clocks"].view(torch.int32)))
    with pytest.raises(ValueError, match="1..64"):
        wide = chip_smoke.k3_spec("plain", 65)
        wire_pack(wide, **chip_smoke.random_wire_case(wide, 1, 4, torch.uint32, gen, card))
    with pytest.raises(ValueError, match="slot row"):
        wire_pack(spec, **{k: v[:, :0] for k, v in case.items()})


@pytest.mark.parametrize("pipeline", [True, False])
def test_the_delta_ring_on_the_card(card, pipeline):
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip, mesh_fold

    rng = random.Random(3)
    reps, applied = chip_smoke.mint_tracked(rng, 8, ["a", "b", "c", "d"])
    model = BatchedOrswot.from_pure(reps, device=card)
    dirty, fctx = chip_smoke.op_tracking(model, applied, card)
    mesh = VirtualMesh(4, card)
    before = wire_pack.launches
    fused = mesh_delta_gossip(model.state, dirty, fctx, mesh, rounds=8, cap=64,
                              pipeline=pipeline)
    assert wire_pack.launches > before
    layered = mesh_delta_gossip(model.state, dirty, fctx, mesh, rounds=8, cap=64,
                                pipeline=pipeline, fused=False)
    assert chip_smoke.same_leaves(fused[0], layered[0]) and int(fused[3]) == int(layered[3]) == 0
    folded, _ = mesh_fold(model.state, mesh)
    assert chip_smoke.rows_equal_fold(fused[0], folded)


def _small_ring(card):
    rng = random.Random(3)
    reps, applied = chip_smoke.mint_tracked(rng, 8, ["a", "b", "c", "d"])
    model = BatchedOrswot.from_pure(reps, device=card)
    dirty, fctx = chip_smoke.op_tracking(model, applied, card)
    return model, dirty, fctx


@pytest.mark.parametrize("pipeline", [True, False])
def test_the_acked_delta_ring_on_the_card(card, pipeline):
    """The acked fused ring (K3's acked instance once per round) == the
    acked layered ring == the unacked ring == mesh_fold, and it equals the
    same acked ring on the CPU, dirty marks included."""
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip, mesh_fold

    model, dirty, fctx = _small_ring(card)
    mesh = VirtualMesh(4, card)
    before = (wire_pack.launches, wire_pack.acked_launches)
    acked = mesh_delta_gossip(model.state, dirty, fctx, mesh, rounds=8, cap=64,
                              pipeline=pipeline, ack_window=True)
    torch.cuda.synchronize(card)
    assert (wire_pack.launches - before[0], wire_pack.acked_launches - before[1]) == (8, 8)
    layered = mesh_delta_gossip(model.state, dirty, fctx, mesh, rounds=8, cap=64,
                                pipeline=pipeline, fused=False, ack_window=True)
    plain = mesh_delta_gossip(model.state, dirty, fctx, mesh, rounds=8, cap=64,
                              pipeline=pipeline)
    assert chip_smoke.same_leaves(acked[:2], layered[:2]) and int(acked[3]) == 0
    assert chip_smoke.same_leaves(acked[0], plain[0])
    folded, _ = mesh_fold(model.state, mesh)
    assert chip_smoke.rows_equal_fold(acked[0], folded)
    from crdt_tpu_torch.ops.lattice import tree_map

    cpu = lambda t: tree_map(lambda x: x.cpu(), t)  # noqa: E731
    on_cpu = mesh_delta_gossip(cpu(model.state), dirty.cpu(), fctx.cpu(), VirtualMesh(4, "cpu"),
                               rounds=8, cap=64, pipeline=pipeline, ack_window=True)
    assert chip_smoke.same_leaves(cpu(tuple(acked[:2])), tuple(on_cpu[:2]))


def test_an_acked_map_round_holds_no_host_sync(card):
    """One acked fused Map round (K3's acked instance, the mirror's
    promotion, the ack bitmap, the window's promotion) under torch's sync
    debug mode "error"."""
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip_map, mesh_fold_map

    state, dirty, fctx, _ = chip_smoke.fill_delta_config4(32, 3000, 2, 4, 4, 8, 1, card, chunk=8)
    mesh = VirtualMesh(8, card)
    unacked = mesh_delta_gossip_map(state, dirty, fctx, mesh, rounds=27, cap=128)
    folded, _ = mesh_fold_map(state, mesh)
    res = chip_smoke.acked_map_ring(state, dirty, fctx, mesh, 27, 128, unacked, folded,
                                    _map_probe(state, dirty, fctx, mesh, 128), card,
                                    lambda: torch.cuda.synchronize(card), 2, 2, samples=1)
    assert res["round_syncs_with_host"] is False and res["k3_acked_launches"] == 27


def _map_probe(state, dirty, fctx, mesh, cap):
    from crdt_tpu_torch._dtypes import umax
    from crdt_tpu_torch.ops import map as map_ops
    from crdt_tpu_torch.parallel.anti_entropy import local_folds, rank_blocks
    from crdt_tpu_torch.parallel.collectives import ppermute

    p = mesh.p
    rl, k, a = dirty.shape[0] // p, dirty.shape[-1], fctx.shape[-1]
    ranks, _ = local_folds(rank_blocks(state, mesh), map_ops.fold)
    d0 = dirty.view(p, rl, k).any(1)
    f0 = torch.stack([bits(umax(fctx.view(p, rl, k, a)[q], 0)) for q in range(p)]).view(
        fctx.dtype)
    return ranks, d0, f0, ppermute(ranks.top, [(i, (i - 1) % p) for i in range(p)])


def test_donated_outputs_alias_their_inputs(card):
    """At R == P the ring entries' outputs live in the donated inputs'
    storage; the values equal the copying runs'."""
    chip_smoke.phase_donate(card, 1, e=2000, k=3000, cap=128)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sparse_model_on_the_card_matches_the_cpu(card, seed):
    from crdt_tpu_torch.models import BatchedSparseOrswot

    rng = random.Random(seed)
    sites, streams = chip_smoke.mint_sites(rng, 5, 40)
    models = {}
    for dev in (card, "cpu"):
        m = BatchedSparseOrswot(5, 64, 5, deferred_cap=8, device=dev)
        order = random.Random(seed)
        for j in range(5):
            cut = [q[: order.randint(0, len(q))] for q in streams]
            for op in chip_smoke.interleave(order, cut):
                m.apply(j, op)
        m.merge_from(0, 1)
        models[dev] = m
    assert chip_smoke.same_leaves(tuple(x.cpu() for x in models[card].state),
                                  models["cpu"].state)
    assert models[card].fold() == models["cpu"].fold()


def test_the_stream_from_pinned_host_blocks_equals_the_stream_from_device_blocks(card):
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_stream_fold_sparse

    gen, master = chip_smoke.flagship_population(256, 100_000, 8, card, seed=5)
    rows = [torch.arange(b * 64, (b + 1) * 64, device=card) for b in range(8)]
    on_card = [gen(r) for r in rows]
    pinned = [tree_map(lambda x: x.cpu().pin_memory(), b) for b in on_card]
    mesh = VirtualMesh(8, card)
    want, want_of = mesh_stream_fold_sparse(iter(on_card), mesh)
    for pipeline in (True, False):
        got, got_of = mesh_stream_fold_sparse(iter(pinned), mesh, pipeline=pipeline)
        assert chip_smoke.same_leaves(got, want) and torch.equal(got_of, want_of)
    cpu, _ = mesh_stream_fold_sparse(iter([tree_map(lambda x: x.cpu(), b) for b in on_card]),
                                     VirtualMesh(8, "cpu"))
    assert chip_smoke.same_leaves(tuple(x.cpu() for x in want), cpu)
    assert bool(want.valid.all()) and torch.equal(want.eid, master["eid"])


def test_a_logged_ring_on_the_card_recovers_bit_identical(card):
    """The δ ring with ``wal=`` on the card (``chip_smoke.durable_ring``):
    it equals the unlogged ring and launches K3 once per round and K1 once
    per rank; the reopened log and snapshot recover its rows on the card,
    after a torn tail and past a corrupt generation too."""
    from crdt_tpu_torch.ops import orswot as ops
    from crdt_tpu_torch.ops.fold_kernels import fold_entries
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip

    model, dirty, fctx = _small_ring(card)
    mesh = VirtualMesh(4, card)
    plain = mesh_delta_gossip(model.state, dirty, fctx, mesh, rounds=8, cap=64)
    e, a = model.state.ctr.shape[-2:]
    base = ops.empty(e, a, model.state.dvalid.shape[-1], batch=(4,), device=card)
    res = chip_smoke.with_scratch_dir(lambda root: chip_smoke.durable_ring(
        "orswot", lambda wal: mesh_delta_gossip(model.state, dirty, fctx, mesh, rounds=8, cap=64,
                                                wal=wal),
        base, plain, (wire_pack, fold_entries), 8, lambda: torch.cuda.synchronize(card), 1,
        root))
    assert res["launches_in_logged_ring"] == [8, 4]
    assert 0 < res["changed_lanes"] <= res["lanes"]


def test_the_stream_resumes_from_its_log_on_the_card(card):
    """A sparse stream on the card whose source dies halfway resumes from
    its log to the uninterrupted pass (``chip_smoke.durable_stream``)."""
    from crdt_tpu_torch.ops import sparse_orswot as sp
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_stream_fold_sparse

    gen, _ = chip_smoke.flagship_population(256, 100_000, 8, card, seed=5)
    mesh = VirtualMesh(8, card)

    def blocks():
        return (gen(torch.arange(b * 64, (b + 1) * 64, device=card)) for b in range(10))

    want, _ = mesh_stream_fold_sparse(blocks(), mesh)
    res = chip_smoke.with_scratch_dir(lambda root: chip_smoke.durable_stream(
        blocks, want, mesh, sp.empty(256, 8, device=card), 10,
        lambda: torch.cuda.synchronize(card), 1, root))
    assert res["resume_points"] == [2, 4, 5]


def test_the_durability_phase_on_the_card(card):
    """The crashpoint diagonal with states on the card and a BatchedMap
    checkpoint round trip (``chip_smoke.phase_durability``, small K)."""
    res = chip_smoke.phase_durability(card, 1, k=3000, chunk=1000)
    assert res["crashpoint_diagonal"]["crashpoints"] == 15


# ---- the serving tier (ROADMAP item 10) -----------------------------------------

SERVE_KINDS = {"orswot": dict(n_elems=8, n_actors=2, deferred_cap=2),
               "sparse_orswot": dict(dot_cap=12, n_actors=2, deferred_cap=2, rm_width=4)}


def _served(kind, device, lanes=64, tenants=256, n_ops=900, seed=5):
    from crdt_tpu_torch import serve
    from crdt_tpu_torch.parallel import VirtualMesh

    caps = SERVE_KINDS[kind]
    sb = serve.Superblock(tenants, VirtualMesh(8, device), kind=kind, caps=dict(caps))
    q = serve.IngestQueue(sb, lanes=lanes, depth=3)
    chip_smoke.serve_submit(q, chip_smoke.serve_streams(kind, caps, tenants, n_ops, seed))
    return sb, q


@pytest.mark.parametrize("kind", sorted(SERVE_KINDS))
def test_the_slab_apply_on_the_card_matches_the_cpu(card, kind):
    """The coalesced ingest (pinned slab copies, mesh_serve_apply on 8
    virtual ranks, overflow → widen → retry) on the card lands on the
    bits the CPU lands on."""
    import numpy as np

    on_card, q_card = _served(kind, card)
    on_cpu, q_cpu = _served(kind, torch.device("cpu"))
    assert chip_smoke.serve_drain(q_card) == chip_smoke.serve_drain(q_cpu)
    assert on_card.caps == on_cpu.caps and on_card.widen_events == on_cpu.widen_events
    assert chip_smoke.same_leaves(
        type(on_cpu.state)(*(x.cpu() for x in on_card.state)), on_cpu.state)
    assert np.array_equal(on_card.lane_of, on_cpu.lane_of)


@pytest.mark.parametrize("kind", sorted(SERVE_KINDS))
def test_an_apply_async_holds_no_host_sync(card, kind):
    """The slab's pinned copy and the dispatch run under sync debug
    "error"; only ``finish`` reads the overflow flags."""
    sb, q = _served(kind, card)
    chip_smoke.serve_drain(q)  # warm: first slab's allocations
    chip_smoke.serve_submit(q, chip_smoke.serve_streams(kind, SERVE_KINDS[kind], 256, 300, 6))
    built = q._assemble()
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend = q._issue(built)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    q._finish(built, pend, None)


def test_the_serve_scenarios_phase_on_the_card(card):
    out = chip_smoke.phase_serve_scenarios(card, 7)
    assert out["orswot"]["held"] == out["sparse_orswot"]["held"] == 16
    assert out["apply_async_under_sync_debug_error"]


# ---- fan-out (ROADMAP item 11) ----------------------------------------------------

@pytest.mark.parametrize("a", [1, 2, 3, 4, 8])
def test_k3_fanout_instance_through_mesh_fanout_push(card, a):
    """One dispatch on 8 virtual ranks (rows outside the ±32 Ki window,
    empty lanes) launches K3 exactly once; its wire == K3's plain version
    on the same card tensors and == the dispatch on the CPU, every leaf."""
    from crdt_tpu_torch.convert import orswot_from_numpy
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_fanout_push

    state, bases, idx, _ = chip_smoke.fanout_dispatch_case(8, 50 + a, e=33, a=a)
    runs = {}
    for dev in (card, torch.device("cpu")):
        args = (orswot_from_numpy(state, dev), orswot_from_numpy(bases, dev),
                torch.as_tensor(idx).to(dev), VirtualMesh(8, dev))
        before = wire_pack.launches
        runs[dev.type] = mesh_fanout_push(*args)
        assert wire_pack.launches == before + (dev.type == "cuda")
        if dev.type == "cuda":
            assert chip_smoke.fanout_vs_plain(runs["cuda"][0],
                                              chip_smoke.fanout_k3_args(*args[:3], 8)) == 0
    torch.cuda.synchronize(card)
    assert chip_smoke.fanout_wire_diff(runs["cuda"][0], runs["cpu"][0]) == 0
    assert torch.equal(runs["cuda"][1].cpu(), runs["cpu"][1])


@pytest.mark.parametrize("with_base", [False, True], ids=["cold", "warm"])
def test_a_resync_through_bootstrap_on_card_tensors(card, with_base):
    """``bootstrap`` of a fan-out row on card tensors: the landed state
    and the report equal the same bootstrap on the CPU."""
    import numpy as np

    from crdt_tpu_torch.convert import orswot_from_numpy
    from crdt_tpu_torch.scaleout import bootstrap

    rows, bases = chip_smoke.fanout_cohort_case(np.random.default_rng(12), 1, 256, 4)
    one = lambda arrays, dev: orswot_from_numpy(  # noqa: E731
        {k: v[0] for k, v in arrays.items()}, dev)
    got = {}
    for dev in (card, torch.device("cpu")):
        got[dev.type] = bootstrap("orswot", one(rows, dev),
                                  one(bases, dev) if with_base else None, segment_cap=64)
    assert tuple(got["cuda"][1]) == tuple(got["cpu"][1])
    assert chip_smoke.same_leaves(type(got["cpu"][0])(*(x.cpu() for x in got["cuda"][0])),
                                  got["cpu"][0])


def test_the_fanout_scenarios_phase_on_the_card(card):
    out = chip_smoke.phase_fanout_scenarios(card, 3)
    assert out["k3_max_abs_err"] == 0
    assert out["probes"]["clients_equal"] == out["probes"]["clients"]
    assert out["detector"] == {"honest_push": True, "skipping_twin": False}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "layered"])
def test_a_telemetry_ring_on_the_card_counts_like_the_cpu(card, fused):
    """A small dense δ ring with ``telemetry=True``, acked: every counted
    field on the card == the same ring on the CPU (the host-timed fields
    left out by name), K3 once per fused round."""
    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip

    inputs = chip_smoke.fill_delta_config3(32, 600, 8, 4, 4, 3, torch.device("cpu"), chunk=8)[:3]
    got = {}
    for dev in (card, torch.device("cpu")):
        before = wire_pack.launches
        out = mesh_delta_gossip(*tree_map(lambda t: t.to(dev), inputs), VirtualMesh(4, dev),
                                rounds=30, cap=8, fused=fused, ack_window=True, telemetry=True)
        if dev.type == "cuda":
            assert wire_pack.launches - before == (30 if fused else 0)
        got[dev.type] = tele.to_dict(out[4])
    for k, v in got["cpu"].items():
        if k not in chip_smoke.HOST_TIMED:
            assert got["cuda"][k] == v, k
    assert got["cuda"]["bytes_acked_skipped"] > 0
    assert (got["cuda"]["wire_packed_bytes"] > 0) == fused


def test_a_telemetry_fanout_dispatch_on_the_card_counts_like_the_cpu(card):
    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.convert import orswot_from_numpy
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_fanout_push

    state, bases, idx, weights = chip_smoke.fanout_dispatch_case(8, 5)
    got = {}
    for dev in (card, torch.device("cpu")):
        out = mesh_fanout_push(orswot_from_numpy(state, dev), orswot_from_numpy(bases, dev),
                               torch.as_tensor(idx).to(dev), VirtualMesh(8, dev),
                               weights=torch.as_tensor(weights).to(dev), telemetry=True)
        got[dev.type] = tele.to_dict(out[2])
    for k, v in got["cpu"].items():
        if k not in chip_smoke.HOST_TIMED:
            assert got["cuda"][k] == v, k
    assert got["cuda"]["cohorts_per_dispatch"] == int((idx >= 0).sum())


# ---- the nested kinds ---------------------------------------------------------

@pytest.mark.parametrize("kind", chip_smoke.NEST_KINDS)
def test_the_fused_level_fold_on_the_card_matches_its_plain_route(card, kind):
    """``fold_fused_level`` on the card (K1, or K2 for the MVReg leaf, once)
    == the same fold's plain route on the CPU, every leaf."""
    from crdt_tpu_torch.ops import fold_kernels as fk

    pures, _ = chip_smoke.nest_population(kind, random.Random(5), 6)
    level = chip_smoke.nest_ops(kind).LEVEL
    on_card = chip_smoke.nest_model(kind, pures, card).state
    on_host = chip_smoke.nest_model(kind, pures, torch.device("cpu")).state
    counter = chip_smoke._leaf_counter(kind)
    before = counter.launches
    got, got_of = fk.fold_fused_level(level, on_card)
    torch.cuda.synchronize(card)
    assert counter.launches == before + 1
    want, want_of = fk.fold_fused_level(level, on_host)
    assert chip_smoke.same_leaves(chip_smoke.on_cpu(got), want)
    assert torch.equal(got_of.cpu(), want_of)


@pytest.mark.parametrize("kind", ["map_orswot", "map3"])
def test_the_nested_k3_pack_matches_its_plain_version(card, kind):
    """K3's nested instance (the dense slot spec; every level's parked
    buffer in the parked instance of one grouped launch) on card tensors
    == the codec's plain pack on the CPU: wire, aux, checksum."""
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import delta_map3, delta_map_orswot, wire

    flavor = delta_map_orswot if kind == "map_orswot" else delta_map3
    extract = flavor.extract_delta_mo if kind == "map_orswot" else flavor.extract_delta_m3
    template_fn = (flavor.packet_template_mo if kind == "map_orswot"
                   else flavor.packet_template_m3)
    state, dirty, fctx, _ = chip_smoke.fill_delta_nest(kind, 16, 4, 3, torch.device("cpu"),
                                                       k=40, m=25, k1=4, k2=10)
    rows = tree_map(lambda x: x[:4].contiguous(), state)
    pkt, _, _ = extract(rows, dirty[:4], fctx[:4], 64)
    top = rows.core.top if kind == "map_orswot" else rows.mo.core.top
    rtop = torch.roll(top, -1, 0)
    out = {}
    for dev in (torch.device("cpu"), card):
        codec = wire.WireCodec(template_fn(tree_map(lambda x: x.to(dev), rows), 64, fctx.dtype),
                               dirty.shape[-1], wire.know_dense, gated=True, acked=False)
        before = wire_pack.launches
        out[dev.type] = codec.pack(tree_map(lambda x: x.to(dev), pkt), rtop=rtop.to(dev))
        assert wire_pack.launches == before + (dev.type == "cuda")
    torch.cuda.synchronize(card)
    assert chip_smoke.same_leaves(chip_smoke.on_cpu(out["cuda"]), out["cpu"])


def test_the_nested_scenarios_phase_on_the_card(card):
    chip_smoke.phase_nested_scenarios(card, 3)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "layered"])
def test_a_nested_ring_on_the_card_equals_the_cpu_ring(card, fused):
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import VirtualMesh, delta_map3

    state, dirty, fctx, _ = chip_smoke.fill_delta_nest("map3", 32, 4, 4, torch.device("cpu"),
                                                       k1=4, k2=10, m=25)
    outs = {}
    for dev in (torch.device("cpu"), card):
        outs[dev.type] = delta_map3.mesh_delta_gossip_map3(
            tree_map(lambda x: x.to(dev), state), dirty.to(dev), fctx.to(dev),
            VirtualMesh(4, dev), rounds=24, cap=256, fused=fused)
    assert chip_smoke.same_leaves(chip_smoke.on_cpu(outs["cuda"]), outs["cpu"])
    assert int(outs["cpu"][3]) == 0


def test_the_list_epoch_scatter_on_the_card_equals_the_cpu(card):
    """A 2,000-op trace through ``BatchedList`` on the card and on the CPU:
    the broadcast epochs of ``apply_trace_to_all``, per-replica epochs of
    ``apply_ops`` and a streamed growth in between land on the same bits."""
    import numpy as np

    from crdt_tpu_torch.models import BatchedList

    trace = chip_smoke.make_edit_trace(2000, seed=5)
    part = lambda lo, hi: tuple(x[lo:hi] for x in trace)  # noqa: E731
    rng = np.random.default_rng(0)
    models = {d: BatchedList.from_trace(*part(0, 1200), n_replicas=8, device=d)
              for d in ("cpu", card)}
    epoch = np.full((8, 64), -1, np.int64)
    for r in range(8):
        take = rng.choice(1200, size=64, replace=False)
        _, first = np.unique(models["cpu"].op_slots[take], return_index=True)
        epoch[r, :len(first)] = take[np.sort(first)]
    for m in models.values():
        m.apply_ops(epoch)
        m.extend_trace(*part(1200, 2000))
        m.apply_trace_to_all(chunk=256)
    torch.cuda.synchronize(card)
    cpu, gpu = models["cpu"], models[card]
    assert torch.equal(gpu.vals.cpu(), cpu.vals) and torch.equal(gpu.alive.cpu(), cpu.alive)
    assert gpu.uploaded_bytes == cpu.uploaded_bytes
    assert gpu.read(3) == cpu.read(3)


@pytest.mark.parametrize("dtype", ["uint32", "uint64"])
def test_the_pairwise_merge_matrix_on_the_card_equals_the_cpu(card, dtype):
    from crdt_tpu_torch._dtypes import from_wide
    from crdt_tpu_torch.ops import vclock

    gen = torch.Generator().manual_seed(256)
    wide = torch.randint(0, 1000, (256, 8), generator=gen, dtype=torch.int64)
    if dtype == "uint64":
        wide = (1 << 63) - 1 - wide  # the sign-flipped view: lanes within 1,000 of 2^64
    clocks = from_wide(wide, getattr(torch, dtype))
    want = vclock.pairwise_merge_matrix(clocks)
    got = vclock.pairwise_merge_matrix(clocks.to(card))
    assert got.shape == (256, 256, 8) and got.dtype == clocks.dtype
    assert torch.equal(bits(got).cpu(), bits(want))
