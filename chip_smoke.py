#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``crdt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--only PHASES]

``--only`` (a development aid) runs the named phases alone and prints no
kernels line and no ok line; the script's contract is the full run with no
arguments. Builds the port's CUDA kernels from the sources in this checkout (``nvcc``,
at first use), then runs, printing one JSON line per phase:

1. ``device``         — the card, torch/CUDA versions, the kernels' build
                        time and ``ptxas`` register report.
2. ``k1_shapes``      — kernel K1 (``fold_entries``) against its plain
                        torch version on the card, bit-exact, at ragged E,
                        A in {2, 8, 12, 32}, R in {1, 3, 5, 7, 64},
                        counters near 2^32-1 and ``n_passes`` = 3.
3. ``scenarios``      — mint → apply → cross-deliver → merge → fold on the
                        card through ``BatchedOrswot``, held against the
                        sequential oracle ``crdt_tpu_torch.pure.Orswot``
                        (gap/dup dots, rm of an unseen member, parked
                        ahead-removes, repeated self-merge, DeferredOverflow).
4. ``full_width``     — BASELINE config 3: ``BatchedOrswot.fold()`` over
                        R=10240 replicas × E=102400 members × A=8 actors
                        (D=4 parked slots), which must launch K1; the folded
                        entries and the converged state are held bit-exact
                        against the plain fold run in 512-replica chunks.
                        Reports K1's median time, GB/s, merges/s and its
                        share of the bandwidth bound. Then the same state
                        streams through ``mesh_stream_fold`` in 1,024-row
                        blocks on P=8 virtual ranks: K1 once per rank and
                        block (80), the result == ``fold_fused`` on every
                        leaf.
5. ``k2_shapes``      — kernel K2 (``fold_cells``) against its plain torch
                        version on the card, bit-exact, at ragged K, A in
                        {1, 3, 4, 8, 32}, R in {1, 3, 5, 7, 8, 64} and
                        counters near 2^32-1; A > 32 and a non-contiguous
                        input must raise.
6. ``map_scenarios``  — the same probe set through ``BatchedMap`` on the
                        card against the oracle ``crdt_tpu_torch.pure.Map``
                        (cross-delivered op streams with parked removes,
                        garbage ops, rm of an unseen key, a full key
                        universe, merges, repeated self-merge, folds through
                        K2, reset_remove, DotRange, SlotOverflow,
                        DeferredOverflow).
7. ``full_width_map`` — BASELINE config 4 at ``bench.py``'s shape and
                        state rule: ``BatchedMap.fold()`` over R=8 replicas
                        × K=1,000,000 keys × S=2 sibling slots × A=4 actors
                        (D=4, 16 parked keyset-removes), then again at
                        R=64. The fused fold is held leaf for leaf against
                        the plain tree fold on the card before any number
                        is reported; then K2's time, GB/s, merges/s and
                        share of the bound, the fused fold's pieces, and
                        ``fold()`` end to end with ``to_pure``'s share.

8. ``k3_shapes``      — kernel K3 (``wire_pack``) against its plain torch
                        version on the card, every output at tolerance 0:
                        the four flag sets (plain, gated, gated+acked,
                        parked), N in {1, 31, 1024, 65537}, LC in {1, 2, 3,
                        8, 16, 17, 33, 64} (every row-group width), B in
                        {1, 8}, u32 and u64 clocks, rows inside and outside
                        the ±32 Ki window, bases above clocks near the
                        dtype's max; grouped launches (``wire_pack_many``:
                        the δ round's slot + parked pair, two mixed pairs,
                        a group of four); bad inputs must raise.
9. ``delta_scenarios`` — small oracle-minted rings on 4 virtual ranks, all
                        of ``pipeline`` × ``fused``: fused == layered on
                        every leaf, equal residue, and the converged rows
                        == ``mesh_fold`` when the residue is 0.
10. ``full_width_delta`` — the dense δ anti-entropy ring at config 3's
                        widths (E=102400, A=8, D=4) on P=8 virtual ranks
                        with R=5120 replicas (half of config 3's 10240: the
                        fctx plane is as large as ctr), through
                        ``mesh_delta_gossip``: fused ring (K3) == layered
                        ring == ``mesh_fold`` (K1) on every leaf with
                        residue 0; K3 launched once per round; K3's time
                        (per launch over a replayed graph, alone under the
                        profiler, per call through the wrapper), the
                        grouped round's time, bytes (distinct data) and
                        bound shares, a graph of 10 wrapped calls holding
                        10 kernel nodes and no memset, ``k3_sweep`` (K3
                        up to 1M rows, where bytes set the bound), the
                        ring's wall time (the median of 5 warm rings of
                        each kind, alternating),
                        rounds, slots and wire bytes per link-round, the
                        local fold's time, the device's busy share and peak
                        memory. Then the same rings with ``ack_window=True``
                        (key ``ack_window``): acked fused == acked layered ==
                        the unacked ring == ``mesh_fold``, residue 0, every
                        K3 launch (one per round) carrying its acked
                        instance; slots shipped and window-skipped against
                        the unacked ring; K3's acked instance (per-slot base,
                        window lanes) per launch and alone with its bytes and
                        bound; the walls (median of 5 of each kind, acked
                        and unacked fused and layered rings alternating),
                        busy share and peak memory. Then the ring with
                        ``wal=`` (key ``durable``): generation 1 is every
                        rank at the synced state, the logged ring == the
                        unlogged one (K3 once per round, K1 once per rank),
                        recovery from the reopened log == its rows, a torn
                        second append truncated on reopen, a corrupt newest
                        generation fallen back; record and snapshot bytes,
                        the append's wall by part, recovery's by part, and
                        the logged and unlogged walls alternating. Then the
                        rings with ``telemetry=True`` (key ``telemetry``,
                        ``telemetry_ring_leg``): == the plain ring bit for
                        bit, K3 once per round, the JAX merge count, the
                        wire bytes, K3's nonzero words (×4, with the id,
                        raw and bitmap leaves') as ``wire_packed_bytes``,
                        the histograms; the acked ring's skipped bytes; the
                        launches a round and walls with the sidecar off and
                        on, alternating.
11. ``map_delta_scenarios`` — small oracle-minted Map<K, MVReg> rings on 4
                        virtual ranks, ``pipeline`` × cap 16 / 1: fused ==
                        layered on every leaf, equal residue, and the
                        converged rows == ``mesh_fold_map`` when certified.
12. ``full_width_delta_map`` — the Map δ ring at config 4's widths (K=1M,
                        S=2, A=4, D=4) with R=64 replicas on P=8 virtual
                        ranks, cap 4096, through ``mesh_delta_gossip_map``:
                        fused ring (K3 at LC 14) == layered ring ==
                        ``mesh_fold_map`` with residue 0; K2 once per rank
                        and K3 once per round; one round run with torch's
                        sync debug mode on (no host sync); K3 at the Map
                        layout per launch over a replayed graph and alone,
                        its bytes and bound, 10 wrapped calls = 10 kernel
                        nodes; ring walls (median of 5 of each kind,
                        alternating), busy share and launches per round;
                        and the same traffic with every key written, where
                        the wire's window leaves the fused ring uncertified.
                        Then the acked rings as in phase 10 (3 walls of each
                        kind), one acked round under sync debug "error", and
                        K3's acked instance at LC 14; the ring with
                        ``wal=`` as in phase 10 (2 walls of each kind); the
                        telemetry rings as in phase 10 (2 walls of each), and
                        one round with the sidecar's work under sync debug
                        "error".
13. ``sparse_scenarios`` — the probe set through ``BatchedSparseOrswot`` (the
                        segment-encoded ORSWOT) on the card against the
                        oracle and a dense ``BatchedOrswot`` twin (through
                        ``to_dense``): cross-delivered op streams with parked
                        ahead-removes, merges, self-merge, reset_remove,
                        folds, DotCapacityOverflow, DeferredOverflow.
14. ``flagship``       — BASELINE's metric of record at its literal shape
                        (``BENCH_CONFIGS.json`` "flagship"): 10,240 replicas
                        over a 1,000,000-element universe, A=8, segment cap
                        4,096, streamed through ``mesh_stream_fold_sparse``
                        in 40 blocks of 256 on P=8 virtual ranks, on a
                        torch copy of ``bench.py``'s population. Gates
                        first: the 24-replica subsample (stream == the
                        co-resident fold == block size 4 == the oracle merge
                        chain), the converged state == the master table,
                        the stream == ``mesh_fold_sparse`` of the whole
                        co-resident population; one step under sync debug
                        mode "error". Then merges/s = (R-1) / stream wall
                        (median and range of 5 warm passes, CUDA events)
                        from device-generated and from pinned host blocks,
                        with busy share, launches per block and the sorts'
                        share of device time (profiled over 10 blocks),
                        peak memory and ``overlap_hit``. Then ``wal=`` (key
                        ``durable``): a pass whose source dies after block
                        20 raises ``StreamInterrupted`` with resume records
                        at blocks 8, 16 and 20; the stream resumed from the
                        reopened log == the uninterrupted pass; logged
                        (``wal_every=8``) and unlogged walls alternating;
                        three passes with ``telemetry=True`` alternating with
                        plain ones (== the plain pass, 40 blocks, the staged
                        bytes, the JAX merge count; merges/s off and on), and
                        one step with the sidecar's work (the changed slots)
                        under sync debug "error".
15. ``elastic``        — the overflow → widen → re-enter loops: at config
                        3's widths (R=5120 on 8 virtual ranks) a
                        ``BatchedOrswot`` born with ``deferred_cap`` 2 under
                        traffic whose rank folds meet 3 parked removes;
                        ``gossip_elastic`` and ``delta_gossip_elastic``
                        (without and with the ack window) overflow in their
                        first attempt, widen to 4 and equal rings born at 4
                        and ``mesh_fold``; ``gossip_elastic`` on a
                        ``BatchedSparseOrswot`` (``dot_cap`` 1024 → 4096) and
                        a ``BatchedMap`` at config 4's widths (D 1 → 2), each
                        == a wider-born ring and its fold. The unacked
                        ``delta_gossip_elastic`` runs with ``wal=``: one
                        full-state record (the widen changed the shapes),
                        recovered == the committed rows.
16. ``resync``         — ``delta_opt.heal.resync`` over 8 ranks that
                        diverged from one snapshot, dense at config 3's
                        widths and Map at config 4's: healed == the join
                        chain of the ranks; lanes, bytes against full states,
                        wall.
17. ``donate``         — ``donate=True`` at R == P = 8 for ``mesh_gossip``
                        (config 3's widths) and ``mesh_delta_gossip_map``
                        (config 4's): == the copying runs, outputs in the
                        inputs' storage, peak and resident memory of both.
18. ``durability``     — the crashpoint diagonal on the card (each of the
                        15 crashpoints once, the decomposition kinds
                        cycled: recovery == the last durable record), and
                        ``checkpoint.save`` / ``load`` of a ``BatchedMap``
                        at config 4's widths, R = 8, == what was saved.
                        Every durable run writes under a temporary
                        directory, removed afterwards, and reports its
                        filesystem's type and free bytes.

19. ``serve_scenarios`` — small oracle probes of the serving tier on the card,
                        both kinds (``orswot``, ``sparse_orswot``): mixed
                        add/rm streams (covered and ahead removes, NOOP
                        padding) through ``Superblock`` + ``IngestQueue`` on 4
                        virtual ranks == ``sequential_oracle`` (the unbatched
                        ops) == the pure ``Orswot`` == the same run on the
                        CPU; overflow → widen → retry (a double widen) == a
                        wide-born superblock; an exhausted widen budget rolls
                        back and requeues; lane paging (24 tenants on 8
                        lanes); evict then touch; backpressure; one
                        ``apply_async`` (pinned copy + dispatch) under sync
                        debug "error".
20. ``serve``          — ``BENCH_CONFIGS.json`` "serve" at its committed shape,
                        driven as ``bench.py``'s ``bench_serve`` drives it:
                        1,048,576 tenants on 262,144 lanes over 8 virtual
                        ranks, slabs 4,096 × 4, 20 cycles of 16,000 ops, a
                        512-tenant evict cohort and a 64-tenant retouch
                        mid-window, 48 sampled tenants held against both
                        oracles; ops/s, dispatch walls (issue → finish,
                        p50/p99), dispatches, launches and device time per
                        dispatch (graph replay; one eager dispatch beside it),
                        busy share, superblock and peak bytes; two more cycles
                        drained with ``telemetry=True`` (the sidecar's own
                        replayed graph, captured in the first), each one's
                        annotated Telemetry against the queue's counts, and
                        the second's dispatch walls. Then the window again
                        with the trace plane on, as ``bench.py`` runs it: a
                        ``FlightRecorder`` (32,768) and a ``Tracer`` at
                        ``trace_sample`` 1,024, every sampled tenant
                        subscribed to a ``FanoutPlane`` whose push → ack
                        closes each cycle's journeys; ops/s and dispatch
                        walls beside the untraced window's, completed
                        journeys, freshness p50/p95/p99 and each stage's p99
                        (µs), the top of ``skew_report``, events and drops by
                        type; the dump passes ``obs.report`` with the trace
                        replay run; ``prometheus_text()`` all valid lines,
                        ``health()`` all its fields.
21. ``serve_zipf``     — its zipf leg (65,536 tenants on 16,384 lanes, slabs
                        1,024 × 4, 8,000 zipf ops a cycle, a ×10 hot shard
                        answered by ``rebalance``) at ``ZIPF_CYCLES`` of its
                        24 cycles: the serial flush loop and the pipelined
                        ``ServeLoop``, both with ``ServeWal``, on one
                        pregenerated schedule land on the same rows and the
                        oracles; ``recover_serve`` into a fresh superblock
                        lands there too; both walls, WAL bytes and fsyncs,
                        evictions, the filesystem.
22. ``fanout_scenarios`` — the fan-out plane's lockstep probes on the card,
                        small: 12 tenants on 6 lanes (restores under lane
                        pressure), split watermark buckets under a lossy
                        link, churn, a dead subscriber's resync, evict →
                        re-warm, a stale duplicate ack; the run on the card
                        == the same run on the CPU (every push's report and
                        wire, the registry, the clients) and every client
                        == its served row; ``fanout_covers_cohorts`` passes
                        the honest push and fails ``push(_skip_versions=
                        (0,))``; K3's fan-out instance (LC = A, per-row base,
                        one ``[8, N, A]`` stack) == its plain version on the
                        same card tensors at A in {1, 2, 3, 4, 8} with rows
                        outside the ±32 Ki window and empty lanes, bare and
                        through ``mesh_fanout_push`` (one launch; == the
                        dispatch on the CPU).
23. ``fanout``         — ``BENCH_CONFIGS.json`` "fanout" at its committed
                        shape, as ``bench.py``'s ``bench_fanout`` drives it:
                        1,048,576 subscribers over 1,048,576 tenants on
                        131,072 lanes (E = 256, A = 4, D = 2) on 8 virtual
                        ranks, 8 cycles of 8,192 ops through the serve ingest,
                        one ``FanoutPlane.push`` a cycle (4,096 dispatch
                        lanes), churn, killed subscribers forced to resync,
                        32 subscribed tenants evicted mid-window; gates: the
                        first dispatch's wire == K3's plain version, K3 once
                        per dispatch, 32 sampled clients and the revived dead
                        one == their served rows, every watermark current,
                        1M+ live subscribers, a resync, the re-warm, δ +
                        bootstrap bytes ≥ 10× below full rows; δ deliveries
                        per second, push walls and dispatches per cycle, the
                        push's host time by part, one profiled push (busy
                        share, launches), K3 at the fan-out layout (replayed
                        graph and profiler, bytes, bound, share); one more
                        cycle's ``push(telemetry=True)``: live subscribers,
                        cohorts, δ bytes against the host's pricing, resync
                        fallbacks and bootstrap bytes. Then 8 cycles again
                        with a ``FlightRecorder`` (32,768) and a ``Tracer``
                        at ``trace_sample`` 256, each push with the sidecar
                        annotated by the tracer and recorded: push walls
                        beside the untraced window's, journeys, freshness and
                        stage p99s, skew, events; the dump passes
                        ``obs.report`` with the trace replay run.
24. ``telemetry_scenarios`` — the same seeded small inputs through every
                        telemetry path (``mesh_fold``, ``mesh_gossip``,
                        ``mesh_fold_map``, the dense and Map δ rings fused,
                        layered and acked, a dense stream, a serving flush,
                        a fan-out dispatch) on the card and on the CPU: the
                        card's ``to_dict`` == the CPU's on every counted
                        field (``HOST_TIMED`` left out by name).

25. ``sparse_map_scenarios`` — oracle-minted op streams through
                        ``BatchedSparseMap`` and ``BatchedSparseMapOrswot`` on the
                        card and on the CPU side by side (card == CPU on every
                        leaf, ``to_pure`` == the pure ``Map`` oracle, removes
                        parked ahead at both levels), merges, folds — the sparse
                        Map's fold == a dense ``BatchedMap`` twin's (K2, counted)
                        — reset_remove and the capacity errors.
26. ``full_width_sparse_map`` — (a) ``BENCH_CONFIGS.json`` "sparse_map" uncut
                        (R = 256, cell cap 2,048, a 100M-key universe, sibling
                        cap 8, A = 8) through ``mesh_fold_sparse_mvmap`` on P = 8
                        and ``BatchedSparseMap.fold()``; gates: == a left chain
                        of joins, ``split_cells`` of it == the key-sharded fold on
                        ``VirtualMesh(8, s=2)``, == the master union, K1–K3
                        launched 0 times; fold ms, merges/s, live cells, bytes,
                        busy share, peak memory. (b) the same widths at the
                        flagship's population (10,240 replicas, 40 blocks of
                        256) through ``mesh_stream_fold_sparse_mvmap``. (c)
                        ``BatchedSparseMapOrswot`` at the "sparse" config's
                        widths (R = 256, dot cap 4,096; 65,536 keys × span 16,
                        16 parked keyset-removes): ``mesh_fold_sparse_nested``
                        and ``mesh_fold_sparse_map`` on ``VirtualMesh(8, s=2)``
                        == ``split_nested`` of it == the join chain. (d) the
                        flagship population through
                        ``mesh_stream_fold_sparse_sharded`` at S = 2 ==
                        ``split_segments`` of the unsharded stream.
27. ``nested_scenarios`` — seeded op streams of ``Map<K, Orswot>``, ``Map<K1,
                        Map<K2, MVReg>>`` and ``Map<K1, Map<K2, Orswot>>``
                        with removes parked at every level, through the
                        models on the card and on the CPU side by side (card
                        == CPU on every leaf, ``to_pure`` == the oracle),
                        merges and ``fold()`` (the fused level fold: K1 or K2
                        on the leaf, counted; == the oracle's merge); the
                        fused fold on the card == its plain route on the CPU
                        == the tree fold with every level's parked slots in
                        clock order; then depth 4, one generic level around
                        ``Map3``.
28. ``full_width_nested`` — (a) ``Map<K, Orswot>`` at config 3's widths (K 400
                        × M 256 = E 102,400, A = 8, D = 4, 4 outer keyset
                        clocks) at R = 10,240 through ``BatchedMapOrswot.fold()``
                        (K1 once); == the plain route (K1's plain version in
                        512-replica chunks + the same epilogue); a 6-replica
                        subsample's fold == the oracle's merge. (b) ``Map3`` at
                        the same widths (K1 16 × K2 25 × M 256) at R = 2,048,
                        two ``settle_outer`` levels, == the plain route. (c)
                        ``Map<K1, Map<K2, MVReg>>`` at config 4's widths (1,000
                        × 1,000 keys, S = 2, A = 4, D = 4) at R = 8 and 64 (K2
                        once a fold; replicas settled first), ==
                        ``fold_cells_plain`` + the epilogue; the flat
                        ``BatchedMap``'s K2 fold + the outer level == the
                        nest's tree fold. Leaf kernel ms, epilogue ms by
                        level, fold walls, peak.
29. ``full_width_delta_nested`` — the ``Map<K, Orswot>`` δ ring at
                        ``full_width_delta``'s widths and cut (R = 5,120 on P =
                        8, cap 4,096) and the ``Map3`` ring at R = 1,024, outer
                        keyset removes of live keys parked at every level (the
                        K1 one kills a live K1 key): certified fused (K3 once
                        a round, every launch == K3's plain version) ==
                        layered == ``mesh_fold_map_orswot`` /
                        ``mesh_fold_map3``, residue 0; acked (residue 0) and
                        logged once (replayed); walls (median of 5,
                        alternating fused, layered and acked), busy
                        share, launches a round, wire bytes, K3 at the nested
                        instance (slot + every parked level in one launch).
30. ``kinds_scenarios`` — small probes of every kind of ROADMAP item 14 on the
                        card == the CPU == the pure oracles: PN and G
                        counters (2^32-1 + 1 raises on strict, wraps off it;
                        a u64 lane near 2^64), VClock gap and duplicate dots,
                        GSet, LWWReg's equal-marker conflict, MVReg's
                        SlotOverflow and reset_remove, List front inserts and
                        a remote ingest that grows the universe, a GList
                        union, a serde round trip of every new tag; no K1-K3.
31. ``full_width_clocks`` — BASELINE configs 1 and 2 at ``bench.py``'s draws
                        (``default_rng(1)``): 64 replicas × 10,000
                        increments through ``BatchedGCounter`` (read exactly
                        10,000), the 1,000 × 1,000 × 8 pairwise merge matrix
                        (== numpy on 64 rows) and PNCounter's p − n; then
                        ``mesh_fold_clocks`` and ``mesh_fold_gset`` (10,240 ×
                        102,400 members) on P = 8 == the single-rank folds.
32. ``full_width_list`` — BASELINE config 5: the synthetic 100k-op trace
                        through ``BatchedList`` at 1,024 replicas, 49 epochs
                        of 2,048 ops; every row == row 0 == the pure ``List``
                        == the native engine; ``to_pure`` of 4 rows; a model
                        fed the last 50,000 ops by ``export_ops`` /
                        ``ingest_remote_ops`` == the first; replica-ops/s,
                        busy share, a checkpoint at R = 64, a ``BatchedGList``
                        of the trace's inserts at R = 1,024.
33. ``reclaim_scenarios`` — causal-stability reclamation (ROADMAP 15.2, 15.8)
                        on the card == the CPU on every leaf: every kind's
                        ``compact`` and ``_observe``, the frontier with a
                        straggler, the eight ring entries with
                        ``stability=True`` (K1 and K2 counted), the stream's
                        ``compact_every``, compact-on-save,
                        ``compact_tenants``, the three ``lifecycle`` calls.
34. ``full_width_reclaim`` — (a) ``mesh_gossip(stability=True)`` at config
                        3's widths, R = 5,120 on P = 8 with a straggler and
                        injected covered, pinned and stale parked slots:
                        reads unchanged, frontier == the numpy min,
                        ``reclaimed_slots`` == the host count, K1 8 times ==
                        its plain fold; walls on and off. (b) the sparse
                        churn (``bench_reclaim``) at the "sparse" widths:
                        reads == the flags-off twin's, a widen and a shrink.
35. ``faults_scenarios`` — the fault plane (ROADMAP 15.4, 15.3) on small
                        rings, gossip entries, streams and bootstraps: card
                        == CPU on every leaf and counter.
36. ``full_width_chaos`` — the faulted dense ring at config 3's widths, the
                        faulted flagship stream, the widening stream.
37. ``obs_scenarios``  — the observability plane (ROADMAP 15.6) on small
                        probes, card == CPU on every flight event (every field
                        but ``ts``) and every leaf: faulted dense and Map
                        rings with ``Membership`` auto-evict, ``with_retries``
                        giving up, a stream losing blocks, a logged ring
                        recovered past a corrupt generation, the elastic
                        votes, a ``ScaleoutMesh`` trajectory with a refused
                        drain and a stale certificate; every dump passes
                        ``obs.report``; ``drain_refuses_unflushed``;
                        ``measure_slo`` card == CPU == the committed
                        budgets. Flags off: a dense ring's launches and a
                        serve dispatch's graph nodes unchanged by installing
                        the recorder and the tracer; a faulted round with a
                        recorder under sync debug "error".
38. ``full_width_scaleout`` — live scale-out (ROADMAP 15.5), ``bench.py``'s
                        trajectory at config 3's widths on P = 8 ranks of one
                        replica each: plateau on 6, the ``Autoscaler``'s
                        admits (cold bootstraps), the warm-start gate at
                        E = 102,400, a certified drain, a refused one; joins/s
                        at each width, the admit's wall by part, bootstrap
                        bytes, ``certify_drain``'s ms, the ring with and
                        without the recorder; the trajectory's dump audited.
39. ``full_width_geo`` — the geo-federation plane (ROADMAP 15.7):
                        ``BENCH_CONFIGS.json`` "geo" uncut (3 regions ×
                        1,024 tenants, E = 256, A = 8, a region killed
                        mid-traffic at cycle 5) run as ``bench.py``'s geo leg,
                        with its four gates (acked-op oracle, interest
                        mirrors, δ ≤ 25% of full mirroring, partial
                        residency); acked ops/s, the failover, δ bytes, stale
                        reads, the watermark lag; the same run on the CPU,
                        card == CPU; ``geo.static_checks`` clean. No kernel.
40. ``laws_scenarios`` — the lattice-law engine and the SEC schedule
                        checker (ROADMAP 16) over the twelve merge kinds on
                        the card, clean; every broken twin card == CPU; every
                        domain and pair table card == CPU. No kernel.
41. ``static_scenarios`` — the port's static-check runner
                        (``crdt_tpu_torch.analysis.run``, ROADMAP 16) on the
                        card: every section clean, section by section with
                        its wall and its K1-K3 launches (K3 in ``wire`` and
                        ``fanout`` > 0, each launch == the plain pack; K1
                        and K2 0); every broken twin's findings card == CPU;
                        the interleaving explorer's counts (21/10, 51/5) and
                        the racy twin's counterexample card == CPU; the wire
                        fixture's words, keep verdicts and checksum and the
                        micro cohort's wire card == CPU.
42. ``multihost``     — ``parallel/multihost.py`` (ROADMAP 5a): two worker
                        processes of this script (``--multihost-worker``) on
                        the one card, 4 local ranks each, joined over gloo
                        at 127.0.0.1: the dense ``mesh_fold`` and every
                        ``mesh_gossip`` row at config 3's widths (R = 2,048,
                        each process drawing its own 1,024 rows block by
                        block from ``--seed``), ``mesh_fold_map`` at config
                        4's (R = 8), ``mesh_fold_sparse_mvmap``, the two
                        ``sync_list`` rounds and the tenant-shard handoff,
                        each equal to the single-process run (P = 8, one
                        process) leaf for leaf; every worker's K1 (8) and K2
                        (4) launches held against their plain versions;
                        per-process fold walls, exchange bytes and ms, local
                        fold ms, against the single-process fold's wall.
                        Then the δ rings across the processes (ROADMAP 32):
                        the dense ring at config 3's cut (R = 2,048, cap
                        4,096, ``full_width_delta``'s fill), the Map ring at
                        R = 8 (``full_width_delta_map``'s fill; keys cut to
                        250,000) and both nested rings at the tests' sizes,
                        each fused (K3 counted: once a round on each process;
                        then every launch held against the plain pack),
                        layered and (dense, Map) acked, == the single-process
                        ring on P = 8 (rows, dirty, flags, residue 0, stats)
                        == the mesh fold; every other fold and gossip kind
                        at the tests' sizes == the single-process entry;
                        ring walls both ways, exchange ms and bytes a round.
                        Then the streams, element-sharded folds and elastic
                        loops across the processes (ROADMAP 32, second
                        part), each process streaming its own half of every
                        block: ``mesh_stream_fold_sparse`` at the flagship's
                        widths (10,240 × a 1M universe, cap 4,096, 40
                        global blocks of 256), ``mesh_stream_fold`` at
                        config 3's (R = 2,048, blocks of 512; K1 counted and
                        held), the sharded flagship stream (S = 2, 10 of the
                        40 blocks) and the four sharded folds at the tests'
                        sizes, dense ``gossip_elastic`` (R = 2,048, born D =
                        2, only one process's rows parking) and Map
                        ``gossip_elastic`` (R = 64, K = 250,000, born D = 1;
                        K2 counted and held), fused ``delta_gossip_elastic``
                        (R = 2,048; K3 counted and held): each == the
                        single-process entry on P = 8 (sharded: 4 × 2)
                        leaf for leaf, the same axes widened; the flagship
                        stream's walls both ways, its merges/s across the
                        processes, exchange ms and bytes a block. Then
                        (ROADMAP 32, third part) ``mesh_serve_apply`` at
                        bench serve's width (262,144 lanes, 20 donated
                        slabs of 4,096 × 4) ± ``telemetry=``,
                        ``mesh_fanout_push`` at ``phase_fanout``'s layout
                        (131,072 lanes, E 256, A 4, 4,096 lanes a dispatch;
                        K3 counted, once a dispatch, and held), the dense
                        fold, gossip and fused ring and the flagship stream
                        with ``telemetry=True``, ``mesh_gossip(stability=
                        True, lag_threshold=1)`` and both dense elastic
                        loops with ``reclaim=``: rows, flags, wire lanes,
                        ``nnz``/``chk``, every sidecar field but the
                        host-timed ones, frontiers, capacities and shrinks
                        == the single-process entries'; dispatch p50/p99,
                        push walls and each sidecar's wall on against off.
                        Then (ROADMAP 32, fourth part, key ``faults``)
                        under ``faults=``: the dense δ ring under bench's
                        chaos plan (``seed=17, corrupt=0.6, drop=0.2,
                        evicted=(5,)``) fused and layered and a fused probe
                        under an edge plan (ranks 3 and 4 evicted, delay,
                        no corruption: 0 rejects), the Map δ ring, the
                        dense and Map ``mesh_gossip*(stability=True)``, the
                        flagship stream over 10 of its 40 blocks under
                        ``drop=0.05, corrupt=0.05`` and the re-stream of its
                        lost blocks (== the unfaulted stream), both dense
                        elastic loops: rows, dirty rows, flags, residue,
                        counters (the global streak), frontiers and the
                        stream's report == the single-process entry on P =
                        8 under the same plan; K3 once a fused round on
                        each process (41 dense, 27 Map), K1/K2 in the local
                        folds, each launch held against its plain version;
                        the faulted walls against the single-process and
                        the unfaulted cross-process walls, exchange ms and
                        bytes a round.

Then the ``nvidia-smi`` name/power-limit line, a ``kernels`` JSON line, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero without that line. It needs one CUDA device
and exits non-zero without one. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# Nominal H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# 32-bit rate outside the tensor cores (the table's fp32 figure), used for
# the integer compare/select work of the fold.
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
# Integer operations per (replica, element, actor) lane of one entry join:
# two compare+selects (wa, wb), min, two max, the presence OR, the final
# select pair, and the top max.
OPS_PER_LANE = 10
# ... and per (replica, key, actor) cell of one cell join: two
# compare+selects (wa, wb), the equality compare+select, the max of wa and
# wb, and the top max.
OPS_PER_CELL = 8

K1 = {
    "name": "fold_entries (K1)",
    "route": "cuda",
    "source": "crdt_tpu_torch/csrc/fold.cu",
    "replaces": "crdt_tpu/ops/pallas_kernels.py:106",
}
K2 = {
    "name": "fold_cells (K2)",
    "route": "cuda",
    "source": "crdt_tpu_torch/csrc/fold.cu",
    "replaces": "crdt_tpu/ops/pallas_kernels.py:91",
}
K3 = {
    "name": "wire_pack (K3)",
    "route": "cuda",
    "source": "crdt_tpu_torch/csrc/wire.cu",
    "replaces": "crdt_tpu/ops/wire_kernels.py:105",
}
SOURCES = ("fold.cu", "wire.cu")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def note(what: str) -> None:
    """A progress line on standard error (the phases' JSON lines and the
    last line stay on standard output)."""
    print(f"chip_smoke: {what}", file=sys.stderr, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, device) -> float:
    """Wall time of ``fn()`` on ``device``: CUDA events around the call on
    a card, the host clock on the CPU (rehearsals only)."""
    import torch

    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def fold_bound_ms(r: int, e: int, a: int, ops_per_lane: int = OPS_PER_LANE) -> dict:
    """The least time the card could take for the fold of ``top[r, a]``,
    ``ctr[r, e, a]``: bytes read once and written once over the memory
    rate, operations over the scalar rate; the larger bounds it."""
    nbytes = 4 * (r * a + r * e * a + a + e * a)
    ops = ops_per_lane * r * e * a
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return {
        "bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def project(history, tops, gen, p_remove):
    """Replica entry matrices as projections of one add history:
    ``history[E, A]`` holds each element's birth dots (0 = none) and
    ``tops[R, A]`` how far each replica has seen; a replica holds the
    dots its top covers, minus the element rows it has removed (each with
    probability ``p_remove``). Every such state is one a real replica can
    reach, so the join is associative on them and any fold order gives
    the same bits."""
    import torch

    r = tops.shape[0]
    e = history.shape[0]
    ctr = torch.where(history[None] <= tops[:, None, :], history[None], 0)
    alive = torch.rand((r, e, 1), generator=gen, device=history.device) >= p_remove
    return ctr * alive


def random_entries(r, e, a, high, gen, device):
    """``top[r, a]``, ``ctr[r, e, a]`` (u32) projected from a history with
    ~70% of dots set and values 1..99 (or within 99 of 2^32-1 when
    ``high``); ``top >= max ctr`` per replica."""
    import torch

    from crdt_tpu_torch._dtypes import from_wide

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int64)

    history = draw(1, 100, (e, a)) * (draw(0, 10, (e, a)) >= 3)
    top = draw(0, 100, (r, a))
    ctr = project(history, top, gen, 0.05 / r)
    if high:
        base = (1 << 32) - 100
        ctr = torch.where(ctr > 0, ctr + base, 0)
        top = top + base
    return from_wide(top, torch.uint32), from_wide(ctr, torch.uint32)


def max_abs_diff(x, y) -> int:
    from crdt_tpu_torch._dtypes import to_wide

    if x.numel() == 0:
        return 0
    return int((to_wide(x) - to_wide(y)).abs().max())


# ---- phase 1 -------------------------------------------------------------

def phase_device(device) -> dict:
    import torch

    from crdt_tpu_torch.ops import _build

    smi = card_label(device)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, started together
        list(pool.map(_build.library, SOURCES))
    load_s = time.perf_counter() - t0
    info = {src: _build.build_info[src] for src in SOURCES}
    ptxas = {src: [ln.strip() for ln in i["log"].splitlines()
                   if "registers" in ln or "spill" in ln or "Compiling" in ln]
             for src, i in info.items()}
    out = {
        "phase": "device",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "device_name": torch.cuda.get_device_name(device),
        "capability": list(torch.cuda.get_device_capability(device)),
        "nvcc_seconds": {src: i["seconds"] for src, i in info.items()},
        "build_and_load_seconds": load_s,
        "ptxas": ptxas,
    }
    emit(out)
    return out


# ---- phase 2 -------------------------------------------------------------

K1_CASES = (
    # (R, E, A, counters near 2^32-1, n_passes)
    (1, 1000, 8, False, 1),
    (3, 777, 2, False, 1),
    (64, 1000, 8, False, 1),
    (64, 999, 32, False, 1),
    (5, 130, 12, False, 1),
    (3, 1001, 8, True, 1),
    (64, 777, 32, True, 3),
    (64, 1000, 8, False, 3),
    (7, 100, 2, True, 3),
)


def phase_k1_shapes(device, seed: int) -> int:
    """K1 vs its plain version at each case; returns the max |diff| (0)."""
    import torch

    from crdt_tpu_torch.ops.fold_kernels import fold_entries, fold_entries_plain

    gen = torch.Generator(device=device).manual_seed(seed)
    worst, rows = 0, []
    for r, e, a, high, passes in K1_CASES:
        top, ctr = random_entries(r, e, a, high, gen, device)
        kt, kc = fold_entries(top, ctr, passes)
        pt, pc = fold_entries_plain(top, ctr, passes)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = max(max_abs_diff(kt, pt), max_abs_diff(kc, pc))
        worst = max(worst, diff)
        rows.append({"R": r, "E": e, "A": a, "high": high, "n_passes": passes,
                     "max_abs_err": diff})
        check(diff == 0, f"K1 disagrees with its plain version at {rows[-1]}")
    emit({"phase": "k1_shapes", "cases": rows, "max_abs_err": worst, "tolerance": 0})
    return worst


# ---- phase 3 -------------------------------------------------------------

MEMBERS = list(range(6))


def mint_sites(rng, n_sites, n_cmds):
    """Each site mints ops under its own actor and occasionally merges
    another site's state, so later rm clocks cover other actors' dots
    (their delivery ahead of those adds parks them)."""
    from crdt_tpu_torch.pure.orswot import Orswot

    sites = [Orswot() for _ in range(n_sites)]
    streams = [[] for _ in range(n_sites)]
    for _ in range(n_cmds):
        i = rng.randrange(n_sites)
        s = sites[i]
        roll = rng.random()
        if roll < 0.5 or not s.read().val:
            op = s.add(rng.choice(MEMBERS), s.read().derive_add_ctx(f"s{i}"))
        elif roll < 0.8:
            victim = rng.choice(sorted(s.read().val))
            op = s.rm(victim, s.contains(victim).derive_rm_ctx())
        else:
            s.merge(sites[rng.randrange(n_sites)].clone())
            continue
        s.apply(op)
        streams[i].append(op)
    return sites, streams


def interleave(rng, queues):
    """Random merge of sequences, preserving each one's inner order."""
    queues = [list(q) for q in queues if q]
    out = []
    while queues:
        i = rng.randrange(len(queues))
        out.append(queues[i].pop(0))
        if not queues[i]:
            queues.pop(i)
    return out


def phase_scenarios(device, seed: int, rounds: int = 6) -> dict:
    import torch

    from crdt_tpu_torch.config import configured
    from crdt_tpu_torch.dot import Dot
    from crdt_tpu_torch.models import BatchedOrswot, DeferredOverflow
    from crdt_tpu_torch.ops.fold_kernels import fold_entries
    from crdt_tpu_torch.pure.orswot import Add, Orswot, Rm
    from crdt_tpu_torch.traits import DotRange
    from crdt_tpu_torch.utils import Interner
    from crdt_tpu_torch.vclock import VClock

    rng = random.Random(seed)
    counts = {"ops": 0, "merges": 0, "folds": 0, "parked_seen": 0}
    launches0 = fold_entries.launches
    for _ in range(rounds):
        n = rng.randint(3, 5)
        sites, streams = mint_sites(rng, n, 24)
        actors = Interner([f"s{i}" for i in range(n)])
        members = Interner(MEMBERS)
        # State round trip through the device is lossless.
        model = BatchedOrswot.from_pure(sites, members=members, actors=actors,
                                        deferred_cap=8, device=device)
        for i, s in enumerate(sites):
            check(model.to_pure(i) == s, "from_pure/to_pure round trip")

        # Cross-delivery: every replica gets random prefixes of every
        # stream, interleaved with per-stream order kept.
        replicas = [Orswot() for _ in range(n)]
        model = BatchedOrswot(n, len(MEMBERS), n, 8, members=members.clone(),
                              actors=actors.clone(), device=device)
        for j in range(n):
            cut = [q[: rng.randint(0, len(q))] for q in streams]
            for op in interleave(rng, cut):
                replicas[j].apply(op)
                model.apply(j, op)
                counts["ops"] += 1
            check(model.to_pure(j) == replicas[j], f"op path, replica {j}")
            counts["parked_seen"] += len(replicas[j].deferred)

        # rm of a member nobody has: a no-op on both sides.
        ghost = Rm(clock=VClock({"s0": 1}), members=(MEMBERS[-1] + 100,))
        with expect_raises(IndexError):
            model.apply(0, ghost)  # the member universe is full: refused
        check(model.to_pure(0) == replicas[0], "refused op left state untouched")

        # Pairwise merges and repeated self-merge.
        for _ in range(n):
            dst, src = rng.randrange(n), rng.randrange(n)
            replicas[dst].merge(replicas[src].clone())
            model.merge_from(dst, src)
            counts["merges"] += 1
            check(model.to_pure(dst) == replicas[dst], "merge_from vs oracle merge")
        before = model.to_pure(0)
        model.merge_from(0, 0)
        model.merge_from(0, 0)
        check(model.to_pure(0) == before, "repeated self-merge changed state")

        # Full fold (K1 on a card) vs the oracle merge chain.
        expect = Orswot()
        for s in replicas:
            expect.merge(s.clone())
        check(model.fold() == expect, "fold vs oracle merge chain")
        counts["folds"] += 1

    # rm of an unseen member with spare lanes: interned, no dot to remove.
    spare = BatchedOrswot(1, 4, 2, 4, device=device)
    pure = Orswot()
    op = Rm(clock=VClock(), members=("never-added",))
    spare.apply(0, op)
    pure.apply(op)
    check(spare.to_pure(0) == pure, "rm of an unseen member")

    # Strict mode: gapped and duplicate dots raise DotRange on both sides,
    # and the rejected op leaves the replica and its interners unchanged.
    with configured(strict=True):
        m = BatchedOrswot(1, 4, 2, 4, device=device)
        p = Orswot()
        first = Add(dot=Dot("a", 1), members=("x",))
        m.apply(0, first)
        p.apply(first)
        for bad in (Add(dot=Dot("a", 3), members=("y",)), Add(dot=Dot("a", 1), members=("y",))):
            for target in (lambda: m.apply(0, bad), lambda: p.validate_op(bad)):
                with expect_raises(DotRange):
                    target()
        check(m.to_pure(0) == p and "y" not in m.members, "rejected op had effects")

    # DeferredOverflow at a small cap: two distinct ahead removes, one slot.
    tight = BatchedOrswot(1, 4, 2, 1, device=device)
    tight.apply(0, Rm(clock=VClock({"a": 5}), members=("x",)))
    with expect_raises(DeferredOverflow):
        tight.apply(0, Rm(clock=VClock({"a": 6}), members=("y",)))

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts["k1_launches"] = fold_entries.launches - launches0
    check(device.type != "cuda" or counts["k1_launches"] == counts["folds"],
          "the card's folds did not all go through K1")
    check(counts["parked_seen"] > 0, "no scenario parked an ahead remove")
    emit({"phase": "scenarios", **counts})
    return counts


class expect_raises:
    """``with expect_raises(Exc): ...`` — fail unless the body raises
    ``Exc``."""

    def __init__(self, exc):
        self.exc = exc

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        if typ is None:
            raise AssertionError(f"expected {self.exc.__name__}")
        return issubclass(typ, self.exc)


# ---- phase 4 -------------------------------------------------------------

def config3_history(draw, e: int, a: int):
    """Config 3's add history ``[e, a]``: ~70% of the (member, actor) dots
    set, values 1..99 (``draw(lo, hi, shape)`` draws integers)."""
    return draw(1, 100, (e, a)) * (draw(0, 10, (e, a)) >= 3)


def config3_tops(draw, r: int, a: int):
    """How far each of ``r`` replicas has seen each actor: 90..99."""
    return draw(90, 100, (r, a))


def fill_config3(model, seed: int, chunk: int):
    """Replica states in place, chunk by chunk on the device, projected
    from one add history (``project``): ~70% of the history's dots set,
    values 1..99, each replica's top drawn from 90..99 per actor, so each
    holds ~65% of its dots (bench.py's config 3 draws ~70%, independently
    per replica); ~5% of the members are removed by one replica each. Plus parked removes ahead of every top in 64 replicas,
    drawn from D distinct rm clocks, so the fold's epilogue dedupes,
    replays and keeps D of them."""
    import torch

    from crdt_tpu_torch._dtypes import bits

    st = model.state
    r, e, a = st.ctr.shape
    d = st.dvalid.shape[-1]
    dev = st.ctr.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    ctr32, top32, dcl32 = bits(st.ctr), bits(st.top), bits(st.dcl)
    history = config3_history(draw, e, a)
    for lo in range(0, r, chunk):
        hi = min(r, lo + chunk)
        tops = config3_tops(draw, hi - lo, a)
        ctr32[lo:hi] = project(history, tops, gen, 0.05 / r)
        top32[lo:hi] = tops
    clocks = draw(0, 100, (d, a))
    clocks[:, 0] = 100 + torch.arange(d, device=dev, dtype=torch.int32)  # ahead of every top
    parked = torch.linspace(0, r - 1, min(64, r), device=dev).long()
    which = torch.arange(parked.numel(), device=dev) % d
    dcl32[parked, 0] = clocks[which]
    st.dvalid[parked, 0] = True
    st.dmask[parked, 0] = torch.rand((parked.numel(), e), generator=gen, device=dev) < 0.01


def profile_busy(fn, device, host_top: int = 0):
    """Run ``fn()`` once under ``torch.profiler``: wall time, the summed
    device time of its kernels, their share of the wall time, the kernels
    that took most of it and (``host_top``) the host-side ops with the
    most self CPU time. None off a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host = [], []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            host.append((ev.self_cpu_time_total / 1e3, ev.key, ev.count))
            continue  # host-side ops; their kernels are listed on their own
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in rows)
    out = {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "sort_ms": sum(ms for ms, k, _ in rows if "sort" in k.lower()),
        "top": [{"kernel": k[:80], "ms": ms, "calls": n} for ms, k, n in rows[:6]],
        "launch_kernel_calls": sum(n for _, k, n in host if k == "cudaLaunchKernel"),
    }
    if host_top:
        host.sort(reverse=True)
        out["host_top"] = [{"op": k[:60], "self_cpu_ms": ms, "calls": n}
                           for ms, k, n in host[:host_top]]
    return out


def graph_ms(fn, device, n: int) -> float:
    """Per-call ms of ``n`` calls of ``fn`` captured in one CUDA graph and
    replayed between CUDA events: the host-side wrapper runs once, at
    capture, so the replay times the device work of the calls alone. The
    host clock on the CPU."""
    import torch

    if device.type != "cuda":
        return time_each(fn, device, n)
    graph = capture(fn, device, n)
    graph.replay()
    torch.cuda.synchronize(device)
    return time_ms(graph.replay, device) / n


def capture(fn, device, n: int, keep_graph: bool = False):
    """A CUDA graph of ``n`` calls of ``fn``, captured on a side stream
    after one warm-up call on that stream (so a call's one-time
    allocations happen before the capture)."""
    import torch

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    return graph


# CUgraphNodeType (CUDA driver API).
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "wait_event", 7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def graph_nodes(fn, device, n: int) -> dict:
    """The device operations ``n`` calls of ``fn`` issue: the nodes of a
    CUDA graph that captures them, counted by type through the driver
    API (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    import ctypes

    graph = capture(fn, device, n, keep_graph=True)
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0, "cuGraphGetNodes failed")
    kinds = {}
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        name = GRAPH_NODE_TYPES.get(kind.value, str(kind.value))
        kinds[name] = kinds.get(name, 0) + 1
    return kinds


def kernel_device_ms(fn, device, name: str, n: int):
    """Mean device time of the kernels whose name contains ``name``, over
    ``n`` calls of ``fn`` under ``torch.profiler`` (the device's own
    clock: the host's wrapper overhead is not in it). None off a card or
    when the profiler shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(device)
    total, calls = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            total += us if us is not None else getattr(ev, "self_cuda_time_total", 0)
            calls += ev.count
    return total / 1e3 / calls if calls else None


def phase_full_width(device, seed: int, r=10240, e=102400, a=8, d=4,
                     chunk=512, repeats=6, stream_rows=1024, p=8) -> dict:
    import torch

    from crdt_tpu_torch._dtypes import bits, from_wide, to_wide
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.models.orswot import _to_pure
    from crdt_tpu_torch.ops.fold_kernels import (
        fold_entries, fold_entries_plain, fold_fused, settle_folded,
    )
    from crdt_tpu_torch.ops.orswot import DTYPE, _join_entries
    from crdt_tpu_torch.utils import Interner

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    model = BatchedOrswot(r, e, a, d, members=Interner(range(e)),
                          actors=Interner(f"a{i}" for i in range(a)), device=device)
    fill_config3(model, seed, chunk)
    sync()
    setup_s = time.perf_counter() - t0
    st = model.state

    # The main path, counted: BatchedOrswot.fold() must go through K1.
    fold_entries.launches = 0
    t0 = time.perf_counter()
    converged = model.fold()
    sync()
    fold_e2e_ms = (time.perf_counter() - t0) * 1e3
    launches = fold_entries.launches
    check(device.type != "cuda" or launches >= 1, "BatchedOrswot.fold() did not launch K1")

    # K1 alone, timed with CUDA events (each run streams 33.5 GB: the
    # 50 MB L2 cannot hold it, so every run reads device memory cold).
    times, out = [], None
    for _ in range(repeats):
        def run():
            nonlocal out
            out = fold_entries(st.top, st.ctr)
        times.append(time_ms(run, device))
    k_top, k_ctr = out
    k1_ms = statistics.median(times)

    # The check: the plain fold over 512-replica chunks, joined in turn.
    def plain():
        acc = None
        for lo in range(0, r, chunk):
            pt, pc = fold_entries_plain(st.top[lo:lo + chunk], st.ctr[lo:lo + chunk])
            part = (to_wide(pt), to_wide(pc))
            acc = part if acc is None else _join_entries(*acc, *part)
        return from_wide(acc[0], DTYPE), from_wide(acc[1], DTYPE)

    result = {}
    plain_ms = time_ms(lambda: result.update(zip(("top", "ctr"), plain())), device)
    diff = max(max_abs_diff(k_top, result["top"]), max_abs_diff(k_ctr, result["ctr"]))
    check(diff == 0, f"K1 at full width disagrees with the chunked plain fold (max {diff})")

    settled, overflow = settle_folded(result["top"], result["ctr"], st)
    check(not bool(overflow), "unexpected deferred overflow")
    expect = _to_pure(settled, model.members, model.actors)
    check(converged == expect, "converged state differs from the chunked plain fold's")
    check(len(converged.entries) > e // 2, "the fold lost most members")
    check(len(converged.deferred) == d, "the parked ahead-removes did not survive")

    # The dense stream: the same population in `stream_rows`-row blocks
    # through mesh_stream_fold on P virtual ranks, whose rank-local folds
    # are fold_auto (K1 + epilogue on the card) — counted, and held leaf
    # for leaf against fold_fused.
    stream = dense_stream_check(st, device, stream_rows, p)

    # Where fold() spends its time: K1 + epilogue on the device, then the
    # read back to oracle form on the host; and the device's busy share
    # of one more fold() under the profiler.
    fused_ms = time_ms(lambda: fold_fused(st), device)
    t0 = time.perf_counter()
    _to_pure(settled, model.members, model.actors)
    read_ms = (time.perf_counter() - t0) * 1e3
    busy = profile_busy(model.fold, device)

    bound = fold_bound_ms(r, e, a)
    out = {
        "phase": "full_width",
        "R": r, "E": e, "A": a, "D": d,
        "setup_s": setup_s,
        "k1_ms_median": k1_ms, "k1_ms_runs": times,
        "k1_gb_per_s": bound["bytes"] / (k1_ms * 1e-3) / 1e9,
        "merges_per_s": (r - 1) / (k1_ms * 1e-3),
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "bound_share": bound["bound_ms"] / k1_ms,
        "plain_chunked_ms_check_not_a_yardstick": plain_ms,
        "fold_e2e_ms_incl_epilogue_and_to_pure": fold_e2e_ms,
        "fold_fused_ms_k1_plus_epilogue": fused_ms,
        "to_pure_ms": read_ms,
        "fold_profile": busy,
        "k1_launches_in_fold": launches,
        "max_abs_err": diff,
        "converged_members": len(converged.entries),
        "converged_parked": len(converged.deferred),
        "dense_stream": stream,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
    }
    emit(out)
    return out


def dense_stream_check(st, device, block_rows: int, p: int) -> dict:
    """``mesh_stream_fold`` of the dense batch ``st`` in ``block_rows``-row
    blocks on ``p`` virtual ranks: K1 must launch once per rank and block,
    and the converged state must equal ``fold_fused``'s on every leaf."""
    import torch

    from crdt_tpu_torch.ops.fold_kernels import fold_entries, fold_fused
    from crdt_tpu_torch.parallel import VirtualMesh, iter_blocks, mesh_stream_fold

    r = st.top.shape[0]
    n_blocks = -(-r // block_rows)
    fold_entries.launches = 0
    t0 = time.perf_counter()
    got, of = mesh_stream_fold(iter_blocks(st, block_rows), VirtualMesh(p, device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stream_ms = (time.perf_counter() - t0) * 1e3
    launches = fold_entries.launches
    check(device.type != "cuda" or launches == n_blocks * p,
          f"the dense stream launched K1 {launches} times for {n_blocks} blocks on {p} ranks")
    want, want_of = fold_fused(st)
    check(same_leaves(got, want), "the dense stream differs from fold_fused")
    check(bool(of) == bool(want_of), "the dense stream's overflow differs from fold_fused's")
    return {"block_rows": block_rows, "P": p, "blocks": n_blocks,
            "k1_launches_in_stream": launches, "stream_ms_first_run": stream_ms}


# ---- phase 5 -------------------------------------------------------------

K2_CASES = (
    # (R, K, A, counters near 2^32-1)
    (1, 1000, 4, False),
    (3, 777, 1, False),
    (8, 1001, 3, True),
    (8, 999, 4, True),
    (5, 130, 8, False),
    (64, 1000, 4, False),
    (64, 777, 8, True),
    (7, 333, 32, True),
    (64, 100, 32, False),
)


def random_cells(r, k, a, high, gen, device):
    """``top[r, a]``, ``wctr[r, k, a]`` (u32) as real replicas reach them:
    actor y writes key k at counter c1 and perhaps later at c2 > c1
    (which evicts c1); a replica holds the newest write its top covers,
    unless it removed it (15%). Values 1..99, or within 99 of 2^32-1 when
    ``high``."""
    import torch

    from crdt_tpu_torch._dtypes import from_wide

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int64)

    c1 = draw(1, 50, (k, a)) * (draw(0, 10, (k, a)) < 8)
    c2 = torch.where(c1 > 0, c1 + draw(1, 50, (k, a)), 0) * draw(0, 2, (k, a))
    top = draw(0, 100, (r, a))
    t = top[:, None, :]
    held = torch.where((c2 > 0) & (c2 <= t), c2, torch.where((c1 > 0) & (c1 <= t), c1, 0))
    held = held * (torch.rand((r, k, a), generator=gen, device=device) >= 0.15)
    if high:
        base = (1 << 32) - 100
        held = torch.where(held > 0, held + base, 0)
        top = top + base
    return from_wide(top, torch.uint32), from_wide(held, torch.uint32)


def phase_k2_shapes(device, seed: int) -> int:
    """K2 vs its plain version at each case; returns the max |diff| (0)."""
    import torch

    from crdt_tpu_torch.ops.fold_kernels import fold_cells, fold_cells_plain

    gen = torch.Generator(device=device).manual_seed(seed + 2)
    worst, rows = 0, []
    for r, k, a, high in K2_CASES:
        top, wctr = random_cells(r, k, a, high, gen, device)
        kt, kw = fold_cells(top, wctr)
        pt, pw = fold_cells_plain(top, wctr)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        diff = max(max_abs_diff(kt, pt), max_abs_diff(kw, pw))
        worst = max(worst, diff)
        rows.append({"R": r, "K": k, "A": a, "high": high, "max_abs_err": diff})
        check(diff == 0, f"K2 disagrees with its plain version at {rows[-1]}")
    refused = 0
    if device.type == "cuda":
        top, wctr = random_cells(3, 64, 33, False, gen, device)
        with expect_raises(ValueError):
            fold_cells(top, wctr)  # A > 32
        top, wctr = random_cells(3, 64, 8, False, gen, device)
        with expect_raises(ValueError):
            fold_cells(top, wctr.transpose(1, 2).contiguous().transpose(1, 2))  # non-contiguous
        with expect_raises(TypeError):
            fold_cells(top, wctr.view(torch.int32))
        refused = 3
    emit({"phase": "k2_shapes", "cases": rows, "max_abs_err": worst, "tolerance": 0,
          "refused_inputs": refused})
    return worst


# ---- phase 6 -------------------------------------------------------------

MAP_KEYS = list("pqrs")


def mint_map_sites(rng, n_sites, n_cmds):
    """Map<K, MVReg> sites: each writes keys under its own actor, removes
    keys it sees, and occasionally merges another site's state, so later
    remove clocks cover other actors' dots (their delivery ahead of those
    writes parks them)."""
    from crdt_tpu_torch.pure import Map, MVReg

    sites = [Map(MVReg) for _ in range(n_sites)]
    streams = [[] for _ in range(n_sites)]
    for _ in range(n_cmds):
        i = rng.randrange(n_sites)
        s = sites[i]
        roll = rng.random()
        if roll < 0.4 or not s.keys():
            val = rng.randrange(5)
            op = s.update(rng.choice(MAP_KEYS), s.len().derive_add_ctx(f"s{i}"),
                          lambda reg, c: reg.write(val, c))
        elif roll < 0.65:
            victim = rng.choice(sorted(s.keys()))
            op = s.rm(victim, s.get(victim).derive_rm_ctx())
        else:
            s.merge(sites[rng.randrange(n_sites)].clone())
            continue
        s.apply(op)
        streams[i].append(op)
    return sites, streams


def phase_map_scenarios(device, seed: int, rounds: int = 6) -> dict:
    import torch

    from crdt_tpu_torch.config import configured
    from crdt_tpu_torch.dot import Dot
    from crdt_tpu_torch.models import BatchedMap, DeferredOverflow, SlotOverflow
    from crdt_tpu_torch.ops.fold_kernels import fold_cells
    from crdt_tpu_torch.pure import Map, MVReg
    from crdt_tpu_torch.pure.map import MapRm, Up
    from crdt_tpu_torch.pure.mvreg import Put
    from crdt_tpu_torch.traits import DotRange
    from crdt_tpu_torch.utils import Interner
    from crdt_tpu_torch.vclock import VClock

    rng = random.Random(seed + 6)
    counts = {"ops": 0, "merges": 0, "folds": 0, "parked_seen": 0, "resets": 0}
    launches0 = fold_cells.launches
    for _ in range(rounds):
        n = rng.randint(3, 5)
        sites, streams = mint_map_sites(rng, n, 24)
        actors = Interner([f"s{i}" for i in range(n)])
        keys, values = Interner(MAP_KEYS), Interner(range(5))
        caps = dict(sibling_cap=n, deferred_cap=8)
        # State round trip through the device is lossless.
        model = BatchedMap.from_pure(sites, keys=keys.clone(), actors=actors.clone(),
                                     values=values.clone(), device=device, **caps)
        for i, s in enumerate(sites):
            check(model.to_pure(i) == s, "from_pure/to_pure round trip")

        # Cross-delivery: every replica gets random prefixes of every
        # stream, interleaved with per-stream order kept.
        replicas = [Map(MVReg) for _ in range(n)]
        model = BatchedMap(n, len(MAP_KEYS), n, keys=keys.clone(), actors=actors.clone(),
                           values=values.clone(), device=device, **caps)
        for j in range(n):
            cut = [q[: rng.randint(0, len(q))] for q in streams]
            for op in interleave(rng, cut):
                replicas[j].apply(op)
                model.apply(j, op)
                counts["ops"] += 1
            check(model.to_pure(j) == replicas[j], f"map op path, replica {j}")
            counts["parked_seen"] += len(replicas[j].deferred)

        # Garbage ops and a key outside the full universe are refused and
        # leave the replica untouched.
        with expect_raises(TypeError):
            model.apply(0, "not an op")
        with expect_raises(IndexError):
            model.apply(0, MapRm(clock=VClock({"s0": 1}), keyset=("ghost",)))
        check(model.to_pure(0) == replicas[0], "refused op left state untouched")

        # Pairwise merges and repeated self-merge.
        for _ in range(n):
            dst, src = rng.randrange(n), rng.randrange(n)
            replicas[dst].merge(replicas[src].clone())
            model.merge_from(dst, src)
            counts["merges"] += 1
            check(model.to_pure(dst) == replicas[dst], "map merge_from vs oracle merge")
        before = model.to_pure(0)
        model.merge_from(0, 0)
        model.merge_from(0, 0)
        check(model.to_pure(0) == before, "repeated self-merge changed state")

        # Full fold (K2 on a card) vs the oracle merge chain.
        expect = Map(MVReg)
        for s in replicas:
            expect.merge(s.clone())
        check(model.fold() == expect, "map fold vs oracle merge chain")
        counts["folds"] += 1

        # reset_remove of one actor's early history.
        clock = VClock({"s0": 2, f"s{n - 1}": 1})
        model.reset_remove(1, clock)
        replicas[1].reset_remove(clock)
        check(model.to_pure(1) == replicas[1], "map reset_remove")
        counts["resets"] += 1

    def up(actor, counter, key, val):
        dot = Dot(actor, counter)
        return Up(dot=dot, key=key, op=Put(dot=dot, clock=VClock({actor: counter}), val=val))

    # A remove that overtakes the write it covers parks, then replays
    # when the write lands.
    site = Map(MVReg)
    write = site.update("p", site.len().derive_add_ctx("a"), lambda reg, c: reg.write(1, c))
    site.apply(write)
    rm = site.rm("p", site.get("p").derive_rm_ctx())
    late = BatchedMap(1, 2, 1, device=device)
    pure = Map(MVReg)
    for op in (rm, write):
        late.apply(0, op)
        pure.apply(op)
        counts["parked_seen"] += len(pure.deferred)
        check(late.to_pure(0) == pure, "parked remove and its replay")
    check(not pure.deferred and not late.keys_of(0), "the parked remove did not replay")

    # rm of an unseen key with spare lanes: interned, nothing to remove.
    spare = BatchedMap(1, 4, 2, device=device)
    pure = Map(MVReg)
    op = MapRm(clock=VClock(), keyset=("never-written",))
    spare.apply(0, op)
    pure.apply(op)
    check(spare.to_pure(0) == pure, "rm of an unseen key")

    # Strict mode: gapped and duplicate dots raise DotRange on both sides,
    # and the rejected op leaves the replica and its interners unchanged.
    with configured(strict=True):
        m = BatchedMap(1, 4, 2, device=device)
        p = Map(MVReg)
        m.apply(0, up("a", 1, "x", 7))
        p.apply(up("a", 1, "x", 7))
        for bad in (up("a", 3, "y", 8), up("a", 1, "y", 8)):
            for target in (lambda: m.apply(0, bad), lambda: p.validate_op(bad)):
                with expect_raises(DotRange):
                    target()
        check(m.to_pure(0) == p and "y" not in m.keys, "rejected op had effects")

    # SlotOverflow: three concurrent writers of one key, two sibling slots.
    tight = BatchedMap(1, 2, 3, sibling_cap=2, device=device)
    tight.apply(0, up("a", 1, "x", 1))
    tight.apply(0, up("b", 1, "x", 2))
    with expect_raises(SlotOverflow):
        tight.apply(0, up("c", 1, "x", 3))
    # DeferredOverflow: two distinct ahead removes, one slot.
    tight = BatchedMap(1, 2, 2, deferred_cap=1, device=device)
    tight.apply(0, MapRm(clock=VClock({"a": 5}), keyset=("x",)))
    with expect_raises(DeferredOverflow):
        tight.apply(0, MapRm(clock=VClock({"a": 6}), keyset=("y",)))

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts["k2_launches"] = fold_cells.launches - launches0
    check(device.type != "cuda" or counts["k2_launches"] == counts["folds"],
          "the card's map folds did not all go through K2")
    check(counts["parked_seen"] > 0, "no map scenario parked an ahead remove")
    emit({"phase": "map_scenarios", **counts})
    return counts


# ---- phase 7 -------------------------------------------------------------

def fill_config4(model, seed: int, chunk: int, n_parked: int = 16, n_clocks: int = 4,
                 max_lag: float = 0.02, p_remove: float = 0.01):
    """Replica states in place, on the device, ``chunk`` keys at a time:
    ``bench.py``'s config-4 layout (``bench_map``) — one fixed counter per
    (key, slot), key·S + j + 1, written with only its own actor lane set
    in the write clock; slot 0 always written, later slots with
    probability 1/2; actors rotate over the slots — drawn as projections
    of ONE write history, so that the replicas converge to a map that
    fits S sibling slots. The write at (key k, slot j) is actor
    (k + j) % A's; replica i has seen each actor's writes up to its top,
    which lags the history's end by up to ``max_lag``; it holds every
    write its top covers, except the keys it removed (probability
    ``p_remove / R`` per key). Slot tables are canonical (live slots
    first, by actor). Plus ``n_parked`` keyset-removes parked ahead of
    every top over ``n_clocks`` distinct clocks, together masking ~1% of
    the keys, so the fused fold's epilogue dedupes, replays and keeps
    ``n_clocks`` slots."""
    import torch

    from crdt_tpu_torch._dtypes import bits, from_wide

    st = model.state
    c = st.child
    r, k, s = c.wact.shape
    a, d = st.top.shape[-1], st.dvalid.shape[-1]
    dev = st.top.device
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    end = k * s  # the history's last counter
    lag = torch.rand((r, a), generator=gen, device=dev) * max_lag * end
    top = (end - lag).long()
    slot = torch.arange(s, device=dev)
    for lo in range(0, k, chunk):
        hi = min(k, lo + chunk)
        keys = torch.arange(lo, hi, device=dev)[:, None]
        ctr = (keys * s + slot + 1).expand(r, hi - lo, s)
        act = ((keys + slot) % a).expand(r, hi - lo, s)
        written = (slot == 0) | (torch.rand((hi - lo, s), generator=gen, device=dev) < 0.5)
        kept = torch.rand((r, hi - lo, 1), generator=gen, device=dev) >= p_remove / r
        held = written & kept & (ctr <= torch.gather(top[:, None, :].expand(r, hi - lo, a), 2, act))
        # Canonical slot order: live slots first, then by actor.
        order = torch.argsort((~held).long() * a + act, dim=-1, stable=True)
        held, act, ctr = (torch.gather(x, 2, order) for x in (held, act, ctr))
        clk = torch.zeros((r, hi - lo, s, a), dtype=torch.int64, device=dev)
        clk.scatter_(-1, act[..., None], ctr[..., None])
        clk = torch.where(held[..., None], clk, 0)
        c.wact[:, lo:hi] = torch.where(held, act, 0).to(torch.int32)
        bits(c.wctr)[:, lo:hi] = bits(from_wide(torch.where(held, ctr, 0), torch.uint32))
        bits(c.clk)[:, lo:hi] = bits(from_wide(clk, torch.uint32))
        c.val[:, lo:hi] = torch.where(held, (ctr - 1) % 5, 0).to(torch.int32)
        c.valid[:, lo:hi] = held
    bits(st.top)[:] = bits(from_wide(top, torch.uint32))
    # Parked removes: clock lane 0 runs ahead of every top; the other
    # lanes cover every dot, so each masked key's cells die in the replay.
    pos = torch.arange(n_parked, device=dev)
    rows, slots = pos * r // n_parked, pos % min(d, 2)
    clocks = torch.full((n_clocks, a), end, dtype=torch.int64, device=dev)
    clocks[:, 0] = end + 1 + torch.arange(n_clocks, device=dev)
    bits(st.dcl)[rows, slots] = bits(from_wide(clocks[pos % n_clocks], torch.uint32))
    st.dvalid[rows, slots] = True
    st.dkeys[rows, slots] = torch.rand((n_parked, k), generator=gen, device=dev) < 0.01 / n_parked


def time_each(fn, device, n: int) -> float:
    """Per-call ms of ``n`` back-to-back calls of ``fn`` (CUDA events
    around the run on a card), so the host's launch overhead overlaps
    with the device's work instead of adding to a short kernel's time."""
    return time_ms(lambda: [fn() for _ in range(n)], device) / n


def phase_full_width_map(device, seed: int, r: int = 8, k: int = 1_000_000, s: int = 2,
                         a: int = 4, d: int = 4, chunk: int = 1 << 17, repeats: int = 7,
                         per_sample: int = 20, e2e: bool = True) -> dict:
    """Config 4 at ``r`` replicas (module docstring, phase 7). ``e2e=False``
    leaves out ``BatchedMap.fold()`` end to end, its profile and the
    ``to_pure`` check: each reads the same 1M-key map back to the host
    (≈ 24 s each on the card), which the R = 8 leg already times."""
    import torch

    from crdt_tpu_torch.models import BatchedMap
    from crdt_tpu_torch.models.map import _to_pure
    from crdt_tpu_torch.ops.fold_kernels import (
        decode_cells, fold_cells, fold_cells_plain, fold_fused_map, settle_folded_map,
    )
    from crdt_tpu_torch.ops.map import _tree_fold
    from crdt_tpu_torch.utils import Interner
    from crdt_tpu_torch._dtypes import bits

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = BatchedMap(r, k, a, s, d, keys=Interner(range(k)),
                       actors=Interner(f"a{i}" for i in range(a)), values=Interner(range(5)),
                       device=device)
    fill_config4(model, seed, chunk)
    sync()
    setup_s = time.perf_counter() - t0
    st = model.state

    # The main path, counted: BatchedMap.fold() must go through K2.
    fold_cells.launches = 0
    if e2e:
        t0 = time.perf_counter()
        converged = model.fold()
        sync()
        fold_e2e_ms = (time.perf_counter() - t0) * 1e3
        launches = fold_cells.launches
        check(not on_card or launches >= 1, "BatchedMap.fold() did not launch K2")

    # The gate, before any number: the fused fold against the plain tree
    # fold on the same device, leaf for leaf, tolerance 0. The parked
    # buffer is a set of (clock, keys) slots whose order differs between
    # fold orders (the JAX package's fused and tree folds differ the same
    # way), so it is compared in clock order.
    fused, fused_flags = fold_fused_map(st)
    got = {}
    tree_ms = time_ms(lambda: got.update(zip(("tree", "flags"), _tree_fold(st))), device)
    tree, tree_flags = got["tree"], got["flags"]
    for (name, x), (_, y) in zip(_named_leaves(parked_in_clock_order(fused)),
                                 _named_leaves(parked_in_clock_order(tree))):
        check(x.dtype == y.dtype and torch.equal(bits(x), bits(y)),
              f"fused map fold differs from the tree fold in {name}")
    check(torch.equal(fused_flags, tree_flags), "fused and tree overflow flags differ")
    check(not bool(fused_flags.any()), "unexpected overflow at full width")
    if e2e:
        t0 = time.perf_counter()
        expect = _to_pure(fused, model.keys, model.actors, model.values)
        to_pure_ms = (time.perf_counter() - t0) * 1e3
        check(expect == converged, "BatchedMap.fold() differs from the gated fused fold")
        check(len(converged.entries) > k * 9 // 10, "the fold lost more keys than were removed")
        check(len(converged.deferred) == 4, "the parked ahead-removes did not survive")

    # K2 alone on the decoded cells, CUDA events (each sample is
    # ``per_sample`` back-to-back launches: at R=8 one launch is tens of µs).
    cells = decode_cells(st)
    times = [time_each(lambda: fold_cells(st.top, cells), device, per_sample)
             for _ in range(repeats)]
    k2_ms = statistics.median(times)
    k_top, k_w = fold_cells(st.top, cells)
    plain = {}
    plain_ms = time_ms(lambda: plain.update(zip(("top", "w"), fold_cells_plain(st.top, cells))),
                       device)
    diff = max(max_abs_diff(k_top, plain["top"]), max_abs_diff(k_w, plain["w"]))
    check(diff == 0, f"K2 at full width disagrees with its plain version (max {diff})")

    # Where fold() spends its time: decode, K2, the epilogue (winner
    # select, parked-remove replay, compaction, slot tables) and the read
    # back to oracle form on the host.
    decode_ms = statistics.median(time_ms(lambda: decode_cells(st), device) for _ in range(3))
    settle_ms = statistics.median(
        time_ms(lambda: settle_folded_map(k_top, k_w, st), device) for _ in range(3))
    fused_ms = statistics.median(time_ms(lambda: fold_fused_map(st), device) for _ in range(3))

    bound = fold_bound_ms(r, k, a, OPS_PER_CELL)
    out = {
        "phase": "full_width_map",
        "R": r, "K": k, "S": s, "A": a, "D": d,
        "setup_s": setup_s,
        "k2_ms_median": k2_ms, "k2_ms_runs": times, "k2_launches_per_sample": per_sample,
        "k2_gb_per_s": bound["bytes"] / (k2_ms * 1e-3) / 1e9,
        "merges_per_s": (r - 1) / (k2_ms * 1e-3),
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "bound_share": bound["bound_ms"] / k2_ms,
        "k2_plain_ms": plain_ms,
        "tree_fold_ms_gate": tree_ms,
        "decode_ms": decode_ms,
        "settle_ms_winner_select_and_epilogue": settle_ms,
        "fold_fused_map_ms": fused_ms,
        "max_abs_err": diff,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
    }
    if e2e:
        out.update({
            "fold_e2e_ms_incl_to_pure": fold_e2e_ms,
            "to_pure_ms": to_pure_ms,
            "to_pure_share_of_fold_e2e": to_pure_ms / fold_e2e_ms,
            "fold_profile": profile_busy(model.fold, device),
            "k2_launches_in_fold": launches,
            "converged_keys": len(converged.entries),
            "converged_parked": len(converged.deferred),
        })
    else:
        out["reduced"] = "fold() end to end, its profile and the to_pure check: the R = 8 leg's"
    emit(out)
    return out


def _named_leaves(state, prefix=""):
    """``(dotted name, tensor)`` for every leaf of a nested NamedTuple."""
    out = []
    for name, x in zip(state._fields, state):
        if isinstance(x, tuple):
            out += _named_leaves(x, f"{prefix}{name}.")
        else:
            out.append((prefix + name, x))
    return out


# ---- phase 8 -------------------------------------------------------------

K3_FLAGS = {
    # name -> (gated, acked, parked)
    "plain": (False, False, False),
    "gated": (True, False, False),
    "gated_acked": (True, True, False),
    "parked": (False, False, True),
}
K3_NS = (1, 31, 1024, 65537)
# Every row-group width G = the power of two >= ceil(LC / 2): 1 (LC 1, 2),
# 2 (3), 4 (8), 8 (16), 16 (17), 32 (33, and 64 with W = 32).
K3_LCS = (1, 2, 3, 8, 16, 17, 33, 64)
K3_BS = (1, 8)
# (B, layout): contiguous per-row inputs at every B, and at the largest B
# also the ring's layout (broadcast watermark and digest, ``know`` inside
# ``clocks``).
K3_LAYOUTS = tuple((b, "rows") for b in K3_BS) + ((K3_BS[-1], "ring"),)
# Grouped launches (``wire_pack_many``), each instance (flags, LC, B, N,
# layout): the δ ring's round (slot + parked), two pairs that differ in
# every field, and a group of the kernel's four instances.
K3_GROUPS = (
    (("gated", 16, 8, 4096, "ring"), ("parked", 8, 8, 4, "ring")),
    (("gated_acked", 33, 8, 1024, "rows"), ("plain", 3, 1, 65537, "rows")),
    (("parked", 64, 8, 31, "ring"), ("gated", 17, 1, 1, "rows")),
    (("plain", 1, 8, 1024, "rows"), ("gated", 8, 1, 65537, "ring"),
     ("gated_acked", 64, 8, 31, "rows"), ("parked", 2, 1, 1, "rows")),
)


def k3_spec(flags: str, lc: int):
    """The WireLaneSpec of one K3 case: the ctx plane is the last
    ``max(1, lc // 2)`` columns where a verdict reads it."""
    from crdt_tpu_torch.ops.wire_kernels import WireLaneSpec

    gated, acked, parked = K3_FLAGS[flags]
    a = max(1, lc // 2)
    ctx = (lc - a, lc) if (gated or acked) else (0, 0)
    return WireLaneSpec(lc=lc, ctx_lo=ctx[0], ctx_hi=ctx[1], gated=gated, acked=acked,
                        parked=parked)


def random_wire_case(spec, b, n, dtype, gen, device):
    """K3's inputs ``[b, n, lc]`` around a per-row watermark: lanes within
    ±40 of it, a quarter of the rows with one lane 40,000 or 2^30 away
    (outside the ±32 Ki window: deferred when valid and ungated), 30% of
    the bases within 20 of the dtype's max with clocks wrapping past it,
    and gate / ack inputs that cover some rows and miss others."""
    import torch

    from crdt_tpu_torch._dtypes import from_raw

    lc = spec.lc
    a = spec.ctx_hi - spec.ctx_lo

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int64)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    wide = dtype == torch.uint64
    top = -1 if wide else (1 << 32) - 1  # the dtype's max, as its raw int64 bits
    base = draw(0, 1 << 20, (b, n, lc))
    base = torch.where(rand((b, n, 1)) < 0.3, top - draw(0, 20, (b, n, lc)), base)
    delta = draw(-40, 40, (b, n, lc))
    far = (rand((b, n, 1)) < 0.25) & (draw(0, lc, (b, n, 1)) == torch.arange(lc, device=device))
    jump = torch.where(rand((b, n, lc)) < 0.5, 40_000, 1 << 30) * torch.where(
        rand((b, n, lc)) < 0.5, -1, 1)
    raw_clocks = base + torch.where(far, jump, delta)
    clocks, base = from_raw(raw_clocks, dtype), from_raw(base, dtype)
    out = dict(clocks=clocks, base=base, valid=rand((b, n)) < 0.8)
    if spec.gated:
        ctx = raw_clocks[..., spec.ctx_lo:spec.ctx_hi]
        know = torch.where((rand((b, n, 1)) < 0.3) & (torch.arange(a, device=device) == 0),
                           ctx ^ 1, ctx)
        dig = torch.where((rand((b, n, 1)) < 0.3) & (torch.arange(a, device=device) == a - 1),
                          know - 1, know)
        out.update(know=from_raw(know, dtype), dig=from_raw(dig, dtype))
    if spec.acked:
        cols = torch.arange(lc, device=device)
        winc = torch.where((rand((b, n, 1)) < 0.3) & (cols == 0), raw_clocks ^ 2, raw_clocks)
        winc = torch.where((rand((b, n, 1)) < 0.3) & (cols == spec.ctx_lo), winc - 1, winc)
        out.update(winc=from_raw(winc, dtype), ack_ok=rand((b, n)) < 0.7)
    return out


def ring_layout(spec, case):
    """``case`` laid out as the δ ring's codec hands it to K3: the
    watermark (and the digest) one stored row per link, broadcast over the
    slots, and the gate's ``know`` read in place from ``clocks`` (here its
    ctx columns, so that the gate covers rows)."""
    out = dict(case, base=case["base"][:, :1].expand(case["base"].shape))
    if spec.gated:
        out.update(dig=case["dig"][:, :1].expand(case["dig"].shape),
                   know=case["clocks"][..., spec.ctx_lo:spec.ctx_hi])
    return out


def wire_diff(x, y) -> int:
    """Max |difference| over the leaves of two WirePackOut (flags count
    their mismatches); 0 when every leaf is equal."""
    import torch

    worst = 0
    for u, v in zip(x, y):
        check(u.shape == v.shape and u.dtype == v.dtype, "WirePackOut leaves differ in shape")
        worst = max(worst, int((u != v).sum()) if u.dtype == torch.bool else max_abs_diff(u, v))
    return worst


def phase_k3_shapes(device, seed: int) -> int:
    """K3 vs its plain version over every case; returns the max |diff| (0)."""
    import torch

    from crdt_tpu_torch.ops.wire_kernels import (
        WireLaneSpec, wire_pack, wire_pack_many, wire_pack_plain,
    )

    gen = torch.Generator(device=device).manual_seed(seed + 8)
    on_card = device.type == "cuda"
    worst, n_cases, rows = 0, 0, []
    launches0 = wire_pack.launches
    for flags in K3_FLAGS:
        for dtype in (torch.uint32, torch.uint64):
            for lc in K3_LCS:
                spec = k3_spec(flags, lc)
                for n in K3_NS:
                    for b, layout in K3_LAYOUTS:
                        case = random_wire_case(spec, b, n, dtype, gen, device)
                        if b == 1:  # the unstacked [N, LC] form
                            case = {k: v[0] for k, v in case.items()}
                        if layout == "ring":
                            case = ring_layout(spec, case)
                        got = wire_pack(spec, **case)
                        want = wire_pack_plain(spec, **case)
                        diff = wire_diff(got, want)
                        n_cases += 1
                        worst = max(worst, diff)
                        check(diff == 0, f"K3 disagrees with its plain version at "
                              f"{flags} {dtype} LC={lc} N={n} B={b} {layout} layout")
                        if n == 65537 and b == 8:
                            rows.append({"flags": flags, "dtype": str(dtype), "LC": lc,
                                         "layout": layout,
                                         "kept": int(want.keep.sum()),
                                         "deferred": int(want.defer.sum()),
                                         "covered": int(want.covered.sum())})
    n_groups = 0
    for group in K3_GROUPS:
        for dtype in (torch.uint32, torch.uint64):
            calls = []
            for flags, lc, b, n, layout in group:
                spec = k3_spec(flags, lc)
                case = random_wire_case(spec, b, n, dtype, gen, device)
                if layout == "ring":
                    case = ring_layout(spec, case)
                calls.append(dict(case, spec=spec))
            outs = wire_pack_many(calls)
            n_groups += 1
            for call, got in zip(calls, outs):
                diff = wire_diff(got, wire_pack_plain(**call))
                worst = max(worst, diff)
                check(diff == 0, f"K3 disagrees with its plain version in the group {group} "
                      f"{dtype}")
    if on_card:
        torch.cuda.synchronize(device)
    launches = wire_pack.launches - launches0
    check(not on_card or launches == n_cases + n_groups, "K3 was not launched for every case")
    refused = 0
    if on_card:
        spec = k3_spec("gated", 16)
        case = random_wire_case(spec, 2, 64, torch.uint32, gen, device)
        bad = [
            ("a CPU base with CUDA clocks", ValueError, dict(case, base=case["base"].cpu())),
            ("non-contiguous clocks", ValueError,
             dict(case, clocks=case["clocks"].transpose(0, 1).contiguous().transpose(0, 1))),
            ("int32 clocks", TypeError, dict(case, clocks=case["clocks"].view(torch.int32))),
            ("u64 base with u32 clocks", TypeError,
             dict(case, base=case["base"].to(torch.int64).view(torch.uint64))),
            ("int8 valid", TypeError, dict(case, valid=case["valid"].to(torch.int8))),
            ("base with strided lanes", ValueError,
             dict(case, base=case["base"].transpose(1, 2).contiguous().transpose(1, 2))),
        ]
        for what, exc, args in bad:
            with expect_raises(exc):
                wire_pack(spec, **args)
            refused += 1
        wide = WireLaneSpec(lc=65)
        c65 = random_wire_case(wide, 1, 8, torch.uint32, gen, device)
        with expect_raises(ValueError):
            wire_pack(wide, **c65)  # LC above the compiled maximum
        empty = random_wire_case(spec, 2, 1, torch.uint32, gen, device)
        with expect_raises(ValueError):
            wire_pack(spec, **{k: v[:, :0] for k, v in empty.items()})  # N = 0
        refused += 2
        check(wire_pack.launches - launches0 == n_cases + n_groups,
              "a refused input launched K3")
    emit({"phase": "k3_shapes", "cases": n_cases, "grouped_launches": n_groups,
          "launches": launches,
          "largest_cases": rows, "max_abs_err": worst, "tolerance": 0,
          "refused_inputs": refused})
    return worst


# ---- phase 9 -------------------------------------------------------------

def mint_tracked(rng, n, members):
    """``n`` oracle replicas from one op history with random causal
    delivery (per-actor prefixes), and each replica's applied-op log: the
    δ tests' workload (tests/test_delta.py ``_rand_states``)."""
    from crdt_tpu_torch.pure.orswot import Orswot

    reps = [Orswot() for _ in range(n)]
    applied = [[] for _ in range(n)]
    got = [[0] * n for _ in range(n)]
    seq = [0] * n
    for _ in range(rng.randint(8, 25)):
        origin = rng.randrange(n)
        m = rng.choice(members)
        if rng.random() < 0.6 or not reps[origin].read().val:
            op = reps[origin].add(m, reps[origin].read().derive_add_ctx(f"s{origin}"))
        else:
            victim = rng.choice(sorted(reps[origin].read().val))
            op = reps[origin].rm(victim, reps[origin].contains(victim).derive_rm_ctx())
        for i in range(n):
            if i == origin:
                reps[i].apply(op)
                applied[i].append(op)
            elif got[i][origin] == seq[origin] and rng.random() < 0.5:
                reps[i].apply(op)
                applied[i].append(op)
                got[i][origin] += 1
        seq[origin] += 1
    return reps, applied


def op_tracking(model, applied, device):
    """``(dirty, fctx)`` from per-replica op logs at op granularity: adds
    contribute their dot at their members, removes their clock."""
    import numpy as np

    from crdt_tpu_torch.convert import tracking_from_numpy
    from crdt_tpu_torch.pure.orswot import Add

    r = model.n_replicas
    e, a = model.state.ctr.shape[-2:]
    dirty = np.zeros((r, e), bool)
    fctx = np.zeros((r, e, a), np.uint32)
    for i, ops_i in enumerate(applied):
        for op in ops_i:
            dots = ({op.dot.actor: op.dot.counter} if isinstance(op, Add) else op.clock.dots)
            for m in op.members:
                eid = model.members.id_of(m)
                dirty[i, eid] = True
                for actor, c in dots.items():
                    aid = model.actors.id_of(actor)
                    fctx[i, eid, aid] = max(fctx[i, eid, aid], c)
    return tracking_from_numpy(dirty, fctx, device=device)


def slots_in_clock_order(dcl, mask, dvalid):
    """One parked buffer ``[..., D, ...]`` with each row's slots reordered:
    valid slots first, by clock (fold orders park the same removes in
    different slots)."""
    import torch

    from crdt_tpu_torch._dtypes import bits, to_wide

    lead, d = dvalid.shape[:-1], dvalid.shape[-1]
    valid = dvalid.reshape(-1, d).tolist()
    clocks = to_wide(dcl).reshape(-1, d, dcl.shape[-1]).tolist()
    idx = torch.tensor([sorted(range(d), key=lambda i: (not v[i], c[i]))
                        for v, c in zip(valid, clocks)], device=dvalid.device).reshape(*lead, d)
    take = lambda x: torch.take_along_dim(  # noqa: E731
        bits(x), idx.reshape(*idx.shape, *([1] * (x.dim() - idx.dim()))),
        dim=idx.dim() - 1).view(x.dtype)
    return take(dcl), take(mask), take(dvalid)


def parked_in_clock_order(state):
    """``state`` (an OrswotState or MapState, with any leading batch axes)
    with each row's parked slots reordered: valid slots first, by clock.
    Fold orders may park the same removes in different slots (the JAX
    package's fused and tree folds differ the same way)."""
    mask = "dmask" if hasattr(state, "dmask") else "dkeys"
    dcl, m, dvalid = slots_in_clock_order(state.dcl, getattr(state, mask), state.dvalid)
    return state._replace(dcl=dcl, dvalid=dvalid, **{mask: m})


def same_leaves(x, y) -> bool:
    """Every leaf of two (nested) tuples of tensors equal, bit for bit."""
    import torch

    from crdt_tpu_torch._dtypes import bits

    if isinstance(x, tuple):
        return len(x) == len(y) and all(same_leaves(u, v) for u, v in zip(x, y))
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))


def rows_equal_fold(rows, folded) -> bool:
    """Every rank's converged row equals the folded state (parked slots in
    clock order on both sides)."""
    from crdt_tpu_torch.ops.lattice import tree_map

    rows = parked_in_clock_order(rows)
    one = parked_in_clock_order(tree_map(lambda x: x[None], folded))
    return all(same_leaves(tree_map(lambda x: x[q], rows), tree_map(lambda x: x[0], one))
               for q in range(rows.top.shape[0]))


def phase_delta_scenarios(device, seed: int, n_seeds: int = 3) -> dict:
    import torch

    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip, mesh_fold

    mesh = VirtualMesh(4, device)
    counts = {"rings": 0, "certified": 0, "matched_fold": 0, "k3_launches": 0}
    launches0 = wire_pack.launches
    for k in range(n_seeds):
        rng = random.Random(seed + 90 + k)
        reps, applied = mint_tracked(rng, 8, ["a", "b", "c", "d", "e"])
        model = BatchedOrswot.from_pure(reps, device=device)
        dirty, fctx = op_tracking(model, applied, device)
        folded, of_f = mesh_fold(model.state, mesh)
        check(not bool(of_f), "mesh_fold overflowed")
        for cap in (64, 2):
            for pipeline in (True, False):
                outs = {}
                for fused in (True, False):
                    outs[fused] = mesh_delta_gossip(model.state, dirty, fctx, mesh, rounds=12,
                                                    cap=cap, pipeline=pipeline, fused=fused)
                    counts["rings"] += 1
                (fr, fd, fo, fres), (lr, ld, lo, lres) = outs[True], outs[False]
                what = f"seed {k} cap {cap} pipeline {pipeline}"
                check(same_leaves(fr, lr) and torch.equal(fd, ld) and bool(fo) == bool(lo),
                      f"fused ring differs from the layered ring ({what})")
                check(int(fres) == int(lres), f"fused and layered residue differ ({what})")
                if int(fres) == 0:
                    counts["certified"] += 1
                    check(rows_equal_fold(fr, folded), f"certified ring != mesh_fold ({what})")
                    counts["matched_fold"] += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts["k3_launches"] = wire_pack.launches - launches0
    check(device.type != "cuda" or counts["k3_launches"] > 0, "no fused ring launched K3")
    check(counts["certified"] > 0, "no scenario ring certified")
    emit({"phase": "delta_scenarios", **counts})
    return counts


# ---- phase 10 ------------------------------------------------------------

def fill_delta_config3(r, e, a, d, p, seed, device, chunk=128, n_cross=3, n_des=3,
                       max_parked=None, synced_out=None):
    """Replica states, dirty and fctx for the δ ring, on the device, chunk
    by chunk. All replicas start from ONE synced state drawn as
    ``fill_config3`` draws a replica (history with ~70% of dots set,
    values 1..99, top 90..99 per actor, ~5% of members removed). After the
    sync each actor mints a stream of L = E/100 ops over its own 1% of the
    members (2/3 adds of a fresh dot, 1/3 removes of a synced member), in
    a random order; a replica holds a prefix of every stream — rank q's
    replicas a prefix of at most H[q, a] ops, the whole stream at actor
    a's home rank (a % P), and each rank's replica 0 exactly H. Plus
    ``n_cross`` removes, each the last op of actor k + A/2's stream,
    covering the add that ends actor k's stream: ``n_des`` replicas per
    rank hold the remove but not the add, so they park it ahead of their
    top. ``(dirty, fctx)`` accumulate with ``interval_accumulate`` from
    the synced state over two steps (the adds, then the removes), so no
    dot is born and removed inside one interval (the tracking contract).
    ``max_parked`` caps the cross removes a replica holds (its first ones
    in actor order), so a replica parks at most that many and a state with
    ``d = max_parked`` is born, while a rank's fold can meet all
    ``n_cross`` (the elastic phase's overflow). ``synced_out``, a list,
    receives the synced state every replica started from. Returns
    ``(state, dirty, fctx, info)``."""
    import torch

    from crdt_tpu_torch._dtypes import bits, from_wide
    from crdt_tpu_torch.ops.orswot import empty
    from crdt_tpu_torch.parallel import interval_accumulate

    gen = torch.Generator(device=device).manual_seed(seed + 10)
    u32 = torch.uint32

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int64)

    rl = r // p
    fits = d > n_cross if max_parked is None else d >= max_parked
    check(rl * p == r and a >= 2 * n_cross and fits and rl > n_des, "bad δ shape")
    # The synced state (fill_config3's draw for one replica).
    history = config3_history(draw, e, a)
    top0 = config3_tops(draw, 1, a)
    ctr0 = project(history, top0, gen, 0.05)[0]

    # Post-sync streams: L + 1 positions per actor; position L holds the
    # cross ops (add at actor k, remove at actor k + A/2), else nothing.
    n_ops = max(3, e // 100)
    perm = torch.randperm(e, generator=gen, device=device)
    pos = torch.stack([torch.randperm(n_ops, generator=gen, device=device) for _ in range(a)])
    members = perm[: a * n_ops].reshape(a, n_ops)
    n_add = (2 * n_ops) // 3
    is_add = torch.zeros((a, n_ops + 1), dtype=torch.bool, device=device)
    is_add.scatter_(1, pos[:, :n_add], True)
    cross_m = perm[a * n_ops: a * n_ops + n_cross]
    cross_b = torch.arange(n_cross, device=device)
    cross_a = cross_b + a // 2
    is_add[cross_b, n_ops] = True
    cum = torch.cat([torch.zeros((a, 1), dtype=torch.int64, device=device),
                     torch.cumsum(is_add.long(), 1)], 1)  # adds before each position
    acts = torch.arange(a, device=device)[:, None]
    add_m = torch.cat([members[:, :n_add].reshape(-1), cross_m])
    add_a = torch.cat([acts.expand(a, n_add).reshape(-1), cross_b])
    add_j = torch.cat([pos[:, :n_add].reshape(-1), torch.full_like(cross_b, n_ops)])
    add_c = top0[0, add_a] + 1 + cum[add_a, add_j]
    rm_m = torch.cat([members[:, n_add:].reshape(-1), cross_m])
    rm_a = torch.cat([acts.expand(a, n_ops - n_add).reshape(-1), cross_a])
    rm_j = torch.cat([pos[:, n_add:].reshape(-1), torch.full_like(cross_a, n_ops)])
    rm_rc = ctr0[rm_m].clone()
    rm_rc[-n_cross:].scatter_(1, cross_b[:, None], add_c[-n_cross:, None])

    # Prefixes: rank horizons, full at the home rank, replica 0 at the
    # horizon, designated replicas holding the cross removes only.
    ranks = torch.arange(p, device=device)[:, None]
    horizon = ((n_ops + 1) * (0.4 + 0.5 * torch.rand((p, a), generator=gen, device=device))).long()
    horizon = torch.where(acts.T % p == ranks, n_ops + 1, horizon)
    hz = horizon.repeat_interleave(rl, 0)
    prefix = torch.minimum((torch.rand((r, a), generator=gen, device=device) * (hz + 1)).long(), hz)
    first = torch.arange(r, device=device) % rl
    prefix = torch.where((first == 0)[:, None], hz, prefix)
    des = (first >= 1) & (first <= n_des)
    prefix[des[:, None] & (acts.T >= a // 2) & (acts.T < a // 2 + n_cross)] = n_ops + 1
    held_b = des[:, None] & (acts.T < n_cross)
    prefix = torch.where(held_b, torch.clamp_max(prefix, n_ops), prefix)
    if max_parked is not None:
        rm_cols = prefix[:, a // 2: a // 2 + n_cross]
        over = torch.cumsum((rm_cols > n_ops).long(), 1) > max_parked
        prefix[:, a // 2: a // 2 + n_cross] = torch.where(over, torch.clamp_max(rm_cols, n_ops),
                                                          rm_cols)

    state = empty(e, a, d, batch=(r,), device=device)
    dirty = torch.zeros((r, e), dtype=torch.bool, device=device)
    fctx = torch.zeros((r, e, a), dtype=torch.int32, device=device).view(u32)
    synced = ctr0.to(torch.int32).view(u32)
    for lo in range(0, r, chunk):
        hi = min(r, lo + chunk)
        pc = prefix[lo:hi]
        top = top0 + torch.gather(cum, 1, pc.T).T
        ctr = ctr0.expand(hi - lo, e, a).clone()
        held = pc[:, add_a] > add_j
        ctr[:, add_m, add_a] = torch.where(held, add_c, ctr[:, add_m, add_a])
        mid = ctr.clone()
        held = pc[:, rm_a] > rm_j
        rows = ctr[:, rm_m]
        ctr[:, rm_m] = torch.where(held[..., None] & (rows <= rm_rc), 0, rows)
        ahead = held[:, -n_cross:] & ~torch.all(rm_rc[-n_cross:] <= top[:, None, :], -1)
        slot = torch.cumsum(ahead.long(), 1) - 1
        dcl = torch.zeros((hi - lo, d, a), dtype=torch.int64, device=device)
        dmask = torch.zeros((hi - lo, d, e), dtype=torch.bool, device=device)
        ii, kk = torch.nonzero(ahead, as_tuple=True)
        dcl[ii, slot[ii, kk]] = rm_rc[-n_cross:][kk]
        dmask[ii, slot[ii, kk], cross_m[kk]] = True
        # interval_accumulate reads the endpoint states' ctr only.
        at = lambda x: state._replace(ctr=x)  # noqa: E731
        dd, ff = interval_accumulate(dirty[lo:hi], fctx[lo:hi], at(synced.expand(hi - lo, e, a)),
                                     at(from_wide(mid, u32)))
        dd, ff = interval_accumulate(dd, ff, at(from_wide(mid, u32)), at(from_wide(ctr, u32)))
        dirty[lo:hi], bits(fctx)[lo:hi] = dd, bits(ff)
        bits(state.top)[lo:hi] = bits(from_wide(top, u32))
        bits(state.ctr)[lo:hi] = bits(from_wide(ctr, u32))
        bits(state.dcl)[lo:hi] = bits(from_wide(dcl, u32))
        state.dmask[lo:hi] = dmask
        state.dvalid[lo:hi] = torch.arange(d, device=device) < ahead.sum(1, keepdim=True)
    info = {"ops_per_actor": n_ops, "cross_removes": n_cross,
            "replicas_parking": int(state.dvalid.any(-1).sum()),
            "dirty_rows_per_replica_mean": float(dirty.sum(-1).float().mean())}
    if synced_out is not None:
        synced_out.append(empty(e, a, d, device=device)._replace(
            top=from_wide(top0[0], u32), ctr=synced))
    return state, dirty, fctx, info


def distinct_bytes(t) -> int:
    """Bytes of the distinct elements a tensor view holds: a broadcast
    (stride-0) axis counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def k3_bytes(args: dict, out) -> int:
    """The bytes K3 must move for one call: each distinct input element
    read once (``know`` read in place inside ``clocks`` adds nothing),
    each output written once."""
    clocks = args["clocks"]
    ins = [v for k, v in args.items() if k != "spec" and not (
        k == "know" and v.untyped_storage().data_ptr() == clocks.untyped_storage().data_ptr())]
    return sum(distinct_bytes(v) for v in ins) + sum(x.numel() * x.element_size() for x in out)


# K3 where bytes, not launch latency, set the bound: (flags, B, N) at
# LC 16 in the ring's layout; the last point is the fan-out plane's
# subscriber count (B * E ~ 1M rows, ROADMAP item 11).
K3_SWEEP = (("gated", 8, 4096), ("gated", 8, 65536), ("gated", 8, 262144),
            ("plain", 1, 1 << 20))


def k3_sweep(device, seed: int, points, repeats: int, per_sample: int) -> list:
    """K3 per launch (CUDA events over a replayed graph, median of
    ``repeats``) at each ``(flags, B, N)`` point, held bit-exact against its
    plain version first, with its bound (distinct bytes over the nominal
    memory rate), bound share and GB/s."""
    import torch

    from crdt_tpu_torch.ops.wire_kernels import wire_pack, wire_pack_plain

    gen = torch.Generator(device=device).manual_seed(seed + 11)
    rows = []
    for flags, b, n in points:
        spec = k3_spec(flags, 16)
        args = dict(ring_layout(spec, random_wire_case(spec, b, n, torch.uint32, gen, device)),
                    spec=spec)
        want = wire_pack_plain(**args)
        check(wire_diff(wire_pack(**args), want) == 0,
              f"K3 disagrees with its plain version at the sweep point {flags} B={b} N={n}")
        ms = statistics.median(graph_ms(lambda: wire_pack(**args), device, per_sample)
                               for _ in range(repeats))
        nbytes = k3_bytes(args, want)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append({"flags": flags, "B": b, "N": n, "LC": 16, "ms": ms, "bytes": nbytes,
                     "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                     "gb_per_s": nbytes / ms / 1e6})
        del args, want
    return rows


def certify_ring(ring, backlog: int, p: int, cap: int, counters, sync):
    """The main path, counted: ``ring(rounds, stats)`` (a fused δ ring) with
    the budget ``2·(P−1)·(1 + ⌈backlog/cap⌉ + extra) − 1`` for extra = 0,
    1, 2 until it certifies, the kernels' launch ``counters`` set to 0 just
    before each run and read just after. Returns ``(out, rounds, stats,
    attempts, launches)``."""
    attempts = []
    for extra in range(3):
        rounds = 2 * (p - 1) * (1 + -(-backlog // cap) + extra) - 1
        stats = {}
        for counted in counters:
            counted.launches = 0
        t0 = time.perf_counter()
        out = ring(rounds, stats)
        sync()
        cold_ms = (time.perf_counter() - t0) * 1e3  # the first ring: allocator growth in it
        launches = [counted.launches for counted in counters]
        attempts.append({"rounds": rounds, "residue": int(out[3]), "ring_ms_cold": cold_ms})
        if int(out[3]) == 0:
            break
    check(int(out[3]) == 0, f"the fused ring did not certify after {attempts}")
    return out, rounds, stats, attempts, launches


def alternate_rings(ring, samples: int, sync, kinds=(True, False)) -> dict:
    """Wall ms of ``samples`` rings of each kind, ``ring(kind)`` for each
    of ``kinds`` in turn (fused True and False by default; each kind warmed
    up by the caller); every ring must certify. Returns the runs by kind."""
    runs = {kind: [] for kind in kinds}
    for _ in range(samples):
        for kind in kinds:
            t0 = time.perf_counter()
            res = ring(kind)
            sync()
            runs[kind].append((time.perf_counter() - t0) * 1e3)
            check(int(res[3]) == 0, "a timed ring did not certify")
            del res
    return runs


def k3_at_ring_shape(args: dict, pargs: dict, device, repeats: int, per_sample: int) -> dict:
    """K3 on one round's slot instance ``args`` (and, grouped with the
    parked instance ``pargs``, the round's one launch), held bit-exact
    against its plain version first; then per launch (CUDA events around a
    replayed graph of launches: the device's work alone), alone (the
    profiler's device time), per call through the Python wrapper (events
    around back-to-back calls: the host's checks and allocation are in
    it), the plain version's time, the bytes and bound over distinct data,
    and the device operations of 10 wrapped calls (one kernel node each,
    no memset)."""
    import torch

    from crdt_tpu_torch.ops.wire_kernels import wire_pack, wire_pack_many, wire_pack_plain

    on_card = device.type == "cuda"
    k3_out = wire_pack(**args)
    k3_err = wire_diff(k3_out, wire_pack_plain(**args))
    check(k3_err == 0, "K3 at the ring's shape disagrees with its plain version")
    group = [args, pargs]
    group_out = wire_pack_many(group)
    group_err = max(wire_diff(x, wire_pack_plain(**g)) for x, g in zip(group_out, group))
    check(group_err == 0, "K3's grouped round disagrees with its plain version")
    times = [graph_ms(lambda: wire_pack(**args), device, per_sample) for _ in range(repeats)]
    k3_ms = statistics.median(times)
    dev_ms = kernel_device_ms(lambda: wire_pack(**args), device, "wire_kernel", per_sample)
    call_ms = statistics.median(time_each(lambda: wire_pack(**args), device, per_sample)
                                for _ in range(repeats))
    group_times = [graph_ms(lambda: wire_pack_many(group), device, per_sample)
                   for _ in range(repeats)]
    group_ms = statistics.median(group_times)
    plain_ms = statistics.median(time_ms(lambda: wire_pack_plain(**args), device)
                                 for _ in range(3))
    nbytes = k3_bytes(args, k3_out)
    group_bytes = sum(k3_bytes(g, x) for g, x in zip(group, group_out))
    lanes = args["clocks"].numel() + (args["know"].numel() if "know" in args else 0)
    bound = {"bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
             "ops_ms": 12 * lanes / PEAK_SCALAR_OPS_PER_S * 1e3}
    bound_ms = max(bound.values())
    group_bound_ms = group_bytes / PEAK_BYTES_PER_S * 1e3
    nodes = graph_nodes(lambda: wire_pack(**args), device, 10) if on_card else None
    check(not on_card or nodes == {"kernel": 10},
          f"10 wrapped K3 calls captured as {nodes}, not 10 kernel nodes")
    del k3_out, group_out
    if on_card:
        torch.cuda.synchronize(device)
    return {
        "k3_lc": args["clocks"].shape[-1],
        "k3_ms_median": k3_ms, "k3_ms_runs": times, "k3_launches_per_sample": per_sample,
        "k3_ms_device_profiler": dev_ms, "k3_ms_per_call_incl_wrapper": call_ms,
        "k3_bytes": nbytes, "k3_bound_ms": bound_ms,
        "k3_bound_by": "bytes" if bound["bytes_ms"] >= bound["ops_ms"] else "operations",
        "k3_bound_share": bound_ms / k3_ms,
        "k3_bound_share_device_profiler": bound_ms / dev_ms if dev_ms else None,
        "k3_plain_ms": plain_ms, "k3_max_abs_err": max(k3_err, group_err),
        "k3_group_ms_median": group_ms, "k3_group_ms_runs": group_times,
        "k3_group_bytes": group_bytes, "k3_group_bound_ms": group_bound_ms,
        "k3_group_bound_share": group_bound_ms / group_ms,
        "k3_graph_nodes_per_10_calls": nodes,
    }


def phase_full_width_delta(device, seed: int, r: int = 5120, e: int = 102400, a: int = 8,
                           d: int = 4, p: int = 8, cap: int = 4096, chunk: int = 128,
                           repeats: int = 7, per_sample: int = 50,
                           ring_samples: int = 5, sweep_points=K3_SWEEP) -> dict:
    import torch

    from crdt_tpu_torch.ops.fold_kernels import fold_auto, fold_entries
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip, mesh_fold
    from crdt_tpu_torch.parallel import wire as wire_mod
    from crdt_tpu_torch.parallel.anti_entropy import local_folds, rank_blocks
    from crdt_tpu_torch.parallel.collectives import ppermute
    from crdt_tpu_torch.parallel.delta import extract_delta
    from crdt_tpu_torch.parallel.delta_ring import _packet_template
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch._dtypes import bits, umax

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    synced = []
    state, dirty, fctx, info = fill_delta_config3(r, e, a, d, p, seed, device, chunk,
                                                  synced_out=synced)
    sync()
    setup_s = time.perf_counter() - t0
    mesh = VirtualMesh(p, device)
    rl = r // p
    backlog = int(dirty.view(p, rl, e).any(1).sum(-1).max())
    base_rounds = 2 * (p - 1) * (1 + -(-backlog // cap)) - 1

    # The main path, counted: the fused ring must launch K3 once per round
    # (and K1 for the local folds).
    fused, rounds, stats, attempts, (k3_launches, k1_launches) = certify_ring(
        lambda rounds, stats: mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds,
                                                cap=cap, stats=stats),
        backlog, p, cap, (wire_pack, fold_entries), sync)
    check(not bool(fused[2]), "the fused ring overflowed")
    check(not on_card or (k3_launches == rounds and k1_launches > 0),
          f"the fused ring launched K3 {k3_launches} times in {rounds} rounds and K1 "
          f"{k1_launches} times")

    # The gate: layered ring (no K3) and mesh_fold (K1) on the same inputs.
    layered_stats = {}
    layered = mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds, cap=cap, fused=False,
                                stats=layered_stats)
    check(same_leaves(fused[0], layered[0]) and torch.equal(fused[1], layered[1]),
          "fused ring differs from the layered ring")
    check(int(layered[3]) == 0 and bool(layered[2]) == bool(fused[2]),
          "layered ring residue/overflow differ")
    t0 = time.perf_counter()
    folded, of_f = mesh_fold(state, mesh)
    sync()
    mesh_fold_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(of_f), "mesh_fold overflowed")
    check(rows_equal_fold(fused[0], folded), "certified ring rows != mesh_fold")

    # Ring wall time: the counted ring and the gate's layered ring were
    # each kind's untimed warm-up; now `ring_samples` of each, alternating.
    ring_runs = alternate_rings(lambda kind: mesh_delta_gossip(
        state, dirty, fctx, mesh, rounds=rounds, cap=cap, fused=kind), ring_samples, sync)
    ring_ms, layered_ms = (statistics.median(ring_runs[k]) for k in (True, False))

    # K3 alone, on round 0's packet at the ring's shapes (8 links × cap
    # slots), CUDA events; and its plain version on the same inputs.
    blocks = rank_blocks(state, mesh)
    lf_ms = time_ms(lambda: local_folds(blocks, fold_auto), device)
    ranks, _ = local_folds(blocks, fold_auto)
    d0 = dirty.view(p, rl, e).any(1)
    f0 = torch.stack([bits(umax(fctx.view(p, rl, e, a)[q], 0)) for q in range(p)]).view(fctx.dtype)
    pkt, _, _ = extract_delta(ranks, d0, f0, cap, start=0)
    rtop = ppermute(ranks.top, [(i, (i - 1) % p) for i in range(p)])
    codec = wire_mod.WireCodec(_packet_template(ranks, cap, fctx.dtype), e,
                               wire_mod.know_dense, gated=True, acked=False)
    k3 = k3_at_ring_shape(codec.slot_inputs(pkt, rtop=rtop), codec.parked_inputs(pkt, rtop=rtop),
                          device, repeats, per_sample)
    sweep = k3_sweep(device, seed, sweep_points, repeats=3, per_sample=20)
    busy = profile_busy(lambda: mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds,
                                                  cap=cap), device, host_top=12)
    busy_layered = profile_busy(lambda: mesh_delta_gossip(state, dirty, fctx, mesh,
                                                          rounds=rounds, cap=cap, fused=False),
                                device, host_top=12)
    acked = acked_dense_ring(state, dirty, fctx, mesh, rounds, cap, fused, folded,
                             (ranks, pkt, rtop), device, sync, repeats, per_sample, ring_samples)
    # The ring with wal= (ROADMAP 9): the log's object is the [P, ...] rank
    # state, every rank at the synced state before the burst.
    durable = with_scratch_dir(lambda root: durable_ring(
        "orswot", lambda wal: mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds, cap=cap,
                                                wal=wal),
        tree_map(lambda x: x.expand(p, *x.shape).clone(), synced[0]), fused,
        (wire_pack, fold_entries), rounds, sync, ring_samples, root))
    check(not on_card or durable["launches_in_logged_ring"] == [rounds, p],
          f"the ring with wal= launched K3 and K1 {durable['launches_in_logged_ring']} times")
    # The rings with the telemetry sidecar (ROADMAP 15.1), on the same inputs.
    telemetry = telemetry_ring_leg(
        lambda on, ack, st: mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds, cap=cap,
                                              ack_window=ack, telemetry=on, stats=st),
        fused, stats, rounds, p, rl, a, (wire_pack, fold_entries), p, busy, sync, ring_samples,
        device, acked, acked["slot_bytes"])
    links = stats["rounds"] * stats["links"]
    out = {
        "phase": "full_width_delta",
        "R": r, "E": e, "A": a, "D": d, "P": p, "cap": cap,
        "reduced": {"R": [10240, r, "fctx [R, E, A] is as large as ctr; at R=10240 the inputs "
                                   "alone are 72.3 GB"]},
        "setup_s": setup_s, **info,
        "backlog_max_per_rank": backlog, "rounds_formula": base_rounds, "attempts": attempts,
        "rounds": rounds, "residue": int(fused[3]),
        "ring_ms_fused": ring_ms, "ring_ms_layered": layered_ms,
        "ring_ms_fused_runs": ring_runs[True], "ring_ms_layered_runs": ring_runs[False],
        "mesh_fold_ms": mesh_fold_ms,
        "local_fold_ms_k1_and_epilogue_all_ranks": lf_ms,
        "k3_launches_in_ring": k3_launches, "k1_launches_in_ring": k1_launches,
        **k3, "k3_sweep": sweep,
        "slots_shipped_per_link_round": stats["slots_shipped"] / links,
        "slots_deferred": stats["slots_deferred"], "parked_lost": stats["parked_lost"],
        "wire_bytes_per_link_round": stats["wire_bytes"],
        "layered_packet_bytes_per_link_round": stats["packet_bytes"],
        "layered_slots_shipped_per_link_round": layered_stats["slots_shipped"] / links,
        "ring_profile": busy, "layered_ring_profile": busy_layered,
        "converged_members": int(bits(folded.ctr).ne(0).any(-1).sum()),
        "converged_parked": int(folded.dvalid.sum()),
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
        "ack_window": acked, "durable": durable, "telemetry": telemetry,
    }
    emit(out)
    return out


def acked_k3(template, n_rows, know_fn, pkt, rtop, device, repeats, per_sample) -> dict:
    """K3's acked instance at a ring's shape (``k3_at_ring_shape``): round
    0's packet against a window that confirmed every other slot of that
    same packet, so half the slots are covered."""
    import torch

    from crdt_tpu_torch.delta_opt import ackwin
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import wire as wire_mod

    p, c = pkt.idx.shape
    win = ackwin.init_window(template, n_rows, batch=(p,), device=device)
    ackwin.update_window(win, pkt, pkt.valid & (torch.arange(c, device=device) % 2 == 0))
    codec = wire_mod.WireCodec(template, n_rows, know_fn, gated=True, acked=True)
    args = codec.slot_inputs(pkt, rtop=rtop, win=win)
    covered = int(wire_pack(**args).covered.sum())
    out = k3_at_ring_shape(args, codec.parked_inputs(pkt, rtop=rtop), device, repeats, per_sample)
    check(covered > 0, "the acked K3 probe covered no slot")
    return {**out, "k3_covered_slots_in_probe": covered}


def acked_rings(ring, rounds: int, unacked, folded, sync, samples: int, on_card: bool) -> dict:
    """The main path with ``ack_window=True``, counted: ``ring(fused, ack,
    stats)`` runs a ring at ``rounds``. The acked fused ring must launch K3
    once per round, every launch with its acked instance; then the gates
    (acked fused == acked layered on every leaf, == the unacked fused
    ring's states, == the fold, residue 0) and ``samples`` warm walls of
    acked and unacked kind, all four alternating."""
    from crdt_tpu_torch.ops.wire_kernels import wire_pack

    stats, layered_stats, plain_stats = {}, {}, {}
    wire_pack.launches = wire_pack.acked_launches = 0
    out = ring(True, True, stats)
    sync()
    launches = (wire_pack.launches, wire_pack.acked_launches)
    check(int(out[3]) == 0 and not bool(out[2].any()), "the acked fused ring did not certify")
    check(not on_card or launches == (rounds, rounds),
          f"the acked ring launched K3 {launches} times (all, acked) in {rounds} rounds")
    layered = ring(False, True, layered_stats)
    check(same_leaves(out[0], layered[0]) and same_leaves(out[1], layered[1])
          and int(layered[3]) == 0, "the acked fused ring differs from the acked layered ring")
    check(same_leaves(out[0], unacked[0]), "the acked ring differs from the unacked ring")
    check(rows_equal_fold(out[0], folded), "the certified acked ring's rows != the fold")
    del out, layered
    ring(True, False, plain_stats)  # the unacked fused ring's counts
    # Acked and unacked rings of both wires in turn: host time drifts
    # between calls and within one, so only alternating walls compare.
    kinds = [(fused, ack) for ack in (True, False) for fused in (True, False)]
    runs = alternate_rings(lambda kind: ring(*kind, None), samples, sync, kinds)
    med = {kind: statistics.median(runs[kind]) for kind in kinds}
    links = stats["rounds"] * stats["links"]
    return {
        "rounds": rounds, "residue": 0, "k3_launches": launches[0],
        "k3_acked_launches": launches[1],
        "slots_shipped": stats["slots_shipped"], "slots_acked_skipped": stats["slots_acked_skipped"],
        "slots_shipped_unacked": plain_stats["slots_shipped"],
        "layered_slots_shipped": layered_stats["slots_shipped"],
        "layered_slots_acked_skipped": layered_stats["slots_acked_skipped"],
        "slots_shipped_per_link_round": stats["slots_shipped"] / links,
        "ack_bytes_per_link_round": stats["ack_bytes"],
        "ring_ms_fused": med[True, True], "ring_ms_layered": med[False, True],
        "ring_ms_fused_unacked": med[True, False], "ring_ms_layered_unacked": med[False, False],
        "acked_over_unacked_fused": med[True, True] / med[True, False],
        "acked_over_unacked_layered": med[False, True] / med[False, False],
        "ring_ms_runs": {f"{'fused' if f else 'layered'}_{'acked' if a else 'unacked'}":
                         runs[f, a] for f, a in kinds},
    }


def acked_dense_ring(state, dirty, fctx, mesh, rounds, cap, unacked, folded, probe,
                     device, sync, repeats, per_sample, samples) -> dict:
    """``full_width_delta`` with ``ack_window=True`` (ROADMAP 7b): the
    acked rings' gates, counts and walls, K3's acked instance at the ring's
    shape, the acked fused ring's busy share and the section's peak
    memory."""
    import torch

    from crdt_tpu_torch.delta_opt import ackwin
    from crdt_tpu_torch.parallel import mesh_delta_gossip
    from crdt_tpu_torch.parallel import wire as wire_mod
    from crdt_tpu_torch.parallel.delta_ring import _packet_template

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    ring = lambda kind, ack, st: mesh_delta_gossip(  # noqa: E731
        state, dirty, fctx, mesh, rounds=rounds, cap=cap, fused=kind, ack_window=ack, stats=st)
    out = acked_rings(ring, rounds, unacked, folded, sync, samples, on_card)
    ranks, pkt, rtop = probe
    template = _packet_template(ranks, cap, fctx.dtype)
    out.update(acked_k3(template, dirty.shape[-1], wire_mod.know_dense, pkt, rtop, device,
                        repeats, per_sample))
    out["slot_bytes"] = ackwin.slot_bytes(template)
    out["ring_profile"] = profile_busy(lambda: ring(True, True, None), device)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None
    return out


# ---- phase 11 ------------------------------------------------------------

def mint_map_tracked(rng, n, n_cmds=14, keys=MAP_KEYS):
    """``n`` Map<K, MVReg> oracle sites, one actor each, minting puts (70%)
    and keyset-removes with random per-origin PREFIX delivery, and each
    site's applied-op log: the δ-map tests' workload
    (tests/test_delta_map.py ``_site_run``)."""
    from crdt_tpu_torch.pure import Map, MVReg

    sites = [Map(MVReg) for _ in range(n)]
    applied = [[] for _ in range(n)]
    got = [[0] * n for _ in range(n)]
    seq = [0] * n
    for _ in range(n_cmds):
        i = rng.randrange(n)
        s, key = sites[i], rng.choice(keys)
        if rng.random() < 0.7:
            val = rng.randrange(40)
            op = s.update(key, s.len().derive_add_ctx(f"s{i}"), lambda reg, c: reg.write(val, c))
        else:
            op = s.rm(key, s.get(key).derive_rm_ctx())
        s.apply(op)
        applied[i].append(op)
        for j in range(n):
            if j != i and got[j][i] == seq[i] and rng.random() < 0.5:
                sites[j].apply(op)
                applied[j].append(op)
                got[j][i] += 1
        seq[i] += 1
    return sites, applied


def map_op_tracking(model, applied, device):
    """``(dirty, fctx)`` of a ``BatchedMap`` from per-replica op logs: a put
    contributes its witness dot at its key, a keyset-remove its clock at
    every key it names."""
    import numpy as np

    from crdt_tpu_torch.convert import tracking_from_numpy
    from crdt_tpu_torch.pure.map import Up

    r = model.n_replicas
    k, a = model.state.dkeys.shape[-1], model.state.top.shape[-1]
    dirty = np.zeros((r, k), bool)
    fctx = np.zeros((r, k, a), np.uint32)
    for i, ops_i in enumerate(applied):
        for op in ops_i:
            if isinstance(op, Up):
                touched, dots = [op.key], {op.dot.actor: op.dot.counter}
            else:
                touched, dots = op.keyset, op.clock.dots
            for key in touched:
                kid = model.keys.id_of(key)
                dirty[i, kid] = True
                for actor, c in dots.items():
                    aid = model.actors.id_of(actor)
                    fctx[i, kid, aid] = max(fctx[i, kid, aid], c)
    return tracking_from_numpy(dirty, fctx, device=device)


def phase_map_delta_scenarios(device, seed: int, n_seeds: int = 3) -> dict:
    import torch

    from crdt_tpu_torch.models import BatchedMap
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip_map, mesh_fold_map
    from crdt_tpu_torch.utils import Interner

    mesh = VirtualMesh(4, device)
    counts = {"rings": 0, "certified": 0, "matched_fold": 0, "k3_launches": 0}
    launches0 = wire_pack.launches
    for k in range(n_seeds):
        sites, applied = mint_map_tracked(random.Random(seed + 110 + k), 6, n_cmds=18)
        model = BatchedMap.from_pure(sites, keys=Interner(MAP_KEYS),
                                     actors=Interner(f"s{i}" for i in range(6)),
                                     values=Interner(range(40)), device=device)
        dirty, fctx = map_op_tracking(model, applied, device)
        folded, of_f = mesh_fold_map(model.state, mesh)
        check(not bool(of_f.any()), "mesh_fold_map overflowed")
        for cap in (16, 1):
            for pipeline in (True, False):
                outs = {}
                for fused in (True, False):
                    outs[fused] = mesh_delta_gossip_map(
                        model.state, dirty, fctx, mesh, rounds=40 if cap == 1 else 8, cap=cap,
                        pipeline=pipeline, fused=fused)
                    counts["rings"] += 1
                (fr, fd, fo, fres), (lr, ld, lo, lres) = outs[True], outs[False]
                what = f"seed {k} cap {cap} pipeline {pipeline}"
                check(same_leaves(fr, lr) and torch.equal(fd, ld) and torch.equal(fo, lo),
                      f"fused map ring differs from the layered ring ({what})")
                check(int(fres) == int(lres), f"fused and layered residue differ ({what})")
                if int(fres) == 0:
                    counts["certified"] += 1
                    check(rows_equal_fold(fr, folded), f"certified map ring != mesh_fold_map "
                                                       f"({what})")
                    counts["matched_fold"] += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts["k3_launches"] = wire_pack.launches - launches0
    check(device.type != "cuda" or counts["k3_launches"] > 0, "no fused map ring launched K3")
    check(counts["certified"] > 0, "no map scenario ring certified")
    emit({"phase": "map_delta_scenarios", **counts})
    return counts


# ---- phase 12 ------------------------------------------------------------

def fill_delta_config4(r, k, s, a, d, p, seed, device, chunk=8, n_ops=1024, n_cross=2,
                       n_des=2, written=None, max_parked=None, synced_out=None):
    """Replica states, dirty and fctx for the Map δ ring, on the device,
    ``chunk`` replicas at a time. All replicas start from ONE synced state:
    ``written`` keys (default K/20) of a random order hold content by
    ``fill_config4``'s rule (slot 0 always written, later slots with
    probability 1/2, the write clock holding its own lane only), with the
    counters dense per actor: the write at (written key i, slot j) is
    actor (i·S + j) % A's, counter (i·S + j) // A + 1; every write is
    held, and the top is the largest counter on every lane (K·S/80 =
    25,000 at config 4). Dense counters keep the tops inside the wire's
    ±32 Ki window (a zero lane — a dead sibling slot, a removed key —
    encodes against a top of at most 32,768 only), which bench.py's
    counters (key·S + j + 1, tops 2,000,000) leave. After the sync each
    actor mints a stream of L = ``n_ops`` ops (at most its share)
    over distinct keys of its own 1% of the keys (all written), in a
    random order: 2/3
    puts of a fresh dot, whose write clock is the synced top with the
    actor's lane at the new counter, so the put replaces the key's synced
    siblings; and 1/3 keyset-removes, each under the clock of its key's
    synced content. A replica holds a prefix of every stream — rank q's
    replicas a prefix of at most H[q, a] ops, the whole stream at actor a's
    home rank (a % P), and each rank's replica 0 exactly H. ``n_cross``
    streams end in a put (actor b) and ``n_cross`` in a keyset-remove of
    that key under the put's clock (actor b + A/2): ``n_des`` replicas per
    rank hold the remove but not the put, so they park it ahead of their
    top. Every touched key carries removal knowledge (the siblings a put
    superseded, or the removed content), so it rides the ring to the end:
    the A·L - n_cross touched keys must fit the cap for the ring to
    certify (A·L = 4,096 = cap at config 4). ``(dirty, fctx)``
    accumulate with ``interval_accumulate_map`` from the synced state over
    two steps (the puts, then the removes), so no dot is born and removed
    inside one interval. ``max_parked`` and ``synced_out`` as in
    :func:`fill_delta_config3`. Returns ``(state, dirty, fctx, info)``."""
    import torch

    from crdt_tpu_torch._dtypes import bits, from_wide
    from crdt_tpu_torch.ops import map as map_ops
    from crdt_tpu_torch.ops.mvreg import MVRegState
    from crdt_tpu_torch.parallel import interval_accumulate_map

    gen = torch.Generator(device=device).manual_seed(seed + 12)
    u32, i64 = torch.uint32, torch.int64
    rl = r // p
    share = max(1, k // 100)
    n_ops = min(n_ops, share)
    written = k // 20 if written is None else written
    fits = d > n_cross if max_parked is None else d >= max_parked
    check(rl * p == r and a >= 2 * n_cross and fits and rl > n_des
          and a * share <= written <= k and n_ops >= 4, "bad δ map shape")

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    # The synced state: the first `written` keys of a random order, by
    # fill_config4's rule with dense per-actor counters, every write held.
    perm = torch.randperm(k, generator=gen, device=device)
    slot = torch.arange(s, device=device)
    q = torch.arange(written, device=device)[:, None] * s + slot
    act0, ctr0 = q % a, q // a + 1
    live0 = (slot == 0) | (rand((written, s)) < 0.5)
    order = torch.argsort((~live0).long() * a + act0, dim=-1, stable=True)
    live0, act0, ctr0 = (torch.gather(x, 1, order) for x in (live0, act0, ctr0))
    clk0 = torch.zeros((written, s, a), dtype=i64, device=device)
    clk0.scatter_(-1, act0[..., None], ctr0[..., None])
    rows0 = (torch.where(live0, act0, 0).to(torch.int32), torch.where(live0, ctr0, 0),
             torch.where(live0[..., None], clk0, 0),
             torch.where(live0, (ctr0 - 1) % 5, 0).to(torch.int32), live0)
    synced = MVRegState(*(x.new_zeros((k, *x.shape[1:])).index_copy_(0, perm[:written], x)
                          for x in rows0))
    top0 = torch.full((a,), (written * s - 1) // a + 1, dtype=i64, device=device)

    # Post-sync streams: L ops per actor over distinct keys of its share.
    # Positions 0 .. L-2 hold its regular ops in a random order; position
    # L-1 a put, except at actors b + A/2 (b < n_cross), where it is the
    # cross remove of the key that actor b's last put wrote.
    own = perm[: a * share].reshape(a, share)
    op_key = torch.stack([own[i, torch.randperm(share, generator=gen, device=device)[:n_ops]]
                          for i in range(a)])
    n_reg = n_ops - 1
    pos = torch.stack([torch.randperm(n_reg, generator=gen, device=device) for _ in range(a)])
    n_put = (2 * n_reg) // 3
    cross_b = torch.arange(n_cross, device=device)
    cross_a = cross_b + a // 2
    last_put = torch.ones((a,), dtype=torch.bool, device=device)
    last_put[cross_a] = False
    is_put = torch.zeros((a, n_ops), dtype=torch.bool, device=device)
    is_put.scatter_(1, pos[:, :n_put], True)
    is_put[:, n_ops - 1] = last_put
    cum = torch.cat([torch.zeros((a, 1), dtype=i64, device=device),
                     torch.cumsum(is_put.long(), 1)], 1)  # puts before each position
    acts = torch.arange(a, device=device)[:, None]
    last_a = torch.arange(a, device=device)[last_put]  # cross_b first
    put_m = torch.cat([op_key[:, :n_put].reshape(-1), op_key[last_a, n_ops - 1]])
    put_a = torch.cat([acts.expand(a, n_put).reshape(-1), last_a])
    put_j = torch.cat([pos[:, :n_put].reshape(-1), torch.full_like(last_a, n_ops - 1)])
    put_c = top0[put_a] + 1 + cum[put_a, put_j]
    put_clock = top0.expand(put_m.numel(), a).clone()
    put_clock.scatter_(1, put_a[:, None], put_c[:, None])
    n_puts = put_m.numel()
    new = MVRegState(  # the key's row after a put: one live slot
        wact=torch.nn.functional.pad(put_a[:, None], (0, s - 1)).to(torch.int32),
        wctr=torch.nn.functional.pad(put_c[:, None], (0, s - 1)),
        clk=torch.cat([put_clock[:, None], put_clock.new_zeros((n_puts, s - 1, a))], 1),
        val=torch.nn.functional.pad((put_c % 5)[:, None], (0, s - 1)).to(torch.int32),
        valid=torch.nn.functional.pad(torch.ones((n_puts, 1), dtype=torch.bool, device=device),
                                      (0, s - 1)),
    )
    cross_m = op_key[cross_b, n_ops - 1]
    rm_m = torch.cat([op_key[:, n_put:n_reg].reshape(-1), cross_m])
    rm_a = torch.cat([acts.expand(a, n_reg - n_put).reshape(-1), cross_a])
    rm_j = torch.cat([pos[:, n_put:].reshape(-1), torch.full_like(cross_a, n_ops - 1)])
    rm_rc = synced.clk[rm_m].amax(1)
    rm_rc[-n_cross:] = put_clock[a * n_put + cross_b]

    # Prefixes: rank horizons, full at the home rank, replica 0 at the
    # horizon, designated replicas holding the cross removes only.
    ranks = torch.arange(p, device=device)[:, None]
    horizon = (n_ops * (0.4 + 0.5 * rand((p, a)))).long()
    horizon = torch.where(acts.T % p == ranks, n_ops, horizon)
    hz = horizon.repeat_interleave(rl, 0)
    prefix = torch.minimum((rand((r, a)) * (hz + 1)).long(), hz)
    first = torch.arange(r, device=device) % rl
    prefix = torch.where((first == 0)[:, None], hz, prefix)
    des = (first >= 1) & (first <= n_des)
    prefix[des[:, None] & (acts.T >= a // 2) & (acts.T < a // 2 + n_cross)] = n_ops
    prefix = torch.where(des[:, None] & (acts.T < n_cross), torch.clamp_max(prefix, n_ops - 1),
                         prefix)
    if max_parked is not None:
        rm_cols = prefix[:, a // 2: a // 2 + n_cross]
        over = torch.cumsum((rm_cols >= n_ops).long(), 1) > max_parked
        prefix[:, a // 2: a // 2 + n_cross] = torch.where(
            over, torch.clamp_max(rm_cols, n_ops - 1), rm_cols)

    state = map_ops.empty(k, a, s, d, batch=(r,), device=device)
    dirty = torch.zeros((r, k), dtype=torch.bool, device=device)
    fctx = torch.zeros((r, k, a), dtype=torch.int32, device=device).view(u32)
    narrow = lambda c: MVRegState(c.wact, from_wide(c.wctr, u32), from_wide(c.clk, u32),  # noqa: E731
                                  c.val, c.valid)
    at = lambda c: state._replace(child=narrow(c))  # noqa: E731
    for lo in range(0, r, chunk):
        hi = min(r, lo + chunk)
        pc = prefix[lo:hi]
        top = top0 + torch.gather(cum, 1, pc.T).T
        child = MVRegState(*(x.expand(hi - lo, *x.shape).clone() for x in synced))
        held = pc[:, put_a] > put_j  # [c, puts]
        for x, n in zip(child, new):
            x[:, put_m] = torch.where(held.reshape(*held.shape, *([1] * (x.dim() - 2))), n,
                                      x[:, put_m])
        mid = MVRegState(*(x.clone() for x in child))
        held = pc[:, rm_a] > rm_j  # [c, removes]
        rows = MVRegState(*(x[:, rm_m] for x in child))
        rc = rm_rc.expand(hi - lo, *rm_rc.shape)
        covered = rows.wctr <= torch.gather(rc, 2, rows.wact.long())
        rows = map_ops._canon_child(rows._replace(valid=rows.valid & ~(held[..., None] & covered)))
        for x, y in zip(child, rows):
            x[:, rm_m] = y
        ahead = held[:, -n_cross:] & ~torch.all(rm_rc[-n_cross:] <= top[:, None, :], -1)
        slot_of = torch.cumsum(ahead.long(), 1) - 1
        dcl = torch.zeros((hi - lo, d, a), dtype=i64, device=device)
        dkeys = torch.zeros((hi - lo, d, k), dtype=torch.bool, device=device)
        ii, kk = torch.nonzero(ahead, as_tuple=True)
        dcl[ii, slot_of[ii, kk]] = rm_rc[-n_cross:][kk]
        dkeys[ii, slot_of[ii, kk], cross_m[kk]] = True
        base = MVRegState(*(x.expand(hi - lo, *x.shape) for x in synced))
        dd, ff = interval_accumulate_map(dirty[lo:hi], fctx[lo:hi], at(base), at(mid))
        dd, ff = interval_accumulate_map(dd, ff, at(mid), at(child))
        dirty[lo:hi], bits(fctx)[lo:hi] = dd, bits(ff)
        for x, y in zip(state.child, narrow(child)):
            bits(x)[lo:hi] = bits(y)
        bits(state.top)[lo:hi] = bits(from_wide(top, u32))
        bits(state.dcl)[lo:hi] = bits(from_wide(dcl, u32))
        state.dkeys[lo:hi] = dkeys
        state.dvalid[lo:hi] = torch.arange(d, device=device) < ahead.sum(1, keepdim=True)
    info = {"written_keys": written, "synced_top": int(top0[0]),
            "ops_per_actor": n_ops, "puts_per_actor": n_put, "cross_removes": n_cross,
            "replicas_parking": int(state.dvalid.any(-1).sum()),
            "dirty_keys_per_replica_mean": float(dirty.sum(-1).float().mean())}
    if synced_out is not None:
        synced_out.append(map_ops.empty(k, a, s, d, device=device)._replace(
            top=from_wide(top0, u32), child=narrow(synced)))
    return state, dirty, fctx, info


def phase_full_width_delta_map(device, seed: int, r: int = 64, k: int = 1_000_000, s: int = 2,
                               a: int = 4, d: int = 4, p: int = 8, cap: int = 4096,
                               chunk: int = 8, repeats: int = 7, per_sample: int = 50,
                               ring_samples: int = 5, durable_samples: int = 2) -> dict:
    import torch

    from crdt_tpu_torch._dtypes import bits, umax
    from crdt_tpu_torch.ops import map as map_ops
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.ops.fold_kernels import fold_cells
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip_map, mesh_fold_map
    from crdt_tpu_torch.parallel import wire as wire_mod
    from crdt_tpu_torch.parallel.anti_entropy import local_folds, rank_blocks
    from crdt_tpu_torch.parallel.collectives import ppermute
    from crdt_tpu_torch.parallel.delta_map import (
        apply_delta_map, extract_delta_map, packet_template_map,
    )
    from crdt_tpu_torch.parallel.delta_ring import RingTelemetry
    from crdt_tpu_torch.telemetry import shipped_bytes

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    synced = []
    state, dirty, fctx, info = fill_delta_config4(r, k, s, a, d, p, seed, device, chunk,
                                                  synced_out=synced)
    sync()
    setup_s = time.perf_counter() - t0
    state_gb = sum(x.numel() * x.element_size() for x in (*state.child, state.top, state.dcl,
                                                           state.dkeys, state.dvalid)) / 1e9
    mesh = VirtualMesh(p, device)
    rl = r // p
    backlog = int(dirty.view(p, rl, k).any(1).sum(-1).max())
    base_rounds = 2 * (p - 1) * (1 + -(-backlog // cap)) - 1

    # The main path, counted: the fused Map ring must launch K2 once per
    # rank (its local fold) and K3 once per round.
    fused, rounds, stats, attempts, (k3_launches, k2_launches) = certify_ring(
        lambda rounds, stats: mesh_delta_gossip_map(state, dirty, fctx, mesh, rounds=rounds,
                                                    cap=cap, stats=stats),
        backlog, p, cap, (wire_pack, fold_cells), sync)
    check(not bool(fused[2].any()), "the fused map ring overflowed")
    check(not on_card or (k3_launches == rounds and k2_launches == p),
          f"the fused map ring launched K3 {k3_launches} times in {rounds} rounds and K2 "
          f"{k2_launches} times on {p} ranks")

    # The gate: the layered ring (no K3) and mesh_fold_map on the same inputs.
    layered_stats = {}
    layered = mesh_delta_gossip_map(state, dirty, fctx, mesh, rounds=rounds, cap=cap,
                                    fused=False, stats=layered_stats)
    check(same_leaves(fused[0], layered[0]) and torch.equal(fused[1], layered[1]),
          "fused map ring differs from the layered ring")
    check(int(layered[3]) == 0 and torch.equal(layered[2], fused[2]),
          "layered map ring residue/overflow differ")
    t0 = time.perf_counter()
    folded, of_f = mesh_fold_map(state, mesh)
    sync()
    mesh_fold_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(of_f.any()), "mesh_fold_map overflowed")
    check(rows_equal_fold(fused[0], folded), "certified map ring rows != mesh_fold_map")
    converged = {"converged_keys": int(folded.child.valid.any(-1).sum()),
                 "converged_parked": int(folded.dvalid.sum())}
    del layered

    # Ring wall time: the counted ring and the gate's layered ring were each
    # kind's untimed warm-up; now `ring_samples` of each, alternating.
    ring_runs = alternate_rings(lambda kind: mesh_delta_gossip_map(
        state, dirty, fctx, mesh, rounds=rounds, cap=cap, fused=kind), ring_samples, sync)
    ring_ms, layered_ms = (statistics.median(ring_runs[x]) for x in (True, False))

    # K3 at the Map layout, on round 0's packet (P links × cap slots × LC
    # = S + S·A + A lanes against a per-slot base), CUDA events over a
    # replayed graph; and its plain version on the same inputs.
    blocks = rank_blocks(state, mesh)
    lf_ms = time_ms(lambda: local_folds(blocks, map_ops.fold), device)
    ranks, _ = local_folds(blocks, map_ops.fold)
    d0 = dirty.view(p, rl, k).any(1)
    f0 = torch.stack([bits(umax(fctx.view(p, rl, k, a)[q], 0)) for q in range(p)]).view(
        fctx.dtype)
    pkt, _, _ = extract_delta_map(ranks, d0, f0, cap, start=0)
    rtop = ppermute(ranks.top, [(i, (i - 1) % p) for i in range(p)])
    codec = wire_mod.WireCodec(packet_template_map(ranks, cap, fctx.dtype), k,
                               wire_mod.know_map, gated=True, acked=False)
    args = codec.slot_inputs(pkt, rtop=rtop)
    pargs = codec.parked_inputs(pkt, rtop=rtop)
    check(args["clocks"].shape[-1] == s + s * a + a and args["base"].is_contiguous(),
          "the Map slot instance is not LC = S + S·A + A against a per-slot base")

    def one_round():
        """A fused round as the ring runs it: extract, K3 pack, ship,
        unpack, apply."""
        pk, dd, ff = extract_delta_map(ranks, d0, f0, cap, start=0)
        wired, aux = codec.pack(pk, rtop=rtop)
        dd = wire_mod.remark_deferred(dd, wire_mod.core_idx(pk), aux.defer)
        got = codec.unpack(ppermute(wired, [(i, (i + 1) % p) for i in range(p)]),
                           own_top=ranks.top)
        return apply_delta_map(ranks, got, dd, ff)

    rt = RingTelemetry(p, device, map_ops.changed_keys)

    def one_tel_round():
        """The same round with the telemetry sidecar's per-round work
        (``delta_ring.RingTelemetry``, as the ring calls it)."""
        rt.begin()
        pk, dd, ff = extract_delta_map(ranks, d0, f0, cap, start=0)
        wired, aux = codec.pack(pk, rtop=rtop)
        dd = wire_mod.remark_deferred(dd, wire_mod.core_idx(pk), aux.defer)
        rt.sent(dd.sum(dim=-1), shipped_bytes(wired, batch_dims=1),
                codec.useful_bytes(pk, aux.keep), packed_words=aux.packed_words)
        got = codec.unpack(ppermute(wired, [(i, (i + 1) % p) for i in range(p)]),
                           own_top=ranks.top)
        st = apply_delta_map(ranks, got, dd, ff)[0]
        rt.applied(ranks, st)
        rt.end(True)

    # No operation of a Map round waits for the device (a CUDA graph of
    # the round could capture it): torch raises on any synchronising call.
    # The same holds with the telemetry sidecar's work in the round.
    one_round()
    one_tel_round()
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        one_round()
        one_tel_round()
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    k3 = k3_at_ring_shape(args, pargs, device, repeats, per_sample)
    busy = profile_busy(lambda: mesh_delta_gossip_map(state, dirty, fctx, mesh, rounds=rounds,
                                                      cap=cap), device, host_top=12)
    busy_layered = profile_busy(lambda: mesh_delta_gossip_map(
        state, dirty, fctx, mesh, rounds=rounds, cap=cap, fused=False), device, host_top=12)
    acked = acked_map_ring(state, dirty, fctx, mesh, rounds, cap, fused, folded,
                           (ranks, d0, f0, rtop), device, sync, repeats, per_sample)
    del folded
    # The ring with wal= (ROADMAP 9), as in full_width_delta; 2 walls of
    # each kind (a Map ring takes seconds).
    durable = with_scratch_dir(lambda root: durable_ring(
        "map", lambda wal: mesh_delta_gossip_map(state, dirty, fctx, mesh, rounds=rounds,
                                                 cap=cap, wal=wal),
        tree_map(lambda x: x.expand(p, *x.shape).clone(), synced.pop()), fused,
        (wire_pack, fold_cells), rounds, sync, durable_samples, root))
    check(not on_card or durable["launches_in_logged_ring"] == [rounds, p],
          f"the map ring with wal= launched K3 and K2 {durable['launches_in_logged_ring']} times")
    # The rings with the telemetry sidecar (ROADMAP 15.1), 2 walls of each.
    telemetry = telemetry_ring_leg(
        lambda on, ack, st: mesh_delta_gossip_map(state, dirty, fctx, mesh, rounds=rounds,
                                                  cap=cap, ack_window=ack, telemetry=on,
                                                  stats=st),
        fused, stats, rounds, p, rl, a, (wire_pack, fold_cells), p, busy, sync,
        durable_samples, device, acked, acked["slot_bytes"])
    telemetry["round_syncs_with_host"] = False if on_card else None
    links = stats["rounds"] * stats["links"]
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None
    residue = int(fused[3])

    # The same traffic with every key written (bench.py's key count; tops
    # K·S/A): a row with a zero lane — a dead sibling slot, a removed key —
    # leaves the wire's ±32 Ki window of the receiver's top and defers, so
    # the fused ring starves where the layered one certifies.
    del state, dirty, fctx, fused, blocks, ranks, pkt, args, pargs
    if on_card:
        torch.cuda.empty_cache()
    st_all, d_all, f_all, info_all = fill_delta_config4(r, k, s, a, d, p, seed, device, chunk,
                                                        written=k)
    all_stats = {}
    all_fused = mesh_delta_gossip_map(st_all, d_all, f_all, mesh, rounds=rounds, cap=cap,
                                      stats=all_stats)
    all_layered = mesh_delta_gossip_map(st_all, d_all, f_all, mesh, rounds=rounds, cap=cap,
                                        fused=False)
    all_written = {"synced_top": info_all["synced_top"], "rounds": rounds,
                   "fused_residue": int(all_fused[3]), "layered_residue": int(all_layered[3]),
                   "fused_slots_deferred": all_stats["slots_deferred"]}
    del st_all, d_all, f_all, all_fused, all_layered
    out = {
        "phase": "full_width_delta_map",
        "R": r, "K": k, "S": s, "A": a, "D": d, "P": p, "cap": cap,
        "reduced": {"written_keys": [k, info["written_keys"],
                                     "the synced store's counters stay inside the wire's "
                                     "±32 Ki window (see every_key_written)"]},
        "setup_s": setup_s, "state_gb": state_gb, **info,
        "backlog_max_per_rank": backlog, "rounds_formula": base_rounds, "attempts": attempts,
        "rounds": rounds, "residue": residue,
        "ring_ms_fused": ring_ms, "ring_ms_layered": layered_ms,
        "ring_ms_fused_runs": ring_runs[True], "ring_ms_layered_runs": ring_runs[False],
        "mesh_fold_map_ms": mesh_fold_ms,
        "local_fold_ms_k2_and_epilogue_all_ranks": lf_ms,
        "k3_launches_in_ring": k3_launches, "k2_launches_in_ring": k2_launches, **k3,
        "round_syncs_with_host": False if on_card else None,
        "slots_shipped_per_link_round": stats["slots_shipped"] / links,
        "slots_deferred": stats["slots_deferred"], "parked_lost": stats["parked_lost"],
        "wire_bytes_per_link_round": stats["wire_bytes"],
        "layered_packet_bytes_per_link_round": stats["packet_bytes"],
        "layered_slots_shipped_per_link_round": layered_stats["slots_shipped"] / links,
        "ring_profile": busy, "layered_ring_profile": busy_layered,
        "launch_kernel_calls_per_round_fused":
            busy["launch_kernel_calls"] / rounds if busy else None,
        "launch_kernel_calls_per_round_layered":
            busy_layered["launch_kernel_calls"] / rounds if busy_layered else None,
        **converged, "every_key_written": all_written, "peak_mem_gb": peak_gb,
        "ack_window": acked, "durable": durable, "telemetry": telemetry,
    }
    emit(out)
    return out


def acked_map_ring(state, dirty, fctx, mesh, rounds, cap, unacked, folded, probe, device, sync,
                   repeats, per_sample, samples: int = 3) -> dict:
    """``full_width_delta_map`` with ``ack_window=True`` (ROADMAP 7b): the
    acked rings' gates, counts and walls (``samples`` of each kind: a Map
    ring takes seconds), one acked round under torch's sync debug mode
    "error", K3's acked instance at LC 14, busy share and peak memory."""
    import torch

    from crdt_tpu_torch.delta_opt import ackwin
    from crdt_tpu_torch.ops import wire_kernels as wk
    from crdt_tpu_torch.parallel import mesh_delta_gossip_map
    from crdt_tpu_torch.parallel import wire as wire_mod
    from crdt_tpu_torch.parallel.collectives import ppermute
    from crdt_tpu_torch.parallel.delta_map import (
        apply_delta_map, extract_delta_map, packet_template_map,
    )

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    ring = lambda kind, ack, st: mesh_delta_gossip_map(  # noqa: E731
        state, dirty, fctx, mesh, rounds=rounds, cap=cap, fused=kind, ack_window=ack, stats=st)
    out = acked_rings(ring, rounds, unacked, folded, sync, samples, on_card)

    ranks, d0, f0, rtop = probe
    p, k = d0.shape
    template = packet_template_map(ranks, cap, fctx.dtype)
    codec = wire_mod.WireCodec(template, k, wire_mod.know_map, gated=True, acked=True)
    win = ackwin.init_window(template, k, batch=(p,), device=device)
    mirror = [torch.zeros_like(win.ctx)]  # the receivers' copy of the window ctx
    perm = [(i, (i + 1) % p) for i in range(p)]
    inv = [(i, (i - 1) % p) for i in range(p)]

    def one_acked_round():
        """An acked fused round as the ring runs it: extract, K3 pack
        against the window, ship, unpack against the mirror, apply, then
        the mirror's promotion and the ack bitmap's trip back."""
        pk, dd, ff = extract_delta_map(ranks, d0, f0, cap, start=0)
        wired, aux = codec.pack(pk, rtop=rtop, win=win)
        dd = wire_mod.remark_deferred(dd, wire_mod.core_idx(pk), aux.defer)
        got = codec.unpack(ppermute(wired, perm), own_top=ranks.top, mirror_ctx=mirror[0])
        st, dd, ff, _ = apply_delta_map(ranks, got, dd, ff)
        acks = ackwin.ack_bits(got)
        mirror[0] = wire_mod.mirror_promote(mirror[0], got, acks)
        acks = wk.unpack_bits(ppermute(wk.pack_bits(acks), inv), acks.shape[-1])
        ackwin.update_window(win, codec.mask(pk, aux.keep), acks)
        return st

    one_acked_round()
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        one_acked_round()
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    pkt, _, _ = extract_delta_map(ranks, d0, f0, cap, start=0)
    out.update(acked_k3(template, k, wire_mod.know_map, pkt, rtop, device, repeats, per_sample))
    out["slot_bytes"] = ackwin.slot_bytes(template)
    out["round_syncs_with_host"] = False if on_card else None
    out["ring_profile"] = profile_busy(lambda: ring(True, True, None), device)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None
    return out


# ---- phase 13 ------------------------------------------------------------

def parked_sets(state):
    """Each row's parked removes of a dense state as a set of (clock,
    element set) pairs, equal-clock slots unioned (one oracle entry)."""
    from crdt_tpu_torch._dtypes import to_wide

    out = []
    dcl = to_wide(state.dcl).reshape(-1, *state.dcl.shape[-2:]).tolist()
    dmask = state.dmask.reshape(-1, *state.dmask.shape[-2:]).tolist()
    dvalid = state.dvalid.reshape(-1, state.dvalid.shape[-1]).tolist()
    for cl, masks, ok in zip(dcl, dmask, dvalid):
        row = {}
        for c, m, v in zip(cl, masks, ok):
            if v:
                row.setdefault(tuple(c), set()).update(e for e, b in enumerate(m) if b)
        out.append({(c, frozenset(m)) for c, m in row.items()})
    return out


def sparse_equals_dense(sparse, dense) -> bool:
    """A sparse batch and a dense batch hold the same replicas: entries and
    tops bit for bit through ``to_dense``, parked removes as sets."""
    from crdt_tpu_torch.ops import sparse_orswot as sp

    back = sp.to_dense(sparse, dense.ctr.shape[-2])
    return (same_leaves(back.ctr, dense.ctr) and same_leaves(back.top, dense.top)
            and parked_sets(back) == parked_sets(dense))


def phase_sparse_scenarios(device, seed: int, rounds: int = 6, cap: int = 64) -> dict:
    import torch

    from crdt_tpu_torch.models import (
        BatchedOrswot, BatchedSparseOrswot, DeferredOverflow, DotCapacityOverflow,
    )
    from crdt_tpu_torch.dot import Dot
    from crdt_tpu_torch.pure.orswot import Add, Orswot, Rm
    from crdt_tpu_torch.utils import Interner
    from crdt_tpu_torch.vclock import VClock

    t_phase = time.perf_counter()
    rng = random.Random(seed + 13)
    counts = {"ops": 0, "merges": 0, "folds": 0, "resets": 0, "parked_seen": 0}
    for _ in range(rounds):
        n = rng.randint(3, 5)
        sites, streams = mint_sites(rng, n, 24)
        actors = Interner([f"s{i}" for i in range(n)])
        members = Interner(MEMBERS)
        model = BatchedSparseOrswot.from_pure(sites, dot_cap=cap, deferred_cap=8, rm_width=8,
                                              members=members, actors=actors, device=device)
        for i, s in enumerate(sites):
            check(model.to_pure(i) == s, "sparse from_pure/to_pure round trip")

        # Cross-delivery on the sparse model and a dense twin: every
        # replica gets random prefixes of every stream, interleaved.
        replicas = [Orswot() for _ in range(n)]
        model = BatchedSparseOrswot(n, cap, n, 8, 8, members=members.clone(),
                                    actors=actors.clone(), device=device)
        twin = BatchedOrswot(n, len(MEMBERS), n, 8, members=members.clone(),
                             actors=actors.clone(), device=device)
        for j in range(n):
            cut = [q[: rng.randint(0, len(q))] for q in streams]
            for op in interleave(rng, cut):
                replicas[j].apply(op)
                model.apply(j, op)
                twin.apply(j, op)
                counts["ops"] += 1
            check(model.to_pure(j) == replicas[j], f"sparse op path, replica {j}")
            counts["parked_seen"] += len(replicas[j].deferred)
        check(sparse_equals_dense(model.state, twin.state), "sparse != dense after the op path")

        # Pairwise merges, repeated self-merge, reset_remove.
        for _ in range(n):
            dst, src = rng.randrange(n), rng.randrange(n)
            replicas[dst].merge(replicas[src].clone())
            model.merge_from(dst, src)
            twin.merge_from(dst, src)
            counts["merges"] += 1
            check(model.to_pure(dst) == replicas[dst], "sparse merge_from vs oracle merge")
        before = model.to_pure(0)
        model.merge_from(0, 0)
        model.merge_from(0, 0)
        check(model.to_pure(0) == before, "repeated sparse self-merge changed state")
        victim = rng.randrange(n)
        clock = VClock({a: c // 2 for a, c in replicas[victim].clock.dots.items()})
        replicas[victim].reset_remove(clock)
        model.reset_remove(victim, clock)
        twin.reset_remove(victim, clock)
        counts["resets"] += 1
        check(model.to_pure(victim) == replicas[victim], "sparse reset_remove vs oracle")
        check(sparse_equals_dense(model.state, twin.state), "sparse != dense after merges")

        expect = Orswot()
        for s in replicas:
            expect.merge(s.clone())
        check(model.fold() == expect == twin.fold(), "sparse fold vs oracle and dense fold")
        counts["folds"] += 1

    # Capacity: too many live cells, a full parked buffer, a too-long list.
    small = BatchedSparseOrswot(1, 2, 1, deferred_cap=1, rm_width=4, device=device)
    with expect_raises(DotCapacityOverflow):
        small.apply(0, Add(dot=Dot("a", 1), members=("x", "y", "z")))
    check("x" not in small.members, "a refused add interned its members")
    small.apply(0, Rm(clock=VClock({"a": 5}), members=("x",)))
    with expect_raises(DeferredOverflow):
        small.apply(0, Rm(clock=VClock({"a": 6}), members=("y",)))
    with expect_raises(DeferredOverflow):
        small.apply(0, Rm(clock=VClock({"a": 6}), members=tuple("pqrst")))
    pair = BatchedSparseOrswot(2, 2, 2, device=device)
    pair.apply(0, Add(dot=Dot("a", 1), members=("x", "y")))
    pair.apply(1, Add(dot=Dot("b", 1), members=("z",)))
    with expect_raises(DotCapacityOverflow):
        pair.merge_from(0, 1)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    check(counts["parked_seen"] > 0, "no sparse scenario parked an ahead remove")
    out = {"phase": "sparse_scenarios", **counts, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# ---- phase 14 ------------------------------------------------------------

def flagship_population(c: int, universe: int, n_actors: int, device, seed: int = 13):
    """The flagship workload (``bench.py`` ``_flagship_population``, in
    torch): one master table of ``c`` live (element, actor) cells sampled
    from ``universe``, sorted by (eid, act), with counter ``eid·A + act +
    1``; replica ``r`` holds the first ``L_r ∈ [c/2, c]`` lanes (a hash of
    r), a per-actor prefix of every counter sequence, so the population is
    causally valid and its join is exactly the master table. Returns
    ``(gen, master)``: ``gen(row_ids)`` makes a canonical
    ``SparseOrswotState [B, ...]`` on the device, ``master`` holds the
    table and its per-actor top."""
    import numpy as np
    import torch

    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.ops import sparse_orswot as sp

    rng = np.random.default_rng(seed)
    eids = np.sort(rng.choice(universe, size=c, replace=False).astype(np.int64))
    acts = rng.integers(0, n_actors, c).astype(np.int32)
    order = np.lexsort((acts, eids))
    eids, acts = eids[order], acts[order]
    ctrs = (eids * n_actors + acts + 1).astype(np.uint32)
    # Per-lane running top: a replica holding lanes [0, L) has top cummax[L-1].
    cummax = np.zeros((c, n_actors), np.uint32)
    run = np.zeros(n_actors, np.uint32)
    for i in range(c):
        run[acts[i]] = max(run[acts[i]], ctrs[i])
        cummax[i] = run
    u32 = lambda x: torch.tensor(x.view(np.int32), device=device).view(torch.uint32)  # noqa: E731
    master = {"eid": torch.tensor(eids.astype(np.int32), device=device),
              "act": torch.tensor(acts, device=device), "ctr": u32(ctrs),
              "tops": u32(cummax), "top": u32(cummax[-1].copy())}
    half = c // 2
    lanes = torch.arange(c, device=device)

    def gen(row_ids):
        cut = half + ((row_ids * 2654435761) & 0xFFFFFFFF) % max(c - half + 1, 1)
        valid = lanes[None, :] < cut[:, None]
        state = sp.empty(c, n_actors, batch=(row_ids.shape[0],), device=device)
        return state._replace(
            top=bits(master["tops"])[cut - 1].view(torch.uint32),
            eid=torch.where(valid, master["eid"], -1),
            act=torch.where(valid, master["act"], 0),
            ctr=torch.where(valid, bits(master["ctr"]), 0).view(torch.uint32),
            valid=valid,
        )

    return gen, master


def flagship_subsample_gate(device, mesh, n_actors: int) -> dict:
    """``bench.py`` ``_flagship_bit_identity`` on the port: 24 replicas of
    the flagship construction at c = 64 over 4,096 elements (seed 17),
    streamed in blocks of 8 and of 4, against the co-resident tree fold and
    the sequential oracle merge chain."""
    import torch

    from crdt_tpu_torch._dtypes import to_wide
    from crdt_tpu_torch.ops import sparse_orswot as sp
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import iter_blocks, mesh_stream_fold_sparse
    from crdt_tpu_torch.pure.orswot import Orswot
    from crdt_tpu_torch.vclock import VClock

    sub_r, sub_c, sub_uni = 24, 64, 4096
    gen, _ = flagship_population(sub_c, sub_uni, n_actors, device, seed=17)
    pop = gen(torch.arange(sub_r, device=device))
    acc, of = mesh_stream_fold_sparse(iter_blocks(pop, 8), mesh)
    check(not bool(of.any()), "the flagship subsample overflowed")
    acc4, _ = mesh_stream_fold_sparse(iter_blocks(pop, 4), mesh)
    coresident, _ = sp.fold(pop)

    def pure_of(row) -> Orswot:
        o = Orswot()
        o.clock = VClock({a: c for a, c in enumerate(to_wide(row.top).tolist()) if c})
        for e, a, c, v in zip(row.eid.tolist(), row.act.tolist(), to_wide(row.ctr).tolist(),
                              row.valid.tolist()):
            if v:
                o.entries.setdefault(e, VClock()).dots[a] = c
        return o

    oracle = Orswot()
    for i in range(sub_r):
        oracle.merge(pure_of(tree_map(lambda x: x[i], pop)))
    out = {"subsample_shape": f"{sub_r}x{sub_uni} (c={sub_c})",
           "stream_equals_coresident": same_leaves(acc, coresident),
           "block_count_invariant": same_leaves(acc, acc4),
           "stream_equals_pure_oracle": pure_of(acc) == oracle}
    check(all(out[k] for k in ("stream_equals_coresident", "block_count_invariant",
                               "stream_equals_pure_oracle")),
          f"the flagship bit-identity gate failed: {out}")
    return out


def phase_flagship(device, seed: int, r: int = 10240, universe: int = 1_000_000, a: int = 8,
                   cap: int = 4096, block_rows: int = 256, p: int = 8, passes: int = 5,
                   profile_blocks: int = 10, durable_passes: int = 3) -> dict:
    """BASELINE's metric of record at its literal shape (``BENCH_CONFIGS.json``
    "flagship"): merges/s across R replicas of the segment-encoded ORSWOT over
    a 1M-element universe, streamed through P virtual ranks in replica
    blocks. Gates first; then the stream's wall from both block sources."""
    import numpy as np
    import torch

    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.ops import sparse_orswot as sp
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_fold_sparse, mesh_stream_fold_sparse
    from crdt_tpu_torch.parallel import stream as stream_mod
    from crdt_tpu_torch.utils.metrics import metrics

    del seed  # the flagship population has its own seeds (13; 17 for the subsample)
    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    mesh = VirtualMesh(p, device)
    n_blocks = -(-r // block_rows)
    r_run = n_blocks * block_rows
    gate = flagship_subsample_gate(device, mesh, a)

    t0 = time.perf_counter()
    gen, master = flagship_population(cap, universe, a, device)
    sync()
    setup_s = time.perf_counter() - t0
    per_replica = sp.nbytes(gen(torch.arange(1, device=device)))

    def device_blocks():
        for b in range(n_blocks):
            yield gen(torch.arange(b * block_rows, (b + 1) * block_rows, device=device))

    t0 = time.perf_counter()
    acc, of = mesh_stream_fold_sparse(device_blocks(), mesh)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(of.any()), "the flagship stream overflowed its caps")
    # Gate: the converged accumulator is exactly the master table.
    check(bool(acc.valid.all()) and torch.equal(acc.eid, master["eid"])
          and torch.equal(acc.act, master["act"])
          and same_leaves(acc.ctr, master["ctr"]) and same_leaves(acc.top, master["top"]),
          "the flagship stream did not converge to the master table")
    # Gate: the stream equals the co-resident fold of the whole population.
    pop = gen(torch.arange(r_run, device=device))
    t0 = time.perf_counter()
    co, co_of = mesh_fold_sparse(pop, mesh)
    sync()
    coresident_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(co_of.any()) and same_leaves(acc, co),
          "the flagship stream differs from mesh_fold_sparse of the co-resident population")
    coresident_gb = sum(x.numel() * x.element_size() for x in pop) / 1e9
    coresident_peak_gb = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None
    del pop, co

    # One stream step waits for nothing on the host: torch raises on any
    # synchronising call under sync debug mode "error".
    plan = stream_mod._plan_sparse()
    block0 = gen(torch.arange(block_rows, device=device))
    acc0 = sp.empty(cap, a, device=device)
    acc1, _ = stream_mod._step(plan, acc0, block0, p)
    plan.slots_fn(acc0, acc1)
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        acc1, _ = stream_mod._step(plan, acc0, block0, p)
        plan.slots_fn(acc0, acc1)  # the step's one piece of telemetry work
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    del block0, acc0, acc1

    # The same blocks from pinned host memory (set-up, untimed).
    host_blocks = []
    for block in device_blocks():
        host_blocks.append(tree_map(
            lambda x: x.cpu().pin_memory() if on_card else x.clone(), block))
    sources = {"device": device_blocks, "pinned_host": lambda: iter(host_blocks)}
    acc_h, of_h = mesh_stream_fold_sparse(sources["pinned_host"](), mesh)
    check(same_leaves(acc_h, acc) and torch.equal(of_h, of),
          "the stream from pinned host blocks differs from the stream of device blocks")
    del acc_h

    def overlap():
        return metrics.snapshot()["counters"].get("stream.overlap_hit", 0)

    runs = {k: [] for k in sources}
    hits = {k: [] for k in sources}
    peak = {k: 0.0 for k in sources}
    for _ in range(passes):  # alternating, after one warm pass of each above
        for name, src in sources.items():
            h0 = overlap()
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            runs[name].append(time_ms(lambda: mesh_stream_fold_sparse(src(), mesh), device))
            hits[name].append(overlap() - h0)
            if on_card:
                peak[name] = max(peak[name], torch.cuda.max_memory_allocated(device) / 1e9)
    per_source = {}
    for name, src in sources.items():
        # The profiler's trace of a whole stream (≈ 77k launches) takes
        # longer to read back than the stream takes to run: profile the
        # first `profile_blocks` blocks.
        busy = profile_busy(lambda: mesh_stream_fold_sparse(
            itertools.islice(src(), profile_blocks), mesh), device)
        med = statistics.median(runs[name])
        per_source[name] = {
            "stream_ms_median": med, "stream_ms_min": min(runs[name]),
            "stream_ms_max": max(runs[name]), "stream_ms_runs": runs[name],
            "merges_per_s": (r_run - 1) / (med * 1e-3),
            "overlap_hit_per_pass": hits[name],
            "peak_mem_gb": peak[name] if on_card else None,
            "profile": busy,
            "busy_share": busy["busy_share"] if busy else None,
            "sort_share_of_device_time": busy["sort_ms"] / busy["device_ms"] if busy else None,
            "launch_kernel_calls_per_block":
                busy["launch_kernel_calls"] / profile_blocks if busy else None,
        }
    # Passes with the telemetry sidecar (ROADMAP 15.1), alternating with
    # plain ones from device blocks: the stream's counts, and merges/s on.
    tel_runs = {False: [], True: []}
    for _ in range(3):
        for on in (False, True):
            t0 = time.perf_counter()
            res_t = mesh_stream_fold_sparse(device_blocks(), mesh, telemetry=on)
            sync()
            tel_runs[on].append((time.perf_counter() - t0) * 1e3)
            check(same_leaves(res_t[0], acc) and torch.equal(res_t[1], of),
                  "a stream pass with telemetry= differs from the plain pass")
            if on:
                tel_d = tele.to_dict(res_t[2])
            del res_t
    staged = n_blocks * block_rows * per_replica
    tel_gates = {
        "stream_blocks": tel_d["stream_blocks"] == n_blocks,
        "stream_staged_bytes": tel_d["stream_staged_bytes"] == float(np.float32(staged)),
        # Each step: a rank's B/P − 1 fold joins, log2(P) exchanges, the
        # accumulator join (JAX stream.py's count).
        "merges": tel_d["merges"] == n_blocks * p * (block_rows // p - 1 + (p.bit_length() - 1)
                                                     + 1),
    }
    check(all(tel_gates.values()), f"flagship telemetry gates failed: {tel_gates}")
    tel_med = {on: statistics.median(v) for on, v in tel_runs.items()}
    telemetry = {
        "gates": tel_gates, "stream_blocks": tel_d["stream_blocks"],
        "stream_staged_bytes": tel_d["stream_staged_bytes"], "staged_bytes_exact": staged,
        "slots_changed": tel_d["slots_changed"], "merges": tel_d["merges"],
        "stream_ms_off": tel_med[False], "stream_ms_on": tel_med[True],
        "merges_per_s_off": (r_run - 1) / (tel_med[False] * 1e-3),
        "merges_per_s_on": (r_run - 1) / (tel_med[True] * 1e-3),
        "runs": {"off": tel_runs[False], "on": tel_runs[True]},
    }
    durable = with_scratch_dir(lambda root: durable_stream(
        device_blocks, acc, mesh, sp.empty(cap, a, device=device), n_blocks, sync, durable_passes,
        root))
    out = {
        "phase": "flagship",
        "R": r_run, "universe": universe, "A": a, "segment_cap": cap, "D": 4, "Q": 8,
        "block_rows": block_rows, "blocks": n_blocks, "P": p, "profiled_blocks": profile_blocks,
        "bit_identity_gate": gate, "setup_s": setup_s,
        "per_replica_bytes": per_replica, "block_mb": per_replica * block_rows / 1e6,
        "coresident_gb": coresident_gb, "coresident_mesh_fold_sparse_ms": coresident_ms,
        "coresident_peak_mem_gb": coresident_peak_gb,
        "converged_live_cells": int(acc.valid.sum()),
        "first_stream_ms_cold": first_ms, "step_syncs_with_host": False if on_card else None,
        "merges_per_s_device_blocks": per_source["device"]["merges_per_s"],
        "merges_per_s_pinned_host_blocks": per_source["pinned_host"]["merges_per_s"],
        "sources": per_source, "durable": durable, "telemetry": telemetry,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


def durable_stream(blocks, want, mesh, template, n_blocks: int, sync, passes: int,
                   root: str) -> dict:
    """The replica stream with ``wal=`` (ROADMAP 9): a pass whose block
    source dies after half the blocks (20 of the flagship's 40) must raise
    ``StreamInterrupted`` with resume records every fifth of the blocks
    (8) and at the interrupt; from a
    reopened log, ``load_stream_resume`` and a re-entered stream
    (``init=acc``, ``wal_base``) land on ``want``, the uninterrupted pass.
    Then ``passes`` walls of the logged and the unlogged pass, alternating."""
    import shutil

    from crdt_tpu_torch.durability import Wal, load_stream_resume
    from crdt_tpu_torch.parallel import StreamInterrupted, mesh_stream_fold_sparse

    die_after, every = n_blocks // 2, max(1, n_blocks // 5)

    def dying():
        yield from itertools.islice(blocks(), die_after)
        raise OSError(f"the block source went away after block {die_after}")

    wal_dir = os.path.join(root, "wal")
    w = Wal(wal_dir)
    t0 = time.perf_counter()
    interrupted = None
    try:
        mesh_stream_fold_sparse(dying(), mesh, wal=w, wal_every=every)
    except StreamInterrupted as exc:
        interrupted = exc.blocks_done
    sync()
    dying_ms = (time.perf_counter() - t0) * 1e3
    check(interrupted == die_after, f"the dying stream stopped at block {interrupted}")
    resume_points = [m["blocks_done"] for _, m, _ in w.records()]
    expect = [*range(every, die_after + 1, every), die_after]
    check(resume_points == expect, f"resume records at {resume_points}, not {expect}")
    appended = dict(w.seconds)
    w.close()
    t0 = time.perf_counter()
    w = Wal(wal_dir)
    open_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc, done = load_stream_resume(w, template)
    load_s = time.perf_counter() - t0
    resumed, of = mesh_stream_fold_sparse(itertools.islice(blocks(), done, None), mesh, init=acc,
                                          wal=w, wal_every=every, wal_base=done)
    check(done == die_after and not bool(of.any()) and same_leaves(resumed, want),
          "the resumed stream differs from the uninterrupted pass")
    points = [m["blocks_done"] for _, m, _ in w.records()]
    check(points[-1] == n_blocks, f"the resumed stream's last resume record is at {points[-1]}")
    resume_record_bytes = w.bytes_appended / (len(points) - len(resume_points))
    w.close()
    logs = [Wal(os.path.join(root, f"timed-{i}")) for i in range(passes)]
    pending = iter(logs)
    runs = {True: [], False: []}
    for _ in range(passes):
        for logged in (True, False):
            t0 = time.perf_counter()
            mesh_stream_fold_sparse(blocks(), mesh, wal=next(pending) if logged else None,
                                    wal_every=every if logged else 0)
            sync()
            runs[logged].append((time.perf_counter() - t0) * 1e3)
    fsyncs = [log.fsyncs for log in logs]
    for log in logs:
        log.close()
        shutil.rmtree(log.path)
    return {
        "die_after_blocks": die_after, "wal_every": every, "resume_points": resume_points,
        "dying_pass_ms": dying_ms, "append_wall_s_dying_pass": appended,
        "resume_record_bytes": resume_record_bytes,
        "acc_bytes": sum(x.numel() * x.element_size() for x in want),
        "recovery": {"open_scan_s": open_s, "load_stream_resume_s": load_s},
        "fsyncs_per_logged_pass": fsyncs,
        "stream_ms_logged": statistics.median(runs[True]),
        "stream_ms_unlogged": statistics.median(runs[False]),
        "logged_over_unlogged": statistics.median(runs[True]) / statistics.median(runs[False]),
        "stream_ms_logged_runs": runs[True], "stream_ms_unlogged_runs": runs[False],
    }


# ---- phases 15-17 (ROADMAP 7b) ---------------------------------------------

def sparse_actor_population(r: int, c: int, universe: int, a: int, dot_cap: int, device,
                            seed: int = 17):
    """A sparse ORSWOT population whose union outgrows each replica: one
    master table of ``c`` (element, actor) cells as in
    :func:`flagship_population`, and replica ``i`` holds a prefix of actor
    ``i % a``'s cells only (between half and all of them), so every
    replica fits ``dot_cap`` while a fold of ``a`` replicas needs the
    whole table. Causally valid: a replica's top covers exactly the
    counters of its prefix."""
    import numpy as np
    import torch

    from crdt_tpu_torch.ops import sparse_orswot as sp

    rng = np.random.default_rng(seed)
    eids = np.sort(rng.choice(universe, size=c, replace=False).astype(np.int64))
    acts = rng.integers(0, a, c).astype(np.int64)
    ctrs = eids * a + acts + 1
    cols = {"eid": np.full((r, dot_cap), -1, np.int32), "act": np.zeros((r, dot_cap), np.int32),
            "ctr": np.zeros((r, dot_cap), np.int64), "valid": np.zeros((r, dot_cap), bool)}
    top = np.zeros((r, a), np.int64)
    for i in range(r):
        g = i % a
        own = np.nonzero(acts == g)[0]
        n = len(own) // 2 + (i * 2654435761) % (len(own) - len(own) // 2 + 1)
        check(n <= dot_cap, "a replica outgrows the sparse population's dot_cap")
        cols["eid"][i, :n], cols["act"][i, :n] = eids[own[:n]], g
        cols["ctr"][i, :n], cols["valid"][i, :n] = ctrs[own[:n]], True
        top[i, g] = ctrs[own[n - 1]] if n else 0
    u32 = lambda x: torch.tensor(x.astype(np.uint32).view(np.int32), device=device).view(  # noqa: E731
        torch.uint32)
    return sp.empty(dot_cap, a, batch=(r,), device=device)._replace(
        top=u32(top), eid=torch.tensor(cols["eid"], device=device),
        act=torch.tensor(cols["act"], device=device), ctr=u32(cols["ctr"]),
        valid=torch.tensor(cols["valid"], device=device))


def phase_elastic(device, seed: int, r: int = 5120, e: int = 102400, a: int = 8, p: int = 8,
                  cap: int = 4096, chunk: int = 128, map_r: int = 64, k: int = 1_000_000,
                  s: int = 2, map_a: int = 4, map_chunk: int = 8, sp_r: int = 64,
                  sp_cells: int = 4096, sp_universe: int = 1_000_000) -> dict:
    """The overflow → widen → re-enter loops on the card. Dense ORSWOT at
    config 3's widths born with ``deferred_cap = 2`` under traffic whose
    rank folds meet three parked cross removes: ``delta_gossip_elastic``
    (without and with the ack window) and ``gossip_elastic`` must overflow
    in their first attempt, widen to 4 and certify, equal to rings of a
    model born at 4 and to ``mesh_fold``. Then ``gossip_elastic`` on a
    ``BatchedSparseOrswot`` whose replicas each hold one actor's cells
    (``dot_cap`` overflow) and on a ``BatchedMap`` at config 4's widths born
    with one parked slot, each equal to a wider-born ring and its fold."""
    import torch

    from crdt_tpu_torch.durability import Wal
    from crdt_tpu_torch.models import BatchedMap, BatchedOrswot, BatchedSparseOrswot
    from crdt_tpu_torch.ops.fold_kernels import fold_cells, fold_entries
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import (
        VirtualMesh, delta_gossip_elastic, gossip_elastic, mesh_delta_gossip, mesh_fold,
        mesh_fold_map, mesh_fold_sparse, mesh_gossip, mesh_gossip_map, mesh_gossip_sparse,
    )
    from crdt_tpu_torch.utils.metrics import metrics

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_phase = time.perf_counter()
    mesh = VirtualMesh(p, device)
    rl = r // p
    counters = lambda: dict(metrics.snapshot()["counters"])  # noqa: E731

    synced = []

    def dense(d):
        st, dd, ff, info = fill_delta_config3(r, e, a, d, p, seed, device, chunk, max_parked=2,
                                              synced_out=synced)
        model = BatchedOrswot(1, e, a, d, device=device)
        model.state = st
        return model, dd, ff, info

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    out = {"phase": "elastic", "P": p}
    # gossip_elastic on the dense model (K1 in every attempt's local folds).
    model, dd, ff, info = dense(2)
    backlog = int(dd.view(p, rl, e).any(1).sum(-1).max())
    rounds = 2 * (p - 1) * (1 + -(-backlog // cap)) - 1
    del dd, ff
    c0, fold_entries.launches = counters(), 0
    (g_rows, g_widened), g_ms = timed(lambda: gossip_elastic(model, mesh))
    migrations = counters().get("elastic.gossip_migrations", 0) - c0.get(
        "elastic.gossip_migrations", 0)
    check(g_widened == {"deferred_cap": 4} and migrations == 1,
          f"dense gossip_elastic widened {g_widened} in {migrations} migrations, not 2 -> 4")
    out["dense_gossip"] = {"R": r, "E": e, "A": a, "born_deferred_cap": 2, "widened": g_widened,
                           "migrations": migrations, "k1_launches": fold_entries.launches,
                           "wall_ms": g_ms, **info}
    check(not on_card or fold_entries.launches == 2 * p, "gossip_elastic did not run K1")
    del model
    # delta_gossip_elastic, unacked and acked: the same (dirty, fctx) in both
    # attempts of each. The unacked loop runs with wal= (ROADMAP 9), its
    # log's base the [P, ...] synced state at D = 2: the committed attempt,
    # widened, is one full-state record.
    d_rows = {}
    for ack in (False, True):
        model, dd, ff, _ = dense(2)
        base = tree_map(lambda x: x.expand(p, *x.shape).clone(), synced.pop())

        def run(root):
            wal = None
            if root is not None:
                wal = Wal(os.path.join(root, "wal"), fsync="on_round")
                wal.attach(base)
            c0, fold_entries.launches = counters(), 0
            res, ms = timed(lambda: delta_gossip_elastic(model, dd, ff, mesh, rounds=rounds,
                                                         cap=cap, ack_window=ack, wal=wal))
            record = elastic_record(wal, root, base, res[0]) if wal is not None else {}
            return {"res": res, "ms": ms, "c0": c0, "record": record}

        ran = run(None) if ack else with_scratch_dir(run)
        res, ms, c0 = ran["res"], ran["ms"], ran["c0"]
        if not ack:
            out["delta_wal"] = {**ran["record"], "filesystem": ran["filesystem"]}
        migrations = counters().get("elastic.delta_migrations", 0) - c0.get(
            "elastic.delta_migrations", 0)
        check(res[4] == {"deferred_cap": 4} and migrations == 1 and int(res[3]) == 0
              and not bool(res[2]),
              f"delta_gossip_elastic (ack_window={ack}) widened {res[4]} in {migrations} "
              f"migrations, residue {int(res[3])}")
        check(model.state.dvalid.shape[-1] == 4, "the model was not widened in place")
        out["delta_acked" if ack else "delta"] = {
            "rounds": rounds, "widened": res[4], "migrations": migrations, "wall_ms": ms,
            "k1_launches": fold_entries.launches}
        d_rows[ack] = res[0]
        del model, dd, ff, res
    # Born at 4: the δ ring, the full-state ring and the fold.
    st4, dd4, ff4, _ = fill_delta_config3(r, e, a, 4, p, seed, device, chunk, max_parked=2)
    ring4 = mesh_delta_gossip(st4, dd4, ff4, mesh, rounds=rounds, cap=cap)
    check(int(ring4[3]) == 0 and not bool(ring4[2]), "the ring born at D = 4 did not certify")
    del dd4, ff4
    check(same_leaves(d_rows[False], ring4[0]) and same_leaves(d_rows[True], ring4[0]),
          "delta_gossip_elastic's rows differ from the ring born at D = 4")
    g4, of4 = mesh_gossip(st4, mesh)
    check(not bool(of4) and same_leaves(g_rows, g4),
          "gossip_elastic's rows differ from mesh_gossip born at D = 4")
    folded, _ = mesh_fold(st4, mesh)
    check(rows_equal_fold(ring4[0], folded) and rows_equal_fold(g4, folded),
          "the widened rings' rows != mesh_fold")
    out["dense_converged_parked"] = int(folded.dvalid.sum())
    del st4, ring4, g4, folded, d_rows, g_rows

    # gossip_elastic on the sparse ORSWOT: dot_cap outgrown by rank folds.
    born = sp_cells // 4
    model = BatchedSparseOrswot(1, born, a, device=device)
    model.state = sparse_actor_population(sp_r, sp_cells, sp_universe, a, born, device)
    (sp_rows, sp_widened), ms = timed(lambda: gossip_elastic(model, mesh))
    check(sp_widened == {"dot_cap": sp_cells}, f"sparse gossip_elastic widened {sp_widened}")
    wide = sparse_actor_population(sp_r, sp_cells, sp_universe, a, sp_cells, device)
    sp4, sp_of = mesh_gossip_sparse(wide, mesh)
    sp_fold, _ = mesh_fold_sparse(wide, mesh)
    check(not bool(sp_of.any()) and same_leaves(sp_rows, sp4),
          "sparse gossip_elastic's rows differ from the ring born at the widened dot_cap")
    check(all(same_leaves(tuple(x[q] for x in sp4), tuple(sp_fold)) for q in range(p)),
          "the sparse ring's rows != mesh_fold_sparse")
    out["sparse_gossip"] = {"R": sp_r, "cells": sp_cells, "universe": sp_universe, "A": a,
                            "born_dot_cap": born, "widened": sp_widened, "wall_ms": ms,
                            "converged_cells": int(sp_fold.valid.sum())}
    del model, wide, sp4, sp_rows, sp_fold

    # gossip_elastic on the Map (K2 in every attempt's local folds).
    def map_model(d):
        st, _, _, info = fill_delta_config4(map_r, k, s, map_a, d, p, seed, device, map_chunk,
                                            max_parked=1)
        model = BatchedMap(1, k, map_a, s, d, device=device)
        model.state = st
        return model, info

    model, info = map_model(1)
    c0, fold_cells.launches = counters(), 0
    (m_rows, m_widened), ms = timed(lambda: gossip_elastic(model, mesh))
    migrations = counters().get("elastic.gossip_migrations", 0) - c0.get(
        "elastic.gossip_migrations", 0)
    check(m_widened == {"deferred_cap": 2} and migrations == 1,
          f"map gossip_elastic widened {m_widened} in {migrations} migrations")
    check(not on_card or fold_cells.launches == 2 * p, "map gossip_elastic did not run K2")
    k2 = fold_cells.launches
    del model
    wide, _ = map_model(2)
    m4, m_of = mesh_gossip_map(wide.state, mesh)
    folded, _ = mesh_fold_map(wide.state, mesh)
    check(not bool(m_of.any()) and same_leaves(m_rows, m4) and rows_equal_fold(m4, folded),
          "map gossip_elastic's rows differ from the ring born at D = 2 or its fold")
    out["map_gossip"] = {"R": map_r, "K": k, "S": s, "A": map_a, "born_deferred_cap": 1,
                         "widened": m_widened, "migrations": migrations, "k2_launches": k2,
                         "wall_ms": ms, "replicas_parking": info["replicas_parking"]}
    del wide, m4, m_rows, folded
    out["reduced"] = {"map_deferred_cap": [
        4, 2, "config 4's A = 4 leaves room for two cross removes, which cannot outgrow D = 4: "
              "the Map model is born at D = 1 and widens to 2"]}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def elastic_record(wal, root: str, base, committed) -> dict:
    """The log of a ``delta_gossip_elastic`` run with ``wal=``: exactly one
    record, a full-state record (the widen changed the shapes), and
    recovery from it (no snapshot: the genesis is ``base``) equals the
    committed attempt's rows."""
    from crdt_tpu_torch.durability import Wal, recover_state

    records = [m for _, m, _ in wal.records()]
    record_bytes, fsyncs = wal.bytes_appended, wal.fsyncs
    wal.close()
    check(records == [{"rtype": "state", "kind": "orswot", "batched": True}],
          f"delta_gossip_elastic logged {records}, not one full-state record")
    t0 = time.perf_counter()
    with Wal(wal.path) as w:
        got, rep = recover_state(os.path.join(root, "snap"), w, base, kind="orswot",
                                 default=base)
    recover_s = time.perf_counter() - t0
    check(rep.full_state_records == 1 and same_leaves(got, committed),
          "the recovery from delta_gossip_elastic's log != the committed rows")
    return {"records": records, "record_bytes": record_bytes, "fsyncs": fsyncs,
            "recovery_s": recover_s}


def diverged_ranks(kind: str, p: int, seed: int, device, **widths):
    """P ranks that diverged from one synced snapshot: rank q's replica 0
    of the δ fills (a prefix of every actor's post-sync stream, so a few
    thousand changed rows per rank), their ``(dirty, fctx)`` and the
    synced state they all inflate."""
    from crdt_tpu_torch.ops.lattice import tree_map

    synced = []
    rl = 4
    if kind == "orswot":
        st, dd, ff, _ = fill_delta_config3(p * rl, widths["e"], widths["a"], widths["d"], p, seed,
                                           device, chunk=rl * p, synced_out=synced)
    else:
        st, dd, ff, _ = fill_delta_config4(p * rl, widths["k"], widths["s"], widths["a"],
                                           widths["d"], p, seed, device, chunk=8,
                                           synced_out=synced)
    pick = lambda x: x[::rl].contiguous()  # noqa: E731
    return tree_map(pick, st), pick(dd), pick(ff), synced[0]


def phase_resync(device, seed: int, p: int = 8, e: int = 102400, a: int = 8, d: int = 4,
                 k: int = 1_000_000, s: int = 2, map_a: int = 4) -> dict:
    """``delta_opt.heal.resync`` over P = 8 ranks that diverged from one
    snapshot, dense at config 3's widths and Map at config 4's: the healed
    rows == the left-to-right join chain of the ranks themselves on every
    leaf; lanes and bytes shipped against full states, and the wall."""
    import torch

    from crdt_tpu_torch.delta_opt import resync
    from crdt_tpu_torch.ops import map as map_ops
    from crdt_tpu_torch.ops import orswot
    from crdt_tpu_torch.ops.lattice import tree_map

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    out = {"phase": "resync", "P": p}
    for kind, join, widths in (("orswot", orswot.join, dict(e=e, a=a, d=d)),
                               ("map", map_ops.join, dict(k=k, s=s, a=map_a, d=d))):
        ranks, _, _, since = diverged_ranks(kind, p, seed, device, **widths)
        resync(kind, ranks, since)  # warm-up
        sync()
        t0 = time.perf_counter()
        healed, report = resync(kind, ranks, since)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        chain = tree_map(lambda x: x[0], ranks)
        for q in range(1, p):
            chain, _ = join(chain, tree_map(lambda x: x[q], ranks))
        check(all(same_leaves(tree_map(lambda x: x[q], healed), chain) for q in range(p)),
              f"{kind} resync differs from the join chain")
        out[kind] = {**widths, "lanes_shipped": report.lanes_shipped,
                     "bytes_shipped": report.bytes_shipped,
                     "bytes_full_state": report.bytes_full_state, "ratio": report.ratio,
                     "wall_ms": wall_ms}
        del ranks, since, healed, chain
    emit(out)
    return out


def phase_donate(device, seed: int, p: int = 8, e: int = 102400, a: int = 8, d: int = 4,
                 k: int = 1_000_000, s: int = 2, map_a: int = 4, cap: int = 4096) -> dict:
    """``donate=True`` at R == P = 8: ``mesh_gossip`` at config 3's widths
    and ``mesh_delta_gossip_map`` at config 4's equal their copying runs on
    every leaf, and their outputs live in the donated inputs' storage.
    Peak memory of both runs beside each other, and what each leaves
    allocated after it, both above what was allocated before the call
    (the inputs included)."""
    import torch

    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip_map, mesh_gossip

    on_card = device.type == "cuda"
    mesh = VirtualMesh(p, device)
    out = {"phase": "donate", "R": p, "P": p}

    def peak(fn):
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        res = fn()
        if on_card:
            torch.cuda.synchronize(device)
            return res, {"peak_gb": (torch.cuda.max_memory_allocated(device) - base) / 1e9,
                         "resident_gb_after": (torch.cuda.memory_allocated(device) - base) / 1e9}
        return res, None

    def leaves(tree):
        return [tree] if isinstance(tree, torch.Tensor) else [y for x in tree for y in leaves(x)]

    dense, _, _, _ = diverged_ranks("orswot", p, seed, device, e=e, a=a, d=d)
    copied, donated = tree_map(torch.clone, dense), tree_map(torch.clone, dense)
    (rows0, of0), peak0 = peak(lambda: mesh_gossip(copied, mesh))
    (rows1, of1), peak1 = peak(lambda: mesh_gossip(donated, mesh, donate=True))
    check(same_leaves(rows0, rows1) and bool(of0) == bool(of1),
          "donated mesh_gossip differs from the copying run")
    check(all(x.data_ptr() == y.data_ptr() for x, y in zip(leaves(rows1), leaves(donated))),
          "donated mesh_gossip's rows are not in the input's storage")
    out["mesh_gossip"] = {"E": e, "A": a, "D": d, "copying": peak0, "donated": peak1}
    del dense, copied, rows0, rows1, donated

    ranks, dd, ff, _ = diverged_ranks("map", p, seed, device, k=k, s=s, a=map_a, d=d)
    rounds = 2 * (p - 1) * (1 + -(-int(dd.sum(-1).max()) // cap)) - 1
    copied, dd0 = tree_map(torch.clone, ranks), dd.clone()
    ring0, peak0 = peak(lambda: mesh_delta_gossip_map(copied, dd0, ff, mesh, rounds=rounds,
                                                      cap=cap))
    ds, dd1 = tree_map(torch.clone, ranks), dd.clone()
    ring1, peak1 = peak(lambda: mesh_delta_gossip_map(ds, dd1, ff, mesh, rounds=rounds, cap=cap,
                                                      donate=True))
    check(same_leaves(ring0, ring1) and int(ring1[3]) == 0,
          "donated mesh_delta_gossip_map differs from the copying run")
    check(all(x.data_ptr() == y.data_ptr() for x, y in zip(leaves(ring1[0]), leaves(ds)))
          and ring1[1].data_ptr() == dd1.data_ptr(),
          "donated mesh_delta_gossip_map's outputs are not in the input's storage")
    out["mesh_delta_gossip_map"] = {"K": k, "S": s, "A": map_a, "D": d, "rounds": rounds,
                                    "copying": peak0, "donated": peak1}
    emit(out)
    return out


# ---- durability (ROADMAP item 9) ----------------------------------------------

def fs_info(path) -> dict:
    """The filesystem that holds ``path``: its mount point and type (the
    longest matching mount point of ``/proc/mounts``) and its free bytes.
    An fsync on ``tmpfs`` is not a disk barrier, and fsync times depend on
    the filesystem."""
    real = os.path.realpath(path)
    mount, fstype = "", None
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            mnt = fields[1].replace("\\040", " ")
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(mount):
                mount, fstype = mnt, fields[2]
    st = os.statvfs(real)
    return {"path": real, "mount": mount, "fstype": fstype,
            "free_bytes": st.f_bavail * st.f_frsize}


def with_scratch_dir(fn):
    """``fn(root)`` in a fresh temporary directory, removed afterwards; the
    result carries the directory's filesystem (:func:`fs_info`)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return {**fn(root), "filesystem": fs_info(root)}
    finally:
        shutil.rmtree(root)


def kind_arrays(kind: str, rng) -> dict:
    """One random unbatched state of decomposition ``kind`` as numpy leaves
    (``convert``'s names and dtypes; a vclock is ``{"clock": [A] u32}``, a
    gset ``{"present": [E] bool}``, an lwwreg four 0-d leaves).
    The WAL's positional diff is exact on any bits, so any state is a fair
    crash-recovery input."""
    import numpy as np

    def u32(shape):
        return rng.integers(0, 50, shape).astype(np.uint32)

    if kind == "orswot":
        return dict(top=u32((3,)), ctr=u32((8, 3)), dcl=u32((2, 3)),
                    dmask=rng.random((2, 8)) < 0.4, dvalid=rng.random(2) < 0.5)
    child = dict(wact=rng.integers(0, 3, (4, 2)).astype(np.int32), wctr=u32((4, 2)),
                 clk=u32((4, 2, 3)), val=rng.integers(0, 9, (4, 2)).astype(np.int32),
                 valid=rng.random((4, 2)) < 0.5)
    if kind == "map":
        return dict(top=u32((3,)), child=child, dcl=u32((2, 3)),
                    dkeys=rng.random((2, 4)) < 0.4, dvalid=rng.random(2) < 0.5)
    if kind == "mvreg":
        return {k: v[0] for k, v in child.items()}
    if kind == "vclock":
        return dict(clock=u32((5,)))
    if kind == "gset":
        return dict(present=rng.random(9) < 0.4)
    if kind == "lwwreg":
        return dict(hi=u32(()), lo=u32(()), val=np.asarray(rng.integers(0, 9), np.int32),
                    has=np.asarray(rng.random() < 0.7))
    orswot = dict(top=u32((3,)), ctr=u32((8, 3)), dcl=u32((2, 3)),
                  dmask=rng.random((2, 8)) < 0.4, dvalid=rng.random(2) < 0.5)

    def level(prefix: str, n_keys: int) -> dict:  # one nest level's buffer
        return {f"{prefix}dcl": u32((2, 3)), f"{prefix}dkeys": rng.random((2, n_keys)) < 0.4,
                f"{prefix}dvalid": rng.random(2) < 0.5}

    if kind == "map_orswot":  # 4 keys x 2 members
        return dict(core=orswot, **level("k", 4))
    if kind == "map3":  # 2 x 2 keys x 2 members
        return dict(mo=dict(core=orswot, **level("k", 4)), **level("o", 2))
    if kind == "map_map":  # 2 x 2 keys
        m = dict(top=u32((3,)), child=child, dcl=u32((2, 3)),
                 dkeys=rng.random((2, 4)) < 0.4, dvalid=rng.random(2) < 0.5)
        return dict(m=m, **level("o", 2))
    segments = dict(top=u32((3,)), eid=rng.integers(-1, 30, 8).astype(np.int32),
                    act=rng.integers(0, 3, 8).astype(np.int32), ctr=u32((8,)),
                    valid=rng.random(8) < 0.6, dcl=u32((2, 3)),
                    didx=rng.integers(-1, 30, (2, 4)).astype(np.int32),
                    dvalid=rng.random(2) < 0.5)
    if kind == "sparse_orswot":
        return segments
    if kind == "sparse_mvmap":
        return dict(top=u32((3,)), kid=rng.integers(-1, 30, 8).astype(np.int32),
                    act=rng.integers(0, 3, 8).astype(np.int32), ctr=u32((8,)),
                    val=rng.integers(0, 9, 8).astype(np.int32), clk=u32((8, 3)),
                    valid=rng.random(8) < 0.6, dcl=u32((2, 3)),
                    kidx=rng.integers(-1, 30, (2, 4)).astype(np.int32),
                    dvalid=rng.random(2) < 0.5)
    check(kind in ("sparse_nest", "sparse_nested_map"), f"no random state for kind {kind!r}")
    return dict(core=segments, kcl=u32((2, 3)),
                kidx=rng.integers(-1, 8, (2, 4)).astype(np.int32), kdvalid=rng.random(2) < 0.5)


def kind_state(kind: str, arrays: dict, device):
    """:func:`kind_arrays`'s leaves as the port's state on ``device``."""
    from crdt_tpu_torch.convert import (
        gset_from_numpy, leaf_from_numpy, lww_from_numpy, map_from_numpy, nest_from_numpy,
        orswot_from_numpy, sparse_mvmap_from_numpy, sparse_nest_from_numpy,
        sparse_orswot_from_numpy,
    )
    from crdt_tpu_torch.ops.mvreg import MVRegState

    if kind == "gset":
        return gset_from_numpy(arrays["present"], device)
    if kind == "lwwreg":
        return lww_from_numpy(arrays, device)
    if kind == "orswot":
        return orswot_from_numpy(arrays, device)
    if kind == "map":
        return map_from_numpy(arrays, device)
    if kind == "sparse_orswot":
        return sparse_orswot_from_numpy(arrays, device)
    if kind == "sparse_mvmap":
        return sparse_mvmap_from_numpy(arrays, device)
    if kind in ("sparse_nest", "sparse_nested_map"):
        return sparse_nest_from_numpy(arrays, device)
    if kind in ("map_orswot", "map3", "map_map"):
        return nest_from_numpy(arrays, device)
    if kind == "mvreg":
        return MVRegState(**{k: leaf_from_numpy(v, device) for k, v in arrays.items()})
    return leaf_from_numpy(arrays["clock"], device)


def fuzz_workload(root: str, kind: str, states) -> None:
    """The durable workload a crashpoint kills (``tests/test_durability.py``'s):
    δ records of ``states[1:]`` over ``states[0]`` in a log of 512-byte
    segments (rotation), fsynced after every append, and two snapshots with
    retain 1 (the prune)."""
    from crdt_tpu_torch.durability import Wal, snapshot

    w = Wal(os.path.join(root, "wal"), fsync="every_n", every_n=1, segment_bytes=512)
    w.attach(states[0])
    for i, st in enumerate(states[1:], 1):
        w.append_state(kind, st, batched=False)
        if i in (2, 4):
            snapshot.save_state(os.path.join(root, "snap"), kind, st, wal_seq=w.last_seq,
                                retain=1)
    w.close()


def crashpoint_diagonal(device, seed: int, root: str) -> dict:
    """Every registered crashpoint once, the port's decomposition kinds
    cycled, states on ``device``: the workload dies at the point, and
    recovery from the surviving files lands bit-identically on the state
    of the last durable record."""
    import numpy as np

    from crdt_tpu_torch.delta_opt.decompose import KINDS
    from crdt_tpu_torch.durability import Wal, crashpoints, recover_state

    kinds = sorted(KINDS)
    # The durability core's points (the serving tier's seven ride its own
    # workloads: tests/test_torch_serve_durable.py).
    points = tuple(p for p in crashpoints.registered() if p.startswith(("wal.", "snapshot.")))
    with crashpoints.recording() as crossed:
        states = [kind_state("orswot", kind_arrays("orswot", np.random.default_rng(seed)), device)
                  for _ in range(6)]
        fuzz_workload(os.path.join(root, "coverage"), "orswot", states)
    check(crossed == set(points), f"the workload crosses {sorted(crossed)}, not every point")
    landed = {}
    for i, point in enumerate(points):
        kind = kinds[i % len(kinds)]
        rng = np.random.default_rng(seed + i)
        states = [kind_state(kind, kind_arrays(kind, rng), device) for _ in range(6)]
        run = os.path.join(root, f"fuzz-{i:02d}")

        def recover():
            with Wal(os.path.join(run, "wal")) as w:
                got, _ = recover_state(os.path.join(run, "snap"), w, states[0], kind=kind,
                                       default=states[0])
                landed[point] = (kind, w.last_seq)
                return got, states[w.last_seq]

        failures = crashpoints.fuzz(lambda name: fuzz_workload(run, kind, states), recover,
                                    same_leaves, names=(point,))
        check(not failures, f"crashpoint {point} ({kind}): {failures}")
    return {"crashpoints": len(points), "kinds": kinds,
            "recovered_to_seq": {p: {"kind": k, "seq": q} for p, (k, q) in landed.items()}}


def durable_ring(kind: str, ring, base, out, counters, rounds: int, sync, samples: int,
                 root: str) -> dict:
    """A δ ring entry with ``wal=``, on the state it certified unlogged
    (``out``). The log's object is the mesh's ``[P, ...]`` rank state:
    ``base`` (every rank at the synced state the fill started from) is
    snapshot as generation 1 and attached as the diff base; the logged ring
    ``ring(wal)`` must equal ``out`` and launch the kernels as the unlogged
    one did (``counters`` set to 0 just before, read just after). Then:
    "restart" (reopen, recover: == the ring's rows); a second append killed
    at ``wal.mid_append`` (reopening truncates the torn tail, recovery lands
    on the last durable record); a corrupt newest generation (recovery
    falls back a generation, replays the suffix, still bit-identical); and
    ``samples`` walls of the logged and unlogged ring, alternating."""
    import shutil

    from crdt_tpu_torch.delta_opt.decompose import KINDS
    from crdt_tpu_torch.durability import (
        SimulatedCrash, Wal, crashpoints, recover_state, snapshot,
    )
    from crdt_tpu_torch.ops.lattice import tree_leaves
    from crdt_tpu_torch.utils.metrics import state_nbytes

    snap_dir, wal_dir = os.path.join(root, kind, "snap"), os.path.join(root, kind, "wal")
    t0 = time.perf_counter()
    snapshot.save_state(snap_dir, kind, base, wal_seq=0)
    snap_s = time.perf_counter() - t0
    w = Wal(wal_dir, fsync="on_round")
    w.attach(base)
    fsyncs0 = w.fsyncs
    for counted in counters:
        counted.launches = 0
    t0 = time.perf_counter()
    logged = ring(w)
    sync()
    logged_ms = (time.perf_counter() - t0) * 1e3
    launches = [counted.launches for counted in counters]
    check(same_leaves(logged[0], out[0]) and same_leaves(logged[1], out[1])
          and int(logged[3]) == 0, f"the {kind} ring with wal= differs from the unlogged ring")
    check(w.last_seq == 1 and w.fsyncs - fsyncs0 == 1,
          f"the {kind} ring logged {w.last_seq} records with {w.fsyncs - fsyncs0} fsyncs")
    append = {"decompose_s": w.seconds["decompose"], "copy_s": w.seconds["copy"],
              "write_s": w.seconds["write"], "fsync_s": w.seconds["fsync"]}
    record_bytes = w.bytes_appended
    w.close()

    # "Restart": the log and the snapshot alone.
    t0 = time.perf_counter()
    w = Wal(wal_dir)
    open_s = time.perf_counter() - t0
    (_, meta, leaves), = list(w.records())
    n_rows = len(tree_leaves(KINDS[kind].split(base)[0]))
    valid = leaves[n_rows]
    got, rep = recover_state(snap_dir, w, base, kind=kind)
    sync()
    check(meta["rtype"] == "delta" and rep.generation == 1 and rep.replayed_records == 1
          and same_leaves(got, logged[0]), f"the {kind} recovery != the logged ring")
    # The restarted process resumes logging over what it recovered; its
    # next append is killed mid-frame: the torn tail.
    w.attach(got)
    del got
    crashed = None
    try:
        with crashpoints.armed("wal.mid_append"):
            w.append_state(kind, base)
    except SimulatedCrash as crash:
        crashed = crash.name
    check(crashed == "wal.mid_append", f"the armed append died at {crashed}")
    w.close()
    t0 = time.perf_counter()
    w = Wal(wal_dir)
    torn_open_s = time.perf_counter() - t0
    check(w.torn_tails == 1 and w.last_seq == 1,
          f"reopening truncated {w.torn_tails} tails, last seq {w.last_seq}")
    got, rep_torn = recover_state(snap_dir, w, base, kind=kind)
    check(same_leaves(got, logged[0]), f"the {kind} recovery after the torn tail differs")
    del got

    # A corrupt newest generation: fall back one, replay the longer suffix.
    t0 = time.perf_counter()
    snapshot.save_state(snap_dir, kind, logged[0], wal_seq=w.last_seq)
    snap2_s = time.perf_counter() - t0
    snapshot.corrupt_generation(snap_dir, 2)
    got, rep_fb = recover_state(snap_dir, w, base, kind=kind)
    check(rep_fb.generation == 1 and rep_fb.snapshot_fallbacks == 1
          and rep_fb.replayed_records == 1 and same_leaves(got, logged[0]),
          f"the {kind} recovery past a corrupt generation differs ({rep_fb})")
    w.close()
    del got, logged

    # Walls: fresh logs, attached before the timing (the caller's seed),
    # the logged and the unlogged ring alternating.
    logs = [Wal(os.path.join(root, kind, f"timed-{i}"), fsync="on_round")
            for i in range(samples)]
    for log in logs:
        log.attach(base)
    pending = iter(logs)
    runs = alternate_rings(lambda on: ring(next(pending) if on else None), samples, sync)
    timed_append = [sum(log.seconds.values()) * 1e3 for log in logs]
    for log in logs:
        log.close()
        shutil.rmtree(log.path)
    full = state_nbytes(out[0])
    gen1 = os.path.getsize(os.path.join(snap_dir, "gen-00000001.npz"))
    return {
        "kind": kind, "rounds": rounds, "launches_in_logged_ring": launches,
        "record_bytes": record_bytes, "full_state_bytes": full,
        "record_over_full_state": record_bytes / full,
        "changed_lanes": int(valid.sum()), "lanes": int(valid.size),
        "append_wall_s": append, "fsyncs_in_ring": 1,
        "snapshot_bytes": gen1, "snapshot_write_s": snap_s, "snapshot2_write_s": snap2_s,
        "logged_ring_ms_first": logged_ms,
        "recovery": {"open_scan_s": open_s, "generation_load_s": rep.load_seconds,
                     "replay_s": rep.replay_seconds, "total_s": open_s + rep.seconds},
        "recovery_after_torn_tail": {"open_scan_s": torn_open_s, "total_s": rep_torn.seconds},
        "recovery_after_fallback": {"generation_load_s": rep_fb.load_seconds,
                                    "replay_s": rep_fb.replay_seconds},
        "ring_ms_logged": statistics.median(runs[True]),
        "ring_ms_unlogged": statistics.median(runs[False]),
        "logged_over_unlogged": statistics.median(runs[True]) / statistics.median(runs[False]),
        "ring_ms_logged_runs": runs[True], "ring_ms_unlogged_runs": runs[False],
        "append_ms_in_timed_runs": timed_append,
    }


def phase_durability(device, seed: int, r: int = 8, k: int = 1_000_000, s: int = 2, a: int = 4,
                     d: int = 4, chunk: int = 1 << 17) -> dict:
    """The durability core on the card: the crashpoint diagonal (each of
    the 15 crashpoints once, the decomposition kinds cycled, small
    states on the card), then ``checkpoint.save`` / ``load`` of a
    ``BatchedMap`` at config 4's widths (R = 8, bench.py's state rule),
    equal to what was saved, leaf for leaf and interner for interner."""
    import torch

    from crdt_tpu_torch import checkpoint
    from crdt_tpu_torch.models import BatchedMap
    from crdt_tpu_torch.utils import Interner
    from crdt_tpu_torch.utils.metrics import state_nbytes

    def runs(root):
        diagonal = crashpoint_diagonal(device, seed, root)
        model = BatchedMap(r, k, a, s, d, keys=Interner(range(k)),
                           actors=Interner(f"a{i}" for i in range(a)), values=Interner(range(5)),
                           device=device)
        fill_config4(model, seed, chunk)
        path = os.path.join(root, "config4.npz")
        t0 = time.perf_counter()
        checkpoint.save(path, model)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.load(path, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        load_s = time.perf_counter() - t0
        check(isinstance(back, BatchedMap) and same_leaves(back.state, model.state)
              and all(getattr(back, n).items() == getattr(model, n).items()
                      for n in ("keys", "actors", "values")),
              "the loaded config-4 checkpoint differs from the saved model")
        return {"crashpoint_diagonal": diagonal, "checkpoint_map": {
            "R": r, "K": k, "S": s, "A": a, "D": d, "file_bytes": os.path.getsize(path),
            "state_bytes": state_nbytes(model.state), "save_s": save_s, "load_s": load_s}}

    t_phase = time.perf_counter()
    out = {"phase": "durability", **with_scratch_dir(runs)}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out



# ---- serving (ROADMAP item 10) ---------------------------------------------------

def serve_config() -> dict:
    """``BENCH_CONFIGS.json`` "serve", as committed (this checkout's copy)."""
    with open(os.path.join(HERE, "BENCH_CONFIGS.json")) as f:
        return json.load(f)["serve"]


def serve_member(kind: str, caps: dict, rng):
    """A random op member descriptor: an element mask (dense, p = 0.4) or
    an id list of 1..rm_width distinct ids below 16 (sparse, -1 padded)."""
    import numpy as np

    if kind == "orswot":
        return rng.random(caps["n_elems"]) < 0.4
    k = int(rng.integers(1, caps["rm_width"] + 1))
    out = np.full(caps["rm_width"], -1, np.int32)
    out[:k] = rng.choice(16, k, replace=False)
    return out


def serve_streams(kind: str, caps: dict, n_tenants: int, n_ops: int, seed: int,
                  p_ahead: float = 0.2) -> list:
    """Per-tenant op streams ``(kind, actor, ctr, clock, member)``: per-actor
    counters rise, removes are covered (the tenant's own counters) or one
    ahead on the acting lane (they park)."""
    import numpy as np

    from crdt_tpu_torch.ops.superblock import ADD, RM

    rng = np.random.default_rng(seed)
    a = caps["n_actors"]
    streams = [[] for _ in range(n_tenants)]
    nxt = np.zeros((n_tenants, a), np.int64)
    for _ in range(n_ops):
        t, act = int(rng.integers(n_tenants)), int(rng.integers(a))
        member = serve_member(kind, caps, rng)
        if rng.random() < 0.75 or not streams[t]:
            nxt[t, act] += 1
            streams[t].append((ADD, act, int(nxt[t, act]), None, member))
        else:
            clock = nxt[t].astype(np.uint32)
            if rng.random() < p_ahead:
                clock[act] += 1
            streams[t].append((RM, 0, 0, clock, member))
    return streams


def serve_submit(q, streams) -> None:
    """Queue op streams (a list by tenant, or a dict tenant → ops)."""
    from crdt_tpu_torch.ops.superblock import ADD

    items = streams.items() if isinstance(streams, dict) else enumerate(streams)
    for t, ops in items:
        for k, actor, ctr, clock, member in ops:
            if k == ADD:
                q.add(t, actor, ctr, member)
            else:
                q.rm(t, clock, member)


def pure_tenant(ops):
    """One tenant's op stream through the sequential oracle
    ``crdt_tpu_torch.pure.Orswot`` (members: mask positions or listed ids)."""
    import numpy as np

    from crdt_tpu_torch.dot import Dot
    from crdt_tpu_torch.ops.superblock import ADD
    from crdt_tpu_torch.pure.orswot import Add, Orswot, Rm
    from crdt_tpu_torch.vclock import VClock

    out = Orswot()
    for k, actor, ctr, clock, member in ops:
        m = np.asarray(member)
        members = tuple(int(e) for e in (np.nonzero(m)[0] if m.dtype == bool else m[m >= 0]))
        if k == ADD:
            out.apply(Add(Dot(int(actor), int(ctr)), members))
        else:
            out.apply(Rm(VClock({a: int(c) for a, c in enumerate(clock) if c > 0}), members))
    return out


def served_as_pure(sb, t: int, universe: int = 16):
    """A served tenant's row as the oracle form (the sparse kind through
    ``to_dense`` over ``universe`` element ids). Parked slots with equal
    clocks union their members, as the oracle's ``deferred`` dict does:
    the sparse kind keeps two such slots apart when their union overflows
    ``rm_width``."""
    import numpy as np

    from crdt_tpu_torch.convert import leaf_from_numpy, leaf_to_numpy
    from crdt_tpu_torch.ops import sparse_orswot as sp
    from crdt_tpu_torch.pure.orswot import Orswot
    from crdt_tpu_torch.vclock import VClock

    row = type(sb.state)(*(leaf_from_numpy(x, "cpu") for x in sb.row(t)))
    if sb.kind == "sparse_orswot":
        row = sp.to_dense(row, universe)
    top, ctr, dcl, dmask, dvalid = (leaf_to_numpy(x) for x in row)

    def clock(lanes):
        return VClock({a: int(c) for a, c in enumerate(lanes) if c > 0})

    out = Orswot()
    out.clock = clock(top)
    for e in np.nonzero(ctr.any(axis=-1))[0]:
        out.entries[int(e)] = clock(ctr[e])
    for d in np.nonzero(dvalid)[0]:
        out.deferred.setdefault(clock(dcl[d]), set()).update(
            int(e) for e in np.nonzero(dmask[d])[0])
    return out


def serve_oracle_gate(sb, ev, tenants, histories, device, what: str) -> int:
    """Each tenant (restored first when cold) == its sequential oracle over
    the unbatched ops on ``device`` at the superblock's caps, and == the pure
    oracle's state. Returns the tenants held."""
    import numpy as np

    from crdt_tpu_torch.ops import superblock as sb_ops

    tk = sb.tk
    for t in tenants:
        if ev is not None and not sb.is_resident(t):
            ev.restore(t)
        want = sb_ops.to_host(sb_ops.sequential_oracle(
            tk, tk.empty(**sb.caps, device=device), histories[t]))
        check(all(np.array_equal(x, y) for x, y in zip(sb.row(t), want)),
              f"{what}: tenant {t} != its sequential oracle")
        check(served_as_pure(sb, t) == pure_tenant(histories[t]),
              f"{what}: tenant {t} != the pure Orswot oracle")
    return len(tenants)


def serve_drain(q, walls=None):
    """Flush until the queue is empty, appending each dispatch's issue →
    finish wall (s) to ``walls``; returns (ops applied, dispatches,
    restored)."""
    ops = dispatches = restored = 0
    while q.n_pending:
        rep, _ = q.flush()
        if rep.ops_applied == 0 and rep.restored == 0:
            break
        ops, restored = ops + rep.ops_applied, restored + rep.restored
        if rep.dispatches:
            dispatches += rep.dispatches
            if walls is not None:
                walls.append(q.sb.last_dispatch_s)
    return ops, dispatches, restored


def serve_telemetry_cycle(q, submit, tenants: int, committed: bool) -> dict:
    """One serving cycle drained with the telemetry sidecar (ROADMAP 15.1):
    every flush's Telemetry combined, its gates against the queue's own
    counts (the served population, coalesced ops, flushes and ops in the
    batch histogram, dispatches in ``hist_dispatch_us``, the slabs' bytes)
    and the dispatch walls (the sidecar's own replayed graph; its first
    dispatch captures it)."""
    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.obs import hist
    from crdt_tpu_torch.ops import superblock as sb_ops

    submit()
    sb = q.sb
    tel, walls = None, []
    ops = dispatches = coalesced = flushes = 0
    while q.n_pending:
        rep, t = q.flush(telemetry=True)
        if rep.ops_applied == 0 and rep.restored == 0:
            break
        tel = t if tel is None else tele.combine(tel, t)
        ops, dispatches = ops + rep.ops_applied, dispatches + rep.dispatches
        coalesced, flushes = coalesced + rep.coalesced, flushes + 1
        walls.append(sb.last_dispatch_s)
    d = tele.to_dict(tel)
    slab = sb_ops.empty_slab(sb.tk, sb.caps, q.lanes, q.depth, device=sb.device)
    slab_bytes = tele.shipped_bytes(slab)
    n_evicted = int((sb.was_evicted & (sb.lane_of < 0)).sum())
    gates = {
        "live_tenants": d["live_tenants"] == tenants and (tenants >= 1_000_000 or not committed),
        "evicted_tenants": d["evicted_tenants"] == n_evicted,
        "ingest_coalesced_ops": d["ingest_coalesced_ops"] == coalesced,
        "hist_ingest_batch": (sum(d["hist_ingest_batch"]["counts"]) == flushes
                              and d["hist_ingest_batch"]["total"] == ops),
        "hist_dispatch_us": sum(d["hist_dispatch_us"]["counts"]) == dispatches,
        "bytes_exchanged": f32_close(d["bytes_exchanged"], dispatches * slab_bytes,
                                     dispatches * sb.p),
        "slots_changed": d["slots_changed"] > 0,
    }
    check(all(gates.values()), f"serve telemetry gates failed: {gates}")
    keep = ("slots_changed", "bytes_exchanged", "bytes_useful", "deferred_depth",
            "widen_pressure", "live_tenants", "evicted_tenants", "ingest_coalesced_ops")
    return {"gates": gates, "ops": ops, "dispatches": dispatches, "flushes": flushes,
            "telemetry": {k: d[k] for k in keep},
            "hist_dispatch_us_p50_p99": [hist.summary(d["hist_dispatch_us"])[k]
                                         for k in ("p50", "p99")],
            "dispatch_wall_with_telemetry": serve_percentiles(walls)}


def phase_serve_scenarios(device, seed: int) -> dict:
    """Small oracle probes of the serving tier on the card, both kinds."""
    import numpy as np
    import torch

    from crdt_tpu_torch import serve
    from crdt_tpu_torch.elastic import ElasticPolicy
    from crdt_tpu_torch.ops import superblock as sb_ops
    from crdt_tpu_torch.parallel import VirtualMesh

    kinds = {"orswot": dict(n_elems=8, n_actors=2, deferred_cap=2),
             "sparse_orswot": dict(dot_cap=12, n_actors=2, deferred_cap=2, rm_width=4)}
    out = {"phase": "serve_scenarios"}
    t_phase = time.perf_counter()

    def runs(root):
        res = {}
        for kind, caps in kinds.items():
            r = {}
            # Mixed streams through the coalesced ingest on 4 virtual ranks
            # (covered and ahead removes, NOOP padding), == the oracles and
            # == the same ingest on the CPU.
            streams = serve_streams(kind, caps, 16, 160, seed)
            sbs = {}
            for dev in (device, torch.device("cpu")):
                sb = serve.Superblock(16, VirtualMesh(4, dev), kind=kind, caps=dict(caps))
                q = serve.IngestQueue(sb, lanes=8, depth=3)
                serve_submit(q, streams)
                r["ops"], r["dispatches"], _ = serve_drain(q)
                sbs[dev.type] = sb
            r["widen_events"] = sbs[device.type].widen_events
            r["held"] = serve_oracle_gate(sbs[device.type], None, range(16), streams, device,
                                          f"{kind} coalesced")
            check(all(all(np.array_equal(x, y) for x, y in zip(sbs[device.type].row(t),
                                                                 sbs["cpu"].row(t)))
                      for t in range(16)), f"{kind}: card != CPU")
            # Overflow → widen → retry == a wide-born superblock (dense: a
            # double widen in one apply; sparse: dot capacity and slots).
            tight = (dict(caps, deferred_cap=1) if kind == "orswot"
                     else dict(caps, dot_cap=4, deferred_cap=1))
            ahead = serve_streams(kind, tight, 8, 70, seed + 1, p_ahead=0.5)
            if kind == "orswot":
                m = lambda *on: np.isin(np.arange(8), on)  # noqa: E731
                ahead[0] = [(sb_ops.RM, 0, 0, np.asarray([1, 0], np.uint32), m(1)),
                            (sb_ops.RM, 0, 0, np.asarray([0, 1], np.uint32), m(2)),
                            (sb_ops.RM, 0, 0, np.asarray([2, 0], np.uint32), m(3))]
            sb = serve.Superblock(8, VirtualMesh(2, device), kind=kind, caps=dict(tight))
            q = serve.IngestQueue(sb, lanes=4, depth=3)
            serve_submit(q, ahead)
            serve_drain(q)
            wide = serve.Superblock(8, VirtualMesh(2, device), kind=kind, caps=dict(sb.caps))
            qw = serve.IngestQueue(wide, lanes=4, depth=3)
            serve_submit(qw, ahead)
            serve_drain(qw)
            check(sb.widen_events >= (2 if kind == "orswot" else 1), f"{kind}: no widen")
            check(wide.widen_events == 0 and same_leaves(sb.state, wide.state),
                  f"{kind}: widened != wide-born")
            serve_oracle_gate(sb, None, range(8), ahead, device, f"{kind} widened")
            r["widened_caps"] = dict(sb.caps)
            # An exhausted widen budget rolls the overflowed tenants back
            # and requeues their ops.
            sb = serve.Superblock(8, VirtualMesh(2, device), kind=kind, caps=dict(tight),
                                  policy=ElasticPolicy(max_migrations=0))
            q = serve.IngestQueue(sb, lanes=4, depth=3)
            serve_submit(q, ahead)
            before = q.n_pending
            try:
                serve_drain(q)
                check(False, f"{kind}: no CapacityOverflow")
            except serve.CapacityOverflow as exc:
                lost = exc.tenants
            # The overflowed tenants' ops are back in the queue; the rows
            # rolled back exactly (the drain below lands on the oracle).
            check(lost and all(q.pending.get(t) for t in lost), f"{kind}: ops not requeued")
            check(0 < q.n_pending <= before, f"{kind}: requeue lost ops")
            sb.widen_capacity(**{k: v for k, v in r["widened_caps"].items() if k != "n_actors"})
            serve_drain(q)
            serve_oracle_gate(sb, None, range(8), ahead, device, f"{kind} after the rollback")
            r["rolled_back"] = list(lost)
            # Lane paging: 24 tenants on 8 lanes, evict / restore on touch.
            sb = serve.Superblock(24, VirtualMesh(2, device), kind=kind, caps=dict(caps),
                                  n_lanes=8)
            ev = serve.Evictor(sb, os.path.join(root, kind, "tier"), pressure_batch=3)
            q = serve.IngestQueue(sb, lanes=4, depth=2, evictor=ev)
            paged = serve_streams(kind, caps, 24, 120, seed + 2)
            restored = 0
            for t in range(24):
                serve_submit(q, {t: paged[t]})
                if t % 3 == 2:
                    restored += serve_drain(q)[2]
            for t in range(6):
                serve_submit(q, {t: paged[t][-1:]})
                paged[t] = paged[t] + paged[t][-1:]  # replayed: dot seen / covered rm
            restored += serve_drain(q)[2]
            check(restored > 0 and sb.was_evicted.any(), f"{kind}: no paging")
            serve_oracle_gate(sb, ev, range(24), paged, device, f"{kind} paged")
            r["paged_restores"] = restored
            # Evict then touch restores bit-identically.
            t0 = int(sb.resident_tenants()[0])
            want = sb.row(t0)
            ev.evict([t0])
            check(not sb.is_resident(t0) and ev.restore(t0), f"{kind}: evict/restore")
            check(all(np.array_equal(x, y) for x, y in zip(sb.row(t0), want)),
                  f"{kind}: restored != evicted row")
            res[kind] = r
        # Backpressure raises and keeps every accepted op.
        sb = serve.Superblock(4, VirtualMesh(1, device), caps=dict(kinds["orswot"]))
        q = serve.IngestQueue(sb, lanes=2, depth=2, max_pending=3)
        for i in range(3):
            q.add(0, 0, i + 1, np.arange(8) == i)
        try:
            q.add(1, 0, 1, np.arange(8) == 0)
            check(False, "no IngestBackpressure")
        except serve.IngestBackpressure:
            pass
        check(q.n_pending == 3 and serve_drain(q)[0] == 3, "backpressure lost ops")
        # One apply_async (the pinned copy and the dispatch) under sync
        # debug "error": the dispatch never waits for the card.
        if device.type == "cuda":
            sb = serve.Superblock(1024, VirtualMesh(8, device), kind="sparse_orswot",
                                  caps=dict(kinds["sparse_orswot"]))
            q = serve.IngestQueue(sb, lanes=64, depth=3)
            serve_submit(q, serve_streams("sparse_orswot", kinds["sparse_orswot"], 1024, 400,
                                          seed + 3))
            serve_drain(q)  # first slab: allocations and caches warm
            serve_submit(q, serve_streams("sparse_orswot", kinds["sparse_orswot"], 1024, 400,
                                          seed + 4))
            built = q._assemble()
            torch.cuda.synchronize(device)
            torch.cuda.set_sync_debug_mode("error")
            try:
                pend = q._issue(built)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            q._finish(built, pend, None)
            res["apply_async_under_sync_debug_error"] = True
        return res

    out.update(with_scratch_dir(runs))
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def serve_percentiles(walls) -> dict:
    import numpy as np

    w = np.asarray(walls) * 1e6
    return {"n": len(walls), "p50_us": float(np.percentile(w, 50)),
            "p99_us": float(np.percentile(w, 99)), "max_us": float(w.max())}


# One Prometheus text-format TYPE line or sample line.
PROM_LINE = re.compile(
    r'^(# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})? '
    r'(-?[0-9.]+(e[+-]?[0-9]+)?|[+-]?Inf|NaN))$')


def exporter_gates() -> dict:
    """``prometheus_text()`` of the live registry: every line valid
    exposition; ``health()``: every field there."""
    from crdt_tpu_torch import exporter

    lines = exporter.prometheus_text().splitlines()
    bad = [ln for ln in lines if not PROM_LINE.match(ln)]
    check(lines and not bad, f"{len(bad)} invalid exposition lines, e.g. {bad[:2]}")
    h = exporter.health()
    want = {"ts", "live_ranks", "generation", "frontier_lag", "residue",
            "last_durable_watermark", "faults_gave_up", "snapshot_fallbacks", "serving",
            "federation", "flight"}
    check(set(h) == want and h["serving"]["freshness_p99_us"] > 0,
          f"health() fields {sorted(h)}")
    return {"exposition_lines": len(lines), "health": {k: v for k, v in h.items() if k != "ts"}}


def trace_summary(tr, rep, walls, untraced_walls) -> dict:
    """A traced window's journeys: freshness and each stage's p99 (the
    replay's exact quantiles, µs of the host clock), the tracer's
    histogram quantiles, and the dispatch walls against the untraced
    window's."""
    from crdt_tpu_torch.obs import hist as obs_hist

    rp = rep["slo"]
    return {
        "minted": tr.minted, "completed": tr.completed, "requeued": tr.requeued,
        "open_at_end": tr.n_open, "replayed": rp["traces_completed"],
        "freshness_us": rp["freshness"],
        "stage_p99_us": {k: v["p99"] for k, v in rp["stage_waterfall"].items()},
        "freshness_hist_us": {k: v for k, v in obs_hist.summary(tr.freshness_dict()).items()
                              if k in ("p50", "p95", "p99", "count")},
        "dispatch_wall": serve_percentiles(walls) if walls else None,
        "untraced_dispatch_wall": serve_percentiles(untraced_walls) if untraced_walls else None,
    }


def flight_summary(o, rep) -> dict:
    return {"events": len(o.rec), "dropped": o.rec.dropped,
            "by_type": by_type(o.rec.events()), "dropped_by_type": dict(o.rec.dropped_by_type),
            "folded_counters": len(rep["folded_counters"]),
            "audit": [f["check"] for f in rep["audit"]], "ok": rep["ok"]}


def phase_serve(device, seed: int, cfg=None) -> dict:
    """``BENCH_CONFIGS.json`` "serve" at its committed shape, driven as
    ``bench.py``'s ``bench_serve`` drives it: 1,048,576 tenants on 262,144
    lanes over 8 virtual ranks, slabs of 4,096 lanes × 4, 20 cycles of
    16,000 ops (85% to a shifting 65,536-tenant hot set, 85% adds with
    p = 0.4 masks, covered removes), a 512-tenant evict cohort and a
    64-tenant retouch mid-window; 48 sampled tenants held against the
    sequential and pure oracles."""
    import numpy as np
    import torch

    from crdt_tpu_torch import serve
    from crdt_tpu_torch.convert import opslab_from_numpy
    from crdt_tpu_torch.ops import superblock as sb_ops
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_serve_apply

    committed = cfg is None
    cfg = dict(serve_config() if committed else cfg)
    tenants, lanes = cfg["tenants"], cfg["lanes"]
    caps = dict(n_elems=cfg["elems"], n_actors=cfg["actors"], deferred_cap=cfg["deferred_cap"])
    e, a = caps["n_elems"], caps["n_actors"]
    hot_set, hot_shift = cfg["hot_set"], cfg["hot_shift"]
    t_phase = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    def runs(root):
        sb = serve.Superblock(tenants, VirtualMesh(cfg["mesh"][0], device), kind="orswot",
                              caps=caps, n_lanes=lanes)
        ev = serve.Evictor(sb, os.path.join(root, "tier"), pressure_batch=256)
        q = serve.IngestQueue(sb, lanes=cfg["slab_lanes"], depth=cfg["slab_depth"],
                              max_pending=1 << 20, evictor=ev)
        rng = np.random.default_rng(151)
        next_ctr = np.zeros(tenants, np.uint32)
        history = {}

        def submit_cycle(cycle, n_ops):
            off = (cycle * hot_shift) % max(tenants - hot_set, 1)
            hot = rng.integers(off, off + hot_set, n_ops)
            uni = rng.integers(0, tenants, n_ops)
            ts = np.where(rng.random(n_ops) < 0.85, hot, uni)
            is_add = rng.random(n_ops) < 0.85
            masks = rng.random((n_ops, e)) < 0.4
            for i in range(n_ops):
                t = int(ts[i])
                act, m = t % a, masks[i]
                if is_add[i] or next_ctr[t] == 0:
                    c = int(next_ctr[t]) + 1
                    next_ctr[t] = c
                    q.add(t, act, c, m)
                    history.setdefault(t, []).append((sb_ops.ADD, act, c, None, m))
                else:
                    # Covered remove at the tenant's applied top: kills
                    # dots, parks nothing.
                    clock = np.zeros(a, np.uint32)
                    clock[act] = next_ctr[t]
                    q.rm(t, clock, m)
                    history.setdefault(t, []).append((sb_ops.RM, 0, 0, clock, m))

        def touch_one(t):
            act = t % a
            c = int(next_ctr[t]) + 1
            next_ctr[t] = c
            m = rng.random(e) < 0.4
            q.add(t, act, c, m)
            history.setdefault(t, []).append((sb_ops.ADD, act, c, None, m))

        submit_cycle(0, 256)  # warmup: first slab's allocations, outside the window
        serve_drain(q)
        walls = []
        total_ops = dispatches = evicted = restored_in_window = 0
        retouch = []
        submit_s = 0.0
        t0 = time.perf_counter()
        for cycle in range(1, cfg["cycles"] + 1):
            ts = time.perf_counter()
            submit_cycle(cycle, cfg["ops_per_cycle"])
            submit_s += time.perf_counter() - ts
            n, d, _ = serve_drain(q, walls)
            total_ops, dispatches = total_ops + n, dispatches + d
            if cycle == cfg["cycles"] // 2:
                cold = ev.select_cold(cfg["evict_cohort"])
                te = time.perf_counter()
                evicted = ev.evict(cold)
                evict_s = time.perf_counter() - te
                retouch = cold[:cfg["retouch"]]
                for t in retouch:
                    touch_one(t)
                n, d, restored_in_window = serve_drain(q, walls)
                total_ops, dispatches = total_ops + n, dispatches + d
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        check(evicted >= 1 and restored_in_window >= 1, "no evict → restore cycle in the window")
        check(tenants >= 1_000_000 or not committed, "the committed shape serves 1M+ tenants")
        # One more cycle, outside the window: its first slab dispatched
        # eagerly on a copy of the lanes (the launches a graph replay
        # saves), then the cycle drained as in the window, profiled —
        # launches, device time and the device's busy share while
        # dispatching.
        submit_cycle(cfg["cycles"] + 1, cfg["ops_per_cycle"])
        built = q._assemble()
        slab = opslab_from_numpy(dict(kind=built.kind, actor=built.actor, ctr=built.ctr,
                                      clock=built.clock, member=built.member), device)
        idx = torch.as_tensor(built.idx, device=device)
        q._unwind(built, RuntimeError("measured, not applied"))  # the ops go back in front
        lanes_copy = type(sb.state)(*(x.clone() for x in sb.state))

        def eager():
            mesh_serve_apply(lanes_copy, slab, idx, sb.mesh, donate=True)

        eager_prof = profile_busy(eager, device)
        eager_ms = [time_ms(eager, device) for _ in range(5)]
        del lanes_copy
        d, w = [], []
        prof = profile_busy(lambda: d.append(serve_drain(q, w)), device)
        if prof is None:  # off a card: drain unprofiled
            d.append(serve_drain(q, w))
        # Two cycles with the sidecar: the first captures its graph, the
        # second's dispatch walls are the steady state.
        first_tel = serve_telemetry_cycle(
            q, lambda: submit_cycle(cfg["cycles"] + 2, cfg["ops_per_cycle"]), tenants, committed)
        telemetry = serve_telemetry_cycle(
            q, lambda: submit_cycle(cfg["cycles"] + 3, cfg["ops_per_cycle"]), tenants, committed)
        telemetry["first_cycle_dispatch_wall"] = first_tel["dispatch_wall_with_telemetry"]
        # Oracle bit-identity on a sample, re-touched evictees first.
        touched = np.asarray(sorted(history))
        sample = list(retouch[: cfg["oracle_sample"] // 3])
        rest = rng.choice(touched, min(cfg["oracle_sample"] - len(sample), len(touched)),
                          replace=False)
        sample += [int(x) for x in rest if int(x) not in set(sample)]
        held = serve_oracle_gate(sb, ev, sample, history, device, "serve")
        traced = serve_traced_window(sb, ev, q, submit_cycle, touch_one, cfg, device, root,
                                     first_cycle=cfg["cycles"] + 4, untraced_walls=walls,
                                     untraced_ops_per_s=total_ops / window_s)
        out = {
            "config": "serve", "tenants": tenants, "lanes": lanes,
            "mesh_virtual_ranks": cfg["mesh"][0], "slab": [cfg["slab_lanes"], cfg["slab_depth"]],
            "cycles": cfg["cycles"], "ops_per_cycle": cfg["ops_per_cycle"],
            "ops_applied": total_ops, "window_s": window_s,
            "ops_per_s": total_ops / window_s, "submit_s_in_window": submit_s,
            "dispatches": dispatches, "dispatch_wall": serve_percentiles(walls),
            "dispatch_wall_sum_s": float(sum(walls)),
            "ops_per_dispatch": total_ops / max(dispatches, 1),
            "evicted": evicted, "evict_s": evict_s, "restored_in_window": restored_in_window,
            "widen_events": sb.widen_events, "resident_lanes": sb.n_resident,
            "touched_tenants": len(history),
            "superblock_bytes": sb.nbytes(), "row_bytes": sb.row_nbytes(),
            "all_resident_equiv_bytes": sb.row_nbytes() * tenants,
            "oracle_held": held, "bit_identical": True, "telemetry": telemetry,
            "traced": traced, "reduced": "none",
        }
        out["eager_dispatch_ms"] = eager_ms
        if prof is not None:
            n = max(d[0][1], 1)
            out["profiled_cycle"] = {
                "dispatches": d[0][1], "wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                "busy_share": prof["busy_share"],
                "launch_kernel_calls_per_dispatch": prof["launch_kernel_calls"] / n,
                "device_ms_per_dispatch": prof["device_ms"] / n,
                "dispatch_wall": serve_percentiles(w), "top": prof["top"][:3]}
            out["eager_dispatch"] = {"launch_kernel_calls": eager_prof["launch_kernel_calls"],
                                     "device_ms": eager_prof["device_ms"],
                                     "wall_ms": eager_prof["wall_ms"]}
            out["window_busy_share_est"] = (prof["device_ms"] / n * dispatches / 1e3 / window_s)
        return out

    out = {"phase": "serve", **with_scratch_dir(runs)}
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# The zipf leg's depth in the full run: 4 of its committed 24 cycles (the
# per-cycle shape, tenants, lanes, slabs, skew and rebalance unchanged; one
# cycle before and during the hot shard, two after). At 24 cycles the leg
# took 739-824 s on an H100 machine whose /tmp is a 9p mount — 17,344
# per-tenant snapshot persists a run as the working set pages through the
# lane pool — more than the script's time limit allows beside the other
# phases; at 9 it took 49-84 s, and the whole script up to 1,149 s of its
# 1,200 on a slow host; at 7, with the multihost phase's serving and
# sidecar legs, 1,139 s on another; at 6, with the multihost phase's
# faulted legs, 1,131 s on a third.
ZIPF_CYCLES = 4


def serve_traced_window(sb, ev, q, submit_cycle, touch_one, cfg, device, root, first_cycle: int,
                        untraced_walls, untraced_ops_per_s: float) -> dict:
    """The serve window again with the trace plane on, as ``bench.py``'s
    serve leg runs it: every tenant the sampling picks (``trace_sample``)
    subscribed to a ``FanoutPlane`` whose push → ack closes each cycle's
    journeys (freshness is submit → client ack), a ``FlightRecorder``
    (32,768) and a ``Tracer`` installed after a warm-up push, the window's
    cycles, evict cohort and re-touch as the untraced window's. The dump,
    with the window's trace-histogram Telemetry recorded at its end,
    passes ``obs.report`` with the trace replay run; then the exporter's
    exposition and health."""
    import numpy as np
    import torch

    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.fanout import FanoutPlane
    from crdt_tpu_torch.obs import trace as obs_trace

    sample = cfg["trace_sample"]
    traced = np.nonzero(obs_trace.sampled_mask(sb.n_tenants, sample))[0]
    fan = FanoutPlane(sb, evictor=ev, window_cap=4, dispatch_lanes=256,
                      capacity=max(len(traced), 1))
    sub_ids = fan.subscribe(traced)
    touch_one(int(traced[0]))  # warm-up: the push dispatch's first call
    serve_drain(q)
    fan.push(tenants=traced[:1])
    fan.ack(sub_ids)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    tr = obs_trace.Tracer(sample=sample)
    walls, total_ops, drain_s, push_s = [], 0, 0.0, 0.0
    with Observed(os.path.join(root, "flight-serve"), capacity=32768, tracer=tr) as o:
        sync()
        t0 = time.perf_counter()
        for cycle in range(first_cycle, first_cycle + cfg["cycles"]):
            submit_cycle(cycle, cfg["ops_per_cycle"])
            td = time.perf_counter()
            n, _, _ = serve_drain(q, walls)
            total_ops += n
            if cycle == first_cycle + cfg["cycles"] // 2:
                cold = ev.select_cold(cfg["evict_cohort"])
                ev.evict(cold)
                for t in cold[:cfg["retouch"]]:
                    touch_one(t)
                total_ops += serve_drain(q, walls)[0]
            tp = time.perf_counter()
            drain_s += tp - td
            open_t = list(tr.open_traces())
            if open_t:
                fan.push(tenants=open_t)
                fan.ack(sub_ids)
            push_s += time.perf_counter() - tp
        sync()
        window_s = time.perf_counter() - t0
        skew = obs_trace.skew_report(evictor=ev, queue=q, tracer=tr, k=8)
        tele.record("serve", tr.annotate(tele.zeros(device)))
        path = o.rec.dump(os.path.join(root, "serve-flight.jsonl"), reason="serve")
        rep = audited(path, snapshot=o.since(), slo=True)
        exported = exporter_gates()
    check(tr.completed >= 1, "no sampled journey completed in the traced serve window")
    return {
        "trace_sample": sample, "traced_tenants": len(traced), "cycles": cfg["cycles"],
        "ops_applied": total_ops, "window_s": window_s, "ops_per_s": total_ops / window_s,
        "drain_s": drain_s, "push_ack_s": push_s,
        "untraced_ops_per_s": untraced_ops_per_s,
        **trace_summary(tr, rep, walls, untraced_walls),
        "skew_top": skew["tenants"][:3], "flight": flight_summary(o, rep), **exported,
    }


def phase_serve_zipf(device, seed: int, cfg=None, cycles: int = ZIPF_CYCLES) -> dict:
    """``BENCH_CONFIGS.json`` "serve"'s zipf leg at its committed shape, as
    ``bench.py``'s ``bench_serve_zipf`` drives it: 65,536 tenants on 16,384
    lanes, slabs of 1,024 × 4, cycles of 8,000 zipf(α = 1.0) ops (``cycles``
    of the committed 24: :data:`ZIPF_CYCLES`) with a ×10 hot shard on 1 of
    8 hosts for the middle third, answered by
    ``rebalance`` of the top 2,048 tenants. The serial flush loop and the
    pipelined ``ServeLoop`` (both WAL-logged) run the same pregenerated
    schedule and must land on the same rows; ``recover_serve`` into a fresh
    superblock must land there too."""
    import numpy as np
    import torch

    from crdt_tpu_torch import serve
    from crdt_tpu_torch.ops import superblock as sb_ops
    from crdt_tpu_torch.parallel import VirtualMesh

    cfg = dict(serve_config() if cfg is None else cfg)
    tenants, lanes = cfg["zipf_tenants"], cfg["zipf_lanes"]
    committed_cycles, per_cycle = cfg["zipf_cycles"], cfg["zipf_ops_per_cycle"]
    cycles = min(cycles, committed_cycles)
    caps = dict(n_elems=cfg["elems"], n_actors=cfg["actors"], deferred_cap=cfg["deferred_cap"])
    e, a = caps["n_elems"], caps["n_actors"]
    p = cfg["mesh"][0]
    rng = np.random.default_rng(181)
    t_phase = time.perf_counter()

    shard = serve.TenantShardMap(cfg["zipf_hosts"])
    ranks = rng.permutation(tenants).astype(np.float64)
    base_w = 1.0 / (ranks + 1.0) ** cfg["zipf_alpha"]
    owner0 = np.asarray([shard.owner(t) for t in range(tenants)])
    hot_host = int(owner0[int(np.argmin(ranks))])
    skew_w = base_w * np.where(owner0 == hot_host, cfg["zipf_skew_factor"], 1.0)
    p_base, p_skew = base_w / base_w.sum(), skew_w / skew_w.sum()
    next_ctr = np.zeros(tenants, np.uint32)
    history = {}
    third = max(cycles // 3, 1)
    during = range(third + 1, 2 * third + 1)

    def gen_cycle(n_ops, pv):
        ts = rng.choice(tenants, size=n_ops, p=pv)
        adds = rng.random(n_ops) < 0.85
        masks = rng.random((n_ops, e)) < 0.4
        ops = []
        for i in range(n_ops):
            t = int(ts[i])
            act, m = t % a, masks[i]
            if adds[i] or next_ctr[t] == 0:
                c = int(next_ctr[t]) + 1
                next_ctr[t] = c
                op = (t, sb_ops.ADD, act, c, None, m)
            else:
                clock = np.zeros(a, np.uint32)
                clock[act] = next_ctr[t]
                op = (t, sb_ops.RM, 0, 0, clock, m)
            ops.append(op)
            history.setdefault(t, []).append(op[1:])
        return ops

    schedule = [gen_cycle(256, p_base)]  # cycle 0: warmup
    for cycle in range(1, cycles + 1):
        schedule.append(gen_cycle(per_cycle, p_skew if cycle in during else p_base))

    def submit(q, ops):
        for t, k, act, c, clock, m in ops:
            if k == sb_ops.ADD:
                q.add(t, act, c, m)
            else:
                q.rm(t, clock, m)

    def stack(root, name, wal=True, tier=None):
        sb = serve.Superblock(tenants, VirtualMesh(p, device), kind="orswot", caps=dict(caps),
                              n_lanes=lanes)
        ev = serve.Evictor(sb, os.path.join(root, f"tier_{tier or name}"))
        swal = serve.ServeWal(os.path.join(root, f"wal_{name}")) if wal else None
        q = serve.IngestQueue(sb, lanes=cfg["zipf_slab_lanes"], depth=cfg["zipf_slab_depth"],
                              max_pending=1 << 20, evictor=ev, wal=swal)
        return sb, ev, swal, q

    from crdt_tpu_torch.utils.metrics import metrics

    io_counters = ("serve.evict.persisted", "serve.evict.evictions", "serve.evict.restores",
                   "serve.evict.admissions", "serve.persist.background", "serve.wal.slabs",
                   "durability.fsyncs")

    def io_delta(before):
        now = metrics.snapshot()["counters"]
        return {k: now.get(k, 0) - before.get(k, 0) for k in io_counters}

    def same_rows(sb_x, sb_y, ev_x, ev_y, sample) -> int:
        """Tenants resident in both compared in one gather each; the sample
        restored and compared row by row. Returns the tenants compared."""
        both = np.nonzero((sb_x.lane_of >= 0) & (sb_y.lane_of >= 0))[0]
        gx = sb_ops.gather_rows(sb_x.state, sb_x.lane_of[both])
        gy = sb_ops.gather_rows(sb_y.state, sb_y.lane_of[both])
        check(same_leaves(gx, gy), "resident rows differ")
        for t in sample:
            for sb_, ev_ in ((sb_x, ev_x), (sb_y, ev_y)):
                if not sb_.is_resident(t):
                    ev_.restore(t)
            check(all(np.array_equal(x, y) for x, y in zip(sb_x.row(t), sb_y.row(t))),
                  f"tenant {t} differs")
        return len(both) + len(sample)

    def runs(root):
        # ---- serial: assemble → WAL → dispatch → wait, one round at a time
        sb_s, ev_s, wal_s, q_s = stack(root, "serial")
        submit(q_s, schedule[0])
        serve_drain(q_s)
        wal0_s = (wal_s.bytes_appended, wal_s.fsyncs)
        walls_s = []
        m0 = metrics.snapshot()["counters"]
        t0 = time.perf_counter()
        n_serial = 0
        for cycle in range(1, cycles + 1):
            submit(q_s, schedule[cycle])
            n_serial += serve_drain(q_s, walls_s)[0]
        serial_s = time.perf_counter() - t0
        serial_io = {**io_delta(m0), "wal_seconds": dict(wal_s.wal.seconds)}
        serial_wal = (wal_s.bytes_appended - wal0_s[0], wal_s.fsyncs - wal0_s[1])
        wal_s.close()

        # ---- pipelined: slab N+1 assembled and logged while N is queued
        sb, ev, swal, q = stack(root, "pipe")
        loop = serve.ServeLoop(q, persist_ahead=cfg["zipf_persist_ahead"])
        submit(q, schedule[0])
        loop.drain()
        wal0 = (swal.bytes_appended, swal.fsyncs)
        moves, ratio_onset, ratio_after = 0, 0.0, 0.0
        walls = {"before": [], "during": [], "after": []}
        total_ops = dispatches = 0
        m0 = metrics.snapshot()["counters"]
        t0 = time.perf_counter()
        for cycle in range(1, cycles + 1):
            phase = "before" if cycle <= third else "during" if cycle in during else "after"
            submit(q, schedule[cycle])
            while q.n_pending:
                before = q.n_pending
                rep, _ = loop.step()
                if rep is not None:
                    total_ops += rep.ops_applied
                    dispatches += rep.dispatches
                    if rep.dispatches:
                        walls[phase].append(sb.last_dispatch_s)
                if q.n_pending >= before and loop.inflight is None:
                    break
            if cycle == third + 1:
                tc = ev.touch_count
                top = np.argsort(tc)[-cfg["zipf_rebalance_top"]:]
                wts = {int(t): float(tc[t]) for t in top if tc[t]}
                lb = serve.host_loads(shard, list(wts), wts)
                mean = sum(lb.values()) / max(len(lb), 1)
                ratio_onset = max(lb.values()) / max(mean, 1e-9)
                plan = serve.rebalance(shard, list(wts), wts, threshold=1.25)
                moves = len(plan)
                loop.note_rebalance(moves)
                la = serve.host_loads(shard, list(wts), wts)
                ratio_after = max(la.values()) / max(mean, 1e-9)
        rep, _ = loop.flush_inflight()
        if rep is not None:
            total_ops += rep.ops_applied
            dispatches += rep.dispatches
            walls["after"].append(sb.last_dispatch_s)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        pipe_io = {**io_delta(m0), "wal_seconds": dict(swal.wal.seconds)}
        wal_pipe = (swal.bytes_appended - wal0[0], swal.fsyncs - wal0[1])
        swal.close()
        check(total_ops == n_serial == sum(len(c) for c in schedule[1:]),
              "the loops applied different op counts")

        # ---- gates: pipelined == serial == oracles; recovery == served
        touched = np.asarray(sorted(history))
        hot_sample = touched[np.argsort(ranks[touched])][: cfg["zipf_oracle_sample"] // 2]
        rest = rng.choice(touched, min(cfg["zipf_oracle_sample"], len(touched)), replace=False)
        sample = sorted({int(x) for x in hot_sample} | {int(x) for x in rest})
        sample = sample[: cfg["zipf_oracle_sample"]]
        compared = same_rows(sb, sb_s, ev, ev_s, sample)
        held = serve_oracle_gate(sb, ev, sample, history, device, "serve_zipf")
        sb_r, ev_r, _, q_r = stack(root, "recover", wal=False, tier="pipe")
        m0 = metrics.snapshot()["counters"]
        t0 = time.perf_counter()
        with serve.ServeWal(os.path.join(root, "wal_pipe")) as rw:
            replayed = serve.recover_serve(ev_r.root, q_r, rw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        recover_s = time.perf_counter() - t0
        recover_io = io_delta(m0)
        recovered = same_rows(sb, sb_r, ev, ev_r, sample)
        return {
            "config": "serve_zipf", "tenants": tenants, "lanes": lanes,
            "slab": [cfg["zipf_slab_lanes"], cfg["zipf_slab_depth"]], "cycles": cycles,
            "ops_per_cycle": per_cycle, "zipf_alpha": cfg["zipf_alpha"],
            "skew_factor": cfg["zipf_skew_factor"], "hosts": cfg["zipf_hosts"],
            "hot_host": hot_host, "ops_applied": total_ops,
            "serial_s": serial_s, "serial_ops_per_s": n_serial / serial_s,
            "pipelined_s": window_s, "pipelined_ops_per_s": total_ops / window_s,
            "pipeline_speedup": serial_s / window_s,
            "dispatches": dispatches, "ops_per_dispatch": total_ops / max(dispatches, 1),
            "overlap_hits": loop.overlap_hits,
            "background_persists": loop.persister.persisted if loop.persister else 0,
            "wal_bytes_serial": serial_wal[0], "wal_fsyncs_serial": serial_wal[1],
            "wal_bytes_pipelined": wal_pipe[0], "wal_fsyncs_pipelined": wal_pipe[1],
            "dispatch_wall": {k: serve_percentiles(v) for k, v in walls.items() if v},
            "serial_dispatch_wall": serve_percentiles(walls_s),
            "rebalance_moves": moves, "load_ratio_onset": ratio_onset,
            "load_ratio_after": ratio_after,
            "rows_compared_pipelined_vs_serial": compared, "oracle_held": held,
            "io_serial": serial_io, "io_pipelined": pipe_io, "io_recover": recover_io,
            "recover_s": recover_s, "replayed_records": replayed.records,
            "replayed_ops": replayed.ops, "rows_compared_recovered": recovered,
            "bit_identical": True,
            "committed_cycles": committed_cycles,
            "reduced": (f"cycles {committed_cycles} -> {cycles} (the time limit: 24 cycles "
                        "took 739-824 s, per-tenant persists on a 9p /tmp)"
                        if cycles < committed_cycles else "none")
                       + "; left out: telemetry (ROADMAP item 15.1)",
        }

    out = {"phase": "serve_zipf", **with_scratch_dir(runs)}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---- fan-out (ROADMAP item 11) ---------------------------------------------------

def fanout_cohort_case(rng, b: int, e: int, a: int, d: int = 2) -> tuple:
    """Numpy ``OrswotState`` leaves of ``b`` cohorts: live ``rows`` and
    acked ``bases`` (dicts, leading axis b, E elements, A actors, D parked
    slots). Base clocks lie below 2^20; a live element lane is the base's
    (40%), a change inside the ±32 Ki window (35%), a change outside it
    (15%: the defer → ``raw`` path, wrapping u32) or absent (10%); parked
    removes with random member bitmaps on both sides; cohort 0 is
    unchanged when b > 1."""
    import numpy as np

    base = rng.integers(0, 1 << 20, (b, e, a)).astype(np.uint32)
    pick = rng.random((b, e, 1))
    near = rng.integers(-32768, 32768, (b, e, a))
    far = rng.integers(32768, 1 << 24, (b, e, a)) * rng.choice([-1, 1], (b, e, a))
    wide = base.astype(np.int64)
    live = np.where(pick < 0.4, wide, np.where(pick < 0.75, wide + near,
                                               np.where(pick < 0.9, wide + far, 0)))
    live = (live % (1 << 32)).astype(np.uint32)
    if b > 1:
        live[0] = base[0]

    def state(ctr):
        return {"top": ctr.max(axis=1) + rng.integers(0, 4, (b, a)).astype(np.uint32),
                "ctr": ctr, "dcl": rng.integers(0, 1 << 20, (b, d, a)).astype(np.uint32),
                "dmask": rng.random((b, d, e)) < 0.3, "dvalid": rng.random((b, d)) < 0.6}

    rows, bases = state(live), state(base)
    if b > 1:
        for k in ("top", "dcl", "dmask", "dvalid"):
            rows[k][0] = bases[k][0]
    return rows, bases


def fanout_dispatch_case(p: int, seed: int, e: int = 33, a: int = 4, lanes_per_rank: int = 3,
                         cohorts_per_rank: int = 4) -> tuple:
    """One ``mesh_fanout_push`` dispatch as numpy: a superblock of
    ``p·lanes_per_rank`` rows, ``p·cohorts_per_rank`` cohort bases (each the
    acked base of the row its lane gathers, so most lanes fit the window),
    rank-local indices with one empty (-1) lane per rank block, and cohort
    weights: ``(state, bases, idx, weights)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t, b = p * lanes_per_rank, p * cohorts_per_rank
    state, acked = fanout_cohort_case(rng, t, e, a)
    idx = rng.integers(0, lanes_per_rank, b).astype(np.int32)
    idx[1::cohorts_per_rank] = -1
    rows = np.arange(b) // cohorts_per_rank * lanes_per_rank + np.maximum(idx, 0)
    bases = {k: v[rows] for k, v in acked.items()}
    return state, bases, idx, rng.integers(1, 9, b).astype(np.float32)


def fanout_config() -> dict:
    """``BENCH_CONFIGS.json`` "fanout", as committed (this checkout's copy)."""
    with open(os.path.join(HERE, "BENCH_CONFIGS.json")) as f:
        return json.load(f)["fanout"]


def fanout_wire_diff(x, y) -> int:
    """:func:`wire_diff` over the leaves of two ``CohortWire`` (on any
    devices): 0 when every leaf is equal."""
    from crdt_tpu_torch.ops.lattice import tree_leaves

    return wire_diff([u.cpu() for u in tree_leaves(tuple(x))],
                     [v.cpu() for v in tree_leaves(tuple(y))])


def fanout_k3_args(state, bases, idx, p: int, kind: str = "orswot") -> dict:
    """K3's arguments for one ``mesh_fanout_push`` dispatch, computed on
    the dispatch's own tensors: the fan-out instance over ``[P, (B/P)·E,
    A]``, per-row base."""
    from crdt_tpu_torch.ops.fanout_kernels import cohort_pack_args
    from crdt_tpu_torch.parallel.fanout_push import by_rank, fanout_deltas

    d, base_ctr, _ = fanout_deltas(kind, state, bases, idx, p)
    return cohort_pack_args(*by_rank(d, base_ctr, p))


def fanout_vs_plain(wire, args, sums: bool = True) -> int:
    """One dispatch's wire (K3 inside ``mesh_fanout_push``) against K3's
    plain version on the same card tensors: words, keep, defer and the
    rank-summed ``nnz``/``chk`` (``sums=False``: not those, which a
    cross-process dispatch sums over every process), and ``raw`` from the
    plain deferrals. Returns the max |difference| (0)."""
    import torch

    from crdt_tpu_torch._dtypes import bits, to_wide
    from crdt_tpu_torch.ops.wire_kernels import wire_pack_plain

    plain = wire_pack_plain(**args)
    raw = torch.where(plain.defer[..., None], bits(args["clocks"]), 0).view(args["clocks"].dtype)
    worst = max(max_abs_diff(wire.words.reshape(plain.words.shape), plain.words),
                int((wire.keep.reshape(plain.keep.shape) != plain.keep).sum()),
                int((wire.defer.reshape(plain.defer.shape) != plain.defer).sum()),
                max_abs_diff(wire.raw.reshape(raw.shape), raw))
    for k in ("nnz", "chk") if sums else ():
        want = int(to_wide(getattr(plain, k)).sum()) & 0xFFFFFFFF
        worst = max(worst, abs(int(to_wide(getattr(wire, k))) - want))
    return worst


def fanout_probe(device, root: str, p: int = 2) -> dict:
    """The CPU lockstep probes of ``tests/test_torch_fanout.py`` on one
    stack: 12 tenants on 6 lanes (fewer lanes than tenants) over ``p``
    virtual ranks with an evictor, 10 subscribers (split watermark buckets
    under a lossy link, a dead one), churn, an evict → re-warm, a stale
    duplicate ack; then the dead subscriber revives and everything
    converges. Returns a digest of every push (reports, wires as numpy,
    resync reports), the registry, the clients' rows and the gates."""
    import numpy as np

    from crdt_tpu_torch import fanout, serve
    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.ops import superblock as sb_ops
    from crdt_tpu_torch.parallel import VirtualMesh
    from crdt_tpu_torch.utils.metrics import metrics

    caps = dict(n_elems=8, n_actors=2, deferred_cap=2)
    sb = serve.Superblock(12, VirtualMesh(p, device), kind="orswot", caps=caps, n_lanes=6)
    ev = serve.Evictor(sb, root, pressure_batch=2)
    plane = fanout.FanoutPlane(sb, evictor=ev, window_cap=2, dispatch_lanes=2 * p)
    clients = {}

    def subscribe(tenants):
        ids = [int(s) for s in plane.subscribe(tenants)]
        for s in ids:
            clients[s] = fanout.ClientReplica("orswot", sb.empty_row(), device=device)
        return ids

    def touch(t, a, c, m):
        if not sb.is_resident(t):
            ev.restore(t)
        lane = sb.ensure_resident(t)
        row, _ = sb.tk.apply_add(sb_ops.unpack(sb.state, lane), a, c, m)
        sb_ops.write_rows_(sb.state, [lane], type(row)(*(x[None] for x in row)))
        sb.dirty[t] = True
        plane.note_dirty([t])

    digest = []

    def push(drop=(), ack=True):
        rep = plane.push()
        digest.append((rep.cohorts, rep.subscribers,
                       [(c.tenant, c.base_ver, c.to_ver, c.members.tolist(),
                         [x.tolist() for x in c.wire[:5]])
                        for c in rep.pushes],
                       [(r.tenant, r.to_ver, r.members.tolist(), tuple(r.report))
                        for r in rep.resyncs]))
        for cp in rep.pushes:
            for s in cp.members:
                if int(s) in clients and int(s) not in drop:
                    clients[int(s)].apply_wire(cp.wire, cp.to_ver)
        for rs in rep.resyncs:
            for s in rs.members:
                if int(s) in clients and int(s) not in drop:
                    clients[int(s)].adopt(rs.state, rs.to_ver)
        live = [s for s in clients if s not in drop]
        for s in live:
            clients[s].ack()
        if ack:
            plane.ack(live, versions=[clients[s].ver for s in live])
        return rep

    evictions0 = metrics.snapshot()["counters"].get("serve.evict.evictions", 0)
    ids = subscribe([0, 0, 1, 1, 2, 5, 7, 9, 11, 11])
    dead, lossy = ids[1], ids[2]
    rng = np.random.default_rng(91)
    ctr = np.zeros((12, 2), np.int64)
    evicted = rewarmed = 0
    for cycle in range(8):
        for _ in range(7):
            t, a = int(rng.choice([0, 1, 2, 5, 7, 9, 11])), int(rng.integers(0, 2))
            ctr[t, a] += 1
            touch(t, a, int(ctr[t, a]), rng.random(8) < 0.4)
        if cycle == 4:
            evicted = ev.evict([0, 1])
        push(drop={dead} | ({lossy} if cycle % 2 else set()))
        if cycle == 4:
            rewarmed = int(sb.is_resident(0) and sb.is_resident(1))
        if cycle == 3:  # churn: one leaves, one joins mid-stream
            gone = ids.pop(4)
            plane.unsubscribe([gone])
            del clients[gone]
            ids += subscribe([2])
    # A stale duplicate ack, reordered before the genuine one: neither
    # the watermark nor the pending mark of the newer ship moves.
    touch(0, 0, int(ctr[0, 0]) + 1, rng.random(8) < 0.4)
    push(drop={dead}, ack=False)
    s0 = ids[0]
    held = (int(plane.sub_ver[s0]), int(plane.sub_pend[s0]))
    plane.ack([s0], versions=[0])
    stale_clamped = (int(plane.sub_ver[s0]), int(plane.sub_pend[s0])) == held and held[1] > 0
    live = [s for s in clients if s != dead]
    plane.ack(live, versions=[clients[s].ver for s in live])
    resyncs = plane.resyncs_total
    for _ in range(6):  # the dead subscriber revives; converge
        rep = push()
        if rep.cohorts == 0 and not rep.resyncs:
            break
    # Seven written tenants on six lanes: restores evicted under pressure
    # (the two explicit evictions aside).
    pressure = metrics.snapshot()["counters"].get("serve.evict.evictions", 0) - evictions0 - 2
    equal = 0
    for s, c in clients.items():
        t = int(plane.sub_tenant[s])
        if not sb.is_resident(t):
            ev.restore(t)
        equal += int(c.equals(sb.row(t)))
    return {"digest": digest, "clients_equal": equal, "clients": len(clients),
            "resyncs": resyncs, "evicted": evicted, "rewarmed": rewarmed,
            "pressure_evictions": pressure,
            "stale_ack_clamped": stale_clamped, "pushes": len(digest),
            "registry": [getattr(plane, k)[:plane._top].tolist() for k in
                         ("sub_tenant", "sub_ver", "sub_pend")] + [plane.ver.tolist()],
            "client_rows": {s: [leaf_to_numpy(x).tolist() for x in c.state]
                            for s, c in clients.items()}}


def phase_fanout_scenarios(device, seed: int) -> dict:
    """The fan-out plane's CPU lockstep probes on the card, small: the probe
    run (:func:`fanout_probe`) on the card == the same run on the CPU (every
    push's report and wire, the registry, the clients), every client == its
    served row; the detector passes the honest push and fails the
    bucket-skipping twin; and K3's fan-out instance against its plain
    version on the same card tensors at A in {1, 2, 3, 4, 8}, with rows
    outside the ±32 Ki window and empty lanes, both as a bare launch and
    through ``mesh_fanout_push`` (one launch a dispatch; == the dispatch on
    the CPU on every leaf)."""
    import torch

    from crdt_tpu_torch.convert import orswot_from_numpy
    from crdt_tpu_torch.fanout import fanout_covers_cohorts
    from crdt_tpu_torch.ops.wire_kernels import wire_pack, wire_pack_plain
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_fanout_push

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    out = {"phase": "fanout_scenarios"}
    k3 = []
    for a in (1, 2, 3, 4, 8):
        state, bases, idx, wts = fanout_dispatch_case(8, seed + a, e=33, a=a)
        runs = {}
        for dev in (device, cpu):
            args = (orswot_from_numpy(state, dev), orswot_from_numpy(bases, dev),
                    torch.as_tensor(idx).to(dev), VirtualMesh(8, dev))
            before = wire_pack.launches
            runs[dev.type] = mesh_fanout_push(*args, weights=torch.as_tensor(wts))
            launches = wire_pack.launches - before
            if dev.type == "cuda":
                check(launches == 1, f"A={a}: mesh_fanout_push launched K3 {launches} times")
                kargs = fanout_k3_args(*args[:3], 8)
                bare = wire_diff(wire_pack(**kargs), wire_pack_plain(**kargs))
                through = fanout_vs_plain(runs[dev.type][0], kargs)
        cross = fanout_wire_diff(runs[device.type][0], runs["cpu"][0])
        pb = max_abs_diff(runs[device.type][1].cpu().view(torch.int32),
                          runs["cpu"][1].view(torch.int32))
        if device.type == "cuda":
            check(bare == 0 and through == 0, f"A={a}: K3 != its plain version ({bare}, {through})")
        check(cross == 0 and pb == 0, f"A={a}: the card's dispatch != the CPU's")
        defer = int(runs["cpu"][0].defer.sum())
        check(defer > 0 and int((torch.as_tensor(idx) < 0).sum()) > 0,
              "the cases hold deferred rows and empty lanes")
        k3.append({"A": a, "rows": int(runs["cpu"][0].keep.numel()), "deferred": defer,
                   "max_abs_err": max(cross, pb, bare if device.type == "cuda" else 0,
                                      through if device.type == "cuda" else 0)})
    out["k3_fanout_instance"] = k3
    out["k3_max_abs_err"] = max(r["max_abs_err"] for r in k3)

    def probes(root):
        card = fanout_probe(device, os.path.join(root, "card"))
        host = fanout_probe(cpu, os.path.join(root, "cpu"))
        check(card == host, "the fan-out probes on the card != the same on the CPU")
        check(card["clients_equal"] == card["clients"], "a client != its served row")
        check(card["resyncs"] >= 1 and card["evicted"] == 2 and card["rewarmed"] == 1,
              "no resync, or no evict → re-warm, in the probes")
        check(card["stale_ack_clamped"], "a stale duplicate ack moved a watermark")
        check(card["pressure_evictions"] >= 1, "no eviction under lane pressure in the probes")
        return {k: card[k] for k in ("pushes", "clients_equal", "clients", "resyncs", "evicted",
                                     "rewarmed", "pressure_evictions", "stale_ack_clamped")}

    out["probes"] = with_scratch_dir(probes)
    honest = fanout_covers_cohorts(lambda plane: plane.push(), device=device)
    twin = fanout_covers_cohorts(lambda plane: plane.push(_skip_versions=(0,)), device=device)
    check(honest and not twin, f"detector: honest {honest}, bucket-skipping twin {twin}")
    out["detector"] = {"honest_push": honest, "skipping_twin": twin}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def fanout_price(wire) -> float:
    """:func:`cohort_push_bytes` of one cohort's host wire (numpy leaves,
    viewed as tensors without a copy): the bytes its payload costs."""
    import numpy as np
    import torch

    from crdt_tpu_torch.ops.fanout_kernels import CohortWire, cohort_push_bytes

    t = lambda x: torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)  # noqa: E731
    return float(cohort_push_bytes(CohortWire(
        words=t(wire.words), keep=t(wire.keep), defer=t(wire.defer), valid=None,
        raw=t(wire.raw), residual=tuple(t(x) for x in wire.residual), nnz=None, chk=None))[0])


class FirstDispatch:
    """Wraps ``mesh_fanout_push`` where the plane calls it: every call goes
    through, and the first one's wire is held against K3's plain version
    on the same card tensors at once (:func:`fanout_vs_plain`); its K3
    arguments are kept for timing after the window."""

    def __init__(self, fn):
        self.fn = fn
        self.args = None
        self.err = None
        self.check_s = 0.0  # host seconds of the check, inside the caller's push

    def __call__(self, state, bases, idx, mesh, **kw):
        out = self.fn(state, bases, idx, mesh, **kw)
        if self.args is None:
            t0 = time.perf_counter()
            self.args = fanout_k3_args(state, bases, idx, mesh.p, kw.get("kind", "orswot"))
            self.err = fanout_vs_plain(out[0], self.args)
            self.check_s = time.perf_counter() - t0
        return out


def fanout_telemetry_gates(rep, plane, dispatches: int, committed: bool) -> dict:
    """A push's annotated Telemetry against the plane and the host: the
    live subscribers (1M+ at the committed shape), its cohorts, the δ
    bytes it pushed priced on the host per delivery (``fanout_price`` ×
    members), its resync fallbacks and their bootstrap bytes, one
    histogram entry per cohort and per dispatch."""
    from crdt_tpu_torch import telemetry as tele

    d = tele.to_dict(rep.telemetry)
    host_bytes = sum(fanout_price(cp.wire) * len(cp.members) for cp in rep.pushes)
    resynced = sum(len(rs.members) for rs in rep.resyncs)
    boot = sum(rs.report.bytes_shipped * len(rs.members) for rs in rep.resyncs)
    gates = {
        "subscribers_live": (d["subscribers_live"] == plane.n_live
                             and (plane.n_live >= 1_000_000 or not committed)),
        "cohorts_per_dispatch": d["cohorts_per_dispatch"] == rep.cohorts,
        "delta_push_bytes": f32_close(d["delta_push_bytes"], host_bytes, rep.cohorts),
        "resync_fallbacks": d["resync_fallbacks"] == resynced,
        "bootstrap_bytes": f32_close(d["bootstrap_bytes"], boot, 1),
        "hist_push_bytes": sum(d["hist_push_bytes"]["counts"]) == rep.cohorts,
        "hist_dispatch_us": sum(d["hist_dispatch_us"]["counts"]) == dispatches,
    }
    check(all(gates.values()), f"fan-out telemetry gates failed: {gates}")
    return {"gates": gates, "dispatches": dispatches, "cohorts": rep.cohorts,
            "host_priced_delta_bytes": host_bytes,
            "telemetry": {k: d[k] for k in ("subscribers_live", "cohorts_per_dispatch",
                                            "delta_push_bytes", "resync_fallbacks",
                                            "bootstrap_bytes")}}


def k3_at_fanout_layout(args: dict, device, repeats: int = 5, per_sample: int = 20) -> dict:
    """K3 on the first dispatch's own inputs (the fan-out instance, ``[P,
    (B/P)·E, A]``, per-row base): per launch over a replayed graph, alone
    under the profiler, the plain version's time, the distinct bytes, the
    bound and the share. Its launches here are not the main path's: the
    caller restores the counter."""
    import torch

    from crdt_tpu_torch.ops.wire_kernels import wire_pack, wire_pack_plain

    out = wire_pack(**args)
    err = wire_diff(out, wire_pack_plain(**args))
    check(err == 0, "K3 at the fan-out layout disagrees with its plain version")
    times = [graph_ms(lambda: wire_pack(**args), device, per_sample) for _ in range(repeats)]
    ms = statistics.median(times)
    dev_ms = kernel_device_ms(lambda: wire_pack(**args), device, "wire_kernel", per_sample)
    plain_ms = statistics.median(time_ms(lambda: wire_pack_plain(**args), device)
                                 for _ in range(3))
    nbytes = k3_bytes(args, out)
    bound = {"bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
             "ops_ms": 12 * args["clocks"].numel() / PEAK_SCALAR_OPS_PER_S * 1e3}
    bound_ms = max(bound.values())
    del out
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"shape": list(args["clocks"].shape), "ms_median": ms, "ms_runs": times,
            "ms_device_profiler": dev_ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound["bytes_ms"] >= bound["ops_ms"] else "operations",
            "bound_share": bound_ms / ms,
            "bound_share_device_profiler": bound_ms / dev_ms if dev_ms else None,
            "max_abs_err": err}


def phase_fanout(device, seed: int, cfg=None) -> dict:
    """``BENCH_CONFIGS.json`` "fanout" at its committed shape, driven as
    ``bench.py``'s ``bench_fanout`` drives it: 1,048,576 subscribers (one
    per tenant) over 1,048,576 tenants on 131,072 lanes (E = 256, A = 4,
    D = 2) on 8 virtual ranks, the serve ingest (slabs 4,096 × 4) feeding
    a ``FanoutPlane`` (4,096 dispatch lanes, window 4); ``cycles`` of
    ``ops_per_cycle`` ops (an ``hot_set`` hot set shifting ``hot_shift`` a
    cycle, the pinned head of sampled and killed subscribers every cycle),
    one push a cycle, ``churn`` subscribers replaced a cycle, killed
    subscribers never acking (resyncs), an ``evict_cohort`` of subscribed
    tenants evicted mid-window and re-warmed by the next push. Gates: the
    first dispatch's wire == K3's plain version on every leaf, K3 once per
    dispatch, the sampled clients and the revived dead one == their served
    rows, every watermark current, 1M+ live subscribers, a resync and the
    re-warm, δ + bootstrap bytes ≥ 10× below the full-state push."""
    import numpy as np
    import torch

    from crdt_tpu_torch import serve
    from crdt_tpu_torch.fanout import ClientReplica, FanoutPlane
    from crdt_tpu_torch.fanout import plane as plane_mod
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import VirtualMesh

    committed = cfg is None
    cfg = dict(fanout_config() if committed else cfg)
    tenants, lanes, subscribers = cfg["tenants"], cfg["lanes"], cfg["subscribers"]
    caps = dict(n_elems=cfg["elems"], n_actors=cfg["actors"], deferred_cap=cfg["deferred_cap"])
    e, a = caps["n_elems"], caps["n_actors"]
    hot_set, hot_shift, cycles = cfg["hot_set"], cfg["hot_shift"], cfg["cycles"]
    client_sample, kill = cfg["client_sample"], cfg["kill_subscribers"]
    t_phase = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    def runs(root):
        sb = serve.Superblock(tenants, VirtualMesh(cfg["mesh"][0], device), kind="orswot",
                              caps=caps, n_lanes=lanes)
        ev = serve.Evictor(sb, os.path.join(root, "tier"), pressure_batch=256)
        q = serve.IngestQueue(sb, lanes=cfg["slab_lanes"], depth=cfg["slab_depth"],
                              max_pending=1 << 20, evictor=ev)
        plane = FanoutPlane(sb, evictor=ev, window_cap=cfg["window_cap"],
                            dispatch_lanes=cfg["dispatch_lanes"], capacity=subscribers)
        t0 = time.perf_counter()
        plane.subscribe(np.arange(subscribers, dtype=np.int64) % tenants)
        subscribe_s = time.perf_counter() - t0
        pinned = client_sample + kill
        clients = {s: ClientReplica("orswot", sb.empty_row(), device=device)
                   for s in range(client_sample)}
        killed = np.arange(client_sample, pinned)
        dead_sub = client_sample  # revived and verified at the end
        dead_client = ClientReplica("orswot", sb.empty_row(), device=device)
        rng = np.random.default_rng(163)
        next_ctr = np.zeros(tenants, np.uint32)
        priced = {"delta_bytes": 0.0, "bootstrap_bytes": 0.0, "delta_deliveries": 0,
                  "deliveries": 0}

        def submit_cycle(cycle, n_ops):
            off = (cycle * hot_shift) % max(tenants - hot_set, 1)
            hot = rng.integers(off, off + hot_set, n_ops)
            uni = rng.integers(0, tenants, n_ops)
            ts = np.where(rng.random(n_ops) < 0.85, hot, uni)
            ts[:pinned] = np.arange(pinned)
            masks = rng.random((n_ops, e)) < (6.0 / e)
            for i in range(n_ops):
                t = int(ts[i])
                c = int(next_ctr[t]) + 1
                next_ctr[t] = c
                q.add(t, t % a, c, masks[i])
            return np.unique(ts)

        def deliver_and_ack(rep, revive=False, price=False):
            for cp in rep.pushes:
                for s in cp.members:
                    s = int(s)
                    if s in clients:
                        clients[s].apply_wire(cp.wire, cp.to_ver)
                    elif revive and s == dead_sub:
                        dead_client.apply_wire(cp.wire, cp.to_ver)
                if price:
                    priced["delta_bytes"] += fanout_price(cp.wire) * len(cp.members)
                    priced["delta_deliveries"] += len(cp.members)
            for rs in rep.resyncs:
                for s in rs.members:
                    s = int(s)
                    if s in clients:
                        clients[s].adopt(rs.state, rs.to_ver)
                    elif revive and s == dead_sub:
                        dead_client.adopt(rs.state, rs.to_ver)
                if price:
                    priced["bootstrap_bytes"] += rs.report.bytes_shipped * len(rs.members)
            if price:
                priced["deliveries"] += rep.subscribers
            for c in clients.values():
                c.ack()
            if revive:
                dead_client.ack()
            members = [cp.members for cp in rep.pushes + rep.resyncs]
            if members:
                allm = np.concatenate(members)
                if not revive:  # the killed set never acks in the window
                    allm = allm[~np.isin(allm, killed)]
                plane.ack(allm)

        # Warmup, outside the window: the first slabs' allocations and
        # graph capture, the first dispatch's.
        touched = submit_cycle(0, 512)
        q.drain()
        plane.note_dirty(touched)
        deliver_and_ack(plane.push())

        first = FirstDispatch(plane_mod.mesh_fanout_push)
        walls, per_cycle_disp = [], []
        n_evicted, rewarmed, submit_s = 0, False, 0.0
        plane.seconds = dict.fromkeys(plane.seconds, 0.0)
        wire_pack.launches = 0
        disp0 = plane.dispatches
        resync0 = plane.resyncs_total
        for cycle in range(1, cycles + 1):
            ts0 = time.perf_counter()
            touched = submit_cycle(cycle, cfg["ops_per_cycle"])
            q.drain()
            submit_s += time.perf_counter() - ts0
            plane.note_dirty(touched)
            if cycle == cycles // 2:
                n_evicted = ev.evict(list(range(cfg["evict_cohort"])))
            d0 = plane.dispatches
            plane_mod.mesh_fanout_push = first if cycle == 1 else first.fn
            try:
                t0 = time.perf_counter()
                rep = plane.push()
                # Cycle 1's first dispatch is held against the plain pack
                # inside its push: that check's time is not the push's.
                walls.append(time.perf_counter() - t0 - (first.check_s if cycle == 1 else 0.0))
            finally:
                plane_mod.mesh_fanout_push = first.fn
            per_cycle_disp.append(plane.dispatches - d0)
            if cycle == cycles // 2:
                rewarmed = all(sb.is_resident(t) for t in range(cfg["evict_cohort"]))
            deliver_and_ack(rep, price=True)
            if cfg["churn"]:
                drop = np.unique(rng.integers(pinned, subscribers, cfg["churn"]))
                plane.unsubscribe(drop)
                plane.subscribe(rng.integers(0, tenants, len(drop)))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        k3_launches = wire_pack.launches
        window_dispatches = plane.dispatches - disp0
        resyncs_in_window = plane.resyncs_total - resync0
        window_seconds = dict(plane.seconds)
        push_s = sum(walls)
        check(first.err == 0, f"the first dispatch's wire != K3's plain version ({first.err})")
        on_card = device.type == "cuda"
        check(window_dispatches >= 1 and (not on_card or k3_launches == window_dispatches),
              f"K3 launched {k3_launches} times for {window_dispatches} dispatches")

        # One more cycle, outside the window, its push profiled: the host /
        # device split.
        touched = submit_cycle(cycles + 1, cfg["ops_per_cycle"])
        q.drain()
        plane.note_dirty(touched)
        got = []
        secs0, d0 = dict(plane.seconds), plane.dispatches
        prof = profile_busy(lambda: got.append(plane.push()), device, host_top=8)
        if prof is None:
            got.append(plane.push())
        deliver_and_ack(got[0])
        prof_secs = {k: plane.seconds[k] - secs0[k] for k in secs0}

        # One more cycle's push with the telemetry sidecar (ROADMAP 15.1),
        # its annotated Telemetry against the plane's and the host's counts.
        touched = submit_cycle(cycles + 2, cfg["ops_per_cycle"])
        q.drain()
        plane.note_dirty(touched)
        d0 = plane.dispatches
        t0 = time.perf_counter()
        rep_t = plane.push(telemetry=True)
        tel_push_s = time.perf_counter() - t0
        telemetry = fanout_telemetry_gates(rep_t, plane, plane.dispatches - d0, committed)
        telemetry["push_wall_s"] = tel_push_s
        deliver_and_ack(rep_t)

        # The trace plane (ROADMAP 15.6), as bench.py's fan-out leg runs
        # it: a FlightRecorder (32,768) and a Tracer at trace_sample,
        # installed after the window above; the window's cycles again, each
        # push with the sidecar, annotated after its acks and recorded.
        traced = fanout_traced_window(
            lambda cycle: submit_cycle(cycle, cfg["ops_per_cycle"]), q, plane, ev, sb,
            deliver_and_ack, cfg, device, root, first_cycle=cycles + 3, untraced_walls=walls,
            pinned=pinned, rng=rng)

        # K3 on the first dispatch's own inputs, timed; not the main path's
        # launches.
        saved = wire_pack.launches
        k3 = k3_at_fanout_layout(first.args, device) if device.type == "cuda" else None
        wire_pack.launches = saved

        # Verification: revive the dead subscriber (its catch-up must come
        # as a resync), converge.
        for _ in range(cfg["window_cap"] + 2):
            rep = plane.push()
            if rep.cohorts == 0 and not rep.resyncs:
                break
            deliver_and_ack(rep, revive=True)
        st = plane.sub_tenant[:plane._top]
        alive = st >= 0
        current = bool(np.all(plane.sub_ver[:plane._top][alive]
                              == plane.ver[np.where(alive, st, 0)][alive]))

        def served(t):
            if not sb.is_resident(t):
                ev.restore(t)
            return sb.row(t)

        mismatches = sum(0 if c.equals(served(s)) else 1 for s, c in clients.items())
        mismatches += 0 if dead_client.equals(served(dead_sub)) else 1
        check(mismatches == 0 and current,
              f"{mismatches} sampled clients diverged (watermarks current: {current})")
        check(plane.n_live >= 1_000_000 or not committed,
              f"only {plane.n_live} live subscribers; the gate is 1M+")
        check(resyncs_in_window >= 1, "no dead-subscriber resync in the window")
        check(n_evicted >= 1 and rewarmed, "no subscribed-tenant evict → re-warm in the window")
        row_b = sb.row_nbytes()
        total = priced["delta_bytes"] + priced["bootstrap_bytes"]
        per_delta = priced["delta_bytes"] / max(priced["delta_deliveries"], 1)
        ratio_overall = priced["deliveries"] * row_b / max(total, 1e-9)
        check(ratio_overall >= 10, f"δ + bootstrap moved 1/{ratio_overall:.2f} of the "
                                   "full-state push; the gate is 10×")
        out = {
            "config": "fanout", "tenants": tenants, "lanes": lanes,
            "subscribers_live": plane.n_live,
            "elems": e, "actors": a, "deferred_cap": caps["deferred_cap"],
            "mesh_virtual_ranks": cfg["mesh"][0], "dispatch_lanes": cfg["dispatch_lanes"],
            "cycles": cycles, "ops_per_cycle": cfg["ops_per_cycle"],
            "deliveries": priced["deliveries"], "delta_deliveries": priced["delta_deliveries"],
            "push_window_s": push_s, "deliveries_per_s": priced["deliveries"] / push_s,
            "push_wall_s_per_cycle": walls, "dispatches_per_cycle": per_cycle_disp,
            "k3_launches_in_window": k3_launches, "window_dispatches": window_dispatches,
            "window_host_seconds_by_part": window_seconds, "submit_and_drain_s": submit_s,
            "subscribe_1m_s": subscribe_s, "resyncs_in_window": resyncs_in_window,
            "evicted": n_evicted, "rewarmed": rewarmed,
            "delta_bytes": priced["delta_bytes"], "bootstrap_bytes": priced["bootstrap_bytes"],
            "bytes_per_delta_delivery": per_delta, "full_row_bytes": row_b,
            "delta_vs_full_ratio": row_b / max(per_delta, 1e-9),
            "overall_vs_full_ratio": ratio_overall,
            "clients_verified": len(clients) + 1, "watermarks_current": current,
            "first_dispatch_max_abs_err": first.err,
            "superblock_bytes": sb.nbytes(), "telemetry": telemetry, "traced": traced,
            "reduced": "none",
        }
        if prof is not None:
            out["profiled_cycle"] = {
                "push_wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                "busy_share": prof["busy_share"], "dispatches": plane.dispatches - d0,
                "launch_kernel_calls": prof["launch_kernel_calls"],
                "host_seconds_by_part": prof_secs, "top": prof["top"][:4],
                "host_top": prof.get("host_top")}
        if k3 is not None:
            out["k3_fanout_layout"] = k3
        return out

    out = {"phase": "fanout", **with_scratch_dir(runs)}
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def fanout_traced_window(submit, q, plane, ev, sb, deliver_and_ack, cfg, device, root,
                         first_cycle: int, untraced_walls, pinned: int, rng) -> dict:
    """The fan-out window again with the trace plane on: a
    ``FlightRecorder`` (32,768) and a ``Tracer`` at ``trace_sample``; each
    cycle's writes, one push with the sidecar (a mid-window evict of
    subscribed tenants re-warmed by it), the deliveries and acks — which
    complete the sampled journeys — then the push's Telemetry annotated
    with the cycle's trace histograms and recorded, and the churn. The
    dump passes ``obs.report`` with the trace replay run."""
    import numpy as np

    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.obs import trace as obs_trace

    tr = obs_trace.Tracer(sample=cfg["trace_sample"])
    walls, deliveries, n_evicted = [], 0, 0
    with Observed(os.path.join(root, "flight-fanout"), capacity=32768, tracer=tr) as o:
        t_window = time.perf_counter()
        for cycle in range(first_cycle, first_cycle + cfg["cycles"]):
            touched = submit(cycle)
            q.drain()
            plane.note_dirty(touched)
            if cycle == first_cycle + cfg["cycles"] // 2:
                n_evicted = ev.evict(list(range(cfg["evict_cohort"])))
            t0 = time.perf_counter()
            rep = plane.push(telemetry=True)
            walls.append(time.perf_counter() - t0)
            deliveries += rep.subscribers
            deliver_and_ack(rep)
            tele.record("fanout", tr.annotate(rep.telemetry))
            if cfg["churn"]:
                drop = np.unique(rng.integers(pinned, cfg["subscribers"], cfg["churn"]))
                plane.unsubscribe(drop)
                plane.subscribe(rng.integers(0, cfg["tenants"], len(drop)))
        window_s = time.perf_counter() - t_window
        skew = obs_trace.skew_report(evictor=ev, queue=q, tracer=tr, k=8)
        path = o.rec.dump(os.path.join(root, "fanout-flight.jsonl"), reason="fanout")
        rep_all = audited(path, snapshot=o.since(), slo=True)
    check(tr.completed >= 1, "no sampled journey completed in the traced fan-out window")
    check(n_evicted >= 1, "no subscribed tenant evicted in the traced window")
    return {
        "trace_sample": cfg["trace_sample"], "cycles": cfg["cycles"], "window_s": window_s,
        "deliveries": deliveries, "push_window_s": sum(walls),
        "deliveries_per_s": deliveries / sum(walls),
        "push_wall_s_per_cycle": walls, "untraced_push_wall_s_per_cycle": untraced_walls,
        "push_wall_p50_s": statistics.median(walls),
        "untraced_push_wall_p50_s": statistics.median(untraced_walls),
        **trace_summary(tr, rep_all, None, None),
        "skew_top": skew["tenants"][:3], "flight": flight_summary(o, rep_all),
    }


# ---- telemetry (ROADMAP 15.1) ----------------------------------------------

# Telemetry fields whose value depends on the host's clock or on timing,
# never held equal across two runs: the host-timed dispatch and persist
# walls, the trace plane's stage walls, and the stream's overlap count.
HOST_TIMED = frozenset({
    "hist_dispatch_us", "hist_persist_us", "hist_queue_wait_us", "hist_dispatch_gap_us",
    "hist_durable_lag_us", "hist_push_lag_us", "hist_ack_lag_us", "hist_freshness_us",
    "stream_overlap_hit",
})


def f32_close(x: float, want: float, terms: int) -> bool:
    """``x``, a float32 sum of ``terms`` rounded adds, within float32
    rounding of the exact ``want``: |x − want| ≤ terms · 2⁻²⁴ · |want|."""
    return abs(x - want) <= max(terms, 1) * 2.0 ** -24 * abs(want)


class PackedProbe:
    """While installed, records on the device what the fused wire put on
    the links: K3's own nonzero-word counts (``nnz`` of every instance of
    every launch), the nonzero words of those instances' outputs, and the
    nonzero words of every leaf of every packed wire tree (the K3 words
    and the id, raw and bitmap leaves packed beside them)."""

    def __init__(self, device):
        import torch

        z = lambda: torch.zeros((), dtype=torch.int64, device=device)  # noqa: E731
        self.k3_nnz, self.k3_words_nonzero, self.wire_nonzero = z(), z(), z()

    def __enter__(self):
        from crdt_tpu_torch._dtypes import bits, to_wide
        from crdt_tpu_torch.ops import wire_kernels as wk
        from crdt_tpu_torch.ops.lattice import tree_leaves
        from crdt_tpu_torch.parallel import wire as wire_mod

        self._saved = (wk, wk.wire_pack_many, wire_mod.WireCodec, wire_mod.WireCodec.pack)
        many, pack = self._saved[1], self._saved[3]

        def counted_many(items):
            outs = many(items)
            for o in outs:
                self.k3_nnz += to_wide(o.nnz).sum()
                self.k3_words_nonzero += (bits(o.words) != 0).sum()
            return outs

        def counted_pack(codec, pkt, rtop=None, win=None):
            wired, aux = pack(codec, pkt, rtop=rtop, win=win)
            for leaf in tree_leaves(wired):
                self.wire_nonzero += (bits(leaf) != 0).sum()
            return wired, aux

        wk.wire_pack_many, wire_mod.WireCodec.pack = counted_many, counted_pack
        return self

    def __exit__(self, *exc):
        wk, many, codec_cls, pack = self._saved
        wk.wire_pack_many, codec_cls.pack = many, pack
        return False


def telemetry_ring_leg(ring, off, stats: dict, rounds: int, p: int, rl: int, a: int, counters,
                       local_launches: int, off_profile, sync, samples: int, device,
                       acked_stats: dict, slot_bytes: int) -> dict:
    """A full-width δ ring with ``telemetry=True`` (``ring(telemetry, ack,
    stats)``): the fused ring counted and probed, then gated against the
    ``telemetry=False`` ring ``off`` (states, dirty, overflow and residue
    bit for bit), the JAX merge count, the static wire bytes (one link's
    ``stats["wire_bytes"]`` a round plus the digest exchange), K3's
    nonzero words as ``wire_packed_bytes``, the histograms' counts and
    totals; the acked ring's skipped bytes against its slot count; then
    launches a round and the median wall with the sidecar off and on,
    alternating."""
    import torch

    from crdt_tpu_torch import telemetry as tele

    on_card = device.type == "cuda"
    for counted in counters:
        counted.launches = 0
    with PackedProbe(device) as probe:
        on = ring(True, False, None)
        sync()
    launches = [counted.launches for counted in counters]
    check(not on_card or launches == [rounds, local_launches],
          f"the telemetry ring launched {launches}, not K3 {rounds} and {local_launches} "
          "local folds")
    check(same_leaves(on[0], off[0]) and torch.equal(on[1], off[1])
          and torch.equal(on[2], off[2]) and int(on[3]) == int(off[3]) == 0,
          "the telemetry ring's states, dirty, overflow or residue differ from the plain ring's")
    d = tele.to_dict(on[4])
    k3_nnz, k3_words = int(probe.k3_nnz), int(probe.k3_words_nonzero)
    wire_nonzero = int(probe.wire_nonzero)
    digest = a * 4  # the frozen receiver tops cross one hop once (u32 [A])
    want = {
        "merges": p * (rl - 1) + p * rounds,
        "bytes_exchanged": p * (rounds * stats["wire_bytes"] + digest),
        # The unit (JAX parallel/wire.py:433-443): K3's nonzero u32 words
        # plus the nonzero words of the id, raw and bitmap leaves, ×4 bytes.
        "wire_packed_bytes": 4 * (k3_nnz + wire_nonzero - k3_words),
        "hist_residue_count": p * rounds,
    }
    gates = {
        "merges": d["merges"] == want["merges"],
        "bytes_exchanged": f32_close(d["bytes_exchanged"], want["bytes_exchanged"], rounds + p),
        "k3_nnz_is_its_nonzero_words": k3_nnz == k3_words,
        "wire_packed_bytes": f32_close(d["wire_packed_bytes"], want["wire_packed_bytes"],
                                       rounds + p),
        "hist_residue_count": sum(d["hist_residue"]["counts"]) == want["hist_residue_count"],
        "hist_useful_total": f32_close(d["hist_useful_bytes"]["total"],
                                       d["bytes_useful"] - p * digest, rounds + p),
        "hist_packed_total": f32_close(d["hist_packed_bytes"]["total"], d["wire_packed_bytes"],
                                       rounds + p),
        "residue": d["residue"] == int(on[3]) == 0,
    }
    check(all(gates.values()), f"telemetry ring gates failed: {gates} (want {want}, got "
                               f"{ {k: d[k] for k in ('merges', 'bytes_exchanged', 'wire_packed_bytes')} })")
    del on
    acked = ring(True, True, None)
    sync()
    da = tele.to_dict(acked[4])
    want_skip = acked_stats["slots_acked_skipped"] * slot_bytes
    acked_gates = {
        "states": same_leaves(acked[0], off[0]) and int(acked[3]) == 0,
        "bytes_acked_skipped": f32_close(da["bytes_acked_skipped"], want_skip, rounds + p),
        "ack_window_depth": da["ack_window_depth"] > 0,
        # The pipelined ring acks in every round but the last (the
        # epilogue's packet is applied, never acked).
        "hist_ack_depth_count": sum(da["hist_ack_depth"]["counts"]) == p * (rounds - 1),
    }
    check(all(acked_gates.values()), f"acked telemetry ring gates failed: {acked_gates}")
    del acked
    on_profile = profile_busy(lambda: ring(True, False, None), device)
    runs = alternate_rings(lambda kind: ring(kind, False, None), samples, sync,
                           kinds=(False, True))
    med = {k: statistics.median(runs[k]) for k in runs}
    per_round = lambda prof: prof["launch_kernel_calls"] / rounds if prof else None  # noqa: E731
    keep = ("merges", "slots_changed", "bytes_exchanged", "bytes_useful", "wire_packed_bytes",
            "deferred_depth", "widen_pressure", "residue")
    return {
        "gates": gates, "acked_gates": acked_gates, "k3_launches": launches[0],
        "local_fold_launches": launches[1], "k3_nnz_words": k3_nnz,
        "id_raw_bitmap_nonzero_words": wire_nonzero - k3_words,
        "telemetry": {k: d[k] for k in keep},
        "acked_telemetry": {k: da[k] for k in ("bytes_acked_skipped", "ack_window_depth",
                                                "bytes_useful", "wire_packed_bytes")},
        "packed_over_exchanged": d["wire_packed_bytes"] / d["bytes_exchanged"],
        "launch_kernel_calls_per_round_off": per_round(off_profile),
        "launch_kernel_calls_per_round_on": per_round(on_profile),
        "device_ms_off": off_profile["device_ms"] if off_profile else None,
        "device_ms_on": on_profile["device_ms"] if on_profile else None,
        "ring_ms_off": med[False], "ring_ms_on": med[True],
        "on_over_off": med[True] / med[False],
        "ring_ms_runs": {"off": runs[False], "on": runs[True]},
    }


def phase_telemetry_scenarios(device, seed: int) -> dict:
    """The same seeded inputs through the port's telemetry paths on the CPU
    and on the card: ``mesh_fold`` / ``mesh_gossip``, the dense and Map δ
    rings (fused, layered, acked), a dense stream, one serving flush and
    one fan-out dispatch; the card's ``to_dict`` == the CPU's on every
    counted field (``HOST_TIMED`` left out by name)."""
    import torch

    from crdt_tpu_torch import serve, telemetry as tele
    from crdt_tpu_torch.convert import orswot_from_numpy
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import (
        VirtualMesh, iter_blocks, mesh_delta_gossip, mesh_delta_gossip_map, mesh_fanout_push,
        mesh_fold, mesh_fold_map, mesh_gossip, mesh_stream_fold,
    )

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    dense = fill_delta_config3(32, 600, 8, 4, 4, seed, cpu, chunk=8)[:3]
    cfg4 = fill_delta_config4(32, 1200, 2, 4, 4, 4, seed, cpu, chunk=8)[:3]
    fan = fanout_dispatch_case(2, seed)
    caps = dict(n_elems=8, n_actors=4, deferred_cap=2)
    streams = serve_streams("orswot", caps, 16, 160, seed)
    on = lambda x, dev: tree_map(lambda t: t.to(dev), x)  # noqa: E731

    def ring_case(fn, inputs, **kw):
        return lambda dev: fn(*on(inputs, dev), VirtualMesh(4, dev), telemetry=True, **kw)[4]

    def serve_case(dev):
        sb = serve.Superblock(16, VirtualMesh(4, dev), caps=dict(caps))
        q = serve.IngestQueue(sb, lanes=8, depth=3)
        serve_submit(q, streams)
        return q.drain(telemetry=True)[1]

    cases = {
        "mesh_fold": lambda dev: mesh_fold(on(dense[0], dev), VirtualMesh(4, dev),
                                           telemetry=True)[2],
        "mesh_gossip": lambda dev: mesh_gossip(on(dense[0], dev), VirtualMesh(4, dev),
                                               telemetry=True)[2],
        "mesh_fold_map": lambda dev: mesh_fold_map(on(cfg4[0], dev), VirtualMesh(4, dev),
                                                   telemetry=True)[2],
        "dense_ring_fused": ring_case(mesh_delta_gossip, dense, rounds=30, cap=8),
        "dense_ring_layered": ring_case(mesh_delta_gossip, dense, rounds=30, cap=8, fused=False),
        "dense_ring_acked": ring_case(mesh_delta_gossip, dense, rounds=30, cap=8,
                                      ack_window=True, pipeline=False),
        "map_ring_fused": ring_case(mesh_delta_gossip_map, cfg4, rounds=12, cap=48),
        "map_ring_layered": ring_case(mesh_delta_gossip_map, cfg4, rounds=12, cap=48,
                                      fused=False),
        "map_ring_acked": ring_case(mesh_delta_gossip_map, cfg4, rounds=12, cap=48,
                                    ack_window=True),
        "dense_stream": lambda dev: mesh_stream_fold(iter_blocks(on(dense[0], dev), 8),
                                                     VirtualMesh(4, dev), telemetry=True)[2],
        "serve_flush": serve_case,
        "fanout_dispatch": lambda dev: mesh_fanout_push(
            orswot_from_numpy(fan[0], dev), orswot_from_numpy(fan[1], dev),
            torch.as_tensor(fan[2]).to(dev), VirtualMesh(2, dev),
            weights=torch.as_tensor(fan[3]).to(dev), telemetry=True)[2],
    }
    out = {}
    for name, fn in cases.items():
        got, want = tele.to_dict(fn(device)), tele.to_dict(fn(cpu))
        diff = sorted(k for k in got if k not in HOST_TIMED and got[k] != want[k])
        check(not diff, f"telemetry_scenarios {name}: card != CPU on {diff}")
        out[name] = {k: got[k] for k in ("merges", "slots_changed", "bytes_exchanged",
                                         "bytes_useful", "wire_packed_bytes",
                                         "bytes_acked_skipped", "cohorts_per_dispatch",
                                         "delta_push_bytes", "stream_blocks", "live_tenants")
                     if got[k]}
    check(out["dense_ring_fused"]["wire_packed_bytes"] > 0
          and out["map_ring_acked"]["bytes_acked_skipped"] > 0,
          "telemetry_scenarios: the fused and acked rings counted nothing")
    res = {"phase": "telemetry_scenarios", "cases": out, "left_out": sorted(HOST_TIMED),
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# ---- phases 25-26: the sparse Map kinds (ROADMAP item 12b) ---------------

def mint_set_map_sites(rng, n_sites, n_cmds):
    """Map<K, Orswot> sites: each adds members to keys under its own actor,
    removes members inside a child and whole keys, and merges another
    site's state now and then, so later remove clocks cover other actors'
    dots (their delivery ahead of those adds parks them at either level)."""
    from crdt_tpu_torch.pure import Map, Orswot
    from crdt_tpu_torch.ctx import RmCtx
    from crdt_tpu_torch.vclock import VClock

    sites = [Map(Orswot) for _ in range(n_sites)]
    streams = [[] for _ in range(n_sites)]
    for _ in range(n_cmds):
        i = rng.randrange(n_sites)
        s = sites[i]
        roll = rng.random()
        key, member = rng.choice(MAP_KEYS), rng.choice(MEMBERS)
        if roll < 0.4 or not s.keys():
            op = s.update(key, s.len().derive_add_ctx(f"s{i}"),
                          lambda child, c: child.add(member, c))
        elif roll < 0.55:
            key = rng.choice(sorted(s.keys()))
            child = s.entries[key]
            rm_ctx = (child.contains(member).derive_rm_ctx() if member in child.entries
                      else RmCtx(clock=VClock()))
            op = s.update(key, s.len().derive_add_ctx(f"s{i}"),
                          lambda child, c: child.rm(member, rm_ctx))
        elif roll < 0.72:
            victim = rng.choice(sorted(s.keys()))
            op = s.rm(victim, s.get(victim).derive_rm_ctx())
        else:
            s.merge(sites[rng.randrange(n_sites)].clone())
            continue
        s.apply(op)
        streams[i].append(op)
    return sites, streams


def on_cpu(tree):
    from crdt_tpu_torch.ops.lattice import tree_map

    return tree_map(lambda x: x.cpu(), tree)


def phase_sparse_map_scenarios(device, seed: int, rounds: int = 4) -> dict:
    """Oracle-minted op streams through ``BatchedSparseMap`` and
    ``BatchedSparseMapOrswot`` on the card and on the CPU side by side:
    card == CPU on every leaf after every replica's ops, merges and
    folds; ``to_pure`` == the pure ``Map`` oracle; the sparse Map's fold ==
    a dense ``BatchedMap`` twin's fold (K2, counted) through ``to_pure``;
    the capacity errors."""
    import torch

    from crdt_tpu_torch.ctx import RmCtx
    from crdt_tpu_torch.dot import Dot
    from crdt_tpu_torch.models import (
        BatchedMap, BatchedSparseMap, BatchedSparseMapOrswot, DeferredOverflow,
        DotCapacityOverflow, SlotOverflow,
    )
    from crdt_tpu_torch.ops.fold_kernels import fold_cells, fold_entries
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.pure import Map, MVReg, Orswot
    from crdt_tpu_torch.pure.map import MapRm, Up
    from crdt_tpu_torch.pure.mvreg import Put
    from crdt_tpu_torch.utils import Interner
    from crdt_tpu_torch.vclock import VClock

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    rng = random.Random(seed + 25)
    counts = {"ops": 0, "merges": 0, "folds": 0, "resets": 0, "parked_seen": 0,
              "nested_ops": 0, "nested_parked_seen": 0}
    fold_entries.launches = fold_cells.launches = wire_pack.launches = 0

    def both(make):
        return make(device), make(cpu)

    def same_card_cpu(card, host, what):
        check(same_leaves(on_cpu(card.state), host.state), f"card != CPU: {what}")

    for _ in range(rounds):
        # ---- Map<K, MVReg>: the sparse model, its CPU twin, a dense twin.
        n = rng.randint(3, 5)
        sites, streams = mint_map_sites(rng, n, 24)
        names = dict(keys=Interner(MAP_KEYS), actors=Interner([f"s{i}" for i in range(n)]),
                     values=Interner(range(5)))
        clone = lambda: {k: v.clone() for k, v in names.items()}  # noqa: E731
        card, host = both(lambda dev: BatchedSparseMap(n, len(MAP_KEYS), n, cell_cap=32,
                                                       sibling_cap=n, deferred_cap=8,
                                                       device=dev, **clone()))
        dense = BatchedMap(n, len(MAP_KEYS), n, sibling_cap=n, deferred_cap=8, device=device,
                           **clone())
        replicas = [Map(MVReg) for _ in range(n)]
        for j in range(n):
            cut = [q[: rng.choice((0, len(q), rng.randint(0, len(q))))] for q in streams]
            for op in interleave(rng, cut):
                for m in (card, host, dense):
                    m.apply(j, op)
                replicas[j].apply(op)
                counts["ops"] += 1
            check(card.to_pure(j) == replicas[j] == dense.to_pure(j),
                  f"sparse map op path, replica {j}")
        # A remove ahead of every top parks on replica 0 (and replays in no
        # merge: nothing ever catches up with it).
        probe = MapRm(clock=VClock({"s0": 99}), keyset=(MAP_KEYS[0],))
        for m in (card, host, dense):
            m.apply(0, probe)
        replicas[0].apply(probe)
        counts["parked_seen"] += sum(len(x.deferred) for x in replicas)
        same_card_cpu(card, host, "sparse map op path")
        for _ in range(n):
            dst, src = rng.randrange(n), rng.randrange(n)
            replicas[dst].merge(replicas[src].clone())
            for m in (card, host, dense):
                m.merge_from(dst, src)
            counts["merges"] += 1
            check(card.to_pure(dst) == replicas[dst], "sparse map merge_from vs the oracle")
        same_card_cpu(card, host, "sparse map merges")
        clock = VClock({"s0": 2, f"s{n - 1}": 1})
        for m in (card, host, dense):
            m.reset_remove(1, clock)
        replicas[1].reset_remove(clock)
        check(card.to_pure(1) == replicas[1] == dense.to_pure(1), "sparse map reset_remove")
        counts["resets"] += 1
        expect = Map(MVReg)
        for s in replicas:
            expect.merge(s.clone())
        k2 = fold_cells.launches
        check(card.fold() == expect == dense.fold() == host.fold(),
              "sparse map fold vs the oracle, the dense fold and the CPU")
        check(device.type != "cuda" or fold_cells.launches == k2 + 1,
              "the dense twin's fold did not launch K2")
        counts["folds"] += 1

        # ---- Map<K, Orswot>: the nested sparse model and its CPU twin.
        sites, streams = mint_set_map_sites(rng, n, 24)
        names = dict(keys=Interner(MAP_KEYS), members=Interner(MEMBERS),
                     actors=Interner([f"s{i}" for i in range(n + 1)]))
        card, host = both(lambda dev: BatchedSparseMapOrswot(
            n, 8, 48, n + 1, deferred_cap=8, rm_width=8, key_deferred_cap=8, key_rm_width=4,
            device=dev, **{k: v.clone() for k, v in names.items()}))
        replicas = [Map(Orswot) for _ in range(n)]
        for j in range(n):
            cut = [q[: rng.choice((0, len(q), rng.randint(0, len(q))))] for q in streams]
            for op in interleave(rng, cut):
                card.apply(j, op)
                host.apply(j, op)
                replicas[j].apply(op)
                counts["nested_ops"] += 1
            check(card.to_pure(j) == replicas[j], f"sparse Map<K, Orswot> op path, replica {j}")
        # Removes ahead of every top park at both levels: a key remove on
        # replica 0, a member remove inside a child on replica 1 (witnessed
        # by an actor of its own, so its dot meets no other op).
        ahead = VClock({"s0": 99})
        probes = [(0, MapRm(clock=ahead, keyset=(MAP_KEYS[0],))),
                  (1, replicas[1].update(MAP_KEYS[1], replicas[1].len().derive_add_ctx(f"s{n}"),
                                         lambda child, c: child.rm(MEMBERS[0],
                                                                   RmCtx(clock=ahead))))]
        for j, probe in probes:
            card.apply(j, probe)
            host.apply(j, probe)
            replicas[j].apply(probe)
        counts["nested_parked_seen"] += sum(
            len(x.deferred) + sum(len(c.deferred) for c in x.entries.values()) for x in replicas)
        same_card_cpu(card, host, "sparse Map<K, Orswot> op path")
        for _ in range(n):
            dst, src = rng.randrange(n), rng.randrange(n)
            replicas[dst].merge(replicas[src].clone())
            card.merge_from(dst, src)
            host.merge_from(dst, src)
            check(card.to_pure(dst) == replicas[dst], "sparse Map<K, Orswot> merge_from")
        same_card_cpu(card, host, "sparse Map<K, Orswot> merges")
        expect = Map(Orswot)
        for s in replicas:
            expect.merge(s.clone())
        check(card.fold() == expect == host.fold(), "sparse Map<K, Orswot> fold vs the oracle")

    # Capacity: a full cell table, a key past the sibling cap, a full
    # parked buffer.
    small = BatchedSparseMap(1, 4, 2, cell_cap=1, device=device)
    small.apply(0, Up(dot=Dot("a", 1), key="p", op=Put(dot=Dot("a", 1),
                                                      clock=VClock({"a": 1}), val=1)))
    with expect_raises(DotCapacityOverflow):
        small.apply(0, Up(dot=Dot("b", 1), key="q", op=Put(dot=Dot("b", 1),
                                                          clock=VClock({"b": 1}), val=2)))
    pair = BatchedSparseMap(2, 4, 2, sibling_cap=1, device=device)
    for i, a in enumerate("ab"):
        pair.apply(i, Up(dot=Dot(a, 1), key="p", op=Put(dot=Dot(a, 1), clock=VClock({a: 1}),
                                                       val=i)))
    with expect_raises(SlotOverflow):
        pair.merge_from(0, 1)
    parked = BatchedSparseMap(1, 4, 2, deferred_cap=1, device=device)
    parked.apply(0, MapRm(clock=VClock({"a": 3}), keyset=("p",)))
    with expect_raises(DeferredOverflow):
        parked.apply(0, MapRm(clock=VClock({"a": 4}), keyset=("q",)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    check(counts["parked_seen"] > 0 and counts["nested_parked_seen"] > 0,
          "no sparse Map scenario parked an ahead remove")
    out = {"phase": "sparse_map_scenarios", **counts, "k1_launches": fold_entries.launches,
           "k2_launches": fold_cells.launches, "k3_launches": wire_pack.launches,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def sparse_map_population(c: int, universe: int, n_actors: int, device, seed: int = 11):
    """``bench.py`` ``bench_sparse_map``'s cells (a key uniform over
    ``universe``, an actor uniform over ``n_actors``, unique (key, actor)
    cells, a value uniform below 2^20, the write clock holding only the
    cell's own dot) as ONE master table of ``c`` cells in canonical (key,
    actor) order, cut per replica as ``bench.py`` ``_flagship_population``
    cuts: replica ``r`` holds the first ``L_r ∈ [c/2, c]`` lanes (a hash of
    r). A cell's counter is its rank among its actor's cells, so every
    replica holds a per-actor prefix of one write history, a dot carries
    the same payload on every replica, and the join is a true lattice.
    Returns ``(gen, master)``: ``gen(row_ids)`` makes a canonical
    ``SparseMVMapState [B, ...]`` on the device; ``master`` holds the
    table and the per-lane running top."""
    import numpy as np
    import torch

    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.convert import leaf_from_numpy
    from crdt_tpu_torch.ops import sparse_mvmap as smv
    from crdt_tpu_torch.ops.lattice import tree_map

    rng = np.random.default_rng(seed)
    packed = np.sort(rng.choice(universe * n_actors, size=c, replace=False).astype(np.int64))
    kids, acts = (packed // n_actors).astype(np.int32), (packed % n_actors).astype(np.int32)
    ctrs = np.zeros(c, np.uint32)
    tops = np.zeros((c, n_actors), np.uint32)
    run = np.zeros(n_actors, np.uint32)
    for i in range(c):
        run[acts[i]] += 1
        ctrs[i] = run[acts[i]]
        tops[i] = run
    vals = rng.integers(0, 1 << 20, c).astype(np.int32)
    clk = np.zeros((c, n_actors), np.uint32)
    clk[np.arange(c), acts] = ctrs
    master = {k: leaf_from_numpy(v, device) for k, v in dict(
        kid=kids, act=acts, ctr=ctrs, val=vals, clk=clk, tops=tops).items()}
    half = c // 2
    lanes = torch.arange(c, device=device)

    def cut_of(row_ids):
        return half + ((row_ids * 2654435761) & 0xFFFFFFFF) % max(c - half + 1, 1)

    def gen(row_ids):
        cut = cut_of(row_ids)
        valid = lanes[None, :] < cut[:, None]
        state = smv.empty(c, n_actors, batch=(row_ids.shape[0],), device=device)
        keep = lambda x, fill=0: torch.where(valid, bits(x), fill).view(x.dtype)  # noqa: E731
        return state._replace(
            top=bits(master["tops"])[cut - 1].view(torch.uint32),
            kid=keep(master["kid"], -1), act=keep(master["act"]), ctr=keep(master["ctr"]),
            val=keep(master["val"]),
            clk=torch.where(valid[..., None], bits(master["clk"]), 0).view(torch.uint32),
            valid=valid,
        )

    def union(n_rows: int):
        """The join of rows ``[0, n_rows)``: the row with the longest cut
        holds every other row's prefix, so it IS the union (unbatched)."""
        longest = torch.argmax(cut_of(torch.arange(n_rows, device=device)))
        return tree_map(lambda x: x[0], gen(longest[None]))

    return gen, master, union


class IdNames:
    """A name table whose every id is its own name: ``to_pure`` of a state
    over a 100M-key universe without interning 100M names."""

    def __getitem__(self, i):
        return i


def nested_population(r: int, c: int, universe: int, n_keys: int, span: int, n_actors: int,
                      device, n_parked: int = 16, n_clocks: int = 4, rm_width: int = 256,
                      key_deferred_cap: int = 4, seed: int = 13):
    """A ``Map<K, Orswot>`` population at the "sparse" config's widths:
    the flagship construction's cells (``flagship_population``) over
    ``universe`` elements laid out as ``n_keys`` keys × ``span`` members
    (element id = key · span + member), plus ``n_parked`` keyset-removes drawn as
    ``fill_config4`` draws them — parked on rows ``pos·r/n_parked``, slot
    ``pos mod 2``, over ``n_clocks`` clocks whose lane 0 runs ahead of
    every top while the others cover every dot, together listing ≈ 1% of
    the keys (a clock's four lists union within ``rm_width``). Returns
    the ``[r, ...]`` state."""
    import numpy as np
    import torch

    from crdt_tpu_torch._dtypes import bits, to_wide
    from crdt_tpu_torch.ops import sparse_nest as nest

    check(n_keys * span >= universe, "the key space does not hold the element universe")
    gen, master = flagship_population(c, universe, n_actors, device, seed=seed)
    core = gen(torch.arange(r, device=device))
    state = nest.level_map_orswot(span).empty(core, n_actors, key_deferred_cap, rm_width,
                                              batch=(r,))
    rng = np.random.default_rng(seed + 4)
    end = int(to_wide(master["ctr"]).max())
    per_list = max(1, int(0.01 * n_keys / n_parked))
    for pos in range(n_parked):
        row, slot = pos * r // n_parked, pos % min(key_deferred_cap, 2)
        clock = [end] * n_actors
        clock[0] = end + 1 + pos % n_clocks
        keys = np.sort(rng.choice(n_keys, size=per_list, replace=False)).astype(np.int32)
        bits(state.kcl)[row, slot] = torch.tensor(clock, dtype=torch.int64,
                                                  device=device).to(torch.int32)
        state.kidx[row, slot, :per_list] = torch.tensor(keys, device=device)
        state.kdvalid[row, slot] = True
    return state


def phase_full_width_sparse_map(device, seed: int, r: int = 256, cells: int = 2048,
                                universe: int = 100_000_000, a: int = 8, siblings: int = 8,
                                p: int = 8, stream_r: int = 10240, block_rows: int = 256,
                                passes: int = 5, sp_r: int = 256, sp_cap: int = 4096,
                                sp_universe: int = 1_000_000, sp_keys: int = 65536,
                                sp_span: int = 16, profile_blocks: int = 10) -> dict:
    """The sparse Map kinds at full width (ROADMAP item 12b). (a)
    ``BENCH_CONFIGS.json`` "sparse_map" uncut — R = 256, cell cap 2,048, a
    100M-key universe, sibling cap 8, A = 8, D = 4, rm width 8 — through
    ``mesh_fold_sparse_mvmap`` on P = 8 and ``BatchedSparseMap.fold()``;
    gates before any number: the mesh fold == a left chain of joins on
    every leaf, ``split_cells`` of it == the key-sharded fold on
    ``VirtualMesh(8, s=2)``, == the master table's union, K1–K3 launched
    0 times. (b) the same widths at the flagship's population, 10,240
    replicas in 40 blocks of 256, through ``mesh_stream_fold_sparse_mvmap``
    (gate: == the union). (c) ``BatchedSparseMapOrswot`` at the "sparse"
    config's widths (R = 256, dot cap 4,096, A = 8; 1M elements as 65,536
    keys × span 16, 16 parked keyset-removes): ``mesh_fold_sparse_nested``
    on P = 8 and ``mesh_fold_sparse_map`` on ``VirtualMesh(8, s=2)``; gate:
    sharded == ``split_nested`` of unsharded, both == the join chain
    (cells bit for bit, parked removes as sets: their slot order follows
    the join order). (d) the flagship population through
    ``mesh_stream_fold_sparse_sharded`` at S = 2; gate: ==
    ``split_segments`` of the unsharded stream's result."""
    import numpy as np
    import torch

    from crdt_tpu_torch.models import BatchedSparseMap
    from crdt_tpu_torch.ops import sparse_mvmap as smv
    from crdt_tpu_torch.ops import sparse_nest as nest
    from crdt_tpu_torch.ops.fold_kernels import fold_cells, fold_entries
    from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import (
        VirtualMesh, mesh_fold_sparse_map, mesh_fold_sparse_mvmap,
        mesh_fold_sparse_mvmap_sharded, mesh_fold_sparse_nested, mesh_stream_fold_sparse,
        mesh_stream_fold_sparse_mvmap, mesh_stream_fold_sparse_sharded, split_cells,
        split_nested, split_segments,
    )
    from crdt_tpu_torch.utils.metrics import metrics

    del seed  # the populations carry their own seeds (11, 13), as bench.py's do
    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    mesh, smesh = VirtualMesh(p, device), VirtualMesh(p, device, s=2)
    row = lambda st, i: tree_map(lambda x: x[i], st)  # noqa: E731
    one = lambda st: tree_map(lambda x: x[None], st)  # noqa: E731

    def chain(states, join):
        acc, flagged = row(states, 0), False
        for i in range(1, tree_leaves(states)[0].shape[0]):
            acc, f = join(acc, row(states, i))
            flagged = flagged or bool(f.any())
        return acc, flagged

    # ---- (a) "sparse_map" uncut ------------------------------------------
    gen, master, union = sparse_map_population(cells, universe, a, device)
    states = gen(torch.arange(r, device=device))
    state_bytes = smv.nbytes(states)
    fold_entries.launches = fold_cells.launches = wire_pack.launches = 0
    folded, of = mesh_fold_sparse_mvmap(states, mesh, sibling_cap=siblings)
    launches = {"k1": fold_entries.launches, "k2": fold_cells.launches, "k3": wire_pack.launches}
    sync()
    join = lambda x, y: smv.join(x, y, sibling_cap=siblings)  # noqa: E731
    t0 = time.perf_counter()
    chained, chain_of = chain(states, join)
    sync()
    chain_ms = (time.perf_counter() - t0) * 1e3
    sharded, sh_of = mesh_fold_sparse_mvmap_sharded(split_cells(states, 2), smesh,
                                                    sibling_cap=siblings)
    model = BatchedSparseMap(r, universe, a, cells, siblings, 4, 8, keys=IdNames(),
                             actors=IdNames(), values=IdNames(), device=device)
    model.state = states
    want = union(r)
    gates = {
        "no_overflow": not bool(of.any()) and not chain_of and not bool(sh_of.any()),
        "mesh_fold_equals_join_chain": same_leaves(folded, chained),
        "split_cells_equals_sharded_fold": same_leaves(row(split_cells(one(folded), 2), 0),
                                                       sharded),
        "equals_master_union": same_leaves(folded, want),
        "model_fold_equals_master_union": model.fold() == model._pure_of(want),
        "k1_k2_k3_launched_0": launches == {"k1": 0, "k2": 0, "k3": 0},
    }
    check(all(gates.values()), f"sparse_map gates failed: {gates}")
    fold_runs = [time_ms(lambda: mesh_fold_sparse_mvmap(states, mesh, sibling_cap=siblings),
                         device) for _ in range(passes)]
    ops_runs = [time_ms(lambda: smv.fold(states, sibling_cap=siblings), device)
                for _ in range(passes)]
    model_runs = [time_ms(model.fold, device) for _ in range(3)]
    busy = profile_busy(lambda: mesh_fold_sparse_mvmap(states, mesh, sibling_cap=siblings),
                        device)
    med = statistics.median(fold_runs)
    sparse_map = {
        "R": r, "cell_cap": cells, "universe": universe, "A": a, "sibling_cap": siblings,
        "D": 4, "Q": 8, "P": p, "gates": gates, "live_cells": int(folded.valid.sum()),
        "state_bytes": state_bytes, "per_replica_bytes": state_bytes // r,
        "launches": launches,
        "mesh_fold_ms_median": med, "mesh_fold_ms_runs": fold_runs,
        "merges_per_s": (r - 1) / (med * 1e-3),
        "ops_fold_ms_median": statistics.median(ops_runs),
        "model_fold_ms_median": statistics.median(model_runs),
        "join_chain_ms": chain_ms, "profile": busy,
        "busy_share": busy["busy_share"] if busy else None,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
    }
    del states, folded, chained, sharded, model

    # ---- (b) the same widths at the flagship's population ---------------
    n_blocks = -(-stream_r // block_rows)
    r_run = n_blocks * block_rows

    def blocks():
        for b in range(n_blocks):
            yield gen(torch.arange(b * block_rows, (b + 1) * block_rows, device=device))

    staged0 = metrics.snapshot()["counters"].get("stream.staged_bytes", 0)
    acc, acc_of = mesh_stream_fold_sparse_mvmap(blocks(), mesh, sibling_cap=siblings)
    staged = metrics.snapshot()["counters"].get("stream.staged_bytes", 0) - staged0
    check(not bool(acc_of.any()) and same_leaves(acc, union(r_run)),
          "the sparse_map stream did not converge to the master union")
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    stream_runs = [time_ms(lambda: mesh_stream_fold_sparse_mvmap(blocks(), mesh,
                                                                 sibling_cap=siblings), device)
                   for _ in range(passes)]
    stream_busy = profile_busy(lambda: mesh_stream_fold_sparse_mvmap(
        itertools.islice(blocks(), profile_blocks), mesh, sibling_cap=siblings), device)
    smed = statistics.median(stream_runs)
    stream = {
        "R": r_run, "block_rows": block_rows, "blocks": n_blocks, "staged_bytes": staged,
        "stream_ms_median": smed, "stream_ms_runs": stream_runs,
        "merges_per_s": (r_run - 1) / (smed * 1e-3), "live_cells": int(acc.valid.sum()),
        "profiled_blocks": profile_blocks, "profile": stream_busy,
        "busy_share": stream_busy["busy_share"] if stream_busy else None,
        "launch_kernel_calls_per_block":
            stream_busy["launch_kernel_calls"] / profile_blocks if stream_busy else None,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
    }
    del acc

    # ---- (c) Map<K, Orswot> at the "sparse" config's widths --------------
    nstates = nested_population(sp_r, sp_cap, sp_universe, sp_keys, sp_span, a, device)
    level = nest.level_map_orswot(sp_span)
    t0 = time.perf_counter()
    unsharded, u_of = mesh_fold_sparse_nested(nstates, mesh, level)
    sync()
    nested_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    nsharded, s_of = mesh_fold_sparse_map(split_nested(nstates, 2), smesh, sp_span)
    sync()
    map_ms = (time.perf_counter() - t0) * 1e3
    nchained, n_chain_of = chain(nstates, level.join)
    ngates = {
        "no_overflow": not bool(u_of.any()) and not bool(s_of.any()) and not n_chain_of,
        "sharded_equals_split_of_unsharded": same_leaves(
            row(split_nested(one(unsharded), 2), 0), nsharded),
        "cells_equal_join_chain": same_leaves(unsharded.core, nchained.core),
        "parked_removes_equal_join_chain": nested_parked(unsharded) == nested_parked(nchained),
        "parked_removes_survive": bool(unsharded.kdvalid.any()),
    }
    check(all(ngates.values()), f"sparse Map<K, Orswot> gates failed: {ngates}")
    nested = {
        "R": sp_r, "dot_cap": sp_cap, "universe": sp_universe, "keys": sp_keys,
        "span": sp_span, "A": a, "key_deferred_cap": 4, "key_rm_width": 256,
        "parked_keyset_removes": 16, "gates": ngates,
        "live_cells": int(unsharded.core.valid.sum()),
        "parked_slots": int(unsharded.kdvalid.sum()),
        "state_bytes": sum(x.numel() * x.element_size() for x in tree_leaves(nstates)),
        "mesh_fold_sparse_nested_ms_first": nested_ms,
        "mesh_fold_sparse_map_ms_first": map_ms,
        "mesh_fold_sparse_nested_ms_median": statistics.median(
            [time_ms(lambda: mesh_fold_sparse_nested(nstates, mesh, level), device)
             for _ in range(3)]),
        "mesh_fold_sparse_map_ms_median": statistics.median(
            [time_ms(lambda: mesh_fold_sparse_map(split_nested(nstates, 2), smesh, sp_span),
                     device) for _ in range(3)]),
    }
    del nstates, unsharded, nsharded, nchained

    # ---- (d) the flagship population, element-sharded at S = 2 -----------
    fgen, _ = flagship_population(sp_cap, sp_universe, a, device)
    f_blocks = -(-stream_r // block_rows)

    def flat_blocks():
        for b in range(f_blocks):
            yield fgen(torch.arange(b * block_rows, (b + 1) * block_rows, device=device))

    def sharded_blocks():
        for block in flat_blocks():
            yield split_segments(block, 2)

    flat, f_of = mesh_stream_fold_sparse(flat_blocks(), mesh)
    t0 = time.perf_counter()
    acc_sh, sh_of = mesh_stream_fold_sparse_sharded(sharded_blocks(), smesh)
    sync()
    sh_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(f_of.any()) and not bool(sh_of.any())
          and same_leaves(acc_sh, row(split_segments(one(flat), 2), 0)),
          "the sharded flagship stream differs from split_segments of the unsharded one")
    flagship_sharded = {
        "R": f_blocks * block_rows, "S": 2, "blocks": f_blocks, "stream_ms": sh_ms,
        "live_cells_per_shard": acc_sh.valid.sum(dim=-1).tolist(),
        "note": "one pass, its blocks split by split_segments on the card as they arrive",
    }
    out = {
        "phase": "full_width_sparse_map", "sparse_map": sparse_map, "stream": stream,
        "nested": nested, "flagship_sharded": flagship_sharded,
        "reduced": "uncut widths; (a)/(b) cells: bench.py bench_sparse_map's key, actor and "
                   "value draws as one master table cut per replica (the flagship rule), "
                   "counters the per-actor rank (bench draws 1..99 per replica), so one dot "
                   "carries one payload on every replica and the join is a true lattice; (c) "
                   "key lists 256 wide so a clock's four fill_config4 lists union in one slot",
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


# ---- phases 27-29: nested composition (ROADMAP item 13) -------------------

NEST_KINDS = ("map_orswot", "map_map", "map3")
NEST_KEYS1, NEST_KEYS2, NEST_MEMBERS = list("pqr"), list("uv"), list("xyz")
NEST_ACTORS = ["s0", "s1", "s2", "A", "B", "C"]
NEST_D = 6  # parked slots at every level


def nest_factory(kind: str):
    """The pure oracle's empty value of a nested ``kind``."""
    from crdt_tpu_torch.pure import Map, MVReg, Orswot

    return {"map_orswot": lambda: Map(Orswot), "map_map": lambda: Map(lambda: Map(MVReg)),
            "map3": lambda: Map(lambda: Map(Orswot))}[kind]()


def nest_update(m, actor, path, leaf):
    """``Op::Up`` through every key of ``path`` with ONE AddCtx (one dot at
    every level), ``leaf(child, ctx)`` minting the op at the bottom;
    applied at ``m`` and returned."""
    ctx = m.len().derive_add_ctx(actor)

    def down(i):
        if i == len(path) - 1:
            return leaf
        return lambda child, c: child.update(path[i + 1], c, down(i + 1))

    op = m.update(path[0], ctx, down(0))
    m.apply(op)
    return op


def nest_rm_ctx(m, path, member=None):
    """The remove context of ``member`` (or of the last key of ``path``)
    as site ``m`` sees it — empty where the target does not exist."""
    from crdt_tpu_torch.ctx import RmCtx
    from crdt_tpu_torch.vclock import VClock

    node = m
    for k in path[:-1] if member is None else path:
        node = node.entries.get(k)
        if node is None:
            return RmCtx(clock=VClock())
    if member is None:
        return node.get(path[-1]).derive_rm_ctx()
    if member not in node.entries:
        return RmCtx(clock=VClock())
    return node.contains(member).derive_rm_ctx()


def nest_add(kind, m, actor, k1, k2, x):
    """The kind's add or put at (k1[, k2]) of member or value ``x``."""
    if kind == "map_map":
        return nest_update(m, actor, [k1, k2], lambda reg, c: reg.write(x, c))
    path = [k1] if kind == "map_orswot" else [k1, k2]
    return nest_update(m, actor, path, lambda s, c: s.add(x, c))


def nest_inner_rm(kind, m, actor, k1, k2, member):
    """A remove one level down (a member remove inside a child; an inner
    keyset remove)."""
    if kind == "map_map":
        ctx = nest_rm_ctx(m, [k1, k2])
        return nest_update(m, actor, [k1], lambda child, c: child.rm(k2, ctx))
    path = [k1] if kind == "map_orswot" else [k1, k2]
    ctx = nest_rm_ctx(m, path, member)
    return nest_update(m, actor, path, lambda s, c: s.rm(member, ctx))


def nest_drop2(m, actor, k1, k2):
    """``Map3``'s middle keyset remove of k2 inside the k1 child."""
    ctx = nest_rm_ctx(m, [k1, k2])
    return nest_update(m, actor, [k1], lambda child, c: child.rm(k2, ctx))


def nest_drop1(m, k1):
    op = m.rm(k1, m.get(k1).derive_rm_ctx())
    m.apply(op)
    return op


def mint_nest_sites(kind: str, rng, n_cmds: int, n_sites: int = 3):
    """Per-site op streams of a nested ``kind`` (adds or puts, removes one
    level down, middle and outer keyset removes), each site minting under
    its own actor and often merging another site's state first, so its
    remove clocks cover other actors' dots."""
    sites = [nest_factory(kind) for _ in range(n_sites)]
    streams = [[] for _ in range(n_sites)]
    for step in range(n_cmds):
        i = rng.randrange(n_sites)
        s, actor = sites[i], NEST_ACTORS[i]
        k1, k2, m = rng.choice(NEST_KEYS1), rng.choice(NEST_KEYS2), rng.choice(NEST_MEMBERS)
        live = sorted(s.entries)
        if live:
            k1 = rng.choice(live)
            k2 = rng.choice(sorted(s.entries[k1].entries) or NEST_KEYS2)
        x = step % 6 if kind == "map_map" else m
        roll = rng.random()
        if roll < 0.4 or not live:
            op = nest_add(kind, s, actor, rng.choice(NEST_KEYS1) if not live else k1, k2, x)
        elif roll < 0.55:
            op = nest_inner_rm(kind, s, actor, k1, k2, m)
        elif roll < 0.62 and kind == "map3":
            op = nest_drop2(s, actor, k1, k2)
        elif roll < 0.72:
            op = nest_drop1(s, k1)
        else:
            s.merge(sites[rng.randrange(n_sites)].clone())
            continue
        streams[i].append(op)
    return streams


def nest_parked_streams(kind: str):
    """Streams of sites "A", "B", "C" that park a remove at EVERY level of
    ``kind`` on a replica that takes A's and B's ops but not C's: B merges
    C and removes C's content one level down (and, in ``map3``, two) and
    at the outer level, while A's add keeps the enclosing children alive
    (a parked remove inside a bottomed child is scrubbed with it).
    Returns ``(streams, replica)``."""
    a, b, c = (nest_factory(kind) for _ in range(3))
    sc = [nest_add(kind, c, "C", "r", "u", 1 if kind == "map_map" else "z"),
          nest_add(kind, c, "C", "q", "v", 2 if kind == "map_map" else "y")]
    if kind == "map3":
        sc.append(nest_add(kind, c, "C", "r", "v", "x"))
    sa = [nest_add(kind, a, "A", "r", "v" if kind == "map_map" else "u",
                   3 if kind == "map_map" else "x")]
    b.merge(c.clone())
    sb = [nest_inner_rm(kind, b, "B", "r", "u", "z")]
    if kind == "map3":
        sb.append(nest_drop2(b, "B", "r", "v"))
    sb.append(nest_drop1(b, "q"))
    rep = nest_factory(kind)
    for op in sa + sb:
        rep.apply(op)
    return [sa, sb, sc], rep


def nest_population(kind: str, rng, n: int, n_cmds: int = 24):
    """``n`` oracle replicas: ``n - 1`` hold random per-site prefixes of
    minted streams in their own interleavings (ahead removes park), one
    (at a random position) parks a remove at every level. Returns
    ``(replicas, streams)``."""
    streams = mint_nest_sites(kind, rng, n_cmds)
    reps = []
    for _ in range(n - 1):
        rep = nest_factory(kind)
        cut = [q[: rng.choice((0, len(q), rng.randint(0, len(q))))] for q in streams]
        for op in interleave(rng, cut):
            rep.apply(op)
        reps.append(rep)
    scripted, parked = nest_parked_streams(kind)
    reps.insert(rng.randrange(n), parked)
    return reps, streams + scripted


def nest_model(kind: str, pures, device, **caps):
    """The nested ``kind``'s batched model of ``pures`` on ``device``, with
    fixed interners."""
    from crdt_tpu_torch.models import BatchedMap3, BatchedMapOrswot, BatchedNestedMap
    from crdt_tpu_torch.utils import Interner

    kw = dict(deferred_cap=NEST_D, actors=Interner(NEST_ACTORS), device=device, **caps)
    if kind == "map_orswot":
        return BatchedMapOrswot.from_pure(pures, keys=Interner(NEST_KEYS1),
                                          members=Interner(NEST_MEMBERS), **kw)
    if kind == "map_map":
        return BatchedNestedMap.from_pure(pures, sibling_cap=6, keys1=Interner(NEST_KEYS1),
                                          keys2=Interner(NEST_KEYS2), values=Interner(range(6)),
                                          **kw)
    return BatchedMap3.from_pure(pures, keys1=Interner(NEST_KEYS1), keys2=Interner(NEST_KEYS2),
                                 members=Interner(NEST_MEMBERS), **kw)


def nest_ops(kind: str):
    from crdt_tpu_torch.ops import map3, map_map, map_orswot

    return {"map_orswot": map_orswot, "map_map": map_map, "map3": map3}[kind]


def nest_parked_levels(state) -> list:
    """Valid parked slots of a dense nest per level, innermost first."""
    if not hasattr(state, "_fields"):
        return []
    if not hasattr(state[0], "_fields"):  # the leaf: its first field is a tensor
        return [int(state.dvalid.sum())]
    return nest_parked_levels(state[0]) + [int(state[3].sum())]


def nest_in_clock_order(state):
    """A dense nest (any depth, any leading axes) with every level's
    parked slots in clock order."""
    if not hasattr(state[0], "_fields"):  # the leaf
        return parked_in_clock_order(state)
    return type(state)(nest_in_clock_order(state[0]), *slots_in_clock_order(*state[1:]))


def nest_rows_equal_fold(rows, folded) -> bool:
    """Every rank's converged row of a nest equals the folded state, every
    level's parked slots in clock order."""
    from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map

    one = nest_in_clock_order(tree_map(lambda x: x[None], folded))
    rows = nest_in_clock_order(rows)
    p = tree_leaves(rows)[0].shape[0]
    return all(same_leaves(tree_map(lambda x: x[q], rows), tree_map(lambda x: x[0], one))
               for q in range(p))


def _leaf_counter(kind: str):
    from crdt_tpu_torch.ops.fold_kernels import fold_cells, fold_entries

    return fold_cells if kind == "map_map" else fold_entries


def phase_nested_scenarios(device, seed: int, n: int = 6, rounds: int = 2) -> dict:
    """Small probes of every nested kind, on the card and on the CPU side
    by side: seeded op streams with removes parked at every level, through
    ``apply`` (card == CPU on every leaf; ``to_pure`` == the oracle),
    ``merge_from`` and ``fold()`` (the fused level fold: K1 on the leaf of
    ``Map<K, Orswot>`` and ``Map3``, K2 on the leaf of ``Map<K1, Map<K2,
    MVReg>>``, counted; == the oracle's merge); the fused fold on the card
    == its plain route on the CPU bit for bit == the tree fold with every
    level's parked slots in clock order. Then depth 4, a level around
    ``Map3`` built from the generic step alone, the same gates."""
    import torch

    from crdt_tpu_torch.ops import fold_kernels as fk
    from crdt_tpu_torch.ops import map3 as m3_ops
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.ops.nest import NestLevel

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    rng = random.Random(seed + 27)
    out = {"phase": "nested_scenarios"}
    for kind in NEST_KINDS:
        ops_mod, counter = nest_ops(kind), _leaf_counter(kind)
        counts = {"ops": 0, "merges": 0, "folds": 0, "launches": 0,
                  "parked_per_level": None}
        for _ in range(rounds):
            pures, streams = nest_population(kind, rng, n)
            card, host = nest_model(kind, pures, device), nest_model(kind, pures, cpu)
            check(same_leaves(on_cpu(card.state), host.state), f"{kind}: from_pure card != CPU")
            levels = nest_parked_levels(host.state)
            counts["parked_per_level"] = (levels if counts["parked_per_level"] is None else
                                          [x + y for x, y in zip(counts["parked_per_level"],
                                                                 levels)])
            # The op path: fresh replicas, each a random cut of the streams.
            fresh = [nest_factory(kind) for _ in range(n)]
            cards, hosts = nest_model(kind, fresh, device), nest_model(kind, fresh, cpu)
            oracles = [nest_factory(kind) for _ in range(n)]
            for j in range(n):
                cut = [q[: rng.choice((0, len(q), rng.randint(0, len(q))))] for q in streams]
                for op in interleave(rng, cut):
                    cards.apply(j, op)
                    hosts.apply(j, op)
                    oracles[j].apply(op)
                    counts["ops"] += 1
                check(cards.to_pure(j) == oracles[j], f"{kind} op path, replica {j}")
            check(same_leaves(on_cpu(cards.state), hosts.state), f"{kind} op path: card != CPU")
            # Merges, then folds of the populated batch.
            for _ in range(n):
                dst, src = rng.randrange(n), rng.randrange(n)
                pures[dst] = pures[dst].clone()
                pures[dst].merge(pures[src].clone())
                card.merge_from(dst, src)
                host.merge_from(dst, src)
                counts["merges"] += 1
                check(card.to_pure(dst) == pures[dst], f"{kind} merge_from vs the oracle")
            check(same_leaves(on_cpu(card.state), host.state), f"{kind} merges: card != CPU")
            expect = nest_factory(kind)
            for x in pures:
                expect.merge(x.clone())
            before = counter.launches
            got = card.fold()
            check(device.type != "cuda" or counter.launches == before + 1,
                  f"{kind}: fold() launched its leaf kernel {counter.launches - before} times")
            counts["launches"] += counter.launches - before
            check(got == expect == host.fold(), f"{kind} fold() vs the oracle and the CPU")
            fused, fflags = ops_mod.fold(card.state)
            plain, pflags = fk.fold_fused_level(ops_mod.LEVEL, host.state)
            tree, tflags = ops_mod.fold(host.state, prefer="tree")
            check(same_leaves(on_cpu(fused), plain), f"{kind}: fused fold card != plain route")
            check(same_leaves(nest_in_clock_order(plain), nest_in_clock_order(tree)),
                  f"{kind}: fused fold != tree fold (parked slots in clock order)")
            check(torch.equal(fflags.cpu(), pflags) and torch.equal(pflags, tflags),
                  f"{kind}: fold flags differ")
            counts["folds"] += 2
        check(all(x > 0 for x in counts["parked_per_level"]),
              f"{kind}: no parked remove at some level {counts['parked_per_level']}")
        out[kind] = counts

    # Depth 4: one more generic level around Map3 (outer keys = K1's, one
    # each), with removes parked at the new level on every replica.
    level4 = NestLevel(m3_ops.LEVEL)
    pures, _ = nest_population("map3", rng, n)
    counter = _leaf_counter("map3")
    states = {}
    for dev in (device, cpu):
        inner = nest_model("map3", pures, dev).state
        st = level4.empty(inner, len(NEST_KEYS1), len(NEST_ACTORS), NEST_D, batch=(n,))
        for k, lane in enumerate((0, 3)):
            clock = [0] * len(NEST_ACTORS)
            clock[lane] = 99 + k
            mask = torch.tensor([j == k for j in range(len(NEST_KEYS1))])
            st, of = level4.rm_parked(st, clock, mask)
            check(not bool(of.any()), "depth 4: the outer buffer overflowed")
        states[dev.type] = st
    check(same_leaves(on_cpu(states[device.type]), states["cpu"]), "depth 4: card != CPU")
    before = counter.launches
    fused, fflags = fk.fold_auto_level(level4, states[device.type])
    check(device.type != "cuda" or counter.launches == before + 1,
          "depth 4: the fused level fold did not launch K1 once")
    tree, tflags = level4.fold(states["cpu"])
    check(same_leaves(nest_in_clock_order(on_cpu(fused)), nest_in_clock_order(tree)),
          "depth 4: fused fold != tree fold")
    check(torch.equal(fflags.cpu(), tflags) and fflags.shape == (4,), "depth 4: flags differ")
    check(int(tree[3].sum()) == 2, "depth 4: the outer removes vanished")
    out["depth4"] = {"replicas": n, "levels": 4, "parked_per_level": nest_parked_levels(tree)}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---- full-width nests ---------------------------------------------------------------

def fill_outer_level(level_state, n_keys: int, seed: int, n_parked: int = 16,
                     n_clocks: int = 4, p_key: float = 0.01, ahead: int = 1_000_000,
                     keys=None):
    """Outer parked keyset-removes into one nest level's buffer, in place:
    ``n_parked`` replicas (spread over the batch) each park one of
    ``n_clocks`` distinct clocks — lane 0 ahead of every top, the other
    lanes zero — over ~``p_key`` of the level's keys (or, with ``keys``,
    the one key ``keys[i % len(keys)]`` each). The fold's epilogue
    dedupes, replays (killing lane 0's covered dots on the masked keys)
    and keeps ``n_clocks`` slots."""
    import torch

    from crdt_tpu_torch._dtypes import bits

    dcl, dkeys, dvalid = level_state[1], level_state[2], level_state[3]
    r, d = dvalid.shape
    dev = dvalid.device
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    pos = torch.arange(n_parked, device=dev)
    rows, slots = pos * r // n_parked, pos % min(d, 2)
    clocks = torch.zeros((n_clocks, dcl.shape[-1]), dtype=torch.int32, device=dev)
    clocks[:, 0] = ahead + torch.arange(n_clocks, device=dev, dtype=torch.int32)
    bits(dcl)[rows, slots] = clocks[pos % n_clocks]
    dvalid[rows, slots] = True
    if keys is None:
        dkeys[rows, slots] = torch.rand((n_parked, n_keys), generator=gen, device=dev) < p_key
    else:
        pick = torch.tensor(keys, device=dev)[pos % len(keys)]
        dkeys[rows, slots] = torch.arange(n_keys, device=dev) == pick[:, None]


def nest_plain_fold(level, states, chunk: int):
    """The plain route of the fused level fold on the same device: the
    leaf kernel's plain version (K1's in ``chunk``-replica chunks joined
    in turn, or K2's on the decoded cells), then the same epilogue."""
    from crdt_tpu_torch._dtypes import from_wide, to_wide
    from crdt_tpu_torch.ops import fold_kernels as fk
    from crdt_tpu_torch.ops.orswot import DTYPE, OrswotState, _join_entries

    _, leaf = fk._level_chain(level, states)
    if isinstance(leaf, OrswotState):
        r = leaf.top.shape[0]
        acc = None
        for lo in range(0, r, chunk):
            pt, pc = fk.fold_entries_plain(leaf.top[lo:lo + chunk], leaf.ctr[lo:lo + chunk])
            part = (to_wide(pt), to_wide(pc))
            acc = part if acc is None else _join_entries(*acc, *part)
        top, ctr = from_wide(acc[0], DTYPE), from_wide(acc[1], DTYPE)
        folded, of = fk.settle_folded(top, ctr, leaf)
        kernel = (top, ctr)
    else:
        top, w = fk.fold_cells_plain(leaf.top, fk.decode_cells(leaf))
        folded, of = fk.settle_folded_map(top, w, leaf)
        kernel = (top, w)
    return fk.settle_levels(level, states, folded, of), kernel


def full_width_nest_leg(kind: str, model, level, device, chunk: int, repeats: int,
                        oracle_rows=None) -> dict:
    """One full-width nest, filled: the main path counted (``fold()`` for
    the orswot-leaf kinds, which reads the converged state back through
    ``to_pure``; ``ops.map_map.fold`` for the MVReg leaf at 1M keys), the
    gate (the fused fold == the plain route on the card, every leaf), the
    leaf kernel alone (CUDA events, median), the epilogue by level, the
    oracle on a replica subsample (``oracle_rows``) and peak memory."""
    import torch

    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.ops import fold_kernels as fk
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.ops.orswot import OrswotState

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    ops_mod, counter = nest_ops(kind), _leaf_counter(kind)
    st = model.state
    _, leaf = fk._level_chain(level, st)
    orswot_leaf = isinstance(leaf, OrswotState)
    counter.launches = 0
    t0 = time.perf_counter()
    if orswot_leaf:
        converged = model.fold()
    else:
        ops_mod.fold(st)
    sync()
    fold_e2e_ms = (time.perf_counter() - t0) * 1e3
    launches = counter.launches
    check(not on_card or launches == 1, f"{kind}: the fold launched its leaf kernel {launches} "
                                        f"times")
    fused, fflags = ops_mod.fold(st, prefer="fused")
    plain = {}
    plain_ms = time_ms(lambda: plain.update(zip(("state", "kernel"), nest_plain_fold(level, st,
                                                                                    chunk))),
                       device)
    (want, wflags), kernel_plain = plain["state"], plain["kernel"]
    check(same_leaves(fused, want) and torch.equal(fflags, wflags),
          f"{kind}: the fused level fold differs from its plain route")
    check(not bool(fflags.any()), f"{kind}: unexpected overflow at full width {fflags.tolist()}")
    levels = nest_parked_levels(tree_map(lambda x: x[None], fused))
    if orswot_leaf:
        ktimes = [time_ms(lambda: fk.fold_entries(leaf.top, leaf.ctr), device)
                  for _ in range(repeats)]
        k_out = fk.fold_entries(leaf.top, leaf.ctr)
        cells = None
    else:
        cells = fk.decode_cells(leaf)
        ktimes = [time_each(lambda: fk.fold_cells(leaf.top, cells), device, 20)
                  for _ in range(repeats)]
        k_out = fk.fold_cells(leaf.top, cells)
    diff = max(max_abs_diff(k_out[0], kernel_plain[0]), max_abs_diff(k_out[1], kernel_plain[1]))
    check(diff == 0, f"{kind}: the leaf kernel disagrees with its plain version (max {diff})")
    # The epilogue by level: the leaf's settle, then the wrapper levels'.
    if orswot_leaf:
        leaf_ms = time_ms(lambda: fk.settle_folded(k_out[0], k_out[1], leaf), device)
        settled, of = fk.settle_folded(k_out[0], k_out[1], leaf)
    else:
        leaf_ms = time_ms(lambda: fk.settle_folded_map(k_out[0], k_out[1], leaf), device)
        settled, of = fk.settle_folded_map(k_out[0], k_out[1], leaf)
    outer_ms = time_ms(lambda: fk.settle_levels(level, st, settled, of), device)
    fused_ms = time_ms(lambda: ops_mod.fold(st, prefer="fused"), device)
    out = {
        "leaf_kernel": "K1" if orswot_leaf else "K2",
        "leaf_kernel_ms_median": statistics.median(ktimes), "leaf_kernel_ms_runs": ktimes,
        "leaf_kernel_launches_in_fold": launches, "max_abs_err": diff,
        "plain_route_ms": plain_ms,
        "epilogue_leaf_ms": leaf_ms, "epilogue_outer_levels_ms": outer_ms,
        "fold_fused_level_ms": fused_ms,
        "fold_e2e_ms": fold_e2e_ms,
        "fold_e2e_includes_to_pure": orswot_leaf,
        "converged_parked_per_level": levels,
        "gates": {"fused_equals_plain_route": True, "no_overflow": True},
    }
    if orswot_leaf:
        out["converged_keys"] = len(converged.entries)
        check(len(converged.deferred) > 0, f"{kind}: the outer parked removes did not survive")
    if oracle_rows is not None:
        # The oracle on a replica subsample: the fused fold of those rows
        # (one more counted launch) == the pure merge of their to_pure.
        sub = tree_map(lambda x: bits(x)[oracle_rows].view(x.dtype), st)
        t0 = time.perf_counter()
        expect = None
        for i in oracle_rows.tolist():
            p = model.to_pure(i)
            if expect is None:
                expect = p
            else:
                expect.merge(p)
        got, gof = ops_mod.fold(sub, prefer="fused")
        check(not bool(gof.any()) and model._pure_of(got) == expect,
              f"{kind}: the subsample's fused fold differs from the oracle's merge")
        out["oracle_subsample_rows"] = len(oracle_rows)
        out["oracle_subsample_s"] = time.perf_counter() - t0
        out["gates"]["subsample_equals_oracle"] = True
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None
    del fused, want, k_out, cells
    return out


def phase_full_width_nested(device, seed: int, r: int = 10240, k: int = 400, m: int = 256,
                            a: int = 8, d: int = 4, r3: int = 2048, k1: int = 16, k2: int = 25,
                            map_r=(8, 64), map_k1: int = 1000, map_k2: int = 1000,
                            map_s: int = 2, map_a: int = 4, chunk: int = 512,
                            map_chunk: int = 1 << 17, repeats: int = 5,
                            oracle_rows: int = 6) -> dict:
    """The nested kinds at full width. (a) ``Map<K, Orswot>`` at config 3's
    widths factored into keys × members (K = 400 × M = 256 = E 102,400,
    A = 8, D = 4 leaf slots, 4 outer keyset slots) at R = 10,240 through
    ``BatchedMapOrswot.fold()``: K1 once, the fused fold == the plain
    route (K1's plain version in 512-replica chunks + the same epilogue),
    the subsample oracle. (b) ``Map3`` at the same widths (K1 16 × K2 25 ×
    M 256) at R = 2,048: two ``settle_outer`` levels. (c) ``Map<K1, Map<K2,
    MVReg>>`` at config 4's widths (1,000 × 1,000 keys, S = 2, A = 4, D =
    4) at R = 8 and 64, every replica settled: K2 once a fold, ==
    ``fold_cells_plain`` + the epilogue, and a dense ``BatchedMap`` twin's
    K2 fold + the outer level == the nest's tree fold."""
    import types

    import torch

    from crdt_tpu_torch.models import BatchedMap3, BatchedMapOrswot, BatchedNestedMap
    from crdt_tpu_torch.ops import fold_kernels as fk
    from crdt_tpu_torch.ops import map as map_ops
    from crdt_tpu_torch.ops import map3 as m3_ops
    from crdt_tpu_torch.ops import map_map as mm_ops
    from crdt_tpu_torch.ops import map_orswot as mo_ops
    from crdt_tpu_torch.utils import Interner

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    names = dict(actors=Interner(f"a{i}" for i in range(a)))
    out = {"phase": "full_width_nested"}

    def fresh():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)

    # (a) Map<K, Orswot>.
    fresh()
    t0 = time.perf_counter()
    model = BatchedMapOrswot(r, k, m, a, d, keys=Interner(range(k)), members=Interner(range(m)),
                             device=device, **names)
    fill_config3(types.SimpleNamespace(state=model.state.core), seed, chunk)
    fill_outer_level(model.state, k, seed)
    sync()
    setup_s = time.perf_counter() - t0
    rows = torch.linspace(0, r - 1, oracle_rows, device=device).long()
    leg = full_width_nest_leg("map_orswot", model, mo_ops.LEVEL, device, chunk, repeats, rows)
    bound = fold_bound_ms(r, k * m, a)
    leg.update(R=r, K=k, M=m, E=k * m, A=a, D=d, setup_s=setup_s,
               ctr_gb=r * k * m * a * 4 / 1e9, bound_ms=bound["bound_ms"],
               bound_by=bound["bound_by"],
               bound_share=bound["bound_ms"] / leg["leaf_kernel_ms_median"],
               merges_per_s=(r - 1) / (leg["leaf_kernel_ms_median"] * 1e-3))
    out["map_orswot"] = leg
    del model
    # (b) Map3 at the same widths, a cut depth.
    fresh()
    t0 = time.perf_counter()
    model = BatchedMap3(r3, k1, k2, m, a, d, keys1=Interner(range(k1)),
                        keys2=Interner(range(k2)), members=Interner(range(m)), device=device,
                        **names)
    fill_config3(types.SimpleNamespace(state=model.state.mo.core), seed + 1, chunk)
    fill_outer_level(model.state.mo, k1 * k2, seed + 1)
    fill_outer_level(model.state, k1, seed + 2, p_key=0.1)
    sync()
    setup_s = time.perf_counter() - t0
    leg = full_width_nest_leg("map3", model, m3_ops.LEVEL, device, chunk, repeats)
    bound = fold_bound_ms(r3, k1 * k2 * m, a)
    leg.update(R=r3, K1=k1, K2=k2, M=m, E=k1 * k2 * m, A=a, D=d, setup_s=setup_s,
               bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
               bound_share=bound["bound_ms"] / leg["leaf_kernel_ms_median"])
    check(len(leg["converged_parked_per_level"]) == 3, "map3: not three parked levels")
    out["map3"] = leg
    del model
    # (c) Map<K1, Map<K2, MVReg>> at config 4's widths, R = 8 and 64.
    out["map_map"] = []
    for rr in map_r:
        fresh()
        t0 = time.perf_counter()
        model = BatchedNestedMap(rr, map_k1, map_k2, map_a, map_s, d,
                                 keys1=Interner(range(map_k1)), keys2=Interner(range(map_k2)),
                                 actors=Interner(f"a{i}" for i in range(map_a)),
                                 values=Interner(range(5)), device=device)
        fill_config4(types.SimpleNamespace(state=model.state.m), seed, map_chunk)
        fill_outer_level(model.state, map_k1, seed + 3, ahead=1 << 30)
        # The fill parks leaf removes inside K1 children a replica holds no
        # cell of, which no op history reaches (each join scrubs them), so
        # the tree fold (a scrub a pair) and the fused one (one scrub) would
        # differ: settle every replica first.
        model.state = mm_ops.LEVEL.settle_self(model.state)
        sync()
        setup_s = time.perf_counter() - t0
        leg = full_width_nest_leg("map_map", model, mm_ops.LEVEL, device, chunk, repeats)
        # A dense BatchedMap's fold of the flat K1·K2 map (ops.map.fold: K2
        # once) with the outer level settled on it equals the nest's tree
        # fold (no kernel; parked slots in clock order).
        before = fk.fold_cells.launches
        leaf, leaf_of = map_ops.fold(model.state.m, prefer="fused")
        check(not on_card or fk.fold_cells.launches == before + 1,
              "the dense twin's fold did not launch K2")
        nested, nof = fk.settle_levels(mm_ops.LEVEL, model.state, leaf, leaf_of)
        tree, tof = mm_ops.fold(model.state, prefer="tree")
        check(same_leaves(nest_in_clock_order(nested), nest_in_clock_order(tree))
              and not bool(nof.any()) and not bool(tof.any()),
              "map_map: the dense twin's K2 fold + the outer level != the nest's tree fold")
        leg["gates"]["dense_twin_equals_tree_fold"] = True
        bound = fold_bound_ms(rr, map_k1 * map_k2, map_a, OPS_PER_CELL)
        leg.update(R=rr, K1=map_k1, K2=map_k2, S=map_s, A=map_a, D=d, setup_s=setup_s,
                   bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                   bound_share=bound["bound_ms"] / leg["leaf_kernel_ms_median"])
        out["map_map"].append(leg)
        del model, leaf, nested, tree
    out["reduced"] = {"map3_R": [10240, r3, "widths unchanged; a depth cut for the time limit"]}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---- the nested δ rings -------------------------------------------------------------

def fill_delta_nest(kind: str, r: int, p: int, seed: int, device, chunk: int = 128,
                    k: int = 400, m: int = 256, k1: int = 16, k2: int = 25, a: int = 8,
                    d: int = 4):
    """A nested δ workload at config 3's widths: ``fill_delta_config3``'s
    replicas as the leaf (E = K·M, or K1·K2·M), wrapped in the kind's
    levels with outer keyset-removes parked ahead of every top
    (``fill_outer_level``). Returns ``(state, dirty, fctx, info)``."""
    from crdt_tpu_torch.ops import map3 as m3_ops
    from crdt_tpu_torch.ops import map_orswot as mo_ops

    import torch

    from crdt_tpu_torch._dtypes import bits

    e = (k if kind == "map_orswot" else k1 * k2) * m
    core, dirty, fctx, info = fill_delta_config3(r, e, a, d, p, seed, device, chunk)
    # Ahead of every top (counters stay below ~100 + E/100), and inside the
    # wire's ±32 Ki window of the digest watermark: the parked clocks ride
    # the fused wire, an unencodable one would be wire loss. One key a
    # slot, each a live key: the K1 level's remove kills every lane-0 dot
    # of one K1 key (K2·M rows) on every replica.
    ahead, kk = 20_000, (k if kind == "map_orswot" else k1 * k2)
    gen = torch.Generator(device=device).manual_seed(seed + 14)
    one_each = torch.randperm(kk, generator=gen, device=device)[:4].tolist()
    if kind == "map_orswot":
        state = mo_ops.LEVEL.empty(core, k, a, d, batch=(r,))
        fill_outer_level(state, k, seed, n_parked=8, ahead=ahead, keys=one_each)
    else:
        mo = mo_ops.LEVEL.empty(core, k1 * k2, a, d, batch=(r,))
        fill_outer_level(mo, k1 * k2, seed, n_parked=8, ahead=ahead, keys=one_each)
        state = m3_ops.LEVEL.empty(mo, k1, a, d, batch=(r,))
        fill_outer_level(state, k1, seed + 1, n_parked=8, ahead=ahead, keys=[k1 - 1])
        live = bits(core.ctr)[:, (k1 - 1) * k2 * m:, 0] != 0
        info = {**info, "k1_remove_kills_rows_per_rank_max":
                int(live.view(p, r // p, -1).any(1).sum(-1).max())}
    return state, dirty, fctx, info


class K3Checked:
    """Every K3 launch of the rings run inside it held against K3's plain
    version on the same inputs (``wire_pack_plain``, which launches no
    kernel and counts nothing): the running max |diff| and the launches
    checked."""

    def __enter__(self):
        from crdt_tpu_torch.ops import wire_kernels as wk

        self._wk, self._many = wk, wk.wire_pack_many
        self.max_abs_err, self.calls = 0, 0

        def checked(group, *args, **kw):
            outs = self._many(group, *args, **kw)
            for x, g in zip(outs, group):
                self.max_abs_err = max(self.max_abs_err, wire_diff(x, wk.wire_pack_plain(**g)))
            self.calls += 1
            return outs

        wk.wire_pack_many = checked
        return self

    def __exit__(self, *exc):
        self._wk.wire_pack_many = self._many
        return False


def delta_nest_leg(kind: str, r: int, p: int, cap: int, seed: int, device, ring_samples: int,
                   repeats: int, per_sample: int, widths=None) -> dict:
    """One nested δ ring at full width: certified fused (K3 once per round,
    every launch checked against K3's plain version), == the layered ring
    == the mesh fold (K1) with residue 0; acked (K3's acked instance every
    round, residue 0, == the unacked rows) and logged once (one δ record of
    the kind, replayed onto the rows); walls alternating fused, layered and
    acked; busy share; K3 at the round's nested instance (slot + every
    parked level in one launch)."""
    import torch

    from crdt_tpu_torch._dtypes import bits, umax
    from crdt_tpu_torch.durability import Wal, recover
    from crdt_tpu_torch.ops.fold_kernels import fold_entries
    from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import (
        VirtualMesh, delta_map3, delta_map_orswot, mesh_fold_map3, mesh_fold_map_orswot,
    )
    from crdt_tpu_torch.parallel import wire as wire_mod
    from crdt_tpu_torch.parallel.anti_entropy import local_folds, rank_blocks
    from crdt_tpu_torch.parallel.collectives import ppermute

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state, dirty, fctx, info = fill_delta_nest(kind, r, p, seed, device, **(widths or {}))
    sync()
    setup_s = time.perf_counter() - t0
    flavor = delta_map_orswot if kind == "map_orswot" else delta_map3
    ring_fn = (flavor.mesh_delta_gossip_map_orswot if kind == "map_orswot"
               else flavor.mesh_delta_gossip_map3)
    fold_fn = mesh_fold_map_orswot if kind == "map_orswot" else mesh_fold_map3
    mesh = VirtualMesh(p, device)
    e, rl = dirty.shape[-1], r // p
    backlog = int(dirty.view(p, rl, e).any(1).sum(-1).max())
    fused, rounds, stats, attempts, (k3_launches, k1_launches) = certify_ring(
        lambda rounds, stats: ring_fn(state, dirty, fctx, mesh, rounds=rounds, cap=cap,
                                      stats=stats),
        backlog, p, cap, (wire_pack, fold_entries), sync)
    check(not bool(fused[2].any()), f"{kind}: the fused ring overflowed")
    check(not on_card or (k3_launches == rounds and k1_launches == p),
          f"{kind}: the fused ring launched K3 {k3_launches} times in {rounds} rounds, K1 "
          f"{k1_launches} times")
    with K3Checked() as k3c:
        checked = ring_fn(state, dirty, fctx, mesh, rounds=rounds, cap=cap)
    check(k3c.max_abs_err == 0 and (not on_card or k3c.calls == rounds),
          f"{kind}: a ring launch of K3 disagrees with its plain version ({k3c.max_abs_err})")
    check(same_leaves(checked[0], fused[0]), f"{kind}: the checked ring differs")
    layered = ring_fn(state, dirty, fctx, mesh, rounds=rounds, cap=cap, fused=False)
    check(same_leaves(fused[0], layered[0]) and same_leaves(fused[1], layered[1])
          and int(layered[3]) == 0, f"{kind}: fused ring != layered ring")
    t0 = time.perf_counter()
    folded, of_f = fold_fn(state, mesh)
    sync()
    mesh_fold_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(of_f.any()), f"{kind}: the mesh fold overflowed")
    check(nest_rows_equal_fold(fused[0], folded), f"{kind}: certified ring rows != mesh fold")
    del checked, layered
    # Acked once: K3's acked instance every round, the rows unchanged.
    wire_pack.launches = wire_pack.acked_launches = 0
    acked = ring_fn(state, dirty, fctx, mesh, rounds=rounds, cap=cap, ack_window=True,
                    stats=(acked_stats := {}))
    sync()
    acked_launches = (wire_pack.launches, wire_pack.acked_launches)
    check(int(acked[3]) == 0 and same_leaves(acked[0], fused[0]),
          f"{kind}: the acked ring differs from the unacked one")
    check(not on_card or acked_launches == (rounds, rounds),
          f"{kind}: the acked ring launched K3 {acked_launches} (all, acked)")
    del acked
    # Logged once: the ring attaches its padded input as the log's base and
    # appends its converged rows as one record of the kind; replayed.
    def logged(root):
        with Wal(os.path.join(root, "wal"), fsync="on_round") as w:
            out = ring_fn(state, dirty, fctx, mesh, rounds=rounds, cap=cap, wal=w)
            records = [meta for _, meta, _ in w.records()]
            nbytes = w.bytes_appended
        with Wal(os.path.join(root, "wal")) as w:
            back, n_rec, _ = recover.replay(w, fused[0], kind, 0)
        check(same_leaves(out[0], fused[0]) and records[0]["kind"] == kind and n_rec == 1
              and same_leaves(back, fused[0]), f"{kind}: the logged ring or its replay differs")
        return {"records": records, "record_bytes": nbytes}

    durable = with_scratch_dir(logged)
    # Walls, alternating fused, layered and acked (fused).
    runs = alternate_rings(lambda kind_: ring_fn(state, dirty, fctx, mesh, rounds=rounds,
                                                 cap=cap, fused=kind_ is not False,
                                                 ack_window=kind_ == "acked"),
                           ring_samples, sync, kinds=(True, False, "acked"))
    busy = profile_busy(lambda: ring_fn(state, dirty, fctx, mesh, rounds=rounds, cap=cap),
                        device)
    # K3 at the round's nested instance: round 0's packet of the rank folds.
    blocks = rank_blocks(state, mesh)
    ranks, _ = local_folds(blocks, lambda b: nest_ops(kind).fold(b))
    d0 = dirty.view(p, rl, e).any(1)
    f0 = torch.stack([bits(umax(fctx.view(p, rl, e, -1)[q], 0))
                      for q in range(p)]).view(fctx.dtype)
    extract = flavor.extract_delta_mo if kind == "map_orswot" else flavor.extract_delta_m3
    template = (flavor.packet_template_mo if kind == "map_orswot"
                else flavor.packet_template_m3)(ranks, cap, fctx.dtype)
    pkt, _, _ = extract(ranks, d0, f0, cap, start=0)
    top = ranks.core.top if kind == "map_orswot" else ranks.mo.core.top
    rtop = ppermute(top, [(i, (i - 1) % p) for i in range(p)])
    codec = wire_mod.WireCodec(template, e, wire_mod.know_dense, gated=True, acked=False)
    pargs = codec.parked_inputs(pkt, rtop=rtop)
    k3 = k3_at_ring_shape(codec.slot_inputs(pkt, rtop=rtop), pargs, device, repeats, per_sample)
    links = stats["rounds"] * stats["links"]
    out = {
        "R": r, "P": p, "cap": cap, "E": e, "setup_s": setup_s, **info,
        "parked_levels": len(codec.parked_recs), "parked_rows_in_k3_group": codec.pd,
        "backlog_max_per_rank": backlog, "attempts": attempts, "rounds": rounds,
        "residue": int(fused[3]),
        "gates": {"fused_equals_layered": True, "equals_mesh_fold": True,
                  "k3_launches_checked_against_plain": k3c.calls, "acked": True, "logged": True},
        "k3_launches_in_ring": k3_launches, "k1_launches_in_ring": k1_launches,
        "k3_launches_per_round": k3_launches / rounds,
        "k3_max_abs_err": max(k3c.max_abs_err, k3["k3_max_abs_err"]),
        "ring_ms_fused": statistics.median(runs[True]),
        "ring_ms_layered": statistics.median(runs[False]),
        "ring_ms_fused_runs": runs[True], "ring_ms_layered_runs": runs[False],
        "mesh_fold_ms": mesh_fold_ms,
        "wire_bytes_per_link_round": stats["wire_bytes"],
        "layered_packet_bytes_per_link_round": stats["packet_bytes"],
        "slots_shipped_per_link_round": stats["slots_shipped"] / links,
        "ring_profile": busy,
        "launches_per_round": (busy["launch_kernel_calls"] / rounds) if busy else None,
        "acked": {"k3_launches": acked_launches[0], "k3_acked_launches": acked_launches[1],
                  "slots_acked_skipped": acked_stats["slots_acked_skipped"],
                  "residue": 0, "ring_ms": statistics.median(runs["acked"]),
                  "ring_ms_runs": runs["acked"]},
        "durable": durable,
        "converged_parked_per_level": nest_parked_levels(tree_map(lambda x: x[None], folded)),
        **{key: k3[key] for key in ("k3_lc", "k3_ms_median", "k3_ms_device_profiler",
                                    "k3_ms_per_call_incl_wrapper", "k3_bytes", "k3_bound_ms",
                                    "k3_bound_by", "k3_bound_share", "k3_plain_ms",
                                    "k3_group_ms_median", "k3_group_bytes",
                                    "k3_group_bound_share")},
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
    }
    del state, dirty, fctx, fused, folded, ranks, blocks
    return out


def phase_full_width_delta_nested(device, seed: int, r: int = 5120, r3: int = 1024, p: int = 8,
                                  cap: int = 4096, ring_samples: int = 5, repeats: int = 5,
                                  per_sample: int = 50, widths=None) -> dict:
    """The nested δ rings at config 3's widths: ``Map<K, Orswot>`` (K 400 ×
    M 256, A = 8, D = 4) at ``full_width_delta``'s cut (R = 5,120 on P = 8
    virtual ranks, cap 4,096) and ``Map3`` (K1 16 × K2 25 × M 256) at R =
    1,024; the leaf is ``fill_delta_config3``'s δ workload, with outer
    keyset-removes of live keys parked ahead of every top at each level."""
    t_phase = time.perf_counter()
    out = {"phase": "full_width_delta_nested"}
    out["map_orswot"] = delta_nest_leg("map_orswot", r, p, cap, seed, device, ring_samples,
                                       repeats, per_sample, widths)
    out["map3"] = delta_nest_leg("map3", r3, p, cap, seed + 1, device, ring_samples, repeats,
                                 per_sample, widths)
    out["reduced"] = {"map_orswot_R": [10240, r, "full_width_delta's cut: fctx is as large as "
                                                 "ctr"],
                      "map3_R": [10240, r3, "widths unchanged; a depth cut for the time limit"]}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def nested_parked(state) -> set:
    """A nest's parked keyset-removes as a set of (clock, key set) pairs,
    equal-clock slots unioned (one oracle entry): the slot order follows
    the join order, the set does not."""
    from crdt_tpu_torch._dtypes import to_wide

    rows = {}
    for cl, ids, ok in zip(to_wide(state.kcl).tolist(), state.kidx.tolist(),
                           state.kdvalid.tolist()):
        if ok:
            rows.setdefault(tuple(cl), set()).update(k for k in ids if k >= 0)
    return {(c, frozenset(k)) for c, k in rows.items()}


# ---- phases 30-32: the remaining kinds (clocks, counters, sets, registers, lists)

LIST_INSERT, LIST_DELETE = 0, 1  # the engine's op kinds (crdt_tpu_torch.native)


def make_edit_trace(n_ops: int, n_actors: int = 4, seed: int = 3):
    """BASELINE config 5's synthetic trace, ``bench.py``'s
    ``make_edit_trace`` draw for draw: mostly typing at a moving cursor,
    occasional jumps and backspaces."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kinds, idxs, vals, actors = [], [], [], []
    length, cursor = 0, 0
    for _ in range(n_ops):
        roll = rng.random()
        if length == 0 or roll < 0.72:       # type at cursor
            kinds.append(LIST_INSERT)
            idxs.append(cursor)
            cursor = min(cursor + 1, length + 1)
            length += 1
        elif roll < 0.87:                     # jump cursor
            cursor = int(rng.integers(0, length + 1))
            kinds.append(LIST_INSERT)
            idxs.append(cursor)
            cursor += 1
            length += 1
        else:                                 # backspace
            kinds.append(LIST_DELETE)
            victim = max(0, min(cursor - 1, length - 1))
            idxs.append(victim)
            cursor = victim
            length -= 1
        vals.append(int(rng.integers(0, 128)))
        actors.append(int(rng.integers(0, n_actors)))
    return kinds, idxs, vals, actors


def card_label(device) -> str:
    """The card's ``nvidia-smi`` name and power limit, printed beside a
    phase's numbers (``cpu`` in a CPU rehearsal)."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def kernel_launches() -> dict:
    """The launch counts of K1, K2 and K3 so far (a phase that runs none
    of them checks that its delta is 0)."""
    from crdt_tpu_torch.ops.fold_kernels import fold_cells, fold_entries
    from crdt_tpu_torch.ops.wire_kernels import wire_pack

    return {"k1": fold_entries.launches, "k2": fold_cells.launches, "k3": wire_pack.launches}


def check_no_kernel(before: dict, phase: str) -> dict:
    after = kernel_launches()
    delta = {k: after[k] - before[k] for k in after}
    check(not any(delta.values()), f"{phase} launched a kernel of K1-K3: {delta}")
    return delta


def new_kind_objects():
    """One oracle object of every serde tag this slice adds (MerkleReg with
    an orphan)."""
    from crdt_tpu_torch.pure import GList, GSet, List, LWWReg, MerkleReg, PNCounter

    pn = PNCounter()
    for actor, up in (("a", True), ("b", False), ("a", True)):
        op = pn.inc(actor) if up else pn.dec(actor)
        pn.apply(op)
    gs = GSet()
    for x in ("z", 3, ("t", b"\x01")):
        gs.apply(gs.insert(x))
    reg = LWWReg()
    lww_op = reg.update({"v": [1, 2]}, (1 << 63) + 5)
    lst = List()
    list_ops = []
    for i, (ix, actor) in enumerate(((0, "a"), (0, "b"), (1, "a"), (0, "c"))):
        list_ops.append(lst.insert_index(ix, f"x{i}", actor))
        lst.apply(list_ops[-1])
    list_ops.append(lst.delete_index(1, "a"))
    lst.apply(list_ops[-1])
    gl = GList()
    g_op = None
    for x in ("p", "q", "r"):
        g_op = gl.insert_after(gl.last(), x)
        gl.apply(g_op)
    mr = MerkleReg()
    root = mr.write("root")
    mr.apply(root)
    child = mr.write(("child", 1), frozenset({root.hash()}))
    mr.apply(child)
    mr.apply(MerkleReg().write(2.5, frozenset({MerkleReg().write(b"parent").hash()})))
    return {"GCounter": pn.p, "PNCounter": pn, "PNOp": op, "GSet": gs, "LWWReg": reg,
            "LWWReg-unset": LWWReg(), "LWWOp": lww_op, "Identifier": list_ops[0].id,
            "List": lst, "Insert": list_ops[0], "Delete": list_ops[-1], "GList": gl,
            "GInsert": g_op, "Node": child, "MerkleReg": mr}


def phase_kinds_scenarios(device, seed: int) -> dict:
    """Small probes of every kind of ROADMAP item 14, each op on a model on
    the card, the same model on the CPU and the port's pure oracle: card
    == CPU bit for bit, both == the oracle. G/PN counters (a u32 counter
    at 2^32-1 + 1 raises under strict and wraps off it; a u64 lane near
    2^64), VClock (gap and duplicate dots raise DotRange), GSet (a full
    universe, a garbage member: TypeError), LWWReg (an equal-marker
    conflict: ConflictingMarker; a garbage marker: TypeError), MVReg
    (SlotOverflow, reset_remove), List (adversarial front inserts: the
    identifiers deepen; a remote ingest that grows the universe
    mid-stream), GList (a union), and a serde round trip of every tag of
    the slice, MerkleReg included. None of K1-K3 launches."""
    import numpy as np
    import torch

    from crdt_tpu_torch import serde
    from crdt_tpu_torch.config import configured
    from crdt_tpu_torch.dot import Dot
    from crdt_tpu_torch.models import (
        BatchedGCounter, BatchedGList, BatchedGSet, BatchedList, BatchedLWWReg, BatchedMVReg,
        BatchedPNCounter, BatchedVClock, SlotOverflow,
    )
    from crdt_tpu_torch.pure import GList, GSet, List, LWWReg, MVReg, PNCounter
    from crdt_tpu_torch.pure.glist import Insert as GInsert
    from crdt_tpu_torch.traits import ConflictingMarker, CounterSaturation, DotRange
    from crdt_tpu_torch.utils import Interner
    from crdt_tpu_torch.vclock import VClock

    t_phase = time.perf_counter()
    before = kernel_launches()
    rng = random.Random(seed)
    devs = (device, torch.device("cpu"))
    counts = {}

    def twin(build):
        return {d.type: build(d) for d in devs}

    def both_equal(models, *planes):
        for plane in planes:
            x, y = (plane(models[d.type]) for d in devs)
            check(same_leaves(on_cpu(x), on_cpu(y)), f"card != CPU: {plane}")

    # ---- PN and G counters -------------------------------------------------
    pures = [PNCounter() for _ in range(4)]
    pn = twin(lambda d: BatchedPNCounter(4, actors=Interner(), n_actors=4, device=d))
    for _ in range(80):
        i, actor, up = rng.randrange(4), rng.choice("abcd"), rng.random() < 0.6
        pures[i].apply(pures[i].inc(actor) if up else pures[i].dec(actor))
        for m in pn.values():
            (m.inc if up else m.dec)(i, actor)
    merged = PNCounter()
    for p in pures:
        merged.merge(p.clone())
    for m in pn.values():
        check(all(m.to_pure(i) == pures[i] and m.read(i) == pures[i].read() for i in range(4)),
              "PNCounter != oracle")
        check(m.fold_read() == merged.read(), "PNCounter fold != oracle merge")
    both_equal(pn, lambda m: m.p.clocks, lambda m: m.n.clocks)
    for strict in (False, True):
        with configured(strict=strict):
            for d in devs:
                g = BatchedGCounter(1, actors=Interner(["a"]), device=d)
                g.inc(0, "a", steps=(1 << 32) - 1)
                if strict:
                    with expect_raises(CounterSaturation):
                        g.inc(0, "a")
                    check(g.read(0) == (1 << 32) - 1, "a trapped increment changed the lane")
                else:
                    g.inc(0, "a")
                    check(g.read(0) == 0, "an unchecked u32 increment past 2^32-1 must wrap")
    top = (1 << 64) - 1
    with configured(counter_dtype="uint64"):
        oracle = [VClock({"a": top - 2, "b": 5}), VClock({"a": 7})]
        vc = twin(lambda d: BatchedVClock.from_pure([c.clone() for c in oracle], n_actors=3,
                                                    device=d))
        for m in vc.values():
            m.apply(0, Dot("a", top - 1))
            m.inc(0, "a")
            m.inc(1, "c")
            m.merge_from(1, 0)
        oracle[0].apply(Dot("a", top - 1))
        oracle[0].apply(oracle[0].inc("a"))
        oracle[1].apply(oracle[1].inc("c"))
        oracle[1].merge(oracle[0].clone())
        for m in vc.values():
            check(m.clocks.dtype == torch.uint64, "u64 config did not widen the lanes")
            check([m.to_pure(i) for i in range(2)] == oracle, "u64 VClock != oracle")
            check(m.fold().get("a") == top, "u64 lane lost its top")
        both_equal(vc, lambda m: m.clocks)
        big = twin(lambda d: BatchedGCounter(1, actors=Interner(["a"]), device=d))
        for m in big.values():
            m.inc(0, "a", steps=top - 1)
            m.inc(0, "a")
            check(m.fold_read() == top, "u64 counter read is not exact")
    with configured(strict=True):
        for d in devs:
            m = BatchedVClock(1, n_actors=2, device=d)
            m.apply(0, Dot("a", 1))
            with expect_raises(DotRange):
                m.apply(0, Dot("a", 1))  # duplicate
            with expect_raises(DotRange):
                m.apply(0, Dot("a", 3))  # gap
            check("z" not in m.actors, "a rejected dot interned its actor")

    # ---- GSet -------------------------------------------------------------------
    gsets = [GSet() for _ in range(4)]
    gm = twin(lambda d: BatchedGSet(4, 16, members=Interner(), device=d))
    for _ in range(50):
        if rng.random() < 0.7:
            i, x = rng.randrange(4), f"m{rng.randrange(12)}"
            gsets[i].apply(gsets[i].insert(x))
            for m in gm.values():
                m.insert(i, x)
        else:
            dst, src = rng.randrange(4), rng.randrange(4)
            gsets[dst].merge(gsets[src].clone())
            for m in gm.values():
                m.merge_from(dst, src)
    union = GSet()
    for g in gsets:
        union.merge(g.clone())
    for m in gm.values():
        check([m.to_pure(i) for i in range(4)] == gsets and m.fold() == union, "GSet != oracle")
        with expect_raises(TypeError):
            m.insert(0, ["unhashable"])
    both_equal(gm, lambda m: m.present)
    for d in devs:
        full = BatchedGSet(1, 2, device=d)
        full.insert(0, "x")
        full.insert(0, "y")
        with expect_raises(IndexError):
            full.insert(0, "z")

    # ---- LWWReg ------------------------------------------------------------
    regs = [LWWReg() for _ in range(4)]
    lm = twin(lambda d: BatchedLWWReg(4, values=Interner(), device=d))
    for _ in range(60):
        if rng.random() < 0.7:
            i = rng.randrange(4)
            marker = rng.randrange(1, 6) + (1 << 40) * (rng.random() < 0.3)
            regs[i].apply(regs[i].update(f"v{marker}", marker))
            for m in lm.values():
                m.update(i, f"v{marker}", marker)
        else:
            dst, src = rng.randrange(4), rng.randrange(4)
            regs[dst].merge(regs[src].clone())
            for m in lm.values():
                m.merge_from(dst, src)
    best = LWWReg()
    for r in regs:
        best.merge(r.clone())
    for m in lm.values():
        check([m.to_pure(i) for i in range(4)] == regs and m.fold() == best, "LWWReg != oracle")
        with expect_raises(ConflictingMarker):
            m.update(0, "another value", regs[0].marker)
        with expect_raises(TypeError):
            m.update(0, "v", "not a marker")
    with expect_raises(ConflictingMarker):
        regs[0].validate_update("another value", regs[0].marker)
    both_equal(lm, *(lambda m, f=f: getattr(m.state, f) for f in ("hi", "lo", "val", "has")))

    # ---- MVReg ---------------------------------------------------------------
    sites = [MVReg() for _ in range(4)]
    mm = twin(lambda d: BatchedMVReg(4, 4, n_slots=4, actors=Interner(), values=Interner(),
                                     device=d))
    for _ in range(40):
        i = rng.randrange(4)
        if rng.random() < 0.6:
            op = sites[i].write(f"v{rng.randrange(9)}", sites[i].read().derive_add_ctx("abcd"[i]))
            targets = {i, rng.randrange(4)}
            for j in targets:
                sites[j].apply(op)
                for m in mm.values():
                    m.apply(j, op)
        else:
            src = rng.randrange(4)
            sites[i].merge(sites[src].clone())
            for m in mm.values():
                m.merge_from(i, src)
    clock = sites[1].clock()
    sites[1].reset_remove(clock)
    for m in mm.values():
        m.reset_remove(1, clock)
    joined = MVReg()
    for s in sites:
        joined.merge(s.clone())
    for m in mm.values():
        check([m.to_pure(i) for i in range(4)] == sites and m.fold() == joined, "MVReg != oracle")
    check(mm[device.type].to_pure(1) == MVReg(), "reset_remove kept a dominated sibling")
    both_equal(mm, *(lambda m, f=f: getattr(m.state, f)
                     for f in ("wact", "wctr", "clk", "val", "valid")))
    for d in devs:
        narrow = BatchedMVReg(1, 3, n_slots=2, device=d)
        for k, actor in enumerate("xyz"):
            w = MVReg()
            put = w.write(k, w.read().derive_add_ctx(actor))
            if k < 2:
                narrow.apply(0, put)
            else:
                with expect_raises(SlotOverflow):
                    narrow.apply(0, put)
        check(len(narrow.to_pure(0).vals) == 2, "an overflowing put changed the register")

    # ---- List: front inserts, and a remote ingest that grows the universe ---
    n = 300
    front = ([LIST_INSERT] * n, [0] * n, list(range(n)), [i % 3 for i in range(n)])
    oracle = List()
    for _, ix, v, a in zip(*front):
        oracle.apply(oracle.insert_index(ix, v, a))
    lists = twin(lambda d: BatchedList.from_trace(*front, n_replicas=2, device=d))
    for m in lists.values():
        m.apply_trace_to_all(chunk=64)
        check(m.read(1) == oracle.read() and m.to_pure(1) == oracle, "front inserts != oracle")
    depth = max(len(lists[device.type].engine.identifier_path(h)) for h in range(n))
    check(depth > 1 and depth == max(len(i.path) for i in oracle.seq),
          f"front-insert identifier depth {depth}")
    both_equal(lists, lambda m: m.vals, lambda m: m.alive)
    ta = make_edit_trace(400, n_actors=2, seed=seed % 997)
    tb = make_edit_trace(300, n_actors=2, seed=seed % 991 + 1)
    tb = (tb[0], tb[1], tb[2], [a + 2 for a in tb[3]])  # another site's actors
    part = lambda t, lo, hi: tuple(x[lo:hi] for x in t)  # noqa: E731
    reads = {}
    for d in devs:
        a = BatchedList.from_trace(*part(ta, 0, 200), n_replicas=2, device=d)
        b = BatchedList.from_trace(*tb, n_replicas=2, device=d)
        a.apply_trace_to_all(chunk=64)
        b.apply_trace_to_all(chunk=64)
        grown = len(a.slots)
        a.ingest_remote_ops(b.export_ops())  # the universe grows mid-stream
        check(len(a.slots) > grown, "the ingest did not grow the universe")
        a.extend_trace(*part(ta, 200, 400))
        a.apply_trace_to_all(chunk=64)
        b.ingest_remote_ops(a.export_ops())
        b.apply_trace_to_all(chunk=64)
        check(a.read(0) == a.read(1) == b.read(0) == b.read(1), "ingest did not converge")
        check(a.to_pure(0) == b.to_pure(1), "ingested replicas differ as oracle objects")
        reads[d.type] = (a.read(0), a.vals, a.alive)
    check(reads[device.type][0] == reads["cpu"][0], "ingest: card != CPU")
    check(same_leaves(on_cpu(reads[device.type][2]), reads["cpu"][2]),
          "ingest: card != CPU (alive)")
    counts["list_identifier_depth"] = depth

    # ---- GList union ---------------------------------------------------------
    gl = twin(lambda d: BatchedGList(3, device=d))
    idx = [rng.randrange(k + 1) for k in range(40)]
    vals = [rng.randrange(100) for _ in range(40)]
    acts = [rng.randrange(3) for _ in range(40)]
    epoch = np.full((3, 40), -1, np.int64)
    for m in gl.values():
        handles = m.mint_inserts(idx, vals, acts)
    for r in range(3):
        pick = [h for h in handles if rng.random() < 0.5]
        epoch[r, :len(pick)] = pick
    glists = [GList() for _ in range(3)]
    g0 = gl[device.type]
    for r in range(3):
        for h in epoch[r][epoch[r] >= 0]:
            glists[r].apply(GInsert(id=g0.identifier(h)))
    for m in gl.values():
        m.apply_inserts(epoch)
        m.union_from(0, 1)
    glists[0].merge(glists[1].clone())
    everything = glists[0].clone()
    everything.merge(glists[2].clone())
    for m in gl.values():
        check([m.to_pure(r) for r in range(3)] == glists, "GList != oracle")
        check(m.to_pure(None) == everything, "GList fold != oracle union")
    both_equal(gl, lambda m: m.alive)

    # ---- serde: every tag of the slice ---------------------------------------------
    objs = new_kind_objects()
    for kind, obj in objs.items():
        check(serde.from_bytes(serde.to_bytes(obj)) == obj, f"serde round trip of {kind}")
    check(serde.decode(serde.encode(objs["MerkleReg"])).num_orphans() == 1,
          "the MerkleReg orphan was lost")
    counts["serde_tags"] = len(objs)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"phase": "kinds_scenarios", **counts, "launches": check_no_kernel(before, "kinds"),
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def phase_full_width_clocks(device, seed: int, r1: int = 64, incs: int = 10_000,
                            r2: int = 1000, a: int = 8, p: int = 8, gset_r: int = 10240,
                            gset_m: int = 102400, gset_density: float = 0.05,
                            repeats: int = 50) -> dict:
    """BASELINE configs 1 and 2 at ``bench.py``'s shapes and draws
    (``default_rng(1)`` in its order), then the clock and set mesh folds.
    Config 1: 64 replicas, 10,000 increments drawn by ``multinomial``,
    each replica in its own actor lane, through ``BatchedGCounter.inc``;
    the converged read is exactly 10,000; ``ops.vclock.fold`` per call.
    Config 2: the 1,000 × 1,000 × A = 8 pairwise merge matrix of the
    VClock, gated against a numpy per-pair max on 64 sampled rows, then
    PNCounter's p and n matrices and the converged p − n read as an exact
    int. Then ``mesh_fold_clocks`` on P = 8 (== the single-rank fold) and
    ``mesh_fold_gset`` at config 3's widths, R = 10,240 × 102,400 members
    (1.05 GB of bool, made on the device; half the members written), ==
    ``ops.gset.fold`` == the written members. Reports
    fold µs, merges/s and pair-merges/s, with the card's name and power
    limit. None of K1-K3 launches."""
    import numpy as np
    import torch

    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.convert import clocks_from_numpy, leaf_to_numpy
    from crdt_tpu_torch.models import BatchedGCounter, BatchedPNCounter
    from crdt_tpu_torch.ops import gset as gset_ops
    from crdt_tpu_torch.ops import vclock
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_fold_clocks, mesh_fold_gset
    from crdt_tpu_torch.utils import Interner

    t_phase = time.perf_counter()
    before = kernel_launches()
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    mesh = VirtualMesh(p, device)
    rng = np.random.default_rng(1)  # bench.py's generator; seed picks the gate rows only
    pick = np.random.default_rng(seed).choice(r2, 64, replace=False)

    # ---- config 1 ----------------------------------------------------------------
    counts = rng.multinomial(incs, np.ones(r1) / r1)
    g = BatchedGCounter(r1, actors=Interner(range(r1)), n_actors=r1, device=device)
    t0 = time.perf_counter()
    for i, c in enumerate(counts):
        g.inc(i, i, steps=int(c))
    sync()
    inc_s = time.perf_counter() - t0
    clocks1 = g.inner.clocks
    check(np.array_equal(leaf_to_numpy(clocks1), np.diag(counts).astype(np.uint32)),
          "config 1 clocks != bench.py's diag(counts)")
    read1 = g.fold_read()
    check(read1 == incs, f"converged gcounter read {read1} != {incs}")
    fold_ms = time_each(lambda: vclock.fold(clocks1), device, repeats)
    t0 = time.perf_counter()
    for _ in range(repeats):
        read_again = g.fold_read()
    read_ms = (time.perf_counter() - t0) * 1e3 / repeats
    check(read_again == incs, "fold_read drifted")
    mesh1 = mesh_fold_clocks(clocks1, mesh)
    check(same_leaves(mesh1, vclock.fold(clocks1)), "config 1: mesh fold != single-rank fold")

    # ---- config 2 ----------------------------------------------------------------
    c2 = rng.integers(0, 1000, (r2, a)).astype(np.uint32)
    x2 = clocks_from_numpy(c2, device)
    matrix = vclock.pairwise_merge_matrix(x2)
    sub = leaf_to_numpy(bits(matrix)[torch.as_tensor(pick, device=device)].view(matrix.dtype))
    check(np.array_equal(sub, np.maximum(c2[pick][:, None, :], c2[None, :, :])),
          "config 2: the pairwise matrix != numpy's per-pair max on 64 sampled rows")
    del matrix
    pair_ms = time_each(lambda: vclock.pairwise_merge_matrix(x2), device, 10)
    p2 = rng.integers(0, 1000, (r2, a)).astype(np.uint32)
    n2 = rng.integers(0, 1000, (r2, a)).astype(np.uint32)
    pn = BatchedPNCounter(r2, actors=Interner(range(a)), n_actors=a, device=device)
    pn.p.clocks, pn.n.clocks = clocks_from_numpy(p2, device), clocks_from_numpy(n2, device)
    pn_ms = time_each(lambda: (vclock.pairwise_merge_matrix(pn.p.clocks),
                               vclock.pairwise_merge_matrix(pn.n.clocks)), device, 10)
    read2 = pn.fold_read()
    want2 = int(p2.max(0).astype(np.int64).sum()) - int(n2.max(0).astype(np.int64).sum())
    check(read2 == want2, f"config 2: converged p - n {read2} != {want2}")
    mesh2 = mesh_fold_clocks(x2, mesh)
    check(same_leaves(mesh2, vclock.fold(x2)), "config 2: mesh fold != single-rank fold")
    mesh_clock_ms = time_each(lambda: mesh_fold_clocks(x2, mesh), device, repeats)

    # ---- GSet at config 3's widths --------------------------------------------
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    # Half the members were ever written; a replica holds each written
    # member with probability ``gset_density``.
    gen = torch.Generator(device=device).manual_seed(seed)
    written = torch.rand(gset_m, generator=gen, device=device) < 0.5
    present = torch.empty((gset_r, gset_m), dtype=torch.bool, device=device)
    for lo in range(0, gset_r, 1024):
        hi = min(lo + 1024, gset_r)
        present[lo:hi] = (torch.rand((hi - lo, gset_m), generator=gen, device=device)
                          < gset_density) & written
    want = gset_ops.fold(present)
    got = mesh_fold_gset(present, mesh)
    check(torch.equal(got, want), "mesh_fold_gset != the single-rank fold")
    check(torch.equal(got, written), "the converged GSet != the written members")
    gset_ms = time_each(lambda: mesh_fold_gset(present, mesh), device, 5)
    gset_single_ms = time_each(lambda: gset_ops.fold(present), device, 5)
    busy = profile_busy(lambda: mesh_fold_gset(present, mesh), device)
    nbytes = present.numel()
    out = {
        "phase": "full_width_clocks", "card": card_label(device),
        "config1": {"replicas": r1, "increments": incs, "read": read1,
                    "inc_host_s": inc_s, "fold_us": fold_ms * 1e3,
                    "merges_per_s": (r1 - 1) / (fold_ms / 1e3),
                    "fold_read_host_ms": read_ms, "mesh_p": p},
        "config2": {"shape": f"{r2}x{r2}x{a}", "pair_ms": pair_ms,
                    "pair_merges_per_s": r2 * r2 / (pair_ms / 1e3),
                    "pn_pair_ms": pn_ms, "pn_pair_merges_per_s": r2 * r2 / (pn_ms / 1e3),
                    "pn_read": read2, "gate_rows": 64,
                    "mesh_fold_clocks_us": mesh_clock_ms * 1e3},
        "gset": {"shape": f"{gset_r}x{gset_m}", "bytes": nbytes, "p": p,
                 "members_converged": int(got.sum()), "mesh_fold_ms": gset_ms,
                 "single_fold_ms": gset_single_ms, "gbps": nbytes / (gset_ms / 1e3) / 1e9,
                 "merges_per_s": (gset_r - 1) / (gset_ms / 1e3),
                 "busy": busy,
                 "peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else None},
        "launches": check_no_kernel(before, "full_width_clocks"),
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


def phase_full_width_list(device, seed: int, r: int = 1024, n_ops: int = 100_000,
                          chunk: int = 2048, ckpt_r: int = 64, sample_rows: int = 4,
                          split: int = 50_000) -> dict:
    """BASELINE config 5 as ``bench.py`` runs it when no automerge-perf
    trace is present: the synthetic ``make_edit_trace(100_000)`` (4 actors,
    seed 3) through ``BatchedList.from_trace(n_replicas=1024)`` and
    ``apply_trace_to_all(chunk=2048)``. Gates before any number: every
    row equals row 0 on the card; row 0's read == the pure ``List``
    oracle's over the trace == the engine's read; ``to_pure`` of 4 sampled
    rows == the oracle object; a second model that holds the first 50,000
    ops and takes the rest through ``export_ops`` / ``ingest_remote_ops``
    ends with the same live elements. Reports replica-ops/s, the oracle's
    and the engine's ops/s, epochs, launches and host-to-device bytes per
    epoch, the busy share, the converged-read latency (``read`` and
    ``to_pure`` of one row), a ``list`` checkpoint round trip at R = 64,
    and a ``BatchedGList`` over the trace's inserts at R = 1,024 against
    the pure ``GList``. None of K1-K3 launches."""
    import tempfile

    import numpy as np
    import torch

    from crdt_tpu_torch import checkpoint
    from crdt_tpu_torch.models import BatchedGList, BatchedList
    from crdt_tpu_torch.native import ListEngine
    from crdt_tpu_torch.pure import GList, List
    from crdt_tpu_torch.pure.glist import Insert as GInsert

    del seed  # the trace carries bench.py's seed (3)
    t_phase = time.perf_counter()
    before = kernel_launches()
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    trace = make_edit_trace(n_ops)
    n_ins = sum(1 for k in trace[0] if k == LIST_INSERT)

    t0 = time.perf_counter()
    oracle = List()
    for k, ix, v, actor in zip(*trace):
        oracle.apply(oracle.insert_index(ix, v, actor) if k == LIST_INSERT
                     else oracle.delete_index(ix, actor))
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = ListEngine()
    engine.apply_trace(*trace)
    native_s = time.perf_counter() - t0
    check(engine.is_native, "the list engine is not the compiled one")
    want = oracle.read()
    check(engine.read()[1].tolist() == want, "the engine's read != the oracle's")

    t0 = time.perf_counter()
    model = BatchedList.from_trace(*trace, n_replicas=r, device=device)
    sync()
    universe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    epochs = model.apply_trace_to_all(chunk=chunk)
    sync()
    apply_s = time.perf_counter() - t0
    up_bytes = model.uploaded_bytes
    check(model.vals.shape == (r, n_ins), f"state shape {tuple(model.vals.shape)}")
    rows_equal = bool((model.vals == model.vals[:1]).all() & (model.alive == model.alive[:1]).all())
    check(rows_equal, "a replica row differs from row 0")
    check(model.read(0) == want, "row 0's read != the oracle's")
    samples = [0, *random.Random(n_ops).sample(range(1, r), sample_rows - 1)]
    t0 = time.perf_counter()
    pure0 = model.to_pure(samples[0])
    to_pure_s = time.perf_counter() - t0
    check(pure0 == oracle and all(model.to_pure(i) == oracle for i in samples[1:]),
          "to_pure of a sampled row != the oracle object")
    t0 = time.perf_counter()
    read_rows = [model.read(0) for _ in range(5)]
    read_ms = (time.perf_counter() - t0) * 1e3 / 5
    check(read_rows[-1] == want, "read drifted")

    # The applied log again, from its start: the same final state (each
    # epoch's last write per slot is the trace's), now timed warm and
    # profiled.
    vals0, alive0 = model.vals.clone(), model.alive.clone()
    model._applied = 0
    t0 = time.perf_counter()
    model.apply_trace_to_all(chunk=chunk)
    sync()
    warm_s = time.perf_counter() - t0
    model._applied = 0
    busy = profile_busy(lambda: model.apply_trace_to_all(chunk=chunk), device)
    check(torch.equal(model.vals, vals0) and torch.equal(model.alive, alive0),
          "re-applying the log changed the state")

    second = BatchedList.from_trace(*(x[:split] for x in trace), n_replicas=r, device=device)
    second.apply_trace_to_all(chunk=chunk)
    t0 = time.perf_counter()
    wire = model.export_ops(split)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second.ingest_remote_ops(wire)
    second.apply_trace_to_all(chunk=chunk)
    sync()
    ingest_s = time.perf_counter() - t0
    check(torch.equal(second.alive, model.alive), "ingested model: alive != the minting model's")
    # A dead slot keeps the value of its last insert inside its epoch
    # window, and the windows differ: the live elements must agree.
    check(torch.equal(torch.where(second.alive, second.vals, 0),
                      torch.where(model.alive, model.vals, 0)),
          "ingested model: live values != the minting model's")
    check(second.read(r - 1) == want, "ingested model's read != the oracle's")
    del second, wire

    small = BatchedList.from_trace(*trace, n_replicas=ckpt_r, device=device)
    small.apply_trace_to_all(chunk=chunk)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_list_") as root:
        path = os.path.join(root, "list.npz")
        t0 = time.perf_counter()
        checkpoint.save(path, small)
        save_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        fs = fs_info(root)
        t0 = time.perf_counter()
        back = checkpoint.load(path, device=device)
        load_s = time.perf_counter() - t0
    check(torch.equal(back.vals, small.vals) and torch.equal(back.alive, small.alive)
          and np.array_equal(back.slots, small.slots) and back.read(ckpt_r - 1) == want,
          "the list checkpoint did not round-trip")
    del small, back

    ins = [i for i, k in enumerate(trace[0]) if k == LIST_INSERT]
    idx, gvals, gacts = ([trace[j][i] for i in ins] for j in (1, 2, 3))
    glist = BatchedGList(r, device=device)
    t0 = time.perf_counter()
    handles = glist.mint_inserts(idx, gvals, gacts)
    for lo in range(0, len(handles), chunk):
        hs = handles[lo:lo + chunk]
        glist.apply_inserts(np.broadcast_to(hs, (r, len(hs))))
    sync()
    glist_s = time.perf_counter() - t0
    check(bool((glist.alive == glist.alive[:1]).all()) and bool(glist.alive.all()),
          "a GList row misses an insert")
    g_oracle = GList()
    val_of = {}
    for h, v in zip(handles, gvals):
        ident = glist.identifier(h)
        val_of[ident] = v
        g_oracle.apply(GInsert(id=ident))
    check(glist.read(0) == [val_of[i] for i in g_oracle.list], "GList read != the oracle's")
    check(glist.to_pure(r - 1) == g_oracle and glist.to_pure(None) == g_oracle,
          "GList to_pure != the oracle")

    out = {
        "phase": "full_width_list", "card": card_label(device), "trace": "synthetic",
        "engine_native": engine.is_native,
        "ops": n_ops, "inserts": n_ins, "deletes": n_ops - n_ins, "replicas": r,
        "slots": int(model.vals.shape[1]), "live": len(want),
        "state_bytes": model.vals.numel() * 4 + model.alive.numel(),
        "oracle_ops_per_s": n_ops / oracle_s, "native_ops_per_s": n_ops / native_s,
        "universe_s": universe_s, "apply_s": apply_s,
        "replica_ops_per_s": n_ops * r / apply_s, "warm_apply_s": warm_s,
        "warm_replica_ops_per_s": n_ops * r / warm_s,
        "epochs": epochs, "h2d_bytes_per_epoch": up_bytes / epochs,
        "launches_per_epoch": (busy["launch_kernel_calls"] / epochs) if busy else None,
        "busy": busy, "read_ms": read_ms, "to_pure_s": to_pure_s,
        "export_s": export_s, "ingest_s": ingest_s,
        "checkpoint": {"replicas": ckpt_r, "save_s": save_s, "load_s": load_s,
                       "file_bytes": file_bytes, "fs": fs},
        "glist": {"replicas": r, "inserts": len(handles), "mint_and_apply_s": glist_s},
        "peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else None,
        "launches": check_no_kernel(before, "full_width_list"),
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


# ---- phases 33-34: causal-stability reclamation (ROADMAP items 15.2, 15.8) ----

RECLAIM_CLOCKS = ("dcl", "kcl", "kdcl", "odcl", "top")
RECLAIM_MASKS = ("dmask", "dkeys", "kdkeys", "odkeys")
RECLAIM_LISTS = ("didx", "kidx")


def redraw_parked(state, rng):
    """``state`` with every parked buffer, top and validity lane redrawn
    from ``rng`` (clocks in [0, 3]: a frontier of 1 or 2 covers some slots
    and not others; dead slots with nonzero clocks are stale lanes)."""
    import numpy as np

    from crdt_tpu_torch.convert import leaf_from_numpy, leaf_to_numpy

    if not hasattr(state, "_fields"):
        return state
    out = {}
    for name in state._fields:
        x = getattr(state, name)
        if hasattr(x, "_fields"):
            out[name] = redraw_parked(x, rng)
        elif name in RECLAIM_CLOCKS:
            out[name] = leaf_from_numpy(rng.integers(0, 4, x.shape).astype(np.uint32), x.device)
        elif name.endswith("dvalid"):
            out[name] = leaf_from_numpy(rng.random(x.shape) < 0.6, x.device)
        elif name in RECLAIM_MASKS:
            out[name] = leaf_from_numpy(rng.random(x.shape) < 0.4, x.device)
        elif name in RECLAIM_LISTS:
            hi = max(int(leaf_to_numpy(x).max()) + 1, 4)
            out[name] = leaf_from_numpy(rng.integers(-1, hi, x.shape).astype(np.int32),
                                        x.device)
        else:
            out[name] = x
    return type(state)(**out)


def reclaim_models(seed: int, device):
    """One small seeded model of every compactable family on ``device``
    (oracle-minted op streams, parked removes at every level) and the
    raw states of the register, clock and set kinds. Returns ``(models,
    states)``: models by ring entry, states by compactor kind."""
    import numpy as np
    import torch

    from crdt_tpu_torch.convert import leaf_from_numpy
    from crdt_tpu_torch.models import (
        BatchedMap, BatchedOrswot, BatchedSparseMap, BatchedSparseMapOrswot,
        BatchedSparseOrswot,
    )
    from crdt_tpu_torch.ops import lwwreg, mvreg

    rng = random.Random(seed + 41)
    sites, _ = mint_sites(rng, 6, 40)
    map_sites, _ = mint_map_sites(rng, 6, 40)
    set_sites, _ = mint_set_map_sites(rng, 6, 40)
    models = {
        "orswot": BatchedOrswot.from_pure(sites, device=device),
        "sparse": BatchedSparseOrswot.from_pure(sites, dot_cap=32, device=device),
        "map": BatchedMap.from_pure(map_sites, device=device),
        "sparse_mvmap": BatchedSparseMap.from_pure(map_sites, cell_cap=32, device=device),
        "sparse_nested": BatchedSparseMapOrswot.from_pure(set_sites, span=8, dot_cap=64,
                                                          device=device),
    }
    for kind in NEST_KINDS:
        models[kind] = nest_model(kind, nest_population(kind, rng, 6)[0], device)
    gen = np.random.default_rng(seed + 42)

    def drawn(like):
        """Random lanes of ``like``'s shape and dtype (values 0..3)."""
        if like.dtype == torch.bool:
            return leaf_from_numpy(gen.random(like.shape) < 0.5, device)
        dt = np.uint32 if like.dtype == torch.uint32 else np.int32
        return leaf_from_numpy(gen.integers(0, 4, like.shape).astype(dt), device)

    mv = mvreg.empty(4, 4, batch=(6,), device=device)
    lww = lwwreg.empty(batch=(6,), device=device)
    states = {
        "mvreg": type(mv)(*map(drawn, mv)), "lwwreg": type(lww)(*map(drawn, lww)),
        "vclock": leaf_from_numpy(gen.integers(0, 9, (6, 4)).astype(np.uint32), device),
        "gset": leaf_from_numpy(gen.random((6, 16)) < 0.3, device),
    }
    kinds = {"orswot": "orswot", "sparse": "sparse_orswot", "map": "map",
             "sparse_mvmap": "sparse_mvmap", "sparse_nested": "sparse_nested_map",
             "map_orswot": "map_orswot", "map_map": "map_map", "map3": "map3"}
    for entry, kind in kinds.items():
        states[kind] = models[entry].state
    return models, states


def gossip_entry(entry: str, model):
    """The ring entry of ``entry`` as ``fn(state, mesh, **kw)``."""
    from crdt_tpu_torch.parallel import anti_entropy as ae

    if entry == "sparse_mvmap":
        return lambda s, m, **k: ae.mesh_gossip_sparse_mvmap(s, m, sibling_cap=model.sibling_cap,
                                                             **k)
    if entry == "sparse_nested":
        return lambda s, m, **k: ae.mesh_gossip_sparse_nested(s, m, model.level, **k)
    return {"orswot": ae.mesh_gossip, "map": ae.mesh_gossip_map,
            "sparse": ae.mesh_gossip_sparse, "map_orswot": ae.mesh_gossip_map_orswot,
            "map_map": ae.mesh_gossip_nested_map, "map3": ae.mesh_gossip_map3}[entry]


def max_leaf_diff(x, y) -> int:
    """The largest absolute difference over every leaf of two trees (the
    wide view; bool leaves as 0/1)."""
    import torch

    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    ys = [y] if isinstance(y, torch.Tensor) else list(y)
    out = 0
    for a, b in zip(xs, ys):
        if not isinstance(a, torch.Tensor):
            out = max(out, max_leaf_diff(a, b))
        elif a.dtype == torch.bool:
            out = max(out, int((a.cpu() != b.cpu()).any()))
        else:
            out = max(out, max_abs_diff(a.cpu(), b.cpu()))
    return out


def phase_reclaim_scenarios(device, seed: int) -> dict:
    """Small probes of causal-stability reclamation on the card == the CPU
    on every leaf: every kind's ``compact`` (settled states and redrawn
    parked buffers, five frontiers) and ``_observe``; the stable frontier
    with a straggler row pinning it, and ``frontier_lag``; the eight ring
    entries with ``stability=True, telemetry=True`` (rows, flags, the
    frontier, every counted Telemetry field; K1 over each rank of the
    dense ring, K2 over each rank of the Map ring, counted); the sparse
    stream with ``compact_every``; compact-on-save (a covered parked slot
    retired, the file loads on the CPU); ``compact_tenants``; and the three
    ``lifecycle`` functions."""
    import numpy as np
    import torch

    from crdt_tpu_torch import checkpoint, lifecycle, reclaim, telemetry as tele
    from crdt_tpu_torch.config import configured
    from crdt_tpu_torch.delta_opt.decompose import compactors
    from crdt_tpu_torch.models import BatchedGCounter, BatchedOrswot, BatchedPNCounter
    from crdt_tpu_torch.ops import superblock as sb
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import VirtualMesh, iter_blocks, mesh_stream_fold_sparse
    from crdt_tpu_torch.pure import Orswot
    from crdt_tpu_torch.utils import Interner
    from crdt_tpu_torch.vclock import VClock

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    on = lambda x, dev: tree_map(lambda t: t.to(dev), x)  # noqa: E731
    models, states = reclaim_models(seed, cpu)
    gen = np.random.default_rng(seed + 43)
    out = {"phase": "reclaim_scenarios", "card": card_label(device)}

    # ---- every kind's compact and _observe ---------------------------------
    compacted = {}
    for kind, comp in compactors().items():
        freed = 0
        for s in (states[kind], redraw_parked(states[kind], gen)):
            top = comp.top_of(s) if comp.top_of else None
            a = top.shape[-1] if top is not None else 1
            own = (reclaim.stable_frontier(top) if top is not None and top.dim() > 1 else top)
            frontiers = [None, torch.zeros(a, dtype=torch.int32).view(torch.uint32),
                         torch.ones(a, dtype=torch.int32).view(torch.uint32), own]
            check(same_leaves(on_cpu(comp.observe(on(s, device))), comp.observe(s)),
                  f"{kind}: observe card != CPU")
            for f in frontiers:
                got = comp.compact(on(s, device), None if f is None else f.to(device))
                want = comp.compact(s, f)
                check(same_leaves(on_cpu(got[0]), want[0]), f"{kind}: compact card != CPU")
                check(int(got[1]) == int(want[1]) and float(got[2]) == float(want[2]),
                      f"{kind}: freed counts card != CPU")
                freed += int(want[1])
        compacted[kind] = freed
    out["freed_slots_by_kind"] = compacted
    check(sum(compacted.values()) > 0, "reclaim_scenarios: no compaction freed a slot")

    # ---- the frontier: a straggler row pins it -----------------------------
    tops = gen.integers(5, 40, (16, 8)).astype(np.uint32)
    tops[11] = gen.integers(0, 5, 8)
    t_card = on(leaf(tops), device)
    f_card = reclaim.stable_frontier(t_card)
    check(np.array_equal(np_of(f_card), tops.min(0)) and np.array_equal(tops.min(0), tops[11]),
          "the stable frontier != the numpy min (the straggler row)")
    check(int(reclaim.frontier_lag(t_card, f_card)) == int((tops - tops.min(0)).max())
          == int(reclaim.frontier_lag(leaf(tops), tops.min(0))), "frontier_lag card != CPU")

    # ---- the eight ring entries --------------------------------------------
    from crdt_tpu_torch.ops.fold_kernels import fold_cells, fold_entries

    rings = {}
    k1_err = k2_err = 0
    for entry, model in models.items():
        fn = gossip_entry(entry, model)
        b1, b2 = fold_entries.launches, fold_cells.launches
        got = fn(on(model.state, device), VirtualMesh(4, device), stability=True,
                 telemetry=True)
        l1, l2 = fold_entries.launches - b1, fold_cells.launches - b2
        want = fn(model.state, VirtualMesh(4, cpu), stability=True, telemetry=True)
        err = max_leaf_diff(got[0], want[0])
        check(err == 0 and same_leaves(on_cpu(got[0]), want[0]), f"{entry}: rows card != CPU")
        check(torch.equal(got[1].cpu(), want[1]) and same_leaves(got[3].cpu(), want[3]),
              f"{entry}: flags or frontier card != CPU")
        g, w = tele.to_dict(got[2]), tele.to_dict(want[2])
        diff = sorted(k for k in g if k not in HOST_TIMED and g[k] != w[k])
        check(not diff, f"{entry}: telemetry card != CPU on {diff}")
        if entry == "orswot":
            check(device.type != "cuda" or l1 == 4, f"the dense ring launched K1 {l1} times")
            k1_err = max(k1_err, err)
        if entry == "map":
            check(device.type != "cuda" or l2 == 4, f"the Map ring launched K2 {l2} times")
            k2_err = max(k2_err, err)
        rings[entry] = {"k1": l1, "k2": l2, "reclaimed_slots": g["reclaimed_slots"],
                        "frontier_lag": g["frontier_lag"]}
    out["rings"] = rings
    out["k1_max_abs_err"], out["k2_max_abs_err"] = k1_err, k2_err

    # ---- the stream with compact_every -----------------------------------
    sparse = redraw_parked(models["sparse"].state, gen)
    got = mesh_stream_fold_sparse(iter_blocks(on(sparse, device), 2), VirtualMesh(4, device),
                                  compact_every=1, telemetry=True)
    want = mesh_stream_fold_sparse(iter_blocks(sparse, 2), VirtualMesh(4, cpu),
                                   compact_every=1, telemetry=True)
    check(same_leaves(on_cpu(got[0]), want[0]) and torch.equal(got[1].cpu(), want[1]),
          "stream compact_every: card != CPU")
    check(int(got[2].reclaimed_slots) == int(want[2].reclaimed_slots),
          "stream compact_every: reclaimed slots card != CPU")
    out["stream_reclaimed_slots"] = int(want[2].reclaimed_slots)

    # ---- compact-on-save -------------------------------------------------
    site = Orswot()
    add = site.add("m", site.read().derive_add_ctx("s0"))
    reps = []
    for _ in range(3):
        r = Orswot()
        r.apply(add)
        reps.append(r)
    reps[0].deferred[VClock({"s0": 1})] = {"dead"}

    def saved(dev, root, name):
        model = BatchedOrswot.from_pure(reps, members=Interner(["m", "dead"]),
                                        actors=Interner(["s0"]), device=dev)
        checkpoint.save(os.path.join(root, name), model, compact=True)
        return checkpoint.load(os.path.join(root, name), device="cpu")

    loaded = with_scratch_dir(lambda root: {
        "card": saved(device, root, "card.npz"), "cpu": saved(cpu, root, "cpu.npz")})
    check(same_leaves(loaded["card"].state, loaded["cpu"].state)
          and int(loaded["card"].state.dvalid.sum()) == 0,
          "compact-on-save: the card's file != the CPU's, or the covered slot survived")

    # ---- compact_tenants -------------------------------------------------
    for kind, caps in (("orswot", dict(n_elems=8, n_actors=4, deferred_cap=2)),
                       ("sparse_orswot", dict(dot_cap=12, n_actors=4, deferred_cap=2,
                                              rm_width=4))):
        tk = sb.tenant_kind(kind)
        rows = sb.pack([sb.sequential_oracle(tk, tk.empty(**caps, device="cpu"), s)
                        for s in serve_streams(kind, caps, 8, 64, seed)])
        f = rows.top
        got = sb.compact_tenants(tk, on(rows, device), f.to(device))
        want = sb.compact_tenants(tk, rows, f)
        check(same_leaves(on_cpu(got[0]), want[0]) and int(got[1]) == int(want[1])
              and float(got[2]) == float(want[2]), f"compact_tenants {kind}: card != CPU")

    # ---- lifecycle -------------------------------------------------------
    def counters(dev):
        g = BatchedGCounter(2, actors=Interner(["a", "b", "c"]), n_actors=8, device=dev)
        pn = BatchedPNCounter(2, actors=Interner(["a", "b", "c"]), n_actors=8, device=dev)
        for row in range(2):
            g.inc(row, "a", 2**32 - 1)
            g.inc(row, "b", 5)
            pn.inc(row, "a", 10)
            pn.dec(row, "a", 3)
            pn.inc(row, "b", 5)
        lifecycle.retire_actor(g, "a")
        lifecycle.retire_actor(pn, "a")
        lifecycle.compact_actors(g)
        lifecycle.compact_actors(pn)
        with configured(counter_dtype="uint64"):
            lifecycle.widen_counters(g)
        g.inc(0, "b", 7)
        return g, pn

    (gc, pc), (gh, ph) = counters(device), counters(cpu)
    check(same_leaves(gc.inner.clocks.cpu(), gh.inner.clocks)
          and same_leaves((pc.p.clocks.cpu(), pc.n.clocks.cpu()), (ph.p.clocks, ph.n.clocks))
          and gc.read(0) == gh.read(0) == 2**32 - 1 + 12 and pc.read(1) == ph.read(1) == 12
          and list(gc.actors.items()) == list(gh.actors.items()),
          "lifecycle: the card's counters != the CPU's")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def leaf(x):
    """A numpy array as a CPU tensor of the same dtype."""
    from crdt_tpu_torch.convert import leaf_from_numpy

    return leaf_from_numpy(x, "cpu")


def np_of(t):
    from crdt_tpu_torch.convert import leaf_to_numpy

    return leaf_to_numpy(t)


def reclaim_host_count(dcl, dvalid, top, frontier) -> int:
    """The slots compaction must free, counted in numpy: valid slots whose
    clock the frontier and the row's own top both cover, plus dead slots
    with a nonzero clock."""
    import numpy as np

    dcl, dvalid, top = np_of(dcl).astype(np.int64), np_of(dvalid), np_of(top).astype(np.int64)
    f = np.asarray(frontier).astype(np.int64)
    covered = dvalid & np.all(dcl <= f, -1) & np.all(dcl <= top[..., None, :], -1)
    stale = ~dvalid & np.any(dcl != 0, -1)
    return int(covered.sum() + stale.sum())


def phase_full_width_reclaim(device, seed: int, r: int = 5120, e: int = 102400, a: int = 8,
                             d: int = 4, p: int = 8, chunk: int = 128, repeats: int = 5,
                             sp_r: int = 256, sp_cap: int = 4096, sp_universe: int = 1_000_000,
                             sp_start_cap: int = 1024, waves=(12, 1, 1), rounds: int = 3,
                             inject: int = 16) -> dict:
    """Causal-stability reclamation at full width.

    (a) Dense ORSWOT at config 3's widths (E = 102,400, A = 8, D = 4) on P
    = 8 ranks, ``full_width_delta``'s fill and cut (R = 5,120: the fill
    also builds the 16.8 GB ``fctx`` a second state would double). Every
    rank parks removes ahead of its tops; one replica is the synced
    straggler (its top pins the frontier at the synced top); slots covered
    by every top are injected into free parked slots (the restore shape,
    over members dead everywhere), with stale dead lanes and slots only
    the own top covers (pinned). Gates: ``mesh_gossip(stability=True)``'s
    rows read the same as ``stability=False``'s and equal their
    compaction; the frontier == the numpy min of the input tops;
    ``reclaimed_slots`` == the host count of covered and stale slots in
    the converged rows; K1 launched ``p`` times, each rank's launch ==
    the plain fold of its block; ``ops.compact`` of the input frees
    exactly the host count of its covered and stale slots, reads kept.
    Walls with stability on and off (median of ``repeats``, alternating,
    CUDA events), the compactions' own ms, K1's ms on one rank block.

    (b) Sparse ORSWOT churn at ``BENCH_CONFIGS.json`` "sparse" widths
    (``sp_r`` replicas, ``dot_cap`` ``sp_cap``, a ``sp_universe`` member
    universe) on P = 8: ``bench.py``'s ``bench_reclaim`` loop with the ops
    built as arrays (one lane-batched add a wave, each replica its own
    actor; the removing replica's observe-removes in ``rm_width`` lists):
    ``waves`` gives each wave's adds per replica; then ``rounds``
    ``gossip_elastic(stability=True, reclaim=Hysteresis(0.25, 2, 4))``
    against a flags-off twin that commits its rows. The model starts at
    ``sp_start_cap`` so the first wave widens. Gates: the membership of
    every replica == the twin's after every round; at least one widen and
    one ``dot_cap`` shrink."""
    import numpy as np
    import torch

    from crdt_tpu_torch import elastic, reclaim
    from crdt_tpu_torch.models import BatchedSparseOrswot
    from crdt_tpu_torch.ops import orswot as ops
    from crdt_tpu_torch.ops import sparse_orswot as sp
    from crdt_tpu_torch.ops.fold_kernels import fold_entries, fold_entries_plain
    from crdt_tpu_torch.ops.orswot import _join_entries
    from crdt_tpu_torch.parallel import VirtualMesh, gossip_elastic, mesh_gossip
    from crdt_tpu_torch.parallel.anti_entropy import _compact_ranks, rank_blocks
    from crdt_tpu_torch.utils import Interner
    from crdt_tpu_torch.utils.metrics import metrics, state_nbytes
    from crdt_tpu_torch._dtypes import bits, from_wide, to_wide

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
    mesh = VirtualMesh(p, device)
    rl = r // p
    t0 = time.perf_counter()
    synced = []
    state, dirty, fctx, info = fill_delta_config3(r, e, a, d, p, seed, device, chunk,
                                                  synced_out=synced)
    del dirty, fctx
    if on_card:
        torch.cuda.empty_cache()
    top0 = synced[0].top
    # The straggler: rank 5's replica 1 holds the synced state alone.
    strag = 5 * rl + 1
    bits(state.top)[strag] = bits(top0)
    bits(state.ctr)[strag] = bits(synced[0].ctr)
    bits(state.dcl)[strag] = 0
    state.dmask[strag] = False
    state.dvalid[strag] = False
    # Members dead in every replica carry the injected slots' masks.
    dead = ~torch.any((bits(state.ctr) != 0).any(-1), 0)
    dead_ids = torch.nonzero(dead)[:inject, 0]
    check(dead_ids.numel() == inject, "too few members dead everywhere to inject")
    rows = torch.arange(r, device=device)
    rank = rows // rl
    free_last = ~state.dvalid[:, d - 1]
    cover = free_last & (rank % 2 == 0) & (rows != strag)
    stale = free_last & (rank % 2 == 1) & (rows != strag)
    pinned = ~state.dvalid[:, d - 2] & (rank < 2) & (rows != strag)
    pin_clock = to_wide(top0).clone()
    pin_clock[0] += 1
    dcl_w = to_wide(state.dcl)
    dcl_w[:, d - 1] = torch.where((cover | stale)[:, None], to_wide(top0), dcl_w[:, d - 1])
    dcl_w[:, d - 2] = torch.where(pinned[:, None], pin_clock, dcl_w[:, d - 2])
    bits(state.dcl).copy_(bits(from_wide(dcl_w, torch.uint32)))
    for slot, sel in ((d - 1, cover), (d - 2, pinned)):
        state.dmask[sel, slot] = False
        state.dmask[sel.nonzero()[:, :1], slot, dead_ids[None, :]] = True
        state.dvalid[:, slot] |= sel
    sync()
    setup_s = time.perf_counter() - t0
    tops_np = np_of(state.top)
    frontier_np = tops_np.min(0)
    check(np.array_equal(frontier_np, np_of(top0)), "the straggler does not pin the frontier")

    # The input's compaction: frees exactly its covered and stale slots.
    want_in = reclaim_host_count(state.dcl, state.dvalid, state.top, frontier_np)
    comp, freed_in, bytes_in = ops.compact(state, leaf(frontier_np).to(device))
    check(int(freed_in) == want_in and want_in > 0,
          f"compacting the input freed {int(freed_in)} slots, the host counts {want_in}")
    check(torch.equal(ops._observe(comp), ops._observe(state)),
          "compacting the input changed a read")
    del comp
    compact_in_ms = statistics.median(
        time_ms(lambda: ops.compact(state, leaf(frontier_np).to(device)), device)
        for _ in range(repeats))

    # The ring, counted: stability=True launches K1 once per rank.
    b1 = fold_entries.launches
    on_out = mesh_gossip(state, mesh, stability=True, telemetry=True)
    k1_launches = fold_entries.launches - b1
    check(not on_card or k1_launches == p, f"mesh_gossip launched K1 {k1_launches} times")
    off_out = mesh_gossip(state, mesh)
    check(np.array_equal(np_of(on_out[3]), frontier_np), "the ring's frontier != the numpy min")
    check(torch.equal(ops._observe(on_out[0]), ops._observe(off_out[0])),
          "stability=True changed a converged read")
    ring_comp, freed_r, bytes_r = _compact_ranks(ops.compact, off_out[0], on_out[3])
    check(same_leaves(on_out[0], ring_comp), "the stability rows != the compacted flags-off rows")
    want_ring = reclaim_host_count(off_out[0].dcl, off_out[0].dvalid, off_out[0].top,
                                   frontier_np)
    tel = on_out[2]
    check(int(tel.reclaimed_slots) == want_ring == int(freed_r),
          f"reclaimed_slots {int(tel.reclaimed_slots)} != the host count {want_ring}")
    compact_ring_ms = statistics.median(
        time_ms(lambda: _compact_ranks(ops.compact, off_out[0], on_out[3]), device)
        for _ in range(repeats))
    # Each rank's K1 launch == the plain fold of its block.
    blocks = rank_blocks(state, mesh)
    k1_err = 0
    for q in range(p):
        kt, kc = fold_entries(blocks.top[q], blocks.ctr[q])
        acc = None
        for lo in range(0, rl, chunk):
            pt, pc = fold_entries_plain(blocks.top[q, lo:lo + chunk], blocks.ctr[q, lo:lo + chunk])
            part = (to_wide(pt), to_wide(pc))
            acc = part if acc is None else _join_entries(*acc, *part)
        k1_err = max(k1_err, max_abs_diff(kt, from_wide(acc[0], torch.uint32)),
                     max_abs_diff(kc, from_wide(acc[1], torch.uint32)))
        del kt, kc, acc
    check(k1_err == 0, f"a rank's K1 launch != its plain fold (max {k1_err})")
    k1_ms = statistics.median(time_ms(lambda: fold_entries(blocks.top[0], blocks.ctr[0]), device)
                              for _ in range(repeats))
    walls = {True: [], False: []}
    for _ in range(repeats):
        for flag in (False, True):
            walls[flag].append(time_ms(lambda: mesh_gossip(state, mesh, stability=flag), device))
    dense = {
        "R": r, "E": e, "A": a, "D": d, "P": p, "setup_s": setup_s,
        "injected": {"covered": int(cover.sum()), "stale": int(stale.sum()),
                     "pinned": int(pinned.sum()), "straggler_row": strag},
        "frontier": frontier_np.tolist(),
        "input_compaction": {"freed_slots": int(freed_in), "freed_bytes": float(bytes_in),
                             "host_count": want_in, "ms": compact_in_ms},
        "ring": {"reclaimed_slots": int(tel.reclaimed_slots),
                 "reclaimed_bytes": float(tel.reclaimed_bytes),
                 "frontier_lag": int(tel.frontier_lag), "host_count": want_ring,
                 "compaction_ms": compact_ring_ms,
                 "wall_ms_stability_on": statistics.median(walls[True]),
                 "wall_ms_stability_off": statistics.median(walls[False]),
                 "walls_on": walls[True], "walls_off": walls[False]},
        "k1_launches": k1_launches, "k1_max_abs_err": k1_err, "k1_ms_rank_block": k1_ms,
    }
    del state, blocks, on_out, off_out, ring_comp
    if on_card:
        torch.cuda.empty_cache()

    # ---- (b) the sparse churn ----------------------------------------------
    t0 = time.perf_counter()
    before = kernel_launches()
    mk = lambda: BatchedSparseOrswot(sp_r, sp_start_cap, sp_r, deferred_cap=4, rm_width=4,  # noqa: E731
                                     members=Interner(), actors=Interner(range(sp_r)),
                                     device=device)
    model, twin = mk(), mk()
    policy = elastic.ElasticPolicy(low_water=0.25, shrink_rounds=2, shrink_floor=4)
    hyst = elastic.Hysteresis(policy)
    snap0 = metrics.snapshot()["counters"]
    actors = torch.arange(sp_r, device=device)
    base = 0
    widened, peak_bytes, peak_twin, lag, read_checks = {}, 0, 0, None, 0
    cap_trace = []
    for w, adds in enumerate(waves):
        eids = (base + torch.arange(sp_r * adds, device=device, dtype=torch.int32)).view(sp_r,
                                                                                       adds)
        base += sp_r * adds
        check(base <= sp_universe, "the churn ran past the member universe")
        counter = torch.full((sp_r,), w + 1, dtype=torch.int32, device=device).view(torch.uint32)
        for m in (model, twin):
            def add(m=m):
                st, of = sp.apply_add(m.state, actors, counter, eids)
                if bool(of.any()):
                    raise elastic.DotCapacityOverflow("churn add")
                m.state = st
            elastic.elastic_call(add, m, policy)
        # One replica observe-removes 3/4 of its view, rm_width ids an op.
        j = w % sp_r
        row = model.state.eid[j][model.state.valid[j]]
        view = torch.unique(row)
        victims = view[: (view.numel() * 3) // 4]
        width = model.state.didx.shape[-1]
        for m in (model, twin):
            for lo in range(0, victims.numel(), width):
                ids = torch.full((width,), -1, dtype=torch.int32, device=device)
                chunk_ids = victims[lo:lo + width]
                ids[:chunk_ids.numel()] = chunk_ids
                st = tree_row(m.state, j)
                st, of = sp.apply_rm(st, m.state.top[j], ids)
                check(not bool(of), "the churn's observed remove parked")
                m.state = tree_set_row(m.state, j, st)
        for _ in range(rounds):
            # R > P: the rows cannot be committed into the model (each rank
            # folded 32 replicas), so every replica adopts the converged row
            # after the call, at the model's capacity (a shrink inside the
            # call narrowed the model, not the returned rows).
            got = gossip_elastic(model, mesh, policy=policy, telemetry=True, stability=True,
                                 reclaim=hyst)
            widened.update(got[1])
            lag = int(got[2].frontier_lag)
            deliver(model, got[0], sp_r)
            deliver(twin, gossip_elastic(twin, mesh, policy=policy)[0], sp_r)
            check(same_members(sp._observe(model.state), sp._observe(twin.state)),
                  f"churn wave {w}: a read differs from the flags-off twin's")
            read_checks += 1
            peak_bytes = max(peak_bytes, state_nbytes(model.state))
            peak_twin = max(peak_twin, state_nbytes(twin.state))
            cap_trace.append(elastic.capacities(model)["dot_cap"])
    snap1 = metrics.snapshot()["counters"]
    delta = lambda k: snap1.get(k, 0) - snap0.get(k, 0)  # noqa: E731
    shrinks = delta("reclaim.shrink_events.sparse_orswot")
    check(widened.get("dot_cap") and delta("elastic.widen_events.sparse_orswot") >= 1,
          "the churn never widened")
    check(shrinks >= 1 and min(cap_trace[cap_trace.index(max(cap_trace)):]) < max(cap_trace),
          f"the churn never shrank dot_cap: {cap_trace}")
    churn = {
        "replicas": sp_r, "universe": sp_universe, "dot_cap_config": sp_cap,
        "dot_cap_start": sp_start_cap, "waves": list(waves), "rounds_per_wave": rounds,
        "dot_cap_trace": cap_trace, "widened": widened, "shrink_events": shrinks,
        "reclaimed_bytes": delta("reclaim.reclaimed_bytes"),
        "peak_state_bytes": peak_bytes, "peak_state_bytes_twin": peak_twin,
        "end_state_bytes": state_nbytes(model.state),
        "end_state_bytes_twin": state_nbytes(twin.state),
        "frontier_lag_final": lag, "read_checks": read_checks,
        "launches": check_no_kernel(before, "full_width_reclaim (b)"),
        "s": time.perf_counter() - t0,
    }
    out = {"phase": "full_width_reclaim", "card": card_label(device), "dense": dense,
           "churn": churn,
           "reduced": {"R": f"{r} of config 3's 10,240 (full_width_delta's cut: the fill "
                             f"builds fctx too)",
                       "dot_cap_start": f"{sp_start_cap} (grows to the config's {sp_cap})"},
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def deliver(model, rows, n: int) -> None:
    """Every one of the model's ``n`` replicas adopts the converged row of
    a ring (every rank's row equal: checked), narrowed to the model's
    current capacities."""
    from crdt_tpu_torch import elastic
    from crdt_tpu_torch.ops import sparse_orswot as sp
    from crdt_tpu_torch.ops.lattice import tree_map

    row = tree_row(rows, 0)
    check(same_leaves(rows, tree_map(lambda x: x.expand(rows.top.shape[0], *x.shape), row)),
          "the ring's rows are not converged")
    state = tree_map(lambda x: x.expand(n, *x.shape).clone(), row)
    caps = elastic.capacities(model)
    if state.eid.shape[-1] > caps["dot_cap"]:
        state = sp.narrow(state, dot_cap=caps["dot_cap"])
    model.state = state


def tree_row(state, j: int):
    from crdt_tpu_torch.ops.lattice import tree_map

    return tree_map(lambda x: x[j], state)


def tree_set_row(state, j: int, row):
    """``state`` with row ``j`` replaced by ``row`` (new tensors)."""
    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.ops.lattice import tree_map

    def put(x, y):
        x = x.clone()
        bits(x)[j] = bits(y)
        return x

    return tree_map(put, state, row)


def same_members(a, b) -> bool:
    """Two ``sparse_orswot._observe`` reads equal: the same sorted member
    ids per replica, the wider one's extra lanes all -1."""
    import torch

    w = min(a.shape[-1], b.shape[-1])
    return (torch.equal(a[..., :w], b[..., :w]) and bool((a[..., w:] == -1).all())
            and bool((b[..., w:] == -1).all()))


# ---- the fault plane (ROADMAP 15.4, 15.3) ------------------------------------

FAULT_PLANS = {
    "zero": dict(seed=1),
    "chaos": dict(seed=42, corrupt=0.6, drop=0.2, delay=0.2, evicted=(2,)),
    "dead": dict(seed=9, drop=0.1, delay=0.3, dead=(1,)),
    "evicted": dict(seed=3, evicted=(1,)),
    "corrupt_all": dict(seed=2, corrupt=1.0),
}


def local_fold_of(kind: str):
    """The local fold of a rank block of one δ ring kind."""
    from crdt_tpu_torch.ops import map as map_ops
    from crdt_tpu_torch.ops import map3 as m3_ops
    from crdt_tpu_torch.ops import map_orswot as mo_ops
    from crdt_tpu_torch.ops.fold_kernels import fold_auto

    return {"orswot": fold_auto, "map": map_ops.fold, "map_orswot": mo_ops.fold,
            "map3": m3_ops.fold}[kind]


def genesis_ring_inputs(kind: str, state, device):
    """``(ring, state, dirty, fctx)`` of one δ ring kind on ``device``:
    the tracking of replicas last synced at genesis (every live row dirty
    with its own dots, ``interval_accumulate`` from the zero state)."""
    import torch

    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import (
        interval_accumulate, interval_accumulate_m3, interval_accumulate_map,
        interval_accumulate_mo, mesh_delta_gossip, mesh_delta_gossip_map,
        mesh_delta_gossip_map3, mesh_delta_gossip_map_orswot,
    )

    state = tree_map(lambda x: x.to(device), state)
    zero = tree_map(torch.zeros_like, state)
    if kind == "map":
        valid = state.child.valid
        dirty = torch.zeros(valid.shape[:2], dtype=torch.bool, device=device)
        fctx = torch.zeros((*valid.shape[:2], state.top.shape[-1]), dtype=torch.int32,
                           device=device).view(torch.uint32)
        return (mesh_delta_gossip_map, state,
                *interval_accumulate_map(dirty, fctx, zero, state))
    core = {"orswot": lambda s: s, "map_orswot": lambda s: s.core,
            "map3": lambda s: s.mo.core}[kind]
    track = {"orswot": interval_accumulate, "map_orswot": interval_accumulate_mo,
             "map3": interval_accumulate_m3}[kind]
    ring = {"orswot": mesh_delta_gossip, "map_orswot": mesh_delta_gossip_map_orswot,
            "map3": mesh_delta_gossip_map3}[kind]
    c = core(state)
    dirty = torch.zeros(c.ctr.shape[:-1], dtype=torch.bool, device=device)
    return ring, state, *track(dirty, torch.zeros_like(c.ctr), zero, state)


def assert_fault_parity(got, want, what: str) -> None:
    """A faulted run on the card == the same run on the CPU: every output
    leaf, the counters and every counted Telemetry field."""
    import torch

    from crdt_tpu_torch import telemetry as tele

    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, tele.Telemetry):
            gd, wd = tele.to_dict(g), tele.to_dict(w)
            diff = sorted(k for k in gd if k not in HOST_TIMED and gd[k] != wd[k])
            check(not diff, f"{what}: telemetry card != CPU on {diff}")
        elif isinstance(g, tuple):
            check(same_leaves(on_cpu(g), w), f"{what}: output {i} card != CPU")
        elif isinstance(g, torch.Tensor):
            check(same_leaves(g.cpu(), w), f"{what}: output {i} card != CPU")
        else:
            check(g == w, f"{what}: output {i} card != CPU ({g} vs {w})")


def parked_pures(n: int, parked_each: int):
    """Oracle replicas with one add each and ``parked_each`` parked removes
    no add ever covers (phantom actors), distinct across replicas: a ring
    must hold their union, so a small ``deferred_cap`` overflows mid-ring
    (the JAX elastic tests' population)."""
    from crdt_tpu_torch.pure.orswot import Orswot
    from crdt_tpu_torch.vclock import VClock

    reps = [Orswot() for _ in range(n)]
    for i, rep in enumerate(reps):
        rep.apply(rep.add(f"m{i}_0", rep.read().derive_add_ctx(f"s{i}")))
        for j in range(parked_each):
            rep.deferred[VClock({f"ghost{i}_{j}": 1})] = {f"m{i}_0"}
    return reps


def disjoint_sparse_blocks(n_blocks: int, rows: int, cap: int, n_actors: int, device):
    """Blocks whose join outgrows any one block's ``dot_cap``: row ``i`` of
    block ``b`` holds one dot of its own actor on its own element (the
    JAX stream tests' ``_disjoint_blocks``)."""
    import torch

    from crdt_tpu_torch.ops import sparse_orswot as sp

    blocks = []
    for b in range(n_blocks):
        st = sp.empty(cap, n_actors, batch=(rows,), device=device)
        actors = torch.arange(b * rows, (b + 1) * rows, device=device)
        top = torch.zeros((rows, n_actors), dtype=torch.int32, device=device)
        top[torch.arange(rows, device=device), actors] = 1
        eid, act, ctr, valid = st.eid.clone(), st.act.clone(), st.ctr.view(torch.int32).clone(), \
            st.valid.clone()
        eid[:, 0] = 1000 * b + torch.arange(rows, device=device, dtype=eid.dtype)
        act[:, 0] = actors.to(act.dtype)
        ctr[:, 0] = 1
        valid[:, 0] = True
        blocks.append(st._replace(top=top.view(torch.uint32), eid=eid, act=act,
                                  ctr=ctr.view(torch.uint32), valid=valid))
    return blocks


def phase_faults_scenarios(device, seed: int, p: int = 4, rounds: int = 12, cap: int = 8) -> dict:
    """Small probes of the fault plane on the card == the CPU on every
    leaf, the ``FaultCounters`` and the Telemetry's ``faults_*`` fields:
    the four δ ring kinds, fused and layered, under the zero-rate, chaos,
    dead-sender, eviction-only and total-corruption plans (K3 once per
    fused round, each launch held against its plain version); the eight
    ``mesh_gossip*`` entries and both elastic wrappers; the four stream
    plans with ``faults=`` and one with ``widen_policy=``; the faulted
    ``bootstrap`` and ``bootstrap_rejects_corruption``; the ``Membership``
    protocol over a card ring's streaks. Gates: a zero-rate plan is
    bit-identical to ``faults=None``; with ``corrupt=0`` no packet is
    rejected on the card (K3's chained ``chk`` == the receiver's plain
    checksum); ``corrupt=1.0`` rejects every live link and keeps each
    rank's local state."""
    import functools

    import numpy as np
    import torch

    from crdt_tpu_torch.elastic import ElasticPolicy
    from crdt_tpu_torch.faults import FaultPlan, Membership
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.ops.fold_kernels import fold_entries
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import (
        VirtualMesh, delta_gossip_elastic, gossip_elastic, iter_blocks, mesh_stream_fold,
        mesh_stream_fold_sparse, mesh_stream_fold_sparse_mvmap, mesh_stream_fold_sparse_sharded,
        split_segments,
    )
    from crdt_tpu_torch.parallel.anti_entropy import local_folds, rank_blocks
    from crdt_tpu_torch.scaleout import bootstrap, bootstrap_rejects_corruption
    from crdt_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    on_card = device.type == "cuda"
    on = lambda x, dev: tree_map(lambda t: t.to(dev), x)  # noqa: E731
    models, _ = reclaim_models(seed, cpu)
    out = {"phase": "faults_scenarios", "card": card_label(device), "P": p, "rounds": rounds}

    # ---- the four δ ring kinds -------------------------------------------
    rings, k3_err, k1_err = {}, 0, 0
    for kind in ("orswot", "map", "map_orswot", "map3"):
        ring, st_h, d_h, f_h = genesis_ring_inputs(kind, models[kind].state, cpu)
        st_c, d_c, f_c = on(st_h, device), d_h.to(device), f_h.to(device)
        for fused in (True, False):
            kw = dict(rounds=rounds, cap=cap, fused=fused, telemetry=True)
            clean = ring(st_c, d_c, f_c, VirtualMesh(p, device), **kw)
            for name, plan in FAULT_PLANS.items():
                what = f"{kind} fused={fused} {name}"
                fp = FaultPlan(**plan)
                l3, l1 = wire_pack.launches, fold_entries.launches
                with K3Checked() as k3:
                    got = ring(st_c, d_c, f_c, VirtualMesh(p, device), faults=fp, **kw)
                l3, l1 = wire_pack.launches - l3, fold_entries.launches - l1
                want = ring(st_h, d_h, f_h, VirtualMesh(p, cpu), faults=fp, **kw)
                assert_fault_parity(got, want, what)
                fc = got[-1]
                counts = [int(x.view(torch.int32)) for x in fc[:3]]
                k3_err = max(k3_err, k3.max_abs_err)
                if kind == "orswot":
                    k1_err = max(k1_err, max_leaf_diff(got[0], want[0]))
                if on_card and fused:
                    check(l3 == rounds and k3.calls == rounds,
                          f"{what}: K3 launched {l3} times in {rounds} rounds")
                if on_card and kind in ("orswot", "map_orswot", "map3"):
                    check(l1 == p, f"{what}: K1 launched {l1} times on {p} ranks")
                if plan.get("corrupt", 0) == 0:
                    check(counts[1] == 0, f"{what}: {counts[1]} packets rejected at corrupt=0")
                if name == "zero":
                    check(counts == [0, 0, 0] and same_leaves(got[:4], clean[:4]),
                          f"{what}: a zero-rate plan differs from faults=None")
                if name == "corrupt_all":
                    local, _ = local_folds(rank_blocks(st_c, VirtualMesh(p, device)),
                                           local_fold_of(kind))
                    check(counts[1] == p * rounds and counts[0] == 0,
                          f"{what}: rejected {counts[1]} of {p * rounds} live links")
                    check(fc.miss_streak.tolist() == [rounds] * p and int(got[3]) >= 1,
                          f"{what}: the streaks or the residue of total corruption")
                    check(same_leaves(got[0], local), f"{what}: a rank lost its local state")
                if name == "evicted":
                    check(counts == [0, 0, 0], f"{what}: an eviction-only plan lost packets")
                rings[what] = {"dropped": counts[0], "rejected": counts[1],
                               "delayed": counts[2], "residue": int(got[3]),
                               "k3": l3, "k1": l1}
    out["rings"] = len(rings)
    out["packets_absorbed"] = sum(v["dropped"] + v["rejected"] + v["delayed"]
                                  for v in rings.values())
    out["k3_max_abs_err"], out["k1_max_abs_err"] = k3_err, k1_err

    # ---- the eight gossip entries and the elastic wrappers ---------------
    gossip_plan = FaultPlan(seed=7, corrupt=0.3, drop=0.2, delay=0.3, evicted=(1,))
    lost = 0
    for entry, model in models.items():
        fn = gossip_entry(entry, model)
        got = fn(on(model.state, device), VirtualMesh(p, device), stability=True,
                 telemetry=True, faults=gossip_plan)
        want = fn(model.state, VirtualMesh(p, cpu), stability=True, telemetry=True,
                  faults=gossip_plan)
        assert_fault_parity(got, want, f"gossip {entry}")
        lost += int(got[-1].packets_dropped) + int(got[-1].packets_rejected)
    check(lost > 0, "the faulted gossip entries lost no packet")
    out["gossip_entries"], out["gossip_packets_lost"] = len(models), lost
    sites = parked_pures(p, 2)
    elastic_plan = FaultPlan(**FAULT_PLANS["chaos"])
    for name, run in (
            ("gossip_elastic", lambda m, dev: gossip_elastic(m, VirtualMesh(p, dev),
                                                             faults=elastic_plan)),
            ("delta_gossip_elastic", lambda m, dev: delta_gossip_elastic(
                m, *genesis_ring_inputs("orswot", m.state, dev)[2:], VirtualMesh(p, dev),
                faults=elastic_plan))):
        got = run(BatchedOrswot.from_pure(sites, deferred_cap=2, n_members=8, n_actors=16,
                                          device=device), device)
        want = run(BatchedOrswot.from_pure(sites, deferred_cap=2, n_members=8, n_actors=16,
                                           device=cpu), cpu)
        assert_fault_parity(got, want, name)
        check(bool(got[-2 if name == "gossip_elastic" else 4]),
              f"{name}: the parked overflow did not widen")
        out[name] = {"widened": got[-2 if name == "gossip_elastic" else 4],
                     "rejected": int(got[-1].packets_rejected)}

    # ---- the four stream plans under faults= -------------------------------
    lossy = FaultPlan(seed=5, drop=0.4, corrupt=0.4)
    sparse, dense, mvmap = (models[k].state for k in ("sparse", "orswot", "sparse_mvmap"))
    cap_mv = models["sparse_mvmap"].sibling_cap
    streams = {
        "sparse": lambda st, dev: mesh_stream_fold_sparse(
            iter_blocks(st, 1), VirtualMesh(p, dev), faults=lossy, telemetry=True),
        "dense": lambda st, dev: mesh_stream_fold(
            iter_blocks(st, 1), VirtualMesh(p, dev), faults=lossy, telemetry=True),
        "mvmap": lambda st, dev: mesh_stream_fold_sparse_mvmap(
            iter_blocks(st, 1), VirtualMesh(p, dev), sibling_cap=cap_mv, faults=lossy,
            telemetry=True),
        "sharded": lambda st, dev: mesh_stream_fold_sparse_sharded(
            iter_blocks(split_segments(st, 2), 1), VirtualMesh(p, dev, s=2), faults=lossy,
            telemetry=True),
    }
    sources = {"sparse": sparse, "dense": dense, "mvmap": mvmap, "sharded": sparse}
    stream_lost = {}
    for name, run in streams.items():
        got = run(on(sources[name], device), device)
        want = run(sources[name], cpu)
        assert_fault_parity(got[:3], want[:3], f"stream {name}")
        check((got[3].dropped_blocks, got[3].rejected_blocks)
              == (want[3].dropped_blocks, want[3].rejected_blocks),
              f"stream {name}: the fault report card != CPU")
        stream_lost[name] = got[3].lost_blocks
    check(any(stream_lost.values()), "no faulted stream lost a block")
    out["stream_lost_blocks"] = stream_lost

    # ---- widen_policy= (15.3) ----------------------------------------------
    retries0 = metrics.snapshot()["counters"].get("stream.widen_retries", 0)
    got = mesh_stream_fold_sparse(iter(disjoint_sparse_blocks(4, p, 4, 16, device)),
                                  VirtualMesh(p, device), widen_policy=ElasticPolicy(),
                                  telemetry=True)
    retries = metrics.snapshot()["counters"].get("stream.widen_retries", 0) - retries0
    want = mesh_stream_fold_sparse(iter(disjoint_sparse_blocks(4, p, 4, 16, cpu)),
                                   VirtualMesh(p, cpu), widen_policy=ElasticPolicy(),
                                   telemetry=True)
    assert_fault_parity(got, want, "stream widen_policy")
    check(retries >= 1 and not bool(got[1].any()) and int(got[0].valid.sum()) == 4 * p,
          f"widen_policy: {retries} retries, flags {got[1].tolist()}")
    out["widen"] = {"retries": retries, "dot_cap": got[0].eid.shape[-1]}

    # ---- the faulted bootstrap ---------------------------------------------
    boot = {}
    for kind in ("orswot", "sparse_orswot", "map", "mvreg"):
        arrays = kind_arrays(kind, np.random.default_rng(seed + 45))
        runs = [bootstrap(kind, kind_state(kind, arrays, dev), faults=FaultPlan(seed=23,
                          corrupt=0.7), segment_cap=3, max_attempts=256) for dev in (device, cpu)]
        check(same_leaves(on_cpu(runs[0][0]), runs[1][0]) and runs[0][1] == runs[1][1]
              and same_leaves(runs[1][0], kind_state(kind, arrays, cpu)),
              f"bootstrap {kind}: card != CPU, or the landing != live")
        boot[kind] = runs[0][1].rejected
    check(bootstrap_rejects_corruption(bootstrap, device=device),
          "bootstrap_rejects_corruption failed the honest receiver")
    check(not bootstrap_rejects_corruption(functools.partial(bootstrap, verify_checksums=False),
                                           device=device),
          "bootstrap_rejects_corruption passed the corrupt-blind receiver")
    out["bootstrap_rejected"] = boot

    # ---- the membership protocol over a card ring ------------------------
    ring, st_c, d_c, f_c = genesis_ring_inputs("orswot", models["orswot"].state, device)
    tracker = Membership(p, k_suspect=rounds + 1)
    base = FaultPlan(seed=9, dead=(1,))
    suspects = []
    for _ in range(2):
        fc = ring(st_c, d_c, f_c, VirtualMesh(p, device), rounds=rounds, cap=cap,
                  faults=tracker.plan(base))[-1]
        suspects.append(tracker.observe(fc, rounds=rounds))
    check(suspects == [(), (1,)], f"membership: suspects {suspects}, expected rank 1 second")
    tracker.evict(1)
    fc = ring(st_c, d_c, f_c, VirtualMesh(p, device), rounds=rounds, cap=cap,
              faults=tracker.plan(base))[-1]
    check(int(fc.packets_dropped) == 0 and tracker.observe(fc, rounds=rounds) == (),
          "membership: the evicted dead rank still cost packets")
    tracker.rejoin(1)
    out["membership"] = {"suspected": list(suspects[-1]), "evicted_then_rejoined": [1]}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def one_faulted_dense_round(state, dirty, fctx, mesh, cap: int, plan):
    """The dense fused faulted round, spelled out as the ring runs it at
    round 0 (extract, K3's pack with its checksum lane, the shift, the
    fates, corruption, verify, unpack, apply, deselect, counters): the
    piece a sync-debug run holds to no host sync."""
    import torch

    from crdt_tpu_torch._dtypes import bits, umax
    from crdt_tpu_torch.faults import inject as flt
    from crdt_tpu_torch.ops.fold_kernels import fold_auto
    from crdt_tpu_torch.parallel import wire as wire_mod
    from crdt_tpu_torch.parallel.anti_entropy import local_folds, rank_blocks
    from crdt_tpu_torch.parallel.collectives import permuter
    from crdt_tpu_torch.parallel.delta import apply_delta, extract_delta
    from crdt_tpu_torch.parallel.delta_ring import _packet_template, _select_apply

    p = mesh.p
    ranks, of = local_folds(rank_blocks(state, mesh), fold_auto)
    rl = dirty.shape[0] // p
    e, a = ranks.ctr.shape[-2:]
    d0 = dirty.view(p, rl, e).any(1)
    f0 = torch.stack([bits(umax(fctx.view(p, rl, e, a)[q], 0)) for q in range(p)]).view(
        fctx.dtype)
    shift = permuter(flt.ring_perm(p, plan.evicted), p, mesh.device)
    rtop = permuter(flt.inv_ring_perm(p, plan.evicted), p, mesh.device)(ranks.top)
    codec = wire_mod.WireCodec(_packet_template(ranks, cap, fctx.dtype), e,
                               wire_mod.know_dense, gated=True, acked=False)
    fates = flt.LinkFates(plan, 1, p, mesh.device)
    fc = flt.zero_counters(p, mesh.device)

    def round_():
        pkt, d, f = extract_delta(ranks, d0, f0, cap, start=0)
        wired, aux = codec.pack(pkt, rtop=rtop)
        d = wire_mod.remark_deferred(d, wire_mod.core_idx(pkt), aux.defer)
        wired, chk = shift((wired, aux.checksum))
        wired, keep, fts = flt.receive_wire(fates, 0, wired, chk, delay_ok=plan.delay > 0)
        rcvd = codec.unpack(wired, own_top=ranks.top)
        st, d, f, of_r = _select_apply(apply_delta(ranks, rcvd, d, f), (ranks, d, f), of, keep)
        return st, flt.tick_counters(fc, fts)

    return round_


def phase_full_width_chaos(device, seed: int, r: int = 5120, e: int = 102400, a: int = 8,
                           d: int = 4, p: int = 8, cap: int = 4096, chunk: int = 128,
                           runs: int = 3, stream_r: int = 10240, universe: int = 1_000_000,
                           segment_cap: int = 4096, block_rows: int = 256, sp_r: int = 256,
                           sp_cells: int = 4096, sp_universe: int = 1_000_000,
                           sp_born: int = 1024, sp_block_rows: int = 32) -> dict:
    """The fault plane at full width. (a) ``full_width_delta``'s shape and
    cut under ``bench.py:817``'s plan (``FaultPlan(seed=17, corrupt=0.6,
    drop=0.2, evicted=(5,))``), ``runs`` degraded fused rings (the first
    over the fill, each later one over the previous rows with genesis
    tracking): residue >= 1 and packets lost in each; the same runs over
    the layered ring give the same rows; the heal by ``mesh_gossip``
    lands every rank on the fault-free fixpoint; a delay-only ring at a
    doubled budget loses nothing, certifies and equals ``mesh_fold``; one
    dense fused faulted round under sync debug "error". (b) the
    ``flagship`` stream under ``FaultPlan(seed=17, drop=0.05,
    corrupt=0.05)``: re-streaming the report's blocks with ``init=`` the
    faulted accumulator equals the unfaulted pass (the master table).
    (c) ROADMAP 15.3: the sparse stream at "sparse" widths born at
    ``dot_cap`` ``sp_born`` with ``widen_policy=`` equals the stream born
    at the final cap, with ``stream.widen_retries`` >= 1."""
    import torch

    from crdt_tpu_torch.elastic import ElasticPolicy
    from crdt_tpu_torch.faults import FaultPlan
    from crdt_tpu_torch.faults.scenarios import genesis_tracking
    from crdt_tpu_torch.ops.fold_kernels import fold_entries
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import (
        VirtualMesh, mesh_delta_gossip, mesh_fold, mesh_gossip, mesh_stream_fold_sparse,
    )
    from crdt_tpu_torch.parallel import stream as stream_mod
    from crdt_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    out = {"phase": "full_width_chaos", "card": card_label(device)}

    # ---- (a) the ring -------------------------------------------------------
    state, dirty, fctx, info = fill_delta_config3(r, e, a, d, p, seed, device, chunk)
    sync()
    mesh = VirtualMesh(p, device)
    rl = r // p
    backlog = int(dirty.view(p, rl, e).any(1).sum(-1).max())
    plan = FaultPlan(seed=17, corrupt=0.6, drop=0.2, evicted=(p - 3,))
    # The fault-free ring's certified budget (full_width_delta's search).
    clean, rounds, _, _, _ = certify_ring(
        lambda rounds, stats: mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds,
                                                cap=cap), backlog, p, cap, (), sync)
    t0 = time.perf_counter()
    clean = mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds, cap=cap)
    sync()
    clean_ms = (time.perf_counter() - t0) * 1e3
    check(int(clean[3]) == 0, "the fault-free ring did not certify at its budget")
    degraded, fused_runs, k3_checked = [], [], 0
    cur = dcur = fcur = None
    for i in range(runs):
        l3, l1 = wire_pack.launches, fold_entries.launches
        t0 = time.perf_counter()
        with K3Checked() as k3:
            if i == 0:
                res = mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds, cap=cap,
                                        faults=plan, telemetry=True)
            else:
                res = mesh_delta_gossip(cur, dcur, fcur, mesh, rounds=rounds, cap=cap,
                                        faults=plan, telemetry=True)
            sync()
        wall = (time.perf_counter() - t0) * 1e3
        l3, l1 = wire_pack.launches - l3, fold_entries.launches - l1
        fc = res[-1]
        lost = int(fc.packets_dropped) + int(fc.packets_rejected)
        check(int(res[3]) >= 1 and lost > 0, f"chaos run {i}: residue {int(res[3])}, lost {lost}")
        check(not on_card or (l3 == rounds and k3.calls == rounds and k3.max_abs_err == 0),
              f"chaos run {i}: K3 {l3} launches in {rounds} rounds, max err {k3.max_abs_err}")
        check(not on_card or l1 == p, f"chaos run {i}: K1 launched {l1} times on {p} ranks")
        k3_checked = max(k3_checked, k3.max_abs_err)
        fused_runs.append({"wall_ms": wall, "residue": int(res[3]),
                           "dropped": int(fc.packets_dropped),
                           "rejected": int(fc.packets_rejected),
                           "delayed": int(fc.packets_delayed),
                           "miss_streak": fc.miss_streak.tolist(), "k3": l3, "k1": l1,
                           "wire_packed_bytes": float(res[4].wire_packed_bytes)})
        cur = res[0]
        dcur, fcur = genesis_tracking(cur)
        degraded.append(cur)
        del res
    # The faulted ring's wall without the per-launch check (warm: run 0
    # above was its warm-up).
    t0 = time.perf_counter()
    res = mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds, cap=cap, faults=plan)
    sync()
    faulted_ms = (time.perf_counter() - t0) * 1e3
    check(same_leaves(res[0], degraded[0]), "the unchecked faulted ring != the checked one")
    del res
    # The layered ring absorbs the same damage packet for packet.
    lcur = None
    t0 = time.perf_counter()
    for i in range(runs):
        if i == 0:
            lres = mesh_delta_gossip(state, dirty, fctx, mesh, rounds=rounds, cap=cap,
                                     faults=plan, fused=False)
        else:
            dl, fl = genesis_tracking(lcur)
            lres = mesh_delta_gossip(lcur, dl, fl, mesh, rounds=rounds, cap=cap, faults=plan,
                                     fused=False)
        lcur = lres[0]
        check(same_leaves(lcur, degraded[i]), f"chaos run {i}: fused rows != layered rows")
    sync()
    layered_ms = (time.perf_counter() - t0) * 1e3
    del lres, lcur
    # The heal (full-state gossip, also the evicted rank's rejoin).
    folded, _ = mesh_fold(state, mesh)
    t0 = time.perf_counter()
    healed, _ = mesh_gossip(cur, mesh)
    sync()
    heal_ms = (time.perf_counter() - t0) * 1e3
    check(rows_equal_fold(healed, folded), "the heal did not land on the fault-free fixpoint")
    del healed, degraded, cur
    # Delay only, at a doubled budget (more if it does not certify there,
    # recorded): nothing lost, certified, == the fault-free ring and the fold.
    delay_budgets = []
    for times in (2, 3, 4):
        t0 = time.perf_counter()
        late = mesh_delta_gossip(state, dirty, fctx, mesh, rounds=times * rounds, cap=cap,
                                 faults=FaultPlan(seed=17, delay=0.3))
        sync()
        late_ms = (time.perf_counter() - t0) * 1e3
        delay_budgets.append({"rounds": times * rounds, "residue": int(late[3]),
                              "wall_ms": late_ms})
        if int(late[3]) == 0:
            break
    lfc = late[-1]
    check(int(lfc.packets_dropped) == int(lfc.packets_rejected) == 0
          and int(lfc.packets_delayed) > 0 and int(late[3]) == 0,
          f"the delay-only ring: budgets {delay_budgets}, counters {[int(x) for x in lfc[:3]]}")
    check(rows_equal_fold(late[0], folded) and rows_equal_fold(clean[0], folded),
          "the delay-only ring != the fault-free ring")
    del late, clean
    # One dense fused faulted round under sync debug "error": no host read.
    round_ = one_faulted_dense_round(state, dirty, fctx, mesh, cap, plan)
    round_()
    sync()
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        round_()
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    del state, dirty, fctx, folded, round_
    out["ring"] = {
        "R": r, "E": e, "A": a, "D": d, "P": p, "cap": cap, "rounds": rounds,
        "plan": {"seed": 17, "corrupt": 0.6, "drop": 0.2, "evicted": [p - 3]},
        "reduced": {"R": [10240, r, "full_width_delta's cut: at R=10240 the inputs alone are "
                                    "72.3 GB"]},
        "fill": info, "ring_ms_unfaulted": clean_ms, "ring_ms_faulted": faulted_ms,
        "chaos_runs": fused_runs,
        "layered_replay_ms_all_runs": layered_ms, "heal_ms": heal_ms,
        "delay_only": {"budgets": delay_budgets, "delayed": int(lfc.packets_delayed)},
        "packets_absorbed": sum(x["dropped"] + x["rejected"] for x in fused_runs),
        "k3_max_abs_err": k3_checked, "faulted_round_syncs_with_host": False if on_card else None,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
    }
    out["k3_max_abs_err"] = k3_checked

    # ---- (b) the flagship stream --------------------------------------------
    gen, master = flagship_population(segment_cap, universe, a, device)
    n_blocks = -(-stream_r // block_rows)

    def blocks(ids=None):
        for b in (range(n_blocks) if ids is None else ids):
            yield gen(torch.arange(b * block_rows, (b + 1) * block_rows, device=device))

    t0 = time.perf_counter()
    acc, of, report = mesh_stream_fold_sparse(blocks(), mesh,
                                              faults=FaultPlan(seed=17, drop=0.05, corrupt=0.05))
    sync()
    faulted_ms = (time.perf_counter() - t0) * 1e3
    check(report.lost_blocks and not bool(of.any()), f"the faulted flagship lost "
          f"{report.lost_blocks} with flags {of.tolist()}")
    healed, hof = mesh_stream_fold_sparse(blocks(report.lost_blocks), mesh, init=acc)
    t0 = time.perf_counter()
    clean, cof = mesh_stream_fold_sparse(blocks(), mesh)
    sync()
    clean_ms = (time.perf_counter() - t0) * 1e3
    check(same_leaves(healed, clean) and not bool(hof.any()) and not bool(cof.any()),
          "the re-streamed faulted flagship != the unfaulted pass")
    check(bool(clean.valid.all()) and torch.equal(clean.eid, master["eid"])
          and same_leaves(clean.ctr, master["ctr"]), "the unfaulted flagship != the master table")
    out["stream"] = {"R": n_blocks * block_rows, "blocks": n_blocks, "block_rows": block_rows,
                     "universe": universe, "segment_cap": segment_cap,
                     "dropped_blocks": report.dropped_blocks,
                     "rejected_blocks": report.rejected_blocks,
                     "faulted_ms": faulted_ms, "unfaulted_ms": clean_ms}
    del acc, healed, clean, master

    # ---- (c) widen_policy= (15.3) -------------------------------------------
    narrow = sparse_actor_population(sp_r, sp_cells, sp_universe, a, sp_born, device)
    wide = sparse_actor_population(sp_r, sp_cells, sp_universe, a, sp_cells, device)
    retries0 = metrics.snapshot()["counters"].get("stream.widen_retries", 0)
    t0 = time.perf_counter()
    grown, gof = mesh_stream_fold_sparse(stream_mod.iter_blocks(narrow, sp_block_rows), mesh,
                                         widen_policy=ElasticPolicy())
    sync()
    widen_ms = (time.perf_counter() - t0) * 1e3
    retries = metrics.snapshot()["counters"].get("stream.widen_retries", 0) - retries0
    born, bof = mesh_stream_fold_sparse(stream_mod.iter_blocks(wide, sp_block_rows), mesh)
    check(retries >= 1 and not bool(gof.any()) and not bool(bof.any())
          and same_leaves(grown, born),
          f"the widened stream ({retries} retries) != the stream born at the final cap")
    out["widen"] = {"R": sp_r, "cells": sp_cells, "universe": sp_universe, "born": sp_born,
                    "final_dot_cap": grown.eid.shape[-1], "widen_retries": retries,
                    "block_rows": sp_block_rows, "wall_ms": widen_ms}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---- the observability plane and live scale-out (ROADMAP 15.6, 15.5) -------

OBS_CHAOS = dict(seed=42, corrupt=0.6, drop=0.2, delay=0.2, evicted=(2,))

# Kernel launches per fused round at full_width_delta's and
# full_width_delta_map's shapes (the telemetry legs' sidecar-off readings)
# and per profiled serve dispatch, as measured on an H100 80GB HBM3 at
# 700 W before the observability plane was wired in (PERF.md §6): with
# nothing installed, the plane must leave all three where they were.
BASE_DENSE_ROUND_LAUNCHES = 390.1463414634146
BASE_MAP_ROUND_LAUNCHES = 920.1851851851852
BASE_SERVE_DISPATCH_LAUNCHES = 37.5


def stripped(events) -> list:
    """Flight events without their wall-clock stamps and the host-timed
    Telemetry fields: what two runs of the same work agree on."""
    return [{k: v for k, v in ev.items() if k != "ts" and k not in HOST_TIMED} for ev in events]


def by_type(events) -> dict:
    out = {}
    for ev in events:
        out[ev["type"]] = out.get(ev["type"], 0) + 1
    return dict(sorted(out.items()))


class Observed:
    """A fresh flight recorder (``capacity``, ``clock``) and optionally a
    tracer installed for the block, auto-dumps into ``root``; the previous
    ones come back on exit. :meth:`since` is the registry's counters since
    the block began (the audit's cross-check target)."""

    def __init__(self, root=None, capacity: int = 4096, clock=None, tracer=None):
        self.root, self.capacity, self.clock, self.tracer = root, capacity, clock, tracer

    def __enter__(self):
        from crdt_tpu_torch import obs
        from crdt_tpu_torch.utils.metrics import metrics

        self.base = metrics.snapshot()["counters"]
        kw = {} if self.clock is None else {"clock": self.clock}
        self.rec = obs.FlightRecorder(capacity=self.capacity, **kw)
        self.prev = obs.install(self.rec)
        if self.root is not None:
            os.makedirs(self.root, exist_ok=True)
            obs.configure_auto_dump(self.root)
        if self.tracer is not None:
            self.prev_tracer = obs.install_tracer(self.tracer)
        return self

    def __exit__(self, *exc):
        from crdt_tpu_torch import obs

        obs.install(self.prev)
        obs.configure_auto_dump(None)
        if self.tracer is not None:
            obs.install_tracer(self.prev_tracer)
        return False

    def since(self) -> dict:
        from crdt_tpu_torch.utils.metrics import metrics

        live = metrics.snapshot()["counters"]
        return {"counters": {k: v - self.base.get(k, 0) for k, v in live.items()}}

    def dumps(self) -> list:
        return sorted(os.path.join(self.root, f) for f in os.listdir(self.root))


def audited(path: str, snapshot=None, slo: bool = False) -> dict:
    """``obs.report.build_report`` of one dump, which must be ok (and, with
    ``slo``, its trace replay must have run)."""
    from crdt_tpu_torch.obs import report

    rep = report.build_report(path, snapshot=snapshot, slo=slo)
    errors = [f for f in rep["audit"] if f["severity"] == "error"]
    check(rep["ok"], f"dump {os.path.basename(path)} failed the audit: parse "
                     f"{rep['parse_errors'][:2]} mismatches {rep['counter_mismatches'][:3]} "
                     f"audit {errors[:2]}"
                     + (f" replay {rep['slo']['mismatches'][:2]}" if slo else ""))
    if slo:
        check(rep["slo"]["skipped"] is None, f"trace replay skipped: {rep['slo']['skipped']}")
    return rep


def obs_probes(device, seed: int, root: str, p: int = 4, rounds: int = 12, cap: int = 8) -> dict:
    """The observability probes on ``device``, each under its own recorder
    (clock 0): ``{probe: (events, leaves, dumps)}``."""
    import numpy as np
    import torch

    from crdt_tpu_torch.analysis import slo
    from crdt_tpu_torch.durability import Wal, recover_state, snapshot
    from crdt_tpu_torch.elastic import ElasticPolicy, Hysteresis
    from crdt_tpu_torch.faults import FaultPlan, Membership
    from crdt_tpu_torch.faults.retry import DcnExchangeFailed, RetryPolicy, with_retries
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import VirtualMesh, iter_blocks, mesh_stream_fold
    from crdt_tpu_torch.scaleout import (
        DrainCertificate, DrainRefused, ScaleoutMesh, certify_drain, drain_refuses_unflushed,
        park_row,
    )

    cpu = torch.device("cpu")
    models, _ = reclaim_models(seed, cpu)
    mesh = VirtualMesh(p, device)
    zero = lambda: 0.0  # noqa: E731
    out = {}

    def probe(name, fn):
        with Observed(os.path.join(root, name), clock=zero) as o:
            leaves = fn()
        out[name] = (stripped(o.rec.events()), on_cpu(tuple(leaves)), o.dumps())

    # (1) the faulted dense and Map rings with auto-evict.
    def rings():
        leaves = []
        for kind in ("orswot", "map"):
            ring, st, d, f = genesis_ring_inputs(kind, models[kind].state, device)
            got = ring(st, d, f, mesh, rounds=rounds, cap=cap, telemetry=True,
                       faults=FaultPlan(**OBS_CHAOS))
            Membership(p, k_suspect=1).observe(got[-1], rounds, auto_evict=True)
            leaves += [got[0], got[1], got[3], tuple(got[-1])]
        return leaves

    probe("rings", rings)

    # (2) an exchange that gives up.
    def retries():
        def down():
            raise RuntimeError("link down")
        with expect_raises(DcnExchangeFailed):
            with_retries(down, RetryPolicy(attempts=3, base_delay=0.0, jitter=0.0),
                         op="obs-probe", sleep=lambda _s: None)
        return []

    probe("retries", retries)

    # (3) a stream that loses blocks.
    def stream():
        st = tree_map(lambda x: x.to(device), models["orswot"].state)
        acc, of, tel, rep = mesh_stream_fold(iter_blocks(st, 1), mesh, telemetry=True,
                                             faults=FaultPlan(seed=5, drop=0.4, corrupt=0.4))
        check(len(rep.lost_blocks) >= 1, "the lossy stream lost no block")
        return [acc, of]

    probe("stream", stream)

    # (4) a logged ring, recovered past a corrupt newest generation.
    def durable():
        ring, st, d, f = genesis_ring_inputs("orswot", models["orswot"].state, device)
        base = tree_map(lambda x: torch.zeros_like(x[:p]), st)
        snap_dir, wal_dir = os.path.join(root, "durable-snap"), os.path.join(root, "durable-wal")
        snapshot.save_state(snap_dir, "orswot", base, wal_seq=0)
        w = Wal(wal_dir, fsync="on_round")
        w.attach(base)
        got = ring(st, d, f, mesh, rounds=rounds, cap=cap, wal=w)
        gen = snapshot.save_state(snap_dir, "orswot", got[0], wal_seq=w.last_seq)
        w.close()
        with open(os.path.join(snap_dir, f"gen-{gen:08d}.npz"), "r+b") as fh:
            fh.seek(40)
            fh.write(b"\xff" * 16)
        w = Wal(wal_dir, fsync="on_round")
        rec, rep = recover_state(snap_dir, w, base, kind="orswot")
        w.close()
        check(same_leaves(on_cpu(rec), on_cpu(got[0])) and rep.snapshot_fallbacks == 1,
              f"recovery past the corrupt generation != the logged ring ({rep})")
        return [got[0], rec]

    probe("durable", durable)

    # (5) the elastic votes.
    def votes():
        h = Hysteresis(ElasticPolicy(low_water=0.2, shrink_rounds=2, high_water=0.8,
                                     widen_rounds=2))
        got = [h.vote("probe", x) for x in (0.9, 0.95, 0.5, 0.1, 0.05, 0.0, 0.85, 0.9)]
        check(got.count("widen") == 2 and got.count("shrink") == 1, f"votes {got}")
        return []

    probe("votes", votes)

    # (6) a scale-out trajectory on P ranks, one rank parked.
    def trajectory():
        st4 = tree_map(lambda x: torch.cat([x[: p - 1], torch.zeros_like(x[:1])]),
                       models["orswot"].state)
        ring, st, d, f = genesis_ring_inputs("orswot", st4, device)
        sm = ScaleoutMesh(p, live=range(p - 1))
        flush = ring(st, d, f, mesh, rounds=rounds, cap=cap, faults=sm.plan())
        check(int(flush[3]) == 0, "the scale-out flush ring kept a residue")
        stale = certify_drain("orswot", 1, flush[0], int(flush[3]), generation=sm.generation,
                              live=sm.live())
        rows, rep = sm.admit(1, kind="orswot", rows=flush[0])
        check(same_leaves(tree_map(lambda x: x[p - 1], rows), tree_map(lambda x: x[0], rows)),
              "the newcomer's row != its peer's")
        cert = sm.drain(p - 1, kind="orswot", rows=rows, residue=0)
        parked = park_row(rows, p - 1)
        for c, r in ((stale, None), (None, 1)):
            with expect_raises(DrainRefused):
                if c is not None:
                    sm.drain(1, certificate=c)
                else:
                    sm.drain(1, kind="orswot", rows=parked, residue=r)
        check(sm.generation == 2 and cert.ok(), f"generation {sm.generation}, {cert}")
        check(isinstance(cert, DrainCertificate) and rep.generation == 1, "admit report")
        return [rows, parked]

    probe("trajectory", trajectory)

    # (7) the drain detector; (8) the SLO gate's measurement.
    detector = drain_refuses_unflushed(certify_drain, device=device)
    return out, detector, slo.measure_slo(device=device)


def phase_obs_scenarios(device, seed: int, p: int = 4, rounds: int = 12, cap: int = 8) -> dict:
    """The observability plane's probes (``obs_probes``) on the card == the
    CPU on every event (every field but ``ts``; the telemetry events
    without the host-timed fields) and every leaf: a faulted dense ring
    and a Map ring (K3 once per fused round, each launch held against its
    plain version; K1 and K2 as the local folds) with ``Membership``
    auto-evict; ``with_retries`` giving up; a stream losing blocks; a
    logged ring recovered past a corrupt generation; the elastic votes; a
    small ``ScaleoutMesh`` trajectory (admit, drain, a refused drain and a
    stale certificate, each refusal dumped). Every dump passes
    ``obs.report``; ``drain_refuses_unflushed(certify_drain)`` holds;
    ``measure_slo`` on the card == on the CPU == the committed
    ``tools/slo_budgets.json``. Flags off: a dense fused ring launches as
    many kernels, and a serve dispatch's graph holds as many nodes, with
    nothing installed as with a recorder and a tracer installed; a dense
    fused faulted round with a recorder installed runs under sync debug
    "error"."""
    import torch

    from crdt_tpu_torch import obs, serve
    from crdt_tpu_torch.analysis import slo
    from crdt_tpu_torch.convert import opslab_from_numpy
    from crdt_tpu_torch.faults import FaultPlan
    from crdt_tpu_torch.ops.fold_kernels import fold_cells, fold_entries
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_serve_apply

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    on_card = device.type == "cuda"
    out = {"phase": "obs_scenarios", "card": card_label(device), "P": p, "rounds": rounds}

    def both(root):
        l3, l1, l2 = wire_pack.launches, fold_entries.launches, fold_cells.launches
        with K3Checked() as k3:
            card = obs_probes(device, seed, os.path.join(root, "card"), p, rounds, cap)
        launches = {"k3": wire_pack.launches - l3, "k1": fold_entries.launches - l1,
                    "k2": fold_cells.launches - l2, "k3_checked": k3.calls}
        host = obs_probes(cpu, seed, os.path.join(root, "cpu"), p, rounds, cap)
        probes = {}
        for name, (events, leaves, dumps) in card[0].items():
            h_events, h_leaves, h_dumps = host[0][name]
            check(events == h_events, f"obs probe {name}: card events != CPU events")
            check(same_leaves(leaves, h_leaves), f"obs probe {name}: card leaves != CPU leaves")
            check(len(dumps) == len(h_dumps), f"obs probe {name}: {len(dumps)} dumps on the "
                                              f"card, {len(h_dumps)} on the CPU")
            reports = [audited(path) for path in dumps + h_dumps]
            probes[name] = {"events": by_type(events), "dumps": len(dumps),
                            "dump_reasons": [r["reason"] for r in reports[:len(dumps)]]}
        check(card[1] and host[1], "drain_refuses_unflushed(certify_drain) failed")
        committed = slo.load_budgets()["entries"]
        check(card[2] == host[2] == committed, f"measure_slo: card {card[2]} / CPU {host[2]} / "
                                              f"committed {committed}")
        check(slo.check_budgets(card[2]) == [], "check_budgets found drift")
        check(not on_card or (launches["k3"] >= 1 and launches["k3"] == launches["k3_checked"]
                              and launches["k1"] >= 1 and launches["k2"] >= 1),
              f"obs probes: kernel launches {launches}")
        return {"probes": probes, "launches": launches, "k3_max_abs_err": k3.max_abs_err,
                "slo": card[2]}

    out.update(with_scratch_dir(both))

    # ---- flags off: nothing installed vs the recorder and the tracer -----
    models, _ = reclaim_models(seed, cpu)
    ring, st, d, f = genesis_ring_inputs("orswot", models["orswot"].state, device)
    mesh = VirtualMesh(p, device)
    run = lambda: ring(st, d, f, mesh, rounds=rounds, cap=cap)  # noqa: E731
    run()
    sb = serve.Superblock(256, VirtualMesh(2, device), kind="orswot",
                          caps=dict(n_elems=4, n_actors=2, deferred_cap=2), n_lanes=64)
    q = serve.IngestQueue(sb, lanes=16, depth=2)
    for t in range(24):
        q.add(t, t % 2, 1, [t % 2 == 0, True, False, t % 3 == 0])
    built = q._assemble()
    slab = opslab_from_numpy(dict(kind=built.kind, actor=built.actor, ctr=built.ctr,
                                  clock=built.clock, member=built.member), device)
    idx = torch.as_tensor(built.idx, device=device)
    lanes = type(sb.state)(*(x.clone() for x in sb.state))
    dispatch = lambda: mesh_serve_apply(lanes, slab, idx, sb.mesh, donate=True)  # noqa: E731
    flags = {}
    for label in ("off", "on", "off_again"):
        with contextlib.ExitStack() as es:
            if label == "on":
                es.enter_context(Observed(tracer=obs.Tracer(sample=1)))
            prof = profile_busy(run, device)
            flags[label] = {
                "ring_launch_kernel_calls": None if prof is None else prof["launch_kernel_calls"],
                "serve_graph_nodes": graph_nodes(dispatch, device, 1) if on_card else None,
            }
    check(flags["off"] == flags["on"] == flags["off_again"],
          f"installing the recorder and the tracer changed the device work: {flags}")
    out["flags_off"] = flags

    # ---- no host sync: a faulted dense round with a recorder installed ---
    st4 = tree_map(lambda x: torch.cat([x[:p - 1], torch.zeros_like(x[:1])]),
                   models["orswot"].state)
    _, st4, d4, f4 = genesis_ring_inputs("orswot", st4, device)
    round_ = one_faulted_dense_round(st4, d4, f4, mesh, cap, FaultPlan(**OBS_CHAOS))
    with Observed() as o:
        round_()
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.set_sync_debug_mode("error")
        try:
            round_()
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        events = len(o.rec)
    out["faulted_round_syncs_with_host"] = False if on_card else None
    out["faulted_round_events"] = events
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def scaleout_rows(state, dirty, fctx, parked):
    """The ring inputs with the ``parked`` ranks' rows back at the join
    identity and clean (R == P: a rank's row is its replica)."""
    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.scaleout import park_row

    dirty, fctx = dirty.clone(), fctx.clone()
    for rank in parked:
        state = park_row(state, rank)
        dirty[rank] = False
        bits(fctx)[rank] = 0
    return state, dirty, fctx


def phase_full_width_scaleout(device, seed: int, e: int = 102400, a: int = 8, d: int = 4,
                              p: int = 8, cap: int = 4096, chunk: int = 128, runs: int = 4,
                              warm_e: int = 102400, samples: int = 3) -> dict:
    """``bench.py``'s scale-out trajectory at config 3's widths: P = 8
    ranks of one replica each (the rows are absolute rank rows, R = P),
    E = 102,400, A = 8, D = 4, the live rows filled as
    ``full_width_delta`` fills its ranks (``fill_delta_config3``), a
    ``FlightRecorder(capacity=8192)`` installed first. Plateau on 6 live
    ranks (2 parked): timed ``mesh_delta_gossip(faults=smesh.plan())``
    runs, residue 0, every live row == the ``mesh_gossip`` fixpoint (K1,
    held against the plain tree fold). The spike: the ``Autoscaler``
    (``load=1.0``) votes until both parked ranks are admitted with a cold
    bootstrap, each newcomer == its peer; the δ workload re-measured on the
    widened ring. The warm-start gate at E = 102,400 (ratio < 0.25). Quiet
    traffic until a drain vote: a flush ring, ``drain`` under its
    certificate, ``park_row``, the narrowed ring == the fixpoint. A
    refused drain (one unflushed row, ``residue=0``) keeps the generation
    and dumps a ``drain_refused`` artifact that passes ``obs.report``.
    The trajectory's own dump, with ``scaleout`` telemetry at the end,
    passes the audit against the registry's counters since the start.
    Every K3 launch is held against its plain version."""
    import torch

    from crdt_tpu_torch import obs
    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch._dtypes import bits, from_wide, to_wide, umax
    from crdt_tpu_torch.elastic import ElasticPolicy
    from crdt_tpu_torch.ops import orswot as ops
    from crdt_tpu_torch.ops.fold_kernels import fold_entries
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_delta_gossip, mesh_gossip
    from crdt_tpu_torch.scaleout import (
        Autoscaler, DrainRefused, ScaleoutMesh, bootstrap, certify_drain, mesh_scale, park_row,
    )

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    out = {"phase": "full_width_scaleout", "card": card_label(device), "P": p, "E": e, "A": a,
           "D": d, "cap": cap, "runs": runs}
    mesh = VirtualMesh(p, device)
    live0 = p - 2
    # One replica a rank: no rank holds a second replica to designate as a
    # parker (n_des = 0); the home ranks' full streams still park removes.
    state, dirty, fctx, info = fill_delta_config3(p, e, a, d, p, seed, device, chunk, n_des=0)
    state, dirty, fctx = scaleout_rows(state, dirty, fctx, range(live0, p))
    sync()
    bench_rounds = 2 * (p - 1) - 1  # bench.py's rate formula: the pipelined window
    out["fill"] = {k: v for k, v in info.items() if isinstance(v, (int, float, str))}

    def budget(dty) -> int:
        """The capped drain's round budget for this tracking's backlog."""
        return 2 * (p - 1) * (1 + -(-int(dty.sum(-1).max()) // cap)) - 1

    def body(root):
        res = {}
        with Observed(os.path.join(root, "flight"), capacity=8192) as o:
            sm = ScaleoutMesh(p, live=range(live0))
            asc = Autoscaler(sm, ElasticPolicy(low_water=0.2, shrink_rounds=2, high_water=0.8,
                                               widen_rounds=2), min_live=2)
            fix_rows, of = mesh_gossip(state, mesh)
            plain_rows, _ = mesh_gossip(state, mesh, local_fold="tree")
            check(same_leaves(fix_rows, plain_rows) and not bool(of),
                  "mesh_gossip's fused fold (K1) != the plain tree fold")
            fix = tree_map(lambda x: x[0], fix_rows)
            del plain_rows

            def identical(rows) -> bool:
                return all(same_leaves(tree_map(lambda x: x[i], rows), fix) for i in sm.live())

            def ring(rows, dty, ctx, **kw):
                return mesh_delta_gossip(rows, dty, ctx, mesh, rounds=budget(dty), cap=cap,
                                         faults=sm.plan(), **kw)

            def measure(rows, dty, ctx, what):
                rounds = budget(dty)
                with K3Checked() as k3:
                    l3, l1 = wire_pack.launches, fold_entries.launches
                    warm = ring(rows, dty, ctx)
                    sync()
                    launches = {"k3": wire_pack.launches - l3, "k1": fold_entries.launches - l1}
                check(int(warm[3]) == 0 and identical(warm[0]),
                      f"{what}: residue {int(warm[3])} or a live row != the fixpoint")
                check(not on_card or launches["k3"] == rounds == k3.calls,
                      f"{what}: K3 {launches} in {rounds} rounds")
                t0 = time.perf_counter()
                for _ in range(runs):
                    last = ring(rows, dty, ctx)
                sync()
                dt = time.perf_counter() - t0
                check(int(last[3]) == 0, f"{what}: a timed run kept a residue")
                # One telemetry'd run off the clock: the dump's telemetry event.
                ring(rows, dty, ctx, telemetry=True)
                o.rec.snapshot_delta()
                return warm[0], {
                    "live": len(sm.live()), "generation": sm.generation, "rounds": rounds,
                    "backlog": int(dty.sum(-1).max()),
                    "joins_per_s": len(sm.live()) * bench_rounds * runs / dt,
                    "ring_ms": dt / runs * 1e3, "launches": launches,
                    "k3_max_abs_err": k3.max_abs_err}

            # 1. plateau.
            conv, res["plateau"] = measure(state, dirty, fctx, "plateau")

            # 2. spike → debounced admits (cold bootstraps).
            boot_s, boots = [0.0], []
            real_bootstrap = mesh_scale.bootstrap

            def timed_bootstrap(*args, **kw):
                t = time.perf_counter()
                got = real_bootstrap(*args, **kw)
                sync()
                boot_s[0] += time.perf_counter() - t
                return got

            votes, admitted = 0, conv
            mesh_scale.bootstrap = timed_bootstrap
            try:
                t0 = time.perf_counter()
                while sm.parked:
                    votes += 1
                    dec = asc.observe(load=1.0)
                    if dec is None:
                        continue
                    check(dec.action == "admit", f"a spike voted {dec}")
                    admitted, rep = sm.admit(1, kind="orswot", rows=admitted)
                    boots += rep.bootstraps
                sync()
                admit_s = time.perf_counter() - t0
            finally:
                mesh_scale.bootstrap = real_bootstrap
            for rank in range(live0, p):
                check(same_leaves(tree_map(lambda x: x[rank], admitted),
                                  tree_map(lambda x: x[0], admitted)),
                      f"newcomer {rank} != its peer")
            res["admit"] = {"votes": votes, "ranks": list(range(live0, p)),
                            "wall_s": admit_s, "bootstrap_s": boot_s[0],
                            "write_s": admit_s - boot_s[0],
                            "cold_bytes": [b.bytes_shipped for b in boots],
                            "cold_ratio": [b.ratio for b in boots],
                            "generation": sm.generation}
            # The widened ring runs the same δ workload: the newcomers hold
            # the fixpoint, tracked since the same sync as the union of the
            # live ranks' δ (their dirty rows, their contexts' max).
            wide = tree_map(lambda x, y: torch.cat([x[:live0], y[live0:]]), state, admitted)
            w_dirty, w_fctx = dirty.clone(), fctx.clone()
            w_dirty[live0:] = dirty[:live0].any(0)
            bits(w_fctx)[live0:] = bits(umax(fctx[:live0], 0))
            conv, res["widened"] = measure(wide, w_dirty, w_fctx, "widened")
            res["rate_ratio_widened_over_plateau"] = (res["widened"]["joins_per_s"]
                                                      / res["plateau"]["joins_per_s"])

            # 3. the warm-start gate at config 3's E.
            u32 = lambda y: from_wide(y, torch.uint32)  # noqa: E731
            snap = ops.empty(warm_e, a, 2, device=device)
            ctr = to_wide(snap.ctr)
            ctr[: warm_e // 3, 0] = 1
            snap = snap._replace(ctr=u32(ctr))
            ctr[: warm_e // 25, 1] = 2
            top = to_wide(snap.top)
            top[0], top[1] = 1, 2
            live_w = snap._replace(ctr=u32(ctr), top=u32(top))
            got_w, warm_rep = bootstrap("orswot", live_w, base=snap)
            _, cold_rep = bootstrap("orswot", live_w)
            check(same_leaves(got_w, live_w) and warm_rep.ratio < 0.25,
                  f"warm bootstrap ratio {warm_rep.ratio}")
            res["warm"] = {"E": warm_e, "ratio": warm_rep.ratio,
                           "bytes_shipped": warm_rep.bytes_shipped,
                           "cold_ratio": cold_rep.ratio, "cold_bytes": cold_rep.bytes_shipped}

            # 4. quiet → debounced drain → certified scale-in.
            dec, quiet = None, 0
            while dec is None:
                quiet += 1
                dec = asc.observe(load=0.0)
            check(dec.action == "drain" and dec.rank == p - 1, f"quiet traffic voted {dec}")
            flush = ring(wide, w_dirty, w_fctx)
            t0 = time.perf_counter()
            cert = certify_drain("orswot", dec.rank, flush[0], int(flush[3]),
                                 generation=sm.generation, live=sm.live())
            certify_ms = (time.perf_counter() - t0) * 1e3
            check(cert.ok(), f"the drain certificate did not hold: {cert}")
            sm.drain(dec.rank, certificate=cert)
            narrow, n_dirty, n_fctx = scaleout_rows(wide, w_dirty, w_fctx, (dec.rank,))
            conv, res["narrowed"] = measure(narrow, n_dirty, n_fctx, "narrowed")
            res["drain"] = {"rank": dec.rank, "quiet_votes": quiet, "certify_ms": certify_ms,
                            "certificate": vars(cert), "generation": sm.generation}

            # 5. a refused drain: one unflushed row on a live rank.
            gen = sm.generation
            ahead = tree_map(lambda x: x.clone(), conv)
            ctr, top = to_wide(ahead.ctr[1]), to_wide(ahead.top[1])
            row = int(torch.nonzero(ctr.amax(-1) == 0)[0])
            top[1] += 1
            ctr[row, 1] = top[1]
            bits(ahead.ctr)[1] = bits(u32(ctr))
            bits(ahead.top)[1] = bits(u32(top))
            before = set(o.dumps())
            with expect_raises(DrainRefused):
                sm.drain(1, kind="orswot", rows=ahead, residue=0)
            check(sm.generation == gen and 1 in sm.live(), "a refused drain moved the mesh")
            refused = [x for x in o.dumps() if x not in before]
            check(len(refused) == 1 and "drain_refused" in refused[0],
                  f"the refused drain dumped {refused}")
            rep_refused = audited(refused[0], snapshot=o.since())
            res["refused"] = {"generation": gen, "audit": [f["check"] for f in rep_refused["audit"]]}

            # 6. the recorder's cost on the ring, alternating.
            off, on = [], []
            for _ in range(samples):
                for installed, walls in ((False, off), (True, on)):
                    prev = obs.install(o.rec if installed else None)
                    try:
                        sync()
                        t0 = time.perf_counter()
                        ring(narrow, n_dirty, n_fctx)
                        sync()
                        walls.append((time.perf_counter() - t0) * 1e3)
                    finally:
                        obs.install(prev)
            res["ring_ms_recorder_off"], res["ring_ms_recorder_on"] = off, on

            tele.record("scaleout", sm.annotate(tele.zeros(device)))
            path = o.rec.dump(os.path.join(root, "scaleout.jsonl"), reason="scaleout")
            rep_all = audited(path, snapshot=o.since())
            res["flight"] = {"events": len(o.rec), "dropped": o.rec.dropped,
                             "by_type": by_type(o.rec.events()),
                             "dropped_by_type": dict(o.rec.dropped_by_type),
                             "folded_counters": len(rep_all["folded_counters"]),
                             "audit": [f["check"] for f in rep_all["audit"]]}
            res["generations"] = sm.generation
            res["bootstrap_bytes_total"] = sm.bootstrap_bytes
        return res

    out.update(with_scratch_dir(body))
    out["k3_max_abs_err"] = max(out[k]["k3_max_abs_err"] for k in ("plateau", "widened",
                                                                    "narrowed"))
    out["reduced"] = {
        "rate_gate": "bench.py asserts the joins/s rise after the admit: there the ranks are "
                     "chips; here the P virtual ranks share one card, so the ratio is reported, "
                     "not gated",
        "R": [p, "one replica per rank: the rows are absolute rank rows (R = P)"]}
    if on_card:
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---- the geo-federation plane and the law engine (ROADMAP 15.7, 16) --------

def geo_config() -> dict:
    """``BENCH_CONFIGS.json`` "geo", as committed (this checkout's copy)."""
    with open(os.path.join(HERE, "BENCH_CONFIGS.json")) as f:
        return json.load(f)["geo"]


# ``bench.py``'s geo leg draws from this fixed seed, not from ``--seed``.
GEO_SEED = 211


def geo_run(cfg: dict, device, root: str) -> dict:
    """One run of ``bench.py``'s geo leg (``bench_geo``) on ``device``,
    draws from ``default_rng(GEO_SEED)`` in bench's order: ``regions`` serving
    stacks (superblock of ``lanes`` lanes, evictor, WAL-attached ingest
    queue, fan-out interest) federated by rendezvous homing; a 64-op warm
    cycle, then ``cycles`` cycles of ``ops_per_cycle`` adds from
    round-robin origins (60% on a hot set shifting each cycle), a labeled
    pre-sweep mirror read, the drains (the WAL group commits: the acks),
    one full anti-entropy sweep; a cohort of the doomed region's tenants
    spilled the cycle before ``kill_cycle``, the region killed at it with
    the cycle's ops pending (unacked, lost) and re-homed from its durable
    tier; two quiesce sweeps. Asserts bench's four gates and returns its
    numbers, the ``FailoverReport``, the δ byte totals and every live
    region's resident rows (host)."""
    import numpy as np
    import torch

    from crdt_tpu_torch import obs
    from crdt_tpu_torch import telemetry as tele
    from crdt_tpu_torch.fanout import FanoutPlane
    from crdt_tpu_torch.geo import (
        Federation, RegionPlane, exchange_all, fail_over_region, read_local,
    )
    from crdt_tpu_torch.obs import hist as obs_hist
    from crdt_tpu_torch.ops import superblock as sb_ops
    from crdt_tpu_torch.parallel import VirtualMesh
    from crdt_tpu_torch.serve import Evictor, IngestQueue, Superblock
    from crdt_tpu_torch.serve.wal import ServeWal

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    regions, tenants, lanes = cfg["regions"], cfg["tenants"], cfg["lanes"]
    cycles, ops_per_cycle, hot_set = cfg["cycles"], cfg["ops_per_cycle"], cfg["hot_set"]
    subscribers, kill_cycle = cfg["subscribers"], cfg["kill_cycle"]
    hot_shift, evict_cohort, oracle_sample = (cfg["hot_shift"], cfg["evict_cohort"],
                                              cfg["oracle_sample"])
    check(regions >= 2 and 2 <= kill_cycle <= cycles, f"bad geo config {cfg}")
    mesh = VirtualMesh(cfg["mesh"][0], device)
    caps = dict(n_elems=cfg["elems"], n_actors=cfg["actors"], deferred_cap=cfg["deferred_cap"])
    e, a = caps["n_elems"], caps["n_actors"]

    rng = np.random.default_rng(GEO_SEED)
    planes = {}
    for r in range(regions):
        sb = Superblock(tenants, mesh, kind="orswot", caps=caps, n_lanes=lanes)
        rroot = os.path.join(root, f"region-{r}")
        os.makedirs(rroot)
        ev = Evictor(sb, rroot, pressure_batch=64)
        wal = ServeWal(os.path.join(rroot, "serve.wal"))
        q = IngestQueue(sb, lanes=cfg["slab_lanes"], depth=cfg["slab_depth"],
                        max_pending=1 << 18, evictor=ev, wal=wal)
        fan = FanoutPlane(sb, evictor=ev, capacity=max(subscribers, 64))
        planes[r] = RegionPlane(r, sb, q, evictor=ev, wal=wal, fanout=fan)
    fed = Federation(planes)
    for r in range(regions):
        planes[r].fanout.subscribe(rng.integers(0, tenants, max(subscribers // regions, 1)))

    dead = regions - 1
    pre_home = np.asarray([fed.rmap.home(t) for t in range(tenants)])
    next_ctr = np.zeros(tenants, np.uint32)
    history = {}  # tenant -> ACKED ops only (the sequential oracle's form)

    def submit_cycle(cycle, n_ops, live):
        off = (cycle * hot_shift) % max(tenants - hot_set, 1)
        hot = rng.integers(off, off + hot_set, n_ops)
        uni = rng.integers(0, tenants, n_ops)
        ts = np.where(rng.random(n_ops) < 0.6, hot, uni)
        masks = rng.random((n_ops, e)) < (4.0 / e)
        tent = []
        for i in range(n_ops):
            t = int(ts[i])
            act = t % a
            c = int(next_ctr[t]) + 1
            next_ctr[t] = c
            home = fed.add(int(live[i % len(live)]), t, actor=act, counter=c, member=masks[i])
            tent.append((home, t, (sb_ops.ADD, act, c, None, masks[i])))
        return tent

    def drain_live(tel):
        for p_ in fed.planes.values():
            if p_.alive:
                _rep, t_ = p_.queue.drain(telemetry=True)
                if t_ is not None:
                    tel = t_ if tel is None else tele.combine(tel, t_)
        return tel

    def ack(tent):
        for _home, t, op in tent:
            history.setdefault(t, []).append(op)

    parts = dict.fromkeys(("submit", "read", "drain", "exchange"), 0.0)

    def timed(part, fn, *args):
        """``fn(*args)``, its wall (the device drained) added to ``parts``."""
        t0 = time.perf_counter()
        res = fn(*args)
        sync()
        parts[part] += time.perf_counter() - t0
        return res

    rec = obs.FlightRecorder(capacity=16384)
    prev_rec = obs.install(rec)
    failover_rep, kill_s, ops_lost_unacked, n_spilled = None, 0.0, 0, 0
    reads = stale_reads = exchanged_tenants = 0
    try:
        # Warm cycle: its ops are real and stay in the oracle histories;
        # only the timing leaves it out.
        tent = submit_cycle(0, 64, list(range(regions)))
        tel = drain_live(None)
        ack(tent)
        exchange_all(fed)
        sync()
        note(f"geo on {device}: warm cycle done")
        t_start = time.perf_counter()
        for cycle in range(1, cycles + 1):
            live = sorted(r for r, p_ in fed.planes.items() if p_.alive)
            tent = timed("submit", submit_cycle, cycle, ops_per_cycle, live)
            if cycle == kill_cycle:
                lost = [x for x in tent if x[0] == dead]
                tent = [x for x in tent if x[0] != dead]
                ops_lost_unacked = len(lost)
                sync()
                t0 = time.perf_counter()
                failover_rep = fail_over_region(fed, dead)
                sync()
                kill_s = time.perf_counter() - t0
            if history:
                t_r = int(rng.choice(np.asarray(sorted(history))))
                home = fed.rmap.home(t_r)
                others = [r for r, p_ in fed.planes.items() if p_.alive and r != home]
                if others:
                    _, cert = timed("read", read_local, fed, int(rng.choice(others)), t_r)
                    reads += 1
                    stale_reads += 0 if cert.fresh else 1
            tel = timed("drain", drain_live, tel)
            ack(tent)
            if cycle == kill_cycle - 1:
                cohort = [t for t in sorted(history) if int(pre_home[t]) == dead][:evict_cohort]
                n_spilled = fed.planes[dead].evictor.evict(cohort)
            for xr in timed("exchange", exchange_all, fed):
                exchanged_tenants += xr.tenants_shipped
            note(f"geo on {device}: cycle {cycle} at {time.perf_counter() - t_start:.1f} s")
        sync()
        window_s = time.perf_counter() - t_start

        tel = drain_live(tel)
        for _ in range(2):
            for xr in exchange_all(fed):
                exchanged_tenants += xr.tenants_shipped
        total_ops = sum(len(v) for v in history.values())
        check(tel is not None, "the geo window drained no telemetry")
        d = tele.to_dict(fed.annotate(tel))
        wm = obs_hist.summary(d["hist_geo_watermark_lag"])

        # ---- bench's gates --------------------------------------------------
        live = sorted(r for r, p_ in fed.planes.items() if p_.alive)
        written = sorted(history)
        rehomed_written = [t for t in written if int(pre_home[t]) == dead]
        sample = list(rehomed_written[:oracle_sample])
        others = [t for t in written if t not in set(sample)]
        if others:
            pick = rng.choice(len(others), min(max(oracle_sample - len(sample), 16),
                                               len(others)), replace=False)
            sample += [others[i] for i in pick]
        tk = fed.plane(live[0]).sb.tk
        oracle_mm = recovered_mm = acked_ops_lost = 0
        for t in sample:
            hp = fed.plane(fed.rmap.home(t))
            if not hp.sb.is_resident(t) and hp.evictor is not None:
                hp.evictor.restore(t)
            want = sb_ops.to_host(sb_ops.sequential_oracle(
                tk, tk.empty(**hp.sb.caps, device=device), history[t]))
            if not rows_equal_host(hp.sb.row(t), want):
                oracle_mm += 1
                if int(pre_home[t]) == dead:
                    recovered_mm += 1
                    acked_ops_lost += len(history[t])
        mirror_mm = mirrors_checked = 0
        for r in live:
            pl = fed.plane(r)
            interest = pl.interest_tenants()
            for t in sample:
                home = fed.rmap.home(t)
                if r == home or t not in interest:
                    continue
                mirrors_checked += 1
                if not pl.sb.is_resident(t) or not rows_equal_host(
                        pl.sb.row(t), fed.plane(home).sb.row(t)):
                    mirror_mm += 1
        check(recovered_mm == 0 and acked_ops_lost == 0,
              f"region-kill failover lost acked ops: {recovered_mm} re-homed tenants diverged "
              "from their acked-op oracle")
        check(oracle_mm == 0 and mirror_mm == 0 and mirrors_checked >= 1,
              f"{oracle_mm} home rows diverged from the sequential oracle, "
              f"{mirror_mm}/{mirrors_checked} interest mirrors diverged from their home rows")
        check(failover_rep is not None and fed.failovers >= 1, "no failover ran")
        check(n_spilled >= 1 and failover_rep.rows_recovered >= 1,
              f"the failover never touched the durable snapshot tier: {n_spilled} rows spilled, "
              f"{failover_rep.rows_recovered} recovered")
        wire_pct = 100.0 * fed.exchange_bytes / max(fed.full_mirror_bytes, 1.0)
        check(fed.full_mirror_bytes > 0 and wire_pct <= 25.0,
              f"cross-region δ lanes moved {wire_pct:.1f}% of full-state mirroring (gate ≤ 25%)")
        rehomed_all = {t for t in range(tenants) if int(pre_home[t]) == dead}
        resident, resident_bound_ok = {}, True
        for r in live:
            pl = fed.plane(r)
            allowed = set(pl.interest_tenants()) | {t for t in written
                                                    if fed.rmap.home(t) == r}
            allowed |= rehomed_all
            resident[r] = pl.resident_lanes()
            resident_bound_ok &= resident[r] <= len(allowed)
        total_resident = sum(resident.values())
        naive_resident = len(written) * len(live)
        check(resident_bound_ok and total_resident < naive_resident,
              f"partial replication violated: resident={resident}, {total_resident} total vs "
              f"{naive_resident} for full mirroring of {len(written)} written tenants")
        events = [ev["type"] for ev in rec.events()]
        rows = {}
        for r in live:
            sb = fed.plane(r).sb
            for t in sorted(int(x) for x in sb.resident_tenants()):
                rows[(r, t)] = list(sb.row(t))
    finally:
        obs.install(prev_rec)
        for p_ in planes.values():
            p_.wal.close()
    return {
        "acked_ops": total_ops, "window_s": window_s,
        "acked_ops_per_s": total_ops / window_s,
        "window_s_by_part": dict(parts, failover=kill_s, rest=window_s - kill_s - sum(
            parts.values())),
        "failover_ms": kill_s * 1e3, "failover": failover_rep,
        "rows_spilled": n_spilled, "unacked_ops_dropped": ops_lost_unacked,
        "exchanges": fed.exchanges, "exchanged_tenants": exchanged_tenants,
        "exchange_bytes": fed.exchange_bytes, "full_mirror_bytes": fed.full_mirror_bytes,
        "wire_vs_mirror_pct": wire_pct, "reads": reads, "stale_reads": stale_reads,
        "watermark_lag_p99": wm["p99"], "resident": resident,
        "total_resident": total_resident, "naive_resident": naive_resident,
        "oracle_checked": len(sample), "mirrors_checked": mirrors_checked,
        "geo_exchange_events": events.count("geo_exchange"),
        "region_failover_events": events.count("region_failover"),
        "rows": rows,
    }


def rows_equal_host(x, y) -> bool:
    """Two host rows (numpy leaves) equal leaf for leaf, dtype included."""
    import numpy as np

    return all(u.dtype == v.dtype and np.array_equal(u, v) for u, v in zip(x, y))


def phase_full_width_geo(device, **over) -> dict:
    """``BENCH_CONFIGS.json`` "geo" uncut (3 regions × 1,024 tenants on
    768 lanes, E = 256, A = 8, D = 2, 10 cycles of 256 ops, the kill at
    cycle 5), run as ``bench.py``'s geo leg runs it (:func:`geo_run`), with
    bench's four gates. Reports acked ops/s, the failover's ms, rows
    recovered and ops replayed, δ bytes against full-mirror bytes, stale
    reads, the watermark lag p99 from ``hist_geo_watermark_lag``. Then the
    same seeded run on the CPU: every live region's rows,
    ``exchange_bytes`` and the ``FailoverReport`` card == CPU. Then
    ``geo.static_checks(device) == []``. K1-K3 launch 0 times. The draws
    are bench's (``GEO_SEED``); ``--seed`` does not apply. ``over`` shrinks
    the config for a CPU rehearsal."""
    import shutil
    import tempfile

    import torch

    from crdt_tpu_torch import geo

    t_phase = time.perf_counter()
    cfg = dict(geo_config(), **over)
    before = kernel_launches()
    out = {"phase": "full_width_geo", "card": card_label(device),
           **{k: cfg[k] for k in ("regions", "tenants", "lanes", "elems", "actors",
                                  "deferred_cap", "cycles", "ops_per_cycle", "kill_cycle")},
           "reduced": {k: v for k, v in over.items()}}
    root = tempfile.mkdtemp(prefix="chip_smoke_geo_")
    try:
        got = geo_run(cfg, device, os.path.join(root, "card"))
        out.update({k: v for k, v in got.items() if k not in ("rows", "failover")})
        note(f"full_width_geo: the card run took {time.perf_counter() - t_phase:.1f} s")
        rep = got["failover"]
        out["failover"] = rep._asdict()
        t0 = time.perf_counter()
        want = geo_run(cfg, torch.device("cpu"), os.path.join(root, "cpu"))
        out["cpu_twin_s"] = time.perf_counter() - t0
        check(want["failover"] == rep, f"failover card {rep} != CPU {want['failover']}")
        check((got["exchange_bytes"], got["full_mirror_bytes"])
              == (want["exchange_bytes"], want["full_mirror_bytes"]),
              "the card's δ byte totals differ from the CPU run's")
        check(sorted(got["rows"]) == sorted(want["rows"]),
              "the card's resident tenants differ from the CPU run's")
        bad = [k for k, v in want["rows"].items() if not rows_equal_host(got["rows"][k], v)]
        check(not bad, f"{len(bad)} rows differ card vs CPU, e.g. {bad[:3]}")
        out["rows_card_eq_cpu"] = len(want["rows"])
        t0 = time.perf_counter()
        findings = geo.static_checks(device=device)
        check(findings == [], f"geo.static_checks: {[str(f) for f in findings]}")
        out["static_checks_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["kernel_launches"] = check_no_kernel(before, "full_width_geo")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _finding_rows(findings) -> list:
    return [(f.check, f.subject, f.detail, f.severity) for f in findings]


def phase_laws_scenarios(device) -> dict:
    """The lattice-law engine and the SEC schedule checker (ROADMAP 16) on
    the card: ``laws.check_all``, ``check_decomposition_all`` and
    ``schedules.check_all_schedules`` each return ``[]``; every broken twin
    (the law, compaction, decomposition, schedule and degeneracy twins, and
    the always-fresh geo read) fires with the same findings on the card as
    on the CPU; every kind's small domain and canonicalised pair table are
    card == CPU leaf for leaf. K1-K3 launch 0 times.
    The domains draw from their own fixed seeds; ``--seed`` does not apply."""
    import torch

    from crdt_tpu_torch.analysis import fixtures as fx
    from crdt_tpu_torch.analysis import laws, schedules
    from crdt_tpu_torch.analysis.registry import get_merge_kind, merge_kinds
    from crdt_tpu_torch.geo import read_local, watermark_reads_sound
    from crdt_tpu_torch.ops.lattice import tree_leaves

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    before = kernel_launches()
    out = {"phase": "laws_scenarios", "card": card_label(device)}
    for name, fn in (("check_all", laws.check_all),
                     ("check_decomposition_all", laws.check_decomposition_all),
                     ("check_all_schedules", schedules.check_all_schedules)):
        t0 = time.perf_counter()
        found = fn(device=device)
        check(found == [], f"{name} on {device}: {[str(f) for f in found]}")
        out[f"{name}_s"] = time.perf_counter() - t0
        note(f"laws_scenarios: {name} {out[f'{name}_s']:.1f} s")

    cells = 0
    for kind in merge_kinds():
        card, host = kind.states(device=device), kind.states(device=cpu)
        tables = [laws.pair_table(kind, card)[0], laws.pair_table(kind, host)[0]]
        for x, y in zip(tree_leaves(card) + tree_leaves(tables[0]),
                        tree_leaves(host) + tree_leaves(tables[1])):
            check(x.dtype == y.dtype and x.shape == y.shape and np_of(x).tobytes()
                  == np_of(y).tobytes(), f"{kind.name}: a domain or pair-table leaf differs")
            cells += x.numel()
    out["kinds"] = len(merge_kinds())
    out["domain_and_table_cells_card_eq_cpu"] = cells

    orswot = get_merge_kind("orswot")
    twins = {
        **{f"laws:{n}": (lambda k: lambda dev: laws._check_domain(
            k, k.states(device=dev), "small"))(getattr(fx, n))
           for n in ("NOT_COMMUTATIVE", "NOT_IDEMPOTENT", "NOT_ASSOCIATIVE")},
        "LOSSY_COMPACTOR": lambda dev: laws.check_compaction_kind(
            fx.GOOD_MAX, comp=fx.LOSSY_COMPACTOR, device=dev),
        **{n: (lambda dec: lambda dev: laws.check_decomposition_kind(
            orswot, dec=dec, device=dev))(getattr(fx, n))
           for n in ("LOSSY_DECOMPOSER", "REDUNDANT_DECOMPOSER")},
        **{f"schedules:{n}": (lambda k: lambda dev: schedules.check_kind_schedules(
            k, device=dev))(getattr(fx, n))
           for n in ("NOT_IDEMPOTENT", "DELTA_NOT_INFLATION", "NON_COMMUTING_APPLY")},
        "DEGENERATE_GENERATOR": lambda dev: schedules.generator_degeneracy(
            fx.DEGENERATE_GENERATOR, device=dev),
    }
    fired = {}
    for name, run in twins.items():
        got, want = _finding_rows(run(device)), _finding_rows(run(cpu))
        check(got == want and got, f"twin {name}: card {got} != CPU {want}")
        fired[name] = sorted({f[0] for f in got})
    for dev in (device, cpu):
        check(watermark_reads_sound(read_local, device=dev)
              and not watermark_reads_sound(fx.region_serves_unwatermarked_read, device=dev),
              f"the watermark detector or its broken twin misbehaves on {dev}")
    out["twins_fired"] = fired
    out["kernel_launches"] = check_no_kernel(before, "laws_scenarios")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _twin_rows(found):
    """A twin run's result in a comparable form: findings as ``(check,
    subject, detail)``, anything else as it is."""
    if isinstance(found, list) and found and hasattr(found[0], "check"):
        return [(f.check, f.subject, f.detail) for f in found]
    return found


def static_twins(device) -> dict:
    """Every broken twin the static-check sections run, each on
    ``device``: ``{name: result}`` (a finding list, a violation list, or
    the detector's verdict), each of which must show the twin caught."""
    from crdt_tpu_torch import fanout, faults, obs, scaleout, serve
    from crdt_tpu_torch.analysis import concur, effects, laws
    from crdt_tpu_torch.analysis import fixtures as fx
    from crdt_tpu_torch.analysis.registry import get_merge_kind
    from crdt_tpu_torch.durability import fsync_honored, loader_detects_corruption
    from crdt_tpu_torch.geo import watermark_reads_sound
    from crdt_tpu_torch.obs import trace
    from crdt_tpu_torch.parallel import wire_checks

    import tempfile

    orswot = get_merge_kind("orswot")
    with tempfile.TemporaryDirectory() as d:
        fsync = fsync_honored(fx.wal_skips_fsync, d)
    return {
        "checksum_ignores_corruption": faults.checksum_detects(
            fx.checksum_ignores_corruption, device),
        "eviction_drops_ranks": faults.validate_perm(fx.eviction_drops_ranks(8, (3,)), 8),
        "LOSSY_DECOMPOSER": laws.check_decomposition_kind(
            orswot, dec=fx.LOSSY_DECOMPOSER, device=device),
        "REDUNDANT_DECOMPOSER": laws.check_decomposition_kind(
            orswot, dec=fx.REDUNDANT_DECOMPOSER, device=device),
        "wal_skips_fsync": fsync,
        "snapshot_load_unchecked": loader_detects_corruption(fx.snapshot_load_unchecked),
        "fused_mask_drops_removals": wire_checks.check_fused_gate(
            know_fn=fx.fused_mask_drops_removals, label="fixtures.fused_mask_drops_removals",
            device=device),
        "bitmap_truncates_lanes": wire_checks.check_bitmaps(
            packer=fx.bitmap_truncates_lanes, label="fixtures.bitmap_truncates_lanes",
            device=device),
        "recorder_drops_events": obs.recorder_conformant(fx.recorder_drops_events),
        "histogram_miscounts": obs.histogram_conformant(fx.histogram_miscounts, device),
        "bootstrap_skips_checksum": scaleout.bootstrap_rejects_corruption(
            fx.bootstrap_skips_checksum, device),
        "drain_ignores_unacked": scaleout.drain_refuses_unflushed(
            fx.drain_ignores_unacked, device),
        "evictor_drops_dirt": serve.evictor_preserves_dirt(fx.evictor_drops_dirt, device),
        "serve_dispatch_before_wal": serve.wal_order_violations(fx.serve_dispatch_before_wal),
        "fanout_skips_watermark_bucket": fanout.fanout_covers_cohorts(
            fx.fanout_skips_watermark_bucket, device),
        "region_serves_unwatermarked_read": watermark_reads_sound(
            fx.region_serves_unwatermarked_read, device=device),
        "RogueCounterMutator": effects.unregistered_shared_mutations(
            extra=(fx.RogueCounterMutator,)),
        "UnorderedWalLoop": concur.call_order_violations(
            fx.UnorderedWalLoop, ("_log",), ("_issue",)),
        "regressing_ack_promoter": concur.ack_window_probe(
            fx.regressing_ack_promoter_cls(), device=device),
        "PersistFreesLanes": concur.uncovered_conflicts(
            extra=(fx.PersistFreesLanes,), extra_threads={"PersistFreesLanes": ("persist",)}),
        "tracer_skips_stage": trace.tracer_conformant(fx.tracer_skips_stage),
        "tracer_clock_regresses": trace.tracer_conformant(fx.tracer_clock_regresses),
    }


def explored_rows(explored: dict) -> dict:
    """The explorer's results, comparable across devices."""
    return {name: (r.schedules, r.events, r.ok, None if r.ok else (
        r.counterexample.schedule, r.counterexample.trace, r.counterexample.reasons))
        for name, r in explored.items()}


def static_wire_probes(device) -> dict:
    """The ``wire`` section's fixture packet and the ``fanout`` section's
    micro cohort packed on ``device``: host copies of the wire tree, the
    keep verdicts and the checksum, and of the cohort wire's words, keep,
    defer and checksum partial."""
    from crdt_tpu_torch.fanout import _micro_cohort
    from crdt_tpu_torch.ops.lattice import tree_leaves
    from crdt_tpu_torch.parallel import wire
    from crdt_tpu_torch.parallel.wire_checks import _codec, _fixture_packet

    pkt, digest = _fixture_packet(device)
    w, aux = _codec(pkt, wire.know_dense).pack(pkt, rtop=digest)
    _d, cw, _rt = _micro_cohort(device)
    host = lambda x: np_of(x).tolist()  # noqa: E731
    return {"fixture_wire": [host(x) for x in tree_leaves(w)], "fixture_keep": host(aux.keep),
            "fixture_checksum": host(aux.checksum),
            "cohort": {k: host(getattr(cw, k)) for k in ("words", "keep", "defer", "chk")}}


def phase_static_scenarios(device) -> dict:
    """The port's static-check runner on the card (ROADMAP 16): each
    section of ``analysis.run`` clean, timed, with its K1-K3 launches —
    every K3 launch held against the plain pack (``K3Checked``); K3 above
    0 in ``wire`` and ``fanout``, K1 and K2 at 0 everywhere. The
    ``concurrency`` section reads the explorer's worlds explored once on
    the card. Then every broken twin, the explorer's results and the wire
    and cohort probes, each card == CPU."""
    import torch

    from crdt_tpu_torch.analysis import run as static_run

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    out = {"phase": "static_scenarios", "card": card_label(device), "sections": {}}
    explored = None
    with K3Checked() as k3:
        for section in static_run.SECTIONS:
            before = kernel_launches()
            t0 = time.perf_counter()
            if section == "concurrency":
                explored = static_run.explore_worlds(device)
                found = static_run.run_concurrency(device, explored=explored)
            else:
                found = static_run.run_static_checks([section], device=device)[section]
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            launches = {k: v - before[k] for k, v in kernel_launches().items()}
            check(found == [], f"section {section} on {device}: {[str(f) for f in found]}")
            check(launches["k1"] == 0 and launches["k2"] == 0,
                  f"section {section} launched K1/K2: {launches}")
            out["sections"][section] = {"s": wall, "launches": launches}
            note(f"static_scenarios: {section} {wall:.1f} s, launches {launches}")
    for section in ("wire", "fanout"):  # a CPU rehearsal runs K3's plain version
        check(out["sections"][section]["launches"]["k3"] > 0 or device.type != "cuda",
              f"the {section} section launched no K3")
    out["k3_checked_groups"] = k3.calls
    out["k3_max_abs_err"] = k3.max_abs_err
    check(k3.max_abs_err == 0, f"K3 differs from its plain version: {k3.max_abs_err}")

    card, host = ({k: _twin_rows(v) for k, v in static_twins(dev).items()}
                  for dev in (device, cpu))
    check(card == host, f"twin results differ card vs CPU: "
                        f"{[k for k in host if card[k] != host[k]]}")
    uncaught = [k for k, v in host.items() if v is True or v == []]
    check(not uncaught, f"broken twins not caught: {uncaught}")
    out["twins_caught"] = sorted(host)

    card_ex = explored_rows(explored)
    cpu_ex = explored_rows(static_run.explore_worlds(cpu))
    check(card_ex == cpu_ex, f"explorer card {card_ex} != CPU {cpu_ex}")
    check([card_ex[k][:3] for k in ("serve", "fanout")] == [(21, 10, True), (51, 5, True)]
          and card_ex["racy"][2] is False,
          f"explorer counts {card_ex} are not the JAX package's 21/10, 51/5 and a race")
    out["explorer"] = {k: {"schedules": v[0], "events": v[1], "ok": v[2]}
                       for k, v in card_ex.items()}
    out["racy_schedule"] = [list(x) for x in card_ex["racy"][3][0]]

    probes = static_wire_probes(device)
    check(probes == static_wire_probes(cpu), "the wire fixture or the micro cohort: card != CPU")
    check(probes["fixture_keep"] == [True, False, True],
          f"fixture keep verdicts {probes['fixture_keep']}")
    out["fixture_keep"] = probes["fixture_keep"]
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---- phase 42: multihost (ROADMAP 5a) ---------------------------------------

MH_PROCESSES = 2
MH_LOCAL_RANKS = 4
MH_BLOCK = 128  # dense rows drawn from one generator
MH_TIMEOUT = 240  # seconds a worker pair may take before both are killed


def mh_dense_rows(seed: int, lo: int, hi: int, r: int, e: int, a: int, d: int, device):
    """Rows ``[lo, hi)`` of the multihost phase's dense ORSWOT batch of
    ``r`` rows at ``e`` × ``a``: one add history from ``seed`` (``project``,
    ``fill_config3``'s draws), each ``MH_BLOCK``-row block's tops and
    removals from a generator of its own, so a process that draws its own
    rows draws the bits the whole batch holds there. No parked removes."""
    import torch

    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.ops import orswot

    def drawer(gen):
        return lambda lo_, hi_, shape: torch.randint(lo_, hi_, shape, generator=gen,
                                                      device=device, dtype=torch.int32)

    history = config3_history(drawer(torch.Generator(device=device).manual_seed(seed)), e, a)
    st = orswot.empty(e, a, deferred_cap=d, batch=(hi - lo,), device=device)
    for b in range(lo // MH_BLOCK, -(-hi // MH_BLOCK)):
        gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + b)
        tops = config3_tops(drawer(gen), MH_BLOCK, a)
        ctr = project(history, tops, gen, 0.05 / r)
        rows = slice(max(lo, b * MH_BLOCK), min(hi, (b + 1) * MH_BLOCK))
        local = slice(rows.start - lo, rows.stop - lo)
        part = slice(rows.start - b * MH_BLOCK, rows.stop - b * MH_BLOCK)
        bits(st.ctr)[local] = ctr[part]
        bits(st.top)[local] = tops[part]
    return st


def mh_map_rows(seed: int, rows, r: int, k: int, s: int, a: int, d: int, device,
                max_lag: float = 0.02, p_remove: float = 0.01):
    """The given rows of the multihost phase's Map batch of ``r`` rows at
    config 4's widths, in ``fill_config4``'s layout: one write history
    from ``seed`` (counter key·S + j + 1 by actor (key + j) % A, slot 0
    always written, later slots with probability 1/2), each row's lag and
    removals from a generator of its own. No parked removes."""
    import torch

    from crdt_tpu_torch._dtypes import bits, from_wide
    from crdt_tpu_torch.ops import map as map_ops

    st = map_ops.empty(k, a, s, d, batch=(len(rows),), device=device)
    c = st.child
    hist = torch.Generator(device=device).manual_seed(seed + 4)
    slot = torch.arange(s, device=device)
    keys = torch.arange(k, device=device)[:, None]
    written = (slot == 0) | (torch.rand((k, s), generator=hist, device=device) < 0.5)
    ctr, act = keys * s + slot + 1, (keys + slot) % a
    end = k * s
    for i, row in enumerate(rows):
        gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + row)
        top = (end - torch.rand(a, generator=gen, device=device) * max_lag * end).long()
        kept = torch.rand((k, 1), generator=gen, device=device) >= p_remove / r
        held = written & kept & (ctr <= top[act])
        order = torch.argsort((~held).long() * a + act, dim=-1, stable=True)
        h, w, n = (torch.gather(x, 1, order) for x in (held, act, ctr))
        clk = torch.zeros((k, s, a), dtype=torch.int64, device=device)
        clk.scatter_(-1, w[..., None], n[..., None])
        c.wact[i] = torch.where(h, w, 0).to(torch.int32)
        bits(c.wctr)[i] = bits(from_wide(torch.where(h, n, 0), torch.uint32))
        bits(c.clk)[i] = bits(from_wide(torch.where(h[..., None], clk, 0), torch.uint32))
        c.val[i] = torch.where(h, (n - 1) % 5, 0).to(torch.int32)
        c.valid[i] = h
        bits(st.top)[i] = bits(from_wide(top, torch.uint32))
    return st


def mh_sparse_rows(rows, device, cells: int = 16, a: int = 4):
    """``tests/multihost_worker.py``'s sparse ``Map<K, MVReg>`` rows: row i
    is actor i % A's (i // A + 1)-th write of key 40 + i % 3."""
    import torch

    from crdt_tpu_torch.ops import sparse_mvmap as smv
    from crdt_tpu_torch.parallel.anti_entropy import stack

    out = []
    for i in rows:
        wct = i // a + 1
        clock = torch.zeros(a, dtype=torch.int32, device=device)
        clock[i % a] = wct
        row, of = smv.apply_up(smv.empty(cells, a, device=device), i % a, wct, 40 + i % 3,
                               clock.view(torch.uint32), 900 + i)
        check(not bool(torch.any(of)), f"sparse row {i} overflowed")
        out.append(row)
    return stack(out, out[0])


def mh_list_edits(pid: int, rnd: int) -> tuple:
    """``tests/multihost_list_worker.py``'s edits, ``(kinds, indices,
    values, actors)``: before round 0 process 0 types "ab" and deletes one
    character and process 1 types "XY" at the front; before round 1
    process 0 types "z" at the front and process 1 deletes its first."""
    from crdt_tpu_torch.native import DELETE, INSERT

    return {(0, 0): ([INSERT, INSERT, DELETE], [0, 1, 0], [ord("a"), ord("b"), 0], [0, 0, 0]),
            (1, 0): ([INSERT, INSERT], [0, 0], [ord("X"), ord("Y")], [1, 1]),
            (0, 1): ([INSERT], [0], [ord("z")], [0]),
            (1, 1): ([DELETE], [0], [0], [1])}[pid, rnd]


def mh_list_rounds(pid: int, device) -> list:
    """This process's two ``multihost.sync_list`` rounds of
    :func:`mh_list_edits`: ``(read, watermark)`` after each, every replica
    read the same and every process's read gathered equal."""
    import numpy as np

    from crdt_tpu_torch.models import BatchedList
    from crdt_tpu_torch.parallel import multihost

    model = BatchedList(4, device=device)
    out, watermark = [], 0
    for rnd in (0, 1):
        model.extend_trace(*mh_list_edits(pid, rnd))
        watermark = multihost.sync_list(model, since=watermark)
        model.apply_trace_to_all()
        reads = [model.read(r) for r in range(4)]
        check(all(x == reads[0] for x in reads), f"process {pid}'s replicas differ: {reads}")
        seq = np.asarray(reads[0], np.int64)
        check(all(np.array_equal(o, seq) for o in multihost._allgather_host(seq)),
              f"round {rnd}: the processes read different sequences")
        out.append((reads[0], watermark))
    return out


def mh_list_reference(device) -> list:
    """:func:`mh_list_rounds` of both processes in one process: two models
    swap their exports each round; per process, ``(read, watermark)``
    after each round."""
    from crdt_tpu_torch.models import BatchedList

    models = [BatchedList(4, device=device) for _ in (0, 1)]
    marks, out = [0, 0], [[], []]
    for rnd in (0, 1):
        for pid, m in enumerate(models):
            m.extend_trace(*mh_list_edits(pid, rnd))
        wires = [m.export_ops(w) for m, w in zip(models, marks)]
        for pid, m in enumerate(models):
            m.ingest_remote_ops(wires[1 - pid])
            marks[pid] = len(m.op_handles)
            m.apply_trace_to_all()
            out[pid].append((m.read(0), marks[pid]))
    return out


def mh_handoff(pid: int, device) -> dict:
    """``examples/04_multihost_dcn.py``'s tenant-shard handoff: each of two
    hosts serves the tenants it owns on 4 local ranks and holds a stale
    row of one tenant the other owns; one ``sync_tenant_shards`` round
    under ``retry=`` hands it off. Returns the report and the members of
    the tenant this host received, and the bytes this host exported."""
    import numpy as np

    from crdt_tpu_torch.faults import RetryPolicy
    from crdt_tpu_torch.parallel import VirtualMesh
    from crdt_tpu_torch.serve import IngestQueue, Superblock, TenantShardMap, sync_tenant_shards

    sb = Superblock(8, VirtualMesh(4, device), kind="orswot",
                    caps=dict(n_elems=8, n_actors=2, deferred_cap=2))
    smap = TenantShardMap(2)
    q = IngestQueue(sb, lanes=4, depth=2)

    def mask(*on):
        return np.isin(np.arange(8), on)

    for t in smap.owned(pid, range(8)):
        q.add(t, pid, 1, mask(t % 8))
    foreign = next(t for t in range(8) if smap.owner(t) != pid)
    q.add(foreign, pid, 1, mask(7 - (foreign % 8)))  # stale foreign residue
    q.drain()
    rep = sync_tenant_shards(sb, smap, pid, handoff=[foreign], retry=RetryPolicy(attempts=3))
    mine = next(t for t in range(8) if smap.owner(t) != 1 - pid)
    return {"shipped": rep.tenants_shipped, "joined": rep.tenants_joined,
            "bytes": rep.bytes_shipped, "tenant": mine,
            "members": np.flatnonzero(np.asarray(sb.read(mine))).tolist()}


def leaf_digests(state) -> list:
    """SHA-256 of every leaf's bytes (and dtype and shape), in leaf
    order: two states are equal leaf for leaf when their lists are."""
    import hashlib

    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.ops.lattice import tree_leaves

    out = []
    for x in tree_leaves(state):
        h = leaf_to_numpy(x)
        out.append(hashlib.sha256(f"{h.dtype}{h.shape}".encode() + h.tobytes()).hexdigest())
    return out


class FoldChecked:
    """Every K1 and K2 launch made inside it held against the kernel's
    plain version on the same inputs (``fold_entries_plain`` /
    ``fold_cells_plain``, which launch nothing and count nothing): the
    running max |diff| and the launches checked, per kernel. A wrapper
    counts its launches on the module's name for it, so while the check
    is in place the count rides the check, and it goes back on exit."""

    def __enter__(self):
        from crdt_tpu_torch.ops import fold_kernels as fk

        self._fk, self._k1, self._k2 = fk, fk.fold_entries, fk.fold_cells
        self.max_abs_err, self.calls = {"k1": 0, "k2": 0}, {"k1": 0, "k2": 0}

        def held(name, kernel, plain):
            def run(*args):
                got, want = kernel(*args), plain(*args)
                err = max(max_abs_diff(g, w) for g, w in zip(got, want))
                self.max_abs_err[name] = max(self.max_abs_err[name], err)
                self.calls[name] += 1
                return got
            run.launches = kernel.launches
            return run

        fk.fold_entries = held("k1", self._k1, fk.fold_entries_plain)
        fk.fold_cells = held("k2", self._k2, fk.fold_cells_plain)
        return self

    def __exit__(self, *exc):
        fk = self._fk
        self._k1.launches, self._k2.launches = fk.fold_entries.launches, fk.fold_cells.launches
        fk.fold_entries, fk.fold_cells = self._k1, self._k2
        return False


def mh_exchange() -> tuple:
    """The multihost exchange's wall seconds and bytes sent so far in this
    process (the metrics registry)."""
    from crdt_tpu_torch.utils.metrics import metrics

    snap = metrics.snapshot()
    return (snap["gauges"].get("multihost.exchange_seconds", {}).get("sum", 0.0),
            snap["counters"].get("multihost.bytes_sent", 0))


# The δ rings and the other fold and gossip kinds across processes
# (ROADMAP item 32): each ring's whole batch is drawn on P = 8 global
# ranks by its fill, and a process keeps its rows.
MH_CAP = 4096          # the dense and Map rings' cap (full_width_delta's)
MH_MAP_R = 8           # the Map ring's rows: config 4's R (bench.py), one a rank
# The Map ring's keys: config 4's 1M cut 4× for the phase's time (its
# rounds are device-bound sorts over the key axis); each actor's 1,024
# ops are the uncut fill's, the parked key masks on the wire shrink with K.
MH_DELTA_MAP_K = 250_000
MH_NEST_R = 32         # the nested rings' rows (their fill parks on 3 replicas a rank)
MH_NEST_WIDTHS = dict(k=100, m=20, k1=10, k2=10)   # the nested rings at the tests' sizes
MH_NEST_CAP = 512
MH_SMALL_R = 8         # the other kinds' rows: one a global rank
# Timed fused rings of each kind on both sides (a Map ring at K = 1M takes
# ≈ 2.6 s of sorts; the nested rings are gates only).
MH_RING_SAMPLES = {"dense": 2, "map": 1, "map_orswot": 0, "map3": 0}
MH_RINGS = {"dense": ("mesh_delta_gossip", MH_CAP), "map": ("mesh_delta_gossip_map", MH_CAP),
            "map_orswot": ("mesh_delta_gossip_map_orswot", MH_NEST_CAP),
            "map3": ("mesh_delta_gossip_map3", MH_NEST_CAP)}


def mh_ring_inputs(kind: str, seed: int, device, r: int, e: int, a: int, d: int, k: int,
                   s: int, map_a: int) -> tuple:
    """One δ ring's whole batch ``(state, dirty, fctx)`` on P = 8 global
    ranks: config 3's dense fill at ``r`` × ``e`` × ``a``
    (``full_width_delta``'s), config 4's Map fill at R = 8 × ``k`` keys, at
    most ``MH_DELTA_MAP_K`` (``full_width_delta_map``'s: K/20 keys written
    with dense counters, inside the wire's ±32 Ki window; with one replica
    a rank none parks ahead of its top), or a nested fill at the tests'
    sizes."""
    p = MH_PROCESSES * MH_LOCAL_RANKS
    if kind == "dense":
        out = fill_delta_config3(r, e, a, d, p, seed, device)
    elif kind == "map":
        out = fill_delta_config4(MH_MAP_R, min(k, MH_DELTA_MAP_K), s, map_a, 4, p, seed, device,
                                 n_des=0)
    else:
        out = fill_delta_nest(kind, MH_NEST_R, p, seed, device, chunk=MH_NEST_R,
                              **MH_NEST_WIDTHS)
    return out[:3]


def mh_ring_digest(out) -> dict:
    """A δ ring's result, rank by rank: every leaf's digest of each rank's
    row and dirty row, the flags and the residue."""
    import torch

    from crdt_tpu_torch.ops.lattice import tree_map

    rows, dirty, of, residue = out[:4]
    return {"rows": [leaf_digests(tree_map(lambda x: x[q], rows)) for q in range(dirty.shape[0])],
            "dirty": [leaf_digests(dirty[q]) for q in range(dirty.shape[0])],
            "overflow": torch.atleast_1d(of).tolist(), "residue": int(residue)}


def mh_rows_equal_fold(kind: str, rows, folded) -> bool:
    return (rows_equal_fold if kind in ("dense", "map") else nest_rows_equal_fold)(rows, folded)


def mh_fold_of(kind: str):
    from crdt_tpu_torch import parallel

    return {"dense": parallel.mesh_fold, "map": parallel.mesh_fold_map,
            "map_orswot": parallel.mesh_fold_map_orswot, "map3": parallel.mesh_fold_map3}[kind]


def mh_leaf_counter(kind: str):
    """The local fold's kernel of a ring: K2 for the Map, K1 otherwise."""
    from crdt_tpu_torch.ops import fold_kernels as fk

    return fk.fold_cells if kind == "map" else fk.fold_entries


def mh_single_ring(kind: str, inputs: tuple, device, samples: int) -> dict:
    """The single-process ring on P = 8 virtual ranks: certified fused
    (its budget, the one the processes run), == layered (== acked for the
    dense and Map rings) == the mesh fold, and the fused ring's walls."""
    from crdt_tpu_torch import parallel

    name, cap = MH_RINGS[kind]
    ring = getattr(parallel, name)
    st, dirty, fctx = inputs
    p = MH_PROCESSES * MH_LOCAL_RANKS
    mesh = parallel.VirtualMesh(p, device)
    backlog = int(dirty.view(p, dirty.shape[0] // p, -1).any(1).sum(-1).max())
    fused, rounds, stats, attempts, _ = certify_ring(
        lambda rounds, stats: ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap, stats=stats),
        backlog, p, cap, (), lambda: sync(device))
    check(not any(mh_ring_digest(fused)["overflow"]), f"{kind}: the single-process ring overflowed")
    layered = ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap, fused=False)
    check(same_leaves(fused[:2], layered[:2]) and int(layered[3]) == 0,
          f"{kind}: the single-process fused ring != the layered ring")
    del layered
    if kind in ("dense", "map"):
        acked = ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap, ack_window=True)
        check(same_leaves(fused[0], acked[0]) and int(acked[3]) == 0,
              f"{kind}: the single-process acked ring != the unacked ring")
        del acked
    folded, of = mh_fold_of(kind)(st, mesh)
    check(not bool(of.any()) and mh_rows_equal_fold(kind, fused[0], folded),
          f"{kind}: the single-process ring rows != the mesh fold")
    walls = []
    for _ in range(samples):
        sync(device)
        t0 = time.perf_counter()
        ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap)
        sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"rounds": rounds, "backlog": backlog, "attempts": attempts, "stats": stats,
           "digest": mh_ring_digest(fused), "wall_ms": walls}
    if kind == "dense":
        out["telemetry"] = dict(mh_ring_telemetry(ring, inputs, mesh, rounds, cap, device, False),
                                wall_ms_off=walls[-1])
    return out


def mh_cross_ring(kind: str, inputs: tuple, rounds: int, mesh, device, samples: int) -> dict:
    """One δ ring across the processes, this process's rows: fused with
    the launches counted (K3 set to 0 just before and read just after,
    the local fold's kernel with it), again with every K3 launch held
    against the plain pack, layered and (dense, Map) acked, all equal;
    == the cross-process mesh fold; then the fused ring's walls, its
    exchange ms and bytes."""
    import torch.distributed as dist

    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.ops.wire_kernels import wire_pack

    name, cap = MH_RINGS[kind]
    ring = getattr(parallel, name)
    st, dirty, fctx = inputs
    leaf = mh_leaf_counter(kind)
    stats = {}
    sync(device)
    wire_pack.launches = wire_pack.acked_launches = leaf.launches = 0
    fused = ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap, stats=stats)
    sync(device)
    out = {"k3_launches": wire_pack.launches, "leaf_launches": leaf.launches, "stats": stats,
           "digest": mh_ring_digest(fused)}
    with K3Checked() as k3c:
        checked = ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap)
    out.update(k3_checked=k3c.calls, k3_max_abs_err=k3c.max_abs_err,
               checked_same=same_leaves(checked[:2], fused[:2]))
    del checked
    layered = ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap, fused=False)
    out["layered_same"] = same_leaves(layered[:2], fused[:2]) and int(layered[3]) == 0
    del layered
    if kind in ("dense", "map"):
        wire_pack.launches = wire_pack.acked_launches = 0
        acked = ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap, ack_window=True)
        sync(device)
        out.update(acked_launches=[wire_pack.launches, wire_pack.acked_launches],
                   acked_same=same_leaves(acked[0], fused[0]) and int(acked[3]) == 0)
        del acked
    folded, of = mh_fold_of(kind)(st, mesh)
    out["equals_fold"] = not bool(of.any()) and mh_rows_equal_fold(kind, fused[0], folded)
    del folded, fused
    walls, exchange = [], []
    for _ in range(samples):
        sync(device)
        dist.barrier()
        x0, t0 = mh_exchange(), time.perf_counter()
        ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap)
        sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        x1 = mh_exchange()
        exchange.append(((x1[0] - x0[0]) * 1e3, x1[1] - x0[1]))
    out.update(wall_ms=walls, exchange_ms=[x for x, _ in exchange],
               exchange_bytes=[b for _, b in exchange])
    if kind == "dense":
        out["telemetry"] = dict(mh_ring_telemetry(ring, inputs, mesh, rounds, cap, device, True),
                                wall_ms_off=walls[-1])
    return out


def mh_small_kinds(seed: int, device) -> dict:
    """Every other fold and gossip entry at the tests' sizes, each on a
    batch of ``MH_SMALL_R`` rows: ``name → (entry, state, extra
    arguments)``."""
    import torch

    from crdt_tpu_torch._dtypes import from_wide
    from crdt_tpu_torch.models import BatchedMVReg
    from crdt_tpu_torch.ops import sparse_nest
    from crdt_tpu_torch.ops.lwwreg import LWWState
    from crdt_tpu_torch.pure import MVReg
    from crdt_tpu_torch.utils import Interner

    r = MH_SMALL_R
    rng = random.Random(seed + 32)
    gen = torch.Generator(device=device).manual_seed(seed + 32)

    def draw(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=device, dtype=torch.int64)

    mp = mh_map_rows(seed, range(r), r, 64, 2, 4, 4, device)
    sparse = sparse_actor_population(r, 256, 4096, 4, 256, device, seed=seed)
    smv = mh_sparse_rows(range(r), device)
    snest = nested_population(r, 256, 1024, 256, 4, 4, device, n_parked=4, rm_width=16,
                              seed=seed)
    level = sparse_nest.level_map_orswot(4)
    nests = {kind: nest_model(kind, nest_population(kind, rng, r)[0], device).state
             for kind in ("map_orswot", "map_map", "map3")}
    has = draw(10, (r,)) < 7
    lww = LWWState(hi=from_wide(draw(2, (r,)) * 0xFFFFFFFF, torch.uint32),
                   lo=from_wide(draw(4, (r,)), torch.uint32),
                   val=torch.where(has, draw(12, (r,)), 0).to(torch.int32), has=has)
    sites = [MVReg() for _ in range(r)]
    for _ in range(30):
        i = rng.randrange(r)
        op = sites[i].write(f"v{rng.randrange(5)}", sites[i].read().derive_add_ctx(
            rng.choice("abcd")))
        sites[i].apply(op)
        if rng.random() < 0.4:
            sites[rng.randrange(r)].merge(sites[i].clone())
    mv = BatchedMVReg.from_pure(sites, actors=Interner(sorted("abcd")), values=Interner(),
                                device=device).state
    return {
        "mesh_gossip_map": ("mesh_gossip_map", mp, ()),
        "mesh_fold_sparse": ("mesh_fold_sparse", sparse, ()),
        "mesh_gossip_sparse": ("mesh_gossip_sparse", sparse, ()),
        "mesh_gossip_sparse_mvmap": ("mesh_gossip_sparse_mvmap", smv, (None, 4)),
        "mesh_fold_sparse_nested": ("mesh_fold_sparse_nested", snest, (level,)),
        "mesh_gossip_sparse_nested": ("mesh_gossip_sparse_nested", snest, (level,)),
        "mesh_fold_map_orswot": ("mesh_fold_map_orswot", nests["map_orswot"], ()),
        "mesh_gossip_map_orswot": ("mesh_gossip_map_orswot", nests["map_orswot"], ()),
        "mesh_fold_map3": ("mesh_fold_map3", nests["map3"], ()),
        "mesh_gossip_map3": ("mesh_gossip_map3", nests["map3"], ()),
        "mesh_fold_nested_map": ("mesh_fold_nested_map", nests["map_map"], ()),
        "mesh_gossip_nested_map": ("mesh_gossip_nested_map", nests["map_map"], ()),
        "mesh_fold_lww": ("mesh_fold_lww", lww, ()),
        "mesh_fold_mvreg": ("mesh_fold_mvreg", mv, ()),
        "mesh_fold_clocks": ("mesh_fold_clocks", from_wide(draw(1 << 32, (r, 6)), torch.uint32),
                             ()),
        "mesh_fold_clocks_u64": ("mesh_fold_clocks",
                                 from_wide(draw(1 << 62, (r, 6)), torch.uint64), ()),
        "mesh_fold_gset": ("mesh_fold_gset", draw(10, (r, 33)) == 0, ()),
    }


def mh_small_digests(cases: dict, mesh, rows=None) -> dict:
    """Each small case's entry on ``mesh`` (this process's ``rows`` of its
    batch across processes): a fold's state digests, a gossip's per rank,
    and the flags."""
    import torch

    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map

    out = {}
    for name, (entry, state, args) in cases.items():
        if rows is not None:
            state = tree_map(lambda x: x[rows], state)
        got = getattr(parallel, entry)(state, mesh, *args)
        if not isinstance(got, tuple):  # the clock and set folds: the state alone
            out[name] = {"state": leaf_digests(got)}
            continue
        flags = torch.atleast_1d(got[1]).tolist()
        if "gossip" in entry:
            ranks = tree_leaves(got[0])[0].shape[0]
            out[name] = {"rows": [leaf_digests(tree_map(lambda x: x[q], got[0]))
                                  for q in range(ranks)], "flags": flags}
        else:
            out[name] = {"state": leaf_digests(got[0]), "flags": flags}
    return out


def mh_ring_report(kind: str, single: dict, cross: list) -> dict:
    """One ring's figures: the budget, the single-process and per-process
    walls, exchange ms per round and bytes per round across the process
    boundary (each process's one outgoing boundary link), and the launch
    counts."""
    med = statistics.median
    rounds = single["rounds"]
    out = {"rounds": rounds, "backlog_max_per_rank": single["backlog"],
           "attempts": single["attempts"],
           "wire_bytes_per_link_round": single["stats"].get("wire_bytes"),
           "layered_packet_bytes_per_link_round": single["stats"].get("packet_bytes"),
           "slots_shipped": single["stats"]["slots_shipped"]}
    if not single["wall_ms"]:
        return out
    out.update(
        single_process_wall_ms=single["wall_ms"],
        single_process_wall_ms_median=med(single["wall_ms"]),
        workers=[{"process": pid, "k3_launches": x["k3_launches"],
                  "leaf_kernel_launches": x["leaf_launches"],
                  "acked_launches": x.get("acked_launches"), "wall_ms": x["wall_ms"],
                  "wall_ms_median": med(x["wall_ms"]),
                  "exchange_ms_per_round": [t / rounds for t in x["exchange_ms"]],
                  "exchange_bytes_per_round": [b / rounds for b in x["exchange_bytes"]]}
                 for pid, x in enumerate(cross)],
    )
    out["cross_over_single"] = (max(w["wall_ms_median"] for w in out["workers"])
                                / out["single_process_wall_ms_median"])
    return out


# The streams, element-sharded folds and elastic loops across processes
# (ROADMAP item 32, second part): the single-process entry on P = 8 (4 × 2
# sharded) draws each global block whole, a process its own half of it.
# BENCH_CONFIGS.json "flagship" (phase_flagship's defaults): replicas, universe,
# actors, dot cap, global block rows.
MH_FLAGSHIP = (10240, 1_000_000, 8, 4096, 256)
MH_SHARDED_BLOCKS = 10       # the sharded flagship stream's blocks: 10 of the 40, for the time
MH_FLAGSHIP_PASSES = 2       # timed passes each way (the first includes warm-up)
MH_DENSE_BLOCKS = 4          # the dense stream's global blocks (R = 2,048: 512 rows each)
MH_ELASTIC_CAP = 4096        # the δ elastic loop's cap (phase_elastic's)
MH_MAP_ELASTIC_R = 64        # the Map elastic loop's rows (phase_elastic's map_r)


def mh_half(b: int, rows: int, pid: int, n: int, device):
    """Process ``pid``'s row ids of global block ``b`` of ``rows`` rows: its
    ``rows / n`` in process order (global rank ``pid · P_local + q``)."""
    import torch

    lo = b * rows + pid * rows // n
    return torch.arange(lo, lo + rows // n, device=device)


def mh_sharded_cases(seed: int, device) -> dict:
    """The four element-sharded folds at the tests' sizes (R = 8, S = 2):
    ``name → (state [R, S, ...], extra arguments)``."""
    from crdt_tpu_torch.ops import sparse_nest
    from crdt_tpu_torch.parallel import split_cells, split_nested, split_segments

    r = MH_SMALL_R
    nested = split_nested(nested_population(r, 256, 1024, 256, 4, 4, device, n_parked=4,
                                            rm_width=16, seed=seed), 2)
    return {
        "mesh_fold_sparse_sharded": (
            split_segments(sparse_actor_population(r, 256, 4096, 4, 256, device, seed=seed), 2),
            ()),
        "mesh_fold_sparse_mvmap_sharded": (split_cells(mh_sparse_rows(range(r), device), 2), (4,)),
        "mesh_fold_sparse_nested_sharded": (nested, (sparse_nest.level_map_orswot(4),)),
        "mesh_fold_sparse_map": (nested, (4,)),
    }


def mh_elastic_inputs(seed: int, device, r: int, e: int, a: int, parking=None) -> tuple:
    """The elastic loops' dense batch at config 3's widths, born at D = 2
    (``phase_elastic``'s fill, ``max_parked=2``: a rank's fold meets three
    parked cross removes): ``(quiet, state, dirty, fctx, parking)`` —
    ``quiet`` the state with the parked buffers emptied on every process's
    rows but those of process ``parking`` (by default the process of the
    first rank whose local fold overflows), so only that process's rows
    fill the capacity."""
    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.ops.fold_kernels import fold_auto
    from crdt_tpu_torch.parallel import VirtualMesh
    from crdt_tpu_torch.parallel.anti_entropy import local_folds, rank_blocks

    p = MH_PROCESSES * MH_LOCAL_RANKS
    st, dd, ff, _ = fill_delta_config3(r, e, a, 2, p, seed, device, chunk=min(128, r // 4),
                                       max_parked=2)
    if parking is None:
        _, of = local_folds(rank_blocks(st, VirtualMesh(p, device)), fold_auto)
        parking = of.tolist().index(True) // MH_LOCAL_RANKS
    keep = slice(parking * r // MH_PROCESSES, (parking + 1) * r // MH_PROCESSES)
    dcl, dmask, dvalid = bits(st.dcl).clone(), st.dmask.clone(), st.dvalid.clone()
    for x in (dcl, dmask, dvalid):
        kept = x[keep].clone()
        x.zero_()
        x[keep] = kept
    quiet = st._replace(dcl=dcl.view(st.dcl.dtype), dmask=dmask, dvalid=dvalid)
    return quiet, st, dd, ff, parking


def mh_map_elastic_state(seed: int, device, k: int, s: int, map_a: int):
    """The Map elastic loop's batch: ``phase_elastic``'s Map fill at
    ``MH_MAP_ELASTIC_R`` rows, K cut to ``MH_DELTA_MAP_K``, born at D = 1."""
    st, _, _, _ = fill_delta_config4(MH_MAP_ELASTIC_R, min(k, MH_DELTA_MAP_K), s, map_a, 1,
                                     MH_PROCESSES * MH_LOCAL_RANKS, seed, device, 8, max_parked=1)
    return st


def mh_stream_legs(seed: int, device, mesh, smesh, r: int, e: int, a: int, d: int, k: int,
                   s: int, map_a: int, flagship=MH_FLAGSHIP, pid: int = 0, n: int = 1,
                   delta_rounds=None, parking=None) -> dict:
    """The streams, the element-sharded folds and the elastic loops on
    ``mesh`` (``smesh`` the sharded one): the single-process entries on P
    = 8 (``n`` = 1) or this process's part across ``n`` processes. Every
    result as leaf digests (a gossip's and a ring's rank by rank); the
    kernels' launches counted from 0 around each leg that runs them, every
    launch held against its plain version; walls, and across processes the
    exchange ms and bytes a block. ``flagship`` is ``MH_FLAGSHIP``'s tuple.
    Returns the legs (the δ elastic loop's round budget and the parking
    process of the dense gossip among them: the single-process run sets
    them, the processes take them)."""
    import torch
    import torch.distributed as dist

    from crdt_tpu_torch.faults import FaultPlan
    from crdt_tpu_torch.models import BatchedMap, BatchedOrswot
    from crdt_tpu_torch.ops import fold_kernels as fk
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.ops.wire_kernels import wire_pack
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.parallel import split_segments

    cross = n > 1
    local = slice(pid * r // n, (pid + 1) * r // n)

    def barrier():
        sync(device)
        if cross:
            dist.barrier()

    def rank_digests(rows):
        return [leaf_digests(tree_map(lambda x: x[q], rows))
                for q in range(rows.top.shape[0])]

    out = {}
    fl_r, universe, fl_a, cap, block_rows = flagship
    gen, _ = flagship_population(cap, universe, fl_a, device)
    n_blocks = fl_r // block_rows

    def flagship_blocks(m, split=False):
        for b in range(m):
            block = gen(mh_half(b, block_rows, pid, n, device))
            yield split_segments(block, 2) if split else block

    walls, exchange = [], []
    for _ in range(MH_FLAGSHIP_PASSES):
        barrier()
        x0, t0 = mh_exchange(), time.perf_counter()
        acc, of = parallel.mesh_stream_fold_sparse(flagship_blocks(n_blocks), mesh)
        sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        x1 = mh_exchange()
        exchange.append(((x1[0] - x0[0]) * 1e3 / n_blocks, (x1[1] - x0[1]) / n_blocks))
    out["flagship"] = {"digest": leaf_digests(acc), "overflow": torch.atleast_1d(of).tolist(),
                       "R": fl_r, "blocks": n_blocks, "block_rows": block_rows, "wall_ms": walls,
                       "exchange_ms_per_block": [x for x, _ in exchange],
                       "exchange_bytes_per_block": [b for _, b in exchange]}
    del acc
    # The sidecar over the sharded leg's first blocks (ROADMAP 32, third
    # part), off and on.
    (clean, off_ms), (res, on_ms) = (mh_timed(lambda: parallel.mesh_stream_fold_sparse(
        flagship_blocks(MH_SHARDED_BLOCKS), mesh, telemetry=on), device, cross)
        for on in (False, True))
    out["flagship"]["telemetry"] = {"telemetry": mh_tel(res[2]), "blocks": MH_SHARDED_BLOCKS,
                                    "wall_ms_off": off_ms, "wall_ms_on": on_ms}
    del res
    # The same blocks over a faulted upload wire, then the re-stream of
    # the lost ones from the faulted accumulator: the unfaulted stream's
    # state (ROADMAP 32, fourth part).
    faults = {}
    (acc, of, report), ms = mh_timed(lambda: parallel.mesh_stream_fold_sparse(
        flagship_blocks(MH_SHARDED_BLOCKS), mesh, faults=FaultPlan(**MH_STREAM_FAULTS)),
        device, cross)
    lost = iter(report.lost_blocks)
    healed, _ = parallel.mesh_stream_fold_sparse(
        (gen(mh_half(b, block_rows, pid, n, device)) for b in lost), mesh, init=acc)
    faults["stream"] = {"digest": leaf_digests(acc), "overflow": torch.atleast_1d(of).tolist(),
                        "report": [report.dropped_blocks, report.rejected_blocks],
                        "healed": leaf_digests(healed), "wall_ms": ms}
    check(faults["stream"]["healed"] == leaf_digests(clean[0]) and report.lost_blocks,
          f"the faulted flagship stream re-streamed ({report}) != the unfaulted stream")
    del acc, healed, clean
    acc, of = parallel.mesh_stream_fold_sparse_sharded(
        flagship_blocks(MH_SHARDED_BLOCKS, split=True), smesh)
    out["flagship_sharded"] = {"digest": leaf_digests(acc),
                               "overflow": torch.atleast_1d(of).tolist()}
    del acc, gen

    # The dense stream at config 3's widths: K1 in every rank's local fold.
    def dense_blocks():
        for b in range(MH_DENSE_BLOCKS):
            rows = mh_half(b, r // MH_DENSE_BLOCKS, pid, n, device)
            yield mh_dense_rows(seed, int(rows[0]), int(rows[-1]) + 1, r, e, a, d, device)

    barrier()
    fk.fold_entries.launches = 0
    with FoldChecked() as held:
        acc, of = parallel.mesh_stream_fold(dense_blocks(), mesh)
        sync(device)
    k1 = fk.fold_entries.launches
    barrier()
    t0 = time.perf_counter()
    parallel.mesh_stream_fold(dense_blocks(), mesh)
    sync(device)
    out["dense_stream"] = {"digest": leaf_digests(acc), "overflow": [bool(of)],
                           "blocks": MH_DENSE_BLOCKS, "k1": k1, "checked": held.calls["k1"],
                           "max_abs_err": held.max_abs_err["k1"],
                           "wall_ms": (time.perf_counter() - t0) * 1e3}
    del acc

    out["sharded_folds"] = {}
    for name, (state, args) in mh_sharded_cases(seed, device).items():
        rows = slice(pid * MH_SMALL_R // n, (pid + 1) * MH_SMALL_R // n)
        got, flags = getattr(parallel, name)(tree_map(lambda x: x[rows], state), smesh, *args)
        out["sharded_folds"][name] = {"state": leaf_digests(got),
                                      "flags": torch.atleast_1d(flags).tolist()}

    # The elastic loops: dense gossip over the quiet batch (only process
    # 0's rows park), the fused δ loop over the whole fill, the Map gossip.
    if device.type == "cuda":
        torch.cuda.empty_cache()
    quiet, st, dd, ff, parking = mh_elastic_inputs(seed, device, r, e, a, parking)
    if not cross:
        p = MH_PROCESSES * MH_LOCAL_RANKS
        backlog = int(dd.view(p, r // p, e).any(1).sum(-1).max())
        delta_rounds = 2 * (p - 1) * (1 + -(-backlog // MH_ELASTIC_CAP)) - 1
    if cross:
        quiet, st, dd, ff = (tree_map(lambda x: x[local].clone(), t) for t in (quiet, st, dd, ff))
    model = BatchedOrswot(1, e, a, 2, device=device)
    model.state = quiet
    barrier()
    fk.fold_entries.launches = 0
    with FoldChecked() as held:
        t0 = time.perf_counter()
        rows, widened = parallel.gossip_elastic(model, mesh)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
    out["gossip_elastic"] = {"rows": rank_digests(rows), "widened": widened, "parking": parking,
                             "k1": fk.fold_entries.launches, "checked": held.calls["k1"],
                             "max_abs_err": held.max_abs_err["k1"], "wall_ms": ms}
    del model, rows
    # The same loop under faults (ROADMAP 32, fourth part).
    model = BatchedOrswot(1, e, a, 2, device=device)
    model.state = quiet
    with FoldChecked() as held:
        (rows, widened, fc), ms = mh_timed(lambda: parallel.gossip_elastic(
            model, mesh, faults=FaultPlan(**MH_FAULTS)), device, cross)
    faults["gossip_elastic"] = {"rows": rank_digests(rows), "widened": widened,
                                "counters": mh_counters(fc), "max_abs_err": held.max_abs_err["k1"],
                                "wall_ms": ms}
    del model, rows
    # The reclaim half over the same rows (ROADMAP 32, third part).
    out["reclaim"] = {"gossip_elastic": mh_reclaim_loop("gossip_elastic", quiet, mesh, device,
                                                        cross, e, a)}
    del quiet
    model = BatchedOrswot(1, e, a, 2, device=device)
    model.state = st
    barrier()
    fk.fold_entries.launches = wire_pack.launches = 0
    stats = {}
    with FoldChecked() as held, K3Checked() as k3c:
        t0 = time.perf_counter()
        res = parallel.delta_gossip_elastic(model, dd, ff, mesh, rounds=delta_rounds,
                                            cap=MH_ELASTIC_CAP, stats=stats)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
    out["delta_gossip_elastic"] = {
        **mh_ring_digest(res[:4]), "widened": res[4], "stats": stats, "rounds": delta_rounds,
        "k1": fk.fold_entries.launches, "k3": wire_pack.launches, "k3_checked": k3c.calls,
        "k1_max_abs_err": held.max_abs_err["k1"], "k3_max_abs_err": k3c.max_abs_err,
        "wall_ms": ms}
    del model, res
    out["reclaim"]["delta_gossip_elastic"] = mh_reclaim_loop(
        "delta_gossip_elastic", st, mesh, device, cross, e, a, tracking=(dd, ff),
        rounds=delta_rounds)
    model = BatchedOrswot(1, e, a, 2, device=device)
    model.state = st
    wire_pack.launches = 0
    with FoldChecked() as held, K3Checked() as k3c:
        res, ms = mh_timed(lambda: parallel.delta_gossip_elastic(
            model, dd, ff, mesh, rounds=delta_rounds, cap=MH_ELASTIC_CAP,
            faults=FaultPlan(**MH_FAULTS)), device, cross)
    dig = mh_ring_digest(res[:4])
    faults["delta_gossip_elastic"] = {
        "rows": dig["rows"], "dirty": dig["dirty"], "widened": res[4],
        "counters": mh_counters(res[5]), "k3": wire_pack.launches, "k3_checked": k3c.calls,
        "rounds": delta_rounds, "max_abs_err": max(held.max_abs_err["k1"], k3c.max_abs_err),
        "wall_ms": ms}
    del model, res
    out["faults"] = faults
    del st, dd, ff
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mstate = mh_map_elastic_state(seed, device, k, s, map_a)
    if cross:
        mrows = slice(pid * MH_MAP_ELASTIC_R // n, (pid + 1) * MH_MAP_ELASTIC_R // n)
        mstate = tree_map(lambda x: x[mrows].clone(), mstate)
    model = BatchedMap(1, min(k, MH_DELTA_MAP_K), map_a, s, 1, device=device)
    model.state = mstate
    barrier()
    fk.fold_cells.launches = 0
    with FoldChecked() as held:
        t0 = time.perf_counter()
        rows, widened = parallel.gossip_elastic(model, mesh)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
    out["map_gossip_elastic"] = {
        "rows": rank_digests(rows), "widened": widened, "k2": fk.fold_cells.launches,
        "checked": held.calls["k2"],
        "max_abs_err": held.max_abs_err["k2"], "wall_ms": ms}
    return out


def mh_check_legs(pid: int, got: dict, want: dict, ranks: slice, on_card: bool) -> None:
    """Worker ``pid``'s streams, sharded folds and elastic loops against the
    single-process ones (``ranks``: the worker's global ranks), and their
    kernels' launches on the card."""
    for name in ("flagship", "flagship_sharded", "dense_stream"):
        check(got[name]["digest"] == want[name]["digest"]
              and got[name]["overflow"] == want[name]["overflow"]
              and not any(got[name]["overflow"]),
              f"worker {pid}: the cross-process {name} stream != the single-process stream")
    check(got["sharded_folds"] == want["sharded_folds"],
          f"worker {pid}: a cross-process sharded fold != the single-process fold")
    for name, widened in (("gossip_elastic", {"deferred_cap": 4}),
                          ("map_gossip_elastic", {"deferred_cap": 2}),
                          ("delta_gossip_elastic", {"deferred_cap": 4})):
        check(got[name]["rows"] == want[name]["rows"][ranks]
              and got[name]["widened"] == want[name]["widened"] == widened,
              f"worker {pid}: the cross-process {name} (widened {got[name]['widened']}) != the "
              f"single-process loop (widened {want[name]['widened']})")
    dg, dw = got["delta_gossip_elastic"], want["delta_gossip_elastic"]
    check(dg["dirty"] == dw["dirty"][ranks] and dg["overflow"] == dw["overflow"]
          and dg["residue"] == dw["residue"] == 0 and dg["stats"] == dw["stats"],
          f"worker {pid}: the cross-process delta_gossip_elastic's dirty rows, flags, residue or "
          f"stats != the single-process loop's")
    check(max(got["dense_stream"]["max_abs_err"], got["gossip_elastic"]["max_abs_err"],
              got["map_gossip_elastic"]["max_abs_err"], dg["k1_max_abs_err"],
              dg["k3_max_abs_err"]) == 0,
          f"worker {pid}: a K1/K2/K3 launch of the streams or elastic loops != its plain version")
    if on_card:
        launches = {"dense_stream k1": (got["dense_stream"]["k1"], got["dense_stream"]["checked"],
                                        got["dense_stream"]["blocks"] * MH_LOCAL_RANKS),
                    "gossip_elastic k1": (got["gossip_elastic"]["k1"],
                                          got["gossip_elastic"]["checked"], 2 * MH_LOCAL_RANKS),
                    "map_gossip_elastic k2": (got["map_gossip_elastic"]["k2"],
                                              got["map_gossip_elastic"]["checked"],
                                              2 * MH_LOCAL_RANKS),
                    "delta_gossip_elastic k1": (dg["k1"], dg["k1"], 2 * MH_LOCAL_RANKS),
                    "delta_gossip_elastic k3": (dg["k3"], dg["k3_checked"], 2 * dg["rounds"])}
        check(all(n == c == want_n for n, c, want_n in launches.values()),
              f"worker {pid}: launches (counted, checked, expected) {launches}")


def mh_legs_report(single: dict, cross: list) -> dict:
    """The streams' and elastic loops' figures: the single-process and
    per-process walls, the flagship stream's merges/s across the
    processes ((R − 1) / its slowest process's wall), exchange ms and bytes
    a block, and the kernels' launches per process."""
    f = single["flagship"]
    r = f["R"]
    out = {"flagship": {
        "R": r, "blocks": f["blocks"], "block_rows": f["block_rows"],
        "single_process_wall_ms": f["wall_ms"],
        "single_process_merges_per_s": [(r - 1) / (w / 1e3) for w in f["wall_ms"]],
        "workers": [{"process": pid, "wall_ms": x["flagship"]["wall_ms"],
                     "exchange_ms_per_block": x["flagship"]["exchange_ms_per_block"],
                     "exchange_bytes_per_block": x["flagship"]["exchange_bytes_per_block"]}
                    for pid, x in enumerate(cross)]}}
    walls = [max(x["flagship"]["wall_ms"][i] for x in cross) for i in range(MH_FLAGSHIP_PASSES)]
    out["flagship"].update(cross_process_wall_ms=walls,
                           cross_process_merges_per_s=[(r - 1) / (w / 1e3) for w in walls],
                           cross_over_single=walls[-1] / f["wall_ms"][-1])
    out["sharded_stream_blocks"] = MH_SHARDED_BLOCKS
    for name in ("dense_stream", "gossip_elastic", "map_gossip_elastic", "delta_gossip_elastic"):
        out[name] = {"single_process_wall_ms": single[name]["wall_ms"],
                     "workers_wall_ms": [x[name]["wall_ms"] for x in cross],
                     "widened": single[name].get("widened")}
    out["launches_per_process"] = [
        {"dense_stream_k1": x["dense_stream"]["k1"], "gossip_elastic_k1": x["gossip_elastic"]["k1"],
         "map_gossip_elastic_k2": x["map_gossip_elastic"]["k2"],
         "delta_gossip_elastic_k1": x["delta_gossip_elastic"]["k1"],
         "delta_gossip_elastic_k3": x["delta_gossip_elastic"]["k3"]} for x in cross]
    out["delta_gossip_elastic"]["rounds"] = single["delta_gossip_elastic"]["rounds"]
    out["reduced"] = {
        "flagship_sharded": f"{MH_SHARDED_BLOCKS} of the flagship's {f['blocks']} blocks",
        "dense_stream_and_elastic_R": "config 3's 10,240 cut to the phase's R",
        "map_gossip_elastic": f"R = {MH_MAP_ELASTIC_R} (phase_elastic's), K cut to "
                              f"{MH_DELTA_MAP_K:,}",
        "sharded_folds": f"the tests' sizes (R = {MH_SMALL_R})"}
    return out


# The serving dispatches, the sidecar and the reclamation options across
# processes (ROADMAP item 32, third part).
MH_SERVE = (262_144, 4096, 4, 20)   # lanes, slab lanes, slab depth, dispatches (bench serve)
MH_FANOUT = (131_072, 256, 4, 4096)  # lanes, E, A, dispatch lanes (phase_fanout's layout)
MH_FANOUT_DISPATCHES = 5             # timed fan-out dispatches each way
MH_STALL = 1                         # the stability leg's lag threshold: it warns


def mh_serve_slabs(seed: int, lanes: int, b: int, depth: int, dispatches: int, caps: dict,
                   p: int) -> list:
    """Every dispatch's GLOBAL op slab of the serve leg as numpy ``(planes,
    idx)``: rank r's ``b/p`` lanes touch distinct rows of its ``lanes/p``
    block (every 16th lane empty), each lane two adds, a remove of what
    they made (one in ten a counter ahead on actor 0: it parks) and one
    more add; per-tenant counters rise across the dispatches."""
    import numpy as np

    from crdt_tpu_torch.ops.superblock import ADD, NOOP, RM

    rng = np.random.default_rng(seed)
    a, e = caps["n_actors"], caps["n_elems"]
    lpr, bpr = lanes // p, b // p
    nxt = np.zeros((lanes, a), np.int64)
    out = []
    for _ in range(dispatches):
        idx = np.concatenate([rng.choice(lpr, bpr, replace=False) for _ in range(p)]).astype(
            np.int32)
        idx[::16] = -1
        ok = idx >= 0
        g = np.arange(b) // bpr * lpr + np.maximum(idx, 0)
        c0, c1 = nxt[g, 0], nxt[g, 1]
        kind = np.where(ok[:, None], np.array([ADD, ADD, RM, ADD][:depth], np.uint8), NOOP)
        actor = np.broadcast_to(np.array([0, 1, 0, 0][:depth], np.int32), (b, depth)).copy()
        ctr = np.stack([c0 + 1, c1 + 1, np.zeros(b, np.int64), c0 + 2][:depth], 1)
        clock = np.zeros((b, depth, a), np.uint32)
        clock[:, 2, 0] = c0 + 1 + (rng.random(b) < 0.1)
        clock[:, 2, 1] = c1 + 1
        planes = dict(kind=kind.astype(np.uint8), actor=actor,
                      ctr=np.where(ok[:, None], ctr, 0).astype(np.uint32),
                      clock=np.where(ok[:, None, None], clock, 0).astype(np.uint32),
                      member=rng.random((b, depth, e)) < 0.5)
        nxt[g[ok], 0] += 2
        nxt[g[ok], 1] += 1
        out.append((planes, idx))
    return out


def mh_fanout_rank(seed: int, rank: int, rows: int, e: int, a: int, d: int, lanes: int, device):
    """Global rank ``rank``'s share of the fan-out leg, drawn on the card
    from its own generator: its ``rows`` superblock rows (a quarter of the
    members live, counters 1..3), its ``lanes`` dispatch lanes' local
    indices (every 8th empty) and their acked bases (each its row with a
    tenth of the counters one behind), cohort weights 1..8."""
    import torch

    from crdt_tpu_torch.ops.orswot import OrswotState

    g = torch.Generator(device=device)
    g.manual_seed(seed * 1009 + rank)
    u32 = torch.uint32
    ctr = torch.randint(1, 4, (rows, e, a), generator=g, device=device, dtype=torch.int32)
    ctr = ctr * (torch.rand((rows, e, 1), generator=g, device=device) < 0.25)
    idx = torch.randperm(rows, generator=g, device=device)[:lanes].to(torch.int32)
    idx[::8] = -1
    base = ctr[idx.clamp_min(0).long()]
    base = (base - (torch.rand(base.shape, generator=g, device=device) < 0.1).to(torch.int32)
            ).clamp_min(0)

    def state(c):
        n = c.shape[0]
        return OrswotState(
            top=c.amax(dim=1).view(u32), ctr=c.view(u32),
            dcl=torch.zeros((n, d, a), dtype=torch.int32, device=device).view(u32),
            dmask=torch.zeros((n, d, e), dtype=torch.bool, device=device),
            dvalid=torch.zeros((n, d), dtype=torch.bool, device=device))

    weights = torch.randint(1, 9, (lanes,), generator=g, device=device).to(torch.float32)
    return state(ctr), state(base), idx, weights


def mh_tel(tel) -> dict:
    """A Telemetry's fields but the host-timed ones (``HOST_TIMED``)."""
    from crdt_tpu_torch import telemetry as tele

    return {k: v for k, v in tele.to_dict(tel).items() if k not in HOST_TIMED}


def mh_dispatch_legs(seed: int, device, mesh, pid: int = 0, n: int = 1, serve=MH_SERVE,
                     fan=MH_FANOUT) -> dict:
    """The serving dispatches on ``mesh``: the single-process entries on P =
    8 (``n`` = 1; every result cut into each process's share) or this
    process's part across ``n`` processes. ``serve``: ``mesh_serve_apply``
    at bench serve's width, donated, ± ``telemetry=``; ``fanout``:
    ``mesh_fanout_push`` at ``phase_fanout``'s layout, one K3 launch a
    dispatch held against its plain version, ± ``telemetry=``. Results as
    digests. The sidecar and reclamation legs run where their inputs are
    drawn anyway (:func:`mh_dense_options`, :func:`mh_ring_telemetry`,
    :func:`mh_stream_legs`) and :func:`mh_options` gathers them."""
    import statistics as st

    import numpy as np
    import torch
    import torch.distributed as dist

    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.convert import opslab_from_numpy
    from crdt_tpu_torch.ops import orswot
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.ops.wire_kernels import wire_pack

    cross = n > 1

    def barrier():
        sync(device)
        if cross:
            dist.barrier()

    def shares(tree):
        return mh_shares(tree, cross)

    out = {}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # ---- serve: 20 donated dispatches, the sidecar off and on -----------
    lanes, b, depth, dispatches = serve
    cfg = serve_config()
    caps = dict(n_elems=cfg["elems"], n_actors=cfg["actors"], deferred_cap=cfg["deferred_cap"])
    p_all = MH_PROCESSES * MH_LOCAL_RANKS
    slabs = []
    for planes, idx in mh_serve_slabs(seed, lanes, b, depth, dispatches, caps, p_all):
        if cross:
            lo, hi = pid * b // n, (pid + 1) * b // n
            planes, idx = {k: v[lo:hi] for k, v in planes.items()}, idx[lo:hi]
        slabs.append((opslab_from_numpy(planes, device), torch.as_tensor(idx, device=device)))
    out["serve"] = {"lanes": lanes, "slab": [b, depth], "dispatches": dispatches}
    for on in (False, True):
        state = orswot.empty(caps["n_elems"], caps["n_actors"], caps["deferred_cap"],
                             batch=(lanes // n,), device=device)
        flags, tels, walls = [], [], []
        barrier()
        for slab, idx in slabs:
            t0 = time.perf_counter()
            res = parallel.mesh_serve_apply(state, slab, idx, mesh, kind="orswot", donate=True,
                                            telemetry=on)
            sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
            state, of = res[:2]
            flags.append(of)
            if on:
                tels.append(mh_tel(res[2]))
        of = torch.stack(flags, 1)
        leg = {"rows": shares(state), "overflow": shares(of), "any_overflow": bool(of.any()),
               "dispatch_ms": walls}
        if on:
            leg["telemetry"] = tels
        out["serve"]["telemetry" if on else "plain"] = leg
        del state, flags
    del slabs

    # ---- fanout: one K3 launch a dispatch, nnz/chk over every process ---
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t, fe, fa, fb = fan
    dcap = 2
    parts = [mh_fanout_rank(seed, q, t // p_all, fe, fa, dcap, fb // p_all, device)
             for q in (range(pid * MH_LOCAL_RANKS, (pid + 1) * MH_LOCAL_RANKS) if cross
                       else range(p_all))]
    cat = lambda *xs: torch.cat([x.view(torch.int32) if x.dtype == torch.uint32 else x  # noqa: E731
                                 for x in xs]).view(xs[0].dtype)
    fstate = tree_map(cat, *[x[0] for x in parts])
    bases = tree_map(cat, *[x[1] for x in parts])
    fidx, weights = torch.cat([x[2] for x in parts]), torch.cat([x[3] for x in parts])
    del parts
    p_loc = mesh.local.p if cross else mesh.p
    barrier()
    wire_pack.launches = 0
    wire, pb = parallel.mesh_fanout_push(fstate, bases, fidx, mesh, weights=weights)
    sync(device)
    k3 = wire_pack.launches
    k3_err = fanout_vs_plain(wire, fanout_k3_args(fstate, bases, fidx, p_loc), sums=not cross)
    walls = {}
    for on in (False, True):
        barrier()
        walls[on] = []
        for _ in range(MH_FANOUT_DISPATCHES):
            t0 = time.perf_counter()
            res = parallel.mesh_fanout_push(fstate, bases, fidx, mesh, weights=weights,
                                            telemetry=on)
            sync(device)
            walls[on].append((time.perf_counter() - t0) * 1e3)
    out["fanout"] = {
        "lanes": t, "E": fe, "A": fa, "dispatch_lanes": fb, "k3": k3, "k3_max_abs_err": k3_err,
        "wire": {k: shares(getattr(wire, k)) for k in ("words", "keep", "defer", "valid")},
        "nnz": int(wire.nnz.view(torch.int32)) & 0xFFFFFFFF,
        "chk": int(wire.chk.view(torch.int32)) & 0xFFFFFFFF, "push_bytes": shares(pb),
        "telemetry": mh_tel(res[2]), "wall_ms": walls[False], "wall_ms_telemetry": walls[True]}
    del fstate, bases, wire, pb, res

    out["serve"]["dispatch_ms_p50_p99"] = {
        k: [st.median(v["dispatch_ms"]), float(np.percentile(v["dispatch_ms"], 99))]
        for k, v in out["serve"].items() if isinstance(v, dict) and "dispatch_ms" in v}
    return out


def mh_shares(tree, cross: bool, digest=None) -> list:
    """Every process's share of a result's leading axis as digests
    (``digest``, :func:`leaf_digests` by default): this process's rows as
    they are across processes, each of the ``MH_PROCESSES`` shares of a
    single-process result."""
    from crdt_tpu_torch.ops.lattice import tree_map

    digest = digest or leaf_digests
    if cross:
        return [digest(tree)]
    return [digest(tree_map(lambda x: x[q * x.shape[0] // MH_PROCESSES:
                                        (q + 1) * x.shape[0] // MH_PROCESSES], tree))
            for q in range(MH_PROCESSES)]


def device_sums(tree) -> list:
    """Two wrapping int64 sums of every leaf's bits on its own device —
    plain and weighted by a multiplicative hash of the position — with its
    dtype and shape: equal trees give equal lists, and a state of
    gigabytes is compared without a copy to the host."""
    import torch

    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.ops.lattice import tree_leaves

    out = []
    for x in tree_leaves(tree):
        flat = bits(x).reshape(-1)
        plain = weighted = 0
        for lo in range(0, flat.numel(), 1 << 26):  # 512 MiB of int64 a chunk
            v = flat[lo:lo + (1 << 26)].to(torch.int64)
            w = (torch.arange(lo, lo + v.numel(), device=v.device, dtype=torch.int64)
                 * 2654435761 + 1) % 2**31
            plain, weighted = plain + int(v.sum()), weighted + int((v * w).sum())
        out.append([str(x.dtype), list(x.shape), plain, weighted])
    return out


def mh_timed(fn, device, cross: bool):
    """``fn()``'s result and wall ms, the processes lined up first."""
    import torch.distributed as dist

    sync(device)
    if cross:
        dist.barrier()
    t0 = time.perf_counter()
    res = fn()
    sync(device)
    return res, (time.perf_counter() - t0) * 1e3


def mh_counter(name: str) -> int:
    from crdt_tpu_torch.utils.metrics import metrics

    return metrics.snapshot()["counters"].get(name, 0)


def mh_dense_options(dense, mesh, device, cross: bool) -> dict:
    """The dense fold and gossip on the phase's R rows with
    ``telemetry=True`` (K1 counted and every launch held against its plain
    version; then walls on and off, unchecked) and ``mesh_gossip(
    stability=True, lag_threshold=MH_STALL)``: its rows rank by rank, its
    frontier, the stalls it counted."""
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.ops import fold_kernels as fk
    from crdt_tpu_torch.ops.lattice import tree_map

    entries = (("fold", parallel.mesh_fold), ("gossip", parallel.mesh_gossip))
    tel = {}
    sync(device)
    fk.fold_entries.launches = 0
    with FoldChecked() as held:
        for name, entry in entries:
            tel[name] = {"telemetry": mh_tel(entry(dense, mesh, telemetry=True)[2])}
        sync(device)
    tel["k1"], tel["k1_checked"], tel["k1_max_abs_err"] = (fk.fold_entries.launches,
                                                           held.calls["k1"], held.max_abs_err["k1"])
    for name, entry in entries:
        tel[name]["wall_ms_off"] = mh_timed(lambda: entry(dense, mesh), device, cross)[1]
        tel[name]["wall_ms_on"] = mh_timed(lambda: entry(dense, mesh, telemetry=True), device,
                                           cross)[1]
    stalls = mh_counter("reclaim.frontier_stalled")
    res = parallel.mesh_gossip(dense, mesh, stability=True, lag_threshold=MH_STALL)
    gossip = {"rows": [leaf_digests(tree_map(lambda x: x[q], res[0]))
                       for q in range(res[0].top.shape[0])],
              "frontier": leaf_digests(res[2]),
              "stalls": mh_counter("reclaim.frontier_stalled") - stalls}
    return {"telemetry": tel, "gossip": gossip}


def mh_ring_telemetry(ring, inputs: tuple, mesh, rounds: int, cap: int, device,
                      cross: bool) -> dict:
    """The fused dense δ ring with ``telemetry=True`` at its certified
    budget, every K3 launch counted and held against the plain pack; then
    its wall, unchecked."""
    from crdt_tpu_torch.ops.wire_kernels import wire_pack

    st, dirty, fctx = inputs
    run = lambda: ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap, telemetry=True)  # noqa: E731
    sync(device)
    wire_pack.launches = 0
    with K3Checked() as k3c:
        res = run()
        sync(device)
    k3 = wire_pack.launches
    _, ms = mh_timed(run, device, cross)
    return {"telemetry": mh_tel(res[4]), "wall_ms_on": ms, "k3": k3,
            "k3_checked": k3c.calls, "k3_max_abs_err": k3c.max_abs_err,
            "residue": int(res[3]), "rounds": rounds}


def mh_reclaim_loop(loop: str, state, mesh, device, cross: bool, e: int, a: int,
                    tracking=None, rounds=None) -> dict:
    """One dense elastic loop with ``reclaim=Hysteresis(shrink_rounds=1)``
    over ``state`` born at 16 parked slots (its members and actors
    interned, so those axes stay): rows rank by rank, widened axes, the
    capacities after, the model's rows and the shrinks counted."""
    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.elastic import ElasticPolicy, Hysteresis, capacities
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.utils import Interner

    model = BatchedOrswot(1, e, a, 2, device=device)
    model.members, model.actors = Interner(range(e)), Interner(range(a))
    model.state = state
    model.widen_capacity(deferred_cap=16)
    reclaim = Hysteresis(ElasticPolicy(shrink_rounds=1))
    events = mh_counter("reclaim.shrink_events")
    if loop == "gossip_elastic":
        (rows, widened), ms = mh_timed(lambda: parallel.gossip_elastic(model, mesh,
                                                                       reclaim=reclaim),
                                       device, cross)
    else:
        got, ms = mh_timed(lambda: parallel.delta_gossip_elastic(
            model, *tracking, mesh, rounds=rounds, cap=MH_ELASTIC_CAP, reclaim=reclaim),
            device, cross)
        rows, widened = got[0], got[4]
    return {"rows": [leaf_digests(tree_map(lambda x: x[q], rows))
                     for q in range(rows.top.shape[0])],
            "widened": widened, "caps": capacities(model),
            "model": mh_shares(model.state, cross, device_sums),
            "shrink_events": mh_counter("reclaim.shrink_events") - events, "wall_ms": ms}


def mh_options(dispatch: dict, dense: dict, ring: dict, legs: dict) -> dict:
    """The option legs of one process (or the single-process run) in one
    dict: the dispatches, the sidecars and the reclamation legs."""
    return {**dispatch,
            "telemetry": {**dense["telemetry"], "ring": ring.pop("telemetry"),
                          "stream": legs["flagship"].pop("telemetry")},
            "reclaim": {"gossip": dense["gossip"], **legs.pop("reclaim")}}


def mh_check_options(pid: int, got: dict, want: dict, ranks: slice, on_card: bool) -> None:
    """Worker ``pid``'s serving dispatches, sidecars and reclamation
    options against the single-process ones (``ranks``: its global ranks)."""
    for on in ("plain", "telemetry"):
        g, w = got["serve"][on], want["serve"][on]
        check(g["rows"] == w["rows"][pid:pid + 1] and g["overflow"] == w["overflow"][pid:pid + 1],
              f"worker {pid}: the cross-process serve dispatches ({on}) != the single-process rows")
    check(got["serve"]["telemetry"]["telemetry"] == want["serve"]["telemetry"]["telemetry"],
          f"worker {pid}: a serve dispatch's sidecar != the single-process sidecar")
    gf, wf = got["fanout"], want["fanout"]
    check(all(gf["wire"][k] == wf["wire"][k][pid:pid + 1] for k in gf["wire"])
          and gf["push_bytes"] == wf["push_bytes"][pid:pid + 1]
          and (gf["nnz"], gf["chk"]) == (wf["nnz"], wf["chk"])
          and gf["telemetry"] == wf["telemetry"],
          f"worker {pid}: the cross-process fan-out dispatch != the single-process dispatch")
    check(gf["k3_max_abs_err"] == 0, f"worker {pid}: the fan-out K3 launch != its plain version")
    for name in ("fold", "gossip", "ring", "stream"):
        check(got["telemetry"][name]["telemetry"] == want["telemetry"][name]["telemetry"],
              f"worker {pid}: the cross-process {name}'s sidecar != the single-process sidecar")
    tg = got["telemetry"]
    check(tg["k1_max_abs_err"] == tg["ring"]["k3_max_abs_err"] == 0
          and tg["ring"]["residue"] == 0,
          f"worker {pid}: a K1/K3 launch of the telemetry legs != its plain version")
    rg, rw = got["reclaim"], want["reclaim"]
    check(rg["gossip"]["rows"] == rw["gossip"]["rows"][ranks]
          and rg["gossip"]["frontier"] == rw["gossip"]["frontier"]
          and rg["gossip"]["stalls"] == rw["gossip"]["stalls"] == 1,
          f"worker {pid}: the cross-process stability gossip (rows, frontier, stalls "
          f"{rg['gossip']['stalls']}) != the single-process gossip")
    for loop in ("gossip_elastic", "delta_gossip_elastic"):
        g, w = rg[loop], rw[loop]
        check(g["rows"] == w["rows"][ranks] and g["widened"] == w["widened"]
              and g["caps"] == w["caps"] and g["model"] == w["model"][pid:pid + 1]
              and g["shrink_events"] == w["shrink_events"],
              f"worker {pid}: the cross-process {loop}(reclaim=) (caps {g['caps']}, shrinks "
              f"{g['shrink_events']}) != the single-process loop (caps {w['caps']}, shrinks "
              f"{w['shrink_events']})")
    if on_card:
        launches = {"fanout k3": (gf["k3"], 1),
                    "telemetry k1": (tg["k1"], 2 * MH_LOCAL_RANKS),
                    "telemetry k1 checked": (tg["k1_checked"], 2 * MH_LOCAL_RANKS),
                    "ring k3": (tg["ring"]["k3"], tg["ring"]["rounds"]),
                    "ring k3 checked": (tg["ring"]["k3_checked"], tg["ring"]["rounds"])}
        check(all(x == y for x, y in launches.values()),
              f"worker {pid}: launches (counted, expected) {launches}")


def mh_options_report(single: dict, cross: list) -> dict:
    """The option legs' figures: serve dispatch p50/p99 and fan-out push
    walls across against single, each sidecar's wall on against off, the
    shrinks, and the launches per process."""
    import statistics as st

    s = single["serve"]["dispatch_ms_p50_p99"]
    out = {"serve": {"single_process_p50_p99_ms": s,
                     "workers_p50_p99_ms": [x["serve"]["dispatch_ms_p50_p99"] for x in cross],
                     "any_overflow": single["serve"]["plain"]["any_overflow"],
                     "lanes": single["serve"]["lanes"], "slab": single["serve"]["slab"],
                     "dispatches": single["serve"]["dispatches"]}}
    f = single["fanout"]
    out["fanout"] = {"single_process_wall_ms": f["wall_ms"],
                     "single_process_wall_ms_telemetry": f["wall_ms_telemetry"],
                     "workers_wall_ms": [x["fanout"]["wall_ms"] for x in cross],
                     "workers_wall_ms_telemetry": [x["fanout"]["wall_ms_telemetry"] for x in cross],
                     "cross_over_single": max(st.median(x["fanout"]["wall_ms"]) for x in cross)
                     / st.median(f["wall_ms"]), "nnz": f["nnz"],
                     "k3_per_dispatch": [x["fanout"]["k3"] for x in cross]}
    out["telemetry"] = {
        name: {"single_process_ms_off_on": [single["telemetry"][name]["wall_ms_off"],
                                            single["telemetry"][name]["wall_ms_on"]],
               "workers_ms_off_on": [[x["telemetry"][name]["wall_ms_off"],
                                      x["telemetry"][name]["wall_ms_on"]] for x in cross]}
        for name in ("fold", "gossip", "ring", "stream")}
    out["telemetry"]["bytes_exchanged"] = {
        name: single["telemetry"][name]["telemetry"]["bytes_exchanged"]
        for name in ("fold", "gossip", "ring", "stream")}
    out["reclaim"] = {loop: {"caps": single["reclaim"][loop]["caps"],
                             "shrink_events": single["reclaim"][loop]["shrink_events"],
                             "single_process_wall_ms": single["reclaim"][loop]["wall_ms"],
                             "workers_wall_ms": [x["reclaim"][loop]["wall_ms"] for x in cross]}
                      for loop in ("gossip_elastic", "delta_gossip_elastic")}
    out["launches_per_process"] = [
        {"fanout_k3": x["fanout"]["k3"], "telemetry_k1": x["telemetry"]["k1"],
         "ring_k3": x["telemetry"]["ring"]["k3"]} for x in cross]
    return out


# ``faults=`` across processes (ROADMAP item 32, fourth part): the plans
# name global ranks of the phase's 2 × 4 mesh.
MH_FAULTS = dict(seed=17, corrupt=0.6, drop=0.2, evicted=(5,))  # bench.py's chaos plan at P = 8
# Both ranks at the process edge out (the hop 2 → 5 crosses), delay, no
# corruption: the probe ring must reject nothing.
MH_EDGE_FAULTS = dict(seed=17, drop=0.1, delay=0.3, evicted=(3, 4))
# The flagship stream's upload wire: block 4 drops, block 9 is rejected.
MH_STREAM_FAULTS = dict(seed=2, drop=0.05, corrupt=0.05)
MH_FAULT_RINGS = ("dense", "map")


def mh_counters(fc) -> dict:
    """``FaultCounters`` as integers (the streak a list, one a rank)."""
    from crdt_tpu_torch._dtypes import to_wide

    return {"dropped": int(to_wide(fc.packets_dropped)),
            "rejected": int(to_wide(fc.packets_rejected)),
            "delayed": int(to_wide(fc.packets_delayed)), "miss_streak": fc.miss_streak.tolist()}


def mh_fault_digest(out) -> dict:
    """A faulted δ ring's or gossip's result: the ring digest (rank by
    rank) or the gossip's rows, flags and frontier, and its
    ``FaultCounters`` (the last output) as integers."""
    import torch

    counters = mh_counters(out[-1])
    if len(out) == 5:  # a ring: rows, dirty, flags, residue, counters
        return {**mh_ring_digest(out[:4]), "counters": counters}
    from crdt_tpu_torch.ops.lattice import tree_leaves, tree_map

    rows = out[0]
    n = tree_leaves(rows)[0].shape[0]
    return {"rows": [leaf_digests(tree_map(lambda x: x[q], rows)) for q in range(n)],
            "overflow": torch.atleast_1d(out[1]).tolist(), "frontier": leaf_digests(out[2]),
            "counters": counters}


def mh_fault_ring(kind: str, inputs: tuple, rounds: int, mesh, device, cross: bool) -> dict:
    """One δ ring of the phase under ``MH_FAULTS`` at its certified budget,
    fused, on this process's rows (or the single-process P = 8 ring): K3
    and the local fold's kernel counted from 0 and every launch held
    against its plain version; the dense ring layered too and a fused
    probe under ``MH_EDGE_FAULTS`` (its K3 launches counted and held);
    then the fused
    ring's wall and, across processes, its exchange ms and bytes a round."""
    import torch.distributed as dist

    from crdt_tpu_torch import parallel
    from crdt_tpu_torch.faults import FaultPlan
    from crdt_tpu_torch.ops.wire_kernels import wire_pack

    name, cap = MH_RINGS[kind]
    ring = getattr(parallel, name)
    st, dirty, fctx = inputs
    leaf = mh_leaf_counter(kind)

    def run(plan=MH_FAULTS, **kw):
        return ring(st, dirty, fctx, mesh, rounds=rounds, cap=cap, faults=FaultPlan(**plan), **kw)

    sync(device)
    wire_pack.launches = leaf.launches = 0
    with FoldChecked() as held, K3Checked() as k3c:
        fused = mh_fault_digest(run())
        sync(device)
    out = {"fused": fused, "rounds": rounds, "k3": wire_pack.launches, "k3_checked": k3c.calls,
           "k3_max_abs_err": k3c.max_abs_err, "leaf": mh_leaf_counter(kind).launches,
           "leaf_max_abs_err": max(held.max_abs_err.values())}
    if kind == "dense":
        out["layered"] = mh_fault_digest(run(fused=False))
        wire_pack.launches = 0
        with K3Checked() as edge_k3c:
            out["edge"] = mh_fault_digest(run(MH_EDGE_FAULTS))
            sync(device)
        out.update(edge_k3=wire_pack.launches, edge_k3_checked=edge_k3c.calls,
                   edge_k3_max_abs_err=edge_k3c.max_abs_err)
    sync(device)
    if cross:
        dist.barrier()
    x0, t0 = mh_exchange(), time.perf_counter()
    run()
    sync(device)
    x1 = mh_exchange()
    out.update(wall_ms=(time.perf_counter() - t0) * 1e3,
               exchange_ms_per_round=(x1[0] - x0[0]) * 1e3 / rounds,
               exchange_bytes_per_round=(x1[1] - x0[1]) / rounds)
    return out


def mh_fault_gossip(entry, state, mesh, device, cross: bool) -> dict:
    """A gossip entry (``mesh_gossip`` / ``mesh_gossip_map``) with
    ``stability=True`` under ``MH_FAULTS``: the local folds' kernel (K1 or
    K2) counted from 0 and held against its plain version; rows rank by
    rank, flags, frontier and counters; its wall."""
    from crdt_tpu_torch.faults import FaultPlan
    from crdt_tpu_torch.ops import fold_kernels as fk

    run = lambda: entry(state, mesh, stability=True, faults=FaultPlan(**MH_FAULTS))  # noqa: E731
    sync(device)
    fk.fold_entries.launches = fk.fold_cells.launches = 0
    with FoldChecked() as held:
        out = mh_fault_digest(run())
        sync(device)
    out.update(k1=fk.fold_entries.launches, k2=fk.fold_cells.launches,
               max_abs_err=max(held.max_abs_err.values()),
               wall_ms=mh_timed(run, device, cross)[1])
    return out


def mh_check_faults(pid: int, got: dict, want: dict, ranks: slice, on_card: bool) -> None:
    """Worker ``pid``'s faulted legs against the single-process ones on P =
    8 under the same plans (``ranks``: its global ranks): rows and dirty
    rows of its ranks, flags, residue, the counters (the global streak)
    and frontiers; the streams' accumulators and reports; the elastic
    loops; K3 once a fused round (the edge probe's too) and twice the
    budget in the faulted δ loop, every launch == plain; no reject under
    a plan without corruption."""
    def same(g, w, rows=True):
        w = dict(w)
        if rows:
            w["rows"] = w["rows"][ranks]
            if "dirty" in w:
                w["dirty"] = w["dirty"][ranks]
        return g == w

    for kind in MH_FAULT_RINGS:
        g, w = got[kind], want[kind]
        for mode in ("fused", "layered", "edge"):
            if mode in w:
                check(same(g[mode], w[mode]),
                      f"worker {pid}: the faulted {kind} ring ({mode}) != the single-process "
                      f"ring: {g[mode]['counters']} vs {w[mode]['counters']}")
        check(g["k3_max_abs_err"] == g["leaf_max_abs_err"] == g.get("edge_k3_max_abs_err", 0)
              == 0,
              f"worker {pid}: a K3/K1/K2 launch of the faulted {kind} ring != its plain version")
        check(g["fused"]["residue"] >= 1 and g["fused"]["counters"]["rejected"] > 0,
              f"worker {pid}: the faulted {kind} ring lost nothing: {g['fused']}")
        if "edge" in g:
            check(g["edge"]["counters"]["rejected"] == 0,
                  f"worker {pid}: a plan without corruption rejected {g['edge']['counters']}")
        if on_card:
            launches = {"k3": (g["k3"], g["rounds"]), "checked": (g["k3_checked"], g["rounds"]),
                        "leaf": (g["leaf"], MH_LOCAL_RANKS)}
            if "edge_k3" in g:
                launches["edge k3"] = (g["edge_k3"], g["rounds"])
                launches["edge checked"] = (g["edge_k3_checked"], g["rounds"])
            check(all(x == y for x, y in launches.values()),
                  f"worker {pid}: the faulted {kind} ring's launches (counted, expected) "
                  f"{launches}")
    for name in ("gossip", "map_gossip"):
        g, w = got[name], want[name]
        check(all(g[k] == (w[k][ranks] if k == "rows" else w[k])
                  for k in ("rows", "overflow", "frontier", "counters"))
              and g["max_abs_err"] == 0,
              f"worker {pid}: the faulted {name} != the single-process gossip")
        if on_card:
            check((g["k1"], g["k2"]) == ((MH_LOCAL_RANKS, 0) if name == "gossip"
                                         else (0, MH_LOCAL_RANKS)),
                  f"worker {pid}: the faulted {name}'s local folds launched K1 {g['k1']}, K2 "
                  f"{g['k2']} times")
    g, w = got["stream"], want["stream"]
    check(all(g[k] == w[k] for k in ("digest", "overflow", "report", "healed")),
          f"worker {pid}: the faulted flagship stream (report {g['report']}) != the "
          f"single-process stream (report {w['report']})")
    for loop in ("gossip_elastic", "delta_gossip_elastic"):
        g, w = got[loop], want[loop]
        check(g["widened"] == w["widened"] and g["counters"] == w["counters"]
              and g["rows"] == w["rows"][ranks] and g.get("dirty") == (
                  w["dirty"][ranks] if "dirty" in w else None)
              and g["max_abs_err"] == 0,
              f"worker {pid}: the faulted {loop} != the single-process loop")
    g = got["delta_gossip_elastic"]
    check(not on_card or g["k3"] == g["k3_checked"] == 2 * g["rounds"],
          f"worker {pid}: the faulted delta_gossip_elastic launched K3 {g['k3']} times "
          f"({g['k3_checked']} checked), expected {2 * g['rounds']} (two attempts)")


def mh_faults_report(single: dict, cross: list, rings: dict, rings_cross: list) -> dict:
    """The faulted legs' figures: each faulted ring's wall across (the
    slower process) against the single-process faulted wall and the
    unfaulted wall across, its exchange ms and bytes a round; the
    gossips', stream's and loops' walls; the counters; the launches per
    process."""
    out = {"plans": {"chaos": MH_FAULTS, "edge": MH_EDGE_FAULTS, "stream": MH_STREAM_FAULTS}}
    for kind in MH_FAULT_RINGS:
        s = single[kind]
        across = max(x[kind]["wall_ms"] for x in cross)
        clean = max(min(r[kind]["wall_ms"]) for r in rings_cross)
        out[kind] = {"rounds": s["rounds"], "single_process_wall_ms": s["wall_ms"],
                     "workers_wall_ms": [x[kind]["wall_ms"] for x in cross],
                     "unfaulted_workers_wall_ms": [r[kind]["wall_ms"] for r in rings_cross],
                     "unfaulted_single_process_wall_ms": rings[kind]["wall_ms"],
                     "across_over_single": across / s["wall_ms"],
                     "across_over_unfaulted_across": across / clean,
                     "exchange_ms_per_round": [x[kind]["exchange_ms_per_round"] for x in cross],
                     "exchange_bytes_per_round": [x[kind]["exchange_bytes_per_round"]
                                                  for x in cross],
                     "counters": s["fused"]["counters"], "residue": s["fused"]["residue"]}
        if "edge" in s:
            out[kind]["edge_counters"] = s["edge"]["counters"]
    for name in ("gossip", "map_gossip", "stream", "gossip_elastic", "delta_gossip_elastic"):
        out[name] = {"single_process_wall_ms": single[name]["wall_ms"],
                     "workers_wall_ms": [x[name]["wall_ms"] for x in cross]}
    out["stream"].update(report=single["stream"]["report"], blocks=MH_SHARDED_BLOCKS)
    out["launches_per_process"] = [
        {"dense_k3": x["dense"]["k3"], "dense_edge_k3": x["dense"]["edge_k3"],
         "dense_k1": x["dense"]["leaf"], "map_k3": x["map"]["k3"], "map_k2": x["map"]["leaf"],
         "gossip_k1": x["gossip"]["k1"], "map_gossip_k2": x["map_gossip"]["k2"],
         "delta_gossip_elastic_k3": x["delta_gossip_elastic"]["k3"]} for x in cross]
    out["reduced"] = {"stream": f"{MH_SHARDED_BLOCKS} of the flagship's 40 blocks (the sharded "
                                f"leg's cut)",
                      "rings_and_loops": "the phase's cuts (dense R = 2,048; Map R = 8, K "
                                         f"{MH_DELTA_MAP_K:,})"}
    return out


def multihost_worker(spec: str, seed: int) -> int:
    """One process of the ``multihost`` phase: ``spec`` is
    ``port,process,n_processes,device,root,r,e,a,d,map_r,k,s,map_a``. It
    joins the group at 127.0.0.1:port, draws its own rows, and runs the
    cross-process ``mesh_fold``, ``mesh_gossip``, ``mesh_fold_map`` and
    ``mesh_fold_sparse_mvmap`` on ``global_mesh(local_ranks=4)`` (every K1
    and K2 launch held against its plain version, the counts reset just
    before and read just after), the list rounds and the tenant handoff;
    then times the dense fold; then runs the four δ rings on its rows of
    their batches at the budgets of ``root/rounds.json``
    (:func:`mh_cross_ring`), every other fold and gossip kind
    (:func:`mh_small_kinds`), and the streams, sharded folds and elastic
    loops (:func:`mh_stream_legs`), and the serving dispatches, the
    sidecar and the reclamation options (:func:`mh_options`). Writes
    ``root/worker<process>.json``."""
    import torch
    import torch.distributed as dist

    from crdt_tpu_torch._dtypes import bits
    from crdt_tpu_torch.ops import fold_kernels as fk
    from crdt_tpu_torch.ops.fold_kernels import fold_auto
    from crdt_tpu_torch.ops.lattice import tree_map
    from crdt_tpu_torch.parallel import (
        mesh_fold, mesh_fold_map, mesh_fold_sparse_mvmap, mesh_gossip, mesh_gossip_map, multihost,
    )
    from crdt_tpu_torch.parallel.anti_entropy import local_folds, rank_blocks

    port, pid, n, dev, root, r, e, a, d, map_r, k, s, map_a, *flagship = spec.split(",")
    pid, n, r, e, a, d, map_r, k, s, map_a = map(int, (pid, n, r, e, a, d, map_r, k, s, map_a))
    flagship = tuple(map(int, flagship))
    device = torch.device(dev)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize(f"127.0.0.1:{port}", num_processes=n, process_id=pid)
    try:
        mesh = multihost.global_mesh(local_ranks=MH_LOCAL_RANKS, device=device)
        lo, hi = pid * r // n, (pid + 1) * r // n
        dense = mh_dense_rows(seed, lo, hi, r, e, a, d, device)
        map_rows = range(pid * map_r // n, (pid + 1) * map_r // n)
        mstate = mh_map_rows(seed, map_rows, map_r, k, s, map_a, 4, device)
        sstate = mh_sparse_rows(range(pid * 8 // n, (pid + 1) * 8 // n), device)
        sync(device)
        fk.fold_entries.launches = fk.fold_cells.launches = 0
        with FoldChecked() as held:
            joined, of = mesh_fold(dense, mesh)
            rows, g_of = mesh_gossip(dense, mesh)
            mjoined, m_of = mesh_fold_map(mstate, mesh)
            sjoined, s_of = mesh_fold_sparse_mvmap(sstate, mesh, sibling_cap=4)
            sync(device)
        out = {"k1": fk.fold_entries.launches, "k2": fk.fold_cells.launches,
               "checked": held.calls, "max_abs_err": held.max_abs_err,
               "overflow": [bool(torch.any(f)) for f in (of, g_of, m_of, s_of)],
               "fold": leaf_digests(joined),
               "gossip": [leaf_digests(tuple(x[q] for x in rows)) for q in range(rows.top.shape[0])],
               "map": leaf_digests(mjoined), "sparse": leaf_digests(sjoined),
               "list": mh_list_rounds(pid, device), "handoff": mh_handoff(pid, device)}
        faults = {"map_gossip": mh_fault_gossip(mesh_gossip_map, mstate, mesh, device, True)}
        del rows, mjoined, mstate, sjoined, sstate
        # The figures: the dense fold end to end, its exchange, and this
        # process's local folds alone (both processes share the card).
        walls, exchange = [], []
        for _ in range(3):
            sync(device)
            dist.barrier()
            x0, t0 = mh_exchange(), time.perf_counter()
            mesh_fold(dense, mesh)
            sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
            x1 = mh_exchange()
            exchange.append(((x1[0] - x0[0]) * 1e3, x1[1] - x0[1]))
        blocks = rank_blocks(dense, mesh.local)
        local = [time_ms(lambda: local_folds(blocks, fold_auto), device) for _ in range(3)]
        out.update(rows=hi - lo, wall_ms=walls, exchange_ms=[x for x, _ in exchange],
                   exchange_bytes=[b for _, b in exchange], local_fold_ms=local)
        del blocks
        dense_options = mh_dense_options(dense, mesh, device, True)
        faults["gossip"] = mh_fault_gossip(mesh_gossip, dense, mesh, device, True)
        del dense
        # The δ rings across processes at the single-process ring's budget,
        # then every other fold and gossip kind at the tests' sizes.
        with open(os.path.join(root, "rounds.json")) as f:
            rounds = json.load(f)
        out["rings"] = {}
        for kind in MH_RINGS:
            if device.type == "cuda":
                torch.cuda.empty_cache()
            batch = mh_ring_inputs(kind, seed, device, r, e, a, d, k, s, map_a)
            mine = slice(pid * batch[1].shape[0] // n, (pid + 1) * batch[1].shape[0] // n)
            inputs = tuple(tree_map(lambda x: bits(x[mine]).clone().view(x.dtype), t)
                           for t in batch)
            del batch
            out["rings"][kind] = mh_cross_ring(kind, inputs, rounds[kind], mesh, device,
                                               MH_RING_SAMPLES[kind])
            if kind in MH_FAULT_RINGS:
                faults[kind] = mh_fault_ring(kind, inputs, rounds[kind], mesh, device, True)
            del inputs
        out["small"] = mh_small_digests(mh_small_kinds(seed, device), mesh,
                                        slice(pid * MH_SMALL_R // n, (pid + 1) * MH_SMALL_R // n))
        # The streams, the element-sharded folds and the elastic loops.
        if device.type == "cuda":
            torch.cuda.empty_cache()
        smesh = multihost.global_mesh(n_element_shards=2, local_ranks=MH_LOCAL_RANKS,
                                      device=device)
        out["legs"] = mh_stream_legs(seed, device, mesh, smesh, r, e, a, d, k, s, map_a,
                                     flagship, pid=pid, n=n,
                                     delta_rounds=rounds["elastic_delta"],
                                     parking=rounds["elastic_parking"])
        out["faults"] = {**faults, **out["legs"].pop("faults")}
        # The serving dispatches, then every option leg in one dict.
        out["options"] = mh_options(
            mh_dispatch_legs(seed, device, mesh, pid=pid, n=n,
                             serve=tuple(rounds["options"]["serve"]),
                             fan=tuple(rounds["options"]["fanout"])),
            dense_options, out["rings"]["dense"], out["legs"])
        with open(os.path.join(root, f"worker{pid}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_multihost(device, seed: int, r: int = 2048, e: int = 102400, a: int = 8, d: int = 4,
                    map_r: int = 8, k: int = 1_000_000, s: int = 2, map_a: int = 4,
                    flagship=MH_FLAGSHIP, serve=MH_SERVE, fan=MH_FANOUT) -> dict:
    """ROADMAP 5a on one card (module docstring, phase 42): the
    single-process folds of the whole batches on P = 8 virtual ranks
    first (the dense one timed), then two worker processes of this script
    (:func:`multihost_worker`), each on 4 local ranks of the same card,
    exchanging host copies over gloo; then the δ rings and every other
    fold and gossip kind across them (module docstring, phase 42). Every
    cross-process result must equal the single-process one leaf for
    leaf."""
    import socket
    import statistics as st
    import tempfile

    import torch

    from crdt_tpu_torch.parallel import (
        VirtualMesh, mesh_fold, mesh_fold_map, mesh_fold_sparse_mvmap, mesh_gossip, mesh_gossip_map,
    )

    t_phase = time.perf_counter()
    out = {"phase": "multihost", "nvidia_smi": card_label(device), "processes": MH_PROCESSES,
           "local_ranks": MH_LOCAL_RANKS, "R": r, "E": e, "A": a, "map_R": map_r, "K": k,
           "delta_map_K": min(k, MH_DELTA_MAP_K)}
    if device.type == "cuda":
        mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
        out["compute_mode"] = mode
        check("exclusive" not in mode.lower(),
              f"compute mode {mode!r}: the card refuses a second process's context, and the "
              f"phase needs two")
    mesh = VirtualMesh(MH_PROCESSES * MH_LOCAL_RANKS, device)
    dense = mh_dense_rows(seed, 0, r, r, e, a, d, device)
    want, of = mesh_fold(dense, mesh)
    check(not bool(of), "the single-process dense fold overflowed")
    walls = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        mesh_fold(dense, mesh)
        sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    ref = {"fold": leaf_digests(want)}
    dense_options = mh_dense_options(dense, mesh, device, False)
    faults = {"gossip": mh_fault_gossip(mesh_gossip, dense, mesh, device, False)}
    del dense, want
    mstate = mh_map_rows(seed, range(map_r), map_r, k, s, map_a, 4, device)
    mwant, m_of = mesh_fold_map(mstate, mesh)
    faults["map_gossip"] = mh_fault_gossip(mesh_gossip_map, mstate, mesh, device, False)
    del mstate
    swant, s_of = mesh_fold_sparse_mvmap(mh_sparse_rows(range(8), device), mesh, sibling_cap=4)
    check(not bool(torch.any(m_of)) and not bool(torch.any(s_of)),
          "a single-process Map fold overflowed")
    ref.update(map=leaf_digests(mwant), sparse=leaf_digests(swant))
    lists = mh_list_reference(device)
    del mwant, swant
    # The δ rings on P = 8 virtual ranks (their budgets go to the
    # workers), then the other kinds at the tests' sizes.
    rings = {}
    for kind in MH_RINGS:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        inputs = mh_ring_inputs(kind, seed, device, r, e, a, d, k, s, map_a)
        rings[kind] = mh_single_ring(kind, inputs, device, MH_RING_SAMPLES[kind])
        if kind in MH_FAULT_RINGS:
            faults[kind] = mh_fault_ring(kind, inputs, rings[kind]["rounds"], mesh, device, False)
        del inputs
    small = mh_small_digests(mh_small_kinds(seed, device), mesh)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    legs = mh_stream_legs(seed, device, mesh, VirtualMesh(MH_PROCESSES * MH_LOCAL_RANKS // 2,
                                                          device, s=2), r, e, a, d, k, s, map_a,
                          flagship)
    faults.update(legs.pop("faults"))
    options = mh_options(mh_dispatch_legs(seed, device, mesh, serve=serve, fan=fan),
                         dense_options, rings["dense"], legs)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the workers need the card's memory

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    root = tempfile.mkdtemp(prefix="chip-smoke-multihost-")
    with open(os.path.join(root, "rounds.json"), "w") as f:
        json.dump({**{kind: ring["rounds"] for kind, ring in rings.items()},
                   "elastic_delta": legs["delta_gossip_elastic"]["rounds"],
                   "elastic_parking": legs["gossip_elastic"]["parking"],
                   "options": {"serve": list(serve), "fanout": list(fan)}}, f)
    spec = lambda pid: ",".join(map(str, (port, pid, MH_PROCESSES, device, root, r, e, a,  # noqa: E731
                                           d, map_r, k, s, map_a, *flagship)))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multihost-worker",
                               spec(pid), "--seed", str(seed)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(MH_PROCESSES)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, MH_TIMEOUT - (time.perf_counter() - t0)))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"multihost workers outlived {MH_TIMEOUT} s")
    out["workers_wall_s"] = time.perf_counter() - t0
    for pid, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"multihost worker {pid} exited {p.returncode}:\n{log[-4000:]}")
    workers = []
    for pid in range(MH_PROCESSES):
        with open(os.path.join(root, f"worker{pid}.json")) as f:
            workers.append(json.load(f))

    on_card = device.type == "cuda"
    for pid, w in enumerate(workers):
        check(not any(w["overflow"]), f"worker {pid}: a cross-process fold overflowed")
        check(w["fold"] == ref["fold"], f"worker {pid}: the cross-process fold != the "
              f"single-process mesh_fold")
        check(all(g == ref["fold"] for g in w["gossip"]) and len(w["gossip"]) == MH_LOCAL_RANKS,
              f"worker {pid}: a gossip row != the single-process mesh_fold")
        check(w["map"] == ref["map"], f"worker {pid}: the cross-process Map fold != mesh_fold_map")
        check(w["sparse"] == ref["sparse"],
              f"worker {pid}: the sparse Map fold != mesh_fold_sparse_mvmap")
        check([tuple(x) for x in w["list"]] == [tuple(x) for x in lists[pid]],
              f"worker {pid}: list rounds {w['list']} != {lists[pid]}")
        t = w["handoff"]["tenant"]
        check(w["handoff"]["shipped"] == w["handoff"]["joined"] == 1
              and sorted(w["handoff"]["members"]) == sorted({t % 8, 7 - t % 8}),
              f"worker {pid}: the handoff {w['handoff']}")
        if on_card:
            check(w["k1"] == 2 * MH_LOCAL_RANKS and w["k2"] == MH_LOCAL_RANKS
                  and w["checked"] == {"k1": w["k1"], "k2": w["k2"]},
                  f"worker {pid}: K1 {w['k1']}, K2 {w['k2']} launches, {w['checked']} checked")
        check(max(w["max_abs_err"].values()) == 0,
              f"worker {pid}: a K1/K2 launch != its plain version: {w['max_abs_err']}")
    check(lists[0][-1][0] == lists[1][-1][0], "the two list models read differently")
    for pid, w in enumerate(workers):
        ranks = slice(pid * MH_LOCAL_RANKS, (pid + 1) * MH_LOCAL_RANKS)
        for kind, x in w["rings"].items():
            ref, dig = rings[kind], x["digest"]
            rounds = ref["rounds"]
            check(dig["rows"] == ref["digest"]["rows"][ranks]
                  and dig["dirty"] == ref["digest"]["dirty"][ranks]
                  and dig["overflow"] == ref["digest"]["overflow"]
                  and dig["residue"] == ref["digest"]["residue"] == 0,
                  f"worker {pid}: the cross-process {kind} ring != the single-process ring")
            check(x["stats"] == ref["stats"],
                  f"worker {pid}: {kind} ring stats {x['stats']} != {ref['stats']}")
            check(x["equals_fold"] and x["layered_same"] and x["checked_same"]
                  and x.get("acked_same", True),
                  f"worker {pid}: the {kind} ring's fused, layered, acked rows and the mesh fold "
                  f"disagree: {x}")
            check(x["k3_max_abs_err"] == 0,
                  f"worker {pid}: a {kind} ring launch of K3 != the plain pack "
                  f"({x['k3_max_abs_err']})")
            if on_card:
                check(x["k3_launches"] == x["k3_checked"] == rounds
                      and x["leaf_launches"] == MH_LOCAL_RANKS
                      and x.get("acked_launches", [rounds, rounds]) == [rounds, rounds],
                      f"worker {pid}: the {kind} ring launched K3 {x['k3_launches']} times "
                      f"({x['k3_checked']} checked, acked {x.get('acked_launches')}) in {rounds} "
                      f"rounds and its local fold's kernel {x['leaf_launches']} times")
        for name, got in w["small"].items():
            want = small[name]
            if "rows" in want:
                want = {"rows": want["rows"][ranks], "flags": want["flags"]}
            check(got == want, f"worker {pid}: the cross-process {name} != the single-process "
                               f"entry")
        mh_check_legs(pid, w["legs"], legs, ranks, on_card)
        mh_check_options(pid, w["options"], options, ranks, on_card)
        mh_check_faults(pid, w["faults"], faults, ranks, on_card)
    med = st.median
    out.update(
        single_process_fold_ms=walls, single_process_fold_ms_median=med(walls),
        workers=[{"process": pid, "rows": w["rows"], "k1_launches": w["k1"],
                  "k2_launches": w["k2"], "fold_wall_ms": w["wall_ms"],
                  "fold_wall_ms_median": med(w["wall_ms"]), "exchange_ms": w["exchange_ms"],
                  "exchange_bytes": w["exchange_bytes"], "local_fold_ms": w["local_fold_ms"],
                  "list": w["list"], "handoff": w["handoff"]} for pid, w in enumerate(workers)],
        cross_over_single=(max(med(w["wall_ms"]) for w in workers) / med(walls)),
        k1_max_abs_err=max(max(w["max_abs_err"]["k1"], w["legs"]["dense_stream"]["max_abs_err"],
                               w["legs"]["gossip_elastic"]["max_abs_err"],
                               w["legs"]["delta_gossip_elastic"]["k1_max_abs_err"],
                               w["options"]["telemetry"]["k1_max_abs_err"])
                           for w in workers),
        k2_max_abs_err=max(max(w["max_abs_err"]["k2"],
                               w["legs"]["map_gossip_elastic"]["max_abs_err"]) for w in workers),
        k3_max_abs_err=max(max(max(x["k3_max_abs_err"] for x in w["rings"].values()),
                               w["legs"]["delta_gossip_elastic"]["k3_max_abs_err"],
                               w["options"]["fanout"]["k3_max_abs_err"],
                               w["options"]["telemetry"]["ring"]["k3_max_abs_err"])
                           for w in workers),
        legs=mh_legs_report(legs, [w["legs"] for w in workers]),
        options=mh_options_report(options, [w["options"] for w in workers]),
        faults=mh_faults_report(faults, [w["faults"] for w in workers], rings,
                                [w["rings"] for w in workers]),
        rings={kind: mh_ring_report(kind, ring, [w["rings"][kind] for w in workers])
               for kind, ring in rings.items()},
        small_kinds=sorted(small),
        phase_s=time.perf_counter() - t_phase,
    )
    emit(out)
    return out


PHASES = ("k1", "scenarios", "full_width", "k2", "map_scenarios", "full_width_map", "k3",
          "delta_scenarios", "full_width_delta", "map_delta_scenarios", "full_width_delta_map",
          "sparse_scenarios", "flagship", "elastic", "resync", "donate", "durability",
          "serve_scenarios", "serve", "serve_zipf", "fanout_scenarios", "fanout",
          "telemetry_scenarios", "sparse_map_scenarios", "full_width_sparse_map",
          "nested_scenarios", "full_width_nested", "full_width_delta_nested",
          "kinds_scenarios", "full_width_clocks", "full_width_list", "reclaim_scenarios",
          "full_width_reclaim", "faults_scenarios", "full_width_chaos", "obs_scenarios",
          "full_width_scaleout", "full_width_geo", "laws_scenarios", "static_scenarios",
          "multihost")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--multihost-worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run (a partial run prints no kernels "
                         f"line and no ok line); phases: {', '.join(PHASES)}")
    args = ap.parse_args(argv)
    only = [x for x in args.only.split(",") if x]
    bad = sorted(set(only) - set(PHASES))
    if bad:
        ap.error(f"unknown phases {bad}")

    import torch

    if args.multihost_worker:  # one process of the multihost phase (its rehearsal: the CPU)
        sys.path.insert(0, HERE)
        return multihost_worker(args.multihost_worker, args.seed)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from crdt_tpu_torch.ops.fold_kernels import fold_entries

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dev = phase_device(device)
    run = lambda name: not only or name in only  # noqa: E731
    res = {}
    if run("k1"):
        res["k1"] = phase_k1_shapes(device, args.seed)
    if run("scenarios"):
        phase_scenarios(device, args.seed)
    if run("full_width"):
        res["full"] = phase_full_width(device, args.seed)
        check(fold_entries.launches >= res["full"]["k1_launches_in_fold"],
              "launch counter went backwards")
    if run("k2"):
        res["k2"] = phase_k2_shapes(device, args.seed)
    if run("map_scenarios"):
        phase_map_scenarios(device, args.seed)
    if run("full_width_map"):
        # Config 4 as bench.py commits it (R = 8), then at R = 64.
        res["map"] = phase_full_width_map(device, args.seed, r=8)
        res["map64"] = phase_full_width_map(device, args.seed, r=64, e2e=False)
    if run("k3"):
        res["k3"] = phase_k3_shapes(device, args.seed)
    if run("delta_scenarios"):
        phase_delta_scenarios(device, args.seed)
    if run("full_width_delta"):
        res["delta"] = phase_full_width_delta(device, args.seed, ring_samples=3)
    if run("map_delta_scenarios"):
        phase_map_delta_scenarios(device, args.seed)
    if run("full_width_delta_map"):
        res["delta_map"] = phase_full_width_delta_map(device, args.seed, ring_samples=1)
    if run("sparse_scenarios"):
        phase_sparse_scenarios(device, args.seed)
    if run("flagship"):
        res["flagship"] = phase_flagship(device, args.seed, passes=2, durable_passes=2)
    if run("elastic"):
        phase_elastic(device, args.seed)
    if run("resync"):
        phase_resync(device, args.seed)
    if run("donate"):
        phase_donate(device, args.seed)
    if run("durability"):
        phase_durability(device, args.seed)
    if run("serve_scenarios"):
        phase_serve_scenarios(device, args.seed)
    if run("serve"):
        res["serve"] = phase_serve(device, args.seed)
    if run("serve_zipf"):
        phase_serve_zipf(device, args.seed)
    if run("fanout_scenarios"):
        res["fanout_scenarios"] = phase_fanout_scenarios(device, args.seed)
    if run("fanout"):
        res["fanout"] = phase_fanout(device, args.seed)
    if run("telemetry_scenarios"):
        phase_telemetry_scenarios(device, args.seed)
    if run("sparse_map_scenarios"):
        phase_sparse_map_scenarios(device, args.seed)
    if run("full_width_sparse_map"):
        phase_full_width_sparse_map(device, args.seed, passes=2)
    if run("nested_scenarios"):
        phase_nested_scenarios(device, args.seed)
    if run("full_width_nested"):
        res["nested"] = phase_full_width_nested(device, args.seed)
    if run("full_width_delta_nested"):
        res["delta_nested"] = phase_full_width_delta_nested(device, args.seed, ring_samples=1)
    if run("kinds_scenarios"):
        phase_kinds_scenarios(device, args.seed)
    if run("full_width_clocks"):
        phase_full_width_clocks(device, args.seed)
    if run("full_width_list"):
        phase_full_width_list(device, args.seed)
    if run("reclaim_scenarios"):
        res["reclaim_scenarios"] = phase_reclaim_scenarios(device, args.seed)
    if run("full_width_reclaim"):
        res["reclaim"] = phase_full_width_reclaim(device, args.seed)
    if run("faults_scenarios"):
        res["faults_scenarios"] = phase_faults_scenarios(device, args.seed)
    if run("full_width_chaos"):
        res["chaos"] = phase_full_width_chaos(device, args.seed)
    if run("obs_scenarios"):
        res["obs_scenarios"] = phase_obs_scenarios(device, args.seed)
    if run("full_width_scaleout"):
        res["scaleout"] = phase_full_width_scaleout(device, args.seed)
    if run("full_width_geo"):
        res["geo"] = phase_full_width_geo(device)
    if run("laws_scenarios"):
        res["laws"] = phase_laws_scenarios(device)
    if run("static_scenarios"):
        res["static"] = phase_static_scenarios(device)
    if run("multihost"):
        res["multihost"] = phase_multihost(device, args.seed)
    if only:
        print(f"chip_smoke: partial run of {only}; no kernels line", flush=True)
        return 0

    full, full_map, wide_map, delta = res["full"], res["map"], res["map64"], res["delta"]
    nested, delta_nested = res["nested"], res["delta_nested"]
    # Flags off, nothing installed: the launch counts from before the
    # observability plane.
    check(delta["telemetry"]["launch_kernel_calls_per_round_off"] == BASE_DENSE_ROUND_LAUNCHES
          and res["delta_map"]["telemetry"]["launch_kernel_calls_per_round_off"]
          == BASE_MAP_ROUND_LAUNCHES
          and res["serve"]["profiled_cycle"]["launch_kernel_calls_per_dispatch"]
          == BASE_SERVE_DISPATCH_LAUNCHES,
          "a δ round or a serve dispatch launches another count of kernels than before the "
          "observability plane")
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": [{
        **K1,
        "launches": full["k1_launches_in_fold"],
        "max_abs_err": max(res["k1"], full["max_abs_err"], nested["map_orswot"]["max_abs_err"],
                           nested["map3"]["max_abs_err"],
                           res["reclaim_scenarios"]["k1_max_abs_err"],
                           res["reclaim"]["dense"]["k1_max_abs_err"],
                           res["faults_scenarios"]["k1_max_abs_err"],
                           res["multihost"]["k1_max_abs_err"]),
        "ms": full["k1_ms_median"],
        "plain_ms": full["plain_chunked_ms_check_not_a_yardstick"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
    }, {
        **K2,
        "launches": full_map["k2_launches_in_fold"],
        "max_abs_err": max(res["k2"], full_map["max_abs_err"], wide_map["max_abs_err"],
                           *(leg["max_abs_err"] for leg in nested["map_map"]),
                           res["reclaim_scenarios"]["k2_max_abs_err"],
                           res["multihost"]["k2_max_abs_err"]),
        "ms": full_map["k2_ms_median"],
        "plain_ms": full_map["k2_plain_ms"],
        "bound_ms": full_map["bound_ms"],
        "bound_by": full_map["bound_by"],
        "library_ms": None,
    }, {
        **K3,
        "launches": delta["k3_launches_in_ring"],
        "max_abs_err": max(res["k3"], delta["k3_max_abs_err"],
                           res["delta_map"]["k3_max_abs_err"],
                           res["fanout_scenarios"]["k3_max_abs_err"],
                           res["fanout"]["first_dispatch_max_abs_err"],
                           res["fanout"]["k3_fanout_layout"]["max_abs_err"],
                           delta_nested["map_orswot"]["k3_max_abs_err"],
                           delta_nested["map3"]["k3_max_abs_err"],
                           res["faults_scenarios"]["k3_max_abs_err"],
                           res["chaos"]["k3_max_abs_err"],
                           res["obs_scenarios"]["k3_max_abs_err"],
                           res["scaleout"]["k3_max_abs_err"],
                           res["static"]["k3_max_abs_err"],
                           res["multihost"]["k3_max_abs_err"]),
        "ms": delta["k3_ms_median"],
        "plain_ms": delta["k3_plain_ms"],
        "bound_ms": delta["k3_bound_ms"],
        "bound_by": delta["k3_bound_by"],
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
