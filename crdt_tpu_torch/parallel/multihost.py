"""Multi-process entry points — the port of the JAX package's
``parallel/multihost.py`` on ``torch.distributed`` with the gloo backend.

The JAX package runs one ``shard_map`` program over every process's
devices, the replica axis spanning processes. Here each process holds
its own replica rows on its own :class:`~.mesh.VirtualMesh` (P virtual
ranks on its card) and the processes meet in a process group:

- ``initialize`` — ``init_process_group("gloo")`` at a coordinator
  address, or torch's ``env://`` rendezvous (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them);
- ``global_mesh`` — a :class:`GlobalMesh`: this process's local ranks
  plus the group, the replica axis ``local ranks × processes`` long,
  global rank ``process · local ranks + local rank`` (process-major, the
  JAX ``global_mesh`` order). The entries of ``CROSS_PROCESS_ENTRIES``
  take it — every fold and gossip of ``anti_entropy``, the four δ
  rings, the four replica streams, the four element-sharded folds, both
  elastic loops and the two serving-tier dispatches,
  ``mesh_serve_apply`` and ``mesh_fanout_push``: each process folds its
  rows on its card (K1, K2),
  then the fold's lattice all-reduce (``collectives.all_reduce_lattice``)
  gains a process step — recursive doubling with partner ``process ^
  2^k`` over ``send``/``recv``, since gloo takes no user-defined reduce
  op — and a ring's shift sends each row whose sender and receiver sit
  on different processes point to point (:func:`exchange_rows`,
  scheduled by ``collectives.ring_permuter``): the unit shift's hop from
  a process's last rank to the next process's first, and the δ ring's
  inverse hop, the digest and the acks. The δ ring's end-of-run sums
  and top maximum ride one all-gather (``gather_processes``). A stream
  runs that process step once a block, after one :func:`agree` gather
  of every process's block status (staged, source ended, failed, refused); an element-sharded
  fold exchanges rank 0's ``[1, S, ...]`` row (element shards never
  straddle processes); an elastic loop re-enters cross-process entries,
  whose flags are global, so every process widens alike; a serving
  dispatch applies (or gathers, decomposes and packs, one K3 launch)
  its own lanes, and only its checks, the fan-out wire's ``nnz`` and
  ``chk`` and the sidecar cross. ``telemetry=`` is mesh-wide on every
  entry that takes it (``telemetry.reduce_processes``: one gather of
  each process's partial sums, gauges and per-rank float32 byte
  vectors, summed over the GLOBAL rank vector in the single-process
  order); the gossip rings' ``stability=`` takes the minimum of every
  process's tops (``collectives.pmin``) and ``lag_threshold=`` their
  maximum lag; the elastic loops' ``reclaim=`` compacts against every
  process's frontier (``reclaim.mesh_frontier``) and decides the shrink
  on every process's occupancy (``elastic.agreed_utilization``). The
  ``faults=`` runs on every ring, stream and elastic loop: the plan
  names global ranks, each process draws the global fate table (numpy
  threefry, keyed on the seed: no exchange) and keeps its own receivers'
  columns, a faulted ring's shift over the live ranks crosses through
  the same :func:`exchange_rows` (a hop skips an evicted rank, or a
  whole evicted process), and the counters ride the entry's end-of-run
  gather. The exchange runs
  over host memory; every join and every K3 pack stays on the card.
  Refused with ``NotImplementedError``, and to stay so, because the JAX
  package does not run them across processes either:
  ``wal=`` (the JAX ``Wal.append_state`` copies every leaf to the host
  with ``np.asarray``, which a global array spanning processes refuses)
  on every cross-process entry, and a ``serve.Superblock`` or
  ``fanout.FanoutPlane`` built on a ``GlobalMesh`` (the JAX package
  serves each host's shard on a local mesh and syncs the shards with
  ``sync_tenant_shards``, ported);
- ``agree`` / ``require_same`` — a few integers of every process in ONE
  small all-gather: the entries' checks at entry (caps, rows, shard
  counts and ``init=`` shapes that differ across processes raise
  ``ValueError`` on every process, never a hang until ``TIMEOUT``) and
  the stream's per-block status;
- ``host_to_global`` / ``global_to_host`` — this process's rows onto the
  mesh's device, a result back to numpy;
- ``_allgather_host``, ``sync_tenant_rows``, ``sync_list`` — the host
  exchanges of the serving tier and the list, field for field the JAX
  ones. Every array rides gloo as a ``uint8`` view, so ``uint32``,
  ``uint64`` and ``bool`` lanes survive bit for bit.

Without a process group every entry sees one process (index 0 of 1):
the gathers return this process's own arrays, as the JAX self-gather
does.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch

from .._dtypes import bits
from ..ops.lattice import tree_leaves, tree_map, tree_unflatten
from ..utils.metrics import metrics
from .mesh import VirtualMesh

#: How long the rendezvous and each exchange wait for a peer before gloo
#: raises (a lost peer fails the run instead of hanging it).
TIMEOUT = datetime.timedelta(seconds=300)

#: The mesh entries that take a :class:`GlobalMesh`.
CROSS_PROCESS_ENTRIES = (
    "mesh_fold", "mesh_gossip", "mesh_fold_map", "mesh_gossip_map", "mesh_fold_sparse",
    "mesh_gossip_sparse", "mesh_fold_sparse_mvmap", "mesh_gossip_sparse_mvmap",
    "mesh_fold_sparse_nested", "mesh_gossip_sparse_nested", "mesh_fold_map_orswot",
    "mesh_gossip_map_orswot", "mesh_fold_map3", "mesh_gossip_map3", "mesh_fold_nested_map",
    "mesh_gossip_nested_map", "mesh_fold_clocks", "mesh_fold_gset", "mesh_fold_lww",
    "mesh_fold_mvreg", "mesh_delta_gossip", "mesh_delta_gossip_map",
    "mesh_delta_gossip_map_orswot", "mesh_delta_gossip_map3", "mesh_stream_fold_sparse",
    "mesh_stream_fold", "mesh_stream_fold_sparse_mvmap", "mesh_stream_fold_sparse_sharded",
    "mesh_fold_sparse_sharded", "mesh_fold_sparse_mvmap_sharded",
    "mesh_fold_sparse_nested_sharded", "mesh_fold_sparse_map", "gossip_elastic",
    "delta_gossip_elastic", "mesh_serve_apply", "mesh_fanout_push",
)

#: The integers a process may put on the table of one :func:`agree`.
AGREE_WIDTH = 32


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join (or start) the process group: gloo, ``tcp://`` at
    ``coordinator_address`` (``host:port``) when given, else torch's
    ``env://`` rendezvous; ``num_processes`` / ``process_id`` default to
    the environment's ``WORLD_SIZE`` / ``RANK``."""
    import torch.distributed as dist

    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=init, timeout=TIMEOUT, **kw)


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's index in the group (``jax.process_index()``); 0
    without a group."""
    import torch.distributed as dist

    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    """The number of processes in the group (``jax.process_count()``); 1
    without a group."""
    import torch.distributed as dist

    return dist.get_world_size() if _group_up() else 1


def refuse(entry: Optional[str] = None):
    """The refusal of an entry that does not run across processes."""
    raise NotImplementedError(
        f"{entry + ': ' if entry else ''}a cross-process mesh (multihost.global_mesh) runs "
        f"the entries of multihost.CROSS_PROCESS_ENTRIES only; a Superblock or FanoutPlane "
        f"on it stays refused: the JAX package does not run them across processes either "
        f"(it serves each host's shard on a local mesh)")


def _cross_process(*_):
    refuse()


class GlobalMesh:
    """A replica mesh over every process: this process's ``local``
    :class:`~.mesh.VirtualMesh` (its ranks on its own device) plus the
    process group. ``shape`` is the JAX mesh's: ``replica`` = local ranks
    × processes, ``element`` = the local element shards. The entries of
    ``CROSS_PROCESS_ENTRIES`` take it; any other entry reaches for the
    virtual mesh's ``p``, ``s`` or ``device``, or calls :func:`refuse`,
    and is refused."""

    p = property(_cross_process)
    s = property(_cross_process)
    device = property(_cross_process)

    def __init__(self, local: VirtualMesh):
        self.local = local
        self.process_index = process_index()
        self.process_count = process_count()
        self.shape = {"replica": local.p * self.process_count, "element": local.s}


def global_mesh(n_element_shards: int = 1, local_ranks: int = 1, device="cuda") -> GlobalMesh:
    """A ``(replica, element)`` mesh over every process: ``local_ranks``
    virtual ranks of this process on ``device``, split into replica ranks
    × ``n_element_shards``; the replica axis spans the processes."""
    # Element shards must fit INSIDE a process: the layout promise is
    # that element traffic never crosses processes.
    if local_ranks % n_element_shards:
        raise ValueError(
            f"{n_element_shards} element shards do not divide the "
            f"{local_ranks} per-process devices — element shards would "
            f"straddle processes (DCN)"
        )
    return GlobalMesh(VirtualMesh(local_ranks // n_element_shards, device, s=n_element_shards))


def host_to_global(local_state, mesh: GlobalMesh):
    """This process's replica rows (numpy arrays or tensors, any state
    tree) on the mesh's device: the hand-off to the cross-process
    entries. The JAX ``specs`` argument has no counterpart: the rows stay
    whole on this process's card."""
    from ..convert import leaf_from_numpy

    dev = mesh.local.device
    return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                    else leaf_from_numpy(np.asarray(x), dev), local_state)


def global_to_host(state):
    """Host copy of a result (the converged state every process receives
    from ``mesh_fold``): the same tree of numpy arrays."""
    from ..convert import leaf_to_numpy

    return tree_map(leaf_to_numpy, state)


def _refuse_timeout(retry, op: str) -> None:
    """Collective exchanges cannot be safely timed out per attempt: the
    abandoned worker thread may still issue its collectives and mispair
    with the retry's on peer processes (faults/retry.py module
    caveats). Fail loudly instead of corrupting rounds cluster-wide."""
    if retry is not None and retry.timeout is not None:
        raise ValueError(
            f"{op}: RetryPolicy.timeout is not supported around "
            f"collective exchanges — an abandoned timed-out attempt "
            f"can mispair its in-flight collectives with the retry's; "
            f"use timeout=None here"
        )


def _all_gather(out: list, tensor: torch.Tensor) -> None:
    """``torch.distributed.all_gather`` of a host tensor: the one seam
    every host gather goes through."""
    import torch.distributed as dist

    dist.all_gather(out, tensor)


def _allgather_host(arr: np.ndarray, retry=None):
    """All-gather a per-process host array of possibly different lengths
    (axis 0); returns the per-process list. Lengths are exchanged first,
    then the rows ride one padded gather as ``uint8`` bytes and are
    viewed back as ``arr``'s dtype (gloo carries no unsigned 32/64-bit
    or bool lanes of its own). One process gathers its own copy.

    ``retry=`` (a ``faults.RetryPolicy``) wraps the exchange in
    exponential-backoff-with-jitter retries — sound because an
    all-gather of immutable host arrays is idempotent. Exhaustion raises
    ``faults.DcnExchangeFailed`` carrying ``arr`` as the last-good state
    (re-gather it later). Retries must be SYMMETRIC across processes
    (same policy everywhere) or the survivors deadlock, and a
    per-attempt ``timeout`` is REFUSED: a timed-out attempt's abandoned
    thread could still issue its collectives and mispair with the
    retry's fresh ones on peer processes (faults/retry.py documents
    both caveats)."""
    _refuse_timeout(retry, "_allgather_host")

    def once():
        if process_count() == 1:
            return [np.ascontiguousarray(arr).copy()]
        with metrics.time("multihost.exchange"):
            return _gather_rows(arr)

    if retry is None:
        return once()
    from ..faults.retry import with_retries

    return with_retries(once, retry, op="allgather_host", last_good=arr)


def _gather_rows(arr: np.ndarray) -> list:
    """One exchange of :func:`_allgather_host` over two or more processes:
    the lengths, then one padded ``uint8`` gather."""
    a = np.ascontiguousarray(arr)
    n = process_count()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    _all_gather(lens, torch.tensor([a.shape[0]], dtype=torch.int64))
    lens = [int(x) for x in lens]
    row = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    width = max(lens) * row
    out = [np.zeros((m, *a.shape[1:]), a.dtype) for m in lens]
    if width == 0:
        return out
    padded = torch.zeros(width, dtype=torch.uint8)
    padded[: a.nbytes] = torch.from_numpy(a.reshape(-1).view(np.uint8))
    got = [torch.empty(width, dtype=torch.uint8) for _ in range(n)]
    _all_gather(got, padded)
    metrics.count("multihost.bytes_sent", width)
    for o, g, m in zip(out, got, lens):
        o.reshape(-1).view(np.uint8)[:] = g[: m * row].numpy()
    return out


# ---- the agreement: a few integers of every process -------------------------

def agree(values, mesh: Optional["GlobalMesh"]) -> list:
    """Every process's ``values`` (fewer than ``AGREE_WIDTH`` integers), in
    process order, over the processes of ``mesh``: ONE all-gather of a
    fixed-width ``int64`` row a process, its count first, so a process
    that put down another count disagrees. Without processes to cross
    (``mesh`` None or one process), ``[values]``."""
    vals = tuple(int(v) for v in values)
    if mesh is None or mesh.process_count == 1:
        return [vals]
    if len(vals) >= AGREE_WIDTH:
        raise ValueError(f"agree takes fewer than {AGREE_WIDTH} integers, got {len(vals)}")
    row = torch.zeros(AGREE_WIDTH, dtype=torch.int64)
    row[0] = len(vals)
    row[1:1 + len(vals)] = torch.tensor(vals, dtype=torch.int64)
    got = [torch.empty_like(row) for _ in range(mesh.process_count)]
    with metrics.time("multihost.exchange"):
        _all_gather(got, row)
    metrics.count("multihost.bytes_sent", row.numel() * row.element_size())
    return [tuple(int(v) for v in g[1:1 + int(g[0])]) for g in got]


def require_same(what: str, values, mesh: Optional["GlobalMesh"], error=None) -> None:
    """An entry's check across processes, raised on EVERY process alike:
    :func:`agree` on ``values``; ``error`` is this process's own refusal
    (the exception its local check raised, or None). Every process then
    raises — this one ``error``, the others a ``ValueError`` naming the
    refusing process — or, when the values differ, a ``ValueError``
    listing them."""
    rows = agree((int(error is not None), *values), mesh)
    if error is not None:
        raise error
    refused = [i for i, r in enumerate(rows) if r[0]]
    if refused:
        raise ValueError(f"{what}: process {refused[0]} refused its input")
    if len(set(rows)) != 1:
        raise ValueError(f"{what} differ across processes: {[r[1:] for r in rows]}")


def shape_digest(tree, skip: int = 1) -> int:
    """A digest of every leaf's dtype and shape past its first ``skip``
    axes (the replica rows): equal across processes when their states
    line up, for :func:`require_same`."""
    import zlib

    return zlib.crc32(repr([(str(x.dtype), tuple(x.shape[skip:]))
                            for x in tree_leaves(tree)]).encode())


# ---- the process step of the cross-process entries -------------------------
#
# The ``multihost.exchange`` span of a process step covers the copy off
# the card, the gloo transfer (with any wait for a peer still folding)
# and the upload; the host exchanges' span covers their gather. The card
# is synchronised just before the span opens (the copy off the card would
# wait for it anyway), so the span does not hold this process's queued
# device work.

def _settle(tree) -> None:
    """Wait for the card that holds ``tree``: the queued work the copy off
    the card waits for, outside the exchange span."""
    leaf = tree_leaves(tree)[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def _to_bytes(tree) -> torch.Tensor:
    """Every leaf's bytes, in ``tree_leaves`` order, as one ``uint8`` host
    tensor (one copy off the card)."""
    return torch.cat([bits(x).reshape(-1).view(torch.uint8) for x in tree_leaves(tree)]).cpu()


def _from_bytes(buf: torch.Tensor, like):
    """Inverse of :func:`_to_bytes` for a tree shaped like ``like``,
    uploaded to ``like``'s device."""
    buf = buf.to(tree_leaves(like)[0].device)
    out, off = [], 0
    for x in tree_leaves(like):
        n = x.numel() * x.element_size()
        # A fresh storage per leaf: a view to a wider dtype needs an
        # aligned offset.
        out.append(buf[off:off + n].clone().view(bits(x).dtype).reshape(x.shape).view(x.dtype))
        off += n
    return tree_unflatten(like, out)


def _sendrecv(payload: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """Send ``payload`` to process ``dst`` while receiving one of the same
    size from ``src``; a size mismatch (peers of other widths) raises."""
    import torch.distributed as dist

    size, their = torch.tensor([payload.numel()], dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    req = dist.isend(size, dst)
    dist.recv(their, src)
    req.wait()
    if int(their) != payload.numel():
        raise ValueError(f"process {src} sent a state of {int(their)} bytes, this process "
                         f"holds {payload.numel()}: the processes' widths differ")
    got = torch.empty_like(payload)
    req = dist.isend(payload, dst)
    dist.recv(got, src)
    req.wait()
    metrics.count("multihost.bytes_sent", payload.numel())
    return got


def all_reduce_processes(state, flags: torch.Tensor, join_fn, fold_fn, mesh: GlobalMesh,
                         rows=None):
    """The lattice all-reduce over the processes of ``mesh``: ``state`` is
    this process's joined row (leaves ``[1, ...]`` on its card), ``flags``
    its OR-reduced overflow flags. A power-of-two process count runs
    recursive doubling — log2(n) rounds, each swapping states and flags
    with process ``index ^ 2^k`` and joining on the card with the kind's
    ``join_fn``, the lower process's state first — so every process joins
    in rank 0's order and holds rank 0's bits, where a join's
    representation depends on its order (an LWW tie, a sibling or parked
    slot order); any other count all-gathers the states and folds them in
    process order with ``fold_fn``. ``rows`` (every local rank's row,
    power-of-two counts only) rides the same swaps, each rank joining its
    own row first with the partner process's row of the same rank: the
    rows a single-process recursive doubling over every rank leaves.
    Returns every process's global join (``[1, ...]``), the flags
    OR-reduced over the processes and the rows (None without)."""
    n, me = mesh.process_count, mesh.process_index
    if n & (n - 1) == 0:
        k = 1
        while k < n:
            payload = (state, flags) if rows is None else (state, flags, rows)
            _settle(payload)
            with metrics.time("multihost.exchange"):
                got = _from_bytes(_sendrecv(_to_bytes(payload), me ^ k, me ^ k), payload)
            theirs, their_flags = got[:2]
            state, of = join_fn(*((state, theirs) if me < me ^ k else (theirs, state)))
            if rows is not None:
                rows, _ = join_fn(rows, got[2])
            flags = flags | their_flags | torch.any(of, dim=0)
            k *= 2
        return state, flags, rows
    _settle(state)
    with metrics.time("multihost.exchange"):
        rows = [_from_bytes(torch.from_numpy(b[0]), (state, flags))
                for b in _gather_rows(_to_bytes((state, flags)).numpy()[None])]
    stacked = tree_map(lambda *xs: torch.cat([bits(x) for x in xs]).view(xs[0].dtype),
                       *[s for s, _ in rows])
    folded, of = fold_fn(stacked)
    for _, f in rows:
        flags = flags | f
    flags = flags | torch.as_tensor(of, device=flags.device).to(torch.bool)
    return tree_map(lambda x: x[None], folded), flags, None


def exchange_rows(sends, recvs, like) -> list:
    """Point-to-point moves of single rows between processes (a ring's
    hops, ``collectives.ring_permuter``):
    ``sends`` is ``[(row, destination process, tag)]`` (``row`` a tree
    shaped like ``like``, leaves ``[1, ...]``), ``recvs`` ``[(source
    process, tag)]``; the tag (the receiving global rank) pairs each send
    with its receive. Every ``isend`` and ``irecv`` is posted before any
    wait, so no order of the processes' calls can deadlock gloo. Returns
    the received rows in ``recvs`` order, on ``like``'s device."""
    import torch.distributed as dist

    _settle(like)
    width = sum(x.numel() * x.element_size() for x in tree_leaves(like))
    with metrics.time("multihost.exchange"):
        out = [_to_bytes(row) for row, _, _ in sends]
        got = [torch.empty(width, dtype=torch.uint8) for _ in recvs]
        reqs = [dist.isend(b, dst, tag=tag) for b, (_, dst, tag) in zip(out, sends)]
        reqs += [dist.irecv(g, src, tag=tag) for g, (src, tag) in zip(got, recvs)]
        for req in reqs:
            req.wait()
        rows = [_from_bytes(g, like) for g in got]
    metrics.count("multihost.bytes_sent", sum(b.numel() for b in out))
    return rows


def gather_processes(tensors, mesh: GlobalMesh) -> list:
    """Every process's ``tensors`` (small tensors on the card) over the
    processes of ``mesh``, in ONE exchange: they ride an all-gather as
    ``uint8`` bytes, since gloo carries no ``uint32``/``uint64``/``bool``
    lanes. Returns, for each tensor, its values stacked ``[processes,
    ...]`` in process order on the card, for the caller's reduction
    (``collectives.preduce``)."""
    tree = tuple(tensors)
    _settle(tree)
    with metrics.time("multihost.exchange"):
        rows = [_from_bytes(torch.from_numpy(b[0]), tree)
                for b in _gather_rows(_to_bytes(tree).numpy()[None])]
    return [torch.stack([bits(x) for x in xs]).view(xs[0].dtype) for xs in zip(*rows)]


# ---- the serving tier's and the list's host exchanges ----------------------

def _lockstep(gather_all, retry, op: str, last_good):
    """Run ``gather_all`` (a multi-collective exchange) under ``retry``,
    each attempt opening with the attempt-number lockstep tag: a
    one-sided retry whose peers sailed on shows as a tag mismatch and
    raises ``DcnExchangeFailed`` without a retry, instead of pairing
    field gathers of different attempts."""
    from ..faults.retry import DcnExchangeFailed, with_retries

    attempt_box = {"n": 0}

    def gather_all_guarded():
        tag = _allgather_host(np.asarray([attempt_box["n"]], np.int32))
        attempt_box["n"] += 1
        if len({int(t[0]) for t in tag}) != 1:
            raise DcnExchangeFailed(
                op, attempt_box["n"],
                RuntimeError(
                    "attempt-number mismatch across processes — a "
                    "one-sided retry desynced the collective "
                    f"sequence; re-enter {op} on every process"
                ),
                last_good=last_good,
            )
        return gather_all()

    return with_retries(gather_all_guarded, retry, op=op, last_good=last_good)


def sync_tenant_rows(wire: dict, retry=None):
    """All-gather per-host serving-tier wire dicts (uniform string
    field names, numpy array values — the tenant-shard anti-entropy
    exchange of serve/shard.py: each host exports packed tenant rows,
    every host receives every export and joins the rows it OWNS).
    Returns the per-process list of wire dicts, this process's own
    included.

    ``retry=`` hardens the gathers exactly like :func:`sync_list`
    (idempotent gathers of immutable exports; symmetric-policy and
    no-per-attempt-timeout caveats apply) — and because this is a
    MULTI-collective exchange (one gather pair per field), each retried
    attempt opens with the same attempt-number lockstep check, so a
    one-sided transient failure surfaces as ``DcnExchangeFailed``
    instead of mispairing field bytes."""
    _refuse_timeout(retry, "sync_tenant_rows")
    fields = sorted(wire)

    def gather_all():
        return {f: _allgather_host(np.asarray(wire[f])) for f in fields}

    gathered = (gather_all() if retry is None
                else _lockstep(gather_all, retry, "sync_tenant_rows", wire))
    return [{f: gathered[f][p] for f in fields} for p in range(process_count())]


def sync_list(model, since: int = 0, retry=None) -> int:
    """Converge ``BatchedList`` identifier universes across processes
    (the reference ships ``Op::Insert { id, val }`` bytes to any
    replica; here the op log's identifier paths ride an all-gather).
    Each process exports its local ops ``[since, ...)``, gathers every
    process's export, and ingests the remote ones in process order —
    identifier paths are globally unique and totally ordered by
    construction, so every process reconverges to the SAME total order
    regardless of mint site. Returns the new local-op watermark to pass
    as ``since`` next round.

    Device state re-permutes with the growing universe; run
    ``model.apply_trace_to_all()`` afterwards to land the new ops.

    ``retry=`` (a ``faults.RetryPolicy``) hardens the gather — the only
    cross-process exchange here — with exponential-backoff-with-jitter
    retries (gathers of an immutable export are idempotent; local
    ingestion below never retries, so a flaky link cannot double-apply).
    Exhaustion raises ``faults.DcnExchangeFailed`` carrying ``since`` as
    the last-good watermark: ops below it are already everywhere —
    re-sync later from it, nothing is lost. Same symmetric-retry and
    no-per-attempt-timeout caveats as ``_allgather_host`` — and because
    this exchange is SEVEN collectives, each retried attempt opens with
    an attempt-number lockstep check, so a one-sided failure surfaces as
    ``DcnExchangeFailed`` instead of silently ingesting mispaired field
    bytes."""
    _refuse_timeout(retry, "sync_list")
    wire = dict(model.export_ops(since))
    # The JAX exchange ships 32-bit lanes (its gather truncates 64-bit
    # dtypes without x64 mode); the same split and range checks keep
    # this one field for field the JAX one: cctr (engine mint counters,
    # uint64) splits hi/lo, cidx and counts are range-checked into int32.
    for f in ("cidx", "counts"):
        if wire[f].size and wire[f].max() > np.iinfo(np.int32).max:
            raise OverflowError(f"wire field {f} exceeds int32 range")
        wire[f] = wire[f].astype(np.int32)
    cctr = wire.pop("cctr")
    wire["cctr_hi"] = (cctr >> np.uint64(32)).astype(np.uint32)
    wire["cctr_lo"] = cctr.astype(np.uint32)
    fields = ("kinds", "values", "counts", "cidx", "cactor", "cctr_hi", "cctr_lo")

    def gather_all():
        return {f: _allgather_host(np.asarray(wire[f])) for f in fields}

    gathered = gather_all() if retry is None else _lockstep(gather_all, retry, "sync_list", since)
    me = process_index()
    for p in range(process_count()):
        if p == me:
            continue
        remote = {f: gathered[f][p] for f in fields}
        remote["cctr"] = (
            remote.pop("cctr_hi").astype(np.uint64) << np.uint64(32)
        ) | remote.pop("cctr_lo").astype(np.uint64)
        remote["counts"] = remote["counts"].astype(np.int64)
        remote["cidx"] = remote["cidx"].astype(np.int64)
        model.ingest_remote_ops(remote)
    # Ops below this watermark are now known to every process (each
    # ingested everyone's export this round) — the next sync ships only
    # ops minted after it.
    return len(model.op_handles)


__all__ = [
    "AGREE_WIDTH", "CROSS_PROCESS_ENTRIES", "GlobalMesh", "TIMEOUT", "agree",
    "all_reduce_processes", "exchange_rows", "gather_processes", "global_mesh", "global_to_host",
    "host_to_global", "initialize", "process_count", "process_index", "refuse", "require_same",
    "shape_digest", "sync_list", "sync_tenant_rows",
]
