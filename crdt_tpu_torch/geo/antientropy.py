"""Cross-region anti-entropy — δ lanes over retry-wrapped links; the port
of the JAX package's ``geo/antientropy.py``.

A link ships only the join-irreducible decomposition of what the peer
provably lacks (``delta_opt/decompose.py``, Enes et al.). One
:class:`GeoLink` per directed (home → mirror) region pair carries the
ack-window semantics host-side:

- the sender keeps its own **shipped copy** per tenant and promotes it to
  the link's acked base ONLY on positive ack — the receiver's mirror
  therefore equals the sender's acked base bit-exactly, which is what
  makes positional δ reconstruction reproduce the home row on arrival;
- promotion is MONOTONIC, and the acked version per tenant IS the causal
  watermark geo/reads.py certifies local reads against.

Every exchange runs under ``faults.retry.with_retries`` with a lockstep
round guard, the packet stamps the federation generation, and the payload
rides under a ``faults.integrity.checksum`` digest: a corrupt packet is
rejected before any join and the retry re-ships it.

Host and device: the shipped copies and acked bases are host trees
(numpy leaves), as the JAX package keeps them. The decomposition, the
reconstruction and the digest run on the federation's device: a row is
taken from its superblock lane there, and a reconstructed mirror is
written back there, with no host detour.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..delta_opt.decompose import Decomposition, decompose, decomposition_bytes, reconstruct
from ..faults import integrity
from ..faults.retry import RetryPolicy, with_retries
from ..ops import superblock as sb_ops
from ..utils.metrics import metrics
from .region import Federation


class GeoLockstepError(RuntimeError):
    """The two ends of a geo link disagree on the exchange round — a
    mispaired packet would join lanes against the wrong base, so the
    exchange fails loudly instead."""


class _CorruptPacket(RuntimeError):
    """Receiver-side integrity rejection — raised INSIDE the retried
    exchange so ``with_retries`` re-ships the packet; the corrupt payload
    never joined."""


class GeoPacket(NamedTuple):
    """One anti-entropy shipment: per-tenant δ decompositions over the
    link's acked bases, under a federation-generation stamp, a lockstep
    round, and a whole-payload checksum digest."""

    src: int
    dst: int
    generation: int
    round: int
    tenants: Tuple[int, ...]
    versions: Tuple[int, ...]   # home version each δ brings the mirror to
    deltas: Tuple[Decomposition, ...]
    digest: torch.Tensor        # integrity.checksum over the payload (u32 in int64)


class ExchangeReport(NamedTuple):
    src: int
    dst: int
    tenants_shipped: int
    bytes_delta: float          # δ-lane wire bytes actually shipped
    bytes_full_mirror: float    # what full-state mirroring would have cost
    rejected: int               # integrity rejections healed by retry
    round: int


class GeoLink:
    """Directed per-(src→dst) link state: the host-side ack window."""

    def __init__(self, src: int, dst: int):
        self.src = int(src)
        self.dst = int(dst)
        # tenant -> the sender's shipped copy promoted on positive ack;
        # equals the receiver's mirror bit-exactly.
        self.acked_base: Dict[int, object] = {}
        self.acked_ver: Dict[int, int] = {}
        self.round_acked = 0
        self.integrity_rejects = 0

    def watermark(self, tenant: int) -> int:
        return self.acked_ver.get(int(tenant), 0)

    def confirm(self, tenant: int, version: int, shipped_row) -> None:
        """Promote on positive ack — monotonic: a duplicate or reordered
        ack below the current watermark is a no-op."""
        t = int(tenant)
        if version <= self.acked_ver.get(t, 0):
            return
        self.acked_ver[t] = int(version)
        self.acked_base[t] = shipped_row

    def reset(self, tenants) -> None:
        """Forget the ack window for ``tenants`` — the ⊥ re-entry
        (geo/failover.py): the next exchange re-ships full state."""
        for t in tenants:
            self.acked_ver.pop(int(t), None)
            self.acked_base.pop(int(t), None)


def link_for(fed: Federation, src: int, dst: int) -> GeoLink:
    key = (int(src), int(dst))
    lk = fed.links.get(key)
    if lk is None:
        lk = GeoLink(src, dst)
        fed.links[key] = lk
    return lk


def _payload(tenants, versions, deltas, src, dst, generation, round_, device):
    """The digest-covered view of a packet: the header ints ride as one
    tensor, so a flipped tenant id or round is as detectable as a flipped
    lane byte. The JAX package runs with 64-bit types off, so its
    ``int64`` header reaches the checksum as ``int32``, one word per value
    (the low 32 bits); the header here is that ``int32`` array, which
    makes the digest the JAX package's."""
    hdr = np.asarray([src, dst, generation, round_] + list(tenants) + list(versions), np.int64)
    return (torch.from_numpy(hdr.astype(np.int32)).to(device), tuple(deltas))


def _tree_shapes_match(a, b) -> bool:
    return len(a) == len(b) and all(
        np.shape(x) == np.shape(y) and np.asarray(x).dtype == np.asarray(y).dtype
        for x, y in zip(a, b)
    )


def _resident(plane, tenant: int) -> bool:
    """Make a tenant's lane current: resident already, or restored on touch
    from the durable tier. False when the tenant has no lane (⊥)."""
    sb = plane.sb
    t = int(tenant)
    if not sb.is_resident(t) and plane.evictor is not None and sb.was_evicted[t]:
        plane.evictor.restore(t)
    return sb.is_resident(t)


def _materialized_row(plane, tenant: int):
    """The receiver's (or sender's) current row for a tenant, on the
    superblock's device: resident lane, else restore-on-touch from the
    durable tier, else ⊥."""
    sb = plane.sb
    if _resident(plane, tenant):
        return sb.device_row(int(tenant))
    return sb.empty_row()


def build_packet(
    fed: Federation, src: int, dst: int, *, max_tenants: Optional[int] = None,
) -> Tuple[Optional[GeoPacket], Dict[int, object], float, float]:
    """Assemble one src→dst shipment: src-homed tenants in dst's
    local-interest set whose home version has advanced past the link's
    acked watermark. Returns ``(packet-or-None, shipped copies, δ bytes,
    full-mirror baseline bytes)``; the shipped copies (host rows) are kept
    sender-side for promote-on-ack."""
    src_plane = fed.plane(src)
    dst_plane = fed.plane(dst)
    link = link_for(fed, src, dst)
    interest = dst_plane.interest_tenants()
    queue = src_plane.queue

    cands: List[int] = []
    for t in sorted(interest):
        if fed.rmap.home(t) != src:
            continue
        applied = int(fed.versions[t]) - len(queue.pending.get(t, ()))
        if applied > link.watermark(t):
            cands.append(t)
        if max_tenants is not None and len(cands) >= max_tenants:
            break
    if not cands:
        return None, {}, 0.0, 0.0

    dev = fed.device
    tenants, versions, deltas = [], [], []
    shipped: Dict[int, object] = {}
    sizes = []
    bytes_full = 0.0
    for t in cands:
        row_dev = _materialized_row(src_plane, t)
        row = sb_ops.to_host(row_dev)
        since = link.acked_base.get(t)
        if since is not None and _tree_shapes_match(since, row):
            base = sb_ops.to_device(since, dev)
        else:
            if since is not None:
                metrics.count("geo.resyncs")
            base = src_plane.sb.empty_row()
        d = decompose(fed.kind, row_dev, base)
        applied = int(fed.versions[t]) - len(queue.pending.get(t, ()))
        tenants.append(int(t))
        versions.append(applied)
        deltas.append(d)
        shipped[int(t)] = row
        sizes.append(decomposition_bytes(d))
        bytes_full += float(src_plane.sb.row_nbytes())
    # One read of every δ's size; summed as Python floats in tenant order,
    # as the JAX package sums its float32 scalars.
    bytes_delta = 0.0
    for b in torch.stack(sizes).tolist():
        bytes_delta += b

    round_ = link.round_acked + 1
    digest = integrity.checksum(_payload(
        tenants, versions, deltas, src, dst, fed.membership.generation, round_, dev,
    ))
    pkt = GeoPacket(
        src=int(src), dst=int(dst), generation=fed.membership.generation, round=round_,
        tenants=tuple(tenants), versions=tuple(versions), deltas=tuple(deltas), digest=digest,
    )
    return pkt, shipped, bytes_delta, bytes_full


def apply_packet(fed: Federation, pkt: GeoPacket) -> List[Tuple[int, int]]:
    """Receiver side: refuse stale generations, hold the lockstep round,
    verify the checksum BEFORE any join, then reconstruct each δ over the
    local mirror (bit-exact by the ack-window invariant) and land it.
    Returns the positive acks ``[(tenant, version)]``."""
    fed.membership.require(pkt.generation, op="exchange")
    plane = fed.plane(pkt.dst)

    last = plane.rounds_applied.get(pkt.src, 0)
    if pkt.round not in (last, last + 1):
        raise GeoLockstepError(
            f"geo link {pkt.src}->{pkt.dst} shipped round {pkt.round} "
            f"but the receiver last applied {last} — mispaired "
            f"exchange; refusing to join"
        )

    if not bool(integrity.verify(
        _payload(pkt.tenants, pkt.versions, pkt.deltas, pkt.src, pkt.dst, pkt.generation,
                 pkt.round, fed.device),
        pkt.digest,
    )):
        link = link_for(fed, pkt.src, pkt.dst)
        link.integrity_rejects += 1
        metrics.count("geo.integrity_rejects")
        raise _CorruptPacket(
            f"geo packet {pkt.src}->{pkt.dst} round {pkt.round} failed "
            f"its checksum — rejected before join"
        )

    acks: List[Tuple[int, int]] = []
    for t, ver, d in zip(pkt.tenants, pkt.versions, pkt.deltas):
        mirror = _materialized_row(plane, t)
        plane.sb.write_row(int(t), reconstruct(fed.kind, mirror, d))
        acks.append((int(t), int(ver)))
    plane.rounds_applied[pkt.src] = pkt.round
    return acks


def exchange(
    fed: Federation, src: int, dst: int, *,
    policy: Optional[RetryPolicy] = None,
    transport: Optional[Callable[[GeoPacket], GeoPacket]] = None,
    max_tenants: Optional[int] = None,
) -> ExchangeReport:
    """One retry-wrapped src→dst anti-entropy round. ``transport``
    (identity by default) is the inter-region seam — fault-injection
    tests wrap it to drop, delay, or corrupt packets; every failure lands
    in ``with_retries``' ledger with ``last_good`` = the link's last fully
    acked round."""
    link = link_for(fed, src, dst)
    pkt, shipped, bytes_delta, bytes_full = build_packet(fed, src, dst,
                                                         max_tenants=max_tenants)
    if pkt is None:
        return ExchangeReport(src, dst, 0, 0.0, 0.0, 0, link.round_acked)

    send = transport or (lambda p: p)
    rejects_before = link.integrity_rejects
    pol = policy or RetryPolicy(attempts=3, base_delay=0.0, jitter=0.0)

    def _one_exchange():
        return apply_packet(fed, send(pkt))

    acks = with_retries(_one_exchange, pol, op=f"geo.exchange.{src}->{dst}",
                        last_good=link.round_acked)
    for t, ver in acks:
        link.confirm(t, ver, shipped[t])
    link.round_acked = pkt.round

    rejected = link.integrity_rejects - rejects_before
    fed.exchanges += 1
    fed.exchange_bytes += bytes_delta
    fed.full_mirror_bytes += bytes_full
    metrics.count("geo.exchanges")
    metrics.count("geo.exchange_bytes", int(bytes_delta))
    obs.emit("geo_exchange", src=int(src), dst=int(dst), tenants=len(pkt.tenants),
             bytes=int(bytes_delta), rejected=int(rejected), round=int(pkt.round))
    return ExchangeReport(src, dst, len(pkt.tenants), bytes_delta, bytes_full, rejected,
                          pkt.round)


def exchange_all(
    fed: Federation, *,
    policy: Optional[RetryPolicy] = None,
    transport: Optional[Callable[[GeoPacket], GeoPacket]] = None,
    max_tenants: Optional[int] = None,
) -> List[ExchangeReport]:
    """One full federation anti-entropy sweep: every live home region
    feeds every OTHER live region's interest set."""
    reports: List[ExchangeReport] = []
    live = sorted(r for r, p in fed.planes.items() if p.alive)
    for src in live:
        for dst in live:
            if src == dst:
                continue
            reports.append(exchange(fed, src, dst, policy=policy, transport=transport,
                                    max_tenants=max_tenants))
    return reports


__all__ = [
    "ExchangeReport", "GeoLink", "GeoLockstepError", "GeoPacket", "apply_packet",
    "build_packet", "exchange", "exchange_all", "link_for",
]
