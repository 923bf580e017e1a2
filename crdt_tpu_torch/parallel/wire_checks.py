"""The ``wire`` static-check section: the fused wire path's gates — the
port of the JAX package's ``parallel/wire_checks.py``.

Three detectors, each with a broken twin in ``analysis/fixtures.py``
proving it fires:

1. **surface coverage** — every δ ring kind (each ``run_delta_ring("...")``
   call of the port) has a codec know function in
   ``parallel.wire.WIRE_SURFACES``;
2. **fused gate soundness** — the in-kernel digest verdict on the committed
   three-slot fixture: the removal-carrying covered slot must SHIP (a top
   digest can never vouch for a removal), the covered add-only slot must
   MASK, the uncovered slot must SHIP. The twin
   ``fixtures.fused_mask_drops_removals`` (the wider gate as a know
   function) must fail it;
3. **wire round trip** — pack → unpack lands the gated packet
   bit-identically and K3's in-pass checksum equals
   ``faults.integrity.checksum`` of the wire tree; the bitmap truncation
   twin ``fixtures.bitmap_truncates_lanes`` must fail the bitmap property.

The fixture packet lives on ``device``: on a card ``WireCodec.pack``
launches kernel K3 there, on the CPU it runs K3's plain version.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..analysis.report import Finding


def _u32(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64, device=device).to(torch.int32).view(torch.uint32)


def _fixture_packet(device="cuda"):
    """The committed three-slot dense fixture on ``device``: slot 0
    removal-carrying but top-covered, slot 1 add-only covered, slot 2
    uncovered — plus one VALID parked remove so the parked lanes exercise
    the wire too. Returns ``(packet, digest)``."""
    from .delta import DeltaPacket

    pkt = DeltaPacket(
        idx=torch.arange(3, dtype=torch.int32, device=device),
        rows=_u32([[1, 0], [1, 0], [7, 0]], device),
        ctxs=_u32([[2, 0], [1, 0], [7, 0]], device),
        valid=torch.ones(3, dtype=torch.bool, device=device),
        dcl=_u32([[3, 1], [0, 0]], device),
        dmask=torch.tensor([[True, False, True, False], [False] * 4], device=device),
        dvalid=torch.tensor([True, False], device=device),
    )
    return pkt, _u32([5, 5], device)


def _codec(pkt, know_fn, gated: bool = True):
    """The codec of the fixture packet (4 rows, gated, no ack window)."""
    from . import wire

    return wire.WireCodec(pkt, 4, know_fn, gated=gated, acked=False)


def check_fused_gate(know_fn=None, label="wire.fused_gate", device="cuda") -> List[Finding]:
    """Detector 2: the fused kernel's keep verdicts on the committed
    fixture (expected [ship, mask, ship])."""
    from . import wire

    pkt, digest = _fixture_packet(device)
    _, aux = _codec(pkt, know_fn or wire.know_dense).pack(pkt, rtop=digest)
    keep = aux.keep.tolist()
    findings: List[Finding] = []
    if not keep[0]:
        findings.append(Finding(
            "wire-removal-dropped", label,
            "the fused gate masked a REMOVAL-CARRYING covered slot "
            "(ctx above rows under a covering top) — a top digest can "
            "never vouch for a removal; receivers would keep dead "
            "members live (the wider-gate unsoundness, inside the "
            "kernel)",
        ))
    if keep[1]:
        findings.append(Finding(
            "wire-gate-dead", label,
            "a digest-covered add-only slot was NOT masked — the "
            "fused gate never strips redundant payload, so the wire "
            "pass is dead weight",
        ))
    if not keep[2]:
        findings.append(Finding(
            "wire-novelty-dropped", label,
            "an UNCOVERED slot was masked — novel content never "
            "reaches the wire and the ring cannot converge",
        ))
    return findings


def check_roundtrip(label="wire.roundtrip", device="cuda") -> List[Finding]:
    """Detector 3: pack → unpack bit-identity against the layered gate's
    output, and kernel-checksum parity with the stock integrity lane."""
    from .._dtypes import to_wide
    from ..convert import leaf_to_numpy
    from ..faults.integrity import checksum
    from ..ops.lattice import tree_leaves
    from . import wire
    from .delta import gate_delta

    pkt, digest = _fixture_packet(device)
    codec = _codec(pkt, wire.know_dense)
    w, aux = codec.pack(pkt, rtop=digest)
    dec = codec.unpack(w, own_top=digest)
    ref = gate_delta(pkt, digest)
    findings: List[Finding] = []
    keep = aux.keep.cpu().numpy()
    dvalid = pkt.dvalid.cpu().numpy()
    for (name, a), b in zip(wire._named_leaves(ref), tree_leaves(dec)):
        a, b = leaf_to_numpy(a), leaf_to_numpy(b)
        if name in ("dcl", "dmask"):
            a = np.where(dvalid.reshape((-1,) + (1,) * (a.ndim - 1)), a, 0)
        if name == "idx":
            # Masked slots ship zero indices; the receiver fills DISTINCT
            # no-op targets — equality holds on kept slots, distinctness
            # over all (wire.fill_invalid_idx).
            if len(set(b.tolist())) != b.shape[0]:
                findings.append(Finding(
                    "wire-roundtrip", label,
                    "reconstructed slot indices collide — duplicate "
                    "scatter targets make the apply order-dependent",
                ))
            a, b = a[keep], b[keep]
        if not np.array_equal(a, b):
            findings.append(Finding(
                "wire-roundtrip", label,
                f"decoded plane {name!r} differs from the gated "
                "packet — the wire format does not round-trip and "
                "converged states would diverge from the layered "
                "oracle",
            ))
    if int(to_wide(aux.checksum)) != int(checksum(w)):
        findings.append(Finding(
            "wire-checksum-drift", label,
            "the kernel's in-pass checksum differs from "
            "integrity.checksum of the wire tree — receivers would "
            "reject every intact packet (or accept corrupt ones)",
        ))
    return findings


def check_bitmaps(packer=None, label="wire.bitmaps", device="cuda") -> List[Finding]:
    """The bitmap pack/unpack property at awkward widths (word boundaries
    ± 1); ``packer`` is the seam the broken twin
    ``fixtures.bitmap_truncates_lanes`` fails through."""
    from ..ops import wire_kernels as wk

    packer = packer or wk.pack_bits
    rng = np.random.RandomState(7)
    findings: List[Finding] = []
    for n in (1, 31, 32, 33, 63, 64, 65, 200):
        flags = torch.from_numpy(rng.rand(n) > 0.5).to(device)
        try:
            ok = bool(torch.all(wk.unpack_bits(packer(flags), n) == flags))
        except Exception:
            ok = False
        if not ok:
            findings.append(Finding(
                "wire-bitmap-truncated", label,
                f"a {n}-bool plane does not survive the bitmap "
                "round-trip — presence masks shorter than the packet's "
                "bool lanes turn valid slots invisible on the wire",
            ))
            break
    return findings


def static_checks(device="cuda") -> List[Finding]:
    """The ``wire`` section (Finding list, empty = clean): coverage,
    fused-gate soundness and the wire round trip on ``device``, each
    detector proven firing by its broken twin."""
    from ..analysis import fixtures
    from ..analysis.registry import unwired_delta_kinds

    findings: List[Finding] = [
        Finding(
            "wire-coverage", kind,
            "δ ring kind has no registered wire surface — register "
            "its codec know function in parallel/wire.py "
            "(analysis.registry.register_wire_surface)",
        )
        for kind in unwired_delta_kinds()
    ]
    findings += check_fused_gate(device=device)
    findings += check_roundtrip(device=device)
    findings += check_bitmaps(device=device)

    # Broken twins must fire — a detector that passes its twin has no teeth.
    broken = check_fused_gate(know_fn=fixtures.fused_mask_drops_removals,
                              label="fixtures.fused_mask_drops_removals", device=device)
    if not any(f.check == "wire-removal-dropped" for f in broken):
        findings.append(Finding(
            "broken-fixture-missed", "fused_mask_drops_removals",
            "the wider-gate-as-know-function twin PASSED the fused "
            "gate detector — the removal-preservation gate is not "
            "actually firing",
        ))
    broken = check_bitmaps(packer=fixtures.bitmap_truncates_lanes,
                           label="fixtures.bitmap_truncates_lanes", device=device)
    if not any(f.check == "wire-bitmap-truncated" for f in broken):
        findings.append(Finding(
            "broken-fixture-missed", "bitmap_truncates_lanes",
            "the word-dropping bit-packer twin PASSED the bitmap "
            "round-trip detector — the truncation gate is not "
            "actually firing",
        ))
    return findings


__all__ = ["check_bitmaps", "check_fused_gate", "check_roundtrip", "static_checks"]
