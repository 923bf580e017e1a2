"""The program lint — the JAX package's ``analysis/jit_lint.py`` over the
port's op trace (``optrace.py``: an eager torch program has no jaxpr, so
each callable runs once under the recorder and its trace is walked). The
check names are the JAX package's:

- **traced-branch** — a host read inside a callable linted as sync-free
  (:func:`lint_callable`; the JAX trace aborts on one). A registered
  entry's host reads are pinned by the cost gate's ``host_syncs`` instead.
- **unstable-sort** — a ``sort``/``argsort`` with ``stable`` false whose
  index output a later event reads: tie order then depends on the device
  and its schedule. A values-only sort is exact and stays clean.
- **float-accum** — an additive reduction (``sum``, ``cumsum``, a matmul,
  ``index_add``, ``scatter_add``; a float ``psum`` is the ``sum`` inside
  it) over floating operands not provably 0/1: float addition is not
  associative. The 0/1 provenance
  follows storages through the value-preserving ops (the JAX list's aten
  names), so the 0/1-mask matmul idiom passes.
- **dtype-overflow** — arithmetic whose result is a sub-32-bit unsigned
  lane (it wraps under realistic op counts), or a conversion from an
  unsigned dtype to a narrower unsigned one.
- **donation-alias** — a donated input leaf whose storage is not the
  storage of any output leaf: the donation did not take the input's
  place (the port's ``anti_entropy._write_back`` contract).
- **ppermute-perm** — a shift (``ppermute``, ``permuter``,
  ``ring_permuter``) whose pairs are not a bijection on the ranks they
  name, or name a rank off the axis.
- **collective-axis** — the port's collectives name no axis: each runs
  over the rank axis, ``"replica"`` (length P); ``"element"`` is the shard
  axis (length S). A collective over an axis the entry's ``mesh_axes``
  does not name, or whose rank count is not that axis's length, is a
  finding.
- **donated-read-after-collective** — a donated storage read after a
  collective consumed it and an in-place write (``copy_``, ``out=``)
  changed it: the read sees the written data, not the input.

**δ digest-gate soundness** (:func:`check_gates`): the port's three gates
(``delta.gate_delta``, ``delta_map.gate_delta_map`` and the
``delta_nest.nested_gate`` lift) proven removal-preserving on the
committed three-slot fixtures, with the JAX finding names.

Drivers: :func:`lint_callable` (any callable and its arguments) and
:func:`lint_entry_points` (every registered mesh entry, each traced once
per mesh shape and device by :func:`entry_traces`, which the cost gate
reuses).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from ..utils import ophooks
from . import optrace
from .report import Finding

_ACCUM = {"sum", "nansum", "mean", "cumsum", "mm", "bmm", "addmm", "baddbmm", "mv", "dot",
          "matmul", "index_add", "index_add_", "scatter_add", "scatter_add_"}
# The JAX value-preserving primitives (broadcast, reshape, transpose,
# squeeze, slice, rev, concatenate, copy, convert, gather, select_n, the
# boolean logic, reduce_or/and/max/min, max, min, mul, pad) as aten ops.
_PRESERVING = {
    "expand", "view", "_unsafe_view", "reshape", "_reshape_alias", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "slice", "select", "narrow", "flip", "roll", "cat", "stack",
    "clone", "_to_copy", "to", "copy", "copy_", "alias", "detach", "contiguous", "lift_fresh",
    "lift_fresh_copy", "gather", "index", "index_select", "take", "where", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and", "logical_or", "logical_xor",
    "logical_not", "any", "all", "amax", "amin", "max", "min", "maximum", "minimum", "mul",
    "constant_pad_nd", "repeat", "unbind", "split", "split_with_sizes", "as_strided",
    "masked_fill", "masked_fill_",
}
# Creation ops whose fill value is their scalar argument.
_FILLS = {"zeros", "ones", "zeros_like", "ones_like", "new_zeros", "new_ones", "full",
          "full_like", "new_full", "fill", "fill_", "zero_", "scalar_tensor"}
_NARROW_UNSIGNED = (torch.uint8, torch.uint16)
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
_ARITH = {"add", "add_", "sub", "sub_", "mul", "mul_", "rsub", "sum", "cumsum", "addcmul"}
_CONVERT = {"_to_copy", "to", "copy_"}

REPLICA, ELEMENT = "replica", "element"


def _at(e: optrace.Event) -> str:
    return f"{e.where}: {e.kind} {e.name}"


class _Walker:
    """One pass over a trace: the detectors above but traced-branch and
    donation-alias (``lint_callable`` and ``lint_trace`` add those)."""

    def __init__(self, label: str, axis_sizes=None, allowed_axes=None):
        self.label = label
        self.axis_sizes = dict(axis_sizes or {})
        self.allowed_axes = None if allowed_axes is None else set(allowed_axes)
        self.findings: List[Finding] = []

    def finding(self, check: str, e: optrace.Event, detail: str) -> None:
        self.findings.append(Finding(check, self.label, f"{detail} (at {e.where})",
                                     jaxpr_slice=_at(e)))

    def walk(self, trace: optrace.OpTrace, donated: Set[int]) -> None:
        exact: Set[int] = {r.sid for r in trace.inputs if r.dtype == torch.bool}
        unstable: Dict[int, optrace.Event] = {}
        consumed: Dict[int, str] = {}   # donated sid -> the collective that read it
        clobbered: Dict[int, str] = {}  # ... then an in-place write changed it
        reported: Set[int] = set()

        def is_exact(r) -> bool:
            return r.dtype == torch.bool or r.sid in exact

        for e in trace.events:
            written = set(e.info.get("written", ()))
            view = e.info.get("view", False)
            read = {r.sid for r in e.ins} - written
            for sid in read:
                if sid in unstable:
                    self.finding("unstable-sort", unstable.pop(sid),
                                 "sort with stable=False whose index output is read — "
                                 "tie order is device-dependent")
                if (sid in clobbered and sid not in reported and not view):
                    reported.add(sid)
                    self.finding(
                        "donated-read-after-collective", e,
                        f"donated input read by {e.name} AFTER a {clobbered[sid]} consumed it "
                        "and an in-place write changed it — the read sees the written data")
            if e.kind == "collective":
                self._collective(e)
                for r in e.ins:
                    if r.sid in donated:
                        consumed.setdefault(r.sid, e.name)
                continue
            if e.kind != "op":
                continue
            for sid in written:
                if sid in consumed:
                    clobbered.setdefault(sid, consumed[sid])
            name = e.name[len("aten."):]
            if name == "sort" and not e.info.get("stable", False) and len(e.outs) > 1:
                unstable[e.outs[1].sid] = e
            if name in _ACCUM:
                floats = [r for r in e.ins if r.dtype.is_floating_point]
                if floats and not all(is_exact(r) for r in floats):
                    self.finding("float-accum", e,
                                 f"{name} accumulates floating values not provably 0/1 — "
                                 "float addition is non-associative")
            if name in _ARITH and any(r.dtype in _NARROW_UNSIGNED for r in e.outs):
                self.finding("dtype-overflow", e,
                             f"{name} on a sub-32-bit unsigned lane — it wraps under realistic "
                             "op counts")
            if name in _CONVERT and e.ins and e.outs:
                src = e.ins[-1].dtype if name == "copy_" else e.ins[0].dtype
                dst = e.outs[0].dtype
                if (src in _UNSIGNED and dst in _UNSIGNED
                        and dst.itemsize < src.itemsize):
                    self.finding("dtype-overflow", e,
                                 f"narrowing convert {src} -> {dst} truncates counter/clock "
                                 "lanes")
            # 0/1 provenance.
            scalars_ok = all(s in (0, 1) for s in e.info.get("scalars", ()))
            if name in _FILLS:
                out_exact = scalars_ok
            elif name in _PRESERVING:
                ins = e.ins[1:] if name == "where" else e.ins
                out_exact = scalars_ok and all(is_exact(r) for r in ins)
            else:
                out_exact = False
            if view:
                continue
            for r in e.outs:
                if r.sid is None:
                    continue
                if r.sid in written:
                    whole = r.nbytes == trace.storage_bytes.get(r.sid)
                    keep = out_exact and (whole or r.sid in exact)
                else:
                    keep = out_exact or r.dtype == torch.bool
                (exact.add if keep else exact.discard)(r.sid)

    def _collective(self, e: optrace.Event) -> None:
        axis, ranks, perm = e.info["axis"], e.info["ranks"], e.info["perm"]
        if self.allowed_axes is not None and axis not in self.allowed_axes:
            self.finding("collective-axis", e,
                         f"{e.name} runs over the {axis!r} axis, outside the entry's mesh axes "
                         f"{sorted(self.allowed_axes)} — it exchanges over the wrong ranks")
        size = self.axis_sizes.get(axis)
        if size is not None and ranks is not None and ranks != size:
            self.finding("collective-axis", e,
                         f"{e.name} runs over {ranks} ranks, but the {axis!r} axis has {size}")
        if perm is not None:
            srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
            n = size if size is not None else ranks
            dup = len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            off = n is not None and any(not 0 <= q < n for q in srcs + dsts)
            if dup or off or set(srcs) != set(dsts):
                why = ("duplicate sources/destinations race" if dup else
                       "a rank off the axis" if off else
                       "the pairs do not close a cycle over the ranks they name — a rank no "
                       "pair targets receives zeros")
                self.finding("ppermute-perm", e,
                             f"{e.name} perm {list(perm)} is not a bijection: {why}")


def lint_trace(trace: optrace.OpTrace, label: str, n_donated_leaves: int = 0,
               axis_sizes=None, allowed_axes=None, copied_donations: bool = False
               ) -> List[Finding]:
    """Every detector but traced-branch over one trace. The first
    ``n_donated_leaves`` input leaves are donated; ``copied_donations``:
    the callable copies each donated leaf once at entry and keeps the
    result in that copy's storage (the replica streams' accumulator)."""
    donated = [r.sid for r in trace.inputs[:n_donated_leaves]]
    w = _Walker(label, axis_sizes=axis_sizes, allowed_axes=allowed_axes)
    w.walk(trace, set(donated))
    outs = {r.sid for r in trace.outputs}
    for sid in donated:
        holders = {sid}
        if copied_donations:
            holders |= copies_of(trace, sid)
        if not holders & outs:
            ref = next(r for r in trace.inputs if r.sid == sid)
            w.findings.append(Finding(
                "donation-alias", label,
                f"donated input {ref.dtype}{list(ref.shape)} lives in no output leaf — the "
                "result did not take the donated buffer's place"))
    return w.findings


def copies_of(trace: optrace.OpTrace, sid: int) -> Set[int]:
    """The storages a ``clone`` of storage ``sid`` created."""
    return {r.sid for e in trace.events if e.name == "aten.clone"
            and any(i.sid == sid for i in e.ins) for r in e.outs}


def host_reads(trace: optrace.OpTrace) -> List[optrace.Event]:
    """The trace's host reads and sync ops, in order."""
    return [e for e in trace.events
            if e.kind == "read" or (e.kind == "op" and e.info.get("sync"))]


def lint_callable(fn, args: tuple, label: Optional[str] = None, n_donated_leaves: int = 0,
                  axis_sizes=None, allowed_axes=None) -> List[Finding]:
    """Run ``fn(*args)`` once under the recorder and lint its trace; the
    callable is linted as sync-free (every host read is a traced-branch
    finding, as a JAX trace aborts on one). ``n_donated_leaves`` marks the
    first N argument leaves donated."""
    label = label or getattr(fn, "__name__", repr(fn))
    trace = optrace.record(fn, *args)
    findings = [Finding("traced-branch", label,
                        f"host read {e.name} on a device value (at {e.where}) — the host "
                        "waits for the device and branches on its data", jaxpr_slice=_at(e))
                for e in host_reads(trace)]
    return findings + lint_trace(trace, label, n_donated_leaves, axis_sizes, allowed_axes)


def gate_mesh(device="cuda"):
    """The gate mesh: P = 4 ranks, S = 2 element shards on ``device``."""
    from ..parallel.mesh import VirtualMesh
    from .gate_states import GP, GS

    return VirtualMesh(GP, device, s=GS)


def mesh_shape(mesh) -> Dict[str, int]:
    return {REPLICA: int(mesh.p), ELEMENT: int(mesh.s)}


def _device_key(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


# Memoised entry traces, keyed on (entry, mesh shape, device): the lint,
# the cost gate and the aliasing gate read one trace of each entry.
_TRACE_CACHE: dict = {}


def entry_traces(mesh=None, names: Optional[Sequence[str]] = None, device="cuda"):
    """``{name: (entry, trace or exception, donated leaf count)}`` for the
    registered mesh entries on the gate mesh (``mesh``: default
    :func:`gate_mesh` on ``device``): each runs once to warm what it
    builds on first use (a shift's index table, the kernels' scratch),
    then once under the recorder, so a trace is the steady state whatever
    ran before it. Both runs take the card's routes
    (``utils.ophooks.card_routes``): a CPU trace is the card's program.
    An entry that raises maps to its exception; callers turn it into a
    finding. Memoised per (entry, mesh shape, device)."""
    from .registry import entry_points

    mesh = gate_mesh(device) if mesh is None else mesh
    dev = _device_key(mesh.device)
    out = {}
    for ep in entry_points():
        if names is not None and ep.name not in names:
            continue
        key = (ep.name, mesh.p, mesh.s, dev)
        if key not in _TRACE_CACHE:
            args = ep.make_args(mesh, mesh.device)
            n_leaves = len(optrace.tensor_leaves(args[:ep.n_donated]))
            try:
                with ophooks.card_routes():
                    ep.invoke(mesh, ep.make_args(mesh, mesh.device))
                    trace = optrace.record(ep.invoke, mesh, args)
                _TRACE_CACHE[key] = (ep, trace, n_leaves)
            except Exception as exc:  # a broken entry is a finding, loudly
                _TRACE_CACHE[key] = (ep, exc, n_leaves)
        out[ep.name] = _TRACE_CACHE[key]
    return out


def lint_entry_points(mesh=None, names: Optional[Sequence[str]] = None, device="cuda"
                      ) -> List[Finding]:
    """Lint every registered mesh entry's trace (each run once on the gate
    mesh); an unregistered public ``mesh_*`` entry is a finding too — the
    entry table is the coverage contract."""
    from .registry import unregistered_entry_points

    findings = [Finding("unregistered-entry", name,
                        "public mesh entry point is not in crdt_tpu_torch.analysis.registry's "
                        "entry table — the program checks cannot see it")
                for name in unregistered_entry_points()]
    mesh = gate_mesh(device) if mesh is None else mesh
    for name, (ep, trace, n_leaves) in entry_traces(mesh, names).items():
        if isinstance(trace, Exception):
            findings.append(Finding("entry-error", name, f"{type(trace).__name__}: {trace}"))
            continue
        findings += lint_trace(trace, name, n_leaves, mesh_shape(mesh), ep.mesh_axes,
                               copied_donations=ep.copies_donated)
    return findings


# ---- δ digest-gate soundness (the gate fixtures) --------------------------
#
# Three committed packet slots per flavor, spanning the decision table:
#
#   slot 0  removal-carrying, digest-covered  -> MUST ship (a top digest can
#           never prove the receiver knows a removal)
#   slot 1  add-only, digest-covered          -> MUST be masked (an
#           always-keep gate is dead weight)
#   slot 2  add-only, NOT covered             -> MUST ship (masking
#           undelivered content is silent data loss)

def _u32(rows, device) -> torch.Tensor:
    from .._dtypes import from_wide

    return from_wide(torch.tensor(rows, dtype=torch.int64, device=device), torch.uint32)


def _gate_verdicts(label: str, kept, masked_detail: str) -> List[Finding]:
    kept = [bool(x) for x in kept.cpu().tolist()]
    findings: List[Finding] = []
    if not kept[0]:
        findings.append(Finding(
            "gate-removal-dropped", label,
            "a removal-carrying slot (context above its content's witness dots) was masked by "
            "a top digest — a digest can never prove the receiver knows a removal; this gate "
            "resurrects removed entries under partition/replay"))
    if kept[1]:
        findings.append(Finding("gate-mask-ineffective", label, masked_detail))
    if not kept[2]:
        findings.append(Finding(
            "gate-overmask", label,
            "an uncovered add-only slot (content above the receiver's digest) was masked — "
            "undelivered content dropped on the wire, replicas cannot converge"))
    return findings


def orswot_gate_fixture(device="cuda") -> Tuple[object, torch.Tensor]:
    """The orswot-flavor packet (rows ``[[1,0],[1,0],[7,0]]``, contexts
    ``[[2,0],[1,0],[7,0]]``) and the receiver's digest ``[5, 5]``."""
    from ..parallel.delta import DeltaPacket

    pkt = DeltaPacket(
        idx=torch.arange(3, dtype=torch.int32, device=device),
        rows=_u32([[1, 0], [1, 0], [7, 0]], device),
        ctxs=_u32([[2, 0], [1, 0], [7, 0]], device),
        valid=torch.ones((3,), dtype=torch.bool, device=device),
        dcl=_u32([[0, 0], [0, 0]], device),
        dmask=torch.zeros((2, 4), dtype=torch.bool, device=device),
        dvalid=torch.zeros((2,), dtype=torch.bool, device=device),
    )
    return pkt, _u32([5, 5], device)


def map_gate_fixture(device="cuda") -> Tuple[object, torch.Tensor]:
    """The map-flavor packet: per-key knowledge (the content slots'
    witness dots) ``[[1,0],[1,0],[7,0]]``, the same contexts and digest."""
    from .._dtypes import bits
    from ..ops.mvreg import empty as mv_empty
    from ..parallel.delta_map import MapDeltaPacket

    child = mv_empty(2, 2, batch=(3,), device=device)
    wctr = _u32([1, 1, 7], device)
    wctr_plane, clk, valid = bits(child.wctr).clone(), bits(child.clk).clone(), child.valid.clone()
    wctr_plane[:, 0] = bits(wctr)
    clk[:, 0, 0] = bits(wctr)
    valid[:, 0] = True
    child = child._replace(wctr=wctr_plane.view(torch.uint32), clk=clk.view(torch.uint32),
                           valid=valid)
    pkt = MapDeltaPacket(
        idx=torch.arange(3, dtype=torch.int32, device=device), child=child,
        ctxs=_u32([[2, 0], [1, 0], [7, 0]], device),
        valid=torch.ones((3,), dtype=torch.bool, device=device),
        dcl=_u32([[0, 0], [0, 0]], device),
        dkeys=torch.zeros((2, 4), dtype=torch.bool, device=device),
        dvalid=torch.zeros((2,), dtype=torch.bool, device=device),
    )
    return pkt, _u32([5, 5], device)


def check_orswot_gate(gate, label: str = "delta.gate_delta", device="cuda") -> List[Finding]:
    """Prove one orswot-flavor δ digest gate removal-preserving (and
    actually masking) on the committed three-slot fixture."""
    pkt, digest = orswot_gate_fixture(device)
    return _gate_verdicts(
        label, gate(pkt, digest).valid,
        "a digest-covered add-only slot (ctx == rows <= digest) was NOT masked — the gate "
        "never strips redundant payload, so digest gating is dead weight on the wire")


def check_map_gate(gate, label: str = "delta_map.gate_delta_map", device="cuda"
                   ) -> List[Finding]:
    """The map-flavor twin: knowledge is the content slots' witness dots
    (``delta_map._key_knowledge``), not raw rows."""
    pkt, digest = map_gate_fixture(device)
    return _gate_verdicts(
        label, gate(pkt, digest).valid,
        "a digest-covered add-only key (ctx == witness knowledge <= digest) was NOT masked — "
        "the map gate never strips redundant payload")


def check_nested_lift(label: str = "delta_nest.nested_gate", device="cuda") -> List[Finding]:
    """The nested lift must gate ONLY the core packet and pass the level's
    parked-keyset buffer through bit-identically — parked rm clocks are
    their own context; gating them would drop removal knowledge
    mid-ring."""
    from .._dtypes import bits
    from ..parallel.delta import gate_delta
    from ..parallel.delta_nest import NestedDeltaPacket, nested_gate

    core, digest = orswot_gate_fixture(device)
    dcl = _u32([[3, 1], [0, 2]], device)
    dkeys = torch.tensor([[True, False], [False, True]], device=device)
    dvalid = torch.tensor([True, True], device=device)
    out = nested_gate(gate_delta)(NestedDeltaPacket(core, dcl, dkeys, dvalid), digest)
    findings = _gate_verdicts(label, out.core.valid,
                              "the lifted core gate stopped masking covered add-only slots")
    if not torch.equal(out.core.valid, gate_delta(core, digest).valid):
        findings.append(Finding(
            "gate-nested-core", label,
            "the lift changed the core gate's verdicts — nested_gate must be "
            "semantics-preserving on the core packet"))
    for name, got, wanted in (("dcl", out.dcl, dcl), ("dkeys", out.dkeys, dkeys),
                              ("dvalid", out.dvalid, dvalid)):
        if not torch.equal(bits(got), bits(wanted)):
            findings.append(Finding(
                "gate-nested-buffer", label,
                f"the parked-keyset buffer leaf {name!r} was modified by the lift — parked rm "
                "clocks must ride whole"))
    return findings


def check_gates(device="cuda") -> List[Finding]:
    """All of the port's δ digest-gate flavors, proven on the committed
    gate fixtures (the ``jit-lint`` section)."""
    from ..parallel.delta import gate_delta
    from ..parallel.delta_map import gate_delta_map

    return (check_orswot_gate(gate_delta, device=device)
            + check_map_gate(gate_delta_map, device=device)
            + check_nested_lift(device=device))


# ---- the twins: each detector proven firing ------------------------------

# Each twin and the checks it must fire on ``device`` (empty: the honest
# twin, which must stay clean).
TWINS = {
    "kernel_traced_branch": {"traced-branch"},
    "kernel_unstable_sort": {"unstable-sort"},
    "kernel_float_accum": {"float-accum"},
    "kernel_exact_bool_accum": set(),
    "kernel_u8_counter": {"dtype-overflow"},
    "kernel_narrowing_convert": {"dtype-overflow"},
    "donating_reshape": {"donation-alias"},
    "donating_aligned": set(),
    "collective_bad_ppermute": {"ppermute-perm"},
    "collective_good_ppermute": set(),
    "collective_wrong_axis": {"collective-axis"},
    "collective_wrong_axis@replica": set(),
    "collective_read_after_donation": {"donated-read-after-collective"},
    "collective_read_before_donation": set(),
    "gate_top_covered_unsound": {"gate-removal-dropped"},
    "gate_keeps_everything": {"gate-mask-ineffective"},
    "gate_drops_everything": {"gate-removal-dropped", "gate-overmask"},
}


def twin_checks(device="cuda") -> Dict[str, List[str]]:
    """Every twin of :data:`TWINS` linted on ``device``: ``{name: sorted
    fired checks}``."""
    from . import fixtures as fx

    mesh = gate_mesh(device)
    u32 = torch.arange(8, dtype=torch.int32, device=device).view(torch.uint32)

    def checks(found):
        return sorted({f.check for f in found})

    def kernel(fn, *args):
        return checks(lint_callable(fn, args))

    def collective(name, allowed=(REPLICA, ELEMENT), donated=0):
        fn, args = getattr(fx, name)(mesh)
        return checks(lint_callable(fn, args, n_donated_leaves=donated,
                                    axis_sizes=mesh_shape(mesh), allowed_axes=allowed))

    out = {
        "kernel_traced_branch": kernel(fx.kernel_traced_branch, u32),
        "kernel_unstable_sort": kernel(fx.kernel_unstable_sort, u32),
        "kernel_float_accum": kernel(fx.kernel_float_accum, u32),
        "kernel_exact_bool_accum": kernel(
            fx.kernel_exact_bool_accum, torch.ones((4, 4), dtype=torch.bool, device=device),
            torch.ones((4, 8), dtype=torch.bool, device=device)),
        "kernel_u8_counter": kernel(fx.kernel_u8_counter,
                                    torch.zeros(4, dtype=torch.uint8, device=device)),
        "kernel_narrowing_convert": kernel(fx.kernel_narrowing_convert, u32),
    }
    for name in ("donating_reshape", "donating_aligned"):
        fn, args = getattr(fx, name)(device=device)
        out[name] = checks(lint_callable(fn, args, n_donated_leaves=1))
    for name in ("collective_bad_ppermute", "collective_good_ppermute"):
        out[name] = collective(name)
    out["collective_wrong_axis"] = collective("collective_wrong_axis", allowed=(ELEMENT,))
    out["collective_wrong_axis@replica"] = collective("collective_wrong_axis",
                                                      allowed=(REPLICA,))
    for name in ("collective_read_after_donation", "collective_read_before_donation"):
        out[name] = collective(name, donated=1)
    out["gate_top_covered_unsound"] = checks(check_orswot_gate(
        fx.gate_top_covered_unsound, "fixtures.gate_top_covered_unsound", device=device))
    out["gate_keeps_everything"] = checks(check_orswot_gate(
        lambda pkt, digest: pkt, "keep-everything gate", device=device))
    out["gate_drops_everything"] = checks(check_orswot_gate(
        lambda pkt, digest: pkt._replace(valid=torch.zeros_like(pkt.valid)),
        "drop-everything gate", device=device))
    return out


def missed_twins(fired: Dict[str, List[str]]) -> List[Finding]:
    """A ``broken-fixture-missed`` finding for every twin of :data:`TWINS`
    whose fired checks are not the ones it must fire."""
    return [Finding("broken-fixture-missed", name,
                    f"fired {fired.get(name)}, must fire {sorted(want)} — "
                    + ("the detector has no teeth" if want else "the honest twin is flagged"))
            for name, want in TWINS.items() if set(fired.get(name, ())) != want]


__all__ = [
    "TWINS", "check_gates", "check_map_gate", "check_nested_lift", "check_orswot_gate",
    "copies_of", "entry_traces", "gate_mesh", "host_reads", "lint_callable", "lint_entry_points",
    "lint_trace", "map_gate_fixture", "mesh_shape", "missed_twins", "orswot_gate_fixture",
    "twin_checks",
]
