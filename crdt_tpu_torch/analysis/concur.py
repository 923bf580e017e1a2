"""Declared happens-before contracts over the host serving runtime — the
port of the JAX package's ``analysis/concur.py``, proved over the port's
own serve and fan-out modules.

The serving loop's ordering invariants used to live in prose — "the
WAL group-commit precedes the scatter", "persist THEN clear", "the
push chunk pins its tenants across gather…dispatch" — plus one
scattered AST detector (``serve.wal.wal_precedes_dispatch``). This
module makes them one machine-checked table, :data:`HB_CONTRACTS`:
each entry names the edge, the shared fields it orders, and an
executable check (an AST order/guard proof or a runtime micro-probe).

On top of the contracts sits the conflict checker
(:func:`uncovered_conflicts`): using the effect table inferred by
``analysis/effects.py`` and the logical-thread map below, every
conflicting access pair (two threads touch a shared field, at least
one writes) must be ordered by same-thread program order, a lock
guard declared at registration (``guard="lock:..."``), or a declared
HB edge — otherwise the checker reports the two code sites and the
unordered field. A background drain that starts freeing lanes
(``analysis.fixtures.PersistFreesLanes``) shows up here as an
uncovered ``lane_of`` conflict, NOT as a fuzz flake three PRs later.

The ``concurrency`` static-check section (``analysis/run.py``) runs:
effect-coverage discovery, every HB contract, the conflict
checker, the broken twins, the retry/thread lints below, and the
deterministic interleaving explorer (``analysis/interleave.py``).
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

from . import effects as _effects
from . import registry as _registry
from ..utils.metrics import metrics
from .registry import call_name as _call_name

# ---- logical threads -----------------------------------------------------
#
# The serving runtime's execution contexts. Everything the driver loop
# runs inline (ingest, dispatch, eviction, fanout pushes) is ONE
# logical thread — program order covers its conflicts; the contracts
# below pin the orders that matter within it. The background persister
# and client acks are the genuinely concurrent contexts, and the
# tracer is stamped from all of them (its fields declare a lock guard
# instead).

_THREAD_RULES: Tuple[Tuple[str, Tuple[Tuple[str, str], ...]], ...] = (
    ("persist", (("BackgroundPersister", "drain"), ("Evictor", "persist"))),
    ("client", (("FanoutPlane", "ack"),)),
)
_ALL_THREADS = ("driver", "persist", "client")


def threads_of(owner: str, method: str) -> Tuple[str, ...]:
    """The logical threads an (owner, method) body may run on.
    ``Evictor.persist`` runs on BOTH the driver (evict path) and the
    background persister; the tracer runs wherever a stamp happens."""
    if owner == "Tracer":
        return _ALL_THREADS
    out = ["driver"] if (owner, method) not in {
        ("BackgroundPersister", "drain"), ("FanoutPlane", "ack"),
    } else []
    for name, members in _THREAD_RULES:
        if (owner, method) in members:
            out.append(name)
    return tuple(out)


# ---- AST helpers (order + guard proofs) ----------------------------------


def _tree_of(obj) -> ast.AST:
    src = textwrap.dedent(inspect.getsource(obj))
    return ast.parse(src)


def call_order_violations(obj, first, then) -> List[str]:
    """The generalized WAL-before-dispatch walk: AST-scan ``obj`` for functions that call both a
    ``first``-set and a ``then``-set name, and return a violation per
    function whose earliest ``then`` site precedes its earliest
    ``first`` site. Empty list = the declared order holds everywhere
    it applies."""
    first, then = frozenset(first), frozenset(then)
    try:
        tree = _tree_of(obj)
    except (OSError, TypeError, SyntaxError) as exc:
        return [f"{getattr(obj, '__name__', obj)}: unscannable ({exc})"]
    out: List[str] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        f_lines = []
        t_lines = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _call_name(sub)
                if name in first:
                    f_lines.append(sub.lineno)
                elif name in then:
                    t_lines.append(sub.lineno)
        if f_lines and t_lines and min(t_lines) < min(f_lines):
            out.append(
                f"{node.name}: {sorted(then)} call at line {min(t_lines)} "
                f"precedes {sorted(first)} at line {min(f_lines)}"
            )
    return out


def calls_missing_kwarg(obj, call_name: str, kw: str) -> List[str]:
    """Guard proof: every call of ``call_name`` inside ``obj`` must
    pass keyword ``kw`` (the pin-set discipline — ``restore(...,
    _exclude=pins)``). Returns a violation per bare call."""
    try:
        tree = _tree_of(obj)
    except (OSError, TypeError, SyntaxError) as exc:
        return [f"{getattr(obj, '__name__', obj)}: unscannable ({exc})"]
    out: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _call_name(node) == call_name:
            if not any(k.arg == kw for k in node.keywords):
                out.append(
                    f"{getattr(obj, '__name__', obj)}: {call_name}() at "
                    f"line {node.lineno} without {kw}= — an unpinned "
                    f"pressure eviction can free an in-flight lane"
                )
    return out


def _contains_raise(obj) -> bool:
    try:
        tree = _tree_of(obj)
    except (OSError, TypeError, SyntaxError):
        return False
    return any(isinstance(n, ast.Raise) for n in ast.walk(tree))


# ---- runtime micro-probes ------------------------------------------------


def ack_window_probe(plane_cls, device="cuda") -> List[str]:
    """Runtime proof of the ack-promotion clamp: build a tiny plane
    from ``plane_cls`` over a superblock on ``device``, ship version 3 to
    a subscriber sitting at watermark 2, then replay a STALE ack (1) and
    an OVERCLAIMING ack (5). The honest
    :class:`~crdt_tpu_torch.fanout.plane.FanoutPlane` clamps every
    promotion to ``[watermark, shipped]`` (plane.py's ``ack``); a
    regressing promoter (``analysis.fixtures.regressing_ack_promoter_cls``)
    fails here."""
    from ..parallel.mesh import VirtualMesh
    from ..serve.superblock import Superblock

    sb = Superblock(
        2, VirtualMesh(1, device), kind="orswot",
        caps=dict(n_elems=4, n_actors=2, deferred_cap=2),
    )
    plane = plane_cls(sb, window_cap=4, dispatch_lanes=1, capacity=4)
    (sid,) = plane.subscribe([0]).tolist()
    plane.sub_ver[sid] = 2
    plane.sub_pend[sid] = 3
    out: List[str] = []
    plane.ack([sid], versions=[1])  # stale duplicate, must not regress
    if int(plane.sub_ver[sid]) != 2:
        out.append(
            f"stale ack(1) moved sub_ver 2 -> {int(plane.sub_ver[sid])} — "
            f"promotion regressed below the acked watermark"
        )
    if int(plane.sub_pend[sid]) != 3:
        out.append("stale ack(1) cleared the pending ship mark")
    plane.sub_ver[sid] = 2
    plane.sub_pend[sid] = 3
    plane.ack([sid], versions=[5])  # claim above anything shipped
    if int(plane.sub_ver[sid]) != 3:
        out.append(
            f"overclaiming ack(5) set sub_ver {int(plane.sub_ver[sid])} — "
            f"must clamp to the shipped version 3"
        )
    return out


def requeue_seq_probe(tracer_cls) -> List[str]:
    """Runtime proof that a loss-free requeue KEEPS the durable WAL
    seq (first seq wins — trace.py's ``requeue``): an op rolled out of
    a group-committed slab re-dispatches under the id its durable
    record already carries."""
    tick = iter(range(1, 100))
    tr = tracer_cls(sample=1, clock_ns=lambda: next(tick) * 1000)
    tr.stamp("submit", tenant=0)
    tr.stamp("coalesce", tenants=[0])
    tr.requeue([0], seq=7)
    tr.stamp("coalesce", tenants=[0])
    tr.requeue([0], seq=9)
    out: List[str] = []
    open_traces = tr._open.get(0, [])
    if not open_traces:
        return ["requeue dropped the open trace entirely"]
    got = open_traces[0].wal_seq
    if got != 7:
        out.append(
            f"re-queued trace carries wal_seq {got}, expected the FIRST "
            f"durable seq 7 (sticky across requeues)"
        )
    if [s for s, _ in open_traces[0].stamps] != ["submit"]:
        out.append("requeue did not roll the trace back to its submit stamp")
    return out


# ---- the contract table --------------------------------------------------


@dataclass(frozen=True)
class HBContract:
    """One declared happens-before edge: ``rule`` is the prose
    invariant, ``fields`` the shared fields the edge orders, ``orders``
    the cross-thread pairs it covers in the conflict checker (empty =
    an intra-driver ordering whose value is the check itself), and
    ``check`` an executable proof returning violations (empty list =
    the edge holds; a probe builds its world on ``check(device=...)``)."""

    name: str
    rule: str
    kind: str  # "order" | "guard" | "probe"
    fields: Tuple[str, ...]
    check: Callable[..., List[str]]
    orders: Tuple[Tuple[str, str], ...] = ()


def _check_wal_precedes_dispatch(device="cuda") -> List[str]:
    from ..serve.ingest import IngestQueue
    from ..serve.loop import ServeLoop
    from ..serve.wal import wal_order_violations

    return wal_order_violations(IngestQueue) + wal_order_violations(ServeLoop)


def _check_settled_window(device="cuda") -> List[str]:
    from ..serve.loop import ServeLoop

    return (
        call_order_violations(ServeLoop.step, {"_finish"}, {"drain"})
        + call_order_violations(ServeLoop.step, {"drain"}, {"_issue"})
    )


def _check_persist_precedes_clear(device="cuda") -> List[str]:
    from ..serve.evict import Evictor

    return call_order_violations(
        Evictor.evict, {"persist", "persist_tenant"},
        {"release_lane", "clear_lanes"},
    )


def _check_pin_gather_dispatch(device="cuda") -> List[str]:
    from ..fanout.plane import FanoutPlane
    from ..serve.ingest import IngestQueue

    out = calls_missing_kwarg(FanoutPlane.push, "_ensure_resident",
                              "_exclude")
    out += calls_missing_kwarg(IngestQueue._assemble, "restore", "_exclude")
    out += call_order_violations(
        FanoutPlane.push, {"_ensure_resident"}, {"_snapshot"}
    )
    for m in (FanoutPlane._snapshot, FanoutPlane._dispatch):
        if not _contains_raise(m):
            out.append(
                f"FanoutPlane.{m.__name__} has no residency guard — a "
                f"-1 lane would wrap to another tenant's row"
            )
    return out


def _check_ack_clamp(device="cuda") -> List[str]:
    from ..fanout.plane import FanoutPlane

    return ack_window_probe(FanoutPlane, device=device)


def _check_requeue_seq(device="cuda") -> List[str]:
    from ..obs.trace import Tracer

    return requeue_seq_probe(Tracer)


def _check_touch_before_pick(device="cuda") -> List[str]:
    from ..fanout.plane import FanoutPlane
    from ..serve.evict import Evictor

    out = calls_missing_kwarg(Evictor.restore, "select_cold", "exclude")
    out += calls_missing_kwarg(FanoutPlane._ensure_resident, "restore",
                               "_exclude")
    # A push/ingest touch must land before the NEXT pressure pick can
    # run — i.e. restore refreshes recency via note_touch.
    if "note_touch" not in inspect.getsource(FanoutPlane._ensure_resident):
        out.append(
            "FanoutPlane._ensure_resident never touches recency — "
            "fan-out-restored tenants would thrash the cold list"
        )
    return out


HB_CONTRACTS: Tuple[HBContract, ...] = (
    HBContract(
        name="wal_commit_precedes_dispatch",
        rule="WAL group-commit ≺ scatter: every logging dispatcher "
             "appends the slab to the serve WAL before issuing it",
        kind="order",
        fields=("wal", "last_wal_seq", "state"),
        check=_check_wal_precedes_dispatch,
    ),
    HBContract(
        name="persist_in_settled_window",
        rule="background drain runs only in the settled window: "
             "finish(N) ≺ drain ≺ issue(N+1), so a persist never reads "
             "an in-flight row",
        kind="order",
        fields=("state", "dirty", "_queue", "_queued", "persisted", "hist"),
        check=_check_settled_window,
        orders=(("driver", "persist"),),
    ),
    HBContract(
        name="persist_precedes_clear",
        rule="persist ≺ clear: an evicting tenant's dirty row reaches "
             "the durable tier before its lane is freed and zeroed",
        kind="order",
        fields=("dirty", "was_evicted", "lane_of", "tenant_of", "_free",
                "state"),
        check=_check_persist_precedes_clear,
    ),
    HBContract(
        name="pin_precedes_gather_dispatch",
        rule="pin ≺ gather…dispatch: a push chunk pins its whole "
             "tenant set before warming lanes, and snapshot/dispatch "
             "refuse a lane that lost residency mid-cycle",
        kind="guard",
        fields=("lane_of", "tenant_of", "_free", "state", "ver", "_bases",
                "dirt", "dirty", "was_evicted", "caps", "widen_events"),
        check=_check_pin_gather_dispatch,
    ),
    HBContract(
        name="ack_clamped_to_window",
        rule="ack promotion clamps to [watermark, shipped]: a stale "
             "ack never regresses sub_ver, an overclaim never exceeds "
             "sub_pend",
        kind="probe",
        fields=("sub_ver", "sub_pend", "sub_tenant"),
        check=_check_ack_clamp,
        orders=(("driver", "client"),),
    ),
    HBContract(
        name="requeue_preserves_durable_seq",
        rule="requeue preserves the durable seq: a loss-free roll-back "
             "keeps the FIRST WAL record id the op group-committed "
             "under",
        kind="probe",
        fields=("_open", "requeued"),
        check=_check_requeue_seq,
    ),
    HBContract(
        name="touch_precedes_pressure_pick",
        rule="touch ≺ pressure-evict pick: recency is refreshed before "
             "any cold pick, and every pick excludes the pinned "
             "in-flight set",
        kind="guard",
        fields=("last_touch", "clock", "touch_count"),
        check=_check_touch_before_pick,
    ),
)


def check_hb_contracts(
    contracts: Sequence[HBContract] = HB_CONTRACTS, device="cuda",
) -> List[Tuple[str, str]]:
    """Run every contract's executable proof (the probes on ``device``);
    ``(contract, violation)`` rows, empty when all declared edges hold."""
    out: List[Tuple[str, str]] = []
    for c in contracts:
        for v in c.check(device=device):
            out.append((c.name, v))
    return out


# ---- the conflict checker ------------------------------------------------


def uncovered_conflicts(
    extra: Tuple = (),
    extra_threads: Dict[str, Tuple[str, ...]] = None,
) -> List[str]:
    """Prove every conflicting effect pair on a shared field ordered.

    For each registered shared field, collect the (thread, mode, site)
    accesses from the inferred effect table. A conflict is two
    DIFFERENT logical threads touching the field with at least one
    write; it is covered by (a) a ``lock:`` guard declared at
    registration, or (b) a declared :data:`HB_CONTRACTS` edge naming
    the field AND the thread pair in ``orders``. Anything else is
    reported with both code sites — the two lines a reviewer must
    reconcile.

    ``extra`` passes twin classes through the effect inference;
    ``extra_threads`` maps a twin owner name to the logical threads
    its methods run on (``{"PersistFreesLanes": ("persist",)}``)."""
    extra_threads = dict(extra_threads or {})
    guards = {
        (sf.owner, sf.name): sf.guard for sf in _registry.shared_fields()
    }
    covered_pairs: Dict[str, set] = {}
    for c in HB_CONTRACTS:
        for f in c.fields:
            covered_pairs.setdefault(f, set()).update(
                frozenset(p) for p in c.orders
            )
    per_field: Dict[str, Dict[str, List[Tuple[str, str, str]]]] = {}
    for e in _effects.infer_effects(extra=extra):
        if not e.owner:
            continue
        threads = extra_threads.get(e.owner) or threads_of(e.owner, e.method)
        for th in threads:
            per_field.setdefault(e.field, {}).setdefault(th, []).append(
                (e.mode, f"{e.owner}.{e.method}", e.site)
            )
    out: List[str] = []
    for fld in sorted(per_field):
        by_thread = per_field[fld]
        if len(by_thread) < 2:
            continue
        writers = {
            th for th, acc in by_thread.items()
            if any(m == "write" for m, _, _ in acc)
        }
        if not writers:
            continue
        if any(
            g.startswith("lock:")
            for (own, name), g in guards.items() if name == fld
        ):
            continue
        threads = sorted(by_thread)
        for i, a in enumerate(threads):
            for b in threads[i + 1:]:
                if a not in writers and b not in writers:
                    continue
                if frozenset((a, b)) in covered_pairs.get(fld, set()):
                    continue
                sa = next(
                    (x for x in by_thread[a] if x[0] == "write"),
                    by_thread[a][0],
                )
                sb_ = next(
                    (x for x in by_thread[b] if x[0] == "write"),
                    by_thread[b][0],
                )
                out.append(
                    f"field '{fld}': {a}-thread {sa[0]} by {sa[1]} "
                    f"({sa[2]}) vs {b}-thread {sb_[0]} by {sb_[1]} "
                    f"({sb_[2]}) — no lock guard and no HB contract "
                    f"orders ({a}, {b})"
                )
    metrics.count("concur.hb_violations", len(out))
    return out


# ---- retry/thread lints (the faults satellite) ---------------------------


#: The multihost exchanges (the JAX ``_COLLECTIVE_CALLS`` names the port
#: has) and the ``torch.distributed`` calls ``parallel/multihost.py``
#: makes: a peer process waits inside each.
_MULTIHOST_CALLS = frozenset({
    "_allgather_host", "allgather_host", "sync_tenant_rows", "sync_list", "all_gather",
    "_all_gather", "_sendrecv", "isend", "recv",
})


def _collective_calls() -> frozenset:
    """The port's collectives: every public function of
    ``parallel/collectives.py`` (the ring shifts and reductions a rank's
    peers wait inside) and the multihost exchanges."""
    from ..parallel import collectives

    return frozenset(collectives.__all__) | _MULTIHOST_CALLS


def _collective_reachers(tree: ast.AST) -> set:
    """Function names in ``tree`` (module-level AND nested) whose body
    transitively reaches a collective call, resolved within the
    module."""
    coll = _collective_calls()
    bodies: Dict[str, List[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bodies[node.name] = [
                _call_name(sub) for sub in ast.walk(node)
                if isinstance(sub, ast.Call)
            ]
    reach = {
        n for n, calls in bodies.items()
        if any(c in coll for c in calls)
    }
    changed = True
    while changed:
        changed = False
        for n, calls in bodies.items():
            if n not in reach and any(c in reach for c in calls):
                reach.add(n)
                changed = True
    return reach


def _static_timeout(call: ast.Call) -> bool:
    """True when a with_retries call site pins a per-attempt timeout
    STATICALLY: a direct ``timeout=`` keyword, or an inline
    ``RetryPolicy(..., timeout=<non-None literal>)`` argument."""
    for kw in call.keywords:
        if kw.arg == "timeout" and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None
        ):
            return True
    for arg in list(call.args) + [k.value for k in call.keywords]:
        if isinstance(arg, ast.Call) and _call_name(arg) == "RetryPolicy":
            for kw in arg.keywords:
                if kw.arg == "timeout" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is None
                ):
                    return True
    return False


def retry_timeout_collective_violations(objs: Tuple = ()) -> List[str]:
    """Flag every ``with_retries(...)`` call site that BOTH pins a
    per-attempt timeout statically and hands over a callee reaching a
    collective of ``parallel/collectives.py`` — a timed-out attempt
    would leave peers stranded inside the collective while this host
    retries (the lockstep-attempt rule, faults/retry.py docstring).
    Scans the port's parallel package by default; ``objs`` scans twin
    sources instead."""
    import importlib
    import pkgutil

    trees: List[ast.AST] = []
    if objs:
        for o in objs:
            trees.append(_tree_of(o))
    else:
        par = importlib.import_module("crdt_tpu_torch.parallel")
        for info in pkgutil.iter_modules(par.__path__):
            mod = importlib.import_module(f"{par.__name__}.{info.name}")
            try:
                trees.append(ast.parse(inspect.getsource(mod)))
            except (OSError, TypeError, SyntaxError):
                continue
    out: List[str] = []
    for tree in trees:
        reach = _collective_reachers(tree)
        for node in ast.walk(tree):
            if (not isinstance(node, ast.Call)
                    or _call_name(node) != "with_retries" or not node.args):
                continue
            callee = node.args[0]
            callee_name = (
                callee.id if isinstance(callee, ast.Name)
                else callee.attr if isinstance(callee, ast.Attribute) else ""
            )
            if callee_name in reach and _static_timeout(node):
                out.append(
                    f"with_retries at line {node.lineno} pins a "
                    f"per-attempt timeout around '{callee_name}', which "
                    f"reaches a collective — a timed-out "
                    f"attempt would desynchronize the lockstep exchange"
                )
    return out


def thread_lint_violations(
    extra_sources: Tuple[Tuple[str, str], ...] = (),
) -> List[str]:
    """Every ``threading.Thread`` created under ``crdt_tpu_torch/`` must
    be daemon (cannot wedge interpreter shutdown), named (debuggable in a
    stack dump), and live in a module with a row in
    ``registry.EFFECT_SOURCES`` (a thread nobody declared is a thread
    whose shared-field effects nobody analyzed)."""
    import os

    registered_modules = {
        src.module for src in _registry.effect_sources()
    }
    out: List[str] = []
    for tree, rel in _registry.parse_sources(extra_sources):
        mod = rel[:-3].replace(os.sep, ".") if rel.endswith(".py") else rel
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or _call_name(node) != "Thread":
                continue
            kwargs = {k.arg: k.value for k in node.keywords}
            site = f"{rel}:{node.lineno}"
            daemon = kwargs.get("daemon")
            if not (isinstance(daemon, ast.Constant)
                    and daemon.value is True):
                out.append(f"{site}: Thread without daemon=True")
            if "name" not in kwargs:
                out.append(f"{site}: Thread without a name")
            if mod not in registered_modules:
                out.append(
                    f"{site}: Thread in module '{mod}' never registered "
                    f"as an effect source (registry.EFFECT_SOURCES)"
                )
    return out


__all__ = [
    "HBContract", "HB_CONTRACTS", "ack_window_probe",
    "call_order_violations", "calls_missing_kwarg", "check_hb_contracts",
    "requeue_seq_probe", "retry_timeout_collective_violations",
    "thread_lint_violations", "threads_of", "uncovered_conflicts",
]
