"""Effect inference over the host serving surface — the port of the JAX
package's ``analysis/effects.py``, reading the port's own sources.

The device program is proved by the law engine and the schedule-space
checker; the *host* program — ServeLoop pipelining, the background
persister, fanout pushes and client acks, pressure eviction — is a
concurrent program in its own right, and its correctness argument
starts with knowing WHO TOUCHES WHAT. This module is that first step:
a pure-AST pass over :data:`HOST_SURFACE_MODULES` classifying every
method's reads and writes of the shared-state fields in
:data:`crdt_tpu_torch.analysis.registry.SHARED_FIELDS` (the lane
table, the free pool, the dirty flags, the WAL seq, the sub_ver/ack
windows, ...).

A row is the coverage contract, exactly like the merge kinds and the
flight-recorder events: :func:`unregistered_shared_mutations` finds
every ``self.<field>`` mutated outside ``__init__`` in a surveyed class
whose ``(owner, field)`` has no row — a field
nobody declared is a field whose conflicts nobody analyzed, and it
fails the ``concurrency`` static-check section at discovery time.

The inferred :class:`Effect` rows feed ``analysis/concur.py``, which
checks every cross-thread conflicting pair against the declared
happens-before contracts. Everything here is stdlib-only and parses
source — no instance is constructed, no device code runs.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from . import registry

# The host serving surface surveyed by the ``concurrency`` section.
HOST_SURFACE_MODULES: Tuple[str, ...] = (
    "crdt_tpu_torch.serve.loop",
    "crdt_tpu_torch.serve.ingest",
    "crdt_tpu_torch.serve.evict",
    "crdt_tpu_torch.serve.superblock",
    "crdt_tpu_torch.serve.wal",
    "crdt_tpu_torch.fanout.plane",
    "crdt_tpu_torch.obs.trace",
    "crdt_tpu_torch.faults.retry",
)

# Method names that mutate their receiver in place: a call
# ``self.pending.setdefault(...)`` is a WRITE of ``pending`` even
# though no assignment statement names it.
_MUTATOR_CALLS = frozenset({
    "append", "appendleft", "add", "discard", "remove", "clear",
    "update", "extend", "insert", "setdefault", "pop", "popleft",
    "fill", "rotate",
})


@dataclass(frozen=True)
class Effect:
    """One inferred access: ``owner.method`` reads or writes shared
    field ``field`` at ``site`` (``relpath:lineno``). ``via_self`` is
    True for a direct ``self.field`` access and False for a
    cross-object access reaching the field through another handle
    (``self.sb.dirty[...] = ...`` from the evictor)."""

    owner: str
    method: str
    field: str
    mode: str  # "read" | "write"
    site: str
    via_self: bool = True


def _module_tree(mod_name: str) -> Tuple[ast.AST, str]:
    mod = importlib.import_module(mod_name)
    src = inspect.getsource(mod)
    rel = os.path.relpath(inspect.getsourcefile(mod) or "", os.getcwd())
    return ast.parse(src), rel


def _obj_tree(obj) -> Tuple[ast.AST, str]:
    src = inspect.getsource(obj)
    # Dedent (methods handed in directly may be indented).
    import textwrap

    rel = os.path.relpath(inspect.getsourcefile(obj) or "<obj>", os.getcwd())
    return ast.parse(textwrap.dedent(src)), rel


def _attr_chain(node: ast.AST) -> List[str]:
    """``self.sb.dirty`` -> ["self", "sb", "dirty"]; [] if the chain
    bottoms out in anything but a bare Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


class _FieldAccessVisitor(ast.NodeVisitor):
    """Collect reads/writes of a fixed name set within one function
    body. Writes: Store/Del-context attributes, attributes inside
    assignment targets (subscript stores like ``self.dirty[t] = x``),
    and in-place mutator calls (``self._free.append(lane)``)."""

    def __init__(self, names: frozenset):
        self.names = names
        self.writes: List[Tuple[str, int, bool]] = []  # (field, line, self?)
        self.reads: List[Tuple[str, int, bool]] = []
        self._written_ids: set = set()

    def _mark_target(self, node: ast.AST) -> None:
        # Only the OUTERMOST attribute of each assigned chain is the
        # written field: ``self.sb.dirty[t] = v`` writes ``dirty``
        # (cross-object), not ``sb``.
        for sub in ast.walk(node):
            tgt: Optional[ast.Attribute] = None
            if (isinstance(sub, ast.Attribute)
                    and not isinstance(sub.ctx, ast.Load)):
                tgt = sub
            elif (isinstance(sub, ast.Subscript)
                    and not isinstance(sub.ctx, ast.Load)):
                inner = sub.value
                while isinstance(inner, ast.Subscript):
                    inner = inner.value
                if isinstance(inner, ast.Attribute):
                    tgt = inner
            if tgt is not None and tgt.attr in self.names:
                chain = _attr_chain(tgt)
                if chain and chain[0] == "self":
                    self.writes.append(
                        (tgt.attr, tgt.lineno, len(chain) == 2)
                    )
                    self._written_ids.add(id(tgt))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._mark_target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._mark_target(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._mark_target(node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._mark_target(t)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in _MUTATOR_CALLS
                and isinstance(f.value, ast.Attribute)
                and f.value.attr in self.names):
            chain = _attr_chain(f.value)
            if chain and chain[0] == "self":
                via_self = len(chain) == 2
                self.writes.append((f.value.attr, f.value.lineno, via_self))
                self._written_ids.add(id(f.value))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (node.attr in self.names and id(node) not in self._written_ids
                and isinstance(node.ctx, ast.Load)):
            chain = _attr_chain(node)
            if chain and chain[0] == "self":
                via_self = len(chain) == 2
                self.reads.append((node.attr, node.lineno, via_self))
        self.generic_visit(node)


def _iter_methods(tree: ast.AST) -> Iterable[Tuple[str, str, ast.AST]]:
    """Yield ``(class_name, method_name, func_node)`` for every method
    of every class in the module tree, plus ``("", name, node)`` for
    module-level functions."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield node.name, sub.name, sub
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield "", node.name, node


_INIT_METHODS = frozenset({"__init__", "__post_init__"})


def infer_effects(extra: Tuple = ()) -> Tuple[Effect, ...]:
    """The inferred effect table: one :class:`Effect` per (method,
    field, mode, line) access of a REGISTERED shared field across the
    surveyed host surface. ``extra`` takes classes or functions (the
    broken twins in ``analysis/fixtures.py``) whose source is scanned
    the same way — their class name is the owner, so a twin's rogue
    writes land in the table without registering anything."""
    names = frozenset(sf.name for sf in registry.shared_fields())
    rows: List[Effect] = []
    trees = [(_module_tree(m)) for m in HOST_SURFACE_MODULES]
    for obj in extra:
        trees.append(_obj_tree(obj))
    for tree, rel in trees:
        for cls, meth, fn in _iter_methods(tree):
            if meth in _INIT_METHODS:
                continue
            v = _FieldAccessVisitor(names)
            for stmt in fn.body if hasattr(fn, "body") else []:
                v.visit(stmt)
            for field, line, via_self in v.writes:
                rows.append(Effect(cls, meth, field, "write",
                                   f"{rel}:{line}", via_self))
            for field, line, via_self in v.reads:
                rows.append(Effect(cls, meth, field, "read",
                                   f"{rel}:{line}", via_self))
    return tuple(rows)


def unregistered_shared_mutations(extra: Tuple = ()) -> List[Tuple[str, str]]:
    """``("Owner.field", site)`` for every DIRECT ``self.<field>``
    mutation outside ``__init__`` in a surveyed class whose
    ``(owner, field)`` has no row in :data:`~crdt_tpu_torch.analysis.registry.SHARED_FIELDS`
    — the discovery gate of the ``concurrency`` static-check section
    (the :func:`~crdt_tpu_torch.analysis.registry.unregistered_obs_events`
    rule for host shared state)."""
    registered = {(sf.owner, sf.name) for sf in registry.shared_fields()}
    out: List[Tuple[str, str]] = []
    trees = [(_module_tree(m)) for m in HOST_SURFACE_MODULES]
    for obj in extra:
        trees.append(_obj_tree(obj))
    for tree, rel in trees:
        for cls, meth, fn in _iter_methods(tree):
            if not cls or meth in _INIT_METHODS:
                continue
            # Match EVERY attribute name (the open-world scan), then
            # keep only direct self.<field> mutations.
            v = _FieldAccessVisitor(frozenset())
            v.names = _AnyName()
            for stmt in fn.body:
                v.visit(stmt)
            for field, line, via_self in v.writes:
                if via_self and (cls, field) not in registered:
                    out.append((f"{cls}.{field}", f"{rel}:{line}"))
    return sorted(set(out))


class _AnyName:
    """A name set that contains every string — lets the discovery gate
    reuse :class:`_FieldAccessVisitor` with an open world."""

    def __contains__(self, item) -> bool:
        return isinstance(item, str)


def shared_field_names() -> frozenset:
    return frozenset(sf.name for sf in registry.shared_fields())


def effects_by_field(
    extra: Tuple = (),
) -> Dict[str, Tuple[Effect, ...]]:
    """The effect table grouped by field name — the shape the
    conflict checker consumes."""
    out: Dict[str, List[Effect]] = {}
    for e in infer_effects(extra):
        out.setdefault(e.field, []).append(e)
    return {k: tuple(v) for k, v in sorted(out.items())}
