"""MerkleReg — content-addressed merkle-DAG register.

Reference: src/merkle_reg.rs ``MerkleReg<T> { leaves: BTreeSet<Hash>, dag:
BTreeMap<Hash, Node<T>>, orphans }`` with ``Node { value, parents }``,
``write(value, parents) -> Node``, ``read() -> Content<T>`` (the current
concurrent leaves); Hash = 32 bytes of SHA-3 (SURVEY.md §3 row 15). Nodes
whose parents have not arrived yet are buffered in ``orphans`` and spliced
in when the missing parent lands (out-of-order delivery support).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Set

from ..traits import CmRDT, CvRDT

Hash = bytes  # 32-byte SHA3-256 digest


def _canonical_bytes(value: Any) -> bytes:
    """Stable, injective byte encoding for hashing (tag + length-prefix
    framing so composite values cannot collide). The reference hashes the
    serde encoding."""

    def frame(tag: bytes, payload: bytes) -> bytes:
        return tag + len(payload).to_bytes(8, "big") + payload

    if isinstance(value, bytes):
        return frame(b"b", value)
    if isinstance(value, bool):  # before int: bool is an int subclass
        return frame(b"?", b"1" if value else b"0")
    if isinstance(value, str):
        return frame(b"s", value.encode("utf-8"))
    if isinstance(value, int):
        return frame(b"i", str(value).encode())
    if isinstance(value, float):
        # CPython float repr is the shortest round-tripping IEEE-754
        # decimal — stable across processes and platforms.
        return frame(b"f", repr(value).encode())
    if isinstance(value, (tuple, list)):
        return frame(b"l", b"".join(_canonical_bytes(v) for v in value))
    if isinstance(value, (set, frozenset)):
        return frame(b"e", b"".join(sorted(_canonical_bytes(v) for v in value)))
    if isinstance(value, dict):
        items = sorted(
            (_canonical_bytes(k), _canonical_bytes(v)) for k, v in value.items()
        )
        return frame(b"d", b"".join(k + v for k, v in items))
    if value is None:
        return frame(b"n", b"")
    raise TypeError(
        f"cannot canonically hash {type(value).__name__}: repr() is not "
        "stable across processes; use bytes/str/int/float/bool/None or "
        "list/tuple/set/dict compositions of them"
    )


@dataclass(frozen=True)
class Node:
    """Reference: src/merkle_reg.rs ``Node { value, parents }``."""

    value: Any
    parents: FrozenSet[Hash] = field(default_factory=frozenset)

    def hash(self) -> Hash:
        h = hashlib.sha3_256()
        for parent in sorted(self.parents):
            h.update(parent)
        h.update(_canonical_bytes(self.value))
        return h.digest()


@dataclass
class Content:
    """Reference: src/merkle_reg.rs ``Content<T>`` — the concurrent
    leaves of the DAG."""

    nodes: Dict[Hash, Node]

    def values(self) -> List[Any]:
        return [n.value for _, n in sorted(self.nodes.items())]

    def hashes(self) -> FrozenSet[Hash]:
        return frozenset(self.nodes)

    def is_empty(self) -> bool:
        return not self.nodes


class MerkleReg(CvRDT, CmRDT):
    __slots__ = ("leaves", "dag", "orphans")

    def __init__(self):
        self.leaves: Set[Hash] = set()
        self.dag: Dict[Hash, Node] = {}
        # missing parent hash -> nodes waiting on it
        self.orphans: Dict[Hash, List[Node]] = {}

    # ---- reads ---------------------------------------------------------
    def read(self) -> Content:
        """Reference: src/merkle_reg.rs ``MerkleReg::read``."""
        return Content(nodes={h: self.dag[h] for h in self.leaves})

    def node(self, hash_: Hash) -> Node:
        return self.dag.get(hash_)

    def parents(self, hash_: Hash) -> Content:
        """The parent nodes of ``hash_``. Reference: src/merkle_reg.rs
        ``MerkleReg::parents``."""
        node = self.dag.get(hash_)
        hashes = node.parents if node else frozenset()
        return Content(nodes={h: self.dag[h] for h in hashes if h in self.dag})

    def children(self, hash_: Hash) -> Content:
        """Reference: src/merkle_reg.rs ``MerkleReg::children``."""
        return Content(
            nodes={
                h: n for h, n in self.dag.items() if hash_ in n.parents
            }
        )

    def num_nodes(self) -> int:
        return len(self.dag)

    def num_orphans(self) -> int:
        return sum(len(v) for v in self.orphans.values())

    # ---- writes --------------------------------------------------------
    def write(self, value: Any, parents: FrozenSet[Hash] = frozenset()) -> Node:
        """Mint (not apply) a node on top of ``parents``.

        Reference: src/merkle_reg.rs ``MerkleReg::write``.
        """
        return Node(value=value, parents=frozenset(parents))

    # ---- CmRDT / CvRDT -------------------------------------------------
    def apply(self, node: Node) -> None:
        h = node.hash()
        if h in self.dag:
            return
        missing = [p for p in node.parents if p not in self.dag]
        if missing:
            # Orphan until the first missing parent arrives.
            self.orphans.setdefault(missing[0], []).append(node)
            return
        self.dag[h] = node
        for parent in node.parents:
            self.leaves.discard(parent)
        # A node enters the dag only after all its parents, so nothing in
        # the dag can already reference h: it is necessarily a leaf.
        self.leaves.add(h)
        # Splice in any orphans that were waiting on this node.
        woken = self.orphans.pop(h, [])
        for orphan in woken:
            self.apply(orphan)

    def merge(self, other: "MerkleReg") -> None:
        for node in other.dag.values():
            self.apply(node)
        for waiting in other.orphans.values():
            for node in waiting:
                self.apply(node)

    # ---- plumbing ------------------------------------------------------
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, MerkleReg)
            and self.dag == other.dag
            and self.leaves == other.leaves
        )

    def clone(self) -> "MerkleReg":
        out = MerkleReg()
        out.leaves = set(self.leaves)
        out.dag = dict(self.dag)
        out.orphans = {k: list(v) for k, v in self.orphans.items()}
        return out

    def __repr__(self) -> str:
        return f"MerkleReg({len(self.dag)} nodes, {len(self.leaves)} leaves)"
