"""serde — the storage encoding of CRDT states, ops and payload values;
the port's copy of the JAX package's ``serde.py`` for the types the port
has.

``encode``/``decode`` map to and from a JSON-able tagged tree, and
``to_bytes``/``from_bytes`` give its canonical wire form. The tags and the
JSON are the JAX package's, so a checkpoint's interner items written by
either package decode in the other (``checkpoint._dump`` writes them
through :func:`encode`).

Every encoding is canonical (sorted map/set iteration) so equal states
produce equal bytes. Payload values (actors, members, register values)
may be None/bool/int/float/str/bytes and list/tuple/set/frozenset/dict
compositions — everything is tagged, so tuples, sets and bytes round-trip
exactly (plain JSON would flatten them).

``Map``'s ``val_default`` factory is serialized as a *prototype*: the
encoding of one empty child. Decoding rebuilds the factory as "decode the
prototype again", which round-trips any Val type without naming classes.

Every tag of the JAX package is here: the primitives, ``Dot``/``OrdDot``,
``VClock``, the counters (``GCounter``, ``PNCounter``, ``PNOp``), ``GSet``,
the registers (``LWWReg``/``LWWOp``, ``MVReg``/``Put``), ``Orswot``
(``Add``, ``Rm``), ``Map`` (``Up``, ``MapRm``, ``Nop``), the sequences
(``Identifier``, ``List`` with ``Insert``/``Delete``, ``GList`` with
``GInsert``) and ``MerkleReg`` (``Node``). A blob either package writes
decodes in the other to an equal object.
"""

from __future__ import annotations

import base64
import json
from typing import Any

from .dot import Dot, OrdDot
from .pure.gcounter import GCounter
from .pure.glist import GList
from .pure.glist import Insert as GInsert
from .pure.gset import GSet
from .pure.identifier import Identifier
from .pure.list import Delete, Insert, List
from .pure.lwwreg import UNSET, LWWOp, LWWReg
from .pure.map import Map, MapRm, Nop, Up
from .pure.merkle_reg import MerkleReg, Node
from .pure.mvreg import MVReg, Put
from .pure.orswot import Add, Orswot, Rm
from .pure.pncounter import Dir, PNCounter, PNOp
from .vclock import VClock


def _key(data) -> str:
    """Canonical sort key for encoded forms (order-stable across runs)."""
    return json.dumps(data, sort_keys=True, separators=(",", ":"))


def _sorted(items):
    return sorted(items, key=_key)


def encode(obj: Any):
    """Encode a CRDT state / op / payload value to a JSON-able tree."""
    if obj is None:
        return ["n"]
    if isinstance(obj, bool):
        return ["?", obj]
    if isinstance(obj, int):
        return ["i", str(obj)]  # str: JSON numbers lose >2^53 precision
    if isinstance(obj, float):
        return ["f", repr(obj)]
    if isinstance(obj, str):
        return ["s", obj]
    if isinstance(obj, bytes):
        return ["b", base64.b64encode(obj).decode("ascii")]
    if isinstance(obj, tuple):
        return ["t", [encode(v) for v in obj]]
    if isinstance(obj, list):
        return ["l", [encode(v) for v in obj]]
    if isinstance(obj, (set, frozenset)):
        return ["e", _sorted(encode(v) for v in obj)]
    if isinstance(obj, dict) and type(obj) is dict:
        return ["d", _sorted([encode(k), encode(v)] for k, v in obj.items())]

    if isinstance(obj, OrdDot):
        return ["OrdDot", encode(obj.actor), str(obj.counter)]
    if isinstance(obj, Dot):
        return ["Dot", encode(obj.actor), str(obj.counter)]
    if isinstance(obj, VClock):
        return ["VClock", _sorted([encode(a), str(c)] for a, c in obj.dots.items())]
    if isinstance(obj, GCounter):
        return ["GCounter", encode(obj.inner)]
    if isinstance(obj, PNCounter):
        return ["PNCounter", encode(obj.p), encode(obj.n)]
    if isinstance(obj, PNOp):
        return ["PNOp", encode(obj.dot), obj.dir.value]
    if isinstance(obj, GSet):
        return ["GSet", _sorted(encode(m) for m in obj.value)]
    if isinstance(obj, LWWReg):
        if obj.val is UNSET:
            return ["LWWReg"]
        return ["LWWReg", encode(obj.val), encode(obj.marker)]
    if isinstance(obj, LWWOp):
        return ["LWWOp", encode(obj.val), encode(obj.marker)]
    if isinstance(obj, MVReg):
        return ["MVReg", _sorted([encode(d), encode(c), encode(v)]
                                 for d, (c, v) in obj.vals.items())]
    if isinstance(obj, Put):
        return ["Put", encode(obj.dot), encode(obj.clock), encode(obj.val)]
    if isinstance(obj, Orswot):
        return [
            "Orswot",
            encode(obj.clock),
            _sorted([encode(m), encode(c)] for m, c in obj.entries.items()),
            _sorted([encode(c), _sorted(encode(m) for m in ms)] for c, ms in obj.deferred.items()),
        ]
    if isinstance(obj, Add):
        return ["Add", encode(obj.dot), [encode(m) for m in obj.members]]
    if isinstance(obj, Rm):
        return ["Rm", encode(obj.clock), [encode(m) for m in obj.members]]
    if isinstance(obj, Map):
        return [
            "Map",
            encode(obj.val_default()),  # factory prototype (empty child)
            encode(obj.clock),
            _sorted([encode(k), encode(v)] for k, v in obj.entries.items()),
            _sorted([encode(c), _sorted(encode(k) for k in ks)] for c, ks in obj.deferred.items()),
        ]
    if isinstance(obj, Up):
        return ["Up", encode(obj.dot), encode(obj.key), encode(obj.op)]
    if isinstance(obj, MapRm):
        return ["MapRm", encode(obj.clock), [encode(k) for k in obj.keyset]]
    if isinstance(obj, Nop):
        return ["Nop"]
    if isinstance(obj, Identifier):
        return ["Identifier", [[str(ix), encode(m)] for ix, m in obj.path]]
    if isinstance(obj, List):
        return ["List", [[encode(i), encode(obj.vals[i])] for i in obj.seq], encode(obj.clock)]
    if isinstance(obj, Insert):
        return ["Insert", encode(obj.id), encode(obj.val)]
    if isinstance(obj, Delete):
        return ["Delete", encode(obj.id), encode(obj.dot)]
    if isinstance(obj, GList):
        return ["GList", [encode(i) for i in obj.list]]
    if isinstance(obj, GInsert):
        return ["GInsert", encode(obj.id)]
    if isinstance(obj, Node):
        return ["Node", encode(obj.value),
                sorted(base64.b64encode(p).decode("ascii") for p in obj.parents)]
    if isinstance(obj, MerkleReg):
        dag = sorted(obj.dag.values(), key=lambda n: n.hash())
        orphans = sorted((n for waiting in obj.orphans.values() for n in waiting),
                         key=lambda n: n.hash())
        return ["MerkleReg", [encode(n) for n in dag], [encode(n) for n in orphans]]
    raise TypeError(f"crdt_tpu_torch.serde cannot encode {type(obj).__name__}")


def decode(data) -> Any:
    """Inverse of ``encode``."""
    tag = data[0]
    if tag == "n":
        return None
    if tag == "?":
        return bool(data[1])
    if tag == "i":
        return int(data[1])
    if tag == "f":
        return float(data[1])
    if tag == "s":
        return data[1]
    if tag == "b":
        return base64.b64decode(data[1])
    if tag == "t":
        return tuple(decode(v) for v in data[1])
    if tag == "l":
        return [decode(v) for v in data[1]]
    if tag == "e":
        return frozenset(decode(v) for v in data[1])
    if tag == "d":
        return {decode(k): decode(v) for k, v in data[1]}

    if tag == "Dot":
        return Dot(decode(data[1]), int(data[2]))
    if tag == "OrdDot":
        return OrdDot(decode(data[1]), int(data[2]))
    if tag == "VClock":
        return VClock({decode(a): int(c) for a, c in data[1]})
    if tag == "GCounter":
        out = GCounter()
        out.inner = decode(data[1])
        return out
    if tag == "PNCounter":
        return PNCounter(decode(data[1]), decode(data[2]))
    if tag == "PNOp":
        return PNOp(dot=decode(data[1]), dir=Dir(data[2]))
    if tag == "GSet":
        return GSet(decode(m) for m in data[1])
    if tag == "LWWReg":
        if len(data) == 1:
            return LWWReg()
        return LWWReg(decode(data[1]), decode(data[2]))
    if tag == "LWWOp":
        return LWWOp(val=decode(data[1]), marker=decode(data[2]))
    if tag == "MVReg":
        return MVReg({decode(d): (decode(c), decode(v)) for d, c, v in data[1]})
    if tag == "Put":
        return Put(dot=decode(data[1]), clock=decode(data[2]), val=decode(data[3]))
    if tag == "Orswot":
        out = Orswot()
        out.clock = decode(data[1])
        out.entries = {decode(m): decode(c) for m, c in data[2]}
        out.deferred = {decode(c): {decode(m) for m in ms} for c, ms in data[3]}
        return out
    if tag == "Add":
        return Add(dot=decode(data[1]), members=tuple(decode(m) for m in data[2]))
    if tag == "Rm":
        return Rm(clock=decode(data[1]), members=tuple(decode(m) for m in data[2]))
    if tag == "Map":
        proto = data[1]
        out = Map(val_default=lambda: decode(proto))
        out.clock = decode(data[2])
        out.entries = {decode(k): decode(v) for k, v in data[3]}
        out.deferred = {decode(c): {decode(k) for k in ks} for c, ks in data[4]}
        return out
    if tag == "Up":
        return Up(dot=decode(data[1]), key=decode(data[2]), op=decode(data[3]))
    if tag == "MapRm":
        return MapRm(clock=decode(data[1]), keyset=tuple(decode(k) for k in data[2]))
    if tag == "Nop":
        return Nop()
    if tag == "Identifier":
        return Identifier(tuple((int(ix), decode(m)) for ix, m in data[1]))
    if tag == "List":
        out = List()
        for ident_data, val_data in data[1]:
            ident = decode(ident_data)
            out.seq.append(ident)
            out.vals[ident] = decode(val_data)
        out.clock = decode(data[2])
        return out
    if tag == "Insert":
        return Insert(id=decode(data[1]), val=decode(data[2]))
    if tag == "Delete":
        return Delete(id=decode(data[1]), dot=decode(data[2]))
    if tag == "GList":
        out = GList()
        out.list = [decode(i) for i in data[1]]
        return out
    if tag == "GInsert":
        return GInsert(id=decode(data[1]))
    if tag == "Node":
        return Node(value=decode(data[1]),
                    parents=frozenset(base64.b64decode(p) for p in data[2]))
    if tag == "MerkleReg":
        out = MerkleReg()
        for node_data in (*data[1], *data[2]):
            out.apply(decode(node_data))
        return out
    raise ValueError(f"crdt_tpu_torch.serde cannot decode tag {tag!r}")


def to_bytes(obj: Any) -> bytes:
    """The wire/storage form (canonical JSON, UTF-8)."""
    return json.dumps(encode(obj), sort_keys=True, separators=(",", ":")).encode("utf-8")


def from_bytes(raw: bytes) -> Any:
    return decode(json.loads(raw.decode("utf-8")))


__all__ = ["decode", "encode", "from_bytes", "to_bytes"]
