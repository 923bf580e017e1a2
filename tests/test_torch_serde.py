"""The port's ``serde`` against the JAX package's: the same value encodes
to the same tagged tree (and the same canonical bytes) in both packages,
and each package decodes the other's encoding back to its own types —
primitives, ``Dot``/``OrdDot``, ``VClock``, the pure ``Orswot``, ``Map``
and ``MVReg`` with their ops, and every other tag: the counters, ``GSet``,
``LWWReg``, the sequences and ``MerkleReg`` (orphans included)."""

import importlib
import random

import pytest

from crdt_tpu import serde as ref_serde
from crdt_tpu.dot import Dot as RefDot, OrdDot as RefOrdDot
from crdt_tpu.pure.gcounter import GCounter as RefGCounter
from crdt_tpu.pure.lwwreg import LWWReg as RefLWWReg
from crdt_tpu.vclock import VClock as RefVClock
from crdt_tpu_torch import serde
from crdt_tpu_torch.dot import Dot, OrdDot
from crdt_tpu_torch.pure.map import Nop

from test_map import _site_run, mv_map, put
from test_torch_convert import port_clock, port_map, port_map_op, port_mvreg, port_op, port_orswot
from test_torch_sparse_orswot import mint, population

PRIMITIVES = [None, True, False, 0, -7, 2**70, 1.5, -0.0, float("inf"), "s", "", b"\x00\xff",
              (1, "a", (None,)), [1, [2.5, b"x"]], {3, "x", (1, 2)}, frozenset({"y", 4}),
              {"k": [1], 2: (3,), (4, 5): None}]


# Ids by position: a set's repr depends on the process's hash seed, and the
# test workers must collect the same ids.
@pytest.mark.parametrize("value", PRIMITIVES,
                         ids=[f"{type(v).__name__}-{i}" for i, v in enumerate(PRIMITIVES)])
def test_primitives_encode_and_decode_as_in_jax(value):
    assert serde.encode(value) == ref_serde.encode(value)
    assert serde.to_bytes(value) == ref_serde.to_bytes(value)
    assert serde.from_bytes(ref_serde.to_bytes(value)) == ref_serde.from_bytes(
        ref_serde.to_bytes(value))


def test_dots_and_clocks_encode_as_in_jax():
    clock = RefVClock({"A": 3, ("t", 1): 2**40, 7: 1})
    pairs = [(RefDot("A", 5), Dot("A", 5)), (RefOrdDot("B", 2), OrdDot("B", 2)),
             (clock, port_clock(clock))]
    for ref, port in pairs:
        assert serde.encode(port) == ref_serde.encode(ref)
        assert serde.decode(ref_serde.encode(ref)) == port


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_orswots_and_their_ops_encode_as_in_jax(seed):
    for ref in population(seed):
        port = port_orswot(ref)
        assert serde.to_bytes(port) == ref_serde.to_bytes(ref)
        assert serde.from_bytes(ref_serde.to_bytes(ref)) == port
    for stream in mint(random.Random(seed), 24):
        for op in stream:
            assert serde.encode(port_op(op)) == ref_serde.encode(op)
            assert serde.decode(ref_serde.encode(op)) == port_op(op)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_maps_registers_and_their_ops_encode_as_in_jax(seed):
    for ref in _site_run(random.Random(seed), mv_map):
        port = port_map(ref)
        assert serde.to_bytes(port) == ref_serde.to_bytes(ref)
        assert serde.decode(ref_serde.encode(ref)) == port
        for reg in ref.entries.values():
            assert serde.encode(port_mvreg(reg)) == ref_serde.encode(reg)
            assert serde.decode(ref_serde.encode(reg)) == port_mvreg(reg)
    site = mv_map()
    up = put(site, "A", "p", 3)
    assert serde.encode(port_map_op(up)) == ref_serde.encode(up)
    assert serde.encode(port_map_op(up).op) == ref_serde.encode(up.op)
    assert serde.decode(ref_serde.encode(up)) == port_map_op(up)
    rm = site.rm("p", site.get("p").derive_rm_ctx())
    assert serde.encode(port_map_op(rm)) == ref_serde.encode(rm)
    assert serde.decode(ref_serde.encode(rm)) == port_map_op(rm)
    assert serde.encode(Nop()) == ["Nop"] and serde.decode(["Nop"]) == Nop()


def test_unported_types_name_their_item():
    """Every JAX tag now decodes to the port's own type; what stays
    refused is a type that is not the port's (an object of the JAX
    package) and a tag neither package knows."""
    for ref in (RefGCounter(), RefLWWReg()):
        back = serde.decode(ref_serde.encode(ref))
        assert type(back).__module__.startswith("crdt_tpu_torch.")
        assert serde.encode(back) == ref_serde.encode(ref)
    with pytest.raises(TypeError, match="cannot encode GCounter"):
        serde.encode(RefGCounter())
    with pytest.raises(ValueError, match="cannot decode tag"):
        serde.decode(["NoSuchTag"])


def _pure(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.pure.{name}")


def _build(pkg: str, kind: str):
    """The same object of ``kind``, minted by the same ops in package
    ``pkg`` (``crdt_tpu`` or ``crdt_tpu_torch``)."""
    if kind in ("GCounter", "PNCounter", "PNOp"):
        m = _pure(pkg, "pncounter")
        pn = m.PNCounter()
        for actor, up in (("a", True), ("b", False), ("a", True), (("t", 2), False)):
            op = pn.inc(actor) if up else pn.dec(actor)
            pn.apply(op)
        return {"GCounter": pn.p, "PNCounter": pn, "PNOp": op}[kind]
    if kind == "GSet":
        g = _pure(pkg, "gset").GSet()
        for x in ("z", 3, ("t", b"\x01"), frozenset({1})):
            g.apply(g.insert(x))
        return g
    if kind in ("LWWReg", "LWWReg-unset", "LWWOp"):
        m = _pure(pkg, "lwwreg")
        if kind == "LWWReg-unset":
            return m.LWWReg()
        r = m.LWWReg()
        op = r.update({"v": [1, 2]}, (1 << 63) + 5)
        return r if kind == "LWWReg" else op
    if kind in ("List", "Insert", "Delete", "Identifier"):
        lst = _pure(pkg, "list").List()
        ops = []
        for i, (ix, actor) in enumerate(((0, "a"), (0, "b"), (1, "a"), (0, "c"), (2, "b"))):
            ops.append(lst.insert_index(ix, f"x{i}", actor))
            lst.apply(ops[-1])
        ops.append(lst.delete_index(1, "a"))
        lst.apply(ops[-1])
        return {"List": lst, "Insert": ops[0], "Delete": ops[-1], "Identifier": ops[2].id}[kind]
    if kind in ("GList", "GInsert"):
        g = _pure(pkg, "glist").GList()
        op = None
        for x in ("p", "q", "r"):
            op = g.insert_after(g.last(), x)
            g.apply(op)
        g.apply(g.insert_before(g.first(), "s"))
        return g if kind == "GList" else op
    m = _pure(pkg, "merkle_reg")
    reg = m.MerkleReg()
    root = reg.write("root")
    reg.apply(root)
    child = reg.write(("child", 1), frozenset({root.hash()}))
    reg.apply(child)
    late = m.MerkleReg()
    orphan_parent = late.write(b"parent")
    orphan = late.write(2.5, frozenset({orphan_parent.hash()}))
    reg.apply(orphan)  # its parent has not arrived: an orphan
    return reg if kind == "MerkleReg" else child


NEW_TAGS = ["GCounter", "PNCounter", "PNOp", "GSet", "LWWReg", "LWWReg-unset", "LWWOp",
            "Identifier", "List", "Insert", "Delete", "GList", "GInsert", "Node", "MerkleReg"]


@pytest.mark.parametrize("kind", NEW_TAGS)
def test_every_other_tag_encodes_as_in_jax_and_decodes_across(kind):
    ref, port = _build("crdt_tpu", kind), _build("crdt_tpu_torch", kind)
    assert type(port).__module__.startswith("crdt_tpu_torch.")
    assert serde.encode(port) == ref_serde.encode(ref)
    assert serde.to_bytes(port) == ref_serde.to_bytes(ref)
    assert serde.from_bytes(ref_serde.to_bytes(ref)) == port
    assert ref_serde.from_bytes(serde.to_bytes(port)) == ref
    if kind == "MerkleReg":
        assert port.num_orphans() == 1 and serde.decode(serde.encode(port)).num_orphans() == 1
