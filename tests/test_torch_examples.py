"""The port's seven tours (``crdt_tpu_torch/examples/``) against the JAX
package's (``examples/``): each pair run in subprocesses on the CPU
prints the same lines, and each port tour's ``main(device="cpu")``
returns the values its lines carry. Tolerance 0: every line is an exact
lattice result, count or byte size. This file holds the tours 01-03 and
the helpers; ``test_torch_examples_mesh.py`` the tours 04-07.

Two exceptions to "the same lines", and only these: gloo's own
``[Gloo] Rank …`` chatter is dropped (04), and the two ``mesh:`` lines
(02, 05) compare their shape dicts — the JAX tours name host devices,
the port virtual ranks. The two processes of 04 interleave, so its
lines compare as a multiset."""

from __future__ import annotations

import ast
import collections
import dataclasses
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from crdt_tpu_torch.examples import EXAMPLES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds a tour may take (tests/test_examples.py's limit)
NAMES = [name for name, _ in EXAMPLES]
FIRST = NAMES[:3]  # this file's tours; the rest are test_torch_examples_mesh.py's
_JAX = {}  # tour -> the JAX tour's CompletedProcess (each runs once per worker)

_GLOO_WORDS = re.compile(r"\[Gloo\] Rank|is connected to|peer ranks\.|"
                         r"Expected number of connected peer ranks is :")
_MESH = re.compile(r"^mesh: (\{.*\}) over ")
_PROCESS_LINE = re.compile(r"(?=process \d+: |both processes agree: )")


def tour_lines(stdout: str) -> list:
    """The tour's own lines of ``stdout``: every line but gloo's. Gloo
    writes its ``[Gloo] Rank …`` lines from every process in pieces, so
    two processes' pieces interleave; a line holding only such pieces and
    digits is gloo's, and a tour line written after a piece is the text
    past it. Nothing else is dropped."""
    gloo = "[Gloo]" in stdout
    out = []
    for line in stdout.splitlines():
        pieces = list(_GLOO_WORDS.finditer(line))
        rest = line[pieces[-1].end():] if pieces else line
        if pieces or gloo:
            rest = rest.lstrip("0123456789 ")
            if not rest.strip():
                continue
        out.append(rest)
    return out


def comparable(name: str, lines: list):
    """The lines as compared: a ``mesh:`` line as its shape dict, 04's
    lines as a multiset. 04's two processes write to one stream, so one
    process's line can land between the other's text and its newline:
    04's lines are split where a process's line starts, and the newline
    left alone is dropped."""
    def one(line):
        m = _MESH.match(line)
        return ("mesh", ast.literal_eval(m.group(1))) if m else line

    if name == "ex04_multihost":
        return collections.Counter(x for line in lines for x in _PROCESS_LINE.split(line) if x)
    return [one(x) for x in lines]


def _jax_env() -> dict:
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    env["XLA_FLAGS"] = flags
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run_pair(name: str):
    """The JAX tour (once per worker) and the port's tour with ``--device
    cpu``, run side by side."""
    script = os.path.join(ROOT, dict(EXAMPLES)[name])
    jax = None if name in _JAX else subprocess.Popen(
        [sys.executable, script], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_jax_env())
    port = subprocess.Popen(
        [sys.executable, "-m", f"crdt_tpu_torch.examples.{name}", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        if jax is not None:
            out, err = jax.communicate(timeout=TIMEOUT)
            _JAX[name] = subprocess.CompletedProcess(jax.args, jax.returncode, out, err)
        out, err = port.communicate(timeout=TIMEOUT)
    finally:
        for p in (jax, port):
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate()
    return _JAX[name], subprocess.CompletedProcess(port.args, port.returncode, out, err)


def check_lines(name: str) -> None:
    """The port's tour prints the JAX tour's lines."""
    jax, port = _run_pair(name)
    assert jax.returncode == 0, f"JAX {name}:\n{jax.stdout}\n{jax.stderr}"
    assert port.returncode == 0, f"port {name}:\n{port.stdout}\n{port.stderr}"
    want, got = tour_lines(jax.stdout), tour_lines(port.stdout)
    assert want, f"the JAX tour {name} printed nothing"
    assert comparable(name, got) == comparable(name, want), (got, want)


@pytest.mark.parametrize("name", FIRST)
def test_tour_prints_the_jax_tours_lines(name):
    check_lines(name)


# ---- main(device="cpu") returns what its lines carry -------------------

def _mesh_line(d):
    return f"mesh: {d['mesh']} over {d['ranks']} virtual ranks on cpu"


def _lines_01(d):
    return [f"pure sites converged: {d['converged']}",
            "device fold bit-identical to the converged pure state"]


def _lines_02(d):
    return [_mesh_line(d),
            f"all-reduce fold: {d['members']}/{d['universe']} members in the converged set",
            "ring gossip (P-1 rounds) reaches the identical converged state"]


def _lines_03(d):
    out = []
    for i, (ops, length) in enumerate(d["bursts"]):
        out.append(f"burst {i}: {ops} ops, sequence length {length}")
        if i == 1:
            out.append("  checkpointed and resumed mid-stream")
    text = d["text"]
    return out + [f"final document ({len(text)} chars): {text[:60]!r}..."]


def _lines_04(d):
    out = []
    for w in d["workers"]:
        pid = w["process"]
        out.append(f"process {pid}: converged set has {w['members']}/{w['union']} members")
        out.append(f"process {pid}: shard owns {w['owned']} tenants, handed off {w['shipped']}, "
                   f"joined {w['joined']} over DCN; handoff read converged")
    return out + ["both processes agree: multi-host fold over DCN converged"]


def _lines_05(d):
    pkt, full = d["packet_bytes"], d["row_slab_bytes"]
    return [_mesh_line(d),
            f"{d['dirty_rows']} dirty rows of {d['tracked_rows']}; delta packet ≈ "
            f"{pkt/1024:.1f} KiB per link per round vs {full/1024:.0f} KiB full row slab "
            f"({full/pkt:.0f}x less traffic)",
            "delta gossip converged bit-identical to the full-state fold"]


def _lines_06(d):
    nest, sp, docs = d["deep_nesting"], d["sparse_presence"], d["sparse_documents"]
    return [f"depth-4 map: 3 replicas folded, {nest['live_leaf_cells']} live leaf cells "
            f"(no ops/map4.py exists — NestLevel composed it)",
            f"sparse presence: {sp['live_members']} live of {sp['universe']:,} possible "
            f"members; device state {sp['state_bytes']/1024:.0f} KiB vs "
            f"{sp['dense_bytes']/1e9:.1f} GB dense — converged == oracle",
            f"sparse documents: {docs['live_docs']} live docs over a 2^31/A-key product space; "
            f"{docs['state_bytes']/1024:.0f} KiB device state; doc-hot holds "
            f"{docs['hot_fields']} fields — converged == oracle"]


def _lines_07(d):
    return [f"fleet converged read before migration: {d['read_before']:,}",
            f"widened u32 -> u64 in place; read unchanged: {d['read_widened']:,}",
            f"retired till-0 into '__retired__'; lanes now {d['retired_lanes']}; "
            f"read still {d['read_retired']:,}",
            f"reset_remove(till-0) on every replica; members now {d['reset_members']}; "
            f"top {d['reset_top']}",
            f"under-budgeted ring (P-1={d['starved_rounds']} rounds, cap 16): "
            f"residue {d['starved_residue']} row-rounds -> NOT certified converged",
            f"re-run with {d['certified_rounds']} rounds: residue {d['certified_residue']} -> "
            f"certified; rows == full join: {d['rows_equal_full_join']}"]


LINES_OF = dict(zip(NAMES, (_lines_01, _lines_02, _lines_03, _lines_04, _lines_05, _lines_06,
                            _lines_07)))


def check_main(name: str, capfd) -> None:
    """``main(device="cpu")`` returns the values of the lines it prints."""
    mod = importlib.import_module(f"crdt_tpu_torch.examples.{name}")
    got = mod.main(device="cpu")
    printed = tour_lines(capfd.readouterr().out)
    assert printed, f"{name} printed nothing"
    assert comparable(name, printed) == comparable(name, LINES_OF[name](got))


@pytest.mark.parametrize("name", FIRST)
def test_main_returns_what_its_lines_carry(name, capfd):
    check_main(name, capfd)


def test_lifecycle_tour_gives_the_callers_configuration_back(monkeypatch):
    from crdt_tpu_torch.config import config, configured
    from crdt_tpu_torch.examples import ex07_lifecycle_and_certificates as ex07

    with configured(deferred_cap=5, strict=True):
        before = dataclasses.asdict(config)
        assert before["counter_dtype"] == "uint32"
        ex07.main(device="cpu")
        assert dataclasses.asdict(config) == before

        def boom(*_a, **_k):
            raise RuntimeError("a fault after the tour widened its lanes")

        monkeypatch.setattr(ex07, "retire_actor", boom)
        with pytest.raises(RuntimeError, match="widened"):
            ex07.main(device="cpu")
        assert dataclasses.asdict(config) == before


def test_importing_a_tour_runs_nothing():
    code = (
        "import contextlib, io, subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a}')\n"
        "subprocess.Popen = refuse\n"
        "import crdt_tpu_torch.examples as ex\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):\n"
        "    for name, _ in ex.EXAMPLES:\n"
        "        __import__(f'crdt_tpu_torch.examples.{name}')\n"
        "assert out.getvalue() == '', out.getvalue()\n"
        "print('ok', len(ex.EXAMPLES))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout == "ok 7\n" and out.stderr == ""


def test_every_tour_has_its_jax_counterpart():
    tours = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                   if re.match(r"\d\d_.*\.py$", f))
    assert sorted(os.path.basename(js) for _, js in EXAMPLES) == tours
    for name, js in EXAMPLES:
        assert name[2:4] == os.path.basename(js)[:2], (name, js)
        assert os.path.exists(os.path.join(ROOT, "crdt_tpu_torch", "examples", f"{name}.py"))


def _presence_sites(pkg):
    """06's presence sites, minted with ``pkg``'s oracle."""
    sites = [pkg.Orswot() for _ in range(4)]
    rng = np.random.default_rng(4)
    for _ in range(200):
        i = int(rng.integers(4))
        s = sites[i]
        member = f"user-{int(rng.integers(1_000_000))}"
        if rng.random() < 0.8 or not s.read().val:
            s.apply(s.add(member, s.read().derive_add_ctx(f"site-{i}")))
        else:
            victim = sorted(s.read().val)[0]
            s.apply(s.rm(victim, s.contains(victim).derive_rm_ctx()))
    return sites


def _document_sites(pkg):
    """06's document sites, minted with ``pkg``'s oracle."""
    import random

    rng = random.Random(6)
    sites = [pkg.Map(lambda: pkg.Map(pkg.MVReg)) for _ in range(3)]
    for step in range(30):
        i = rng.randrange(3)
        m = sites[i]
        doc = f"doc-{rng.randrange(1_000_000)}" if rng.random() < 0.4 else "doc-hot"
        field = rng.choice(["title", "body", "owner"])
        ctx = m.len().derive_add_ctx(f"site-{i}")
        m.apply(m.update(doc, ctx, lambda im, c, f=field, v=f"r{step}":
                         im.update(f, c, lambda reg, c2: reg.write(v, c2))))
    return sites


def test_sparse_tour_states_hold_the_jax_leaves_byte_for_byte():
    """06's device-byte figures, exactly: every leaf of the sparse
    presence set and the sparse document store has the JAX leaf's dtype
    and shape, so the byte sums agree to the byte, not only in KiB."""
    import jax

    import crdt_tpu
    import crdt_tpu_torch
    from crdt_tpu import models as jm
    from crdt_tpu_torch import models as tm
    from crdt_tpu_torch.convert import leaf_to_numpy
    from crdt_tpu_torch.ops.lattice import tree_leaves

    def leaves(state, port):
        xs = tree_leaves(state) if port else jax.tree_util.tree_leaves(state)
        return [(np.dtype(leaf_to_numpy(x).dtype if port else x.dtype), tuple(x.shape))
                for x in xs]

    cases = [
        (jm.BatchedSparseOrswot.from_pure(_presence_sites(crdt_tpu), dot_cap=512, rm_width=16),
         tm.BatchedSparseOrswot.from_pure(_presence_sites(crdt_tpu_torch), dot_cap=512,
                                          rm_width=16, device="cpu")),
        (jm.BatchedSparseNestedMap.from_pure(_document_sites(crdt_tpu), span=1 << 16,
                                             cell_cap=128, sibling_cap=8),
         tm.BatchedSparseNestedMap.from_pure(_document_sites(crdt_tpu_torch), span=1 << 16,
                                             cell_cap=128, sibling_cap=8, device="cpu")),
    ]
    for want, got in cases:
        assert leaves(got.state, True) == leaves(want.state, False)
        w = sum(x.nbytes for x in jax.tree_util.tree_leaves(want.state))
        g = sum(x.numel() * x.element_size() for x in tree_leaves(got.state))
        assert g == w
    assert cases[1][1].nbytes() == cases[1][0].nbytes()
