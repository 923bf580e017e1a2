"""The port's package boundary: it runs without JAX and without the JAX
package, a CUDA tensor never falls back to the plain path, and the chip
smoke script refuses to run without a CUDA device."""

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import crdt_tpu_torch
from crdt_tpu_torch.ops import fold_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(crdt_tpu_torch.__path__, "crdt_tpu_torch.")
    )


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    for m in ("ops.fold_kernels", "convert", "ops.wire_kernels", "faults.integrity",
              "parallel.delta_ring", "parallel.wire", "delta_opt.ackwin"):
        assert f"crdt_tpu_torch.{m}" in mods, m
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'crdt_tpu' or m.startswith('crdt_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_sources_name_neither_jax_nor_the_jax_package():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "crdt_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                code = line.split("#")[0].strip()
                if code.startswith(("import ", "from ")):
                    words = code.replace(",", " ").split()
                    assert "jax" not in words and not any(
                        w == "crdt_tpu" or w.startswith(("crdt_tpu.", "jax.")) for w in words
                    ), f"{path}:{n}: {line.strip()}"


class _FakeCudaTensor(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one: what the kernel
    wrapper sees on a card, on a machine that cannot build the kernel."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _u32(shape):
    return torch.zeros(shape, dtype=torch.int32).view(torch.uint32)


def test_a_cuda_tensor_without_a_built_kernel_raises_instead_of_falling_back(
    monkeypatch, tmp_path
):
    from crdt_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))  # nothing built
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(fold_kernels, "fold_entries_plain", lambda *a, **k: pytest.fail(
        "fell back to the plain version"))
    top = _u32((3, 4)).as_subclass(_FakeCudaTensor)
    ctr = _u32((3, 5, 4)).as_subclass(_FakeCudaTensor)
    before = fold_kernels.fold_entries.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        fold_kernels.fold_entries(top, ctr)
    assert fold_kernels.fold_entries.launches == before


@pytest.mark.parametrize(
    "what,top,ctr",
    [
        ("dtype", torch.zeros((3, 4), dtype=torch.int32), _u32((3, 5, 4))),
        ("shape", _u32((3, 3)), _u32((3, 5, 4))),
        ("actors", _u32((3, 33)), _u32((3, 5, 33))),
    ],
)
def test_the_kernel_wrapper_refuses_what_the_kernel_cannot_take(what, top, ctr):
    top, ctr = top.as_subclass(_FakeCudaTensor), ctr.as_subclass(_FakeCudaTensor)
    with pytest.raises((TypeError, ValueError)):
        fold_kernels.fold_entries(top, ctr)


def test_the_kernel_wrapper_refuses_a_cpu_top_with_a_cuda_ctr():
    ctr = _u32((3, 5, 4)).as_subclass(_FakeCudaTensor)
    with pytest.raises(ValueError, match="CUDA"):
        fold_kernels.fold_entries(_u32((3, 4)), ctr)


def test_entry_points_default_to_the_card():
    import inspect

    from crdt_tpu_torch.convert import orswot_from_numpy, tracking_from_numpy
    from crdt_tpu_torch.models import BatchedOrswot
    from crdt_tpu_torch.ops.orswot import empty
    from crdt_tpu_torch.parallel import VirtualMesh

    for fn in (empty, orswot_from_numpy, BatchedOrswot.__init__, BatchedOrswot.from_pure,
               tracking_from_numpy, VirtualMesh.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert VirtualMesh(2).device == torch.device("cuda")


def _k3_inputs(n=5, lc=8, a=4):
    """Gated K3 inputs: zeros, on the CPU."""
    from crdt_tpu_torch._dtypes import zeros

    u32 = lambda *shape: zeros(shape, torch.uint32, "cpu")  # noqa: E731
    return dict(clocks=u32(n, lc), base=u32(n, lc), valid=torch.zeros(n, dtype=torch.bool),
                know=u32(n, a), dig=u32(n, a))


def _fake(args):
    return {k: v.as_subclass(_FakeCudaTensor) for k, v in args.items()}


def test_k3_without_a_built_kernel_raises_instead_of_falling_back(monkeypatch, tmp_path):
    from crdt_tpu_torch.ops import _build, wire_kernels

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(wire_kernels, "wire_pack_plain", lambda *a, **k: pytest.fail(
        "fell back to the plain version"))
    spec = wire_kernels.WireLaneSpec(lc=8, ctx_lo=4, ctx_hi=8, gated=True)
    before = wire_kernels.wire_pack.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        wire_kernels.wire_pack(spec, **_fake(_k3_inputs()))
    assert wire_kernels.wire_pack.launches == before


@pytest.mark.parametrize("what", ["cpu base", "non-contiguous", "int32 clocks", "u64 base",
                                  "lanes above the maximum", "no rows", "no know",
                                  "strided base lanes"])
def test_k3_wrapper_refuses_what_the_kernel_cannot_take(what):
    from crdt_tpu_torch.ops import wire_kernels

    lc = 66 if what == "lanes above the maximum" else 8
    n = 0 if what == "no rows" else 5
    spec = wire_kernels.WireLaneSpec(lc=lc, ctx_lo=lc - 4, ctx_hi=lc, gated=True)
    args = _k3_inputs(n=n, lc=lc)
    if what == "int32 clocks":
        args["clocks"] = args["clocks"].view(torch.int32)
    if what == "u64 base":
        args["base"] = args["base"].to(torch.int64).view(torch.uint64)
    if what == "no know":
        del args["know"]
    args = _fake(args)
    if what == "cpu base":
        args["base"] = _k3_inputs()["base"]
    if what == "non-contiguous":
        args["clocks"] = _u32((lc, n)).t().as_subclass(_FakeCudaTensor)
    if what == "strided base lanes":
        args["base"] = _u32((lc, n)).t().as_subclass(_FakeCudaTensor)
    with pytest.raises((TypeError, ValueError)):
        wire_kernels.wire_pack(spec, **args)


@pytest.mark.parametrize("what,exc,match", [
    ("mixed dtypes", TypeError, "one clock dtype"),
    ("five instances", ValueError, "1..4 instances"),
    ("rows above the maximum", ValueError, "at most 4 rows"),
])
def test_k3_group_refuses_what_the_kernel_cannot_take(monkeypatch, what, exc, match):
    """A grouped launch checks every instance and what they must share,
    before it builds or launches anything."""
    from crdt_tpu_torch.ops import wire_kernels

    spec = wire_kernels.WireLaneSpec(lc=8, ctx_lo=4, ctx_hi=8, gated=True)
    call = dict(spec=spec, **_fake(_k3_inputs()))
    calls = [call, dict(call)]
    if what == "mixed dtypes":
        wide = {k: v.to(torch.int64).view(torch.uint64) if v.dtype == torch.uint32 else v
                for k, v in _k3_inputs().items()}
        calls[1] = dict(spec=spec, **_fake(wide))
    if what == "five instances":
        calls = [call] * 5
    if what == "rows above the maximum":
        monkeypatch.setattr(wire_kernels, "MAX_ROWS", 4)
    before = wire_kernels.wire_pack.launches
    with pytest.raises(exc, match=match):
        wire_kernels.wire_pack_many(calls)
    assert wire_kernels.wire_pack.launches == before


def test_k3_wrapper_takes_the_rings_views_in_place(monkeypatch, tmp_path):
    """A watermark and digest row broadcast over the slots and ``know`` as
    a column range of ``clocks`` pass the wrapper's checks: it goes on to
    build the kernel (and raises only because it cannot)."""
    from crdt_tpu_torch.ops import _build, wire_kernels

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    spec = wire_kernels.WireLaneSpec(lc=8, ctx_lo=4, ctx_hi=8, gated=True)
    args = _k3_inputs(n=5, lc=8)
    args.update(base=args["base"][:1].expand(5, 8), dig=args["dig"][:1].expand(5, 4),
                know=args["clocks"][:, :4])
    args = _fake(args)
    assert args["base"].stride() == (0, 1) and not args["know"].is_contiguous()
    with pytest.raises(RuntimeError, match="nvcc"):
        wire_kernels.wire_pack(spec, **args)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")


def test_chip_smoke_fails_without_a_card(no_card):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=120, cwd=tmp_path, env=env,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_k3_cases_cover_every_flag_set_and_both_dtypes():
    import chip_smoke

    assert set(chip_smoke.K3_FLAGS) == {"plain", "gated", "gated_acked", "parked"}
    assert chip_smoke.K3_NS == (1, 31, 1024, 65537)
    assert chip_smoke.K3_LCS == (1, 2, 3, 8, 16, 17, 33, 64) and chip_smoke.K3_BS == (1, 8)
    assert chip_smoke.K3_LAYOUTS == ((1, "rows"), (8, "rows"), (8, "ring"))
    # Every row-group width (threads per row: the power of two >= ceil(LC / 2)).
    widths = {1 << ((lc + 1) // 2 - 1).bit_length() for lc in chip_smoke.K3_LCS}
    assert widths == {1, 2, 4, 8, 16, 32} and max(chip_smoke.K3_LCS) == 64
    # Grouped launches: the ring's round (gated slot + parked) and a group
    # of the kernel's maximum size, in every flag set.
    assert chip_smoke.K3_GROUPS[0] == (("gated", 16, 8, 4096, "ring"), ("parked", 8, 8, 4, "ring"))
    from crdt_tpu_torch.ops.wire_kernels import MAX_GROUP

    assert max(len(g) for g in chip_smoke.K3_GROUPS) == MAX_GROUP
    assert {f for g in chip_smoke.K3_GROUPS for f, *_ in g} == set(chip_smoke.K3_FLAGS)
    spec = chip_smoke.k3_spec("gated_acked", 33)
    assert (spec.ctx_lo, spec.ctx_hi, spec.gated, spec.acked) == (17, 33, True, True)


def test_chip_smoke_k3_bytes_count_each_distinct_element_once():
    """K3's bound at the ring's shape (8 links x 4,096 slots, A = 8, u32,
    gated) from the codec's own inputs: the broadcast watermark and digest
    count one row per link, ``know`` read inside ``clocks`` counts nothing."""
    import chip_smoke

    from crdt_tpu_torch.ops.wire_kernels import WireLaneSpec, wire_pack_plain

    b, n, a = 8, 4096, 8
    spec = WireLaneSpec(lc=2 * a, ctx_lo=a, ctx_hi=2 * a, gated=True)
    clocks = _u32((b, n, 2 * a))
    args = dict(spec=spec, clocks=clocks, base=_u32((b, 1, 2 * a)).expand(b, n, 2 * a),
                valid=torch.zeros((b, n), dtype=torch.bool), know=clocks[..., :a],
                dig=_u32((b, 1, a)).expand(b, n, a))
    out = wire_pack_plain(**args)
    reads = 4 * b * n * 2 * a + 4 * b * 2 * a + 4 * b * a + b * n
    writes = 4 * b * n * a + 3 * b * n + 2 * 4 * b
    assert chip_smoke.k3_bytes(args, out) == reads + writes == 3_277_632


def test_chip_smoke_bound_is_the_bandwidth_floor_at_config_3():
    import chip_smoke  # the repo root is on sys.path (conftest)

    b = chip_smoke.fold_bound_ms(10240, 102400, 8)
    assert b["bound_by"] == "bytes"
    assert b["bytes"] == 4 * (10240 * 8 + 10240 * 102400 * 8 + 8 + 102400 * 8)
    assert np.isclose(b["bound_ms"], 10.017, atol=1e-3)
