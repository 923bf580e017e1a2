"""The port on a CUDA device: kernels K1 and K2 against their plain
versions, and the models' folds on the card against the same folds on the
CPU.

Marked ``cuda``; every test skips without a device. It imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import random

import pytest
import torch

import chip_smoke
from crdt_tpu_torch._dtypes import bits
from crdt_tpu_torch.models import BatchedMap, BatchedOrswot
from crdt_tpu_torch.ops.fold_kernels import (
    fold_cells, fold_cells_plain, fold_entries, fold_entries_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("r,e,a,high,n_passes", chip_smoke.K1_CASES)
def test_k1_matches_its_plain_version(card, r, e, a, high, n_passes):
    gen = torch.Generator(device=card).manual_seed(r * 1000 + e + a)
    top, ctr = chip_smoke.random_entries(r, e, a, high, gen, card)
    before = fold_entries.launches
    kt, kc = fold_entries(top, ctr, n_passes)
    pt, pc = fold_entries_plain(top, ctr, n_passes)
    torch.cuda.synchronize(card)
    assert fold_entries.launches == before + 1
    assert torch.equal(bits(kt), bits(pt)) and torch.equal(bits(kc), bits(pc))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_model_fold_on_the_card_matches_the_cpu(card, seed):
    rng = random.Random(seed)
    sites, _ = chip_smoke.mint_sites(rng, 5, 30)
    on_card = BatchedOrswot.from_pure(sites, device=card)
    on_cpu = BatchedOrswot.from_pure(sites, device="cpu")
    before = fold_entries.launches
    assert on_card.fold() == on_cpu.fold()
    assert fold_entries.launches == before + 1


@pytest.mark.parametrize("r,k,a,high", chip_smoke.K2_CASES)
def test_k2_matches_its_plain_version(card, r, k, a, high):
    gen = torch.Generator(device=card).manual_seed(r * 1000 + k + a)
    top, wctr = chip_smoke.random_cells(r, k, a, high, gen, card)
    before = fold_cells.launches
    kt, kw = fold_cells(top, wctr)
    pt, pw = fold_cells_plain(top, wctr)
    torch.cuda.synchronize(card)
    assert fold_cells.launches == before + 1
    assert torch.equal(bits(kt), bits(pt)) and torch.equal(bits(kw), bits(pw))


def test_k2_refuses_what_it_cannot_take(card):
    gen = torch.Generator(device=card).manual_seed(5)
    top, wctr = chip_smoke.random_cells(3, 64, 33, False, gen, card)
    with pytest.raises(ValueError, match="1..32"):
        fold_cells(top, wctr)
    top, wctr = chip_smoke.random_cells(3, 64, 8, False, gen, card)
    with pytest.raises(ValueError, match="contiguous"):
        fold_cells(top, wctr.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError, match="uint32"):
        fold_cells(top, wctr.view(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        fold_cells(top, wctr.cpu())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_map_fold_on_the_card_matches_the_cpu(card, seed):
    rng = random.Random(seed)
    sites, _ = chip_smoke.mint_map_sites(rng, 4, 30)
    on_card = BatchedMap.from_pure(sites, sibling_cap=4, device=card)
    on_cpu = BatchedMap.from_pure(sites, sibling_cap=4, device="cpu")
    before = fold_cells.launches
    assert on_card.fold() == on_cpu.fold()
    assert fold_cells.launches == before + 1
