"""The CUDA kernels of the port against their plain PyTorch versions, on the
card.  A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
and nvcc; without a CUDA device they skip.  Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

(``python3 chip_smoke.py`` makes the same comparisons at more shapes and
drives a whole proof)."""

import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rand(seed, shape, device):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    a.reshape(-1)[::7] = 0
    a.reshape(-1)[3::11] = P - 1
    return gl.from_u64(a, device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 255, 4099])
def test_permute_cuda_equals_plain(card, rows):
    x = _rand(rows, (rows, 12), card)
    before = pc.launch_counts()["permute_cuda"]
    got = pc.permute_cuda(x)
    assert pc.launch_counts()["permute_cuda"] == before + 1
    assert torch.equal(got, pc.permute_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8, 15, 135])
def test_hash_no_pad_cuda_equals_plain(card, width):
    x = _rand(width, (1030, width), card)
    want = pc.hash_no_pad_plain(x)
    before = pc.launch_counts()["hash_no_pad_cuda"]
    assert torch.equal(pc.hash_no_pad_cuda(x), want)
    assert torch.equal(pc.hash_no_pad_cuda(x.t().contiguous().t()), want)
    assert pc.launch_counts()["hash_no_pad_cuda"] == before + 2


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(card):
    with pytest.raises(ValueError):
        pc.permute_cuda(torch.zeros((12, 8), dtype=torch.int64, device=card).t())
