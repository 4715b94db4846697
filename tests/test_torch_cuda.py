"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU.  The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bar: max error < 2e-5 on valid query rows, every row finite (kv_len = 0
included).
"""

import numpy as np
import pytest
import torch

from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention

pytestmark = pytest.mark.cuda

TOL = 2e-5

CASES = [  # (seed, BH, T, D, kv_lens)
    (0, 4, 256, 192, (256, 200, 129, 64)),
    (1, 2, 100, 64, (100, 37)),
    (2, 3, 130, 24, (130, 0, 1)),
    (3, 3, 77, 256, (77, 5, 0)),
    (4, 16, 1024, 192, (1024, 1, 0) + (700,) * 13),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, BH, T, D, lens, device):
    rng = np.random.RandomState(seed)
    q = (rng.randn(BH, T, D) * 0.3).astype(np.float32)
    k = (rng.randn(BH, T, D) * 0.3).astype(np.float32)
    v = rng.randn(BH, T, D).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (q, k, v, np.asarray(lens, np.int32)))


@pytest.mark.parametrize("seed,BH,T,D,lens", CASES, ids=[f"{c[1]}x{c[2]}x{c[3]}" for c in CASES])
def test_flash_kernel_matches_plain(cuda, seed, BH, T, D, lens):
    q, k, v, kv = _inputs(seed, BH, T, D, lens, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_plain(q, k, v, kv)
    assert torch.isfinite(out).all()
    for b, n in enumerate(lens):
        if n:
            assert (out[b, :n] - ref[b, :n]).abs().max().item() < TOL, b
        else:
            assert not out[b].any()


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, kv = _inputs(5, 2, 64, 32, (64, 9), cuda)
    with pytest.raises(ValueError):  # non-contiguous
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, kv)
    with pytest.raises(ValueError):  # CPU/CUDA mix
        flash_attention(q, k, v, kv.cpu())
    with pytest.raises(TypeError):  # float32 only
        flash_attention(q.half(), k.half(), v.half(), kv)
    with pytest.raises(ValueError):  # head dim past the kernel's 256
        big = torch.zeros(1, 8, 264, device=cuda)
        flash_attention(big, big, big, torch.tensor([8], dtype=torch.int32, device=cuda))
