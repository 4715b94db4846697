"""The PyTorch port's flash attention against the JAX package's Pallas kernel
(interpret mode) and its plain reference, on the CPU.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is held
to the plain version by ``tests/test_torch_cuda.py`` (skipped without a GPU)
and by ``chip_smoke.py`` on the card.  Bar: max error < 2e-5 on valid query rows
(the JAX kernel test's bar), every row finite, kv_len = 0 included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_tts_tpu.kernels import attention_reference
from e2e_tts_tpu.kernels import flash_attention as jax_flash_attention
from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention

TOL = 2e-5

CASES = [  # (seed, BH, T, D, kv_lens): the JAX kernel test's shapes, D=24, kv_len=0
    (0, 4, 256, 192, (256, 200, 129, 64)),
    (1, 2, 100, 64, (100, 37)),
    (2, 3, 130, 24, (130, 0, 1)),
]


def _inputs(seed, BH, T, D, lens):
    rng = np.random.RandomState(seed)
    q = (rng.randn(BH, T, D) * 0.3).astype(np.float32)
    k = (rng.randn(BH, T, D) * 0.3).astype(np.float32)
    v = rng.randn(BH, T, D).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("seed,BH,T,D,lens", CASES, ids=[f"{c[1]}x{c[2]}x{c[3]}" for c in CASES])
def test_plain_matches_jax_kernel_and_reference(seed, BH, T, D, lens):
    q, k, v, kv = _inputs(seed, BH, T, D, lens)
    ours = attention_plain(*map(torch.from_numpy, (q, k, v, kv))).numpy()
    pallas = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v, kv)), interpret=True))
    ref = np.asarray(attention_reference(*map(jnp.asarray, (q, k, v, kv))))
    assert np.isfinite(ours).all()
    for b, n in enumerate(lens):
        if n:
            assert np.abs(ours[b, :n] - pallas[b, :n]).max() < TOL, b
            assert np.abs(ours[b, :n] - ref[b, :n]).max() < TOL, b
        else:
            assert not ours[b].any()  # no valid key: defined as 0


def test_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, kv = map(torch.from_numpy, _inputs(3, 2, 64, 24, (64, 10)))
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v, kv), attention_plain(q, k, v, kv))
    assert flash_attention.launches == before  # counts kernel launches only


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, kv = map(torch.from_numpy, _inputs(4, 2, 16, 8, (16, 3)))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double(), kv)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :8], v, kv)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv[:1])


def test_kernel_sources_ship_with_the_module():
    from e2e_tts_tpu_torch.kernels import build

    assert open(f"{build.CSRC}/flash_attention.cu").read().count("flash_attention_fwd_f32")
    assert "compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
