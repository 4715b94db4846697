"""The port on the card: its CUDA kernels against their plain PyTorch
versions, its audio ops on CUDA against the CPU, and the batching queue on a
small CUDA engine.

Every test here is marked ``cuda`` and skips without a GPU.  The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bars: attention max error < 2e-5 on valid query rows, every row finite
(kv_len = 0 included); log-mel MAE < 1e-4 and ``inverse_stft`` max < 1e-4
against the CPU, and ``inverse_stft`` bit-equal run to run; the queue's
results equal to a solo ``synthesize`` within 1 LSB on average.
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
    (6, 4, 1152, 192, (957, 957, 4, 4)),  # serving's largest bucket
    (7, 4, 384, 192, (88, 88, 4, 4)),  # 96 blocks of 16 rows: fewer than the SMs
    (8, 2, 300, 100, (300, 17)),  # D not a multiple of 8
    (9, 2, 70, 27, (70, 33)),  # D not a multiple of 4: 4-byte copies
    (10, 2, 50, 1, (50, 3)),  # D = 1
    (11, 2, 40, 256, (40, 17)),  # D = 256
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


def test_flash_kernel_rows_past_kv_len(cuda):
    """Rows at or past kv_len are finite, a kv_len = 0 head is all zeros, and
    a 16-row group with no valid row (no key loop) is zeros too."""
    lens = (957, 0, 4, 1152)
    q, k, v, kv = _inputs(12, 4, 1152, 192, lens, cuda)
    out = flash_attention(q, k, v, kv)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v, kv)
    assert torch.isfinite(out).all()
    assert not out[1].any()
    assert not out[0, 960:].any() and not out[2, 16:].any()
    for b, n in enumerate(lens):
        if n:
            assert (out[b, :n] - ref[b, :n]).abs().max().item() < TOL, b


def test_flash_kernel_shapes_in_turn(cuda):
    """Shapes in turn whose launches share a compiled kernel with different
    shared memory and key splits (the launch plan is kept per shape)."""
    for seed, (BH, T, D, lens) in enumerate([(4, 1152, 192, (957, 957, 4, 4)),
                                             (4, 384, 192, (88, 88, 4, 4)),
                                             (4, 1152, 192, (957, 0, 4, 1152)),
                                             (16, 256, 192, (256, 17) * 8)]):
        q, k, v, kv = _inputs(20 + seed, BH, T, D, lens, cuda)
        out = flash_attention(q, k, v, kv)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, kv)
        assert torch.isfinite(out).all()
        for b, n in enumerate(lens):
            if n:
                assert (out[b, :n] - ref[b, :n]).abs().max().item() < TOL, (T, b)


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


# --- audio ops and the queue on the card ------------------------------------------------

def test_audio_ops_on_cuda_match_cpu(cuda):
    from e2e_tts_tpu_torch.audio import MelParams, inverse_stft, mel_spectrogram

    rng = np.random.RandomState(30)
    audio = torch.from_numpy((0.3 * rng.randn(2, 3 * 22050)).astype(np.float32))
    p = MelParams()
    mel_g, e_g = mel_spectrogram(audio.to(cuda), p, return_energy=True)
    mel_c, e_c = mel_spectrogram(audio, p, return_energy=True)
    assert (mel_g.cpu() - mel_c).abs().mean().item() < 1e-4
    assert (e_g.cpu() - e_c).abs().max().item() < 2e-2
    for n_fft, hop, win, frames in ((16, 4, 16, 4000), (1024, 256, 1024, 200)):
        mag = torch.from_numpy(np.exp(rng.randn(2, n_fft // 2 + 1, frames)).astype(np.float32))
        ph = torch.from_numpy(rng.uniform(-3, 3, mag.shape).astype(np.float32))
        out = inverse_stft(mag.to(cuda), ph.to(cuda), n_fft, hop, win)
        again = inverse_stft(mag.to(cuda), ph.to(cuda), n_fft, hop, win)
        ref = inverse_stft(mag, ph, n_fft, hop, win)
        assert torch.equal(out, again)  # the overlap-add is deterministic
        assert out.shape == ref.shape and (out.cpu() - ref).abs().max().item() < 1e-4


def test_batching_server_on_cuda(cuda):
    import threading

    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.serve import BatchingServer, SynthesisEngine

    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    small = fs2.replace(encoder_layers=1, decoder_layers=1, encoder_hidden=64, decoder_hidden=64,
                        building_block=fs2.building_block.replace(
                            transformer=fs2.building_block.transformer.replace(
                                conv_filter_size=64)),
                        postnet=fs2.postnet.replace(embedding_dim=64, conv_layers=2))
    cfg = cfg.replace(models=cfg.models.replace(fastspeech2=small))
    eng = SynthesisEngine.from_random(seed=0, config=cfg, device=cuda)
    texts = ["xin chào bạn", "hôm nay trời đẹp", "em yêu hoa lá", "núi sông hùng vĩ " * 20]
    solo = [eng.synthesize(t, silence_distance=0.0) for t in texts]
    futures = [None] * len(texts)
    before = flash_attention.launches
    with BatchingServer(eng, max_wait_ms=50.0) as srv:
        barrier = threading.Barrier(len(texts))

        def go(i):
            barrier.wait(timeout=60)
            futures[i] = srv.submit(texts[i], silence_distance=0.0)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        outs = [f.result(timeout=300) for f in futures]
    assert flash_attention.launches > before  # the long text's decoder runs at T >= 256
    for out, ref in zip(outs, solo):
        assert len(out) == len(ref) > 0
        assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).mean() < 1.0
