"""The port on the card: its CUDA kernels against their plain PyTorch
versions, its audio ops on CUDA against the CPU, the batching queue on a
small CUDA engine, one train step and two joint acoustic + vocoder steps
that launch the training kernels, a supervised train step (no aligner)
against the CPU, the training CLI refusing to start without a card unless
given ``--device cpu``, a vocoder GAN step against the CPU, and data
preparation: a synthetic corpus's features on the card against the
CPU (log-mel MAE < 1e-4, energy max < 2e-2, f0 and pitch equal) and one
default-width train step on a bucketed batch of it; the four other block
families' encoders and decoders against the CPU, and the reformer's
rotation table on the card; the router's ``vie_tiny`` request, the kNN
voice-conversion match and the learned MOS scorer on the card against the
CPU.

Every test here is marked ``cuda`` and skips without a GPU, but one: the
data entry points' ``device=None`` raising without a card runs on the CPU
only.  The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bars: attention max error < 2e-5 on valid query rows, every row finite
(kv_len = 0 included); the 16-bit attention (both its kernels,
``flash_fwd_16_sm90`` and ``flash_fwd_16``) within one ulp of its output's
dtype of the plain version (float32 on the upcast inputs, rounded once;
``ulp_error``: near 0, float32's ulp at the largest |v|);
a bfloat16 engine on CUDA against the same on the CPU: equal lengths, mean
|diff| no more than the CPU's own bfloat16-against-float32 gap; log-mel MAE < 1e-4 and ``inverse_stft`` max < 1e-4
against the CPU, and ``inverse_stft`` bit-equal run to run; the queue's
results equal to a solo ``synthesize`` within 1 LSB on average; MAS
bit-equal to its plain version; the CTC loss within 1e-5 relative and its
gradient within 1e-5 x max |grad| of the plain versions; one vocoder GAN
step against the CPU within 1e-4 (metrics) and 1e-3 (each module's
gradient, relative norm), cuDNN's TF32 off.
"""

import numpy as np
import pytest
import torch

from chip_smoke import ATTN_SHAPES
from e2e_tts_tpu_torch.kernels.flash_attention import attention_plain, flash_attention, ulp_error

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
    with pytest.raises(TypeError):  # float32, bfloat16 or float16 only
        flash_attention(q.double(), k.double(), v.double(), kv)
    with pytest.raises(TypeError):  # the three alike
        flash_attention(q.half(), k.bfloat16(), v.half(), kv)
    with pytest.raises(ValueError):  # head dim past the kernel's 256
        big = torch.zeros(1, 8, 264, device=cuda)
        flash_attention(big, big, big, torch.tensor([8], dtype=torch.int32, device=cuda))


def _counts():
    return (flash_attention.launches, flash_attention.launches_16,
            flash_attention.launches_16_sm90)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("seed,BH,T,D,lens", CASES, ids=[f"{c[1]}x{c[2]}x{c[3]}" for c in CASES])
def test_flash_kernel_16bit_matches_plain(cuda, dtype, seed, BH, T, D, lens):
    """The 16-bit form on 16-bit inputs: the launch count of the kernel the
    plan takes rises (``flash_fwd_16_sm90`` where D % 8 == 0, else
    ``flash_fwd_16``) and no other (no upcast into the float32 form); every
    valid element within one ulp of the plain version (``ulp_error``);
    kv_len = 0 heads are zeros."""
    q, k, v, kv = _inputs(seed, BH, T, D, lens, cuda)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = _counts()
    out = flash_attention(q, k, v, kv)
    torch.cuda.synchronize()
    sm90 = D % 8 == 0
    assert _counts() == (before[0], before[1] + (not sm90), before[2] + sm90)
    assert out.dtype == dtype
    ref = attention_plain(q, k, v, kv)
    assert torch.isfinite(out.float()).all()
    assert ulp_error(out, ref, v, kv) <= 1.0
    for b, n in enumerate(lens):
        if not n:
            assert not out[b].float().any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_flash_kernel_16bit_rows_past_kv_len(cuda, dtype):
    lens = (957, 0, 4, 1152)
    q, k, v, kv = _inputs(12, 4, 1152, 192, lens, cuda)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    out = flash_attention(q, k, v, kv)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v, kv)
    assert torch.isfinite(out.float()).all()
    assert not out[1].float().any()
    assert not out[0, 960:].float().any() and not out[2, 16:].float().any()
    assert ulp_error(out, ref, v, kv) <= 1.0


# chip_smoke.ATTN_SHAPES with D % 8 == 0 (all of them), and edges: kv_len 0
# and 1, rows past kv_len, D of 16 to 256, T not a multiple of the tiles
SM90_SHAPES = [s for s in ATTN_SHAPES if s[2] % 8 == 0] + [
    (3, 200, 16, (200, 1, 0)), (3, 333, 128, (333, 64, 65)), (3, 500, 256, (500, 129, 7)),
    (2, 130, 64, (1, 130)), (64, 1024, 192, (1024, 800, 555, 3) * 16)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("BH,T,D,lens", SM90_SHAPES, ids=[f"{s[0]}x{s[1]}x{s[2]}" for s in SM90_SHAPES])
def test_flash_sm90_and_mma_sync_hold_the_bar(cuda, BH, T, D, lens, dtype, seed):
    """Both 16-bit kernels, each forced, within one ulp of the plain version;
    only the forced kernel's count rises; rows past kv_len finite, kv_len = 0
    heads zeros."""
    q, k, v, kv = _inputs(100 * seed + D, BH, T, D, lens, cuda)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    ref = attention_plain(q, k, v, kv)
    for kernel, counter in (("sm90", 2), ("mma_sync", 1)):
        before = _counts()
        out = flash_attention(q, k, v, kv, kernel=kernel)
        torch.cuda.synchronize()
        assert _counts() == tuple(n + (i == counter) for i, n in enumerate(before)), kernel
        assert torch.isfinite(out.float()).all(), kernel
        assert ulp_error(out, ref, v, kv) <= 1.0, kernel
        for b, n in enumerate(lens):
            if not n:
                assert not out[b].float().any(), kernel


def test_flash_16bit_plan_sends_odd_head_dims_to_mma_sync(cuda):
    """D % 8 != 0 (rows TMA cannot address): the plan takes flash_fwd_16,
    and forcing flash_fwd_16_sm90 there raises."""
    q, k, v, kv = _inputs(31, 2, 300, 100, (300, 17), cuda)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    before = _counts()
    out = flash_attention(q, k, v, kv)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2])
    assert ulp_error(out, attention_plain(q, k, v, kv), v, kv) <= 1.0
    with pytest.raises(RuntimeError):
        flash_attention(q, k, v, kv, kernel="sm90")


def test_flash_sm90_takes_a_misaligned_view(cuda):
    """A contiguous view 2 bytes past an aligned start reaches the TMA kernel
    as an aligned copy, with the same result as the aligned tensor."""
    q, k, v, kv = _inputs(32, 2, 256, 64, (256, 100), cuda)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    buf[1:].copy_(q.flatten())
    view = buf[1:].view(q.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    out = flash_attention(view, k, v, kv, kernel="sm90")
    assert torch.equal(out, flash_attention(q, k, v, kv, kernel="sm90"))



def test_bf16_engine_on_cuda_matches_cpu(cuda):
    """``vie_tiny`` in bfloat16 on the card (the 16-bit kernel, and no launch
    of the float32 form) against the same bundle in bfloat16 and in float32
    on the CPU, all on the card run's durations (``chip_smoke.duration_trace``;
    the log-durations held to 2 x the bfloat16 model's own error): equal
    lengths, and the card's mean |diff| from the CPU's bfloat16 no more than
    the CPU's own bfloat16-against-float32 gap."""
    import os

    from chip_smoke import REQUESTS, duration_trace, log_duration_parity
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    bundle = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "assets", "bundles", "vie_tiny")
    gpu = SynthesisEngine.from_checkpoint(bundle, device=cuda, dtype=torch.bfloat16)
    text = REQUESTS[-1]  # long enough for the decoder's flash branch
    before = _counts()
    with duration_trace(gpu) as trace:
        out = gpu.synthesize(text)
    # the bundle's heads are 24 wide: flash_fwd_16_sm90
    after = _counts()
    assert after[:2] == before[:2] and after[2] > before[2]
    refs, traces = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        cpu = SynthesisEngine.from_checkpoint(bundle, device="cpu", dtype=dtype)
        with duration_trace(cpu, trace) as traces[dtype]:
            refs[dtype] = cpu.synthesize(text)
    log_duration_parity("vie_tiny", trace, traces[torch.bfloat16], traces[torch.float32])
    assert len(out) == len(refs[torch.bfloat16]) == len(refs[torch.float32])
    diff = lambda a, b: np.abs(a.astype(np.int32) - b.astype(np.int32)).mean()  # noqa: E731
    assert diff(out, refs[torch.bfloat16]) <= diff(refs[torch.bfloat16], refs[torch.float32])


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


# --- the training kernels: MAS and the forward-sum CTC ----------------------------------

MAS_CASES = [  # (seed, B, T, L, text_lens, mel_lens)
    (40, 4, 768, 128, (128, 64, 100, 77), (768, 384, 500, 600)),
    (41, 2, 1024, 256, (256, 200), (1024, 777)),
    (42, 6, 45, 13, (1, 0, 13, 9, 13, 5), (45, 30, 45, 4, 0, 1)),  # edges; not multiples of 32
    (43, 3, 100, 1100, (1100, 1025, 3), (100, 100, 100)),  # more columns than threads
]


def _mas_inputs(seed, B, T, L, device):
    rng = np.random.RandomState(seed)
    attn = rng.dirichlet(np.ones(L), size=(B, T)).astype(np.float32)
    return torch.log(torch.clamp(torch.from_numpy(attn), min=1e-30)).to(device)


@pytest.mark.parametrize("seed,B,T,L,tl,ml", MAS_CASES, ids=[f"{c[1]}x{c[2]}x{c[3]}" for c in MAS_CASES])
def test_mas_kernel_bit_equal_to_plain(cuda, seed, B, T, L, tl, ml):
    from e2e_tts_tpu_torch.kernels.mas import mas, mas_plain

    la = _mas_inputs(seed, B, T, L, cuda)
    tl_t = torch.tensor(tl, dtype=torch.int32, device=cuda)
    ml_t = torch.tensor(ml, dtype=torch.int32, device=cuda)
    before = mas.launches
    out = mas(la, tl_t, ml_t)
    torch.cuda.synchronize()
    assert mas.launches == before + 1
    assert torch.equal(out, mas_plain(la, tl_t, ml_t))
    for b, (n, m) in enumerate(zip(tl, ml)):
        if n == 0 or m == 0:
            assert not out[b].any()


def test_mas_kernel_ties(cuda):
    """Flat rows (every step a tie, resolved to the left) and -1e30 in column 0."""
    from e2e_tts_tpu_torch.kernels.mas import mas, mas_plain

    la = torch.full((3, 50, 20), -3.0, device=cuda)
    la[2, :, 0] = -1e30
    tl = torch.tensor([20, 7, 20], dtype=torch.int32, device=cuda)
    ml = torch.tensor([50, 33, 50], dtype=torch.int32, device=cuda)
    assert torch.equal(mas(la, tl, ml), mas_plain(la, tl, ml))


CTC_CASES = [  # (seed, B, T, K, text_lens, mel_lens)
    (50, 4, 768, 128, (128, 64, 100, 77), (768, 384, 500, 600)),
    (51, 2, 1024, 256, (256, 200), (1024, 777)),
    (52, 6, 45, 13, (1, 0, 13, 9, 13, 5), (45, 30, 45, 4, 0, 1)),  # k 0 and 1, q < k, q 0
]


def _ctc_inputs(seed, B, T, K, tl, device):
    from e2e_tts_tpu_torch.ops.ctc import lattice_log_probs

    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(B, T, K) * 2).astype(np.float32))
    return lattice_log_probs(logits, torch.tensor(tl)).to(device).contiguous()


@pytest.mark.parametrize("seed,B,T,K,tl,ml", CTC_CASES, ids=[f"{c[1]}x{c[2]}x{c[3]}" for c in CTC_CASES])
def test_ctc_kernels_match_plain(cuda, seed, B, T, K, tl, ml):
    """Loss relative error < 1e-5, gradient max |diff| < 1e-5 x max |grad|
    (exp/log and sums in another order than the plain version's)."""
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_bwd_plain, ctc_fwd, ctc_fwd_plain

    lp = _ctc_inputs(seed, B, T, K, tl, cuda)
    kl = torch.tensor(tl, dtype=torch.int32, device=cuda)
    ql = torch.tensor(ml, dtype=torch.int32, device=cuda)
    g = torch.full((B,), 1.0 / B, device=cuda)
    n_fwd, n_bwd = ctc_fwd.launches, ctc_bwd.launches
    loss, alpha, total = ctc_fwd(lp, kl, ql)
    grad = ctc_bwd(g, lp, kl, ql, alpha, total)
    torch.cuda.synchronize()
    assert (ctc_fwd.launches, ctc_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    loss_p, alpha_p, total_p = ctc_fwd_plain(lp, kl, ql)
    grad_p = ctc_bwd_plain(g, lp, kl, ql, alpha_p, total_p)
    assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
    assert ((loss - loss_p).abs() <= 1e-5 * loss_p.abs()).all(), (loss, loss_p)
    assert (grad - grad_p).abs().max().item() < 1e-5 * grad_p.abs().max().item()
    for b, (n, m) in enumerate(zip(tl, ml)):
        if n == 0 or m < n and m > 0:  # zeroed rows: no loss, no gradient
            assert loss[b].item() == 0 and not grad[b].any()


def _small_acoustic(device):
    """A one-layer FastSpeech2 with its aligner, its config, and a batch of
    3 rows in the JAX ``_collate`` layout."""
    from e2e_tts_tpu_torch.audio import beta_binomial_prior
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.models.acoustic import FastSpeech2
    from e2e_tts_tpu_torch.nn.variance import FeatureStats
    from e2e_tts_tpu_torch.train import AcousticBatch

    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    fs2 = fs2.replace(encoder_layers=1, decoder_layers=1, encoder_hidden=64, decoder_hidden=64,
                      building_block=fs2.building_block.replace(
                          transformer=fs2.building_block.transformer.replace(conv_filter_size=64)),
                      postnet=fs2.postnet.replace(embedding_dim=64, conv_layers=2))
    cfg = cfg.replace(models=cfg.models.replace(fastspeech2=fs2))
    model = FastSpeech2(fs2, 40, 2, 80, FeatureStats(), device=device)
    rng = np.random.RandomState(60)
    B, L, T = 3, 20, 90
    tl, ml = np.array([20, 13, 7]), np.array([90, 60, 31])
    arrays = [np.zeros(B, np.int64), np.zeros((B, L), np.int64), tl, np.zeros((B, L), np.int64),
              np.zeros((B, T, 80), np.float32), ml, np.zeros((B, T, L), np.float32),
              np.zeros((B, L), np.float32)] + [np.zeros((B, T), np.float32) for _ in range(4)]
    for b in range(B):
        arrays[1][b, :tl[b]] = rng.randint(1, 40, tl[b])
        arrays[4][b, :ml[b]] = rng.randn(ml[b], 80) - 4.0
        arrays[6][b, :ml[b], :tl[b]] = beta_binomial_prior(tl[b], ml[b])
    return model, cfg, AcousticBatch.from_numpy(arrays, device)


def test_train_step_launches_the_training_kernels(cuda):
    """One train step of a small model on the card launches MAS once, the CTC
    forward once and the CTC backward once; its losses are finite."""
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.mas import mas
    from e2e_tts_tpu_torch.train import acoustic_optimizer, init_train_state, make_train_step

    model, cfg, batch = _small_acoustic(cuda)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 64)
    state = init_train_state(model, opt)
    before = (mas.launches, ctc_fwd.launches, ctc_bwd.launches)
    _, metrics = make_train_step(model, cfg, opt, 32)(state, batch)
    torch.cuda.synchronize()
    assert (mas.launches, ctc_fwd.launches, ctc_bwd.launches) == tuple(n + 1 for n in before)
    assert all(torch.isfinite(v).item() for v in metrics.values())


def test_supervised_train_step_on_cuda_matches_cpu(cuda):
    """One train step of a small supervised model (``learn_alignment: false``,
    causal duration-predictor padding, durations from the batch, dropout off)
    on the card against the same weights and batch on the CPU, cuDNN's TF32
    off: each metric within 1e-4 relative, the gradients (Adam's first
    moments) within 1e-3 relative norm; no MAS or CTC launch, no ctc term."""
    import copy

    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.mas import mas
    from e2e_tts_tpu_torch.train import (AcousticBatch, acoustic_optimizer, build_acoustic_model,
                                         init_train_state, make_train_step)

    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    v = fs2.variance
    fs2 = fs2.replace(
        encoder_layers=2, decoder_layers=2, encoder_hidden=64, decoder_hidden=64,
        building_block=fs2.building_block.replace(
            transformer=fs2.building_block.transformer.replace(conv_filter_size=128)),
        variance=v.replace(
            variance_predictor=v.variance_predictor.replace(filter_size=32, ffn_padding="CAUSAL"),
            duration_modelling=v.duration_modelling.replace(learn_alignment=False)),
        postnet=fs2.postnet.replace(embedding_dim=64, conv_layers=3))
    cfg = cfg.replace(models=cfg.models.replace(fastspeech2=fs2))
    model = build_acoustic_model(cfg, 40, 2, dropout=False, device="cpu")
    rng = np.random.RandomState(61)
    B, L, T = 3, 20, 90
    tl = np.array([20, 13, 7])
    arrays = [np.arange(B) % 2, np.zeros((B, L), np.int64), tl, np.zeros((B, L), np.int64),
              np.zeros((B, T, 80), np.float32), np.zeros(B, np.int64),
              np.zeros((B, T, L), np.float32), np.zeros((B, L), np.float32)] + [
        np.zeros((B, T), np.float32) for _ in range(4)]
    for b in range(B):
        d = rng.randint(1, 5, tl[b])
        arrays[1][b, :tl[b]] = rng.randint(1, 40, tl[b])
        arrays[3][b, :tl[b]] = np.arange(tl[b])
        arrays[5][b] = ml = d.sum()
        arrays[7][b, :tl[b]] = d
        arrays[4][b, :ml] = rng.randn(ml, 80) - 4.0
        for k in (8, 10, 11):
            arrays[k][b, :ml] = rng.randn(ml)
        arrays[9][b, :ml] = rng.rand(ml) < 0.3
    out = {}
    before = (mas.launches, ctc_fwd.launches, ctc_bwd.launches)
    for device in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(device)
        opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 64)
        state = init_train_state(m, opt)
        out[device] = make_train_step(m, cfg, opt, 32)(state, AcousticBatch.from_numpy(arrays,
                                                                                        device))
    torch.cuda.synchronize()
    assert (mas.launches, ctc_fwd.launches, ctc_bwd.launches) == before
    (s_c, m_c), (s_g, m_g) = out["cpu"], out["cuda"]
    assert "ctc" not in m_g and sorted(m_g) == sorted(m_c)
    for k, val in m_c.items():
        assert abs(m_g[k].item() - val.item()) <= 1e-4 * abs(val.item()), k
    for name, c, g in zip([n for n, _ in model.named_parameters()], s_c.opt_state.mu,
                          s_g.opt_state.mu):
        if name.endswith("slf_attn.w_k.bias") or (name.startswith("postnet.convs.")
                                                   and name.endswith(".bias")):
            continue  # 0 by construction: float noise on both
        assert ((g.cpu() - c).norm() / c.norm().clamp(min=1e-30)).item() < 1e-3, name


def test_cli_refuses_to_start_without_cuda(cuda, tmp_path):
    """``python -m e2e_tts_tpu_torch.train.cli acoustic`` with no card visible
    exits with an error that names CUDA, before any work; with
    ``--device cpu`` it runs (here: zero steps of a tiny model)."""
    import json
    import os
    import subprocess
    import sys

    from e2e_tts_tpu_torch.config import default_config, save_config

    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    cfg = cfg.replace(models=cfg.models.replace(fastspeech2=fs2.replace(
        encoder_layers=1, decoder_layers=1, encoder_hidden=32, decoder_hidden=32,
        building_block=fs2.building_block.replace(
            transformer=fs2.building_block.transformer.replace(conv_filter_size=32)),
        postnet=fs2.postnet.replace(embedding_dim=32, conv_layers=2))))
    save_config(cfg, str(tmp_path / "config.yaml"))
    w = tmp_path / "work"
    w.mkdir()
    (w / "file_list.txt").write_text("")
    (w / "stats.json").write_text(json.dumps({}))
    (w / "speakers.json").write_text(json.dumps({"spk": 0}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    argv = [sys.executable, "-m", "e2e_tts_tpu_torch.train.cli", "acoustic", "--workdir", str(w),
            "--config", str(tmp_path / "config.yaml"), "--steps", "0"]
    refused = subprocess.run(argv, cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert refused.returncode != 0 and "CUDA" in refused.stderr
    assert not (w / "acoustic_ckpt").exists()
    ran = subprocess.run(argv + ["--device", "cpu"], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=300)
    assert ran.returncode == 0, ran.stderr
    assert "[acoustic] done at step 0" in ran.stdout and (w / "acoustic_ckpt" / "0").is_dir()


TINY_GEN = dict(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),))


def _tiny_gan(cfg, device):
    """A tiny training-form HiFi-GAN and tiny discriminators, each kernel at
    norm U(0.5, 1.5) a channel (a level-keeping network, as a trained one)."""
    from e2e_tts_tpu_torch.models.vocoder import build_generator
    from e2e_tts_tpu_torch.nn.discriminators import TINY_MSD_SPECS, build_discriminators

    cfg = cfg.replace(models=cfg.models.replace(hifigan=cfg.models.hifigan.replace(**TINY_GEN)))
    gen = build_generator(cfg, "hifigan", train=True, device=device)
    mpd, msd = build_discriminators(device, periods=(2, 3), mpd_channels=(4, 8), n_scales=2,
                                    msd_specs=TINY_MSD_SPECS)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in (gen, mpd, msd):
            for name, p in m.named_parameters():
                if name.endswith(".g"):
                    p.copy_(0.5 + torch.rand(p.shape, generator=g))
    return cfg, gen, mpd, msd


def _speech(B, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 22050.0
    a = sum(0.2 * np.sin(2 * np.pi * f * t + rng.rand() * 6) for f in (140.0, 290.0, 610.0))
    return (a[None] + 0.02 * rng.randn(B, n)).astype(np.float32)


def test_vocoder_step_on_cuda_matches_cpu(cuda):
    """One vocoder GAN step (HiFi-GAN, then iSTFTNet) on the card against the
    same weights and batch on the CPU, cuDNN's TF32 off: each metric within
    1e-4 relative; the generator's and the discriminators' gradients, read
    from Adam's first moments, within 1e-3 relative norm each (a single
    tensor's weight gradient summed over thousands of samples moves by ~1e-3
    with the order of the sums alone)."""
    import copy

    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.models.vocoder import build_generator
    from e2e_tts_tpu_torch.train import (VocoderBatch, gan_optimizer, init_vocoder_train_state,
                                         make_vocoder_train_step)

    torch.backends.cudnn.allow_tf32 = False
    for kind in ("hifigan", "istft"):
        cfg, gen, mpd, msd = _tiny_gan(default_config(), "cpu")
        if kind == "istft":
            cfg = cfg.replace(models=cfg.models.replace(
                istft=cfg.models.istft.replace(**TINY_GEN)))
            gen = build_generator(cfg, "istft", train=True, device="cpu")
        mel = (np.random.RandomState(7).randn(2, 8, 80) * 1.5 - 5.0).astype(np.float32)
        arrays = (mel, _speech(2, 8 * 256, 8))
        out = {}
        for device in ("cpu", "cuda"):
            mods = [copy.deepcopy(m).to(device) for m in (gen, mpd, msd)]
            g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
            state = init_vocoder_train_state(mods[0], g_opt, d_opt, *mods[1:])
            step = make_vocoder_train_step(mods[0], cfg, g_opt, d_opt, kind, *mods[1:])
            out[device] = step(state, VocoderBatch.from_numpy(arrays, device))
        (s_c, m_c), (s_g, m_g) = out["cpu"], out["cuda"]
        for k, v in m_c.items():
            assert abs(m_g[k].item() - v.item()) <= 1e-4 * abs(v.item()), (kind, k)
        for attr in ("g_opt_state", "d_opt_state"):
            c = torch.cat([m.flatten() for m in getattr(s_c, attr).mu])
            g = torch.cat([m.flatten().cpu() for m in getattr(s_g, attr).mu])
            assert ((g - c).norm() / c.norm()).item() < 1e-3, (kind, attr)


def test_e2e_step_launches_the_training_kernels(cuda):
    """Two joint acoustic + vocoder steps of small models on the card launch
    MAS, the CTC forward and the CTC backward once a step each; the metrics
    are finite and no parameter keeps a gradient."""
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.mas import mas
    from e2e_tts_tpu_torch.train import (E2EBatch, acoustic_optimizer, gan_optimizer,
                                         init_e2e_state, make_e2e_train_step)

    model, cfg, acoustic = _small_acoustic(cuda)
    cfg, gen, mpd, msd = _tiny_gan(cfg, cuda)
    am_opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, 64)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    state = init_e2e_state(model, gen, am_opt, g_opt, d_opt, mpd, msd)
    step = make_e2e_train_step(model, gen, cfg, am_opt, g_opt, d_opt, 32, segment_frames=16,
                               mpd=mpd, msd=msd)
    batch = E2EBatch(acoustic, torch.from_numpy(_speech(3, 90 * 256, 9)).to(cuda))
    before = (mas.launches, ctc_fwd.launches, ctc_bwd.launches)
    for _ in range(2):
        state, metrics = step(state, batch)
        assert all(torch.isfinite(v).item() for v in metrics.values())
    torch.cuda.synchronize()
    assert (mas.launches, ctc_fwd.launches, ctc_bwd.launches) == tuple(n + 2 for n in before)
    assert state.step == 2
    assert all(p.grad is None for m in (model, gen, mpd, msd) for p in m.parameters())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A synthetic corpus of 2 sentences x 2 speakers and its file list."""
    from e2e_tts_tpu_torch.data import create_unsupervised_filelist, read_filelist
    from e2e_tts_tpu_torch.data.synthetic import make_synthetic_corpus

    root = str(tmp_path_factory.mktemp("corpus"))
    make_synthetic_corpus(root, n_sentences=2, f0_jitter=0.1, seed=0)
    create_unsupervised_filelist([root], f"{root}/list.txt")
    return root, read_filelist(f"{root}/list.txt")


def test_card_features_match_cpu(cuda, corpus, tmp_path):
    """``create_utterance_features`` on the card against the CPU on one
    utterance: log-mel MAE < 1e-4, energy max < 2e-2, f0 and pitch (host
    code) equal."""
    import shutil

    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.data import create_utterance_features

    wav = corpus[1][0][0]
    copy = tmp_path / "wavs"
    copy.mkdir()
    shutil.copy(wav, copy)
    cpu = create_utterance_features(str(copy / wav.rsplit("/", 1)[1]), default_config(),
                                    device="cpu")
    gpu = create_utterance_features(wav, default_config(), overwrite=True, device=cuda)
    assert {k: v.shape for k, v in gpu.items()} == {k: v.shape for k, v in cpu.items()}
    assert np.abs(gpu["mels"] - cpu["mels"]).mean() < 1e-4
    assert np.abs(gpu["energy"] - cpu["energy"]).max() < 2e-2
    np.testing.assert_array_equal(gpu["f0"], cpu["f0"])
    np.testing.assert_array_equal(gpu["pitch"], cpu["pitch"])


def test_default_width_train_step_on_a_corpus_batch(cuda, corpus):
    """Features, stats and a bucketed batch of the corpus, then one train step
    of the default-width model on the card: MAS and both CTC kernels launch
    once, the losses are finite."""
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.data import (AcousticDataset, build_speaker_map, compute_stats,
                                        create_utterance_features, make_acoustic_batches)
    from e2e_tts_tpu_torch.kernels.ctc import ctc_bwd, ctc_fwd
    from e2e_tts_tpu_torch.kernels.mas import mas
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train import (acoustic_optimizer, build_acoustic_model,
                                         init_train_state, make_train_step)

    cfg = default_config()
    _, entries = corpus
    for wav, *_ in entries:
        create_utterance_features(wav, cfg, device=cuda)
    speakers = build_speaker_map(entries)
    ds = AcousticDataset(entries, speakers, compute_stats(entries), cfg)
    batch = next(make_acoustic_batches(ds, 4, seed=0, device=cuda))
    assert batch.mel.is_cuda and batch.mel.shape[0] == 4
    model = build_acoustic_model(cfg, len(symbols), len(speakers), device=cuda)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer, cfg.models.fastspeech2.encoder_hidden)
    state = init_train_state(model, opt)
    before = (mas.launches, ctc_fwd.launches, ctc_bwd.launches)
    _, metrics = make_train_step(model, cfg, opt, 256)(state, batch)
    torch.cuda.synchronize()
    assert (mas.launches, ctc_fwd.launches, ctc_bwd.launches) == tuple(n + 1 for n in before)
    assert all(torch.isfinite(v).item() for v in metrics.values())


def test_data_entry_points_raise_without_a_card(corpus):
    """``device=None`` means CUDA: without a card the feature and batch entry
    points raise instead of running on the CPU (a CPU test)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.data import (AcousticDataset, VocoderDataset, build_speaker_map,
                                        create_utterance_features, make_acoustic_batches,
                                        make_vocoder_batches)

    _, entries = corpus
    with pytest.raises(RuntimeError, match="CUDA"):
        create_utterance_features(entries[0][0], default_config())
    for wav, *_ in entries:
        create_utterance_features(wav, default_config(), device="cpu")
    stats = {k: {"mean": 0.0, "std": 1.0} for k in ("pitch", "energy", "f0")}
    ds = AcousticDataset(entries, build_speaker_map(entries), stats, default_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_acoustic_batches(ds, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_vocoder_batches(VocoderDataset(entries, default_config()), 2)


FAMILY_SMALL = {  # tests/test_blocks.py::_cfg's widths
    "conformer": dict(encoder_head=4, decoder_head=4, encoder_dropout=0.0, decoder_dropout=0.0),
    "fastformer": dict(conv_filter_size=64, encoder_dropout=0.0, decoder_dropout=0.0),
    "lstransformer": dict(conv_filter_size=64, window_size=16, r=1, encoder_dropout=0.0,
                          decoder_dropout=0.0),
    "reformer": dict(encoder_head=4, decoder_head=4, bucket_size=8, n_hashes=2,
                     encoder_dropout=0.0, decoder_dropout=0.0),
}


@pytest.mark.parametrize("family", sorted(FAMILY_SMALL))
def test_block_family_on_cuda_matches_cpu(cuda, family):
    """A family's encoder and decoder (2 + 2 layers, hidden 64, dropout 0) on
    the card against the same weights on the CPU, cuDNN's TF32 off: the
    forward in training mode (the conformer's BatchNorm on batch statistics)
    within 1e-4 x max |output|, each gradient within 1e-3 relative norm, and
    the BatchNorm statistics after it within 1e-5; no flash launch."""
    import copy

    from e2e_tts_tpu_torch.config import default_config
    from e2e_tts_tpu_torch.models.blocks import build_decoder, build_encoder

    torch.backends.cudnn.allow_tf32 = False
    fs2 = default_config().models.fastspeech2
    bb = fs2.building_block
    fs2 = fs2.replace(encoder_layers=2, decoder_layers=2, encoder_hidden=64, decoder_hidden=64,
                      building_block=bb.replace(block_type=family, **{family: getattr(
                          bb, family).replace(**FAMILY_SMALL[family])}))
    g = torch.Generator().manual_seed(0)
    mods = {"cpu": (build_encoder(fs2, 40, generator=g, device="cpu"),
                    build_decoder(fs2, generator=g, device="cpu"))}
    mods["cuda"] = tuple(copy.deepcopy(m).to("cuda") for m in mods["cpu"])
    rng = np.random.RandomState(3)
    mask = np.arange(37)[None] < np.array([37, 28, 18])[:, None]
    ids = rng.randint(1, 41, mask.shape) * mask
    x = rng.randn(3, 37, 64).astype(np.float32)
    # a fixed random projection of the outputs: the sum of squares of a
    # LayerNorm's output barely depends on its input, and its gradient is noise
    proj = rng.randn(2, 3, 37, 64).astype(np.float32)
    out = {}
    before = (flash_attention.launches, flash_attention.launches_16,
              flash_attention.launches_16_sm90)
    for device, (enc, dec) in mods.items():
        m = torch.from_numpy(mask).to(device)
        pe, pd = (torch.from_numpy(p).to(device) for p in proj)
        ye, _ = enc(torch.from_numpy(ids).to(device), m, None, True)
        yd, _ = dec(torch.from_numpy(x).to(device), m, None, True)
        ((ye * pe).sum() + (yd * pd).sum()).backward()
        out[device] = (ye.detach().cpu(), yd.detach().cpu())
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_16,
            flash_attention.launches_16_sm90) == before
    for got, want in zip(out["cuda"], out["cpu"]):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    for (c_mod, g_mod) in zip(mods["cpu"], mods["cuda"]):
        grads = dict(g_mod.named_parameters())
        for name, p in c_mod.named_parameters():
            if name.endswith(("mhsa.key_proj.bias", "attn_logits.bias")):
                continue  # 0 by construction: float noise on both
            err = ((grads[name].grad.cpu() - p.grad).norm() / p.grad.norm().clamp(min=1e-30))
            assert err.item() < 1e-3, name
        bufs = dict(g_mod.named_buffers())
        for name, b in c_mod.named_buffers():
            assert (bufs[name].cpu() - b).abs().max() <= 1e-5, name


def test_reformer_rotation_table_on_cuda(cuda):
    """The key-0 rotation table in bfloat16 and float32, built on the host
    and kept on the card, equals the host's draw bit for bit; a second call
    returns the kept table."""
    from e2e_tts_tpu_torch.ops import jax_random

    for dtype in (torch.bfloat16, torch.float32):
        shape = (48, 4, 8)
        table = jax_random.lsh_rotations(shape, dtype, "cuda")
        assert table.is_cuda and table.dtype == dtype
        assert torch.equal(table.cpu(), jax_random.normal(jax_random.key_data(0), shape, dtype))
        assert jax_random.lsh_rotations(shape, dtype, "cuda") is table


# --- the router, voice conversion and scoring on the card ------------------------------


def test_router_vie_tiny_on_cuda_matches_cpu(cuda, tmp_path):
    """The router's Vietnamese voice on the card launches the flash kernel
    (the request's mel bucket is >= 256) and is within 1 LSB on average of
    the same router on the CPU."""
    import os

    from chip_smoke import REQUESTS
    from e2e_tts_tpu_torch.synthesizer import Synthesizer, discover_bundles

    bundles = {"vie": discover_bundles()["vie"]}
    text = REQUESTS[-1]
    outs = {}
    for dev in (cuda, "cpu"):
        r = Synthesizer(bundles=bundles, auto_discover=False, device=dev,
                        output_dir=str(tmp_path / str(dev)))
        assert r.model_dict["vie"].engine.device.type == torch.device(dev).type
        before = flash_attention.launches
        outs[str(dev)] = r.model_dict["vie"].synthesize_array(text)
        if dev is cuda:
            assert flash_attention.launches > before
    a, b = outs["cuda"], outs["cpu"]
    assert len(a) == len(b) > 0
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).mean() < 1.0


def test_knn_match_on_cuda_matches_cpu(cuda):
    """``_knn_match`` on the card: at least 99.9% of the source frames pick
    the CPU's target frames, and on those the mel is within 1e-3."""
    from e2e_tts_tpu_torch.serve.voice_conversion import _knn_match

    rng = np.random.RandomState(0)
    sf, tf = (rng.randn(n, 200).astype(np.float32) for n in (512, 768))
    tm = rng.randn(768, 80).astype(np.float32)
    mask = np.arange(768) < 700
    outs = [_knn_match(*(torch.from_numpy(a).to(dev) for a in (sf, tf, tm, mask)), k=4)
            for dev in (cuda, "cpu")]
    (mel_g, idx_g), (mel_c, idx_c) = ((m.cpu().numpy(), i.cpu().numpy()) for m, i in outs)
    same = (idx_g == idx_c).all(axis=1)
    assert same.mean() >= 0.999
    assert np.abs(mel_g[same] - mel_c[same]).max() < 1e-3


def test_mos_predictor_on_cuda_matches_cpu(cuda):
    """``LearnedMosScorer`` on the card scores each anchor within 1e-4 of
    the CPU."""
    import glob
    import os

    from e2e_tts_tpu_torch.audio.wav import read_wav
    from e2e_tts_tpu_torch.utils.metrics import LearnedMosScorer

    anchors = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", "mos", "anchors", "*.wav")))
    assert anchors
    gpu, cpu = LearnedMosScorer(device=cuda), LearnedMosScorer(device="cpu")
    assert next(gpu.model.parameters()).is_cuda
    for path in anchors:
        audio, sr = read_wav(path)
        assert abs(gpu(audio, sr) - cpu(audio, sr)) < 1e-4, path
