"""The PyTorch port's audio ops (``e2e_tts_tpu_torch/audio``) against the JAX
package's, on the same numpy inputs, on the CPU.

Bars: filterbank and window equal; log-mel MAE < 1e-4; per-frame energy
max |diff| < 2e-2 (a norm over 513 bins of magnitudes up to ~100);
``inverse_stft`` max |diff| < 1e-4 at the same length; ``num_frames`` equal;
a wav round trip exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.audio import filters as jax_filters
from e2e_tts_tpu.audio import mel as jax_mel
from e2e_tts_tpu.audio import wav as jax_wav
from e2e_tts_tpu_torch.audio import filters, mel, wav

pytestmark = pytest.mark.usefixtures("one_thread")

MEL_MAE = 1e-4
ENERGY_MAX = 2e-2
ISTFT_MAX = 1e-4


@pytest.mark.parametrize("args", [(22050, 1024, 80, 0.0, 8000.0), (16000, 512, 40, 50.0, None)])
def test_filterbank_and_window_equal_jax(args):
    np.testing.assert_array_equal(filters.mel_filterbank(*args), jax_filters.mel_filterbank(*args))
    for n in (16, 512, 1024):
        np.testing.assert_array_equal(filters.hann_window(n), jax_filters.hann_window(n))


def _audio(seed, shape):
    rng = np.random.RandomState(seed)
    t = np.arange(shape[-1]) / 22050.0
    tone = 0.5 * np.sin(2 * np.pi * 220.0 * t)  # a tone, so mel bins span decades
    return (tone + 0.1 * rng.randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, dict(win_length=512)], ids=["default", "win512"])
def test_mel_spectrogram_matches_jax(kw):
    audio = _audio(0, (2, 22050 + 77))
    jp, pp = jax_mel.MelParams(**kw), mel.MelParams(**kw)
    want_mel, want_e = jax_mel.mel_spectrogram(jnp.asarray(audio), jp, return_energy=True)
    got_mel, got_e = mel.mel_spectrogram(torch.from_numpy(audio), pp, return_energy=True)
    want_mel, want_e = np.asarray(want_mel), np.asarray(want_e)
    assert got_mel.shape == want_mel.shape == (2, 80, mel.num_frames(audio.shape[-1], pp))
    assert np.abs(got_mel.numpy() - want_mel).mean() < MEL_MAE
    assert got_e.shape == want_e.shape
    assert np.abs(got_e.numpy() - want_e).max() < ENERGY_MAX
    # a single (T,) signal and the centre-padded magnitude too
    one = mel.stft_magnitude(torch.from_numpy(audio[0]), pp, center=True).numpy()
    np.testing.assert_allclose(
        one, np.asarray(jax_mel.stft_magnitude(jnp.asarray(audio[0]), jp, center=True)),
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_fft,hop,win,frames", [(16, 4, 16, 513), (1024, 256, 512, 40),
                                                  (1024, 256, 1024, 40)])
def test_inverse_stft_matches_jax(n_fft, hop, win, frames):
    rng = np.random.RandomState(n_fft + win)
    mag = np.exp(rng.randn(2, n_fft // 2 + 1, frames)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    want = np.asarray(jax_mel.inverse_stft(jnp.asarray(mag), jnp.asarray(phase), n_fft, hop, win))
    got = mel.inverse_stft(torch.from_numpy(mag), torch.from_numpy(phase), n_fft, hop, win).numpy()
    assert got.shape == want.shape == (2, hop * (frames - 1))
    assert np.abs(got - want).max() < ISTFT_MAX


def test_overlap_add_is_the_loop_sum():
    rng = np.random.RandomState(5)
    frames = rng.randn(3, 7, 12).astype(np.float32)
    want = np.zeros((3, 12 + 5 * 6), np.float32)
    for f in range(7):
        want[:, 5 * f: 5 * f + 12] += frames[:, f]
    np.testing.assert_allclose(mel.overlap_add(torch.from_numpy(frames), 5).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_dynamic_range_and_num_frames_match_jax():
    x = np.abs(np.random.RandomState(2).randn(50)).astype(np.float32) * 1e-3
    np.testing.assert_allclose(mel.dynamic_range_compression(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_mel.dynamic_range_compression(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(mel.dynamic_range_decompression(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_mel.dynamic_range_decompression(jnp.asarray(x))),
                               rtol=1e-6)
    for kw in ({}, dict(n_fft=16, hop_length=4, win_length=16)):
        for n in (0, 1, 255, 256, 22050, 286_650):
            assert mel.num_frames(n, mel.MelParams(**kw)) == jax_mel.num_frames(
                n, jax_mel.MelParams(**kw))


def test_mel_params_from_config_matches_jax():
    from e2e_tts_tpu.config import default_config as jax_default_config
    from e2e_tts_tpu_torch.config import default_config

    for loss in (False, True):
        got = mel.MelParams.from_config(default_config().audio, loss=loss)
        want = jax_mel.MelParams.from_config(jax_default_config().audio, loss=loss)
        assert got.__dict__ == want.__dict__


def test_wav_round_trip(tmp_path):
    audio = _audio(3, (4000,))
    i16 = wav.float_to_int16(audio)
    np.testing.assert_array_equal(i16, jax_wav.float_to_int16(audio))
    path = os.path.join(tmp_path, "a.wav")
    wav.write_wav(path, i16, 16000)
    back, sr = wav.read_wav(path)
    assert sr == 16000
    np.testing.assert_array_equal(back, i16.astype(np.float32) / wav.MAX_WAV_VALUE)
    wav.write_wav(path, audio)  # float in: clipped and scaled by 32767
    back, sr = wav.read_wav(path)
    want, _ = jax_wav.read_wav(path)
    assert sr == 22050 and np.array_equal(back, want)
    np.testing.assert_array_equal(
        (back * wav.MAX_WAV_VALUE).astype(np.int16),
        (np.clip(audio, -1, 1) * (wav.MAX_WAV_VALUE - 1)).astype(np.int16))
