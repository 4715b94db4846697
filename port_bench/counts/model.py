"""Model FLOPs of FastSpeech2, HiFi-GAN and iSTFTNet from a configuration's
widths, at real lengths: a phoneme sequence's own length, its own frames
and samples, never a padded bucket.  A multiply-add is 2 FLOPs.  Counted:
every matrix product and convolution (attention's q k^T and its weighted
sum of v included); not counted: softmax, norms, activations, embeddings
and the inverse STFT, each a few FLOPs an element.  Training is the forward
pass plus a backward pass of twice its FLOPs (3x), recomputation not
counted.  An encoder or decoder layer is its block family's: ``_fft_layer``
for the transformer, ``layer(n, d, blk)`` of ``blocks/<block_type>.py``
(``blk`` the family's block of the configuration) for any other, under the
same rules.
"""

from __future__ import annotations

import importlib


def _fft_layer(n: int, d: int, f: int, k1: int, k2: int) -> float:
    """One FFT block over n positions: q, k, v and fc (8 n d^2), scores and
    the weighted sum (4 n^2 d), the two convolutions."""
    return 8.0 * n * d * d + 4.0 * n * n * d + 2.0 * n * f * d * (k1 + k2)


def block_layer(n: int, d: int, fs2: dict) -> float:
    """One encoder or decoder layer of the configuration's block family over
    n positions at width d."""
    block_type = fs2["building_block"]["block_type"]
    blk = fs2["building_block"][block_type]
    if block_type == "transformer":
        return _fft_layer(n, d, blk["conv_filter_size"], *blk["conv_kernel_size"])
    return importlib.import_module(f"{__package__}.blocks.{block_type}").layer(n, d, blk)


def _conv(n: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * n * c_in * c_out * k


def acoustic_stage1(L: int, config: dict) -> float:
    fs2 = config["models"]["fastspeech2"]
    d = fs2["encoder_hidden"]
    vp = fs2["variance"]["variance_predictor"]
    n_mels = config["audio"]["mel"]["channels"]
    total = fs2["encoder_layers"] * block_layer(L, d, fs2)
    # duration predictor: n_mels channels, then a 1-wide head
    kd = vp["dur_predictor_kernel"]
    total += _conv(L, d, n_mels, kd) + (vp["dur_predictor_layers"] - 1) * _conv(L, n_mels, n_mels, kd)
    total += _conv(L, n_mels, 1, 1)
    fs = vp["filter_size"]
    for layers, k, out in ((vp["pit_predictor_layers"], vp["pit_predictor_kernel"], 2),
                           (vp["ener_predictor_layers"], vp["ener_predictor_kernel"], 1)):
        total += _conv(L, d, fs, k) + (layers - 1) * _conv(L, fs, fs, k) + _conv(L, fs, out, 1)
    return total


def acoustic_stage2(T: int, config: dict) -> float:
    fs2 = config["models"]["fastspeech2"]
    d = fs2["decoder_hidden"]
    n_mels = config["audio"]["mel"]["channels"]
    pn = fs2["postnet"]
    e, k, n = pn["embedding_dim"], pn["kernel_size"], pn["conv_layers"]
    total = fs2["decoder_layers"] * block_layer(T, d, fs2) + _conv(T, d, n_mels, 1)
    total += _conv(T, n_mels, e, k) + (n - 2) * _conv(T, e, e, k) + _conv(T, e, n_mels, k)
    return total


def vocoder(T: int, config: dict, kind: str) -> float:
    """T mel frames through the generator."""
    cfg = config["models"]["hifigan" if kind == "hifigan" else "istft"]
    n_mels = config["audio"]["mel"]["channels"]
    ch = cfg["upsample_initial_channel"]
    total = _conv(T, n_mels, ch, 7)
    n = T
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        total += 2.0 * n * c_in * c_out * k  # each input sample reaches k outputs a channel pair
        n *= u
        for rk, dil in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            total += 2 * len(dil) * _conv(n, c_out, c_out, rk)
    c_last = ch // 2 ** len(cfg["upsample_rates"])
    out = 1 if kind == "hifigan" else cfg["gen_istft_n_fft"] + 2
    return total + _conv(n, c_last, out, 7)


def aligner(L: int, T: int, config: dict) -> float:
    """The aligner's projections and convolutions, the distances and the
    soft expansion of the phonemes to T frames."""
    fs2 = config["models"]["fastspeech2"]
    d = fs2["encoder_hidden"]
    m = config["audio"]["mel"]["channels"]
    total = _conv(L, d, 2 * d, 3) + _conv(L, 2 * d, m, 1)
    total += _conv(T, m, 2 * m, 3) + _conv(T, 2 * m, m, 1) + _conv(T, m, m, 1)
    return total + 2.0 * T * L * m + 2.0 * T * L * d


def serve_row(L: int, T: int, config: dict, kind: str) -> float:
    return acoustic_stage1(L, config) + acoustic_stage2(T, config) + vocoder(T, config, kind)


def train_row(L: int, T: int, config: dict) -> float:
    return 3.0 * (acoustic_stage1(L, config) + acoustic_stage2(T, config) + aligner(L, T, config))
