"""The operation and byte counters, each against a count by hand at a tiny
shape, and the model FLOPs against the parameters they multiply."""

from __future__ import annotations

import copy
import json
import os

import pytest

from port_bench import harness
from port_bench.counts import kernels, model


def _config():
    with open(os.path.join(harness.HERE, "configs", "fs2_hifigan_v1.json")) as f:
        return json.load(f)["config"]


def test_flash_counts_valid_rows_only():
    # two rows of 3 and 5 valid keys, width 4: q k^T and p v are 2 kv^2 d each
    flops, bytes_ = kernels.flash([3, 5], 4)
    assert flops == 4 * (9 + 25) * 4
    assert bytes_ == 4 * (3 + 5) * 4 * 4  # q, k, v, o of the valid rows, 4 bytes


def test_mas_counts_valid_cells_read_and_the_whole_alignment_written():
    flops, bytes_ = kernels.mas([2, 3], [4, 5], T=6, L=3)
    assert flops == 2 * (2 * 4 + 3 * 5)
    assert bytes_ == 4 * ((2 * 4 + 3 * 5) + 2 * 6 * 3)


def test_ctc_counts_the_lattice_forward_and_backward():
    flops, bytes_ = kernels.ctc([2], [4], T=5, L=3)
    states = 4 * (2 * 2 + 1)
    assert flops == 16 * states
    lp = 4 * 3
    assert bytes_ == 4 * (lp + 2 * states + lp + 2) + 4 * (5 * 7 + 5 * 4 + 2)


def test_a_layer_of_the_encoder_by_hand():
    # d = 2, filter 3, kernels (1, 1), n = 2 positions
    assert model._fft_layer(2, 2, 3, 1, 1) == 8 * 2 * 4 + 4 * 4 * 2 + 2 * 2 * 3 * 2 * 2


def test_model_flops_grow_with_length_and_count_each_weight_twice():
    cfg = _config()
    # the decoder's per-frame products: 2 x its weights (attention, conv FFN) a frame
    fs2 = cfg["models"]["fastspeech2"]
    d, f = fs2["decoder_hidden"], 1024
    per_frame = fs2["decoder_layers"] * 2 * (4 * d * d + d * f * 9 + f * d * 1)
    two = model.acoustic_stage2(2, cfg)
    one = model.acoustic_stage2(1, cfg)
    attention_extra = fs2["decoder_layers"] * 4 * d * (4 - 1)  # 4 n^2 d at n = 2 less n = 1
    assert two - one == pytest.approx(per_frame + attention_extra + 2 * d * 80
                                      + 2 * 5 * (80 * 512 + 3 * 512 * 512 + 512 * 80))


def test_vocoder_flops_follow_the_upsampling():
    cfg = _config()
    one = model.vocoder(1, cfg, "hifigan")
    assert model.vocoder(3, cfg, "hifigan") == pytest.approx(3 * one)
    narrow = copy.deepcopy(cfg)
    narrow["models"]["hifigan"]["upsample_initial_channel"] = 256
    assert model.vocoder(1, narrow, "hifigan") == pytest.approx(one / 4, rel=0.01)


def test_training_is_three_forward_passes():
    cfg = _config()
    fwd = model.acoustic_stage1(40, cfg) + model.acoustic_stage2(300, cfg) + model.aligner(40, 300, cfg)
    assert model.train_row(40, 300, cfg) == pytest.approx(3 * fwd)


def _config_of(name):
    with open(os.path.join(harness.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)["config"]


# serve_row and train_row of the shipped configurations as the harness counted
# them before the block families were resolved by name
PINNED = [
    ("fs2_hifigan_v1", "hifigan", 7, 40, 27504106592.0, 8874052128.0),
    ("fs2_hifigan_v1", "hifigan", 61, 433, 298476157472.0, 98275442112.0),
    ("fs2_hifigan_v1", "hifigan", 250, 1987, 1396828813376.0, 533294933760.0),
    ("fs2_istftnet_c8c8i", "istft", 7, 40, 19403201632.0, 8874052128.0),
    ("fs2_istftnet_c8c8i", "istft", 61, 433, 210783861280.0, 98275442112.0),
    ("fs2_istftnet_c8c8i", "istft", 250, 1987, 994416359488.0, 533294933760.0),
]


@pytest.mark.parametrize("name,kind,L,T,serve,train", PINNED)
def test_the_transformers_rows_are_as_pinned(name, kind, L, T, serve, train):
    cfg = _config_of(name)
    assert model.serve_row(L, T, cfg, kind) == serve
    assert model.train_row(L, T, cfg) == train


def test_a_conformer_layer_by_hand():
    from port_bench.counts.blocks import conformer

    blk = {"ffn_expansion_factor": 4, "conv_expansion_factor": 2, "conv_kernel_size": 31}
    n, d = 3, 4
    ffn = 2 * (2 * n * d * 16 + 2 * n * 16 * d)        # d -> 4d -> d, twice
    projections = 5 * 2 * n * d * d                     # q, k, v, out, pos
    scores = 3 * 2 * n * n * d                          # content, position, weighted sum
    conv = 2 * n * d * 8 + 2 * n * d * 31 + 2 * n * d * d  # pw1 (d -> 2d), depthwise, pw2
    assert conformer.layer(n, d, blk) == ffn + projections + scores + conv == 3264


def test_a_conformer_configuration_counts_its_own_layers():
    from port_bench.counts.blocks import conformer

    trans = _config()
    conf = copy.deepcopy(trans)
    fs2 = conf["models"]["fastspeech2"]
    fs2["building_block"]["block_type"] = "conformer"
    blk, d = fs2["building_block"]["conformer"], fs2["decoder_hidden"]
    per_layer = conformer.layer(900, d, blk) - model._fft_layer(900, d, 1024, 9, 1)
    assert model.acoustic_stage2(900, conf) - model.acoustic_stage2(900, trans) == pytest.approx(
        fs2["decoder_layers"] * per_layer)
    assert model.train_row(40, 900, conf) == pytest.approx(
        3 * (model.acoustic_stage1(40, conf) + model.acoustic_stage2(900, conf)
             + model.aligner(40, 900, conf)))
