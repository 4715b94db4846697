"""The plain reference held to the port at a tiny size on the CPU (the
whole serving and training paths are held to it by ``test_harness``'s
runs; these hold the pieces those runs reach only in part)."""

from __future__ import annotations

import pytest
import torch

from port_bench.gen.weights import load, seeded_weights
from port_bench.reference import training, vocoders
from port_bench.reference.serving_rules import request_sequences
from port_bench.tests.tiny import tiny_config

CPU = torch.device("cpu")


def _generator(kind):
    from e2e_tts_tpu_torch.config import Config
    from e2e_tts_tpu_torch.models.vocoder import build_generator, vocode

    cfg = tiny_config("fs2_hifigan_v1")
    config = Config.from_dict(cfg["config"])
    gen = build_generator(config, kind, device="cpu")
    weights = seeded_weights(gen, cfg["init"], 3, CPU)
    load(gen, weights)
    sub = cfg["config"]["models"]["hifigan" if kind == "hifigan" else "istft"]
    return gen, weights, sub, lambda mel: vocode(gen, mel, config, kind)


def test_vocoders_match_the_ports():
    mel = torch.randn(2, 24, 80, generator=torch.Generator().manual_seed(0))
    for kind in ("hifigan", "istft"):
        _, weights, sub, port = _generator(kind)
        with torch.no_grad():
            want = port(mel)
        got = vocoders.vocode(weights, kind, sub, mel)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) < 1e-5 * max(1.0, float(want.abs().max()))


def test_mas_matches_the_ports_plain_version():
    from e2e_tts_tpu_torch.kernels.mas import mas_plain

    g = torch.Generator().manual_seed(1)
    soft = torch.softmax(torch.randn(3, 40, 12, generator=g), -1)
    tl, ml = torch.tensor([12, 7, 9]), torch.tensor([40, 25, 31])
    want = mas_plain(torch.log(torch.clamp(soft, min=1e-30)), tl, ml)
    assert torch.equal(training.monotonic_alignment(soft, tl, ml), want)


def test_forward_sum_matches_the_ports():
    from e2e_tts_tpu_torch.ops.ctc import forward_sum_loss

    g = torch.Generator().manual_seed(2)
    logprob = torch.randn(3, 30, 10, generator=g)
    tl, ml = torch.tensor([10, 6, 8]), torch.tensor([30, 20, 25])
    assert abs(float(training.forward_sum(logprob, tl, ml)) - float(forward_sum_loss(logprob, tl, ml))) < 1e-5


def test_the_frontend_copy_gives_the_engines_rows():
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    eng = SynthesisEngine.from_random(seed=0, config=None, device="cpu")
    text = ("hôm nay trời đẹp, chúng ta cùng nhau đi dạo quanh hồ gươm nhé. " * 9).strip()
    seqs, _ = eng.prepare_request(text)
    mine = request_sequences(text)
    assert len(mine) == len(seqs) > 1
    assert all(list(a) == list(b) for a, b in zip(mine, seqs))


def test_stage_two_follows_the_program_only_across_a_boundary():
    from port_bench.compare.serving import Reference
    from port_bench.reference.fs2 import FastSpeech2

    cfg = tiny_config("fs2_hifigan_v1")
    ref = Reference.__new__(Reference)
    ref.device = CPU
    ref.model = FastSpeech2({"mel_linear.weight": torch.zeros(1)}, cfg["config"], cfg["stats"])
    limits = {"logd_gap": 1e-4, "pitch_gap": 1e-4, "energy_gap": 1e-4}
    # exp(log d) - 1 = 2.5 rounds to 2; just above it the program's rounds to 3
    log_d = torch.log(torch.tensor([3.5, 4.0, 6.0]))
    prog_log_d = log_d + torch.tensor([2e-5, 0.0, 0.3])   # a straddle, equal, far apart
    pitch = torch.tensor([[0.1, -1.0], [0.2, 3e-5], [0.3, 1.0]])
    prog_pitch = pitch * torch.tensor([[1.0, 1.0], [1.0, -1.0], [1.0, 1.0]])  # uv flips near 0
    energy = torch.tensor([0.5, 1.0, 2.0])
    (d, p, e), followed, apart = ref.follow_straddles((log_d, pitch, energy),
                                                      (prog_log_d, prog_pitch, energy), limits)
    assert followed == 2 and apart == 1
    assert torch.equal(d, torch.stack([prog_log_d[0], log_d[1], log_d[2]]))
    assert torch.equal(p, torch.stack([pitch[0], prog_pitch[1], pitch[2]]))
    assert torch.equal(e, energy)


# --- block families ---------------------------------------------------------------------


def _acoustic_weights(cfg, seed):
    """The seeded weights of the port's acoustic model for the configuration
    file ``cfg``, each moved by noise so that no bias or norm is its init."""
    from e2e_tts_tpu_torch.config import Config
    from e2e_tts_tpu_torch.text.symbols import symbols
    from e2e_tts_tpu_torch.train import build_acoustic_model

    model = build_acoustic_model(Config.from_dict(cfg["config"]), len(symbols),
                                 n_speakers=cfg["speakers"], device="cpu")
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.05 * torch.randn(v.shape, generator=g) if v.is_floating_point() else v
            for k, v in seeded_weights(model, cfg["init"], seed, CPU).items()}


def _direct_fft_stacks(config):
    """The transformer's encoder and decoder written out: sinusoid positions,
    padded rows zeroed, ``fft_block`` layer by layer with the side's heads
    and rate, all read from the configuration here."""
    from port_bench.reference.fs2 import fft_block, sinusoid_table

    fs2 = config["models"]["fastspeech2"]
    blk = fs2["building_block"]["transformer"]

    def stack(P, prefix, x, mask, _blk, _n_layers, _side, drop, _train):
        pos = torch.from_numpy(sinusoid_table(x.shape[1], x.shape[2]))
        x = (x + pos[None]) * mask[..., None]
        for i in range(fs2[f"{prefix}_layers"]):
            x = fft_block(P, f"{prefix}.layers.{i}", x, mask, blk[f"{prefix}_head"],
                          blk[f"{prefix}_dropout"], drop)
        return x

    return stack


def _train_batch(L, T, B=3, seed=4):
    g = torch.Generator().manual_seed(seed)
    txt_lens, mel_lens = torch.tensor([L, L - 3, L - 7]), torch.tensor([T, T - 9, T - 20])
    texts = torch.randint(1, 60, (B, L), generator=g)
    texts = texts * (torch.arange(L)[None] < txt_lens[:, None])
    mel_mask = (torch.arange(T)[None] < mel_lens[:, None]).float()
    prior = torch.softmax(torch.randn(B, T, L, generator=g), -1)
    return dict(texts=texts, txt_lens=txt_lens, mel_lens=mel_lens,
                speakers=torch.tensor([0, 3, 1]), prior=prior,
                mel=torch.randn(B, T, 80, generator=g) * mel_mask[..., None],
                f0=torch.randn(B, T, generator=g) * mel_mask,
                uv=(torch.rand(B, T, generator=g) < 0.3).float() * mel_mask,
                energy=torch.randn(B, T, generator=g) * mel_mask)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("name", ["fs2_hifigan_v1", "fs2_istftnet_c8c8i"])
def test_the_transformer_stacks_are_the_direct_composition_to_the_bit(name):
    from port_bench.reference.fs2 import FastSpeech2

    cfg = tiny_config(name)
    fs2 = cfg["config"]["models"]["fastspeech2"]
    fs2["decoder_layers"] = 3  # the sides apart, so that neither can take the other's
    fs2["building_block"]["transformer"].update(decoder_head=4, decoder_dropout=0.2)
    P = _acoustic_weights(cfg, 11)
    model = FastSpeech2(P, cfg["config"], cfg["stats"])
    direct = FastSpeech2(P, cfg["config"], cfg["stats"])
    direct.stack = _direct_fft_stacks(cfg["config"])
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, 60, (2, 17), generator=g) * (torch.arange(17)[None] < torch.tensor(
        [[17], [11]]))
    speakers = torch.tensor([2, 0])
    one = model.stage1(tokens, speakers)
    assert _equal(one, direct.stage1(tokens, speakers))
    x, _, pitch, energy, _ = one
    durations = torch.randint(0, 6, (2, 17), generator=g) * (tokens != 0)
    assert _equal(model.stage2(x, pitch, energy, durations, 64),
                  direct.stage2(x, pitch, energy, durations, 64))
    batch = _train_batch(15, 70)
    for step in (0, 7000):  # the soft expansion, then the hard one
        got = model.train_forward(batch, step, torch.Generator().manual_seed(9), None)
        want = direct.train_forward(batch, step, torch.Generator().manual_seed(9), None)
        assert _equal(got, want), step


@pytest.mark.parametrize("T", [1, 2, 7])
def test_the_conformer_skew_follows_the_index_formula(T):
    from port_bench.reference.blocks.conformer import skew

    s = torch.randn(2, 3, T, T, generator=torch.Generator().manual_seed(T))
    want = torch.zeros_like(s)
    for i in range(T):
        for j in range(T):
            if j <= i:
                want[..., i, j] = s[..., i, T - 1 - i + j]
            elif j >= i + 2:
                want[..., i, j] = s[..., i + 1, j - i - 2]
    assert torch.equal(skew(s), want)


def _conformer_pair(side, mask_attention, seed=1):
    """The port's conformer encoder or decoder at a tiny width with every
    parameter and running statistic moved off its init, and its weights."""
    from e2e_tts_tpu_torch.nn.conformer import ConformerDecoder, ConformerEncoder

    blk = dict(tiny_config("fs2_hifigan_v1", "conformer")["config"]["models"]["fastspeech2"]
               ["building_block"]["conformer"], mask_attention=mask_attention)
    g = torch.Generator().manual_seed(seed)
    args = (2, 32, blk[f"{side}_head"], blk["ffn_expansion_factor"], blk["conv_kernel_size"],
            blk["conv_expansion_factor"], blk["half_step_residual"], blk[f"{side}_dropout"],
            mask_attention)
    module = (ConformerEncoder(20, *args, generator=g) if side == "encoder"
              else ConformerDecoder(*args, generator=g))
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
        for n, b in module.named_buffers():
            if n.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif n.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    return module, blk, {f"{side}.{k}": v.detach() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("mask_attention", [True, False])
@pytest.mark.parametrize("side", ["encoder", "decoder"])
@pytest.mark.parametrize("train", [False, True])
def test_the_conformer_stack_matches_the_ports(side, train, mask_attention):
    from port_bench.reference.blocks.conformer import stack
    from port_bench.reference.fs2 import Dropout

    module, blk, P = _conformer_pair(side, mask_attention)
    module.train(train)
    g = torch.Generator().manual_seed(2)
    lens = torch.tensor([13, 9, 4])
    mask = torch.arange(13)[None] < lens[:, None]
    if side == "encoder":
        x = torch.randint(1, 20, (3, 13), generator=g) * mask
    else:
        x = torch.randn(3, 13, 32, generator=g) * mask[..., None]
    with torch.no_grad():
        want, emb = module(x, mask, torch.Generator().manual_seed(5) if train else None, train)
        x = emb if side == "encoder" else x
        got = stack(P, side, x, mask, blk, 2, side,
                    Dropout(torch.Generator().manual_seed(5) if train else None), train)
    # both sides are float32 products and sums of the same terms, but not one
    # program: the order of a reduction is the library's choice for each
    # einsum and linear, which moves a result by a few ulp (~1e-7) a layer;
    # 1e-5 of the output leaves that room over both layers and no more
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), side
