"""The plain reference held to the port at a tiny size on the CPU (the
whole serving and training paths are held to it by ``test_harness``'s
runs; these hold the pieces those runs reach only in part)."""

from __future__ import annotations

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
