"""What the serving drivers share: the engine of a configuration file on the
benchmark's weights, and the recorder that reads the engine's work through
forward hooks on its public modules.

The recorder keeps, for every stage-1 call, the token ids, speakers, log
durations and pitch and energy predictions the call produced (references
to the device tensors; nothing waits for the device), the mel bucket of the
stage-2 call that follows it, and the shapes of the re-rendering stage-2
calls; with spans on, the host times (``time.time_ns``, the profiler's
clock) of every call of the acoustic model's parts and of the vocoder, to
attribute kernels to them.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from ..gen.weights import load, seeded_weights

ACOUSTIC_PARTS = ("encoder", "speaker_emb", "variance_adaptor.duration_predictor",
                  "variance_adaptor.pitch_predictor", "variance_adaptor.pitch_embedding",
                  "variance_adaptor.energy_predictor", "variance_adaptor.energy_embedding",
                  "decoder", "mel_linear", "postnet")


def build_engine(cfg_file: dict, seed: int, device):
    """(engine, acoustic weights, vocoder weights): the program's engine for
    the configuration, its weights replaced by the benchmark's seeded ones."""
    from e2e_tts_tpu_torch.config import Config
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    config = Config.from_dict(cfg_file["config"])
    engine = SynthesisEngine.from_random(seed=0, config=config, n_speakers=cfg_file["speakers"],
                                         vocoder_kind=cfg_file["vocoder"], device=device)
    init = cfg_file["init"]
    wa = seeded_weights(engine.acoustic, init, seed, device)
    wv = seeded_weights(engine.vocoder, init, seed + 1, device)
    load(engine.acoustic, wa)
    load(engine.vocoder, wv)
    return engine, wa, wv


@torch.no_grad()
def warm_shapes(engine, warm: dict) -> None:
    """Run each stage-1 shape (rows x text bucket) and each stage-2 and
    vocoder shape (rows x mel bucket up to ``mel_max``) that the mix's
    ``warm`` block names ``calls`` times (default once), so that their
    first calls (the kernels' build, cuDNN's and cuFFT's plans, the
    allocator's blocks) fall in set-up.  The engine graphs a serving
    module at a shape's second call (``serve/graphs.py``): with ``calls``
    2 those captures fall in set-up too, and none holds the window's
    replays behind its lock."""
    from e2e_tts_tpu_torch.models.vocoder import vocode

    ac, dev = engine.acoustic, engine.device
    H = ac.encoder.src_word_emb.weight.shape[1]
    for _ in range(warm.get("calls", 1)):
        for L in warm["text_buckets"]:
            for B in warm["stage1_rows"]:
                texts = torch.full((B, L), 5, dtype=torch.int64, device=dev)
                ac.synthesize_stage1(torch.zeros(B, dtype=torch.int64, device=dev), texts,
                                     torch.full((B,), L, dtype=torch.int64, device=dev))
        for T in range(128, warm["mel_max"] + 1, 128):
            for B in warm["stage2_rows"]:
                x = torch.zeros(B, 8, H, device=dev)
                d = torch.full((B, 8), T // 8, dtype=torch.int32, device=dev)
                mel, _ = ac.synthesize_stage2(x, d, max_mel_len=T)
                vocode(engine.vocoder, mel, engine.config, engine.vocoder_kind)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sub(module, path: str):
    for part in path.split("."):
        module = getattr(module, part)
    return module


class Recorder:
    """Forward hooks on ``engine.acoustic``'s parts and ``engine.vocoder``."""

    def __init__(self, engine):
        self.records: List[Dict] = []
        self.rerenders: List[tuple] = []
        self.spans: List[tuple] = []
        self.spans_on = False
        self._handles = []
        ac = engine.acoustic
        for path in ACOUSTIC_PARTS:
            self._hook(_sub(ac, path), "acoustic." + path.split(".")[-1])
        self._hook(engine.vocoder, "vocoder")
        self._on(ac.encoder, self._encoder)
        self._on(ac.speaker_emb, lambda m, a, o: self._set("speakers", a[0]))
        self._on(ac.variance_adaptor.duration_predictor, lambda m, a, o: self._set("log_d", o))
        self._on(ac.variance_adaptor.pitch_predictor, lambda m, a, o: self._set("pitch", o))
        self._on(ac.variance_adaptor.energy_predictor, lambda m, a, o: self._set("energy", o))
        self._on(ac.decoder, self._decoder)

    def _on(self, module, fn):
        self._handles.append(module.register_forward_hook(fn))

    def _hook(self, module, label):
        starts = []

        def pre(m, a):
            if self.spans_on:
                starts.append(time.time_ns())

        def post(m, a, o):
            if self.spans_on and starts:
                self.spans.append((starts.pop(), time.time_ns(), label))

        self._handles.append(module.register_forward_pre_hook(pre))
        self._handles.append(module.register_forward_hook(post))

    def _encoder(self, m, args, out):
        self.records.append({"tokens": args[0]})

    def _set(self, key, value):
        if self.records and key not in self.records[-1]:
            self.records[-1][key] = value

    def _decoder(self, m, args, out):
        mask = args[1]
        rec = self.records[-1] if self.records else None
        if rec is not None and "T" not in rec and "log_d" in rec:
            rec["T"], rec["dec_mask"] = int(mask.shape[1]), mask
        else:
            self.rerenders.append((int(mask.shape[0]), int(mask.shape[1]), mask))

    def clear(self):
        self.records.clear()
        self.rerenders.clear()
        self.spans.clear()

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles.clear()

    def to_host(self) -> Dict:
        """The window's records on the host: per stage-1 call its arrays, the
        stage-2 bucket, and the re-renders' (rows, T, mel lengths)."""
        recs = []
        for r in self.records:
            recs.append({"tokens": r["tokens"].cpu(), "speakers": r["speakers"].cpu(),
                         "log_d": r["log_d"].float().cpu(), "pitch": r["pitch"].float().cpu(),
                         "energy": r["energy"].float().cpu()[..., 0], "T": r["T"],
                         "mel_lens": r["dec_mask"].sum(-1).cpu()})
        rer = [(b, t, m.sum(-1).cpu()) for b, t, m in self.rerenders]
        return {"records": recs, "rerenders": rer, "spans": list(self.spans)}


def free() -> None:
    """Give the program's freed device memory back before the reference runs."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def real_rows(rec) -> torch.Tensor:
    """The rows of a stage-1 call that carry a chunk (padding rows hold no
    token)."""
    return (rec["tokens"][:, 0] != 0).nonzero().flatten()


def counters(host: Dict, cfg_file: dict, cycles: int = 0) -> Dict:
    """The per-layer readers' counts of a serving window, from the records."""
    from ..counts import kernels, model
    from ..reference.serving_rules import durations_from_log

    config, kind = cfg_file["config"], cfg_file["vocoder"]
    fs2 = config["models"]["fastspeech2"]
    d_enc, d_dec = fs2["encoder_hidden"], fs2["decoder_hidden"]
    flash = fs2["building_block"]["block_type"] == "transformer"
    hop, sr = config["audio"]["stft"]["hop_length"], config["audio"]["signal"]["sampling_rate"]
    rows = frames = decoder_bt = 0
    model_flops = flash_flops = flash_bytes = 0.0
    flash_calls = 0
    for rec in host["records"]:
        mask = rec["tokens"] != 0
        lens = mask.sum(-1)
        totals = (durations_from_log(rec["log_d"]) * mask).sum(-1)
        B, L = rec["tokens"].shape
        decoder_bt += B * rec["T"]
        for r in real_rows(rec).tolist():
            rows += 1
            frames += int(totals[r])
            model_flops += model.serve_row(int(lens[r]), int(totals[r]), config, kind)
        if flash and L >= FLASH_MIN_LEN:
            f, b = kernels.flash(lens.tolist(), d_enc)
            flash_flops += fs2["encoder_layers"] * f
            flash_bytes += fs2["encoder_layers"] * b
            flash_calls += fs2["encoder_layers"]
        if flash and rec["T"] >= FLASH_MIN_LEN:
            f, b = kernels.flash(rec["mel_lens"].tolist(), d_dec)
            flash_flops += fs2["decoder_layers"] * f
            flash_bytes += fs2["decoder_layers"] * b
            flash_calls += fs2["decoder_layers"]
    for b_rows, t, mel_lens in host["rerenders"]:
        decoder_bt += b_rows * t
        if flash and t >= FLASH_MIN_LEN:
            f, b = kernels.flash(mel_lens.tolist(), d_dec)
            flash_flops += fs2["decoder_layers"] * f
            flash_bytes += fs2["decoder_layers"] * b
            flash_calls += fs2["decoder_layers"]
    return {"rows": rows, "cycles": cycles, "frames": frames, "decoder_frames": decoder_bt,
            "audio_s": frames * hop / sr, "model_flops": model_flops,
            "flash_flops": flash_flops, "flash_bytes": flash_bytes, "flash_calls": flash_calls}


# attention over at least this many positions runs the flash kernel (the
# port's transformer at its default ``use_flash``; no other block family
# launches it)
FLASH_MIN_LEN = 256
