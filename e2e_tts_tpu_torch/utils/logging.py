"""Training and serving observability (port of
``e2e_tts_tpu/utils/logging.py``): ``ScalarWriter`` (tensorboardX where it
imports, and always a JSONL file of scalars), the acoustic and joint e2e
loggers with the reference's scalar names, and ``ServeLogger``.  The JSONL
records are the JAX package's, field for field."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class ScalarWriter:
    """SummaryWriter facade: ``scalars.jsonl`` in ``logdir``, and
    tensorboardX's event files too where it imports."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:
            self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        value = float(value)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": int(step), "ts": time.time()})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def audio(self, tag: str, audio: np.ndarray, step: int, sample_rate: int = 22050):
        if self._tb is not None:
            self._tb.add_audio(tag, audio[None, :], step, sample_rate=sample_rate)

    def histogram(self, tag: str, values: np.ndarray, step: int):
        """Parameter histogram; without tensorboardX the JSONL file records
        summary statistics instead of the histogram."""
        values = np.asarray(values).reshape(-1)
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)
        else:
            self._jsonl.write(
                json.dumps({
                    "tag": tag, "step": int(step), "kind": "histogram",
                    "mean": float(values.mean()), "std": float(values.std()),
                    "min": float(values.min()), "max": float(values.max()),
                    "n": int(values.size), "ts": time.time(),
                }) + "\n"
            )

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class AcousticLogger:
    """Per-step loss-dict scalars and the learning rate, under ``acoustic/``."""

    def __init__(self, logdir: str):
        self.writer = ScalarWriter(logdir)

    def log(self, step: int, losses: Dict[str, float], lr: Optional[float] = None):
        for k, v in losses.items():
            self.writer.scalar(f"acoustic/{k}", v, step)
        if lr is not None:
            self.writer.scalar("acoustic/lr", lr, step)

    def log_audio(self, step: int, tag: str, audio, sample_rate: int = 22050):
        self.writer.audio(f"acoustic/{tag}", np.asarray(audio), step, sample_rate)

    def log_params(self, step: int, model: torch.nn.Module):
        """A histogram of each parameter of ``model``, under its
        ``named_parameters`` name with "/" for "."; called on checkpoint
        steps."""
        for name, p in model.named_parameters():
            self.writer.histogram(f"acoustic/params/{name.replace('.', '/')}",
                                  p.detach().float().cpu().numpy(), step)

    def close(self):
        self.writer.close()


class E2ELogger:
    """Joint acoustic + GAN fine-tune logger: the reference's 14 scalars under
    ``e2e/``, any other metric under ``e2e/extra/``, and the real and
    generated audio."""

    SCALARS = (
        "total", "generator", "discriminator", "variance",
        "mpd", "msd", "fm", "mel",
        "duration", "pitch", "energy", "ctc", "bin", "postnet",
    )

    def __init__(self, logdir: str):
        self.writer = ScalarWriter(logdir)

    def log(self, step: int, metrics: Dict[str, float]):
        for k in self.SCALARS:
            if k in metrics:
                self.writer.scalar(f"e2e/{k}", metrics[k], step)
        for k, v in metrics.items():
            if k not in self.SCALARS:
                self.writer.scalar(f"e2e/extra/{k}", v, step)

    def log_audio(self, step: int, real, generated, sample_rate: int = 22050):
        self.writer.audio("e2e/audio_real", np.asarray(real), step, sample_rate)
        self.writer.audio("e2e/audio_generated", np.asarray(generated), step, sample_rate)

    def close(self):
        self.writer.close()


class ServeLogger:
    """Structured JSONL request logs for the serving path, one line a
    request; ``close`` closes the file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def log_request(self, **fields):
        fields["ts"] = time.time()
        self._f.write(json.dumps(fields, ensure_ascii=False) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
