"""Public synthesis API (port of ``e2e_tts_tpu/serve/inference.py``).

``Synthesizer`` normalizes text (in process by default; or through an HTTP
endpoint that falls back to the in-process normalizer when it is down),
synthesizes, writes a wav, and optionally changes its speed.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional

import numpy as np

from ..audio.wav import write_wav
from ..text.frontends import get_frontend
from ..text.normalizer import HttpNormalizer
from .audio_post import audio_speed_change
from .engine import SynthesisEngine


class Synthesizer:
    """text -> wav file through a ``SynthesisEngine``: an engine given, or one
    loaded from ``bundle_dir`` onto ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(
        self,
        engine: Optional[SynthesisEngine] = None,
        bundle_dir: Optional[str] = None,
        output_dir: str = "outputs",
        normalizer: Optional[Callable[[str], str]] = None,
        normalize_url: Optional[str] = None,
        log_path: Optional[str] = None,
        device=None,
    ) -> None:
        if engine is None:
            if bundle_dir is None:
                raise ValueError("need engine or bundle_dir")
            engine = SynthesisEngine.from_checkpoint(bundle_dir, device=device)
        self.engine = engine
        # every language normalizes through its own frontend, so digits,
        # currency and dates never reach the G2P raw
        lang_normalize = get_frontend(getattr(engine, "language", "vie")).normalize
        if normalizer is not None:
            self.normalize = normalizer
        elif normalize_url:
            self.normalize = HttpNormalizer(normalize_url, fallback=lang_normalize)
        else:
            self.normalize = lang_normalize
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        # one JSONL record per synthesis call, with the engine's degraded-output
        # events of that call
        self.logger = None
        if log_path is not None:
            from ..utils.logging import ServeLogger

            self.logger = ServeLogger(log_path)

    def close(self):
        """Close the request log, if there is one."""
        if self.logger is not None:
            self.logger.close()

    def tts_to_file(self, text: str, file_path: str, speed: float = 1.0):
        return self.synthesis(text, file_path, speed)

    def synthesis(
        self,
        text: str,
        save_filepath: Optional[str] = None,
        speed: float = 1.0,
        speaker_id: Optional[str] = None,
        sr: Optional[int] = None,
        pitch_control: float = 1.0,
        energy_control: float = 1.0,
        duration_control: float = 1.0,
        silence_distance: float = 0.5,
    ) -> str:
        if not text:
            raise ValueError("empty text")
        text = self.normalize(text)

        if not save_filepath:
            stamp = datetime.datetime.now().strftime("%m_%d_%Y_%H_%M_%S")
            save_filepath = os.path.join(self.output_dir, f"{stamp}.wav")
            n = 1
            while os.path.exists(save_filepath):
                # second-resolution stamps collide for back-to-back calls;
                # never overwrite an earlier synthesis
                save_filepath = os.path.join(self.output_dir, f"{stamp}_{n}.wav")
                n += 1

        events: list = []
        prev_sink = self.engine.on_event
        if self.logger is not None:
            # collect this request's engine events, chaining any subscriber
            self.engine.on_event = (
                events.append
                if prev_sink is None
                else lambda rec: (events.append(rec), prev_sink(rec))
            )
        t0 = time.perf_counter()
        try:
            audio = self.engine.synthesize(
                text,
                speaker_id=speaker_id,
                pitch_control=pitch_control,
                energy_control=energy_control,
                duration_control=duration_control,
                silence_distance=silence_distance,
            )
        finally:
            if self.logger is not None:
                self.engine.on_event = prev_sink
        if self.logger is not None:
            self.logger.log_request(
                text_chars=len(text),
                speaker_id=speaker_id,
                speed=speed,
                audio_s=round(len(audio) / self.engine.sample_rate, 3),
                wall_s=round(time.perf_counter() - t0, 4),
                events=events,
                path=save_filepath,
            )
        if sr and sr != self.engine.sample_rate:
            # resample: engine-rate samples under another header would change
            # playback speed and pitch
            n_out = int(round(len(audio) * sr / self.engine.sample_rate))
            x = audio.astype(np.float32)
            audio = np.interp(
                np.arange(n_out) * (len(x) - 1) / max(n_out - 1, 1),
                np.arange(len(x)),
                x,
            ).astype(np.int16)
        write_wav(save_filepath, audio, sr or self.engine.sample_rate)
        if speed != 1.0:
            save_filepath = audio_speed_change(save_filepath, speed_rate=speed)
        return save_filepath

    def synthesize_array(self, text: str, **kw) -> np.ndarray:
        """text -> int16 numpy waveform (no file I/O)."""
        return self.engine.synthesize(self.normalize(text), **kw)
