"""Multi-lingual synthesis router (port of the JAX package's repo-root
``synthesizer.py``).

Every voice bundle found under ``assets/bundles`` is served by the port's
``serve.Synthesizer`` under its language tag; any object with
``tts_to_file(text, file_path, speed)`` registers as another language's
backend (``extra_models``); voice conversion goes through a
``KnnVoiceConverter`` on the Vietnamese engine.  All engines live on one
device: CUDA unless the caller passes ``device="cpu"``; with
``device=None`` and no CUDA the router raises.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, Optional

import torch

from .device import resolve_device
from .serve import SynthesisEngine
from .serve import Synthesizer as _VNSynthesizer
from .serve.voice_conversion import KnnVoiceConverter

BUNDLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "bundles")


def discover_bundles(root: Optional[str] = None) -> Dict[str, str]:
    """``{language: bundle directory}`` for every ``<root>/*/meta.json``
    (``root`` defaults to the repo's ``assets/bundles``); the first bundle
    of a language in name order wins."""
    root = root or BUNDLES
    found: Dict[str, str] = {}
    for meta in sorted(glob.glob(os.path.join(root, "*", "meta.json"))):
        try:
            with open(meta) as f:
                lang = json.load(f).get("language", "vie")
        except (OSError, ValueError):
            continue
        found.setdefault(lang, os.path.dirname(meta))
    return found


class Synthesizer:
    """text -> wav file in a language, optionally converted to a target
    speaker's voice.

    ``bundles`` (language -> bundle directory) adds to, and ``vie_bundle``
    overrides, the discovered bundles; ``engine`` serves Vietnamese (a
    random-weight engine from seed 0 does when no Vietnamese voice is
    found).  Every engine is loaded onto ``device`` in ``dtype``; a given
    ``engine`` sets the device when ``device`` is None and must lie on it
    otherwise."""

    def __init__(
        self,
        vie_bundle: Optional[str] = None,
        engine: Optional[SynthesisEngine] = None,
        extra_models: Optional[Dict[str, object]] = None,
        bundles: Optional[Dict[str, str]] = None,
        auto_discover: bool = True,
        output_dir: str = "outputs",
        vc_prosody_weight: float = 0.0,
        device=None,
        dtype=torch.float32,
    ) -> None:
        if engine is not None and device is None:
            device = engine.device
        self.device = resolve_device(device)
        if engine is not None and engine.device != self.device:
            raise ValueError(f"the engine is on {engine.device}, the router on {self.device}")
        bundles = dict(bundles or {})
        if auto_discover:
            for lang, path in discover_bundles().items():
                bundles.setdefault(lang, path)
        if vie_bundle:
            bundles["vie"] = vie_bundle

        self.model_dict: Dict[str, object] = {}
        for lang, path in bundles.items():
            eng = SynthesisEngine.from_checkpoint(path, device=self.device, dtype=dtype)
            self.model_dict[lang] = _VNSynthesizer(engine=eng, output_dir=output_dir)
        if engine is not None or "vie" not in self.model_dict:
            engine = engine or SynthesisEngine.from_random(seed=0, device=self.device,
                                                           dtype=dtype)
            self.model_dict["vie"] = _VNSynthesizer(engine=engine, output_dir=output_dir)
        if extra_models:
            self.model_dict.update(extra_models)
        # kNN-VC rendered by the Vietnamese engine's vocoder; the spectral
        # converter when that backend has no engine
        vn = getattr(self.model_dict.get("vie"), "engine", None)
        self.voice_converter = KnnVoiceConverter(
            engine=vn, prosody_weight=vc_prosody_weight,
            device=None if vn is not None else self.device)
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    @property
    def languages(self):
        return sorted(self.model_dict)

    def synthesis(
        self,
        text: str,
        language: str = "vie",
        target_filepath: Optional[str] = None,
        speed: float = 1.0,
    ):
        """text -> (tts wav path, voice-converted wav path or None)."""
        if language not in self.model_dict:
            raise ValueError(
                f"no model for language {language!r}; available: {self.languages}. "
                "Register external backends via extra_models."
            )
        model = self.model_dict[language]
        path = model.synthesis(text, save_filepath=None, speed=speed)
        vc_path = None
        if target_filepath:
            vc_path = self.voice_conversion(path, target_filepath)
        return path, vc_path

    def voice_conversion(self, source_filepath: str, target_filepath: str) -> str:
        out = os.path.join(self.output_dir, f"vc_{time.time_ns()}.wav")
        return self.voice_converter.convert(source_filepath, target_filepath, out)
