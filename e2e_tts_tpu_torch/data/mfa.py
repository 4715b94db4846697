"""Montreal-Forced-Aligner interop (a copy of ``e2e_tts_tpu/data/mfa.py``;
reference: e2e_tts/modules/mfa/).

- ``build_mfa_corpus``: copy wavs, write per-utterance ``.lab`` transcripts,
  and build ``lexicon.txt`` mapping each word to phonemes via the G2P
  frontend (reference build_mfa_format.py:14-68).
- ``parse_textgrid`` + ``textgrid_to_durations``: align MFA phone intervals
  to the G2P phoneme sequence and quantize to mel frames with leftover carry
  so durations sum exactly to the mel length (textgrid2durations.py:36-149).
- ``filter_nan_utterances``: drop utterances whose cached pitch/energy
  contain NaN (check_nan.py:6-21).

MFA itself is an external tool; this module produces/consumes its formats.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..text import phonemize, syllable_to_phonemes

MFA_TRAIN_CONFIG = """\
beam: 10
retry_beam: 40
features:
  type: "mfcc"
  use_energy: false
  frame_shift: 10
training:
  - monophone:
      num_iterations: 40
      max_gaussians: 1000
  - triphone:
      num_iterations: 35
      num_leaves: 2000
      max_gaussians: 10000
  - lda:
      num_leaves: 2500
      max_gaussians: 15000
  - sat:
      num_leaves: 2500
      max_gaussians: 15000
"""


def build_mfa_corpus(
    metadata_path: str,
    wav_dir: str,
    output_dir: str,
    foreign_dict: Optional[Dict[str, dict]] = None,
) -> str:
    """metadata.csv (file|speaker|transcript) -> MFA corpus layout + lexicon."""
    os.makedirs(output_dir, exist_ok=True)
    lexicon: Dict[str, str] = {}
    with open(metadata_path, encoding="utf8") as f:
        rows = [r.strip().split("|") for r in f if r.strip()]

    for fname, speaker, transcript in rows:
        spk_dir = os.path.join(output_dir, speaker)
        os.makedirs(spk_dir, exist_ok=True)
        src = os.path.join(wav_dir, fname)
        shutil.copy(src, os.path.join(spk_dir, fname))
        base = os.path.splitext(fname)[0]
        with open(os.path.join(spk_dir, f"{base}.lab"), "w", encoding="utf8") as lf:
            lf.write(transcript.lower())
        for word in transcript.lower().split():
            if word in lexicon or _is_punct(word):
                continue
            try:
                if foreign_dict and word in foreign_dict:
                    ph, _ = phonemize([word], foreign_dict, is_training=True)
                    ph = [p for p in ph if not p.startswith("<")]
                elif "-" in word:
                    ph = [
                        p.upper()
                        for part in word.split("-") if part
                        for p in syllable_to_phonemes(part)
                    ]
                else:
                    ph = [p.upper() for p in syllable_to_phonemes(word)]
                lexicon[word] = " ".join(ph)
            except Exception:
                continue

    lex_path = os.path.join(output_dir, "lexicon.txt")
    with open(lex_path, "w", encoding="utf8") as f:
        for w in sorted(lexicon):
            f.write(f"{w}\t{lexicon[w]}\n")
    with open(os.path.join(output_dir, "mfa_config.yaml"), "w") as f:
        f.write(MFA_TRAIN_CONFIG)
    return lex_path


_INTERVAL_RE = re.compile(
    r'intervals \[\d+\]:\s*xmin = ([\d.]+)\s*xmax = ([\d.]+)\s*text = "([^"]*)"',
)


def parse_textgrid(path: str, tier: str = "phones") -> List[Tuple[float, float, str]]:
    """Minimal TextGrid parser: [(xmin, xmax, label), ...] for one tier."""
    with open(path, encoding="utf8") as f:
        content = f.read()
    # isolate the requested tier
    tiers = re.split(r"item \[\d+\]:", content)
    block = None
    for t in tiers:
        if f'name = "{tier}"' in t:
            block = t
            break
    if block is None:
        raise ValueError(f"tier {tier!r} not found in {path}")
    return [
        (float(a), float(b), lbl.strip())
        for a, b, lbl in _INTERVAL_RE.findall(block)
    ]


def intervals_to_durations(
    intervals: Sequence[Tuple[float, float, str]],
    mel_len: int,
    sample_rate: int = 22050,
    hop_length: int = 256,
) -> Tuple[List[str], np.ndarray]:
    """Quantize aligned phone intervals to frame counts with leftover carry;
    the total is fixed to ``mel_len`` on the final phone
    (reference textgrid2durations.py:36-149)."""
    frames_per_second = sample_rate / hop_length
    labels, durations = [], []
    carry = 0.0
    for xmin, xmax, label in intervals:
        exact = (xmax - xmin) * frames_per_second + carry
        d = int(round(exact))
        carry = exact - d
        labels.append(label if label else "<SILENT>")
        durations.append(max(d, 0))
    durations = np.asarray(durations, np.int64)
    total = durations.sum()
    if total != mel_len and len(durations):
        durations[-1] += mel_len - total
        durations[-1] = max(durations[-1], 0)
    return labels, durations


def textgrid_to_durations(
    textgrid_path: str,
    mel_len: int,
    sample_rate: int = 22050,
    hop_length: int = 256,
):
    return intervals_to_durations(
        parse_textgrid(textgrid_path), mel_len, sample_rate, hop_length
    )


def filter_nan_utterances(filelist_entries) -> Tuple[list, list]:
    """Drop utterances whose cached pitch/energy contain NaN
    (reference check_nan.py:6-21).  Returns (kept, dropped)."""
    from .features import load_utterance_features

    kept, dropped = [], []
    for entry in filelist_entries:
        try:
            feats = load_utterance_features(entry[0])
            if np.isnan(feats["pitch"]).any() or np.isnan(feats["energy"]).any():
                dropped.append(entry)
            else:
                kept.append(entry)
        except FileNotFoundError:
            dropped.append(entry)
    return kept, dropped


def _is_punct(w: str) -> bool:
    import string

    return all(c in string.punctuation for c in w)
