"""File-list construction (a copy of ``e2e_tts_tpu/data/filelist.py``;
reference: src/tools/tools_for_data.py:16-77).

Produces the same pipe-separated line format the reference trains from:

    <wav_path>|<speaker>|<space-joined phonemes>|<boundaries or durations>

- supervised: reads per-corpus ``metadata.lab`` (filename|speaker|phonemes)
  plus ``durations/<utt>.txt`` written by the MFA tooling; validates that
  phoneme and duration counts agree (tools_for_data.py:30-34).
- unsupervised: reads ``metadata.csv`` (filename|speaker|transcript), runs
  the G2P frontend, and filters utterances containing out-of-vocabulary
  syllables — using the algorithmic validator instead of the reference's
  static 17,977-word list.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..text import is_valid_syllable, phonemize


def create_supervised_filelist(
    corpus_dirs: Sequence[str], output_path: str
) -> List[str]:
    lines = []
    for corpus in corpus_dirs:
        meta = os.path.join(corpus, "metadata.lab")
        with open(meta, encoding="utf8") as f:
            for row in f:
                row = row.strip()
                if not row:
                    continue
                fname, speaker, phonemes = row.split("|")[:3]
                dur_path = os.path.join(corpus, "durations", f"{os.path.splitext(fname)[0]}.txt")
                with open(dur_path, encoding="utf8") as df:
                    durations = df.read().split()
                n_ph = len(phonemes.split())
                if n_ph != len(durations):
                    raise ValueError(
                        f"{fname}: {n_ph} phonemes vs {len(durations)} durations"
                    )
                wav = os.path.join(corpus, "wavs", fname)
                lines.append(f"{wav}|{speaker}|{phonemes}|{' '.join(durations)}")
    _write(output_path, lines)
    return lines


def create_unsupervised_filelist(
    corpus_dirs: Sequence[str],
    output_path: str,
    foreign_dicts: Optional[Dict[str, dict]] = None,
    lang: str = "vie",
) -> Tuple[List[str], List[str]]:
    """Returns (kept lines, skipped utterance names).

    ``lang``: "vie" runs the Vietnamese G2P with OOV filtering; any other
    registered frontend (text/frontends.py — "eng", "mya") runs its own
    phonemizer (rule-based fallbacks, so nothing is OOV)."""
    foreign_dicts = foreign_dicts or {}
    lines, skipped = [], []
    for corpus in corpus_dirs:
        speaker_fd = foreign_dicts.get(os.path.basename(corpus), {})
        meta = os.path.join(corpus, "metadata.csv")
        with open(meta, encoding="utf8") as f:
            for row in f:
                row = row.strip()
                if not row:
                    continue
                fname, speaker, transcript = row.split("|")[:3]
                words = transcript.lower().split()
                if lang != "vie":
                    from ..text.frontends import get_frontend

                    phonemes, boundaries = get_frontend(lang).phonemize(words)
                else:
                    oov = [
                        w
                        for w in words
                        if w not in speaker_fd
                        and "-" not in w
                        and not _is_punct(w)
                        and not is_valid_syllable(w)
                    ]
                    if oov:
                        skipped.append(fname)
                        continue
                    phonemes, boundaries = phonemize(
                        words, foreign_dict=speaker_fd, is_training=True
                    )
                wav = os.path.join(corpus, "wavs", fname)
                lines.append(
                    f"{wav}|{speaker}|{' '.join(phonemes)}|"
                    f"{' '.join(str(b) for b in boundaries)}"
                )
    _write(output_path, lines)
    return lines, skipped


def read_filelist(path: str) -> List[Tuple[str, str, List[str], List[int]]]:
    """Parse a file list into (wav_path, speaker, phonemes, bounds/durs)."""
    out = []
    with open(path, encoding="utf8") as f:
        for row in f:
            row = row.strip()
            if not row:
                continue
            wav, speaker, phonemes, tail = row.split("|")[:4]
            out.append((wav, speaker, phonemes.split(), [int(x) for x in tail.split()]))
    return out


def build_speaker_map(entries) -> Dict[str, int]:
    speakers = sorted({e[1] for e in entries})
    return {s: i for i, s in enumerate(speakers)}


def _is_punct(w: str) -> bool:
    import string

    return all(c in string.punctuation for c in w)


def _write(path: str, lines: List[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf8") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
