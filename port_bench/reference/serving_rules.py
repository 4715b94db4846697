"""The serving path's host rules, as the reference applies them to a
request: chunking (at most 300 characters, split at clause punctuation,
then whitespace, merged greedily back up to the budget), phoneme sequences
longer than the largest text bucket cut near a pause, the mel bucket a
stage-2 call runs at, the int16 encoding and the silence gap stitched after
every chunk.  A frozen copy of the rules of the port's ``serve/chunking.py``
and ``serve/engine.py`` at the benchmark's first commit; the decisions
change the output (a row's last samples read its bucket's padding), so the
reference takes them as they are.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np
import torch

from .vie_text.sequence import text_to_sequence
from .vie_text.symbols import SILENT_ID

MAX_CHARS = 300
TEXT_BUCKETS = (32, 64, 96, 128, 192, 256, 320)
MEL_BUCKET_STEP = 128
MAX_MEL_LEN = 2048
GAP_SECONDS = 0.5

_CLAUSE_SPLIT = re.compile(r"\s*[,;:]\s+")


def arrange_text(lines: Sequence[str], max_len: int = MAX_CHARS) -> List[str]:
    chunks: List[str] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if len(line) <= max_len:
            chunks.append(line)
            continue
        pieces: List[str] = []
        for part in _CLAUSE_SPLIT.split(line):
            while len(part) > max_len:
                cut = part.rfind(" ", 0, max_len)
                if cut <= 0:
                    cut = max_len
                pieces.append(part[:cut])
                part = part[cut:].strip()
            if part:
                pieces.append(part)
        cur = ""
        for p in pieces:
            if not cur:
                cur = p
            elif len(cur) + len(p) + 3 <= max_len:
                cur = f"{cur} , {p}"
            else:
                chunks.append(cur)
                cur = p
        if cur:
            chunks.append(cur)
    return chunks


def split_long_sequence(seq: np.ndarray) -> List[np.ndarray]:
    cap = TEXT_BUCKETS[-1]
    if len(seq) <= cap:
        return [seq]
    n_parts = -(-len(seq) // cap)
    piece_len = -(-len(seq) // n_parts)
    silent_pos = np.flatnonzero(np.asarray(seq) == SILENT_ID)
    pieces, start = [], 0
    while start < len(seq):
        target = min(start + piece_len, len(seq))
        if target < len(seq):
            near = silent_pos[(silent_pos > start) & (silent_pos < len(seq) - 1)
                              & (silent_pos < start + cap)
                              & (np.abs(silent_pos - target) <= piece_len // 4)]
            if near.size:
                target = int(near[np.argmin(np.abs(near - target))]) + 1
        pieces.append(seq[start:target])
        start = target
    return [p for p in pieces if len(p) > 0]


def request_sequences(text: str) -> List[np.ndarray]:
    """A request's phoneme-id sequences, one per row the engine runs."""
    seqs = [np.asarray(text_to_sequence(c), np.int64) for c in arrange_text([text])]
    return [p for s in seqs for p in split_long_sequence(s) if len(p) > 0]


def text_bucket(n: int) -> int:
    for b in TEXT_BUCKETS:
        if n <= b:
            return b
    return TEXT_BUCKETS[-1]


def mel_bucket(n: int) -> int:
    b = ((max(n, 1) + MEL_BUCKET_STEP - 1) // MEL_BUCKET_STEP) * MEL_BUCKET_STEP
    return min(b, MAX_MEL_LEN)


def durations_from_log(log_d: torch.Tensor, d_control: float = 1.0) -> torch.Tensor:
    """FastSpeech2's inference durations: round(exp(log d) - 1), scaled,
    floored at 0, as integers."""
    return torch.clamp(torch.round(torch.exp(log_d) - 1.0) * d_control, min=0.0).to(torch.int64)


def to_int16(audio: torch.Tensor) -> np.ndarray:
    return (torch.clamp(audio.float(), -1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()


def stitch(chunks: List[np.ndarray], sample_rate: int) -> np.ndarray:
    gap = np.zeros(int(GAP_SECONDS * sample_rate), np.int16)
    out = []
    for c in chunks:
        out += [c, gap]
    return np.concatenate(out) if out else np.zeros(0, np.int16)
