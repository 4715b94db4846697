"""Text <-> symbol-id codec (reference: e2e_tts/models/g2p/__init__.py:11-57)."""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from .g2p import phonemize
from .symbols import ID_TO_SYMBOL, SYMBOL_TO_ID

_whitespace_re = re.compile(r"\s+")


def _strip_stress(symbol: str) -> str:
    # ARPAbet tags carry an optional trailing stress digit ("@AA1" -> "@AA").
    if symbol.startswith("@") and symbol[-1].isdigit():
        return symbol[:-1]
    return symbol


def phonemes_to_sequence(
    phonemes: List[str],
    table: Optional[Dict[str, int]] = None,
    strict: bool = True,
) -> List[int]:
    """Phoneme symbols -> ids.  ``table`` defaults to the Vietnamese
    inventory; pass english.ENGLISH_SYMBOL_TO_ID for the extended table.
    With ``strict=False`` unknown symbols (e.g. ARPAbet foreign-word phones
    under the VN-only table) degrade to <SILENT> instead of raising — the
    serving contract (a pause beats a crash on user text)."""
    table = table or SYMBOL_TO_ID
    out = []
    for p in phonemes:
        s = _strip_stress(p)
        if s in table:
            out.append(table[s])
        elif strict:
            raise KeyError(f"unknown phoneme symbol {p!r}")
        else:
            out.append(table["<SILENT>"])
    return out


def text_to_sequence(
    text: str,
    foreign_dict: Optional[Dict[str, dict]] = None,
    return_boundary: bool = False,
):
    """Convert raw text to symbol ids via the Vietnamese G2P frontend.

    Matches the reference ``text_to_sequence`` with the default
    ``normalize_phonemes`` cleaner (g2p/__init__.py:11-31, cleaners.py:26-32):
    lowercase, collapse whitespace, phonemize, map to ids.
    """
    text = _whitespace_re.sub(" ", text.lower()).strip()
    phonemes, boundaries = phonemize(
        text, foreign_dict, is_training=False, strict=False
    )
    seq = phonemes_to_sequence(phonemes, strict=False)
    if return_boundary:
        return seq, boundaries
    return seq


def sequence_to_phonemes(sequence: List[int]) -> List[str]:
    return [ID_TO_SYMBOL[int(i)] for i in sequence]


def sequence_to_text(sequence: List[int]) -> str:
    """ids -> underscore-joined symbol string (reference
    g2p/__init__.py:34-40 debugging helper)."""
    return "_".join(sequence_to_phonemes(sequence))


def basic_cleaners(text: str) -> str:
    """Uppercase + collapse whitespace, no transliteration (reference
    cleaners.py:18-23) — for pre-phonemized inputs."""
    return _whitespace_re.sub(" ", text.upper()).strip()
