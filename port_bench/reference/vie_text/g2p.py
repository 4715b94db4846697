"""Vietnamese grapheme-to-phoneme conversion.

Behavioral contract: produces the same phoneme sequences as the reference's
rule-based frontend (reference: e2e_tts/models/g2p/g2p.py:58-176) for every
valid Vietnamese syllable, since the phoneme inventory is the model's input
vocabulary.  The implementation is a fresh design: an explicit
onset/medial/nucleus/coda/tone decomposition with longest-match onset parsing,
instead of the reference's vowel-boundary string surgery.

A syllable decomposes as  C1 w V_T C2:
  C1  onset consonant            ("th" -> TH)
  w   medial glide               ("o"/"u" -> WO/WU)
  V_T nucleus vowel + tone index ("iê" + sắc -> IE_1)
  C2  coda                       ("ng" -> NGZ)
"""

from __future__ import annotations

import json
import os
import string
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .phonology import (
    CODAS,
    DIPHTHONGS,
    MEDIALS,
    MONOPHTHONGS,
    OFFGLIDE_LETTERS,
    ONSETS,
    TONE_MARKS,
    VOWEL_LETTERS,
    fold,
    fold_str,
)


class G2PError(ValueError):
    """Raised when a token cannot be parsed as a Vietnamese syllable."""


def strip_tone(graph: str) -> Tuple[str, int]:
    """Remove the first tone diacritic; return (bare syllable, tone index)."""
    for i, ch in enumerate(graph):
        if ch in TONE_MARKS:
            base, tone = TONE_MARKS[ch]
            return graph[:i] + base + graph[i + 1:], tone
    return graph, 0


def _segment(graph: str) -> Tuple[str, str, str]:
    """Split a bare (tone-stripped) syllable into letter runs:
    leading consonants, first vowel cluster, following consonants.
    Trailing material after the first coda run is ignored (the reference
    only ever consumes the first three runs)."""
    n = len(graph)
    i = 0
    while i < n and fold(graph[i]) not in VOWEL_LETTERS:
        i += 1
    onset = graph[:i]
    j = i
    while j < n and fold(graph[j]) in VOWEL_LETTERS:
        j += 1
    nucleus = graph[i:j]
    k = j
    while k < n and fold(graph[k]) not in VOWEL_LETTERS:
        k += 1
    coda = graph[j:k]
    return onset, nucleus, coda


def syllable_to_phonemes(graph: str) -> List[str]:
    """Convert one lowercase Vietnamese syllable to its phoneme list.

    Equivalent in output to the reference ``vi_convert`` (g2p.py:58-132).
    """
    # Bare single consonant letters pass straight through (e.g. spelled-out
    # initials); mirrors reference g2p.py:67-69.
    if len(graph) == 1 and graph in ONSETS:
        return [ONSETS[graph]]

    graph, tone = strip_tone(graph)
    onset, nucleus, coda = _segment(graph)
    if onset + nucleus + coda != graph:
        # _segment stops at the second vowel group: leftover letters mean
        # this is not a (single) Vietnamese syllable ("blockchain")
        raise G2PError(f"unparseable syllable {graph!r}")
    if onset and onset not in ONSETS:
        raise G2PError(f"unparseable onset {onset!r} in {graph!r}")
    if coda and coda not in CODAS:
        raise G2PError(f"unparseable coda {coda!r} in {graph!r}")

    onset_ph = ONSETS.get(onset, "")

    if nucleus:
        fold_on = fold_str(onset)
        fold_nu = fold_str(nucleus)
        # "gi" spelling: gi + vowel realizes onset /z/ ("d"); the written "i"
        # is part of the onset unless it is itself the nucleus ("gì", "gin")
        # or begins "iê(u)" with following material.
        if fold_on == "g" and fold_nu[0] == "i":
            onset_ph = "d"
            keep_i = fold_nu in ("i", "ieu") or (nucleus == "iê" and coda)
            if not keep_i:
                nucleus = nucleus[1:]
        # "q" is always followed by written "u": "qu" realizes /kw/, except a
        # bare "qu" syllable where the "u" is the nucleus.
        elif fold_on == "q" and fold_nu[0] == "u":
            if nucleus == "u":
                onset_ph = "k"
            else:
                onset_ph = "kw"
                nucleus = nucleus[1:]

        medial = ""
        if len(nucleus) > 1:
            # Off-glide: a final u/o/i/y letter closes the syllable when the
            # cluster is not a true diphthong and there is no written coda.
            if (
                nucleus[-1] in OFFGLIDE_LETTERS
                and nucleus not in DIPHTHONGS
                and not coda
            ):
                coda = nucleus[-1]
                nucleus = nucleus[:-1]
            # Medial glide: a leading u/o letter is the /w/ medial when the
            # remainder still forms a nucleus.
            if (
                len(nucleus) > 1
                and nucleus[0] in ("u", "o")
                and nucleus not in DIPHTHONGS
                and nucleus != "oo"
            ):
                medial = nucleus[0]
                nucleus = nucleus[1:]

        # Orthographic "o" before n/t/i codas is the closed vowel /ɔ/ ("oo"),
        # not the open /ɔa/ default (reference g2p.py:118-119).
        if not medial and nucleus == "o" and coda in ("n", "t", "i"):
            nucleus = "oo"

        medial_ph = MEDIALS[medial] if medial else ""
        if len(nucleus) == 2 and nucleus != "oo":
            if nucleus not in DIPHTHONGS:
                raise G2PError(f"unparseable nucleus {nucleus!r} in {graph!r}")
            vowel_ph = DIPHTHONGS[nucleus]
        else:
            if nucleus not in MONOPHTHONGS:
                raise G2PError(f"unparseable nucleus {nucleus!r} in {graph!r}")
            vowel_ph = MONOPHTHONGS[nucleus]
        vowel_ph = f"{vowel_ph}_{tone}"
    else:
        # No nucleus: onset-only token (reference would emit a dangling
        # "_<tone>" symbol here, g2p.py:130 — a latent crash; we emit just
        # the onset phoneme instead).
        if not onset_ph:
            raise G2PError(f"unparseable syllable {graph!r}")
        return [onset_ph]

    coda_ph = CODAS.get(coda, "")
    return [p for p in (onset_ph, medial_ph, vowel_ph, coda_ph) if p]


# Alias matching the reference public name (g2p.py:58).
vi_convert = syllable_to_phonemes


_PUNCTUATION = frozenset(string.punctuation)

SILENT = "<silent>"
EOS = "</s>"
BOS = "<s>"


def _foreign_entry_to_phonemes(entry: dict):
    """Expand one foreign-dictionary entry (reference g2p.py:144-152).

    ``phonemes``: space-separated ARPAbet with optional stress digits and
    "|"-separated per-word groups; rendered as "@PH" tags.
    ``subtitle``: hyphen-joined Vietnamese approximation run through g2p.
    """
    if entry.get("phonemes") is not None:
        ph = entry["phonemes"]
        def tag(p):
            return f"@{p[:-1] if p[-1].isdigit() else p}"
        if "|" in ph:
            return [[tag(p) for p in grp.strip().split()] for grp in ph.split("|")]
        return [tag(p) for p in ph.split()]
    return [syllable_to_phonemes(x) for x in entry["subtitle"].split("-")]


def _is_punct_token(word: str) -> bool:
    return all(ch in _PUNCTUATION for ch in word)


def phonemize(
    text: Union[str, Sequence[str]],
    foreign_dict: Optional[Dict[str, dict]] = None,
    is_training: bool = True,
    strict: bool = True,
) -> Tuple[List[str], list]:
    """Convert text (or pre-split words) to a flat phoneme sequence plus
    word boundaries.

    Equivalent to the reference ``normalize_phonemes`` (g2p.py:135-176):
    - a final "." is appended when the text does not end in punctuation;
    - foreign-dictionary words use their ARPAbet or VN-subtitle expansion;
    - hyphenated compounds are split into per-syllable groups;
    - punctuation becomes ``<silent>`` (or ``</s>`` sentence-finally);
    - output phonemes are uppercased.

    Boundaries are the per-word phoneme counts; when ``is_training`` is
    False, multi-syllable foreign/compound words report a nested list.
    """
    foreign_dict = foreign_dict or {}
    words = list(text.split()) if isinstance(text, str) else list(text)
    if not words:
        words = ["."]
    if not _is_punct_token(words[-1]):
        # multi-char punctuation ("...", "?!") already ends the sentence;
        # single-char membership used to append a spurious extra "."
        words.append(".")

    phonemes: List[str] = []
    boundaries: list = []
    last = len(words) - 1
    for i, word in enumerate(words):
        if word in foreign_dict:
            seq = _foreign_entry_to_phonemes(foreign_dict[word])
        elif _is_punct_token(word):
            # multi-character punctuation ("...", "?!") reads as one pause;
            # the reference only handles single chars and crashes otherwise
            seq = [EOS] if i == last else [SILENT]
        elif "-" in word:
            try:
                seq = [syllable_to_phonemes(x) for x in word.split("-") if x]
            except G2PError:
                if strict:
                    raise
                seq = [SILENT]
        else:
            try:
                seq = syllable_to_phonemes(word)
            except G2PError:
                if strict:
                    raise
                # serving mode: an un-phonemizable token (foreign word with no
                # dictionary entry) becomes a short pause instead of a crash
                seq = [SILENT]

        if seq and isinstance(seq[0], list):
            phonemes.extend(p for grp in seq for p in grp)
            if is_training:
                boundaries.extend(len(grp) for grp in seq)
            else:
                boundaries.append([len(grp) for grp in seq])
        else:
            phonemes.extend(seq)
            boundaries.append(len(seq))

    return [p.upper() for p in phonemes], boundaries


# Alias matching the reference public name.
normalize_phonemes = phonemize


def is_valid_syllable(graph: str) -> bool:
    """True when ``graph`` parses as a well-formed Vietnamese syllable.

    Replaces the reference's 17,977-line ``dict/fix_words.txt`` lookup
    (g2p.py:11-12, used for OOV filtering in tools_for_data.py:59) with an
    algorithmic check derived from the same phonotactics.
    """
    if not graph or any(ch in _PUNCTUATION or ch.isdigit() for ch in graph):
        return False
    bare, tone = strip_tone(graph)
    onset, nucleus, coda = _segment(bare)
    if onset + nucleus + coda != bare:
        return False  # leftover material => not a single syllable
    if not nucleus:
        return False
    if onset and onset not in ONSETS:
        return False
    try:
        syllable_to_phonemes(graph)
    except G2PError:
        return False
    if coda and coda not in CODAS:
        return False
    # Checked (stop) codas p/t/c/ch only combine with tones sắc/nặng.
    if coda in ("p", "t", "c", "ch") and tone not in (1, 5):
        return False
    return True


def load_foreign_dict(path: str) -> Dict[str, dict]:
    """Load a per-corpus foreign-word pronunciation override file
    (reference format: models/g2p/dict/foreign_words.json)."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf8") as f:
        return json.load(f)
