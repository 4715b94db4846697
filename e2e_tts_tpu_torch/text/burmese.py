"""Burmese (mya) text frontend.

The reference routes "mya" to an external fairseq VITS checkpoint via Coqui
(reference: synthesizer.py:17-24) — no Burmese text processing exists in the
reference at all.  External checkpoints cannot ship here, so Burmese gets the
same treatment English got (text/english.py): an in-framework frontend that
makes the language a first-class citizen of the router, proving the
multi-lingual surface is N-ary rather than hard-coded to two languages.

This is a real (if simplified) Burmese grapheme-to-phoneme layer over the
Unicode Myanmar block: syllables are parsed as
    onset (+ medial) (+ vowel signs) (+ final consonant with asat) (+ tone)
and emitted as "~PH" tags in a dedicated phone block appended after the VN
inventory (mirroring how the CMU block carries English).  Phonological
simplifications (documented, deliberate): stop finals neutralize to a
glottal coda ~Q with checked tone; the ြ medial reads /j/ as in modern
colloquial Burmese; vowel-quality shifts before finals are ignored.
"""

from __future__ import annotations

import string
from typing import Dict, List, Sequence, Tuple, Union

from .symbols import build_symbols

SILENT = "<silent>"
EOS = "</s>"

# --- phone inventory ---------------------------------------------------------

MYA_ONSETS = (
    "K", "KH", "G", "NG", "S", "HS", "Z", "NY", "T", "HT", "D", "N",
    "P", "HP", "B", "M", "Y", "L", "W", "TH", "H", "Q",
)
MYA_VOWELS = ("A", "I", "U", "E", "AI", "AU", "O", "AW")
MYA_TONES = ("1", "2", "3", "4")  # low, high, creaky, checked
MYA_FINALS = ("NF", "QF")  # nasal coda, glottal-stop coda

MYA_PHONES = (
    MYA_ONSETS
    + tuple(f"{v}_{t}" for v in MYA_VOWELS for t in MYA_TONES)
    + MYA_FINALS
)


def build_mya_symbols() -> tuple:
    """VN inventory + Burmese block ("~PH"), VN ids unchanged."""
    return build_symbols() + tuple(f"~{p}" for p in MYA_PHONES)


MYA_SYMBOLS = build_mya_symbols()
MYA_SYMBOL_TO_ID = {s: i for i, s in enumerate(MYA_SYMBOLS)}

# --- script tables -----------------------------------------------------------

_CONSONANTS: Dict[str, str] = {
    "က": "K", "ခ": "KH", "ဂ": "G", "ဃ": "G",
    "င": "NG", "စ": "S", "ဆ": "HS", "ဇ": "Z",
    "ဈ": "Z", "ဉ": "NY", "ည": "NY", "ဋ": "T",
    "ဌ": "HT", "ဍ": "D", "ဎ": "D", "ဏ": "N",
    "တ": "T", "ထ": "HT", "ဒ": "D", "ဓ": "D",
    "န": "N", "ပ": "P", "ဖ": "HP", "ဗ": "B",
    "ဘ": "B", "မ": "M", "ယ": "Y", "ရ": "Y",
    "လ": "L", "ဝ": "W", "သ": "TH", "ဟ": "H",
    "ဠ": "L", "အ": "Q",
}
_MEDIALS = {"ျ": "Y", "ြ": "Y", "ွ": "W", "ှ": None}
_VOWEL_SIGNS = {
    "ါ": "AA", "ာ": "AA",  # tall/round aa -> open a, low tone
    "ိ": "I", "ီ": "II",
    "ု": "U", "ူ": "UU",
    "ေ": "E", "ဲ": "AI",
}
_ASAT = "်"
_ANUSVARA = "ံ"   # nasalization
_DOT_BELOW = "့"  # creaky tone
_VISARGA = "း"    # high tone
_NASAL_FINALS = frozenset("ငဉညဏနမ")
_DIGITS = {chr(0x1040 + i): i for i in range(10)}

# vowel-sign combinations -> rhyme vowel (sorted-concatenation keys)
_VOWEL_COMBOS = {
    "": "A", "AA": "A", "I": "I", "II": "I", "U": "U", "UU": "U",
    "E": "E", "AI": "AI", "AAE": "AW", "IU": "O", "AAU": "AU",
    "AAII": "AW", "EU": "O",
}


def _parse_syllable(chars: str) -> List[str]:
    """One syllable cluster -> phones.  ``chars`` starts with a consonant."""
    onset = _CONSONANTS[chars[0]]
    i = 1
    medial = None
    while i < len(chars) and chars[i] in _MEDIALS:
        m = _MEDIALS[chars[i]]
        if m and medial is None:
            medial = m
        i += 1

    vowel_signs: List[str] = []
    tone = "1"
    final = None
    while i < len(chars):
        c = chars[i]
        if c in _VOWEL_SIGNS:
            vowel_signs.append(_VOWEL_SIGNS[c])
        elif c == _ANUSVARA:
            final = "NF"
        elif c == _DOT_BELOW:
            tone = "3"
        elif c == _VISARGA:
            tone = "2"
        elif c in _CONSONANTS and i + 1 < len(chars) and chars[i + 1] == _ASAT:
            # final consonant: nasal class -> NF, stop class -> QF + checked
            if c in _NASAL_FINALS:
                final = "NF"
            else:
                final = "QF"
                tone = "4"
            i += 1  # consume asat
        i += 1

    # vowel resolution: combinations first, else inherent /a/
    vs = "".join(sorted(vowel_signs))
    vowel = _VOWEL_COMBOS.get(vs, "A")
    # long-vowel signs (II/UU alone) default to high tone unless marked
    if tone == "1" and vs in ("II", "UU"):
        tone = "2"

    phones = [onset]
    if medial:
        phones.append(medial)
    phones.append(f"{vowel}_{tone}")
    if final:
        phones.append(final)
    return phones


def burmese_word_to_phonemes(word: str) -> List[str]:
    """A run of Burmese script -> "~PH" tags, syllable by syllable."""
    out: List[str] = []
    i = 0
    n = len(word)
    while i < n:
        c = word[i]
        if c in _DIGITS:  # read digits as their own syllables
            out.extend(f"~{p}" for p in _DIGIT_PHONES[_DIGITS[c]])
            i += 1
            continue
        if c not in _CONSONANTS:
            i += 1  # stray mark: skip
            continue
        # collect this syllable: consonant + trailing marks (+ final C + asat)
        j = i + 1
        while j < n:
            cj = word[j]
            if cj in _CONSONANTS:
                if j + 1 < n and word[j + 1] == _ASAT:
                    j += 2
                    continue
                break
            if (
                cj in _MEDIALS
                or cj in _VOWEL_SIGNS
                or cj in (_ANUSVARA, _DOT_BELOW, _VISARGA, _ASAT)
            ):
                j += 1
                continue
            break
        out.extend(f"~{p}" for p in _parse_syllable(word[i:j]))
        i = j
    return out


# spoken digits (approximate colloquial forms)
_DIGIT_PHONES = {
    0: ["TH", "AW_1", "NF"],      # thoun
    1: ["T", "I_4", "QF"],        # tiʔ
    2: ["N", "I_4", "QF"],        # hniʔ
    3: ["TH", "AW_2", "NF"],      # thoun
    4: ["L", "E_2"],              # lei
    5: ["NG", "A_2"],             # nga
    6: ["KH", "AU_4", "QF"],      # chauʔ
    7: ["KH", "U_1", "NF"],       # khun
    8: ["HS", "I_4", "QF"],       # shiʔ
    9: ["K", "O_2"],              # ko
}

_PUNCT = frozenset(string.punctuation) | {"၊", "။"}  # ၊ ။

# --- number normalization ----------------------------------------------------

_BURMESE_DIGIT_OF = {str(i): chr(0x1040 + i) for i in range(10)}
# place-value words in script (the syllable parser reads them); ascending
_PLACES = ("", "ဆယ်", "ရာ", "ထောင်", "သောင်း", "သိန်း", "သန်း")
_ZERO_WORD = "သုည"


def burmese_number_to_words(n: int) -> str:
    """Place-value reading as space-separated script tokens: 25 ->
    "၂ ဆယ် ၅" (hniʔ hse nga).  Numbers beyond သန်း (10^6) places read
    digit by digit (the parser voices each digit)."""
    if n == 0:
        return _ZERO_WORD
    s = str(n)
    if len(s) > len(_PLACES):
        return " ".join(_BURMESE_DIGIT_OF[c] for c in s)
    out: List[str] = []
    for pos, ch in enumerate(s):
        place = len(s) - 1 - pos
        if ch == "0":
            continue
        out.append(_BURMESE_DIGIT_OF[ch])
        if place:
            out.append(_PLACES[place])
    return " ".join(out)


def normalize_burmese(text: str) -> str:
    """Expand numerals in Burmese text to spoken place-value words.

    ASCII digits are treated as Burmese numbers (the common mixed-script
    case: "အခန်း 25").  Other text passes through untouched."""
    import re

    def _expand(m: "re.Match[str]") -> str:
        digits = "".join(
            str(_DIGITS[c]) if c in _DIGITS else c for c in m.group(0)
        )
        return " " + burmese_number_to_words(int(digits)) + " "

    t = re.sub(r"[0-9၀-၉]+", _expand, text)
    return re.sub(r"\s+", " ", t).strip()


def burmese_phonemize(
    text: Union[str, Sequence[str]],
    is_training: bool = True,
) -> Tuple[List[str], List[int]]:
    """Burmese text -> (~PH phoneme list, per-word boundary counts).

    Mirrors the VN/ENG conventions: trailing sentence punctuation appended,
    ၊/။ and ASCII punctuation -> <SILENT> / sentence-final </S>."""
    words = list(text.split()) if isinstance(text, str) else list(text)
    if not words:
        words = ["။"]
    if not all(ch in _PUNCT for ch in words[-1]):
        words.append("။")
    phonemes: List[str] = []
    boundaries: List[int] = []
    last = len(words) - 1
    for i, word in enumerate(words):
        if all(ch in _PUNCT for ch in word):
            seq = [EOS] if i == last else [SILENT]
        else:
            seq = burmese_word_to_phonemes(word.strip(string.punctuation) or word)
            if not seq:
                seq = [SILENT]
        phonemes.extend(seq)
        boundaries.append(len(seq))
    return [p.upper() for p in phonemes], boundaries


def burmese_to_sequence(text: str, return_boundary: bool = False):
    """Burmese text -> ids in the extended (VN+MYA) symbol table."""
    from .sequence import phonemes_to_sequence

    phonemes, boundaries = burmese_phonemize(text)
    seq = phonemes_to_sequence(phonemes, table=MYA_SYMBOL_TO_ID, strict=False)
    if return_boundary:
        return seq, boundaries
    return seq


# a small everyday vocabulary for the synthetic tiny voice (real Burmese)
BURMESE_VOCAB = [
    "နေ",        # nei (sun / stay)
    "ကောင်း",    # kaung (good)
    "လို",        # lo (want)
    "ထမင်း",     # htamin (rice/meal)
    "ရေ",        # yei (water)
    "လက်",       # leʔ (hand)
    "အိမ်",      # ein (house)
    "မြေ",       # myei (earth)
    "လမ်း",      # lan (road)
    "နေ့",        # nei. (day)
    "ည",         # nya (night)
    "ပန်း",      # pan (flower)
    "ကြက်",      # kyeʔ (chicken)
    "ခွေး",      # khwei (dog)
    "ပျော်",     # pyaw (happy)
    "အသစ်",      # athiʔ (new)
    "ကို",        # ko (to)
    "မေး",       # mei (ask)
    "စာ",        # sa (letter/text)
    "ဆရာ",      # hsaya (teacher)
    "မိုး",       # mo (rain/sky)
    "တောင်",     # taung (mountain)
    "မြစ်",      # myiʔ (river)
    "သစ်ပင်",    # thiʔpin (tree)
]
