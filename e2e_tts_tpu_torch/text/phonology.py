"""Vietnamese phonology data.

Orthography-to-phoneme tables for Vietnamese syllable decomposition.  The
phoneme naming scheme is the model's vocabulary and therefore must match the
reference symbol inventory exactly (reference: e2e_tts/models/g2p/symbols.py,
g2p.py:17-53); the parsing *algorithm* built on top of these tables lives in
``g2p.py`` and is a fresh design (explicit longest-match onset parsing rather
than the reference's vowel-boundary string splitting).
"""

# Tone diacritics.  Vietnamese has six tones; tone 0 (ngang) is unmarked.
# Maps each precomposed toned vowel to (base_vowel, tone_index).
_TONED = {}


def _add_tones(base: str, acute, grave, hook, tilde, dot):
    for ch, tone in ((acute, 1), (grave, 2), (hook, 3), (tilde, 4), (dot, 5)):
        _TONED[ch] = (base, tone)


_add_tones("a", "á", "à", "ả", "ã", "ạ")
_add_tones("â", "ấ", "ầ", "ẩ", "ẫ", "ậ")
_add_tones("ă", "ắ", "ằ", "ẳ", "ẵ", "ặ")
_add_tones("e", "é", "è", "ẻ", "ẽ", "ẹ")
_add_tones("ê", "ế", "ề", "ể", "ễ", "ệ")
_add_tones("i", "í", "ì", "ỉ", "ĩ", "ị")
_add_tones("o", "ó", "ò", "ỏ", "õ", "ọ")
_add_tones("ô", "ố", "ồ", "ổ", "ỗ", "ộ")
_add_tones("ơ", "ớ", "ờ", "ở", "ỡ", "ợ")
_add_tones("u", "ú", "ù", "ủ", "ũ", "ụ")
_add_tones("ư", "ứ", "ừ", "ử", "ữ", "ự")
_add_tones("y", "ý", "ỳ", "ỷ", "ỹ", "ỵ")

TONE_MARKS = _TONED

# ASCII folding for the Vietnamese alphabet (replaces the reference's
# dependency on the `unidecode` package, g2p.py:7).
_BASE_FOLD = {
    "ă": "a", "â": "a", "ê": "e", "ô": "o", "ơ": "o", "ư": "u", "đ": "d",
}


def fold(ch: str) -> str:
    """Fold one Vietnamese character to its bare ASCII letter."""
    if ch in _TONED:
        ch = _TONED[ch][0]
    return _BASE_FOLD.get(ch, ch)


def fold_str(s: str) -> str:
    return "".join(fold(c) for c in s)


# Letters that count as vowels for syllable segmentation (after folding).
VOWEL_LETTERS = frozenset("aeiouy")

# Onset orthography -> phoneme.  Multi-character onsets are matched longest
# first by the parser.  "gi" and "qu" get contextual handling in g2p.py.
ONSETS = {
    "b": "b", "c": "k", "ch": "ch", "d": "d", "đ": "dd", "g": "g", "gh": "g",
    "gi": "d", "h": "h", "k": "k", "kh": "kh", "l": "l", "m": "m", "n": "n",
    "ng": "ng", "ngh": "ng", "nh": "nh", "p": "p", "ph": "ph", "q": "k",
    "qu": "kw", "r": "r", "s": "s", "t": "t", "th": "th", "tr": "tr",
    "v": "v", "x": "x",
}

# Medial (pre-vocalic glide) orthography -> phoneme.
MEDIALS = {"u": "wu", "o": "wo"}

# Nucleus orthography -> phoneme.
MONOPHTHONGS = {
    "a": "a", "ă": "aw", "â": "aa", "e": "e", "ê": "ee", "i": "i", "y": "i",
    "o": "oa", "oo": "o", "ô": "oo", "ơ": "ow", "u": "u", "ư": "uw",
}
DIPHTHONGS = {
    "iê": "ie", "yê": "ie", "ia": "ie", "ya": "ie",
    "ươ": "wa", "ưa": "wa",
    "uô": "uo", "ua": "uo",
}

# Coda orthography -> phoneme (z-suffixed to disambiguate from onsets).
CODAS = {
    "c": "cz", "ch": "kz", "i": "iz", "k": "cz", "m": "mz", "n": "nz",
    "ng": "ngz", "nh": "nhz", "o": "oz", "p": "pz", "t": "tz", "u": "uz",
    "y": "yz",
}

# Off-glide letters that may close an open orthographic vowel cluster.
OFFGLIDE_LETTERS = ("u", "o", "i", "y")

TONES = ("0", "1", "2", "3", "4", "5")
