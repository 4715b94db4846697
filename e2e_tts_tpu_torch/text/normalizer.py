"""Vietnamese text normalization.

The reference delegates normalization to an external HTTP service and falls
back to raw text when it is unreachable (reference: src/api/inference.py:14,
28-33).  That service is not part of the repo, so this module provides an
in-process normalizer with the same role: expand numbers, dates, percentages
and common abbreviations into spoken Vietnamese words, and tidy punctuation
so the G2P layer only ever sees phonemizable tokens.  An HTTP-backed
normalizer with the reference's endpoint semantics is available for parity.
"""

from __future__ import annotations

import re
from typing import Callable

# --- Vietnamese number reading -------------------------------------------

_DIGITS = ["không", "một", "hai", "ba", "bốn", "năm", "sáu", "bảy", "tám", "chín"]
_SCALES = ["", " nghìn", " triệu", " tỷ"]


def _read_three(n: int, has_higher: bool) -> str:
    """Read a 0..999 group. Applies the mốt/lăm/tư/linh sandhi rules."""
    tram, rest = divmod(n, 100)
    chuc, donvi = divmod(rest, 10)
    parts = []
    if tram or (has_higher and rest):
        parts.append(_DIGITS[tram] + " trăm")
    if chuc > 1:
        parts.append(_DIGITS[chuc] + " mươi")
        if donvi == 1:
            parts.append("mốt")
        elif donvi == 4:
            parts.append("tư")
        elif donvi == 5:
            parts.append("lăm")
        elif donvi:
            parts.append(_DIGITS[donvi])
    elif chuc == 1:
        parts.append("mười")
        if donvi == 5:
            parts.append("lăm")
        elif donvi:
            parts.append(_DIGITS[donvi])
    else:
        if donvi:
            if parts or has_higher:
                parts.append("linh")
            parts.append(_DIGITS[donvi])
    return " ".join(parts)


def number_to_words(n: int) -> str:
    """Read a non-negative integer in Vietnamese."""
    if n == 0:
        return _DIGITS[0]
    if n < 0:
        return "âm " + number_to_words(-n)
    groups = []
    while n > 0:
        groups.append(n % 1000)
        n //= 1000
    parts = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        scale = _SCALES[i % 4] if i < 4 else ""
        if i >= 4:  # beyond tỷ: recurse on billions
            scale = " tỷ" * (i // 3)
        words = _read_three(g, has_higher=i < len(groups) - 1)
        parts.append(words + scale)
    return " ".join(p for p in parts if p.strip())


def decimal_to_words(s: str) -> str:
    """Read "3,14" / "3.14" style decimals (phẩy = decimal comma)."""
    m = re.match(r"^(\d+)[.,](\d+)$", s)
    if not m:
        return number_to_words(int(s))
    whole, frac = m.groups()
    frac_words = " ".join(_DIGITS[int(d)] for d in frac)
    return f"{number_to_words(int(whole))} phẩy {frac_words}"


def digits_to_words(s: str) -> str:
    """Read a digit string one digit at a time (phone numbers, codes)."""
    return " ".join(_DIGITS[int(d)] for d in s if d.isdigit())


# --- token-level normalization ---------------------------------------------

_ABBREVIATIONS = {
    "tp": "thành phố",
    "tp.": "thành phố",
    "ts": "tiến sĩ",
    "ts.": "tiến sĩ",
    "gs": "giáo sư",
    "gs.": "giáo sư",
    "pgs": "phó giáo sư",
    "ths": "thạc sĩ",
    "bs": "bác sĩ",
    "bs.": "bác sĩ",
    "ubnd": "ủy ban nhân dân",
    "thcs": "trung học cơ sở",
    "thpt": "trung học phổ thông",
    "km": "ki lô mét",
    "kg": "ki lô gam",
    "cm": "xen ti mét",
    "mm": "mi li mét",
    "ml": "mi li lít",
    "tv": "ti vi",
    "%": "phần trăm",
    "usd": "đô la",
    "vnđ": "đồng",
    "vnd": "việt nam đồng",
    "đ": "đồng",
}

_UNITS_RE = re.compile(r"^(\d+(?:[.,]\d+)?)(%|km|kg|cm|mm|ml|m|g|l)$", re.IGNORECASE)
_CURRENCY_RE = re.compile(r"^(\d[\d.]*(?:,\d+)?)(đ|vnđ|vnd|usd|\$)$", re.IGNORECASE)
_DOLLAR_PREFIX_RE = re.compile(r"^\$(\d[\d.]*(?:,\d+)?)$")
_CURRENCY_SHORT_RE = re.compile(r"^(\d+(?:[.,]\d+)?)(k|tr)$", re.IGNORECASE)
_RANGE_RE = re.compile(r"^(\d+)-(\d+)$")
_DATE_RE = re.compile(r"^(\d{1,2})/(\d{1,2})(?:/(\d{2,4}))?$")
# "3-5/7[/2026]": a day range within one month
_DAY_RANGE_RE = re.compile(r"^(\d{1,2})-(\d{1,2})/(\d{1,2})(?:/(\d{2,4}))?$")
# "28/12-3/1[/2026]": a full date range
_DATE_RANGE_RE = re.compile(
    r"^(\d{1,2})/(\d{1,2})-(\d{1,2})/(\d{1,2})(?:/(\d{2,4}))?$"
)
_TIME_RE = re.compile(r"^(\d{1,2})[:h](\d{2})?$")
# "8h-17h30" / "8:00-17:00": a time range
_TIME_RANGE_RE = re.compile(r"^(\d{1,2})[:h](\d{2})?-(\d{1,2})[:h](\d{2})?$")
_NUM_RE = re.compile(r"^-?\d+$")
_DEC_RE = re.compile(r"^\d+[.,]\d+$")
_THOUSANDS_RE = re.compile(r"^\d{1,3}(\.\d{3})+$")
_LONG_DIGITS_RE = re.compile(r"^\d{10,}$")

# Punctuation the downstream G2P understands (becomes <silent> / </s>).
_KEEP_PUNCT = ",.!?;:"

# Dotted abbreviations ("TP. HCM") are expanded BEFORE punctuation splitting,
# otherwise the '.' becomes its own token and the dotted key is unreachable.
_DOTTED_ABBREV_RE = re.compile(
    r"\b(tp|ts|gs|pgs|ths|bs)\.(?=\s*\w)", re.IGNORECASE
)

# Vietnamese letter names for acronym spelling ("HCM" -> "hát xê mờ").
_LETTER_NAMES = {
    "a": "a", "b": "bê", "c": "xê", "d": "dê", "đ": "đê", "e": "e",
    "f": "ép", "g": "gờ", "h": "hát", "i": "i", "j": "gi", "k": "ca",
    "l": "lờ", "m": "mờ", "n": "nờ", "o": "o", "p": "pê", "q": "quy",
    "r": "rờ", "s": "ét", "t": "tê", "u": "u", "v": "vê", "w": "vê kép",
    "x": "ích", "y": "i dài", "z": "dét",
}
_ACRONYM_RE = re.compile(r"^[A-ZĐ]{2,6}$")


def _is_acronym(tok: str) -> bool:
    """All-caps token that is not a shouted Vietnamese syllable."""
    if not _ACRONYM_RE.match(tok):
        return False
    from .g2p import is_valid_syllable

    return not is_valid_syllable(tok.lower())


def spell_acronym(tok: str) -> str:
    """Spell an uppercase acronym letter by letter in Vietnamese."""
    return " ".join(_LETTER_NAMES.get(c.lower(), c) for c in tok)


def ordinal_to_words(n: int) -> str:
    """Vietnamese ordinal reading: thứ nhất / thứ tư irregulars."""
    if n == 1:
        return "nhất"
    if n == 4:
        return "tư"
    return number_to_words(n)


# --- roman numerals ----------------------------------------------------------

_ROMAN_RE = re.compile(
    r"^(?=[IVXLCDM])M{0,3}(CM|CD|D?C{0,3})(XC|XL|L?X{0,3})(IX|IV|V?I{0,3})$"
)
# Words whose FOLLOWING roman numeral is read as a number ("thế kỷ XXI",
# "chương IV", "Đại hội XIII", "quý II"). Keyed on the immediately
# preceding (lowercased) token.
_ROMAN_TRIGGERS = {
    "thứ", "chương", "kỷ", "lần", "khóa", "khoá", "quý", "phần", "tập",
    "mùa", "vòng", "kỳ", "hội", "đời", "đoạn", "hồi",
}
_ROMAN_VALUES = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}


def roman_to_int(s: str) -> int:
    """Value of a valid roman-numeral string."""
    total = 0
    for i, c in enumerate(s):
        v = _ROMAN_VALUES[c]
        if i + 1 < len(s) and _ROMAN_VALUES[s[i + 1]] > v:
            total -= v
        else:
            total += v
    return total


def _is_roman(tok: str, prev: str) -> bool:
    """A roman numeral worth reading as a number: either context-triggered
    (after "chương"/"kỷ"/...) or unambiguous (only I/V/X, 2+ chars — "III",
    "XXI" — which no Vietnamese acronym spelling should claim)."""
    if not _ROMAN_RE.match(tok):
        return False
    if prev in _ROMAN_TRIGGERS:
        return True
    return len(tok) >= 2 and set(tok) <= {"I", "V", "X"}


def _read_amount(num: str) -> str:
    """Read a numeric amount that may carry '.'-thousands separators and a
    ','-decimal part ("1.500.000", "2,5", "1.234,56").  A lone '.' with 1-2
    trailing digits cannot be a VN thousands group, so "2.5" is the US-style
    decimal (common in dollar amounts) — "1.500" remains 1500."""
    if re.match(r"^\d+\.\d{1,2}$", num):
        return decimal_to_words(num)
    num = num.replace(".", "")
    if "," in num:
        return decimal_to_words(num)
    return number_to_words(int(num))


def _read_time(h: str, mnt) -> str:
    out = f"{number_to_words(int(h))} giờ"
    if mnt and int(mnt):
        out += f" {number_to_words(int(mnt))} phút"
    return out


def _normalize_token(tok: str, prev: str = "") -> str:
    low = tok.lower()
    if low in _ABBREVIATIONS:
        return _ABBREVIATIONS[low]
    if prev == "thứ" and _NUM_RE.match(tok) and int(tok) > 0:
        return ordinal_to_words(int(tok))
    if _is_roman(tok, prev):
        n = roman_to_int(tok)
        return ordinal_to_words(n) if prev == "thứ" else number_to_words(n)
    if _is_acronym(tok):
        return spell_acronym(tok)
    m = _CURRENCY_RE.match(low)
    if m:
        num, cur = m.groups()
        words = {"đ": "đồng", "vnđ": "đồng", "vnd": "đồng",
                 "usd": "đô la", "$": "đô la"}[cur]
        return f"{_read_amount(num)} {words}"
    m = _DOLLAR_PREFIX_RE.match(tok)
    if m:
        return f"{_read_amount(m.group(1))} đô la"
    m = _CURRENCY_SHORT_RE.match(low)
    if m:
        num, suffix = m.groups()
        scale = "nghìn" if suffix == "k" else "triệu"
        return f"{_read_amount(num)} {scale}"
    m = _DATE_RANGE_RE.match(tok)
    if m:
        d1, m1, d2, m2, y = m.groups()
        out = (
            f"từ ngày {number_to_words(int(d1))} tháng {number_to_words(int(m1))}"
            f" đến ngày {number_to_words(int(d2))} tháng {number_to_words(int(m2))}"
        )
        if y:
            out += f" năm {number_to_words(int(y))}"
        return out
    m = _DAY_RANGE_RE.match(tok)
    if m:
        d1, d2, mth, y = m.groups()
        out = (
            f"từ ngày {number_to_words(int(d1))} đến ngày "
            f"{number_to_words(int(d2))} tháng {number_to_words(int(mth))}"
        )
        if y:
            out += f" năm {number_to_words(int(y))}"
        return out
    m = _TIME_RANGE_RE.match(low)
    if m:
        h1, m1, h2, m2 = m.groups()
        return f"từ {_read_time(h1, m1)} đến {_read_time(h2, m2)}"
    m = _RANGE_RE.match(tok)
    if m:
        a, b = m.groups()
        return f"{number_to_words(int(a))} đến {number_to_words(int(b))}"
    m = _DATE_RE.match(tok)
    if m:
        d, mth, y = m.groups()
        out = f"ngày {number_to_words(int(d))} tháng {number_to_words(int(mth))}"
        if y:
            out += f" năm {number_to_words(int(y))}"
        return out
    m = _TIME_RE.match(tok)
    if m:
        h, mnt = m.groups()
        return _read_time(h, mnt)
    m = _UNITS_RE.match(tok)
    if m:
        num, unit = m.groups()
        unit_words = _ABBREVIATIONS.get(unit.lower(), {"m": "mét", "g": "gam", "l": "lít"}.get(unit.lower(), unit))
        return f"{decimal_to_words(num)} {unit_words}"
    if _THOUSANDS_RE.match(tok):
        return number_to_words(int(tok.replace(".", "")))
    if _LONG_DIGITS_RE.match(tok):
        return digits_to_words(tok)
    if _NUM_RE.match(tok):
        return number_to_words(int(tok))
    if _DEC_RE.match(tok):
        return decimal_to_words(tok)
    return tok


def normalize_text(text: str) -> str:
    """Normalize raw Vietnamese text for the G2P frontend."""
    # Expand dotted abbreviations before '.' becomes a standalone token.
    text = _DOTTED_ABBREV_RE.sub(
        lambda m: _ABBREVIATIONS[m.group(1).lower()], text
    )
    # Separate kept punctuation into standalone tokens; drop the rest.
    text = re.sub(r"[–—]", "-", text)
    text = re.sub(r"[“”\"'()\[\]{}]", " ", text)
    text = re.sub(r"\.{2,}", ".", text)
    text = re.sub(rf"([{re.escape(_KEEP_PUNCT)}])", r" \1 ", text)
    # But re-join decimal/date-internal separators split by the above:
    text = re.sub(r"(\d) ([.,]) (\d)", r"\1\2\3", text)
    tokens = text.split()
    out = []
    prev = ""
    for tok in tokens:
        if tok in _KEEP_PUNCT:
            out.append("," if tok in ";:" else tok)
            prev = tok
            continue
        norm = _normalize_token(tok, prev=prev.lower())
        out.append(norm)
        prev = tok
    result = " ".join(out)
    return re.sub(r"\s+", " ", result).strip()


class HttpNormalizer:
    """Client for an external normalization endpoint with local fallback,
    mirroring the reference's try/except-to-raw-text behavior
    (src/api/inference.py:28-33)."""

    def __init__(self, url: str, fallback: Callable[[str], str] = normalize_text,
                 timeout: float = 3.0):
        self.url = url
        self.fallback = fallback
        self.timeout = timeout

    def __call__(self, text: str) -> str:
        try:
            import requests

            r = requests.post(self.url, json={"text": text}, timeout=self.timeout)
            return r.json()["result"]
        except Exception:
            return self.fallback(text)
