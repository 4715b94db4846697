"""English text normalization: digits, ordinals, currency, time, percent,
years, acronyms -> spoken words.

The reference offloads Vietnamese normalization to an HTTP service
(reference: e2e_tts/src/api/inference.py:29) and has NO English
normalizer at all — English text reaches its external Coqui model raw
(synthesizer.py:12-25).  Here English is an in-framework frontend
(text/english.py), so numerals must become words *before* phonemization or
they reach the G2P as unpronounceable digit strings.

Design mirrors text/normalizer.py (the Vietnamese one): ordered regex
passes over the raw (case-preserving) text; every expansion emits plain
lowercase words the lexicon/LTS can say.
"""

from __future__ import annotations

import re

_UNITS = (
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
)
_TENS = (
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
)
_SCALES = (
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (10**2, "hundred"),
)

_ORD_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def english_number_to_words(n: int) -> str:
    """Cardinal reading of an integer (up to trillions)."""
    if n < 0:
        return "minus " + english_number_to_words(-n)
    if n < 20:
        return _UNITS[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _TENS[tens] + (" " + _UNITS[rest] if rest else "")
    for value, name in _SCALES:
        if n >= value:
            head, rest = divmod(n, value)
            out = english_number_to_words(head) + " " + name
            if rest:
                out += " " + english_number_to_words(rest)
            return out
    return _UNITS[0]  # pragma: no cover


def english_ordinal_words(n: int) -> str:
    """Ordinal reading: 1 -> first, 22 -> twenty second, 100 -> hundredth."""
    words = english_number_to_words(n).split()
    last = words[-1]
    if last in _ORD_IRREGULAR:
        words[-1] = _ORD_IRREGULAR[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return " ".join(words)


def _year_words(n: int) -> str:
    """Year reading: 1999 -> nineteen ninety nine, 2005 -> two thousand
    five, 2025 -> twenty twenty five, 1900 -> nineteen hundred."""
    if 1100 <= n <= 1999 or 2100 <= n <= 9999:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return english_number_to_words(hi) + " hundred"
        if lo < 10:
            return english_number_to_words(hi) + " oh " + _UNITS[lo]
        return english_number_to_words(hi) + " " + english_number_to_words(lo)
    if 2000 <= n <= 2009:
        return english_number_to_words(n)
    if 2010 <= n <= 2099:
        return "twenty " + english_number_to_words(n - 2000)
    return english_number_to_words(n)


# letter names for acronym spelling; words the lexicon can already say
_LETTER_NAMES = {
    "a": "ay", "b": "bee", "c": "see", "d": "dee", "e": "ee", "f": "ef",
    "g": "jee", "h": "aitch", "i": "eye", "j": "jay", "k": "kay", "l": "el",
    "m": "em", "n": "en", "o": "oh", "p": "pee", "q": "cue", "r": "ar",
    "s": "ess", "t": "tee", "u": "you", "v": "vee", "w": "double you",
    "x": "ex", "y": "why", "z": "zee",
}

_ABBREV = {
    "mr": "mister", "mrs": "missus", "ms": "miz", "dr": "doctor",
    "st": "saint", "vs": "versus", "etc": "et cetera", "no": "number",
    "jr": "junior", "sr": "senior", "prof": "professor",
}

# units read after a number ("5 km" -> "five kilometers")
_NUM_UNITS = {
    "km": "kilometers", "m": "meters", "cm": "centimeters",
    "mm": "millimeters", "kg": "kilograms", "g": "grams", "lb": "pounds",
    "mph": "miles per hour", "kmh": "kilometers per hour", "hz": "hertz",
    "khz": "kilohertz", "mhz": "megahertz", "ghz": "gigahertz",
    "kb": "kilobytes", "mb": "megabytes", "gb": "gigabytes",
    "tb": "terabytes", "ms": "milliseconds", "min": "minutes",
    "hr": "hours", "sec": "seconds", "ft": "feet", "mi": "miles",
}

_BIG_NAMES = ("trillion", "billion", "million", "thousand", "hundred")

_MONTHS = (
    "january", "february", "march", "april", "may", "june", "july",
    "august", "september", "october", "november", "december",
)


def _slash_date(m: "re.Match[str]") -> str:
    a, b, year = int(m.group(1)), int(m.group(2)), m.group(3)
    if 1 <= a <= 12 and 1 <= b <= 31 and not (a > 12 or (b <= 12 and a > 12)):
        mon, day = a, b  # US month-first by default
    elif 1 <= b <= 12 and 1 <= a <= 31:
        mon, day = b, a  # day-first when the first number can't be a month
    else:
        return (
            english_number_to_words(a) + " slash " + english_number_to_words(b)
        )
    out = f"{_MONTHS[mon - 1]} {english_ordinal_words(day)}"
    if year:
        y = int(year)
        out += " " + _year_words(y + 2000 if y < 100 else y)
    return out


def _digits_seq(s: str) -> str:
    """Digit-by-digit reading ("0 4 5" style, phone numbers / long ids)."""
    return " ".join("oh" if c == "0" else _UNITS[int(c)] for c in s)


def _decimal_words(s: str) -> str:
    whole, frac = s.split(".")
    return (
        english_number_to_words(int(whole))
        + " point "
        + _digits_seq(frac).replace("oh", "zero")
    )


def _money_words(amount: str, scale: str | None) -> str:
    """$ amounts: $5 -> five dollars, $5.50 -> five dollars fifty cents,
    $3.2 million -> three point two million dollars."""
    amount = amount.replace(",", "")
    if scale:
        num = (
            _decimal_words(amount) if "." in amount
            else english_number_to_words(int(amount))
        )
        return f"{num} {scale} dollars"
    if "." in amount:
        whole, frac = amount.split(".")
        frac = (frac + "0")[:2]
        out = english_number_to_words(int(whole)) + (
            " dollar" if int(whole) == 1 else " dollars"
        )
        if int(frac):
            out += " " + english_number_to_words(int(frac)) + (
                " cent" if int(frac) == 1 else " cents"
            )
        return out
    n = int(amount)
    return english_number_to_words(n) + (" dollar" if n == 1 else " dollars")


def _time_words(h: str, m: str, suffix: str) -> str:
    hh, mm = int(h), int(m)
    if not 0 <= hh <= 23 or not 0 <= mm <= 59:
        return f"{english_number_to_words(int(h))} {english_number_to_words(int(m))}"
    out = english_number_to_words(hh if hh else 12)
    if mm == 0:
        out += " o'clock" if not suffix else ""
    elif mm < 10:
        out += " oh " + _UNITS[mm]
    else:
        out += " " + english_number_to_words(mm)
    if suffix:
        out += " " + " ".join(_LETTER_NAMES[c] for c in suffix.lower() if c.isalpha())
    return out


def normalize_english(text: str) -> str:
    """Expand numerals/symbols in English text to spoken words.

    Case-preserving for ordinary words (the phonemizer lowercases later);
    expansions are emitted lowercase."""
    t = " " + text + " "

    # currency (before thousands-comma stripping eats the $ pattern)
    t = re.sub(
        r"\$\s?(\d+(?:,\d{3})*(?:\.\d+)?)\s*(trillion|billion|million|thousand|[kK]\b)?",
        lambda m: " "
        + _money_words(
            m.group(1),
            {"k": "thousand", "K": "thousand"}.get(m.group(2), m.group(2))
            if m.group(2)
            else None,
        )
        + " ",
        t,
    )
    # comma-formatted numbers are explicit quantities (never years):
    # 1,234 -> one thousand two hundred thirty four
    t = re.sub(
        r"\b\d{1,3}(?:,\d{3})+\b",
        lambda m: english_number_to_words(int(m.group(0).replace(",", ""))),
        t,
    )
    # percent
    t = re.sub(
        r"(\d+(?:\.\d+)?)\s?%",
        lambda m: (
            _decimal_words(m.group(1))
            if "." in m.group(1)
            else english_number_to_words(int(m.group(1)))
        )
        + " percent",
        t,
    )
    # times: 9:30, 12:05 am
    t = re.sub(
        r"\b(\d{1,2}):(\d{2})\s?(am|pm|AM|PM|a\.m\.|p\.m\.)?\b",
        lambda m: _time_words(
            m.group(1), m.group(2), (m.group(3) or "").replace(".", "")
        ),
        t,
    )
    # ordinals: 1st 2nd 3rd 4th
    t = re.sub(
        r"\b(\d+)(?:st|nd|rd|th)\b",
        lambda m: english_ordinal_words(int(m.group(1))),
        t,
    )
    # ISO dates: 2020-08-16 -> august sixteenth twenty twenty
    t = re.sub(
        r"\b(\d{4})-(\d{1,2})-(\d{1,2})\b",
        lambda m: (
            f"{_MONTHS[int(m.group(2)) - 1]} "
            f"{english_ordinal_words(int(m.group(3)))} "
            f"{_year_words(int(m.group(1)))}"
            if 1 <= int(m.group(2)) <= 12 and 1 <= int(m.group(3)) <= 31
            else m.group(0)
        ),
        t,
    )
    # slash dates: 8/16 or 16/8 (day>12 disambiguates) + optional year
    t = re.sub(r"\b(\d{1,2})/(\d{1,2})(?:/(\d{2,4}))?\b", _slash_date, t)
    # numeric ranges: 5-10 -> five to ten
    t = re.sub(
        r"\b(\d+)\s*[-–]\s*(\d+)\b",
        lambda m: english_number_to_words(int(m.group(1)))
        + " to "
        + english_number_to_words(int(m.group(2))),
        t,
    )
    # decimals
    t = re.sub(r"\b(\d+\.\d+)\b", lambda m: _decimal_words(m.group(1)), t)
    # number + unit abbreviation
    unit_alt = "|".join(sorted(_NUM_UNITS, key=len, reverse=True))
    t = re.sub(
        rf"\b(\d+)\s?({unit_alt})\b",
        lambda m: english_number_to_words(int(m.group(1)))
        + " "
        + _NUM_UNITS[m.group(2)],
        t,
    )
    # years in context: standalone 4-digit numbers in a year-like range
    t = re.sub(
        r"\b(1[1-9]\d\d|20\d\d)\b",
        lambda m: _year_words(int(m.group(1))),
        t,
    )
    # long digit strings (ids / phone numbers): digit by digit
    t = re.sub(r"\b(\d{7,})\b", lambda m: _digits_seq(m.group(1)), t)
    # plain integers
    t = re.sub(
        r"\b(\d+)\b", lambda m: english_number_to_words(int(m.group(1))), t
    )
    # alphanumeric mixes: b2 -> b two (after pure numbers so \b is clean)
    t = re.sub(
        r"\b([A-Za-z]+)(\d+)\b",
        lambda m: m.group(1) + " " + english_number_to_words(int(m.group(2))),
        t,
    )
    t = re.sub(
        r"\b(\d+)([A-Za-z]+)\b",
        lambda m: english_number_to_words(int(m.group(1))) + " " + m.group(2),
        t,
    )
    # abbreviations with optional trailing period
    abbrev_alt = "|".join(_ABBREV)
    t = re.sub(
        rf"\b({abbrev_alt})\.(?=\s|$)",
        lambda m: _ABBREV[m.group(1).lower()],
        t,
        flags=re.IGNORECASE,
    )
    # title abbreviations without the period still read as the title when
    # capitalized and followed by a capitalized word (Mr Smith)
    t = re.sub(
        r"\b(Mr|Mrs|Ms|Dr|Prof)\b(?=\s+[A-Z])",
        lambda m: _ABBREV[m.group(1).lower()],
        t,
    )
    # acronyms: 2-6 letter ALL-CAPS tokens spell out letter by letter
    # (unless they read as a plain word the lexicon knows, e.g. "NASA" is
    # left to LTS only when not consonant-heavy — the simple rule: spell
    # everything all-caps; writers use caps for initialisms)
    def _spell(m: re.Match) -> str:
        word = m.group(0)
        return " ".join(_LETTER_NAMES[c] for c in word.lower())

    t = re.sub(r"\b[A-Z]{2,6}\b(?!\.\d)", _spell, t)

    return re.sub(r"\s+", " ", t).strip()
