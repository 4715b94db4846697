"""Language frontend registry.

The reference hard-codes its language routing in a dict of external models
(reference: synthesizer.py:12-25).  Here every language is an in-framework
frontend — (symbol table, text->ids, phonemizer) — registered by code, so
the engine, bundles, training CLI, and router all scale to N languages
without per-language if/else at the call sites.  A bundle's meta.json
records its frontend name; loading resolves it through this registry.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple


class Frontend(NamedTuple):
    name: str
    symbols: tuple                      # model input inventory
    symbol_to_id: dict
    to_sequence: Callable[..., list]    # text -> ids
    phonemize: Callable[..., Tuple[List[str], List[int]]]
    normalize: Callable[[str], str]     # raw text -> speakable text


def _vie() -> Frontend:
    from . import text_to_sequence
    from .g2p import phonemize
    from .normalizer import normalize_text
    from .symbols import SYMBOL_TO_ID, symbols

    return Frontend(
        "vie", symbols, SYMBOL_TO_ID, text_to_sequence, phonemize,
        normalize_text,
    )


def _eng() -> Frontend:
    from .english import (
        ENGLISH_SYMBOL_TO_ID,
        ENGLISH_SYMBOLS,
        english_phonemize,
        english_to_sequence,
    )
    from .english_normalizer import normalize_english

    # foreign_dict is the VN-frontend per-corpus override mechanism; the
    # other frontends accept and ignore it so call sites stay uniform
    def to_seq(text, foreign_dict=None):
        return english_to_sequence(text)

    return Frontend(
        "eng", ENGLISH_SYMBOLS, ENGLISH_SYMBOL_TO_ID, to_seq,
        english_phonemize, normalize_english,
    )


def _mya() -> Frontend:
    from .burmese import (
        MYA_SYMBOL_TO_ID,
        MYA_SYMBOLS,
        burmese_phonemize,
        burmese_to_sequence,
        normalize_burmese,
    )

    def to_seq(text, foreign_dict=None):
        return burmese_to_sequence(text)

    return Frontend(
        "mya", MYA_SYMBOLS, MYA_SYMBOL_TO_ID, to_seq, burmese_phonemize,
        normalize_burmese,
    )


_REGISTRY: Dict[str, Callable[[], Frontend]] = {
    "vie": _vie,
    "eng": _eng,
    "mya": _mya,
}
_CACHE: Dict[str, Frontend] = {}


def available_languages() -> Sequence[str]:
    return sorted(_REGISTRY)


def get_frontend(language: str) -> Frontend:
    if language not in _REGISTRY:
        raise ValueError(
            f"unknown language {language!r}; have {available_languages()}"
        )
    if language not in _CACHE:
        _CACHE[language] = _REGISTRY[language]()
    return _CACHE[language]
