"""The PyTorch port's copy of the text frontend against ``e2e_tts_tpu.text``:
``normalize_text`` and ``text_to_sequence`` (through each language's
frontend) must give exactly the same output on the golden texts, a
normalizer case and a sample of ``tests/assets/lts_benchmark_words.txt``."""

import os

import pytest

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.text import normalize_text as jax_normalize_text
from e2e_tts_tpu.text import text_to_sequence as jax_text_to_sequence
from e2e_tts_tpu.text.frontends import get_frontend as jax_frontend
from e2e_tts_tpu_torch.text import normalize_text, text_to_sequence
from e2e_tts_tpu_torch.text.frontends import get_frontend

pytestmark = pytest.mark.usefixtures("one_thread")

WORDS = os.path.join(os.path.dirname(__file__), "assets", "lts_benchmark_words.txt")

GOLDEN = {  # tools/regen_golden.py GOLDEN_TEXTS, plus one normalizer case each
    "vie": ["xin chào việt nam", "em yêu hoa lá trên núi", "Hôm nay 16/8, nhiệt độ 35 độ."],
    "eng": ["hello world we sing", "the sun and the moon", "Dr. Smith paid $3.50 on 12/5."],
    "mya": ["နေ ကောင်း လမ်း", "ရေ မိုး တောင်", "၁၂၃ ရေ"],
}


def _word_sample():
    with open(WORDS, encoding="utf8") as f:
        words = f.read().split()
    return [" ".join(words[i:i + 12]) for i in range(0, len(words), 12)]


def _run(fe, text):
    """normalize then to_sequence; an exception is part of the output."""
    try:
        return fe.to_sequence(fe.normalize(text))
    except Exception as e:  # noqa: BLE001 - compared by type and message
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("lang", sorted(GOLDEN))
def test_frontend_matches_jax(lang):
    ours, theirs = get_frontend(lang), jax_frontend(lang)
    assert ours.symbols == theirs.symbols
    assert ours.symbol_to_id == theirs.symbol_to_id
    texts = GOLDEN[lang] + _word_sample()
    n_seq = 0
    for text in texts:
        got, want = _run(ours, text), _run(theirs, text)
        assert got == want, text
        n_seq += isinstance(got, list) and len(got) > 0
    assert n_seq >= len(GOLDEN[lang])  # the golden texts all phonemize


def test_vietnamese_entry_points_match_jax():
    for text in GOLDEN["vie"]:
        assert normalize_text(text) == jax_normalize_text(text)
        assert text_to_sequence(normalize_text(text)) == jax_text_to_sequence(
            jax_normalize_text(text))
