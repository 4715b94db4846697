from .g2p import (
    G2PError,
    is_valid_syllable,
    load_foreign_dict,
    normalize_phonemes,
    phonemize,
    syllable_to_phonemes,
    vi_convert,
)
from .normalizer import HttpNormalizer, normalize_text, number_to_words
from .sequence import (
    basic_cleaners,
    phonemes_to_sequence,
    sequence_to_phonemes,
    sequence_to_text,
    text_to_sequence,
)
from .symbols import (
    EOS_ID,
    PAD_ID,
    SILENT_ID,
    SYMBOL_TO_ID,
    build_symbols,
    symbols,
)
