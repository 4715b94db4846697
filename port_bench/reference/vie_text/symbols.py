"""Model input symbol inventory.

Must match the reference vocabulary exactly (reference:
e2e_tts/models/g2p/symbols.py:21-50): 4 specials + 23 consonants + 2 medials
+ 15 vowels x 6 tones + 12 codas = 131 symbols, all uppercase.  The CMU
ARPAbet set is available for foreign-word support but excluded from the
default inventory, as in the serving copy (src/api/g2p/symbols.py:37).
"""

from .phonology import CODAS, DIPHTHONGS, MEDIALS, MONOPHTHONGS, ONSETS, TONES

PAD = "<PAD>"
SILENT = "<SILENT>"
BOS = "<S>"
EOS = "</S>"

SPECIALS = (PAD, SILENT, BOS, EOS)

CONSONANTS = tuple(sorted(set(ONSETS.values())))
MEDIAL_SYMBOLS = tuple(sorted(set(MEDIALS.values())))
# Monophthongs sorted, then the three diphthongs — matching the reference's
# ordering ["a","aa","aw","e","ee","i","o","oa","oo","ow","u","uw"] + ["ie","uo","wa"].
VOWELS = tuple(sorted(set(MONOPHTHONGS.values()))) + tuple(sorted(set(DIPHTHONGS.values())))
CODA_SYMBOLS = tuple(sorted(set(CODAS.values())))

TONED_VOWELS = tuple(f"{v}_{t}" for v in VOWELS for t in TONES)

# Bare (stress-stripped) ARPAbet inventory: the sequence codec strips the
# stress digit before lookup ("@AA1" -> "@AA", reference g2p/__init__.py:52),
# so the table stores one entry per phone, not per stress variant.
CMU = tuple(
    f"@{ph}"
    for ph in (
        "AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N NG "
        "OW OY P R S SH T TH UH UW V W Y Z ZH"
    ).split()
)


def build_symbols(include_cmu: bool = False) -> tuple:
    base = SPECIALS + CONSONANTS + MEDIAL_SYMBOLS + TONED_VOWELS + CODA_SYMBOLS
    if include_cmu:
        base = base + CMU
    return tuple(s.upper() for s in base)


symbols = build_symbols()

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(symbols)}

PAD_ID = SYMBOL_TO_ID[PAD]
SILENT_ID = SYMBOL_TO_ID[SILENT.upper()]
EOS_ID = SYMBOL_TO_ID[EOS]
