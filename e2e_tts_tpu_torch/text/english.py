"""English text frontend (ARPAbet).

The reference serves English through an external Coqui-TTS VITS checkpoint
(reference: synthesizer.py:12-25) and runs g2p_en (trained LTS + CMUdict)
for English words embedded in Vietnamese text (models/g2p/g2p.py:56,146-150).
External torch checkpoints cannot ship here, so English is a first-class
in-framework frontend instead, with the same lexicon-first architecture as
g2p_en:

1. a ~1,500-lemma pronunciation lexicon (text/data/english_lexicon.txt,
   CMUdict-style entries — the CMU dictionary is public domain),
2. a morphological layer that derives inflected forms (plural -s/-es, past
   -ed, -ing, -er/-est, -ly, -ness/-ful/-less, possessives) from lexicon
   lemmas with the correct voicing-conditioned suffix phonology, and
3. rule-based letter-to-sound for true OOV words (accuracy quantified by
   tests/test_english.py::test_lts_heldout_accuracy).

All paths emit the same "@PH" ARPAbet tags the VN foreign-word path uses.
Models trained with this frontend use the extended symbol table
(build_symbols(include_cmu=True), 200 symbols; VN ids are unchanged because
the CMU block appends after them).
"""

from __future__ import annotations

import os
import re
import string
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .symbols import build_symbols

ENGLISH_SYMBOLS = build_symbols(include_cmu=True)
ENGLISH_SYMBOL_TO_ID = {s: i for i, s in enumerate(ENGLISH_SYMBOLS)}

SILENT = "<silent>"
EOS = "</s>"

# Hand-written CMU pronunciations for the core vocabulary (stress digits are
# stripped by the sequence codec, kept here for fidelity to CMUdict).
_LEXICON: Dict[str, str] = {
    "a": "AH0", "about": "AH0 B AW1 T", "all": "AO1 L", "and": "AH0 N D",
    "are": "AA1 R", "bird": "B ER1 D", "blue": "B L UW1", "boy": "B OY1",
    "bright": "B R AY1 T", "cat": "K AE1 T", "cloud": "K L AW1 D",
    "cold": "K OW1 L D", "come": "K AH1 M", "dark": "D AA1 R K",
    "day": "D EY1", "dog": "D AO1 G", "down": "D AW1 N",
    "dream": "D R IY1 M", "earth": "ER1 TH", "fire": "F AY1 ER0",
    "fish": "F IH1 SH", "flower": "F L AW1 ER0", "fly": "F L AY1",
    "for": "F AO1 R", "girl": "G ER1 L", "go": "G OW1", "good": "G UH1 D",
    "green": "G R IY1 N", "hello": "HH AH0 L OW1", "high": "HH AY1",
    "home": "HH OW1 M", "house": "HH AW1 S", "i": "AY1", "in": "IH0 N",
    "is": "IH1 Z", "lake": "L EY1 K", "light": "L AY1 T",
    "love": "L AH1 V", "low": "L OW1", "moon": "M UW1 N",
    "morning": "M AO1 R N IH0 NG", "mountain": "M AW1 N T AH0 N",
    "night": "N AY1 T", "of": "AH0 V", "on": "AA1 N", "rain": "R EY1 N",
    "red": "R EH1 D", "river": "R IH1 V ER0", "sea": "S IY1",
    "sing": "S IH1 NG", "sky": "S K AY1", "snow": "S N OW1",
    "song": "S AO1 NG", "star": "S T AA1 R", "stone": "S T OW1 N",
    "sun": "S AH1 N", "the": "DH AH0", "tree": "T R IY1", "up": "AH1 P",
    "warm": "W AO1 R M", "water": "W AO1 T ER0", "we": "W IY1",
    "wind": "W IH1 N D", "world": "W ER1 L D", "you": "Y UW1",
}

# corpus vocabulary for the synthetic English voice (all lexicon-backed)
ENGLISH_VOCAB = (
    "hello world we sing the sun and moon star sky sea rain wind tree "
    "flower bird fish river mountain light dark day night love dream home"
).split()


def _load_lexicon_file() -> Dict[str, str]:
    path = os.path.join(os.path.dirname(__file__), "data", "english_lexicon.txt")
    out: Dict[str, str] = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            word, _, phones = line.partition(" ")
            out[word.lower()] = phones.strip()
    return out


# file entries win over the legacy inline seed lexicon
_LEXICON.update(_load_lexicon_file())


# --- morphology: derive inflected forms from lexicon lemmas -----------------

_VOICELESS = frozenset("P T K F TH S SH CH HH".split())
_SIBILANT = frozenset("S Z SH ZH CH JH".split())


def _strip_stress(p: str) -> str:
    return p.rstrip("012")


def _plural_suffix(phones: List[str]) -> List[str]:
    last = _strip_stress(phones[-1])
    if last in _SIBILANT:
        return ["IH0", "Z"]
    if last in _VOICELESS:
        return ["S"]
    return ["Z"]


def _past_suffix(phones: List[str]) -> List[str]:
    last = _strip_stress(phones[-1])
    if last in ("T", "D"):
        return ["IH0", "D"]
    if last in _VOICELESS:
        return ["T"]
    return ["D"]


def _lemma_phones(base: str) -> Optional[List[str]]:
    phones = _LEXICON.get(base)
    return phones.split() if phones else None


def _stem_candidates(stem: str) -> List[str]:
    """Spelling variants a suffix-stripped stem may correspond to:
    "mak" -> "make" (dropped silent e), "runn" -> "run" (doubled final
    consonant), "happi" -> "happy" (y -> i mutation)."""
    cands = [stem]
    if stem and stem[-1] not in "aeiou":
        cands.append(stem + "e")
        if len(stem) >= 2 and stem[-1] == stem[-2]:
            cands.append(stem[:-1])
    if stem.endswith("i"):
        cands.append(stem[:-1] + "y")
    return cands


def _inflected_phones(word: str) -> Optional[List[str]]:
    """Derive an inflected form's phones from a lexicon lemma, or None."""
    if word in _LEXICON:
        return None  # plain lookup handles it

    # possessives / contractions of 's
    if word.endswith("'s"):
        base = word[:-2]
        phones = _lemma_phones(base) or _inflected_phones(base)
        if phones:
            return phones + _plural_suffix(phones)
        return None
    if word.endswith("s'"):
        # plural possessive: the base ("dogs") already carries its /z/ —
        # the apostrophe adds nothing phonetically
        base = word[:-1]
        return _lemma_phones(base) or _inflected_phones(base)

    # -ies / -ied: "cities" -> city + Z, "carried" -> carry + D
    if word.endswith("ies") or word.endswith("ied"):
        phones = _lemma_phones(word[:-3] + "y")
        if phones:
            tail = _plural_suffix(phones) if word.endswith("s") else _past_suffix(phones)
            return phones + tail

    # -es after a sibilant: "boxes", "watches"
    if word.endswith("es"):
        for base in _stem_candidates(word[:-2]):
            phones = _lemma_phones(base)
            if phones:
                last = _strip_stress(phones[-1])
                if last in _SIBILANT:
                    return phones + ["IH0", "Z"]
                return phones + _plural_suffix(phones)

    # plural / 3rd-person -s; the base may itself be derived ("viewers"
    # -> viewer -> view + ER), so fall back to one recursion level
    if word.endswith("s") and not word.endswith("ss"):
        base = word[:-1]
        phones = _lemma_phones(base) or _inflected_phones(base)
        if phones:
            return phones + _plural_suffix(phones)

    # past -ed: "walked", "loved" (e-final lemma), "planned" (doubling)
    if word.endswith("ed"):
        for base in _stem_candidates(word[:-2]):
            phones = _lemma_phones(base)
            if phones:
                return phones + _past_suffix(phones)

    # progressive -ing: "walking", "making", "running"
    if word.endswith("ing"):
        for base in _stem_candidates(word[:-3]):
            phones = _lemma_phones(base)
            if phones:
                return phones + ["IH0", "NG"]

    # comparative -er / superlative -est
    if word.endswith("er"):
        for base in _stem_candidates(word[:-2]):
            phones = _lemma_phones(base)
            if phones:
                return phones + ["ER0"]
    if word.endswith("est"):
        for base in _stem_candidates(word[:-3]):
            phones = _lemma_phones(base)
            if phones:
                return phones + ["AH0", "S", "T"]

    # adverbial -ly, nominal -ness, adjectival -ful / -less
    for suffix, tail in (
        ("ly", ["L", "IY0"]),
        ("ness", ["N", "AH0", "S"]),
        ("ful", ["F", "AH0", "L"]),
        ("less", ["L", "AH0", "S"]),
    ):
        if word.endswith(suffix):
            stem = word[: -len(suffix)]
            for base in _stem_candidates(stem):
                phones = _lemma_phones(base)
                if phones:
                    return phones + tail
    return None

# ---------------------------------------------------------------------------
# Rule-based letter-to-sound fallback.  Longest-match left-to-right over
# (grapheme, context) patterns; "$" anchors end of word.  Coverage is the
# usual rough 80% of regular English spellings — OOV words get a consistent,
# trainable pronunciation rather than a crash (the serving contract).
# ---------------------------------------------------------------------------

_RULES: List[Tuple[str, str]] = [
    # multi-letter endings
    ("ation$", "EY1 SH AH0 N"), ("ations$", "EY1 SH AH0 N Z"),
    # vowel + tion/sion: the vowel reads long/tense (motion, solution,
    # completion, edition; occasion, explosion, confusion); a consonant
    # before -tion keeps the short stressed vowel (section, function)
    ("quation", "K W EY1 ZH AH0 N"),
    ("otion", "OW1 SH AH0 N"), ("ution", "UW1 SH AH0 N"),
    ("etion", "IY1 SH AH0 N"), ("ition", "IH1 SH AH0 N"),
    ("asion", "EY1 ZH AH0 N"), ("osion", "OW1 ZH AH0 N"),
    ("usion", "UW1 ZH AH0 N"), ("esion", "IY1 ZH AH0 N"),
    ("ption", "P SH AH0 N"), ("nction", "NG K SH AH0 N"),
    ("ction", "K SH AH0 N"),
    ("tions$", "SH AH0 N Z"), ("sions$", "ZH AH0 N Z"),
    ("ould$", "UH1 D"), ("ange$", "EY1 N JH"), ("aste$", "EY1 S T"),
    ("ouse$", "AW1 S"), ("ause$", "AO1 Z"), ("ase$", "EY1 S"),
    ("ese$", "IY1 Z"),
    ("ssion", "SH AH0 N"), ("nsion", "N SH AH0 N"),
    ("stion", "S CH AH0 N"), ("tion", "SH AH0 N"), ("sion", "ZH AH0 N"),
    ("tious$", "SH AH0 S"),
    ("cious$", "SH AH0 S"), ("ture$", "CH ER0"), ("sure$", "ZH ER0"),
    ("tial$", "SH AH0 L"), ("cial$", "SH AH0 L"), ("ought", "AO1 T"),
    ("iation", "IY0 EY1 SH AH0 N"), ("ium$", "IY0 AH0 M"),
    ("ial$", "IY0 AH0 L"), ("gious$", "JH AH0 S"), ("ious$", "IY0 AH0 S"),
    ("ften$", "F AH0 N"), ("gue$", "G"), ("iew", "Y UW1"),
    ("aught", "AO1 T"), ("ight", "AY1 T"), ("eigh", "EY1"), ("igh", "AY1"),
    ("able$", "AH0 B AH0 L"), ("ible$", "AH0 B AH0 L"),
    ("ism$", "IH0 Z AH0 M"), ("sist", "S IH1 S T"), ("xist", "G Z IH1 S T"),
    ("ist$", "AH0 S T"), ("ity$", "IH0 T IY0"),
    ("ment$", "M AH0 N T"), ("ness$", "N AH0 S"), ("ship$", "SH IH0 P"),
    ("ish$", "IH0 SH"), ("ous$", "AH0 S"), ("age$", "IH0 JH"), ("ate$", "EY2 T"),
    ("ize$", "AY2 Z"), ("ise$", "AY2 Z"), ("ify$", "IH0 F AY2"),
    ("ive$", "IH0 V"), ("ogy$", "AH0 JH IY0"), ("ical$", "IH0 K AH0 L"),
    ("ing$", "IH0 NG"), ("ings$", "IH0 NG Z"),
    ("ies$", "IY0 Z"), ("ey$", "IY0"), ("y$", "IY0"), ("le$", "AH0 L"),
    ("ce$", "S"), ("ge$", "JH"), ("ve$", "V"), ("o$", "OW1"),
    ("se$", "S"), ("ic$", "IH0 K"), ("gy$", "JH IY0"),
    ("uge$", "Y UW1 JH"), ("ceive$", "S IY1 V"),
    # consonant digraphs
    ("machighn$", "M AH0 SH IY1 N"), ("chighn$", "SH IY1 N"), ("zighn$", "Z IY1 N"),
    ("cighn$", "S AH0 N"), ("gighn$", "JH AH0 N"),
    ("ocial", "OW1 SH AH0 L"),
    ("tch", "CH"), ("dge", "JH"), ("chr", "K R"), ("sch", "S K"),
    ("ch", "CH"), ("sh", "SH"),
    ("th", "TH"), ("ph", "F"), ("gh", "G"), ("wh", "W"), ("ck", "K"),
    ("ng", "NG"), ("quite$", "K W AY1 T"), ("quiet", "K W AY1 AH0 T"),
    ("qu", "K W"), ("wr", "R"), ("kn", "N"),
    ("mb$", "M"), ("sc", "S K"), ("dd", "D"), ("bb", "B"), ("tt", "T"),
    ("pp", "P"), ("ss", "S"), ("ll", "L"), ("mm", "M"), ("nn", "N"),
    ("rr", "R"), ("ff", "F"), ("gg", "G"), ("zz", "Z"), ("cc", "K"),
    # vowel + context patterns
    ("ally$", "AH0 L IY0"), ("alk", "AO1 K"),
    ("all", "AO1 L"), ("old$", "OW1 L D"), ("ind$", "AY1 N D"),
    ("every", "EH1 V R IY0"), ("ware", "W EH1 R"), ("war", "W AO1 R"), ("ood$", "UH1 D"), ("uni", "Y UW1 N"),
    ("neath", "N IY1 TH"), ("eathe", "IY1 DH"), ("eath", "EH1 TH"),
    ("break", "B R EY1 K"), ("nough", "N AH1 F"),
    ("cough", "K AO1 F"), ("though", "DH OW1"),
    ("aig$", "EY1 JH"), ("aig", "EY1"), ("eeg$", "IH0 JH"),
    ("ealth", "EH1 L TH"), ("easure", "EH1 ZH ER0"),
    ("eaven", "EH1 V AH0 N"), ("ough$", "OW1"), ("oar", "AO1 R"),
    ("ngth", "NG K TH"), ("xch", "K S CH"), ("xc", "K S"), ("tz", "T S"), ("ieth$", "IY0 AH0 TH"), ("gent$", "JH AH0 N T"), ("vent$", "V EH2 N T"),
    ("ccent", "K S EH2 N T"), ("mment", "M EH2 N T"),
    ("ntent$", "N T EH2 N T"), ("xtent$", "K S T EH2 N T"),
    ("ernet$", "ER0 N EH2 T"), ("forget", "F ER0 G EH1 T"),
    ("area", "EH1 R IY0 AH0"), ("event$", "IH0 V EH1 N T"), ("events$", "IH0 V EH1 N T S"),
    ("america", "AH0 M EH1 R AH0 K"), ("another", "AH0 N AH1 DH ER0"), ("where", "W EH1 R"),
    ("already", "AO0 L R EH1 D IY0"), ("stead", "S T EH2 D"),
    ("alt", "AO1 L T"), ("nk", "NG K"),
    ("ire$", "AY1 ER0"), ("ired$", "AY1 ER0 D"), ("ires$", "AY1 ER0 Z"),
    ("rive$", "R AY1 V"), ("use$", "Y UW1 Z"),
    ("stle$", "S AH0 L"), ("sten$", "S AH0 N"),
    ("are$", "EH1 R"), ("arr", "EH1 R"), ("err", "EH1 R"), ("orr", "AO1 R"), ("urr", "ER1"),
    ("oubt", "AW1 T"), ("ebt", "EH1 T"), ("eighth", "EY1 T TH"),
    ("either", "IY1 DH ER0"), ("europ", "Y UH1 R AH0 P"),
    ("who$", "HH UW1"), ("owel", "AW1 AH0 L"), ("ninet", "N AY1 N T"),
    ("alm$", "AA1 M"), ("hour", "AW1 ER0"),
    ("exp", "IH0 K S P"), ("destr", "D IH0 S T R"),
    ("alue$", "AE1 L Y UW0"), ("ess$", "EH2 S"),
    ("transi", "T R AE1 N Z IH0"), ("engl", "IH1 NG G L"), ("ajor", "EY1 JH ER0"),
    ("cient$", "SH AH0 N T"), ("tient$", "SH AH0 N T"),
    ("ient$", "AY1 AH0 N T"), ("ilent$", "AY1 L AH0 N T"),
    ("edu", "EH1 JH AH0"), ("ffice", "F AH0 S"),
    ("othes$", "OW1 DH Z"), ("eople", "IY1 P AH0 L"),
    ("was$", "W AA1 Z"), ("wash", "W AA1 SH"),
    ("arious", "EH1 R IY0 AH0 S"), ("eai", "IY0 EY1"),
    ("ision", "IH1 ZH AH0 N"), ("pply$", "P L AY1"), ("ply$", "P L AY1"), ("fy$", "F AY2"),
    ("fying$", "F AY2 IH0 NG"), ("deny", "D IH0 N AY1"),
    ("ccupy", "K Y AH0 P AY2"), ("july", "JH UW0 L AY1"),
    ("earby", "IH1 R B AY1"), ("erfly", "ER0 F L AY2"),
    ("die$", "D AY1"), ("lie$", "L AY1"), ("tie$", "T AY1"),
    ("pie$", "P AY1"), ("via", "V AY1 AH0"), ("rial", "R AY1 AH0 L"),
    ("cience", "S AY1 AH0 N S"), ("iny$", "AY1 N IY0"), ("ycle", "AY1 K AH0 L"),
    ("ilot", "AY1 L AH0 T"), ("item", "AY1 T AH0 M"),
    ("ina$", "AY1 N AH0"), ("rivate", "R AY1 V AH0 T"),
    ("rimary", "R AY1 M EH2 R IY0"), ("rivacy", "R AY1 V AH0 S IY0"),
    ("iolog", "AY0 AA1 L AH0 JH"), ("ydr", "AY1 D R"),
    ("five", "F AY1 V"), ("dive$", "D AY1 V"), ("vive", "V AY1 V"),
    ("alive", "AH0 L AY1 V"), ("ninth", "N AY1 N TH"),
    ("ilence", "S AY1 L AH0 N S"), ("iday", "AY1 D EY2"),
    ("inor", "AY1 N ER0"), ("icense", "AY1 S AH0 N S"),
    ("ynam", "AY0 N AE1 M"), ("idea", "AY0 D IY1 AH0"),
    ("identi", "AY0 D EH1 N T"), ("hild", "HH AY1 L D"),
    ("ide$", "AY1 D"),
    ("inal$", "AY1 N AH0 L"),
    ("inus", "AY1 N AH0 S"), ("ibr", "AY1 B R"),
    ("oul", "OW1 L"), ("eather", "EH1 DH ER0"), ("irr", "IH1 R"),
    ("eau", "Y UW1"), ("inute", "IH1 N AH0 T"),
    ("ience$", "IY0 AH0 N S"), ("noth", "N AH1 TH"), ("pull", "P UH1 L"), ("push", "P UH1 SH"),
    ("put$", "P UH1 T"), ("move", "M UW1 V"), ("prove", "P R UW1 V"),
    ("love", "L AH1 V"), ("mood", "M UW1 D"), ("food", "F UW1 D"),
    ("once", "W AH1 N S"), ("howev", "HH AW2 EH1 V"),
    ("open", "OW1 P AH0 N"), ("econd", "EH1 K AH0 N D"),
    ("said", "S EH1 D"), ("ecret", "IY1 K R AH0 T"),
    ("ecent", "IY1 S AH0 N T"), ("enior", "IY1 N Y ER0"),
    ("junior", "JH UW1 N Y ER0"), ("llion", "L Y AH0 N"),
    ("lion$", "L AY1 AH0 N"), ("inion", "IH1 N Y AH0 N"),
    ("atient", "EY1 SH AH0 N T"), ("ssenger", "S AH0 N JH ER0"),
    ("mportant", "M P AO1 R T AH0 N T"), ("island", "AY1 L AH0 N D"),
    ("into$", "IH1 N T UW2"), ("often", "AO1 F AH0 N"),
    ("soft", "S AO1 F T"), ("heart", "HH AA1 R T"),
    ("roup", "R UW1 P"), ("soup", "S UW1 P"),
    ("laugh", "L AE1 F"), ("ocean", "OW1 SH AH0 N"),
    ("oldier", "OW1 L JH ER0"), ("ousand", "AW1 Z AH0 N D"),
    ("great", "G R EY1 T"), ("charac", "K EH1 R AH0 K"),
    ("nsider", "N S IH1 D ER0"), ("ustoam", "AH1 S T AH0 M"),
    ("ermine$", "ER1 M AH0 N"), ("entury", "EH1 N CH ER0 IY0"),
    ("eremony", "EH1 R AH0 M OW2 N IY0"), ("ctua", "K CH UW0"),
    ("iamond", "AY1 M AH0 N D"), ("usiness", "IH1 Z N AH0 S"),
    ("usy", "IH1 Z IY0"), ("trol$", "T R OW1 L"),
    ("sappear", "S AH0 P IH1 R"), ("broad", "B R AO1 D"),
    ("eiling", "IY1 L IH0 NG"), ("ourage", "ER1 IH0 JH"),
    ("effort", "EH1 F ER0 T"), ("omfort", "AH1 M F ER0 T"),
    ("lways", "L W EY2 Z"), ("rgue$", "R G Y UW0"),
    ("dozen", "D AH1 Z AH0 N"), ("bove$", "B AH1 V"),
    ("cover", "K AH1 V ER0"), ("does$", "D AH1 Z"),
    ("offee", "AO1 F IY0"), ("loth$", "L AO1 TH"),
    ("rvice", "R V AH0 S"), ("vice$", "V AY1 S"),
    ("vise$", "V AY1 Z"), ("coam$", "K AH1 M"),
    ("soam$", "S AH0 M"),
    ("otor", "OW1 T ER0"), ("aise$", "EY1 Z"), ("eeze$", "IY1 Z"),
    ("ily$", "AH0 L IY0"), ("whol", "HH OW1 L"),
    ("qual", "K W AA1 L"), ("quant", "K W AA1 N T"),
    ("crease$", "K R IY1 S"), ("lease$", "L IY1 S"), ("ease$", "IY1 Z"),
    ("easure", "EH1 ZH ER0"), ("oise$", "OY1 Z"), ("uise$", "UW1 Z"),
    ("choose", "CH UW1 Z"), ("bserv", "B Z ER1 V"),
    ("bsor", "B Z AO1 R"), ("sday", "Z D EY2"), ("news", "N UW1 Z"),
    ("transl", "T R AE1 N Z L"), ("transm", "T R AE1 N Z M"),
    ("journ", "JH ER1 N"), ("nsw", "N S"), ("alf", "AE1 F"),
    ("uild", "IH1 L D"), ("uscle", "AH1 S AH0 L"),
    ("chine$", "SH IY1 N"), ("eign$", "AH0 N"), ("olor", "AH1 L ER0"),
    ("ular$", "Y AH0 L ER0"), ("gument", "G Y AH0 M AH0 N T"),
    ("cument", "K Y AH0 M AH0 N T"), ("nument", "N Y AH0 M AH0 N T"),
    ("mbulance", "M B Y AH0 L AH0 N S"), ("few", "F Y UW1"),
    ("phew", "F Y UW0"), ("user", "Y UW1 Z ER0"),
    ("unior", "UW1 N Y ER0"), ("ecule", "AH0 K Y UW2 L"),
    ("secute", "S AH0 K Y UW2 T"), ("abulary", "AE1 B Y AH0 L EH2 R IY0"),
    ("ontinue", "AH0 N T IH1 N Y UW0"), ("ercent", "ER0 S EH1 N T"),
    ("equation", "IH0 K W EY1 ZH AH0 N"), ("equ", "IY1 K W"), ("aybe$", "EY1 B IY0"), ("avor", "EY1 V ER0"), ("amous", "EY1 M AH0 S"),
    ("atal", "EY1 T AH0 L"), ("native", "N EY1 T IH0 V"),
    ("apable", "EY1 P AH0 B AH0 L"), ("chamber", "CH EY1 M B ER0"),
    ("ancient", "EY1 N CH AH0 N T"), ("april", "EY1 P R AH0 L"),
    ("data", "D EY1 T AH0"), ("amework", "EY1 M W ER2 K"),
    ("adar", "EY1 D AA2 R"), ("adio", "EY1 D IY0 OW2"),
    ("acred", "EY1 K R AH0 D"), ("aving$", "EY1 V IH0 NG"),
    ("lavery", "L EY1 V ER0 IY0"), ("eague", "IY1 G"),
    ("ague$", "EY1 G"), ("tadium", "T EY1 D IY0 AH0 M"), ("azy$", "EY1 Z IY0"), ("avy$", "EY1 V IY0"),
    ("ady$", "EY1 D IY0"), ("aby$", "EY1 B IY0"), ("abor", "EY1 B ER0"),
    ("abel", "EY1 B AH0 L"), ("acon", "EY1 K AH0 N"), ("neu", "N UW1"),
    ("ouble", "AH1 B AH0 L"), ("ower$", "AW1 ER0"), ("aigh", "EY1"),
    ("iron", "AY1 ER0 N"), ("honor", "AA1 N ER0"),
    ("honest", "AA1 N AH0 S T"), ("nior", "N Y ER0"),
    ("eese$", "IY1 Z"), ("urpose", "ER1 P AH0 S"),
    ("alm", "AO1 L M"), ("alw", "AO1 L W"), ("als", "AO1 L S"),
    ("alr", "AO1 L R"), ("terest", "T R AH0 S T"),
    ("dred$", "D R AH0 D"), ("gine$", "JH AH0 N"), ("xcuse", "K S K Y UW1 S"), ("gain", "G EH1 N"),
    ("ountain", "AW1 N T AH0 N"), ("ontain", "AH0 N T EY1 N"),
    ("btain", "B T EY1 N"), ("aintain", "EY1 N T EY2 N"),
    ("tain$", "T AH0 N"),
    ("olution", "AH0 L UW1 SH AH0 N"), ("iri", "IH1 R IH0"),
    ("eally$", "IH1 L IY0"),
    ("ager$", "IH0 JH ER0"), ("shion$", "SH AH0 N"),
    ("gion$", "JH AH0 N"), ("ion$", "Y AH0 N"),
    ("most", "M OW1 S T"), ("host", "HH OW1 S T"),
    ("post", "P OW1 S T"), ("ghost", "G OW1 S T"),
    ("ost$", "AO1 S T"), ("osen", "OW1 Z AH0 N"),
    ("ovember", "OW0 V EH1 M B ER0"), ("omework", "OW1 M W ER2 K"),
    ("otebook", "OW1 T B UH2 K"), ("oetry", "OW1 AH0 T R IY0"),
    ("oem", "OW1 AH0 M"), ("oll$", "OW1 L"), ("olls$", "OW1 L Z"),
    ("oster", "OW1 S T ER0"), ("ozone", "OW1 Z OW2 N"),
    ("onait$", "OW1 N EY2 T"), ("obighl", "OW1 B AH0 L"),
    ("photo", "F OW1 T OW2"), ("okay", "OW2 K EY1"),
    ("oven$", "AH1 V AH0 N"), ("overn", "AH1 V ER0 N"),
    ("onion", "AH1 N Y AH0 N"), ("rom$", "R AH1 M"),
    ("ront", "R AH1 N T"), ("onday", "AH1 N D EY2"),
    ("ybody", "IY0 B AA2 D IY0"), ("orgot", "ER0 G AA1 T"),
    ("rove$", "R OW1 V"), ("tove$", "T OW1 V"), ("ostly$", "OW1 S T L IY0"),
    ("oken", "OW1 K AH0 N"), ("olden", "OW1 L D AH0 N"),
    ("obal", "OW1 B AH0 L"), ("ocal", "OW1 K AH0 L"),
    ("oble", "OW1 B AH0 L"), ("otal", "OW1 T AH0 L"),
    ("only", "OW1 N L IY0"), ("oly$", "OW1 L IY0"),
    ("onus", "OW1 N AH0 S"), ("ocus", "OW1 K AH0 S"),
    ("oment", "OW1 M AH0 N T"), ("otice", "OW1 T AH0 S"),
    ("otive", "OW1 T IH0 V"), ("otel", "OW0 T EH1 L"),
    ("omain", "OW0 M EY1 N"), ("onate$", "OW1 N EY2 T"),
    ("ocery", "OW1 S ER0 IY0"), ("obody", "OW1 B AA2 D IY0"),
    ("obile", "OW1 B AH0 L"), ("obey", "OW0 B EY1"),
    ("omit", "OW0 M IH1 T"), ("oken$", "OW1 K AH0 N"),
    ("other", "AH1 DH ER0"), ("oney$", "AH1 N IY0"),
    ("onth", "AH1 N TH"), ("onkey", "AH1 NG K IY0"), ("ia$", "IY0 AH0"),
    ("ign$", "AY1 N"), ("ave$", "EY1 V"), ("ead$", "EH1 D"),
    ("eady", "EH1 D IY0"),
    ("ild$", "AY1 L D"), ("imb$", "AY1 M"), ("oth$", "OW1 TH"),
    ("off", "AO1 F"), ("ary$", "EH2 R IY0"),
    # r-controlled and vowel digraphs
    ("air", "EH1 R"), ("ear", "IH1 R"), ("eer", "IH1 R"), ("oor", "AO1 R"),
    ("our", "AO1 R"), ("ai", "EY1"), ("ay", "EY1"), ("au", "AO1"),
    ("aw", "AO1"), ("ee", "IY1"), ("ea", "IY1"), ("ei", "EY1"),
    ("ey", "EY1"), ("ew", "UW1"), ("ie", "IY1"), ("oa", "OW1"),
    ("ong", "AO1 NG"), ("oss", "AO1 S"), ("og$", "AO1 G"),
    ("ook", "UH1 K"), ("ose$", "OW1 Z"),
    ("oo", "UW1"), ("ou", "AW1"), ("ow", "OW1"), ("oi", "OY1"),
    ("oy", "OY1"), ("ue", "UW1"), ("ui", "UW1"), ("ar", "AA1 R"),
    ("wor", "W ER1"), ("er$", "ER0"), ("er", "ER1"), ("ir", "ER1"),
    ("or", "AO1 R"),
    ("ur", "ER1"),
    # single letters (soft c/g handled contextually in letter_to_sound)
    ("a", "AE1"), ("b", "B"), ("c", "K"), ("d", "D"), ("e", "EH1"),
    ("f", "F"), ("g", "G"), ("h", "HH"), ("i", "IH1"), ("j", "JH"),
    ("k", "K"), ("l", "L"), ("m", "M"), ("n", "N"), ("o", "AA1"),
    ("p", "P"), ("r", "R"), ("s", "S"), ("t", "T"), ("u", "AH1"),
    ("v", "V"), ("w", "W"), ("x", "K S"), ("y", "Y"), ("z", "Z"),
]

# "magic e": rewrite V-C-e$ so the vowel reads long via the digraph rules
# above (stone -> stoan -> S T OW1 N, time -> tighm -> T AY1 M).
# "s" is excluded: V-s-e words split S/Z lexically ("house" vs "rose")
# and get dedicated -Vse$ rules instead
_MAGIC_E = re.compile(r"(?<![aeiou])([aeiouy])([bdfgklmnprtz])e$")
_LONG_VOWEL = {"a": "ai", "e": "ee", "i": "igh", "o": "oa", "u": "ue", "y": "igh"}
# magic e through soft c ("face" -> fais -> F EY S); only for short stems —
# longer -ace/-ice endings are unstressed ("practice", "surface")
_MAGIC_CE = re.compile(r"(?<![aeiou])([aeiou])ce$")
# suffixes that keep the stem's magic-e reading: "maker", "timing".
# "v" is excluded: single-v stems before -er are mostly SHORT vowels
# (never, river, cover, ever, deliver) — "over" is the exception
_MAGIC_E_SUFFIX = re.compile(r"([aeiou])([bdfgklmnprstz])(ing|er|ers|ed)$")


_FINAL_SCHWA: List[Tuple[str, List[str]]] = [
    ("ence", ["AH0", "N", "S"]), ("ance", ["AH0", "N", "S"]),
    ("ent", ["AH0", "N", "T"]), ("ant", ["AH0", "N", "T"]),
    ("en", ["AH0", "N"]), ("el", ["AH0", "L"]), ("on", ["AH0", "N"]),
    ("om", ["AH0", "M"]),
]


_REDUCIBLE = {
    "AE1": "AH0", "AA1": "AH0", "AH1": "AH0", "EH1": "AH0", "IH1": "AH0",
}
_KEEP_FINAL_GUARD = 2  # final syllable with a 2+-consonant coda keeps stress

# Pre-stress reduction keeps more vowel-quality distinctions than the
# post-stress table: spelled "e" before the stress reads IH0 (election,
# because), tense vowels flatten to schwa (pollution, preparation).
_PRE_REDUCE = {
    "AE1": "AH0", "AA1": "AH0", "AH1": "AH0", "IH1": "AH0", "EH1": "IH0",
    "OW1": "AH0", "EY1": "AH0", "UW1": "AH0", "AO1": "AH0",
}

# Stress-determining suffixes (spelling pattern -> main-stress position as
# "Nth vowel counted from the END of the emitted phone string").  These are
# the classic Latinate stress rules every LTS needs: -tion/-sion/-cial/-ic
# stress the immediately preceding syllable, -ity/-ify/-ogy/-ical stress
# two syllables before, -ee/-eer/-esque attract stress themselves.
_SUFFIX_STRESS: List[Tuple[re.Pattern, int]] = [
    (re.compile(r"(ee|eer|eers|ese|esque|oon|oons|ette|aire|ique)$"), 1),
    (re.compile(r"([tsx]|ss|c|g)ions?$"), 2),
    (re.compile(r"cians?$"), 2),
    (re.compile(r"[cts]ials?$"), 2),
    (re.compile(r"[ct]ious$|geous$|xious$"), 2),
    (re.compile(r"i[ck]s?$|ic[ts]$"), 2),
    (re.compile(r"icals?$|ically$"), 3),
    (re.compile(r"it(y|ies)$"), 3),
    (re.compile(r"if(y|ies)$"), 3),
    (re.compile(r"og(y|ies)$|graph(y|ies)$|path(y|ies)$|om(y|ies)$"), 3),
    (re.compile(r"ious$|eous$"), 3),
    (re.compile(r"ituted?$|itutes?$"), 3),
    (re.compile(r"[a-z]ates?$|[a-z]ated$|[a-z]ating$"), 3),
]


def _main_stress_from_suffix(word: str, phones: List[str]) -> Optional[int]:
    """Phone index of the main-stress vowel dictated by a suffix class, or
    None when no class matches (the first-stress heuristic applies then)."""
    vowel_idx = [k for k, ph in enumerate(phones) if ph[-1:] in "012"]
    for pat, n_from_end in _SUFFIX_STRESS:
        if pat.search(word):
            if len(vowel_idx) >= n_from_end:
                return vowel_idx[-n_from_end]
            return None
    return None


def _reduce_unstressed(phones: List[str], word: str = "") -> List[str]:
    """Stress-aware vowel reduction post-pass.

    The table rules emit citation (stressed) vowel qualities everywhere;
    real English reduces short vowels in unstressed syllables to schwa
    (market -> M AA1 R K AH0 T).  When the word carries a stress-determining
    Latinate suffix (-tion, -ity, -ic, ... — _SUFFIX_STRESS), the main
    stress is placed by the suffix class and every other syllable reduces
    around it: post-stress short vowels -> AH0, pre-stress vowels -> the
    _PRE_REDUCE map, EXCEPT the word-initial syllable, which keeps full
    quality as a secondary stress when it is two or more syllables before
    the main one (ap-pli-CA-tion -> AE2, but con-NEC-tion -> AH0).

    Otherwise the legacy heuristic applies: the first rule-stressed vowel
    carries the word stress; later rule-stressed SHORT vowels reduce to
    AH0 (AO1+R -> ER0), except in a final syllable closed by 2+ consonants
    ("understand" keeps its final full vowel).  Vowels the rules already
    marked unstressed (digit 0 from suffix knowledge) are left alone."""
    vowel_idx = [
        k for k, ph in enumerate(phones) if ph[-1:] in "012"
    ]
    if len(vowel_idx) < 2:
        return phones
    out = list(phones)

    main = _main_stress_from_suffix(word, phones) if word else None
    if main is not None:
        main_n = vowel_idx.index(main)
        for n, k in enumerate(vowel_idx):
            ph = phones[k]
            if k == main:
                continue
            if not ph.endswith("1"):
                continue  # digits 0/2 already carry suffix knowledge
            if n < main_n:
                # initial syllable keeps full quality (secondary stress)
                # unless directly adjacent to the main stress
                if n == 0 and main_n - n >= 2:
                    continue
                if ph == "AO1" and k + 1 < len(phones) and phones[k + 1] == "R":
                    if n == 0:
                        continue  # or-/ar- onsets keep the r-colored vowel
                    out[k] = "ER0"  # infORmation -> ER0 (non-initial)
                    out[k + 1] = None
                    continue
                if n == 0 and ph in ("IH1", "UW1", "UH1"):
                    # in-/nu- initial syllables keep quality even when
                    # adjacent to the stress (infection, nutrition)
                    out[k] = ph[:-1] + "0"
                    continue
                repl = _PRE_REDUCE.get(ph)
                if repl:
                    out[k] = repl
            else:
                if ph == "AO1" and k + 1 < len(phones) and phones[k + 1] == "R":
                    out[k] = "ER0"
                    out[k + 1] = None
                elif ph in _REDUCIBLE:
                    out[k] = _REDUCIBLE[ph]
        # -ity as a SUFFIX reads AH0 T IY0 (ability, quality) — the bare
        # "ity$" table rule keeps IH0 so monosyllabic stems ("city") stay
        # IH; only the class-matched polysyllables get the schwa.
        if word.endswith(("ity", "ities")) and len(vowel_idx) >= 2:
            k2 = vowel_idx[-2]
            if out[k2] == "IH0":
                out[k2] = "AH0"
        return [p for p in out if p is not None]

    seen_stress = False
    for n, k in enumerate(vowel_idx):
        ph = phones[k]
        if not ph.endswith("1"):
            continue
        if not seen_stress:
            seen_stress = True
            continue
        is_last = n == len(vowel_idx) - 1
        coda = len(phones) - k - 1 if is_last else 0
        if is_last and coda >= _KEEP_FINAL_GUARD:
            continue
        if ph == "AO1" and k + 1 < len(phones) and phones[k + 1] == "R":
            out[k] = "ER0"
            out[k + 1] = None
        elif ph in _REDUCIBLE:
            out[k] = _REDUCIBLE[ph]
    return [p for p in out if p is not None]


def letter_to_sound(word: str) -> List[str]:
    """Grapheme -> ARPAbet with unstressed-vowel reduction (see
    _reduce_unstressed; core rules in _lts_core)."""
    word = word.lower()
    return _reduce_unstressed(_lts_core(word), word)


# The DH/TH split on word-initial "th" is purely lexical: English voices
# initial th ONLY in the closed class of function words (determiners,
# pronouns, th-adverbs) — a finite, linguistically-fixed set every
# rule-based LTS hardcodes (content words: thing, think, three -> TH).
_TH_FUNCTION = frozenset(
    "the this that these those they them then than thus though there "
    "their theirs therefore themselves thee thy thine".split()
)


def _lts_core(word: str) -> List[str]:
    """Rule-based grapheme -> ARPAbet for out-of-lexicon words.

    Longest-match left-to-right with a handful of context rules (soft c,
    magic e, y as consonant/vowel).  Accuracy on held-out lexicon words is
    measured by tests/test_english.py (55.3% word-exact / 17.1% phoneme
    error rate on the 1,583-word held-out lexicon, 2026-08-17) — rough but
    consistent, which is the serving contract for true OOVs."""
    word = word.lower()
    if word == "i":
        return ["AY1"]
    if word in _TH_FUNCTION:
        rest = _lts_core("d" + word[2:])[1:]  # vowel/coda via normal rules
        if word == "the":
            return ["DH", "AH0"]
        return ["DH"] + rest
    # closed-class s-final function words voice to /z/
    _S_FUNCTION = {
        "as": ["AE1", "Z"], "is": ["IH1", "Z"],
        "his": ["HH", "IH1", "Z"], "has": ["HH", "AE1", "Z"],
    }
    if word in _S_FUNCTION:
        return list(_S_FUNCTION[word])
    # stress-neutral derivational suffixes peel off and the stem is read on
    # its own (bare+ly, grate+ful, state+ment) — the silent-e/magic-e rules
    # then see the stem's true word edge
    for suf, tail in (
        ("ly", ["L", "IY0"]),
        ("ful", ["F", "AH0", "L"]),
        ("ness", ["N", "AH0", "S"]),
        ("ment", ["M", "AH0", "N", "T"]),
    ):
        if (
            word.endswith(suf) and len(word) - len(suf) >= 4
            and any(c in "aeiouy" for c in word[: -len(suf)])
        ):
            stem = word[: -len(suf)]
            if suf == "ly" and stem.endswith("al"):
                # -ally reads AH0 L IY0 (finally, usually): peel -al too
                return _lts_core(stem[:-2]) + ["AH0", "L", "IY0"]
            return _lts_core(stem) + tail
    # -iage is the IH0 JH suffix with silent i (marriage, carriage)
    if len(word) > 5 and word.endswith("iage"):
        return _lts_core(word[:-4]) + ["IH0", "JH"]
    # polysyllabic -age is the unstressed IH0 JH suffix (village, message,
    # language) — peel it BEFORE magic-e rewrites "age" into long-a "aig"
    if (
        len(word) > 4 and word.endswith("age")
        and any(c in "aeiouy" for c in word[:-3])
    ):  # vowel-less stems ("stage") are monosyllables, not -age suffixes
        return _lts_core(word[:-3]) + ["IH0", "JH"]
    # -ture/-sure/-ure read CH ER / ZH ER / (Y) ER (structure, pleasure,
    # injure, figure) — peel before magic-e rewrites "ure" into long-u;
    # "-easure" first so its EH vowel survives (treasure, measure)
    if len(word) > 6 and word.endswith("easure"):
        return _lts_core(word[:-6]) + ["EH1", "ZH", "ER0"]
    if len(word) > 4 and word.endswith("ture"):
        stem = word[:-4]
        if stem[-1] in "aeiou" and len(stem) <= 3:
            # open monosyllabic stem reads long: nature -> N EY CH ER
            return (
                _lts_core(stem[:-1] + _LONG_VOWEL.get(stem[-1], stem[-1]))
                + ["CH", "ER0"]
            )
        return _lts_core(stem) + ["CH", "ER0"]
    if len(word) > 4 and word.endswith("sure"):
        return _lts_core(word[:-4]) + ["ZH", "ER0"]
    if len(word) > 5 and word.endswith("ure"):
        stem = word[:-3]
        glide = ["Y"] if stem[-1] in "gl" else []
        return _lts_core(stem) + glide + ["ER0"]
    # the stress-class gate must see the ORIGINAL spelling: magic-e below
    # rewrites "-ate" into "-ait" etc., which would hide the suffix class
    latinate = any(pat.search(word) for pat, _ in _SUFFIX_STRESS)
    if len(word) <= 5:
        word = _MAGIC_CE.sub(lambda m: _LONG_VOWEL[m.group(1)] + "s", word)
    word = _MAGIC_E.sub(lambda m: _LONG_VOWEL[m.group(1)] + m.group(2), word)
    word = _MAGIC_E_SUFFIX.sub(
        lambda m: _LONG_VOWEL[m.group(1)] + m.group(2) + m.group(3), word
    )
    out: List[str] = []
    i = 0
    # Words with a stress-determining Latinate suffix skip the unstressed-
    # prefix rewrites below: _reduce_unstressed places the main stress from
    # the suffix class and decides which earlier syllables reduce (keeping
    # the word-initial secondary stress of ap-pli-CA-tion) — the gate was
    # computed above, before the magic-e rewrites.
    # pronoun compounds: any-/every-/some- + one/body/thing/where/time(s)
    # (the "one" half reads W AH N only in these compounds)
    _COMPOUND_TAILS = {
        "one": ["W", "AH1", "N"], "body": ["B", "AA2", "D", "IY0"],
        "thing": ["TH", "IH2", "NG"], "where": ["W", "EH2", "R"],
        "time": ["T", "AY2", "M"], "times": ["T", "AY2", "M", "Z"],
        "how": ["HH", "AW2"], "way": ["W", "EY2"], "what": ["W", "AH2", "T"],
    }
    for pre in ("any", "every", "some"):
        if word.startswith(pre) and word[len(pre):] in _COMPOUND_TAILS:
            return _lts_core(pre) + _COMPOUND_TAILS[word[len(pre):]]
    if word.startswith("any"):
        return ["EH1", "N", "IY0"] + (_lts_core(word[3:]) if word[3:] else [])
    # word-initial "isl" keeps its silent s (island, isle); mid-word "isl"
    # is an ordinary cluster (legislation)
    if word.startswith("isl"):
        out.extend(["AY1", "L"])
        i = 3
    # unstressed initial a- before one consonant + vowel ("about", "again")
    # or a doubled consonant ("attack", "address"); true clusters
    # ("after") keep AE, and so do most 3+-syllable a- nouns (animal,
    # avenue, accident, attitude — initial stress), so the reduction only
    # applies to disyllables
    stem_nosilent = (
        word[:-1]
        if word.endswith("e") and len(word) > 2 and word[-2] not in "aeiouy"
        else word
    )
    n_vowel_groups = len(re.findall(r"[aeiouy]+", stem_nosilent))
    if (
        not latinate and i == 0
        and len(word) >= 4 and word[0] == "a"
        and word[1] not in "aeiouy"
        and n_vowel_groups == 2
        and (word[2] in "aeiou" or (word[1] == word[2] and len(word) >= 5))
    ):
        out.append("AH0")
        i = 1
    # unstressed initial e- in disyllables: before x (except, exchange),
    # a doubled consonant (effect), or a single consonant + vowel (elect,
    # emerge, elite); "ev-" stays (even, evil — CMU keeps IY1 V there),
    # exa-/exi- keep their dedicated /gz/-voicing rule, and the noun class
    # exit/expert/extra keeps initial stress
    elif (
        not latinate and i == 0
        and len(word) >= 5 and word[0] == "e"
        and word[1] not in "aeiouy" and word[1] != "v"
        and n_vowel_groups == 2
        and not word.startswith(("exa", "exi"))
        and word not in ("exit", "expert", "extra", "excess", "experts")
        and (
            word[1] == "x"
            or word[1] == word[2]
            or word[2] in "aeiouy"
        )
    ):
        out.append("IH0")
        i = 2 if word[1] == word[2] else 1
    # unstressed initial ad- before a consonant in disyllabic verbs
    # (admit, advance, advice); longer ad- words keep initial stress
    elif (
        not latinate and i == 0
        and len(word) >= 5 and word[:2] == "ad"
        and word[2] not in "aeiouy" and word[2] != "d"
        and n_vowel_groups == 2
    ):
        out.extend(["AH0", "D"])
        i = 2
    # unstressed be-/de-/re-/pre- prefixes before a consonant (or
    # consonant+liquid cluster) + vowel ("begin", "decide", "degree",
    # "reply", "prepare"); doubles ("better") keep full vowels
    if (
        not latinate and i == 0
        and len(word) >= 6 and word[:3] == "pre"
        and word[3] not in "aeiouy"
        and (
            word[4] in "aeiouy"
            or (word[4] in "lr" and len(word) > 5 and word[5] in "aeiouy")
        )
    ):
        out.extend(["P", "R", "IH0"])
        i = 3
    elif (
        not latinate and i == 0
        and len(word) >= 7 and word[:3] in ("com", "con")
        and word[3] not in "aeiouy" and word[3] != word[2]
        and not word.startswith(("concept", "concert", "contest", "context",
                                 "contract", "contrast", "contact", "content",
                                 "constant", "concrete", "combat"))
        and not re.search(r"(ence|ent|ance|ant)s?$", word)
    ):
        # noun-stressed con- compounds (concept, contact, contrast) and
        # -ence/-ent nominals (conference, continent) keep initial stress;
        # the open verb class (combine, compare, concern, connect) reduces
        # unstressed com-/con- before a consonant in longer words
        # (computer, continue, condition); shorter ones (common, comment,
        # concert) and doubles (connect is the exception) keep stress
        out.extend(["K", "AH0", "M" if word[2] == "m" else "N"])
        i = 3
    elif (
        not latinate and i == 0
        and len(word) >= 5 and word[:2] in ("be", "de", "re")
        and word[2] not in "aeiouy"
        and (
            word[3] in "aeiouy"
            or (word[3] in "lr" and len(word) > 4 and word[4] in "aeiouy")
            or (word[2] == "s" and word[3] not in "aeiouy")
        )
        and word[2] != word[3]
    ):
        out.append({"b": "B", "d": "D", "r": "R"}[word[0]])
        out.append("IH0")
        i = 2
    while i < len(word):
        # short function-like words ending in open e read long: we, he, be
        if i + 1 == len(word) and word[i] == "e" and len(word) <= 3:
            out.append("IY1")
            i += 1
            continue
        # unstressed final syllables of polysyllables reduce to schwa:
        # garden -> AH N, level -> AH L, different -> AH N T
        if i >= 3:
            suf = next(
                (s for s, _ in _FINAL_SCHWA
                 if word.startswith(s, i) and i + len(s) == len(word)),
                None,
            )
            if suf is not None:
                out.extend(dict(_FINAL_SCHWA)[suf])
                break
        # suffix -ed: voicing assimilates to the stem's last letter
        # (walked -> T, loved -> D, needed -> IH0 D); "red"/"bed" (i < 2)
        # are stems, not suffixed forms
        if i >= 2 and i + 2 == len(word) and word.startswith("ed", i):
            prev = word[i - 1]
            if prev in "td":
                out.extend(["IH0", "D"])
            elif prev in "pkfshxc":
                out.append("T")
            else:
                out.append("D")
            break
        # suffix -es: epenthetic after sibilant spellings (boxes, churches),
        # plain /z/ otherwise (goes, shoes); "yes" (i < 2) is a stem
        if i >= 2 and i + 2 == len(word) and word.startswith("es", i):
            if word[i - 1] in "sxzhcg":
                out.extend(["IH0", "Z"])
            else:
                out.append("Z")
            break
        # non-initial "ther" is voiced (mother, other, weather, northern);
        # word-initial keeps TH (therapy, thermal)
        if i > 0 and word.startswith("ther", i):
            out.extend(["DH", "ER0"])
            i += 4
            continue
        # intervocalic single "s" is usually voiced (music, reason, visit,
        # easy); doubles ("ss") stay /s/, and a final silent e doesn't
        # count as a following vowel ("choose" -> the -se$ rules)
        if (
            word[i] == "s" and 0 < i < len(word) - 1
            and word[i - 1] in "aeiouy" and word[i + 1] in "aeiouy"
            and not word.startswith("ss", i)
            and not (i + 2 == len(word) and word[i + 1] == "e")
            and not word.startswith("sion", i)
            and not word.startswith("sid", i)
        ):
            out.append("Z")
            i += 1
            continue
        # "sc" before e/i/y is plain /s/ (science, scene, scissors) — must
        # outrank the "sc" -> S K digraph
        if (
            word.startswith("sc", i) and i + 2 < len(word)
            and word[i + 2] in "eiy"
            and not word.startswith("science", i)
        ):
            out.append("S")
            i += 2
            continue
        # word-initial gn: silent g (gnome); mid-word handled as G N
        if i == 0 and word.startswith("gn"):
            out.append("N")
            i += 2
            continue
        # soft g: "ge/gi/gy" reads JH (gene, giant, gym, general) except in
        # the Germanic core (get, give, girl, gift, gear, geese) and the
        # agentive/comparative "-ger" of tiger/eager (danger/stranger take
        # the dedicated "anger" rule above)
        if (
            word[i] == "g" and i + 1 < len(word) and word[i + 1] in "eiy"
            and not word.startswith(("get", "giv", "gif", "gir", "gea",
                                     "gee", "gig", "gild", "gey"), i)
            and word[i:] not in ("ger", "gers")
        ):
            out.append("JH")
            i += 1
            continue
        # "ng" + liquid keeps the hard g (single, angry, england)
        if (
            word.startswith("ng", i) and i + 2 < len(word)
            and word[i + 2] in "lr"
        ):
            out.extend(["NG", "G"])
            i += 2
            continue
        # word-initial exa-/exi- voices to /gz/ (exact, example, exist)
        if i == 0 and (word.startswith("exa") or word.startswith("exi")):
            out.extend(["IH0", "G", "Z"])
            i = 2
            continue
        # open-syllable "u" after labials/velars keeps the glide: music,
        # human, computer; before "r" the vowel is lax (security, curious);
        # word-final "-use" keeps its own voicing rule
        if (
            word[i] == "u" and i + 2 < len(word)
            and (i == 0 or word[i - 1] in "mhcfgp")
            and word[i + 1] not in "aeiouy" and word[i + 2] in "aeiouy"
            and not (word.startswith("use", i) and i + 3 == len(word))
            and not word.startswith("ular", i)
        ):
            out.extend(["Y", "UH1"] if word[i + 1] == "r" else ["Y", "UW1"])
            i += 1
            continue
        # "ue" after a non-coronal onset keeps the glide: cube/dispute
        # (via their magic-e rewrites "cueb"/"disputet"), rescue, value;
        # after l/n the glide needs a preceding vowel (volume, continue)
        # so onset clusters stay plain (blue, clue, glue)
        if word.startswith("ue", i) and i > 0 and (
            word[i - 1] in "bcfghkmpv"
            or (word[i - 1] in "ln" and i >= 2 and word[i - 2] in "aeiouy")
        ):
            out.extend(["Y", "UW1"])
            i += 2
            continue
        # "ur" + vowel is lax UH R (during, jury), not the ER of "turn"
        if (
            word[i] == "u" and i + 2 < len(word) and word[i + 1] == "r"
            and word[i + 2] in "aeiouy"
        ):
            out.append("UH1")
            i += 1
            continue
        # silent u after g before i/e/y: guide, guitar, guest, guy
        if (
            word[i] == "g" and i + 2 < len(word) and word[i + 1] == "u"
            and word[i + 2] in "iey"
        ):
            out.append("G")
            i += 2
            continue
        # non-initial "-anger" is the soft nasal of danger/stranger;
        # "anger" itself (i == 0) keeps the hard g
        if i > 0 and word.startswith("anger", i) and i + 5 == len(word):
            out.extend(["EY1", "N", "JH", "ER0"])
            break
        # word-final single "e" after a consonant is silent once the word
        # already has a vowel (maybe -> M EY B, owe -> OW)
        if (
            i + 1 == len(word) and word[i] == "e"
            and any(p[-1:] in "012" for p in out)
        ):
            break
        # open-syllable "u" after coronals is plain UW (duty, student,
        # stupid, super — American English drops the glide there)
        if (
            word[i] == "u" and i + 2 < len(word)
            and i > 0 and word[i - 1] in "dtsnlrz"
            and word[i + 1] not in "aeiouyr" and word[i + 2] in "aeiouy"
            and not (word.startswith("use", i) and i + 3 == len(word))
        ):
            out.append("UW1")
            i += 1
            continue
        # "ngu" + vowel keeps hard g + glide: language, penguin, linguist
        if word.startswith("ngu", i) and (
            i + 3 == len(word) or word[i + 3] in "aeiouy"
        ):
            out.extend(["NG", "G", "W"])
            i += 3
            continue
        # "cc" before e/i reads /ks/: success, accept, accident
        if (
            word.startswith("cc", i) and i + 2 < len(word)
            and word[i + 2] in "eiy"
        ):
            out.extend(["K", "S"])
            i += 2
            continue
        # "s" voices before voiced stops/nasals after a vowel: wisdom,
        # husband
        if (
            word[i] == "s" and 0 < i < len(word) - 1
            and word[i - 1] in "aeiouy" and word[i + 1] in "dbm"
        ):
            out.append("Z")
            i += 1
            continue
        # "s" + u + vowel palatalizes after a vowel: usual, casual, visual
        if (
            word[i] == "s" and 0 < i < len(word) - 2
            and word[i - 1] in "aeiouy" and word[i + 1] == "u"
            and word[i + 2] in "aeiou"
        ):
            out.append("ZH")
            i += 1
            continue
        # unstressed final -al/-ol/-il of polysyllables reduces (animal,
        # symbol, pencil); monosyllables ("pal", "oil") keep full vowels
        if (
            i >= 2 and i + 2 == len(word)
            and word[i] in "aoi" and word[i + 1] == "l"
            and word[i - 1] not in "aeio"
        ):
            out.extend(["AH0", "L"])
            break
        # "ear" + consonant is the ER of "earth"/"learn", not the IH R of
        # "ear"/"near"
        if word.startswith("ear", i) and i + 3 < len(word)                 and word[i + 3] not in "aeiouy":
            out.append("ER1")
            i += 3
            continue
        # soft c: "ce/ci/cy" -> S; a word-final "ce" is just /s/ (the e
        # is silent — "chance", "force"), so consume both letters; leave
        # "-ceive" to its dedicated rule (receive, perceive)
        if (
            word[i] == "c" and i + 1 < len(word) and word[i + 1] in "eiy"
            and not (word.startswith("ceive", i) and i + 5 == len(word))
            and not word.startswith(("cial", "cious", "cian", "cient"), i)
        ):
            out.append("S")
            i += 2 if i + 2 == len(word) and word[i + 1] == "e" else 1
            continue
        # unstressed final -or / -ar ("doctor", "dollar") reduce to ER;
        # monosyllables ("for", "car") keep the full vowel
        if i >= 3 and i + 2 == len(word) and word[i:] in ("or", "ar"):
            out.append("ER0")
            i += 2
            continue
        # a final lone s voices to /z/ after a voiced consonant ("birds");
        # vowel-s stays /s/ — it is usually a rewritten silent-e spelling
        # ("face" -> fais) or a lexicon-covered function word
        if (
            i + 1 == len(word) and word[i] == "s" and i > 0
            and word[i - 1] in "bdglmnrvw"
        ):
            out.append("Z")
            i += 1
            continue
        # y: consonant at word/syllable start, vowel elsewhere
        if word[i] == "y":
            if i == 0:
                out.append("Y")
            elif i == len(word) - 1:
                out.append("AY1" if len(word) <= 3 else "IY0")
            else:
                out.append("IH0")
            i += 1
            continue
        for pat, phones in _RULES:
            anchored = pat.endswith("$")
            p = pat[:-1] if anchored else pat
            if word.startswith(p, i) and (not anchored or i + len(p) == len(word)):
                out.extend(phones.split())
                i += len(p)
                break
        else:
            i += 1  # unknown character: skip
    return out


def word_to_phonemes(word: str) -> List[str]:
    """Lexicon -> morphology -> letter-to-sound, first hit wins."""
    low = word.lower()
    phones = _LEXICON.get(low)
    if phones is not None:
        return [f"@{p}" for p in phones.split()]
    derived = _inflected_phones(low)
    if derived is not None:
        return [f"@{p}" for p in derived]
    return [f"@{p}" for p in letter_to_sound(word)]


_PUNCT = frozenset(string.punctuation)


def english_phonemize(
    text: Union[str, Sequence[str]],
    is_training: bool = True,
) -> Tuple[List[str], List[int]]:
    """English text -> (@PH phoneme list, per-word boundary counts).

    Mirrors the VN ``phonemize`` conventions (g2p.py:188-251): trailing
    period appended, punctuation -> <SILENT> / sentence-final </S>,
    uppercased output."""
    words = list(text.split()) if isinstance(text, str) else list(text)
    if not words:
        words = ["."]
    if words[-1] not in _PUNCT:
        words.append(".")
    phonemes: List[str] = []
    boundaries: List[int] = []
    last = len(words) - 1
    for i, word in enumerate(words):
        if all(ch in _PUNCT for ch in word):
            seq = [EOS] if i == last else [SILENT]
        else:
            seq = word_to_phonemes(word.strip(string.punctuation) or word)
            if not seq:
                seq = [SILENT]
        phonemes.extend(seq)
        boundaries.append(len(seq))
    return [p.upper() for p in phonemes], boundaries


def english_to_sequence(text: str, return_boundary: bool = False):
    """English text -> ids in the extended (VN+CMU) symbol table."""
    from .sequence import phonemes_to_sequence

    phonemes, boundaries = english_phonemize(text.lower())
    seq = phonemes_to_sequence(phonemes, table=ENGLISH_SYMBOL_TO_ID, strict=False)
    if return_boundary:
        return seq, boundaries
    return seq
