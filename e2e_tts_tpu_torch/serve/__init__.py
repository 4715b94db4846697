from .bundle import load_bundle
from .chunking import arrange_text
from .engine import SynthesisEngine
