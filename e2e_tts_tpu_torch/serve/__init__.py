from .audio_post import audio_speed_change, change_speed_array
from .bundle import load_bundle
from .chunking import arrange_text
from .engine import SynthesisEngine
from .inference import Synthesizer
from .queue import BatchingServer
from .streaming import StreamingVocoder, stream_synthesize
