from .acoustic import FastSpeech2
from .blocks import build_decoder, build_encoder
from .vocoder import build_generator, fuse_generator, fuse_weight_norm, istft_to_audio, vocode
