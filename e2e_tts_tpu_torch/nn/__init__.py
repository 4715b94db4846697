from .common import Conv1d, ConvTranspose1d, LayerNorm, sinusoid_table, t2t_sinusoid
from .hifigan import HifiGanGenerator, IstftNetGenerator, ResBlock1, ResBlock2
from .postnet import Postnet
from .transformer import FFTBlock, TransformerDecoder, TransformerEncoder
from .variance import DurationPredictor, FeatureStats, VarianceAdaptor, VariancePredictor
