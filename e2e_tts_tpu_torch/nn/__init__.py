from .common import (Conv1d, ConvTranspose1d, LayerNorm, WNConv1d, WNConv2d, WNConvTranspose1d,
                     sinusoid_table, t2t_sinusoid)
from .discriminators import (MultiPeriodDiscriminator, MultiScaleDiscriminator,
                             build_discriminators, discriminator_loss, feature_loss,
                             generator_adv_loss)
from .hifigan import (HifiGanGenerator, IstftNetGenerator, ResBlock1, ResBlock2, TrainableHifiGan,
                      TrainableIstftNet, fuse_generator)
from .postnet import Postnet
from .transformer import FFTBlock, TransformerDecoder, TransformerEncoder
from .variance import DurationPredictor, FeatureStats, VarianceAdaptor, VariancePredictor
