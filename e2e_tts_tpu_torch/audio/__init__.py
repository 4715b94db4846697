from .features import beta_binomial_prior
from .filters import hann_window, mel_filterbank
from .mel import (
    MelParams,
    dynamic_range_compression,
    dynamic_range_decompression,
    inverse_stft,
    mel_spectrogram,
    num_frames,
    stft_magnitude,
)
from .wav import MAX_WAV_VALUE, float_to_int16, read_wav, write_wav
