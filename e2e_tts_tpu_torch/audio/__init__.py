from .features import (
    ac_f0,
    beta_binomial_prior,
    dio_f0,
    extract_f0,
    extract_pitch,
    f0_to_coarse,
    remove_outliers,
    stonemask,
    yin_f0,
)
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
