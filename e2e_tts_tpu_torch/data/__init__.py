"""Data preparation (port of ``e2e_tts_tpu/data``): file lists, the feature
cache, corpus statistics, datasets and bucketed batchers; ``synthetic``,
``audio_prep`` and ``mfa`` are imported by module."""

from .dataset import (
    AcousticDataset,
    Utterance,
    VocoderDataset,
    boundaries_to_word_ids,
    make_acoustic_batches,
    make_vocoder_batches,
    split_train_valid,
)
from .features import (
    compute_stats,
    create_utterance_features,
    load_utterance_features,
    utterance_paths,
)
from .filelist import (
    build_speaker_map,
    create_supervised_filelist,
    create_unsupervised_filelist,
    read_filelist,
)
