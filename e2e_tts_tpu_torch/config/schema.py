"""Typed configuration schema.

The reference merges three YAML files into a ``{"audio", "models", "train"}``
dict at load time (reference: e2e_tts/src/tools/tools_for_model.py:14-20) and
threads raw dicts through every constructor.  Here the same logical schema is
expressed as frozen dataclasses so that configs hash cleanly (they key jit
caches) and typos fail loudly at load time instead of deep inside a model.

Defaults reproduce the reference's shipped configuration
(e2e_tts/config/{model,train,preprocessing}_config.yaml).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _freeze(x):
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


class _Base:
    """from_dict/to_dict plumbing shared by every config dataclass."""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "_Base":
        if d is None:
            return cls()
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            sub = _SUBTYPES.get((cls.__name__, f.name))
            if sub is not None and isinstance(v, dict):
                v = sub.from_dict(v)
            else:
                v = _freeze(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, _Base):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = [list(x) if isinstance(x, tuple) else x for x in v]
            out[f.name] = v
        return out

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# audio  (reference: preprocessing_config.yaml)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SignalConfig(_Base):
    sampling_rate: int = 22050
    max_wav_value: float = 32768.0
    segment_length: int = 32768


@dataclass(frozen=True)
class StftConfig(_Base):
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    window: str = "hann"


@dataclass(frozen=True)
class MelConfig(_Base):
    channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = 8000.0
    mel_fmax_loss: Optional[float] = 8000.0


@dataclass(frozen=True)
class AudioConfig(_Base):
    signal: SignalConfig = field(default_factory=SignalConfig)
    stft: StftConfig = field(default_factory=StftConfig)
    mel: MelConfig = field(default_factory=MelConfig)

    @property
    def frames_per_second(self) -> float:
        return self.signal.sampling_rate / self.stft.hop_length


# ---------------------------------------------------------------------------
# models  (reference: model_config.yaml)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TransformerBlockConfig(_Base):
    encoder_head: int = 2
    decoder_head: int = 2
    conv_filter_size: int = 1024
    conv_kernel_size: Tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.1
    decoder_dropout: float = 0.1


@dataclass(frozen=True)
class ConformerBlockConfig(_Base):
    encoder_head: int = 8
    decoder_head: int = 8
    ffn_expansion_factor: int = 4
    conv_kernel_size: int = 31
    conv_expansion_factor: int = 2
    half_step_residual: bool = True
    encoder_dropout: float = 0.1
    decoder_dropout: float = 0.1
    # False reproduces the reference conformer exactly (its blocks never
    # mask attention — conformer.py:215-256); required when migrating
    # reference-trained conformer checkpoints.  True = proper key masking.
    mask_attention: bool = True


@dataclass(frozen=True)
class FastformerBlockConfig(_Base):
    encoder_head: int = 2
    decoder_head: int = 2
    conv_filter_size: int = 1024
    conv_kernel_size: Tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2
    # True reproduces the reference fastformer exactly for checkpoint
    # migration: its FastAttention inverts the head semantics (it runs
    # hidden//encoder_head heads of size encoder_head — fastformer.py:
    # 190-196), and its encoder/decoder never zero padded rows before
    # block 0.  False (default) = the sane Wu et al. reading:
    # encoder_head heads, padded input zeroed.
    reference_compat: bool = False


@dataclass(frozen=True)
class LSTransformerBlockConfig(_Base):
    encoder_head: int = 2
    decoder_head: int = 2
    conv_filter_size: int = 1024
    conv_kernel_size: Tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2
    window_size: int = 128
    r: int = 32
    # True reproduces the reference lstransformer for checkpoint migration:
    # r forced to 1 (its FFTBlock hardcodes the causal default,
    # lstransformer.py:154-156), interleaved rotary pairs (the
    # rotary-embedding-torch layout it imports), and no pre-zero of padded
    # rows before block 0.
    reference_compat: bool = False


@dataclass(frozen=True)
class ReformerBlockConfig(_Base):
    encoder_head: int = 8
    decoder_head: int = 8
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2
    bucket_size: int = 64
    n_hashes: int = 4


@dataclass(frozen=True)
class BuildingBlockConfig(_Base):
    block_type: str = "transformer"
    transformer: TransformerBlockConfig = field(default_factory=TransformerBlockConfig)
    conformer: ConformerBlockConfig = field(default_factory=ConformerBlockConfig)
    fastformer: FastformerBlockConfig = field(default_factory=FastformerBlockConfig)
    lstransformer: LSTransformerBlockConfig = field(default_factory=LSTransformerBlockConfig)
    reformer: ReformerBlockConfig = field(default_factory=ReformerBlockConfig)

    def active(self):
        return getattr(self, self.block_type)


@dataclass(frozen=True)
class DurationModellingConfig(_Base):
    learn_alignment: bool = True
    aligner_temperature: float = 0.0005
    binarization_start_steps: int = 6000


@dataclass(frozen=True)
class VariancePredictorConfig(_Base):
    predictor_grad: float = 0.1
    filter_size: int = 256
    kernel_size: int = 3
    dropout: float = 0.5
    dur_predictor_layers: int = 2
    dur_predictor_kernel: int = 3
    pit_predictor_layers: int = 2
    pit_predictor_kernel: int = 5
    ener_predictor_layers: int = 2
    ener_predictor_kernel: int = 5
    ffn_padding: str = "SAME"
    ffn_act: str = "gelu"


@dataclass(frozen=True)
class VarianceEmbeddingConfig(_Base):
    use_uv: bool = True
    n_bins: int = 256
    pitch_feature: str = "phoneme_level"
    pitch_quantization: str = "linear"
    energy_feature: str = "phoneme_level"
    energy_quantization: str = "linear"
    f0_bins: int = 300


@dataclass(frozen=True)
class VarianceConfig(_Base):
    duration_modelling: DurationModellingConfig = field(default_factory=DurationModellingConfig)
    variance_predictor: VariancePredictorConfig = field(default_factory=VariancePredictorConfig)
    variance_embedding: VarianceEmbeddingConfig = field(default_factory=VarianceEmbeddingConfig)


@dataclass(frozen=True)
class PostnetConfig(_Base):
    embedding_dim: int = 512
    conv_layers: int = 5
    kernel_size: int = 5


@dataclass(frozen=True)
class FastSpeech2Config(_Base):
    max_seq_len: int = 1000
    encoder_layers: int = 6
    encoder_hidden: int = 384
    decoder_layers: int = 6
    decoder_hidden: int = 384
    # rematerialize encoder/decoder layer activations in the backward pass
    # (jax.checkpoint per layer): trades recompute FLOPs for HBM, enabling
    # larger batches/sequences.  The reformer family always remats (its LSH
    # design assumes it); the other four families honor this flag.
    remat_blocks: bool = False
    building_block: BuildingBlockConfig = field(default_factory=BuildingBlockConfig)
    variance: VarianceConfig = field(default_factory=VarianceConfig)
    postnet: PostnetConfig = field(default_factory=PostnetConfig)


@dataclass(frozen=True)
class HifiGanConfig(_Base):
    resblock: int = 1
    num_freq: int = 1025
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


@dataclass(frozen=True)
class IstftNetConfig(_Base):
    resblock: int = 1
    gen_istft_n_fft: int = 16
    gen_istft_hop_size: int = 4
    gen_istft_win_size: int = 16
    upsample_rates: Tuple[int, ...] = (8, 8)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


@dataclass(frozen=True)
class ModelsConfig(_Base):
    fastspeech2: FastSpeech2Config = field(default_factory=FastSpeech2Config)
    hifigan: HifiGanConfig = field(default_factory=HifiGanConfig)
    istft: IstftNetConfig = field(default_factory=IstftNetConfig)


# ---------------------------------------------------------------------------
# train  (reference: train_config.yaml)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig(_Base):
    learning_rate: float = 0.001
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip_thresh: float = 1.0
    warm_up_step: int = 4000
    anneal_steps: Tuple[int, ...] = (300000, 400000, 500000)
    anneal_rate: float = 0.3


@dataclass(frozen=True)
class LossConfig(_Base):
    # per-granularity duration-loss weights (reference: train_config.yaml
    # dur_loss_lambda {pdur, wdur, sdur}), flattened so the config hashes
    pdur_lambda: float = 1.0
    wdur_lambda: float = 1.0
    sdur_lambda: float = 1.0
    binarization_loss_warmup_steps: int = 10000
    binarization_loss_enable_steps: int = 18000

    @classmethod
    def from_dict(cls, d):
        if d and "dur_loss_lambda" in d:
            d = dict(d)
            lam = d.pop("dur_loss_lambda")
            d.setdefault("pdur_lambda", lam.get("pdur", 1.0))
            d.setdefault("wdur_lambda", lam.get("wdur", 1.0))
            d.setdefault("sdur_lambda", lam.get("sdur", 1.0))
        return super().from_dict(d)


@dataclass(frozen=True)
class TrainConfig(_Base):
    seed: int = 1234
    batch_size: int = 32
    log_step: int = 100
    grad_acc_step: int = 1
    grad_clip_thresh: float = 1.0
    # bf16 compute with f32 master params/moments (flax casts per-op)
    mixed_precision: bool = False
    load_mel_from_disk: bool = True
    external_model: str = "fastspeech2"
    fastspeech2_loss: LossConfig = field(default_factory=LossConfig)
    fastspeech2_optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    hifigan_optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(
            learning_rate=0.0002, betas=(0.8, 0.99), weight_decay=0.999
        )
    )

    @classmethod
    def from_dict(cls, d):
        if d is None:
            return cls()
        d = dict(d)
        # Accept the reference's nested YAML layout:
        #   fastspeech2: {loss: ..., optimizer: ...}; hifigan: {optimizer: ...}
        fs2 = d.pop("fastspeech2", None)
        hg = d.pop("hifigan", None)
        if fs2:
            d.setdefault("fastspeech2_loss", fs2.get("loss"))
            d.setdefault("fastspeech2_optimizer", fs2.get("optimizer"))
        if hg:
            d.setdefault("hifigan_optimizer", hg.get("optimizer"))
        return super().from_dict(d)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config(_Base):
    audio: AudioConfig = field(default_factory=AudioConfig)
    models: ModelsConfig = field(default_factory=ModelsConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


_SUBTYPES = {
    ("AudioConfig", "signal"): SignalConfig,
    ("AudioConfig", "stft"): StftConfig,
    ("AudioConfig", "mel"): MelConfig,
    ("BuildingBlockConfig", "transformer"): TransformerBlockConfig,
    ("BuildingBlockConfig", "conformer"): ConformerBlockConfig,
    ("BuildingBlockConfig", "fastformer"): FastformerBlockConfig,
    ("BuildingBlockConfig", "lstransformer"): LSTransformerBlockConfig,
    ("BuildingBlockConfig", "reformer"): ReformerBlockConfig,
    ("VarianceConfig", "duration_modelling"): DurationModellingConfig,
    ("VarianceConfig", "variance_predictor"): VariancePredictorConfig,
    ("VarianceConfig", "variance_embedding"): VarianceEmbeddingConfig,
    ("FastSpeech2Config", "building_block"): BuildingBlockConfig,
    ("FastSpeech2Config", "variance"): VarianceConfig,
    ("FastSpeech2Config", "postnet"): PostnetConfig,
    ("ModelsConfig", "fastspeech2"): FastSpeech2Config,
    ("ModelsConfig", "hifigan"): HifiGanConfig,
    ("ModelsConfig", "istft"): IstftNetConfig,
    ("TrainConfig", "fastspeech2_loss"): LossConfig,
    ("TrainConfig", "fastspeech2_optimizer"): OptimizerConfig,
    ("TrainConfig", "hifigan_optimizer"): OptimizerConfig,
    ("Config", "audio"): AudioConfig,
    ("Config", "models"): ModelsConfig,
    ("Config", "train"): TrainConfig,
}


def default_config() -> Config:
    return Config()


def load_config(
    path_or_dir: str = None,
    model_config: str = None,
    train_config: str = None,
    preprocess_config: str = None,
) -> Config:
    """Load a config.

    Mirrors the reference's ``build_config`` three-file merge
    (tools_for_model.py:14-20) but also accepts a single bundled
    ``config.yaml`` (the deploy-bundle format written next to checkpoints,
    reference: src/api/utils.py:34).
    """
    import yaml  # imported here so that serving without a YAML file needs no pyyaml

    if path_or_dir is not None and os.path.isdir(path_or_dir):
        model_config = os.path.join(path_or_dir, "model_config.yaml")
        train_config = os.path.join(path_or_dir, "train_config.yaml")
        preprocess_config = os.path.join(path_or_dir, "preprocessing_config.yaml")
        path_or_dir = None

    if path_or_dir is not None:
        with open(path_or_dir) as f:
            d = yaml.safe_load(f)
        return Config.from_dict(d)

    def _load(p):
        if p is None:
            return {}
        with open(p) as f:
            return yaml.safe_load(f) or {}

    return Config.from_dict(
        {
            "audio": _load(preprocess_config),
            "models": _load(model_config),
            "train": _load(train_config),
        }
    )


def save_config(config: Config, path: str) -> None:
    """Write the bundled single-file config (deploy-bundle format)."""
    import yaml

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config.to_dict(), f, sort_keys=False)
