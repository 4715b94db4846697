"""Reference-checkpoint import (port of
``e2e_tts_tpu/compat/torch_import.py``).

Maps the reference's PyTorch ``state_dict`` layouts
(UnsupervisedFastSpeech2 / SupervisedFastSpeech2 and HifiGan/iSTFT; a
checkpoint file holds ``{"state_dict": ...}`` or the state dict itself)
onto the JAX package's variable trees, in NumPy, as its converter does
(``convert_acoustic``, ``convert_hifigan``); ``load_acoustic`` and
``load_vocoder`` build the port's models from such a tree through
``convert.load_into``, which raises unless every parameter and buffer is
assigned.  The reformer is not convertible: the reference draws fresh LSH
rotations on every forward pass.

Layout conventions converted:
- torch Linear weight (out, in)            -> flax Dense kernel (in, out)
- torch Conv1d weight (out, in, k)         -> NWC conv kernel (k, in, out)
- torch ConvTranspose1d weight (in, out, k)-> (k, in, out) (apply flips k)
- torch weight-norm (weight_g, weight_v)   -> fused w, stored as (v=w,
  g=||w||) so our normalize-in-apply reproduces w exactly
- torch BatchNorm1d weight/bias/running_*  -> scale/bias + batch_stats
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..convert import load_into
from ..device import resolve_device
from ..models.acoustic import FastSpeech2
from ..models.vocoder import build_generator
from ..nn.variance import FeatureStats


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().numpy() for k, v in sd.items()}


def _lin(sd, name):
    out = {"kernel": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _conv1d(sd, name):
    out = {"Conv_0": {"kernel": sd[f"{name}.weight"].transpose(2, 1, 0)}}
    if f"{name}.bias" in sd:
        out["Conv_0"]["bias"] = sd[f"{name}.bias"]
    return out


def _ln(sd, name):
    return {"LayerNorm_0": {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}}


def _ln_flat(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def convert_fft_layer(sd, prefix):
    """One reference FFTBlock (blocks/transformer.py:168-189)."""
    return {
        "slf_attn": {
            "w_q": _lin(sd, f"{prefix}.slf_attn.w_qs"),
            "w_k": _lin(sd, f"{prefix}.slf_attn.w_ks"),
            "w_v": _lin(sd, f"{prefix}.slf_attn.w_vs"),
            "fc": _lin(sd, f"{prefix}.slf_attn.fc"),
            "LayerNorm_0": _ln_flat(sd, f"{prefix}.slf_attn.layer_norm"),
        },
        "pos_ffn": {
            "w_1": _conv1d(sd, f"{prefix}.pos_ffn.w_1"),
            "w_2": _conv1d(sd, f"{prefix}.pos_ffn.w_2"),
            "LayerNorm_0": _ln_flat(sd, f"{prefix}.pos_ffn.layer_norm"),
        },
    }


def _pointwise_conv(sd, name):
    """Reference PointwiseConv1d (k=1 Conv1d wrapper, conformer.py:494-528)
    -> flax Dense."""
    w = sd[f"{name}.conv.weight"][:, :, 0].T  # (out, in, 1) -> (in, out)
    out = {"kernel": w}
    if f"{name}.conv.bias" in sd:
        out["bias"] = sd[f"{name}.conv.bias"]
    return out


def _conformer_ffn(sd, p):
    """Reference FeedForwardModule (conformer.py:273-305): Sequential
    LN(0) Linear(1) Swish Dropout Linear(4) Dropout."""
    return {
        "LayerNorm_0": _ln_flat(sd, f"{p}.sequential.0"),
        "Dense_0": _lin(sd, f"{p}.sequential.1.linear"),
        "Dense_1": _lin(sd, f"{p}.sequential.4.linear"),
    }


def convert_conformer_block(sd, prefix, d_model):
    """One reference ConformerBlock (conformer.py:171-256): Sequential of
    residual-wrapped [FFN, MHSA, Conv, FFN] + final LN.  Returns
    (params, batch_stats) — the conv module carries a BatchNorm."""
    a = f"{prefix}.sequential.1.module"
    c = f"{prefix}.sequential.2.module.sequential"
    zeros = np.zeros((d_model,), np.float32)

    def _proj(name, bias):
        out = {"kernel": sd[f"{a}.attention.{name}.linear.weight"].T}
        if bias:
            # reference LinearNorm defaults to bias=False for q/k/v/out;
            # our Dense has a bias param — zero reproduces the math
            out["bias"] = zeros
        return out

    params = {
        "ff1": _conformer_ffn(sd, f"{prefix}.sequential.0.module"),
        "mhsa_norm": _ln_flat(sd, f"{a}.layer_norm"),
        "mhsa": {
            "query_proj": _proj("query_proj", True),
            "key_proj": _proj("key_proj", True),
            "value_proj": _proj("value_proj", True),
            "pos_proj": _proj("pos_proj", False),
            "out_proj": _proj("out_proj", True),
            "u_bias": sd[f"{a}.attention.u_bias"],
            "v_bias": sd[f"{a}.attention.v_bias"],
        },
        "conv": {
            "LayerNorm_0": _ln_flat(sd, f"{c}.0"),
            "pw1": _pointwise_conv(sd, f"{c}.2"),
            "depthwise": {"kernel": sd[f"{c}.4.conv.weight"].transpose(2, 1, 0)},
            "BatchNorm_0": {
                "scale": sd[f"{c}.5.weight"],
                "bias": sd[f"{c}.5.bias"],
            },
            "pw2": _pointwise_conv(sd, f"{c}.7"),
        },
        "ff2": _conformer_ffn(sd, f"{prefix}.sequential.3.module"),
        "final_norm": _ln_flat(sd, f"{prefix}.sequential.4"),
    }
    batch_stats = {
        "conv": {
            "BatchNorm_0": {
                "mean": sd[f"{c}.5.running_mean"],
                "var": sd[f"{c}.5.running_var"],
            }
        }
    }
    return params, batch_stats


def convert_fastformer_stack(sd, prefix, n_layers):
    """Reference fastformer FFTBlock (fastformer.py:146-175): per layer a
    PreNorm(FastAttention) + PreNorm(conv FFN); the q/k pooling logits are
    weight-tied across layers (read once from layer 0)."""
    stack = {
        "to_q_attn_logits": _lin(sd, f"{prefix}.layers.0.0.fn.to_q_attn_logits"),
        "to_k_attn_logits": _lin(sd, f"{prefix}.layers.0.0.fn.to_k_attn_logits"),
    }
    for i in range(n_layers):
        a = f"{prefix}.layers.{i}.0"
        f = f"{prefix}.layers.{i}.1"
        stack[f"attn_norm_{i}"] = _ln_flat(sd, f"{a}.norm")
        stack[f"ff_norm_{i}"] = _ln_flat(sd, f"{f}.norm")
        stack[f"attn_{i}"] = {
            "query": _lin(sd, f"{a}.fn.query"),
            "key": _lin(sd, f"{a}.fn.key"),
            "transform": _lin(sd, f"{a}.fn.transform"),
        }
        stack[f"ff_{i}"] = {
            "w_1": _conv1d(sd, f"{f}.fn.w_1"),
            "w_2": _conv1d(sd, f"{f}.fn.w_2"),
        }
    return {"stack": stack}


def convert_lstransformer_stack(sd, prefix, n_layers):
    """Reference long-short FFTBlock (lstransformer.py:150-180): per layer a
    PreNorm(LongShortAttention) + PreNorm(conv FFN).  The rotary freqs
    buffer (pos_emb.freqs) is deterministic and recomputed on our side."""
    stack = {}
    for i in range(n_layers):
        a = f"{prefix}.layers.{i}.0"
        f = f"{prefix}.layers.{i}.1"
        stack[f"attn_norm_{i}"] = _ln_flat(sd, f"{a}.norm")
        stack[f"ff_norm_{i}"] = _ln_flat(sd, f"{f}.norm")
        stack[f"attn_{i}"] = {
            "to_q": {"kernel": sd[f"{a}.fn.to_q.weight"].T},
            "to_kv": {"kernel": sd[f"{a}.fn.to_kv.weight"].T},
            "to_out": _lin(sd, f"{a}.fn.to_out"),
            "to_dynamic_proj": {
                "kernel": sd[f"{a}.fn.to_dynamic_proj.weight"].T
            },
            "local_norm": _ln_flat(sd, f"{a}.fn.local_norm"),
            "global_norm": _ln_flat(sd, f"{a}.fn.global_norm"),
        }
        stack[f"ff_{i}"] = {
            "w_1": _conv1d(sd, f"{f}.fn.w_1"),
            "w_2": _conv1d(sd, f"{f}.fn.w_2"),
        }
    return {"stack": stack}


def _predictor_stack(sd, prefix, n_layers):
    """Reference Duration/VariancePredictor conv stacks (layers.py:372-505);
    Sequential indices: 0=pad, 1=conv, 2=relu, 3=LN, 4=dropout."""
    out = {}
    for i in range(n_layers):
        out[f"conv_{i}"] = _conv1d(sd, f"{prefix}.conv.{i}.1")
        out[f"ln_{i}"] = _ln(sd, f"{prefix}.conv.{i}.3")
    out["linear"] = _lin(sd, f"{prefix}.linear")
    return out


def convert_acoustic(
    sd: Dict[str, np.ndarray],
    encoder_layers: int = 6,
    decoder_layers: int = 6,
    dur_layers: int = 2,
    pit_layers: int = 2,
    ener_layers: int = 2,
    postnet_layers: int = 5,
    learn_alignment: bool = True,
    block_type: str = "transformer",
) -> Dict:
    """Reference FastSpeech2 -> the JAX package's variables dict (transformer,
    conformer, fastformer or long-short blocks; the variance and postnet
    trees are shared)."""
    params: Dict = {}
    batch_stats: Dict = {}

    if block_type == "transformer":
        params["encoder"] = {
            "src_word_emb": {"embedding": sd["encoder.src_word_emb.weight"]},
            **{
                f"layer_{i}": convert_fft_layer(sd, f"encoder.layer_stack.{i}")
                for i in range(encoder_layers)
            },
        }
        params["decoder"] = {
            f"layer_{i}": convert_fft_layer(sd, f"decoder.layer_stack.{i}")
            for i in range(decoder_layers)
        }
    elif block_type == "conformer":
        d_model = sd["encoder.src_word_emb.weight"].shape[1]
        enc = {"src_word_emb": {"embedding": sd["encoder.src_word_emb.weight"]}}
        enc_bs: Dict = {}
        for i in range(encoder_layers):
            p, bs = convert_conformer_block(
                sd, f"encoder.layer_stack.{i}", d_model
            )
            enc[f"layer_{i}"] = p
            enc_bs[f"layer_{i}"] = bs
        dec: Dict = {}
        dec_bs: Dict = {}
        for i in range(decoder_layers):
            p, bs = convert_conformer_block(
                sd, f"decoder.layer_stack.{i}", d_model
            )
            dec[f"layer_{i}"] = p
            dec_bs[f"layer_{i}"] = bs
        params["encoder"], params["decoder"] = enc, dec
        batch_stats["encoder"], batch_stats["decoder"] = enc_bs, dec_bs
    elif block_type == "fastformer":
        params["encoder"] = {
            "src_word_emb": {"embedding": sd["encoder.src_word_emb.weight"]},
            **convert_fastformer_stack(
                sd, "encoder.layer_stack", encoder_layers
            ),
        }
        params["decoder"] = convert_fastformer_stack(
            sd, "decoder.layer_stack", decoder_layers
        )
    elif block_type == "lstransformer":
        params["encoder"] = {
            "src_word_emb": {"embedding": sd["encoder.src_word_emb.weight"]},
            **convert_lstransformer_stack(
                sd, "encoder.layer_stack", encoder_layers
            ),
        }
        params["decoder"] = convert_lstransformer_stack(
            sd, "decoder.layer_stack", decoder_layers
        )
    else:
        # reformer is deliberately unsupported: the reference's LSH
        # attention draws fresh random rotation matrices per forward pass
        # (reference blocks/reformer.py hash_vectors), so two frameworks
        # cannot be made output-identical from shared weights.
        raise ValueError(
            f"no converter for block_type {block_type!r} (transformer, "
            "conformer, fastformer and lstransformer are supported)"
        )
    params["mel_linear"] = _lin(sd, "mel_linear")
    params["speaker_emb"] = {"embedding": sd["speaker_emb.weight"]}

    if learn_alignment:
        dur = {
            "stack": _predictor_stack(
                sd, "variance_adaptor.duration_predictor", dur_layers
            )
        }
    else:
        # supervised tree: ming024-style predictor
        # (supervised layers.py:240-297, Sequential named conv1d_i/layer_norm_i)
        dp = "variance_adaptor.duration_predictor"
        dur = {
            "stack": {
                "conv_0": _conv1d(sd, f"{dp}.conv_layer.conv1d_1.conv"),
                "ln_0": _ln(sd, f"{dp}.conv_layer.layer_norm_1"),
                "conv_1": _conv1d(sd, f"{dp}.conv_layer.conv1d_2.conv"),
                "ln_1": _ln(sd, f"{dp}.conv_layer.layer_norm_2"),
                "linear": _lin(sd, f"{dp}.linear_layer"),
            }
        }

    va: Dict = {
        "duration_predictor": dur,
        "pitch_predictor": {
            "pos_alpha": sd["variance_adaptor.pitch_predictor.pos_embed_alpha"],
            "stack": _predictor_stack(
                sd, "variance_adaptor.pitch_predictor", pit_layers
            ),
        },
        "energy_predictor": {
            "pos_alpha": sd["variance_adaptor.energy_predictor.pos_embed_alpha"],
            "stack": _predictor_stack(
                sd, "variance_adaptor.energy_predictor", ener_layers
            ),
        },
        "pitch_embedding": {
            "embedding": sd["variance_adaptor.pitch_embedding.weight"]
        },
        "energy_embedding": {
            "embedding": sd["variance_adaptor.energy_embedding.weight"]
        },
    }
    if learn_alignment:
        al = "variance_adaptor.aligner"
        va["aligner"] = {
            "key_conv1": _conv1d(sd, f"{al}.key_proj.0.conv"),
            "key_conv2": _conv1d(sd, f"{al}.key_proj.2.conv"),
            "query_conv1": _conv1d(sd, f"{al}.query_proj.0.conv"),
            "query_conv2": _conv1d(sd, f"{al}.query_proj.2.conv"),
            "query_conv3": _conv1d(sd, f"{al}.query_proj.4.conv"),
            "key_spk_proj": {"kernel": sd[f"{al}.key_spk_proj.linear.weight"].T},
            "query_spk_proj": {"kernel": sd[f"{al}.query_spk_proj.linear.weight"].T},
        }
    params["variance_adaptor"] = va

    postnet: Dict = {}
    batch_stats["postnet"] = {}
    for i in range(postnet_layers):
        p = f"postnet.convolutions.{i}"
        postnet[f"conv_{i}"] = _conv1d(sd, f"{p}.0.conv")
        postnet[f"bn_{i}"] = {
            "scale": sd[f"{p}.1.weight"],
            "bias": sd[f"{p}.1.bias"],
        }
        batch_stats["postnet"][f"bn_{i}"] = {
            "mean": sd[f"{p}.1.running_mean"],
            "var": sd[f"{p}.1.running_var"],
        }
    params["postnet"] = postnet

    return {"params": params, "batch_stats": batch_stats}


def _fuse_wn(sd, name):
    """Fuse torch weight-norm (weight_g, weight_v) -> plain weight.

    torch normalizes v over all dims except ``dim=0``:
    w = g * v / ||v||_(per dim0 slice).
    """
    if f"{name}.weight" in sd:
        return sd[f"{name}.weight"]
    g = sd[f"{name}.weight_g"]
    v = sd[f"{name}.weight_v"]
    norm = np.sqrt((v**2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _wn_conv1d(sd, name):
    """torch weight-norm Conv1d -> our WNConv1d (v, g, bias) params."""
    w = _fuse_wn(sd, name).transpose(2, 1, 0)  # (k, in, out)
    g = np.sqrt((w.reshape(-1, w.shape[-1]) ** 2).sum(0))
    out = {"v": w, "g": g}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _wn_convtranspose1d(sd, name):
    w = _fuse_wn(sd, name).transpose(2, 0, 1)  # (in,out,k) -> (k, in, out)
    g = np.sqrt((w.reshape(-1, w.shape[-1]) ** 2).sum(0))
    return {"v": w, "g": g, "bias": sd[f"{name}.bias"]}


def convert_hifigan(
    sd: Dict[str, np.ndarray],
    n_upsamples: int = 4,
    n_kernels: int = 3,
    n_res_convs: int = 3,
    resblock_type: int = 1,
) -> Dict:
    """Reference HifiGan or iSTFTNet generator -> the JAX package's params
    (weight-norm pairs fused, then stored as v = w, g = ||w||)."""
    trunk: Dict = {"conv_pre": _wn_conv1d(sd, "conv_pre")}
    for i in range(n_upsamples):
        trunk[f"up_{i}"] = _wn_convtranspose1d(sd, f"ups.{i}")
        for j in range(n_kernels):
            ridx = i * n_kernels + j
            res: Dict = {}
            if resblock_type == 1:
                for d in range(n_res_convs):
                    res[f"conv1_{d}"] = _wn_conv1d(sd, f"resblocks.{ridx}.convs1.{d}")
                    res[f"conv2_{d}"] = _wn_conv1d(sd, f"resblocks.{ridx}.convs2.{d}")
            else:
                for d in range(2):
                    res[f"conv_{d}"] = _wn_conv1d(sd, f"resblocks.{ridx}.convs.{d}")
            trunk[f"res_{i}_{j}"] = res

    return {"params": {"trunk": trunk, "conv_post": _wn_conv1d(sd, "conv_post")}}


def load_acoustic(sd: Dict[str, np.ndarray], config, n_symbols: int, n_speakers: int,
                  stats=None, *, device=None, dtype=torch.float32):
    """A reference acoustic ``state_dict`` -> the port's ``FastSpeech2`` for
    ``config`` (the whole ``Config``) on ``device`` (CUDA unless
    ``device="cpu"``), in eval mode, with ``use_flash`` as serving has it."""
    fs2 = config.models.fastspeech2
    vp = fs2.variance.variance_predictor
    variables = convert_acoustic(
        sd, encoder_layers=fs2.encoder_layers, decoder_layers=fs2.decoder_layers,
        dur_layers=vp.dur_predictor_layers, pit_layers=vp.pit_predictor_layers,
        ener_layers=vp.ener_predictor_layers, postnet_layers=fs2.postnet.conv_layers,
        learn_alignment=fs2.variance.duration_modelling.learn_alignment,
        block_type=fs2.building_block.block_type)
    model = FastSpeech2(fs2, n_symbols, n_speakers, config.audio.mel.channels,
                        stats or FeatureStats(), use_flash=True,
                        device=resolve_device(device), dtype=dtype)
    load_into(model, variables)
    return model


def load_vocoder(sd: Dict[str, np.ndarray], config, kind: str = "hifigan", *, device=None,
                 dtype=torch.float32):
    """A reference generator ``state_dict`` -> the port's serving generator
    (``kind`` "hifigan" or "istft", read from ``config.models``) on
    ``device`` (CUDA unless ``device="cpu"``)."""
    vc = config.models.hifigan if kind == "hifigan" else config.models.istft
    variables = convert_hifigan(
        sd, n_upsamples=len(vc.upsample_rates), n_kernels=len(vc.resblock_kernel_sizes),
        n_res_convs=len(vc.resblock_dilation_sizes[0]), resblock_type=int(vc.resblock))
    gen = build_generator(config, kind, device=resolve_device(device), dtype=dtype)
    load_into(gen, variables)
    return gen
