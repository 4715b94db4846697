"""Random ``state_dict``s in the reference's PyTorch layout, for exercising
the import (``torch_import.py``) where no reference checkpoint is at hand.

``acoustic_state_dict`` and ``generator_state_dict`` are the inverses of
``convert_acoustic`` and ``convert_hifigan``: each takes a variables tree in
the JAX package's layout (``convert.to_jax`` of a port model gives one of
the right shapes for a config) and writes every array under the key, and in
the layout, that the converter reads.  ``random_reference_state_dict`` fills such a tree with
seeded random values: each array drawn around the template's own scale,
the running variances positive, and weight-norm pairs as (``weight_g``,
``weight_v``) with g drawn U(0.5, 1.5).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..convert import to_jax


def _lin(sd, name, t):
    sd[f"{name}.weight"] = t["kernel"].T
    if "bias" in t:
        sd[f"{name}.bias"] = t["bias"]


def _conv1d(sd, name, t):
    c = t["Conv_0"]
    sd[f"{name}.weight"] = c["kernel"].transpose(2, 1, 0)
    if "bias" in c:
        sd[f"{name}.bias"] = c["bias"]


def _ln_flat(sd, name, t):
    sd[f"{name}.weight"], sd[f"{name}.bias"] = t["scale"], t["bias"]


def _fft_layer(sd, p, t):
    a, f = t["slf_attn"], t["pos_ffn"]
    for ours, theirs in (("w_q", "w_qs"), ("w_k", "w_ks"), ("w_v", "w_vs"), ("fc", "fc")):
        _lin(sd, f"{p}.slf_attn.{theirs}", a[ours])
    _ln_flat(sd, f"{p}.slf_attn.layer_norm", a["LayerNorm_0"])
    _conv1d(sd, f"{p}.pos_ffn.w_1", f["w_1"])
    _conv1d(sd, f"{p}.pos_ffn.w_2", f["w_2"])
    _ln_flat(sd, f"{p}.pos_ffn.layer_norm", f["LayerNorm_0"])


def _conformer_ffn(sd, p, t):
    _ln_flat(sd, f"{p}.sequential.0", t["LayerNorm_0"])
    _lin(sd, f"{p}.sequential.1.linear", t["Dense_0"])
    _lin(sd, f"{p}.sequential.4.linear", t["Dense_1"])


def _conformer_block(sd, p, t, bs):
    a = f"{p}.sequential.1.module"
    c = f"{p}.sequential.2.module.sequential"
    _conformer_ffn(sd, f"{p}.sequential.0.module", t["ff1"])
    _ln_flat(sd, f"{a}.layer_norm", t["mhsa_norm"])
    m = t["mhsa"]
    for name in ("query_proj", "key_proj", "value_proj", "pos_proj", "out_proj"):
        # the reference's projections have no bias; the converter adds zeros
        sd[f"{a}.attention.{name}.linear.weight"] = m[name]["kernel"].T
    sd[f"{a}.attention.u_bias"], sd[f"{a}.attention.v_bias"] = m["u_bias"], m["v_bias"]
    cv = t["conv"]
    _ln_flat(sd, f"{c}.0", cv["LayerNorm_0"])
    for idx, name in ((2, "pw1"), (7, "pw2")):
        sd[f"{c}.{idx}.conv.weight"] = cv[name]["kernel"].T[:, :, None]
        if "bias" in cv[name]:
            sd[f"{c}.{idx}.conv.bias"] = cv[name]["bias"]
    sd[f"{c}.4.conv.weight"] = cv["depthwise"]["kernel"].transpose(2, 1, 0)
    bn, st = cv["BatchNorm_0"], bs["conv"]["BatchNorm_0"]
    sd[f"{c}.5.weight"], sd[f"{c}.5.bias"] = bn["scale"], bn["bias"]
    sd[f"{c}.5.running_mean"], sd[f"{c}.5.running_var"] = st["mean"], st["var"]
    _conformer_ffn(sd, f"{p}.sequential.3.module", t["ff2"])
    _ln_flat(sd, f"{p}.sequential.4", t["final_norm"])


def _fastformer_stack(sd, p, t, n_layers):
    for name in ("to_q_attn_logits", "to_k_attn_logits"):
        _lin(sd, f"{p}.layers.0.0.fn.{name}", t[name])
    for i in range(n_layers):
        a, f = f"{p}.layers.{i}.0", f"{p}.layers.{i}.1"
        _ln_flat(sd, f"{a}.norm", t[f"attn_norm_{i}"])
        _ln_flat(sd, f"{f}.norm", t[f"ff_norm_{i}"])
        for name in ("query", "key", "transform"):
            _lin(sd, f"{a}.fn.{name}", t[f"attn_{i}"][name])
        _conv1d(sd, f"{f}.fn.w_1", t[f"ff_{i}"]["w_1"])
        _conv1d(sd, f"{f}.fn.w_2", t[f"ff_{i}"]["w_2"])


def _lstransformer_stack(sd, p, t, n_layers):
    for i in range(n_layers):
        a, f = f"{p}.layers.{i}.0", f"{p}.layers.{i}.1"
        at = t[f"attn_{i}"]
        _ln_flat(sd, f"{a}.norm", t[f"attn_norm_{i}"])
        _ln_flat(sd, f"{f}.norm", t[f"ff_norm_{i}"])
        for name in ("to_q", "to_kv", "to_dynamic_proj"):
            sd[f"{a}.fn.{name}.weight"] = at[name]["kernel"].T
        _lin(sd, f"{a}.fn.to_out", at["to_out"])
        _ln_flat(sd, f"{a}.fn.local_norm", at["local_norm"])
        _ln_flat(sd, f"{a}.fn.global_norm", at["global_norm"])
        _conv1d(sd, f"{f}.fn.w_1", t[f"ff_{i}"]["w_1"])
        _conv1d(sd, f"{f}.fn.w_2", t[f"ff_{i}"]["w_2"])


def _predictor_stack(sd, p, t):
    n = sum(k.startswith("conv_") for k in t)
    for i in range(n):
        _conv1d(sd, f"{p}.conv.{i}.1", t[f"conv_{i}"])
        _ln_flat(sd, f"{p}.conv.{i}.3", t[f"ln_{i}"]["LayerNorm_0"])
    _lin(sd, f"{p}.linear", t["linear"])


def acoustic_state_dict(variables: dict, block_type: str = "transformer",
                        learn_alignment: bool = True) -> Dict[str, np.ndarray]:
    """An acoustic variables tree in the JAX layout -> the reference's
    ``state_dict`` that ``convert_acoustic`` reads back into it."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    enc, dec = params["encoder"], params["decoder"]
    sd["encoder.src_word_emb.weight"] = enc["src_word_emb"]["embedding"]
    n_enc = sum(k.startswith("layer_") for k in enc) or sum(
        k.startswith("attn_norm_") for k in enc.get("stack", {}))
    n_dec = sum(k.startswith("layer_") for k in dec) or sum(
        k.startswith("attn_norm_") for k in dec.get("stack", {}))
    for side, tree, n in (("encoder", enc, n_enc), ("decoder", dec, n_dec)):
        if block_type == "transformer":
            for i in range(n):
                _fft_layer(sd, f"{side}.layer_stack.{i}", tree[f"layer_{i}"])
        elif block_type == "conformer":
            for i in range(n):
                _conformer_block(sd, f"{side}.layer_stack.{i}", tree[f"layer_{i}"],
                                 stats[side][f"layer_{i}"])
        elif block_type == "fastformer":
            _fastformer_stack(sd, f"{side}.layer_stack", tree["stack"], n)
        elif block_type == "lstransformer":
            _lstransformer_stack(sd, f"{side}.layer_stack", tree["stack"], n)
        else:
            raise ValueError(f"no reference layout for block_type {block_type!r}")
    _lin(sd, "mel_linear", params["mel_linear"])
    sd["speaker_emb.weight"] = params["speaker_emb"]["embedding"]

    va = params["variance_adaptor"]
    dp = "variance_adaptor.duration_predictor"
    dur = va["duration_predictor"]["stack"]
    if learn_alignment:
        _predictor_stack(sd, dp, dur)
    else:
        for i in (0, 1):
            _conv1d(sd, f"{dp}.conv_layer.conv1d_{i + 1}.conv", dur[f"conv_{i}"])
            _ln_flat(sd, f"{dp}.conv_layer.layer_norm_{i + 1}", dur[f"ln_{i}"]["LayerNorm_0"])
        _lin(sd, f"{dp}.linear_layer", dur["linear"])
    for kind in ("pitch", "energy"):
        pred = va[f"{kind}_predictor"]
        sd[f"variance_adaptor.{kind}_predictor.pos_embed_alpha"] = pred["pos_alpha"]
        _predictor_stack(sd, f"variance_adaptor.{kind}_predictor", pred["stack"])
        sd[f"variance_adaptor.{kind}_embedding.weight"] = va[f"{kind}_embedding"]["embedding"]
    if learn_alignment:
        al, t = "variance_adaptor.aligner", va["aligner"]
        for ours, theirs in (("key_conv1", "key_proj.0"), ("key_conv2", "key_proj.2"),
                             ("query_conv1", "query_proj.0"), ("query_conv2", "query_proj.2"),
                             ("query_conv3", "query_proj.4")):
            _conv1d(sd, f"{al}.{theirs}.conv", t[ours])
        for name in ("key_spk_proj", "query_spk_proj"):
            sd[f"{al}.{name}.linear.weight"] = t[name]["kernel"].T
    post, post_stats = params["postnet"], stats["postnet"]
    for i in range(sum(k.startswith("conv_") for k in post)):
        p = f"postnet.convolutions.{i}"
        _conv1d(sd, f"{p}.0.conv", post[f"conv_{i}"])
        sd[f"{p}.1.weight"], sd[f"{p}.1.bias"] = post[f"bn_{i}"]["scale"], post[f"bn_{i}"]["bias"]
        sd[f"{p}.1.running_mean"] = post_stats[f"bn_{i}"]["mean"]
        sd[f"{p}.1.running_var"] = post_stats[f"bn_{i}"]["var"]
    return sd


def _wn(sd, name, t, transpose, rng):
    """A weight-norm conv {v, g, bias} -> the reference's (weight_g, weight_v):
    v from the JAX layout, g (one per dim-0 slice, as torch's weight_norm
    keeps it) drawn U(0.5, 1.5), a trained generator's scale (at the init's
    g = ||v|| a random generator's waveform is far below 1 LSB)."""
    v = t["v"].transpose(*transpose)
    sd[f"{name}.weight_v"] = v
    sd[f"{name}.weight_g"] = rng.uniform(0.5, 1.5, (v.shape[0],) + (1,) * (v.ndim - 1)).astype(
        v.dtype)
    if "bias" in t:
        sd[f"{name}.bias"] = t["bias"]


def generator_state_dict(variables: dict, seed: int = 0) -> Dict[str, np.ndarray]:
    """A generator's variables tree in the JAX layout (HiFi-GAN or iSTFTNet)
    -> the reference's weight-normed ``state_dict``."""
    rng = np.random.RandomState(seed)
    params = variables["params"]
    trunk, sd = params["trunk"], {}
    _wn(sd, "conv_pre", trunk["conv_pre"], (2, 1, 0), rng)
    n_up = sum(k.startswith("up_") for k in trunk)
    n_kernels = sum(k.startswith("res_0_") for k in trunk)
    for i in range(n_up):
        _wn(sd, f"ups.{i}", trunk[f"up_{i}"], (1, 2, 0), rng)  # (k, in, out) -> (in, out, k)
        for j in range(n_kernels):
            r, res = i * n_kernels + j, trunk[f"res_{i}_{j}"]
            for key in sorted(res):
                group, d = key.rsplit("_", 1)
                name = {"conv1": "convs1", "conv2": "convs2", "conv": "convs"}[group]
                _wn(sd, f"resblocks.{r}.{name}.{d}", res[key], (2, 1, 0), rng)
    _wn(sd, "conv_post", params["conv_post"], (2, 1, 0), rng)
    return sd


def _randomize(tree, rng):
    """Every array redrawn around its own scale (a trained model's spread,
    not the init's): normal with the array's std (0.1 where it is
    constant) about its mean; variances and weight-norm gains kept > 0."""
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
            continue
        std = float(v.std()) if v.size > 1 and v.std() > 0 else 0.1
        x = float(v.mean()) + std * rng.randn(*v.shape)
        if k in ("var", "g"):
            x = np.abs(x) + 0.5
        out[k] = x.astype(v.dtype)
    return out


def random_reference_state_dict(module: torch.nn.Module, seed: int = 0,
                                block_type: str = "transformer",
                                learn_alignment: bool = True) -> Dict[str, np.ndarray]:
    """A seeded random reference ``state_dict`` of the shapes of ``module``
    (the port's acoustic model or serving generator for some config)."""
    from ..nn.hifigan import HifiGanGenerator, IstftNetGenerator

    rng = np.random.RandomState(seed)
    tree = _randomize(to_jax(module), rng)
    if isinstance(module, (HifiGanGenerator, IstftNetGenerator)):
        return generator_state_dict(tree, seed)
    return acoustic_state_dict(tree, block_type, learn_alignment)
