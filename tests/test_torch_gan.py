"""The port's vocoder GAN training against the JAX package's, on the CPU:
the weight-norm convolutions, the discriminators at reference width, the
LS-GAN losses, ``gan_optimizer`` against its optax chain, and
``make_vocoder_train_step`` for HiFi-GAN and iSTFTNet.  The same weights go
to both sides through ``convert.py``, which keeps each (v, g) pair where the
port's module holds one.

Bars (float32 on both sides, sums in another order):
- a weight-norm convolution's output and a discriminator's logits and
  feature maps: max |diff| < 1e-5; their gradients: relative norm < 1e-4;
- each GAN loss term: relative error < 1e-5;
- ``gan_optimizer``'s updates: max |diff| < 1e-6 against optax;
- 2 vocoder steps (tiny generator and discriminators): each metric within
  1e-5 relative, and each tensor's update in each step within 1e-3 relative
  norm.  Each step is held on its own because two Adam steps can cancel: a
  leaf whose gradient turns round moves by lr and then back, and the small
  net update holds float noise of the size of one step.  No leaf of the
  generator or the discriminators has a gradient that is 0 by construction,
  so no update is held to a looser noise bar.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.audio.mel import inverse_stft as jax_inverse_stft
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.nn import common as jax_common
from e2e_tts_tpu.nn import discriminators as jax_disc
from e2e_tts_tpu.nn.hifigan import HifiGanGenerator as JaxHifiGan
from e2e_tts_tpu.nn.hifigan import IstftNetGenerator as JaxIstftNet
from e2e_tts_tpu.train import gan_optimizer as jax_gan_optimizer
from e2e_tts_tpu.train import init_vocoder_train_state as jax_init_vocoder_state
from e2e_tts_tpu.train import make_vocoder_train_step as jax_make_vocoder_step
from e2e_tts_tpu.train.vocoder_step import VocoderBatch as JaxVocoderBatch
from e2e_tts_tpu_torch.audio.mel import inverse_stft
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import convert, load_into
from e2e_tts_tpu_torch.nn import common, discriminators
from e2e_tts_tpu_torch.nn.hifigan import TrainableHifiGan, TrainableIstftNet
from e2e_tts_tpu_torch.train import (VocoderBatch, gan_optimizer, init_vocoder_train_state,
                                     make_vocoder_train_step)

pytestmark = pytest.mark.usefixtures("one_thread")

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
OPT_TOL = 1e-6
UPDATE_TOL = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed):
    """g away from ||v|| and nonzero biases, so that both matter."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        x = np.asarray(x)
        key = getattr(path[-1], "key", None)
        if key == "g":
            return (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        if key == "bias":
            return (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


def _trained_scale(params, seed):
    """Each output channel's kernel at norm U(0.5, 1.5) (g drawn afresh) and
    nonzero biases: a network that keeps its signal's level from layer to
    layer, as a trained one does.  At the init's g = ||v|| (0.01 a weight)
    the tiny generator's early layers get gradients near 1e-12, below Adam's
    eps, where an update is the gradient's float noise over eps."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        x = np.asarray(x)
        key = getattr(path[-1], "key", None)
        if key == "g":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if key == "bias":
            return (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


def _speech(B, n, seed):
    """Audio at a speaking level: a few sines and noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 22050.0
    a = sum(0.2 * np.sin(2 * np.pi * f * t + rng.rand() * 6) for f in (140.0, 290.0, 610.0))
    return (a[None] + 0.02 * rng.randn(B, n)).astype(np.float32)


# --- weight-norm convolutions ----------------------------------------------------------------

class _Holder(torch.nn.Module):
    """A module tree whose names match the JAX tree {"trunk": {"up_0" | "c": ...}}."""

    def __init__(self, conv, transposed):
        super().__init__()
        self.trunk = torch.nn.Module()
        if transposed:
            self.trunk.ups = torch.nn.ModuleList([conv])
        else:
            self.trunk.c = conv


def _gen():
    return torch.Generator().manual_seed(0)


WN_CASES = {
    # name: (JAX module, port module, input shape (B, T, C) or (B, H, W, C))
    "same_even_dilated": (jax_common.WNConv1d(6, 4, dilation=3),
                          common.WNConv1d(5, 6, 4, dilation=3, generator=_gen()), (2, 19, 5)),
    "same_stride2": (jax_common.WNConv1d(6, 5, stride=2),
                     common.WNConv1d(5, 6, 5, stride=2, generator=_gen()), (2, 19, 5)),
    "grouped_explicit": (jax_common.WNConv1d(16, 41, stride=4, groups=4, padding=(20, 20)),
                         common.WNConv1d(8, 16, 41, stride=4, groups=4, padding=(20, 20),
                                         generator=_gen()), (2, 67, 8)),
    "transposed": (jax_common.WNConvTranspose1d(4, 16, 8),
                   common.WNConvTranspose1d(6, 4, 16, 8, generator=_gen()), (2, 9, 6)),
    "conv2d_period": (jax_disc.WNConv2d(8, (5, 1), (3, 1), ((2, 2), (0, 0))),
                      common.WNConv2d(3, 8, (5, 1), (3, 1), ((2, 2), (0, 0)), generator=_gen()),
                      (2, 17, 5, 3)),
}


@pytest.mark.parametrize("case", sorted(WN_CASES))
def test_wn_conv_matches_jax_forward_and_grads(case):
    jmod, port, shape = WN_CASES[case]
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    name = "up_0" if case == "transposed" else "c"
    params = _perturbed(_np(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]), 3)
    variables = {"params": {"trunk": {name: params}}}
    holder = _Holder(port, case == "transposed")
    assert load_into(holder, variables) == 3  # v, g, bias: kept, not fused

    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    r = rng.randn(*want.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jmod.apply({"params": p}, jnp.asarray(x)) * r))(params)

    xt = torch.from_numpy(x)
    if x.ndim == 4:  # NHWC -> NCHW and back
        got = port(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    elif case == "transposed":
        got = port.conv_ncw(xt.transpose(1, 2)).transpose(1, 2)
    else:
        got = port(xt)
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() < FWD_TOL
    (got * torch.from_numpy(r)).sum().backward()
    want_g = convert({"params": {"trunk": {name: _np(jgrads)}}}, holder.state_dict())
    for n, p in holder.named_parameters():
        assert _rel(p.grad.numpy(), want_g[n]) < GRAD_TOL, (case, n)
    # the norm runs per output channel: for the transposed conv, over dims (0, 2)
    v = port.v.detach()
    w = port.weight().detach()
    out_dim = 1 if case == "transposed" else 0
    dims = tuple(i for i in range(v.dim()) if i != out_dim)
    np.testing.assert_allclose(torch.linalg.vector_norm(w, dim=dims).numpy(),
                               np.abs(port.g.detach().numpy()), rtol=1e-5)


def test_wn_init_is_norm_of_v_and_fuses_to_the_serving_init():
    """g starts at ||v|| (so w = v at init), and a training generator fused
    at init is its seed's serving generator."""
    from e2e_tts_tpu_torch.nn.hifigan import HifiGanGenerator, fuse_generator

    conv = common.WNConv1d(4, 3, 5, generator=_gen())
    torch.testing.assert_close(conv.g, torch.linalg.vector_norm(conv.v, dim=(1, 2)))
    kw = dict(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3),))
    trained = TrainableHifiGan(**kw, device="cpu", seed=5)
    assert all(p.requires_grad for p in trained.parameters())
    serving = fuse_generator(trained)
    ref = HifiGanGenerator(**kw, device="cpu", seed=5)
    assert not any(p.requires_grad for p in serving.parameters())
    for (n, p), q in zip(serving.state_dict().items(), ref.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-8, msg=n)


# --- discriminators and losses at reference width -----------------------------------------------

def _random_tree(jmodule, seed, length=4096):
    """A weight tree for ``jmodule`` from numpy: v ~ normal(0.01), g = ||v||
    scaled by U(0.5, 1.5), biases normal(0.05); shapes from ``eval_shape``
    (no compile)."""
    a = jnp.zeros((1, length))
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), a, a)
    rng = np.random.RandomState(seed)

    def conv(leaves):
        v = (0.01 * rng.randn(*leaves["v"].shape)).astype(np.float32)
        norm = np.linalg.norm(v.reshape(-1, v.shape[-1]), axis=0)
        return {"v": v, "g": (norm * rng.uniform(0.5, 1.5, norm.shape)).astype(np.float32),
                "bias": (0.05 * rng.randn(*leaves["bias"].shape)).astype(np.float32)}

    def walk(tree):
        return conv(tree) if "v" in tree else {k: walk(t) for k, t in tree.items()}
    return walk(shapes)


def _jax_d_apply(jmpd, jmsd, vm, vs, real, fake):
    pr, pf, prf, pff = jmpd.apply(vm, real, fake)
    sr, sf, srf, sff = jmsd.apply(vs, real, fake)
    d = jax_disc.discriminator_loss(pr, pf) + jax_disc.discriminator_loss(sr, sf)
    return d, (pr, pf, prf, pff, sr, sf, srf, sff)


def test_discriminators_match_jax_at_reference_width():
    """2 x 4099 samples: not a multiple of any period, so every period
    discriminator reflect-pads its tail; MSD's pooled scales count the pad.
    Logits and every feature map (NHWC -> NCHW), and the three losses."""
    jmpd, jmsd = jax_disc.MultiPeriodDiscriminator(), jax_disc.MultiScaleDiscriminator()
    vm, vs = _random_tree(jmpd, 1), _random_tree(jmsd, 2)
    mpd, msd = discriminators.build_discriminators(device="cpu")
    assert load_into(mpd, vm) == 5 * 6 * 3  # 5 periods x (4 + 1 + post) convs x (v, g, bias)
    assert load_into(msd, vs) == 3 * 8 * 3  # 3 scales x (7 + post) convs x (v, g, bias)
    real, fake = _speech(2, 4099, 0), _speech(2, 4099, 1) * 0.5
    jd, (pr, pf, prf, pff, sr, sf, srf, sff) = jax.jit(functools.partial(_jax_d_apply, jmpd, jmsd))(
        vm, vs, jnp.asarray(real), jnp.asarray(fake))
    out = {}
    with torch.no_grad():
        out["mpd"] = mpd(torch.from_numpy(real), torch.from_numpy(fake))
        out["msd"] = msd(torch.from_numpy(real), torch.from_numpy(fake))
    for key, want in (("mpd", (pr, pf, prf, pff)), ("msd", (sr, sf, srf, sff))):
        got = out[key]
        for lg_g, lg_w in zip(got[0] + got[1], want[0] + want[1]):
            assert lg_g.shape == lg_w.shape
            assert np.abs(lg_g.numpy() - np.asarray(lg_w)).max() < FWD_TOL, key
        n_maps = 0
        for maps_g, maps_w in zip(got[2] + got[3], want[2] + want[3]):
            for fg, fw in zip(maps_g, maps_w):
                fw = np.asarray(fw)
                fw = fw.transpose(0, 3, 1, 2) if fw.ndim == 4 else fw.transpose(0, 2, 1)
                assert fg.shape == fw.shape
                assert np.abs(fg.numpy() - fw).max() < FWD_TOL, (key, fg.shape)
                n_maps += 1
        assert n_maps == (2 * 5 * 6 if key == "mpd" else 2 * 3 * 8)

    losses = {
        "feature": (discriminators.feature_loss(out["mpd"][2], out["mpd"][3])
                    + discriminators.feature_loss(out["msd"][2], out["msd"][3]),
                    jax_disc.feature_loss(prf, pff) + jax_disc.feature_loss(srf, sff)),
        "discriminator": (discriminators.discriminator_loss(out["mpd"][0], out["mpd"][1])
                          + discriminators.discriminator_loss(out["msd"][0], out["msd"][1]), jd),
        "generator_adv": (discriminators.generator_adv_loss(out["mpd"][1])
                          + discriminators.generator_adv_loss(out["msd"][1]),
                          jax_disc.generator_adv_loss(pf) + jax_disc.generator_adv_loss(sf)),
    }
    for key, (got, want) in losses.items():
        assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want)), key


def test_discriminator_loss_gradients_match_jax():
    """The discriminators' loss gradient in every (v, g, bias), at the tiny
    widths of the step tests, against ``jax.grad``."""
    jmpd, jmsd = _tiny_jax_discriminators()
    vm, vs = _random_tree(jmpd, 3, 1000), _random_tree(jmsd, 4, 1000)
    mpd, msd = _tiny_port_discriminators()
    load_into(mpd, vm)
    load_into(msd, vs)
    real, fake = _speech(2, 1001, 2), _speech(2, 1001, 3) * 0.5
    grads = jax.jit(jax.grad(lambda vm, vs: _jax_d_apply(jmpd, jmsd, vm, vs, jnp.asarray(real),
                                                         jnp.asarray(fake))[0], argnums=(0, 1)))(
        vm, vs)
    real_t, fake_t = torch.from_numpy(real), torch.from_numpy(fake)
    d = sum(discriminators.discriminator_loss(*m(real_t, fake_t)[:2]) for m in (mpd, msd))
    d.backward()
    for module, g in zip((mpd, msd), grads):
        want = convert(_np(g), module.state_dict())
        for n, p in module.named_parameters():
            assert _rel(p.grad.numpy(), want[n]) < GRAD_TOL, n


def test_msd_pool_counts_the_pad_and_mpd_reflects_the_tail():
    """MSD downsamples by avg_pool(4, 2, pad 2) with the pad counted (flax's
    default): the first pooled sample of a constant signal is half of it.
    MPD reflects the tail without repeating the last sample."""
    msd = discriminators.MultiScaleDiscriminator(2, discriminators.TINY_MSD_SPECS, device="cpu")
    seen = []
    msd.scale_1.forward = lambda x: (seen.append(x), (x, []))[1]
    msd.discriminate(torch.ones(1, 16))
    assert seen[0].shape == (1, 9)
    torch.testing.assert_close(seen[0][0, :2], torch.tensor([0.5, 1.0]))

    mpd = discriminators.MultiPeriodDiscriminator((5,), (2,), device="cpu")
    folded = []
    conv0 = mpd.period_5.convs[0]
    conv0.forward = lambda x, f=conv0.forward: (folded.append(x), f(x))[1]
    mpd.discriminate(torch.arange(7.0)[None])
    assert folded[0].shape == (1, 1, 2, 5)
    assert folded[0].flatten().tolist() == [0, 1, 2, 3, 4, 5, 6, 5, 4, 3]


def test_inverse_stft_gradient_matches_jax():
    """The gradient through ``torch.fft.irfft`` (the iSTFTNet head) against
    ``jax.grad``, the DC and Nyquist bins' imaginary parts included: JAX's
    irfft drops them, the port zeroes them, so the phase there gets the
    cosine's gradient only."""
    rng = np.random.RandomState(4)
    mag = np.exp(rng.randn(2, 9, 40)).astype(np.float32)
    phase = rng.uniform(-3, 3, mag.shape).astype(np.float32)
    r = rng.randn(2, 4 * 39).astype(np.float32)
    f = lambda m, p: jnp.sum(jax_inverse_stft(m, p, 16, 4, 16) * r)  # noqa: E731
    jm, jp = jax.grad(f, argnums=(0, 1))(jnp.asarray(mag), jnp.asarray(phase))
    m, p = torch.from_numpy(mag).requires_grad_(), torch.from_numpy(phase).requires_grad_()
    (inverse_stft(m, p, 16, 4, 16) * torch.from_numpy(r)).sum().backward()
    for got, want in ((m.grad, jm), (p.grad, jp)):
        assert _rel(got.numpy(), want) < GRAD_TOL
        for b in (0, 8):  # DC, Nyquist
            assert _rel(got[:, b].numpy(), np.asarray(want)[:, b]) < GRAD_TOL, b


# --- the optimizer ----------------------------------------------------------------------------

@pytest.mark.parametrize("count", [0, 2500])
def test_gan_optimizer_matches_optax(count):
    """3 updates of an MPD + MSD shaped tree against the optax chain, from
    update count 0 and 2500 (the learning rate 0.999^2.5 down).  Neither
    half's gradient norm reaches the clip alone; together they do, so the
    clip must run over both.  The config's ``weight_decay`` 0.999 is the
    decay gamma: no weight decay is applied."""
    cfg = default_config().train.hifigan_optimizer
    assert cfg.weight_decay == 0.999
    opt = gan_optimizer(cfg)
    assert opt.weight_decay == 0.0
    jopt = jax_gan_optimizer(jax_default_config().train.hifigan_optimizer)
    rng = np.random.RandomState(count)
    tree = {"mpd": {"a": rng.randn(4, 3).astype(np.float32)},
            "msd": {"b": rng.randn(5).astype(np.float32), "c": rng.randn(2, 2).astype(np.float32)}}
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    params = [torch.from_numpy(x.copy()) for x in leaves]
    state = opt.init(params)
    state.count = count
    jstate = jopt.init(tree)
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.asarray(count, x.dtype) if jnp.ndim(x) == 0 else x, jstate)
    jparams = tree
    for i in range(3):
        grads = [rng.randn(*x.shape) for x in leaves]
        # the norms of the MPD and MSD halves: each under the clip, together
        # over it; then far over; then far under
        for (j, k), norm in zip(((0, 1), (1, 3)), ((0.8, 0.8), (3.0, 4.0), (0.01, 0.02))[i]):
            h = np.sqrt(sum((g ** 2).sum() for g in grads[j:k]))
            grads[j:k] = [g * norm / h for g in grads[j:k]]
        grads = [g.astype(np.float32) for g in grads]
        jg = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g) for g in grads])
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.apply(params, [torch.from_numpy(g) for g in grads], state)
        for got, want in zip(params, jax.tree_util.tree_leaves(jparams)):
            assert np.abs(got.numpy() - np.asarray(want)).max() < OPT_TOL, i
    assert state.count == count + 3


# --- the vocoder train step -------------------------------------------------------------------

TINY_GEN = dict(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),))
TINY_ISTFT = dict(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                  resblock_dilation_sizes=((1, 3),))
SEG = 8  # frames a row


def _tiny_config(cfg):
    m = cfg.models
    return cfg.replace(models=m.replace(hifigan=m.hifigan.replace(**TINY_GEN),
                                        istft=m.istft.replace(**TINY_ISTFT)))


def _tiny_jax_discriminators():
    return (jax_disc.MultiPeriodDiscriminator(periods=(2, 3), channels=(4, 8)),
            jax_disc.MultiScaleDiscriminator(n_scales=2, specs=jax_disc.TINY_MSD_SPECS))


def _tiny_port_discriminators():
    return discriminators.build_discriminators(device="cpu", periods=(2, 3), mpd_channels=(4, 8),
                                               n_scales=2, msd_specs=discriminators.TINY_MSD_SPECS)


_JAX_STEPS = {}


def _jax_vocoder_steps(kind, n):
    """n JAX vocoder steps from the init at a trained scale: (the variables before each
    step and after the last, metrics of each step); compiled once per kind."""
    if kind in _JAX_STEPS:
        return _JAX_STEPS[kind]
    cfg = _tiny_config(jax_default_config())
    gen = (JaxHifiGan if kind == "hifigan" else JaxIstftNet).from_config(
        cfg.models.hifigan if kind == "hifigan" else cfg.models.istft)
    jmpd, jmsd = _tiny_jax_discriminators()
    g_opt = d_opt = jax_gan_optimizer(cfg.train.hifigan_optimizer)
    state = jax_init_vocoder_state(gen, cfg, g_opt, d_opt, jax.random.PRNGKey(0), SEG,
                                   mpd=jmpd, msd=jmsd)
    state = state._replace(g_params=_trained_scale(_np(state.g_params), 5),
                           d_params=_trained_scale(_np(state.d_params), 6))
    step = jax.jit(jax_make_vocoder_step(gen, cfg, g_opt, d_opt, kind, mpd=jmpd, msd=jmsd))
    batch = JaxVocoderBatch(*(jnp.asarray(a) for a in _vocoder_batch()))
    trees, metrics = [(state.g_params, state.d_params)], []
    for _ in range(n):
        state, m = step(state, batch)
        trees.append(_np((state.g_params, state.d_params)))
        metrics.append({k: float(v) for k, v in m.items()})
    _JAX_STEPS[kind] = (trees, metrics)
    return _JAX_STEPS[kind]


def _vocoder_batch(B=2):
    rng = np.random.RandomState(7)
    mel = (rng.randn(B, SEG, 80) * 1.5 - 5.0).astype(np.float32)
    return (mel, _speech(B, SEG * 256, 8))


def _port_vocoder(kind, init):
    cfg = _tiny_config(default_config())
    gen = (TrainableHifiGan if kind == "hifigan" else TrainableIstftNet).from_config(
        cfg.models.hifigan if kind == "hifigan" else cfg.models.istft, device="cpu")
    mpd, msd = _tiny_port_discriminators()
    g_params, d_params = init
    load_into(gen, g_params)
    load_into(mpd, d_params["mpd"])
    load_into(msd, d_params["msd"])
    return cfg, gen, mpd, msd


def _snapshot(modules):
    return [{n: p.detach().numpy().copy() for n, p in m.named_parameters()} for m in modules]


def _check_step_update(modules, before, after, jax_before, jax_after):
    """One step's update of every tensor, port (``before`` -> ``after``)
    against JAX (``jax_before`` -> ``jax_after``, trees in the modules' order)."""
    for module, b, a, jb, ja in zip(modules, before, after, jax_before, jax_after):
        jb, ja = convert(jb, module.state_dict()), convert(ja, module.state_dict())
        for n in a:
            assert _rel(a[n] - b[n], ja[n] - jb[n]) < UPDATE_TOL, n


@pytest.mark.parametrize("kind", ["hifigan", "istft"])
def test_vocoder_step_matches_jax(kind):
    """Two steps (D on the current G, then G on the updated D) against JAX:
    the metrics of each, and every parameter's update in each."""
    trees, jmetrics = _jax_vocoder_steps(kind, 2)
    cfg, gen, mpd, msd = _port_vocoder(kind, trees[0])
    modules = (gen, mpd, msd)
    g_opt = gan_optimizer(cfg.train.hifigan_optimizer)
    d_opt = gan_optimizer(cfg.train.hifigan_optimizer)
    state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
    step = make_vocoder_train_step(gen, cfg, g_opt, d_opt, kind, mpd=mpd, msd=msd)
    batch = VocoderBatch.from_numpy(_vocoder_batch(), "cpu")
    flat = lambda t: (t[0], t[1]["mpd"], t[1]["msd"])  # noqa: E731
    for i, want in enumerate(jmetrics):
        before = _snapshot(modules)
        state, got = step(state, batch)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert abs(got[k].item() - w) <= LOSS_TOL * abs(w), (k, got[k].item(), w)
        _check_step_update(modules, before, _snapshot(modules), flat(trees[i]), flat(trees[i + 1]))
    assert state.step == 2
    # autograd.grad: no .grad left on either side's parameters
    assert all(p.grad is None for m in modules for p in m.parameters())


def test_vocoder_step_updates_d_before_g():
    """The generator's losses are taken against the updated discriminators:
    with the discriminators' learning rate at 0 they differ; the
    discriminators' own losses of the first step do not."""
    init = _jax_vocoder_steps("hifigan", 2)[0][0]
    out = {}
    for lr in (0.0, None):
        cfg, gen, mpd, msd = _port_vocoder("hifigan", init)
        opt_cfg = cfg.train.hifigan_optimizer
        d_opt = gan_optimizer(opt_cfg if lr is None else opt_cfg.replace(learning_rate=lr))
        g_opt = gan_optimizer(opt_cfg)
        state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
        step = make_vocoder_train_step(gen, cfg, g_opt, d_opt, "hifigan", mpd=mpd, msd=msd)
        out[lr] = step(state, VocoderBatch.from_numpy(_vocoder_batch(), "cpu"))[1]
    assert out[0.0]["d_total"].item() == out[None]["d_total"].item()
    assert out[0.0]["g_adv"].item() != out[None]["g_adv"].item()
    assert out[0.0]["g_mel"].item() == out[None]["g_mel"].item()


def test_vocoder_step_defaults_and_device(monkeypatch):
    """Without discriminators the step builds the reference widths on the
    generator's device; the training form builds on CUDA unless told, and
    raises without one."""
    from e2e_tts_tpu_torch.models.vocoder import build_generator

    cfg = _tiny_config(default_config())
    gen = build_generator(cfg, "hifigan", train=True, device="cpu")
    opt = gan_optimizer(cfg.train.hifigan_optimizer)
    step = make_vocoder_train_step(gen, cfg, opt, opt)
    assert step.mpd.periods == (2, 3, 5, 7, 11) and step.msd.n_scales == 3
    assert step.mpd.period_2.convs[-2].v.shape == (1024, 512, 5, 1)
    assert next(step.msd.parameters()).device.type == "cpu"
    with pytest.raises(ValueError):
        make_vocoder_train_step(gen, cfg, opt, opt, "melgan")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_generator(cfg, "hifigan", train=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        discriminators.build_discriminators()
