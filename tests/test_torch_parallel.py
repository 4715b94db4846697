"""The port's ``parallel/`` package and the engine's data-parallel serving
against the JAX package's, in the main process (JAX's 8 virtual CPU devices
from ``tests/conftest.py``; the two-rank checks are in
``test_torch_parallel_steps.py``).

- Mesh arithmetic: ``mesh_shape`` / ``data_mesh_shape`` against JAX's
  ``make_mesh`` / ``make_data_mesh`` for every count of devices from 1 to
  8 (JAX's ``jax.devices()`` cut to the count), every ``model_parallel``,
  every ``n_devices`` and batch sizes 1 to 32, errors included.
- Sharding rules: for every parameter of the default-width transformer
  FastSpeech2 and HiFi-GAN generator (training form), the port's placement
  splits the same logical axis as JAX's ``param_sharding_rules`` on (4, 2)
  and (8, 1) meshes, and on a (2, 3) mesh where the divisibility guard
  replicates the FFN's 1024 channels; the parameters are mapped through
  ``convert.py`` with their axes permuted.
- The engine: ``serving_devices=8, batch_size=8`` on ``vie_tiny`` against
  JAX's sharded engine: the same batch size and row buckets, int16 of
  equal length within 1 LSB mean, on one text (one batch) and on ten
  chunks; against the port's own single engine; under ``BatchingServer``.
"""

import os

import jax
import numpy as np
import pytest

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.models.acoustic import FastSpeech2 as JaxFastSpeech2
from e2e_tts_tpu.models.acoustic import init_acoustic_variables
from e2e_tts_tpu.nn import FeatureStats as JaxFeatureStats
from e2e_tts_tpu.nn.hifigan import HifiGanGenerator as JaxHifiGan
from e2e_tts_tpu.parallel import make_data_mesh as jax_make_data_mesh
from e2e_tts_tpu.parallel import make_mesh as jax_make_mesh
from e2e_tts_tpu.parallel import param_sharding_rules as jax_rules
from e2e_tts_tpu.serve.engine import SynthesisEngine as JaxEngine
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.convert import _torch_name
from e2e_tts_tpu_torch.models.vocoder import build_generator
from e2e_tts_tpu_torch.parallel import param_sharding_rules
from e2e_tts_tpu_torch.parallel.mesh import data_mesh_shape, mesh_shape
from e2e_tts_tpu_torch.parallel.sharding import split_dim
from e2e_tts_tpu_torch.serve import BatchingServer
from e2e_tts_tpu_torch.serve.engine import SynthesisEngine
from e2e_tts_tpu_torch.train import build_acoustic_model

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")
N_SYMBOLS = 100


# --- mesh arithmetic ---------------------------------------------------------------------------

def _jax_shape(fn):
    """(data, model) of JAX's mesh, or the ValueError's message."""
    try:
        m = fn()
    except ValueError as e:
        return str(e)
    return tuple(m.devices.shape)


def _port_shape(fn):
    try:
        return fn()
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("n_available", range(1, 9))
def test_mesh_arithmetic_matches_jax(n_available, monkeypatch):
    devices = jax.devices()[:n_available]
    monkeypatch.setattr(jax, "devices", lambda: devices)
    for mp in range(1, 9):
        for n in (None, *range(1, 10)):
            want = _jax_shape(lambda: jax_make_mesh(n, model_parallel=mp))
            assert _port_shape(lambda: mesh_shape(n_available, n, mp)) == want, (n, mp)
        for batch in range(1, 33):
            want = _jax_shape(lambda: jax_make_data_mesh(batch, model_parallel=mp))
            assert _port_shape(lambda: data_mesh_shape(n_available, batch, mp)) == want, \
                (batch, mp)


# --- sharding rules ----------------------------------------------------------------------------

def _jax_param_shapes():
    """JAX's default-width FastSpeech2 and HiFi-GAN parameter shapes."""
    cfg = jax_default_config()
    am = JaxFastSpeech2(cfg.models.fastspeech2, N_SYMBOLS, 1, 80, JaxFeatureStats())
    ams = jax.eval_shape(lambda: init_acoustic_variables(am, 0))["params"]
    gen = JaxHifiGan.from_config(cfg.models.hifigan)
    gs = jax.eval_shape(lambda: gen.init(jax.random.PRNGKey(0),
                                         np.zeros((1, 4, 80), np.float32)))["params"]
    return ams, gs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _jax_axis(path, spec_tree):
    """The axis of JAX's array that "model" splits, or None."""
    spec = _flat(spec_tree)[path].spec
    axes = [i for i, s in enumerate(spec) if s == "model"]
    return axes[0] if axes else None


def _port_to_jax_axis(name, leaf, ndim, dim):
    """A port tensor's dim as the axis of JAX's array (``convert._layout``
    read backwards)."""
    if dim is None or leaf not in ("kernel", "v"):
        return dim
    if ndim == 2:
        return 1 - dim  # Linear (out, in) <- Dense (in, out)
    if ".ups." in f".{name}":
        return {0: 1, 1: 2, 2: 0}[dim]  # (in, out, k) <- (k, in, out)
    return 2 - dim  # (out, in, k) <- (k, in, out)


@pytest.fixture(scope="module")
def models():
    cfg = default_config()
    am = build_acoustic_model(cfg, N_SYMBOLS, 1, device="cpu")
    gen = build_generator(cfg, "hifigan", train=True, device="cpu")
    return am, gen, _jax_param_shapes()


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 3)], ids=["4x2", "8x1", "2x3"])
def test_sharding_rules_match_jax(models, shape):
    am, gen, (ams, gs) = models
    mesh = jax_make_mesh(shape[0] * shape[1], model_parallel=shape[1])
    sizes = {"data": shape[0], "model": shape[1]}
    split = 0
    for module, tree, prefix in ((am, ams, ""), (gen, gs, "trunk.")):
        specs = jax_rules(tree, mesh)
        ported = param_sharding_rules(module, sizes)
        params = dict(module.named_parameters())
        for path, arr in _flat(tree).items():
            name = _torch_name(path)
            name = prefix + name if prefix + name in params else name
            assert name in params, name
            leaf = path.rsplit("/", 1)[1]
            p = params[name]
            dim = split_dim(name, tuple(p.shape), sizes)
            assert _port_to_jax_axis(name, leaf, p.dim(), dim) == _jax_axis(path, specs), name
            placements = ported[name]
            assert len(placements) == 2 and placements[0].is_replicate()
            assert placements[1].is_shard(dim) if dim is not None else \
                placements[1].is_replicate()
            split += dim is not None
        assert len(ported) == len(_flat(tree))
    assert split > 0 if shape[1] > 1 else split == 0
    if shape == (2, 3):
        # the divisibility guard: 1024 FFN channels do not split in 3
        w1 = dict(am.named_parameters())["encoder.layers.0.pos_ffn.w_1.weight"]
        assert w1.shape[0] % 3 and split_dim("encoder.layers.0.pos_ffn.w_1.weight",
                                             tuple(w1.shape), sizes) is None
        assert split_dim("encoder.layers.0.slf_attn.w_q.weight", (384, 384), sizes) == 0


# --- the engine --------------------------------------------------------------------------------

TEXT = "xin chào việt nam hôm nay trời đẹp"
CHUNKS = ["xin chào bạn"] * 10
_ENGINES = {}


def _engines():
    """(JAX's engine on 8 devices, the port's on 8 replicas, the port's single
    engine), each on vie_tiny at batch 8."""
    if not _ENGINES:
        _ENGINES["e"] = (JaxEngine.from_checkpoint(VIE_TINY, serving_devices=8, batch_size=8),
                         SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu",
                                                         serving_devices=8, batch_size=8),
                         SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu", batch_size=8))
    return _ENGINES["e"]


def _within_one_lsb(a, b):
    assert a.dtype == b.dtype == np.int16 and a.shape == b.shape
    assert np.abs(a.astype(np.int64) - b.astype(np.int64)).mean() < 1.0


@pytest.mark.parametrize("text", [TEXT, CHUNKS], ids=["one_batch", "ten_chunks"])
def test_sharded_engine_matches_jax(text):
    jeng, peng, single = _engines()
    assert peng.batch_size == jeng.batch_size == 8
    assert peng._row_buckets == jeng._row_buckets
    assert peng.n_devices == jeng.serve_mesh.shape["data"] == 8
    got = peng.synthesize(text, silence_distance=0.1)
    _within_one_lsb(got, np.asarray(jeng.synthesize(text, silence_distance=0.1)))
    _within_one_lsb(got, single.synthesize(text, silence_distance=0.1))


@pytest.mark.parametrize("n", [2, 3, 5])
def test_serving_devices_round_like_jax(n):
    """The batch size and every row bucket round up to a multiple of the
    devices, as JAX's engine rounds them (its arithmetic, held here on the
    rounding alone)."""
    _, peng, _ = _engines()
    eng = SynthesisEngine(peng.config, peng.acoustic, peng.vocoder, peng.speakers, peng.stats,
                          device="cpu", serving_devices=n, batch_size=8)
    b = -(-8 // n) * n
    assert eng.batch_size == b
    assert eng._row_buckets == sorted({-(-max(1, b // 4) // n) * n, -(-max(1, b // 2) // n) * n, b})


def test_engine_mesh_refusals():
    """``global_mesh`` takes no partial count of devices (JAX's error), and
    in one process it serves alone."""
    _, peng, single = _engines()
    with pytest.raises(ValueError, match="global_mesh"):
        SynthesisEngine(peng.config, peng.acoustic, peng.vocoder, peng.speakers, peng.stats,
                        device="cpu", global_mesh=True, serving_devices=2)
    one = SynthesisEngine(peng.config, peng.acoustic, peng.vocoder, peng.speakers, peng.stats,
                          device="cpu", global_mesh=True, batch_size=8)
    assert one.n_devices == 1 and one._group is None
    np.testing.assert_array_equal(one.synthesize(TEXT), single.synthesize(TEXT))


def test_batching_server_takes_a_sharded_engine():
    _, peng, _ = _engines()
    with BatchingServer(peng) as srv:
        audio = srv.synthesize(TEXT, silence_distance=0.0)
    np.testing.assert_array_equal(audio, peng.synthesize(TEXT, silence_distance=0.0))
