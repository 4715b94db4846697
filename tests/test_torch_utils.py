"""The port's small utilities (``e2e_tts_tpu_torch/utils/profiling.py`` and
``utils/params.py``) against the JAX package's, on the CPU.

- ``measure_rtf`` on a stub, beside JAX's;
- ``get_param_num``, ``param_summary`` and ``show_params`` on the port's
  ``vie_tiny`` models equal to JAX's on the same bundle's variables: the
  totals, the top-level groups, and the deeper groups under ``convert.py``'s
  name map (the vocoder in its training form, whose weight norm keeps v and
  g as parameters, as JAX's tree does);
- ``engine_cache_stats`` after two text buckets, with JAX's keys;
- ``device_trace`` writing a Chrome trace on the CPU.
"""

import json
import os
import types

import numpy as np
import pytest

from _torch_one_thread import one_thread  # noqa: F401
from e2e_tts_tpu.utils import params as jparams
from e2e_tts_tpu.utils import profiling as jprofiling
from e2e_tts_tpu_torch.convert import convert, load_into
from e2e_tts_tpu_torch.models.vocoder import build_generator
from e2e_tts_tpu_torch.serve import SynthesisEngine
from e2e_tts_tpu_torch.serve.bundle import load_bundle
from e2e_tts_tpu_torch.utils import (device_trace, engine_cache_stats, get_param_num,
                                     measure_rtf, param_summary, show_params)

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIE_TINY = os.path.join(REPO, "assets", "bundles", "vie_tiny")


def test_measure_rtf_matches_jax():
    calls = []

    def fake_synthesize():
        calls.append(1)
        return np.zeros(22050, np.int16)

    rep = measure_rtf(fake_synthesize, warmup=1, runs=3)
    want = jprofiling.measure_rtf(fake_synthesize, warmup=1, runs=3)
    assert len(calls) == 8
    assert rep.audio_s == want.audio_s == 3.0 and rep.runs == want.runs == 3
    assert len(rep.per_run_s) == 3 and rep.rtf > 0
    assert abs(rep.rtf - rep.wall_s / rep.audio_s) < 1e-12


@pytest.fixture(scope="module")
def vie_tiny():
    engine = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    bundle = load_bundle(VIE_TINY)
    trainable = build_generator(bundle.config, bundle.vocoder_kind, train=True, device="cpu")
    load_into(trainable, bundle.vocoder_variables)
    return engine, trainable, bundle


def _groups_under_name_map(params, module, depth):
    """JAX's parameter tree grouped by the first ``depth`` parts of the names
    that ``convert`` gives its leaves in ``module``."""
    groups = {}
    for name, arr in convert({"params": params}, module.state_dict()).items():
        key = "/".join(name.split(".")[:depth])
        groups[key] = groups.get(key, 0) + arr.size
    return groups


@pytest.mark.parametrize("part", ["acoustic", "vocoder"])
def test_param_counts_match_jax(vie_tiny, part, capsys):
    engine, trainable, bundle = vie_tiny
    module = engine.acoustic if part == "acoustic" else trainable
    variables = bundle.acoustic_variables if part == "acoustic" else bundle.vocoder_variables
    params = variables["params"]
    total = jparams.get_param_num(params)
    assert get_param_num(module) == get_param_num(params) == total > 0
    assert param_summary(module) == jparams.param_summary(params)
    assert param_summary(params, depth=2) == jparams.param_summary(params, depth=2)
    assert param_summary(module, depth=2) == _groups_under_name_map(params, module, 2)
    assert show_params(module, max_rows=3) == total
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == f"[*] Parameter Size: {total}" and len(out) == 3 + 3


def test_engine_cache_stats_after_two_buckets():
    engine = SynthesisEngine.from_checkpoint(VIE_TINY, device="cpu")
    assert engine_cache_stats(engine) == {"stage1_programs": 0, "stage2_programs": 0,
                                          "total_compiled": 0}
    engine.synthesize("xin chào")
    engine.synthesize("xin chào việt nam " * 4)  # a larger text bucket
    engine.synthesize("xin chào")  # a bucket already run
    stats = engine_cache_stats(engine)
    want_keys = jprofiling.engine_cache_stats(types.SimpleNamespace(
        _stage1_cache={}, _stage2_cache={}, n_programs_compiled=0)).keys()
    assert stats.keys() == want_keys
    assert stats["stage1_programs"] == 2
    assert stats["stage2_programs"] == len(engine.stage2_shapes) >= 2
    assert stats["total_compiled"] == stats["stage1_programs"] + stats["stage2_programs"]
    engine.vocode_mel(np.zeros((10, 80), np.float32))
    assert engine_cache_stats(engine)["stage2_programs"] == stats["stage2_programs"] + 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
