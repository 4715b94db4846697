"""The harness's checks on the CPU: what the benchmark imports, the names
and units of ``BENCHMARK.json``, that every name resolves to its file, that
a new mix and a new metric resolve as new files, that a run without a card
fails, and whole runs of a narrow copy of the cells, sound and with the
faults ``correct`` has to catch."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny

PB = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), encoding="utf8") as f:
        return json.load(f)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.JAX_NAMES), (path, tops & set(harness.JAX_NAMES))


def test_the_reference_imports_nothing_of_the_port():
    paths = list(_sources("reference"))
    assert os.path.join(PB, "reference", "blocks", "conformer.py") in paths  # the families too
    for path in paths:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "e2e_tts_tpu_torch" not in tops, path


def test_jax_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "e2e_tts_tpu_torch_fake", object())
    assert "e2e_tts_tpu_torch_fake" not in harness.jax_modules()
    monkeypatch.setitem(sys.modules, "e2e_tts_tpu.fake", object())
    assert harness.jax_modules() == ["e2e_tts_tpu"]


def test_names_and_units_use_the_allowed_characters():
    b = _bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in b["configs"]] + [w["why"] for w in b["workloads"]]
                 + [m["layer"] for m in b["per_layer"]] + b["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == len(
        b["end_to_end"] + b["per_layer"])


def test_every_cell_resolves_to_its_files():
    b = _bench()
    for w in b["workloads"]:
        p = harness.plan(b, w["name"])
        assert p.limits, f"no limits for {w['name']}"
        assert {m["name"] for m in p.per_layer} and p.end_to_end
        for path in p.readers.values():
            assert callable(harness.load_reader(path))


def test_a_new_mix_and_a_new_metric_resolve_as_new_files():
    b = _bench()
    mix_path = os.path.join(PB, "traffic", "zz_test_mix.json")
    metric_path = os.path.join(PB, "metrics", "zz_test_metric.py")
    before = {p: os.path.getmtime(p) for p in _sources()}
    try:
        with open(mix_path, "w") as f:
            json.dump({"driver": "queue_open", "rate": 1.0}, f)
        with open(metric_path, "w") as f:
            f.write("def read(rec):\n    return 42.0\n")
        b["workloads"].append({"name": "zz_cell", "config": "fs2_hifigan_v1",
                               "traffic": "zz_test_mix", "chips": 1, "why": "test"})
        b["per_layer"].append({"name": "zz_test_metric.open", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "request_p95_s", "workloads": ["zz_cell"]})
        b["end_to_end"][0]["workloads"].append("zz_cell")
        p = harness.plan(b, "zz_cell")
        assert p.driver == "queue_open" and p.mix["rate"] == 1.0
        assert harness.load_reader(p.readers["zz_test_metric.open"])({}) == 42.0
    finally:
        os.remove(mix_path)
        os.remove(metric_path)
    assert before == {p: os.path.getmtime(p) for p in _sources()}


def test_a_block_family_without_its_files_fails_in_the_plan(tmp_path):
    bench = tiny.tiny_bench(str(tmp_path), "vie_train_acoustic", "fs2_hifigan_v1",
                            "train_ljs_lengths", block_type="reformer")
    with pytest.raises(FileNotFoundError) as e:
        harness.plan(bench, "vie_train_acoustic")
    for sub in ("reference", "counts"):
        assert os.path.join(PB, sub, "blocks", "reformer.py") in str(e.value)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "vie_mixed_open",
                        "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


# --- whole runs on the CPU, at a narrow width -------------------------------------------

SERVING_LIMITS = {"unmatched_rows": 0, "logd_gap": 1e-4, "pitch_gap": 1e-4, "energy_gap": 1e-4,
                  "wave_lsb": 2}
TRAINING_LIMITS = {"batch_mismatch": 0, "batch_gap": 1e-6, "mas_rows_differ": 0,
                   "loss_gap": 1e-5, "grad_gap": 1e-3, "update_gap": 1e-2}


def _run(tmp_path, monkeypatch, workload, config, traffic, mix, limits, trace=0,
         block_type=None):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    torch.set_num_threads(2)
    bench = tiny.tiny_bench(str(tmp_path), workload, config, traffic, block_type)
    p = harness.plan(bench, workload)
    p.mix = dict(p.mix, **mix)
    p.limits = limits
    return harness.execute(tiny.args(workload, seed=2 ** 31 + 9, seconds=1.0, trace=trace),
                           torch.device("cpu"), time.perf_counter(), bench, p)


TINY_WARM = dict(stage1_rows=[2], text_buckets=[32], stage2_rows=[1, 2], mel_max=256)


def _serve(tmp_path, monkeypatch, trace=0):
    return _run(tmp_path, monkeypatch, "vie_mixed_open", "fs2_hifigan_v1", "mixed_open",
                dict(rate=4.0, warmup_seconds=0.5, check_requests=3, warm=TINY_WARM),
                SERVING_LIMITS, trace)


def _train(tmp_path, monkeypatch, block_type=None):
    return _run(tmp_path, monkeypatch, "vie_train_acoustic", "fs2_hifigan_v1",
                "train_ljs_lengths", dict(utterances=72, seconds_range=[0.3, 1.0]),
                TRAINING_LIMITS, block_type=block_type)


def _narrate(tmp_path, monkeypatch, block_type=None):
    return _run(tmp_path, monkeypatch, "vie_longform_closed", "fs2_istftnet_c8c8i",
                "longform_closed", dict(documents=6, warmup_documents=1, check_requests=2,
                                        length=dict(dist="uniform", unit="chars", min=120,
                                                    max=300), warm=TINY_WARM),
                SERVING_LIMITS, block_type=block_type)


def test_serving_run_is_correct_and_reports_its_metrics(tmp_path, monkeypatch):
    r = _serve(tmp_path, monkeypatch)
    assert r["correct"], r["check"]
    assert r["attempted"] == 4 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "request_p95_s"}
    assert list(r)[-1] == "check"


def test_traced_serving_run_writes_no_device_metric_from_the_cpu(tmp_path, monkeypatch):
    r = _serve(tmp_path, monkeypatch, trace=1)
    assert r["correct"], r["check"]
    layer = {m["name"]: m for m in _bench()["per_layer"]}
    assert r["metrics"] and all(layer[n]["source"] != "device_trace" for n in r["metrics"])
    assert "busy_s" not in r["device"]


def test_an_answer_altered_where_it_is_made_is_not_correct(tmp_path, monkeypatch):
    from e2e_tts_tpu_torch.nn.hifigan import HifiGanGenerator

    generate = HifiGanGenerator.generate

    def altered(self, mel):
        audio = generate(self, mel).clone()
        audio[:, 100] += 0.05
        return audio

    monkeypatch.setattr(HifiGanGenerator, "generate", altered)
    r = _serve(tmp_path, monkeypatch)
    assert not r["correct"] and r["check"]["wave_lsb"]["value"] > SERVING_LIMITS["wave_lsb"]


def test_training_run_is_correct(tmp_path, monkeypatch):
    r = _train(tmp_path, monkeypatch)
    assert r["correct"], r["check"]
    assert set(r["metrics"]) == {"setup_s", "train_utt_per_s"}


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tmp_path, monkeypatch):
    from e2e_tts_tpu_torch.train.optim import ScheduledAdam

    def unchanged(self, params, grads, state, model_group=None):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))

    monkeypatch.setattr(ScheduledAdam, "apply", unchanged)
    r = _train(tmp_path, monkeypatch)
    assert not r["correct"] and r["check"]["update_gap"]["value"] > TRAINING_LIMITS["update_gap"]


def test_a_fault_that_acts_only_in_the_window_is_not_correct(tmp_path, monkeypatch):
    from e2e_tts_tpu_torch.train.optim import ScheduledAdam

    apply = ScheduledAdam.apply

    def late(self, params, grads, state, model_group=None):  # unchanged after the first epoch
        if state.count < 3:
            return apply(self, params, grads, state, model_group)
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))

    monkeypatch.setattr(ScheduledAdam, "apply", late)
    r = _train(tmp_path, monkeypatch)
    assert not r["correct"] and r["check"]["update_gap"]["value"] > TRAINING_LIMITS["update_gap"]


def test_the_knee_is_where_the_median_wait_passes_a_requests_own_time():
    from port_bench.sweep import knee

    def row(rate, p50, done=10):
        return dict(rate=rate, requests=10, done=done, p50_s=p50)

    assert knee([row(8, 0.12), row(4, 0.10), row(12, 0.19), row(16, 0.21), row(20, 0.15)]) \
        == (12, 0.10)
    assert knee([row(4, 0.1), row(8, 0.1, done=9)]) == (4, 0.1)


def test_half_the_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    from e2e_tts_tpu_torch.train import acoustic_step

    losses = acoustic_step._losses

    def half(model, config, batch, *a, **k):
        rows = batch.speakers.shape[0] // 2
        return losses(model, config, acoustic_step.AcousticBatch(*(t[:rows] for t in batch)),
                      *a, **k)

    monkeypatch.setattr(acoustic_step, "_losses", half)
    r = _train(tmp_path, monkeypatch)
    assert not r["correct"] and r["check"]["loss_gap"]["value"] > TRAINING_LIMITS["loss_gap"]


# --- a second block family through the same drivers and checks ----------------------------


def test_a_conformer_narration_run_is_correct(tmp_path, monkeypatch):
    r = _narrate(tmp_path, monkeypatch, "conformer")
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and set(r["metrics"]) == {"setup_s", "audio_s_per_s"}


def test_a_conformer_training_run_is_correct(tmp_path, monkeypatch):
    r = _train(tmp_path, monkeypatch, "conformer")
    assert r["correct"], r["check"]
    assert set(r["metrics"]) == {"setup_s", "train_utt_per_s"}


def test_a_conformer_weight_altered_in_the_program_is_not_correct(tmp_path, monkeypatch):
    from port_bench.drivers import serving

    build = serving.build_engine

    def altered(*a, **k):
        engine, wa, wv = build(*a, **k)
        with torch.no_grad():  # the program's relative-position bias, not the benchmark's
            engine.acoustic.encoder.layers[0].mhsa.v_bias.add_(0.5)
        return engine, wa, wv

    monkeypatch.setattr(serving, "build_engine", altered)
    r = _narrate(tmp_path, monkeypatch, "conformer")
    assert not r["correct"]
    assert r["check"]["logd_gap"]["value"] > SERVING_LIMITS["logd_gap"], r["check"]


def test_the_flash_counters_stay_off_for_a_family_that_does_not_launch_it():
    from port_bench.drivers import serving

    tokens = torch.zeros(1, 300, dtype=torch.int64)
    tokens[0, :280] = 7
    host = {"records": [{"tokens": tokens, "log_d": torch.full((1, 300), 1.0), "T": 512,
                         "mel_lens": torch.tensor([500])}],
            "rerenders": [(1, 1024, torch.tensor([900]))]}
    counts = {}
    for block_type in ("transformer", "conformer"):
        cfg = tiny.tiny_config("fs2_hifigan_v1", block_type)
        counts[block_type] = serving.counters(host, cfg)
    assert counts["transformer"]["flash_flops"] > 0 and counts["transformer"]["flash_calls"] == 6
    assert counts["conformer"]["flash_flops"] == counts["conformer"]["flash_bytes"] == 0
    assert counts["conformer"]["model_flops"] > 0


# --- set-up ----------------------------------------------------------------------------


@pytest.mark.parametrize("calls", [1, 2])
def test_the_warm_sweep_runs_each_shape_as_many_times_as_the_mix_asks(calls):
    from port_bench.drivers import serving

    engine, _, _ = serving.build_engine(tiny.tiny_config(), 3, torch.device("cpu"))
    seen = {"encoder": [], "vocoder": []}
    for name, module in (("encoder", engine.acoustic.encoder), ("vocoder", engine.vocoder)):
        module.register_forward_hook(lambda m, a, o, name=name: seen[name].append(a[0].shape))
    serving.warm_shapes(engine, dict(TINY_WARM, calls=calls))
    assert seen["encoder"] == [torch.Size([2, 32])] * calls
    assert sorted(seen["vocoder"]) == sorted([torch.Size([b, t, 80]) for b in (1, 2)
                                              for t in (128, 256)] * calls)


def test_the_open_mix_captures_its_graphs_in_set_up():
    with open(os.path.join(PB, "traffic", "mixed_open.json"), encoding="utf8") as f:
        warm = json.load(f)["warm"]
    assert warm["calls"] >= 2  # a serving module's graph is captured at a shape's second call
