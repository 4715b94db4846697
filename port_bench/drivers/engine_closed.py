"""Closed loop of one caller through ``SynthesisEngine.synthesize``: the
next document is sent when the last one's int16 array is back.  The mix
fixes the documents of a run (their lengths are the mix's, the seed draws
their order and words); the window runs documents until ``--seconds`` have
passed and ends when the last one returns, so its rate is every audio
second returned over every second of the window.  Set-up runs
``warmup_documents`` of the mix on another seed: the kernels' build, the
shapes this traffic uses and the engine's bucket estimator.
"""

from __future__ import annotations

import time

from ..gen.text import make_texts, speakers_of
from ..compare.serving import compare_requests
from . import serving
from .outcome import Outcome


def run(run) -> Outcome:
    mix, cfg = run.mix, run.config_file
    engine, wa, wv = serving.build_engine(cfg, run.seed, run.device)
    serving.warm_shapes(engine, mix["warm"])
    recorder = serving.Recorder(engine)
    silence = mix["silence_seconds"]
    warm_seed = run.seed + 7919
    n_warm = mix["warmup_documents"]
    for text, spk in zip(make_texts(mix, n_warm, warm_seed), speakers_of(mix, n_warm, warm_seed)):
        engine.synthesize(text, speaker_id=f"speaker_{spk}", silence_distance=silence)

    n = mix["documents"]
    texts, speakers = make_texts(mix, n, run.seed), speakers_of(mix, n, run.seed)
    recorder.clear()
    recorder.spans_on = run.trace
    audio, ok = [None] * n, [False] * n
    clock0 = run.begin_window()
    i = 0
    while i < n and time.perf_counter() - clock0 < run.seconds:
        audio[i] = engine.synthesize(texts[i], speaker_id=f"speaker_{speakers[i]}",
                                     silence_distance=silence)
        ok[i] = True
        i += 1
    run.end_window()
    recorder.spans_on = False
    if i == n:
        run.note(f"all {n} documents ran before {run.seconds} s: the mix needs more")
    sr = engine.sample_rate
    audio_s = sum(len(a) for a in audio[:i]) / sr
    host = recorder.to_host()
    recorder.remove()
    del engine
    run.note(f"documents {i}, audio {audio_s:.3f} s in {run.window_s:.3f} s")
    counters = serving.counters(host, cfg)

    def check(control=None):
        serving.free()
        return compare_requests(run, cfg, host, texts, speakers, audio, ok, wa, wv, silence,
                                control)

    return Outcome(metrics={"audio_s_per_s": audio_s / run.window_s}, attempted=i, failed=0,
                   counters=counters, spans=host["spans"], check=check)
