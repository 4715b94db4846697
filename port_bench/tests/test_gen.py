"""The generators: the same seed gives the same inputs, and each meets its
mix file's stated distribution."""

from __future__ import annotations

import json
import os

import numpy as np

from port_bench import harness
from port_bench.gen import corpus, schedule, text
from port_bench.reference.serving_rules import request_sequences

BIG = 2 ** 31 + 12345


def _mix(name):
    with open(os.path.join(harness.HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def test_texts_repeat_per_seed_and_differ_across_seeds():
    mix = _mix("mixed_open")
    a, b = text.make_texts(mix, 50, BIG), text.make_texts(mix, 50, BIG)
    assert a == b and a != text.make_texts(mix, 50, BIG + 1)
    assert len(set(a)) == 50


def test_mixed_lengths_follow_the_lognormal_and_the_set_is_the_seeds_own():
    mix = _mix("mixed_open")
    n = 400
    texts = text.make_texts(mix, n, BIG)
    sizes = np.array([len(t) for t in texts])
    spec = mix["length"]
    # each text is cut at the last syllable that fits its drawn length
    assert sizes.min() >= spec["min"] - 7 and sizes.max() <= spec["max"]
    assert abs(np.median(sizes) - spec["median"]) <= 0.06 * spec["median"]
    assert abs(np.std(np.log(sizes)) - spec["sigma"]) < 0.08
    other = sorted(len(t) for t in text.make_texts(mix, n, BIG + 7))
    # the same drawn sizes, reordered: equal to within the syllable each is cut at
    assert np.abs(np.array(other) - np.sort(sizes)).max() <= 7
    assert all("," in t for t in texts if len(t) > 80)


def test_prompts_of_two_to_eight_syllables():
    mix = {"length": {"dist": "uniform", "unit": "syllables", "min": 2, "max": 8}, "speakers": 4}
    texts = text.make_texts(mix, 200, BIG)
    counts = [len(t.split()) for t in texts]
    assert min(counts) == 2 and max(counts) == 8
    assert text.speakers_of(mix, 200, BIG) == text.speakers_of(mix, 200, BIG)
    assert set(text.speakers_of(mix, 200, BIG)) == set(range(mix["speakers"]))


def test_documents_chunk_into_rows_of_the_engines_budget():
    mix = _mix("longform_closed")
    docs = text.make_texts(mix, 6, BIG)
    for d in docs:
        assert 1500 <= len(d) <= 4000
        rows = request_sequences(d)
        assert 5 <= len(rows) <= 15


def test_poisson_schedule_has_the_rate_and_repeats_per_seed():
    due = schedule.poisson_due_times(20.0, 30.0, BIG)
    assert len(due) == 600 and np.all(np.diff(due) >= 0) and due[0] == 0 and due[-1] < 30
    assert np.array_equal(due, schedule.poisson_due_times(20.0, 30.0, BIG))
    gaps = np.diff(due)
    assert abs(gaps.mean() - 1 / 20) < 0.005 and abs(gaps.std() / gaps.mean() - 1) < 0.15
    other = np.diff(schedule.poisson_due_times(20.0, 30.0, BIG + 1))
    assert not np.array_equal(gaps, other)
    # the same gaps on every seed, in another order (the first gap of each is
    # the one before its first arrival, left out of the differences)
    assert np.abs(np.sort(gaps)[:500] - np.sort(other)[:500]).max() < 0.02


def test_corpus_lengths_and_files(tmp_path):
    mix = dict(_mix("train_ljs_lengths"), utterances=64)
    with open(os.path.join(harness.HERE, "configs", "fs2_hifigan_v1.json")) as f:
        config = json.load(f)["config"]
    recs = corpus.write_workdir(str(tmp_path), mix, config, BIG)
    frames = np.array([r["frames"] for r in recs])
    assert frames.min() >= 86 and frames.max() <= 862
    assert abs(frames.mean() * 256 / 22050 - 6.5) < 0.3  # LJSpeech's mean, ~6.5 s
    again = corpus.write_workdir(str(tmp_path / "b"), mix, config, BIG)
    assert [r["phonemes"] for r in recs] == [r["phonemes"] for r in again]
    per = [r["frames"] / len(r["phonemes"]) for r in recs]
    assert 5.5 < np.mean(per) < 10.5
    mel = np.load(tmp_path / "corpus" / "mels" / f"{recs[0]['id']}.npy")
    assert mel.shape == (80, recs[0]["frames"])
    with open(tmp_path / "file_list.txt") as f:
        assert len(f.read().strip().splitlines()) == 64



def test_sliced_mix_deals_each_length_and_gap_stratum_over_every_slice():
    mix = _mix("mixed_open")
    m, spec = mix["slice_requests"], mix["length"]
    n = int(round(mix["rate"] * 51))
    k = -(-n // m)
    whole = n // k  # strata of k ranks; the last, of n % k, is shorter
    plain = text.lengths(spec, n, np.random.default_rng([BIG, 1]))
    for seed in (BIG, BIG + 1):
        for stream, values in ((1, text.lengths(spec, n, np.random.default_rng([seed, 1]), m)),
                               (3, np.diff(schedule.poisson_due_times(mix["rate"], 51.0, seed, m)))):
            slices = schedule.dealt_slices(n, m, np.random.default_rng([seed, stream]))
            order = np.concatenate(slices)
            assert np.array_equal(order, schedule.dealt(n, m, np.random.default_rng([seed, stream])))
            assert sorted(order) == list(range(n)) and len(slices) == k
            for ranks in slices:
                got = np.bincount(ranks // k, minlength=whole + 1)
                assert got[:whole].tolist() == [1] * whole and got[whole] <= 1
            # what the mix's requests get is the sorted values in that order
            if stream == 1:
                assert np.array_equal(values, np.sort(plain)[order])
            else:  # the gaps between arrivals: the first is the one before the window
                gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / mix["rate"]
                assert np.allclose(values, (gaps[order] * 51.0 / gaps.sum())[1:])
    a = text.lengths(spec, n, np.random.default_rng([BIG, 1]), m)
    b = text.lengths(spec, n, np.random.default_rng([BIG + 1, 1]), m)
    assert sorted(a) == sorted(b) == sorted(plain) and list(a) != list(b)


def test_fixed_slices_keep_their_gaps_beside_their_lengths_in_an_order_the_seed_draws():
    mix = _mix("mixed_open")
    m, fixed, spec = mix["slice_requests"], mix["slices_seed"], mix["length"]
    n = int(round(mix["rate"] * 51))
    ranks = [schedule.dealt(n, m, np.random.default_rng([fixed, s])) for s in (1, 3)]
    pairs = list(zip(*ranks))  # (length rank, gap rank) of each request, as the fixed seed deals
    blocks = {pairs[i]: pairs[i:i + m] for i in range(0, n, m)}  # by their first request

    def block_order(seed):
        got, i, order = list(zip(*(schedule.arranged(n, m, seed, s, fixed) for s in (1, 3)))), 0, []
        while i < n:
            block = blocks[got[i]]
            assert got[i:i + len(block)] == block
            order.append(got[i])
            i += len(block)
        return order

    a, b = block_order(BIG), block_order(BIG + 1)
    assert sorted(a) == sorted(blocks) == sorted(b) and a != b and a == block_order(BIG)
    order = schedule.arranged(n, m, BIG, 1, fixed)
    sizes = text.lengths(spec, n, None, order=order)
    texts = text.make_texts(mix, n, BIG)
    assert all(len(t) <= s for t, s in zip(texts, sizes)) and texts != text.make_texts(mix, n, BIG + 1)
    q = -np.log1p(-(np.arange(n) + 0.5) / n) / mix["rate"]
    due = schedule.poisson_due_times(mix["rate"], 51.0, BIG, m, fixed)
    assert np.allclose(np.diff(due), (q[schedule.arranged(n, m, BIG, 3, fixed)] * 51.0 / q.sum())[1:])
