"""The port's data preparation (``e2e_tts_tpu_torch/data``, the f0 family of
``audio/features.py``, the native YIN) against the JAX package's, on the
CPU, on a synthetic corpus of 3 sentences x 2 speakers.

Bars: the corpus's wavs and ``metadata.csv`` byte-equal for one seed; file
lists, ``read_filelist`` entries and speaker maps equal; each f0 function
bit-equal to JAX's on the plain (NumPy) path; the port's native YIN within
1e-3 Hz of its plain version with the same voicing; features written by
``create_utterance_features(device="cpu")`` against JAX's: log-mel MAE
< 1e-4, energy max |diff| < 2e-2 (the port's mel bars,
``tests/test_torch_audio.py``), f0 and pitch equal, the same files;
``compute_stats`` equal on the same feature files; batches from JAX-written
features equal array for array (the beta-binomial prior within 1e-6: the
port's is one broadcast, JAX's a row loop); TextGrid durations, the NaN
filter, the MFA corpus and ``audio_prep.process_file`` equal.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from e2e_tts_tpu.audio import features as jax_features
from e2e_tts_tpu.config import default_config as jax_default_config
from e2e_tts_tpu.data import audio_prep as jax_audio_prep
from e2e_tts_tpu.data import dataset as jax_dataset
from e2e_tts_tpu.data import features as jax_data_features
from e2e_tts_tpu.data import filelist as jax_filelist
from e2e_tts_tpu.data import mfa as jax_mfa
from e2e_tts_tpu.data import synthetic as jax_synthetic
from e2e_tts_tpu_torch.audio import features, read_wav, write_wav
from e2e_tts_tpu_torch.config import default_config
from e2e_tts_tpu_torch.data import audio_prep, dataset, filelist, mfa, synthetic
from e2e_tts_tpu_torch.data import features as data_features
from e2e_tts_tpu_torch.native import native_yin_f0

MEL_MAE = 1e-4
ENERGY_MAX = 2e-2
PRIOR_TOL = 1e-6
NATIVE_HZ = 1e-3  # native YIN against its plain version, on voiced frames
SR = 22050
HOP = 256


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same corpus written by each package, and each package's features
    of it: (port root, JAX root)."""
    roots = {}
    for name, make in (("port", synthetic.make_synthetic_corpus),
                       ("jax", jax_synthetic.make_synthetic_corpus)):
        root = str(tmp_path_factory.mktemp(name))
        assert make(root, n_sentences=3, f0_jitter=0.1, seed=0) is not None
        roots[name] = root
    cfg, jcfg = default_config(), jax_default_config()
    for name in os.listdir(os.path.join(roots["port"], "wavs")):
        data_features.create_utterance_features(os.path.join(roots["port"], "wavs", name), cfg,
                                                device="cpu")
        jax_data_features.create_utterance_features(
            os.path.join(roots["jax"], "wavs", name), jcfg)
    return roots["port"], roots["jax"]


def _files(root, sub):
    return sorted(os.listdir(os.path.join(root, sub)))


def test_synthetic_corpus_byte_equal(corpora):
    port, jax_root = corpora
    assert _files(port, "wavs") == _files(jax_root, "wavs")
    assert len(_files(port, "wavs")) == 6
    for name in _files(port, "wavs") + ["../metadata.csv"]:
        with open(os.path.join(port, "wavs", name), "rb") as a, \
                open(os.path.join(jax_root, "wavs", name), "rb") as b:
            assert a.read() == b.read(), name
    assert synthetic.make_sentences(5, seed=3) == jax_synthetic.make_sentences(5, seed=3)


def test_filelists_and_speaker_maps_equal(corpora, tmp_path):
    _, root = corpora
    got, got_skipped = filelist.create_unsupervised_filelist([root], str(tmp_path / "p.txt"))
    want, want_skipped = jax_filelist.create_unsupervised_filelist([root], str(tmp_path / "j.txt"))
    assert got == want and got_skipped == want_skipped and len(got) == 6
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    entries = filelist.read_filelist(str(tmp_path / "p.txt"))
    assert entries == jax_filelist.read_filelist(str(tmp_path / "j.txt"))
    assert filelist.build_speaker_map(entries) == jax_filelist.build_speaker_map(entries) == {
        "nam": 0, "nu": 1}
    # supervised lists: metadata.lab + durations/
    corpus = tmp_path / "sup"
    (corpus / "durations").mkdir(parents=True)
    (corpus / "metadata.lab").write_text("a.wav|spk|A B C\nb.wav|spk|D E\n", encoding="utf8")
    (corpus / "durations" / "a.txt").write_text("3 4 5")
    (corpus / "durations" / "b.txt").write_text("6 7")
    assert filelist.create_supervised_filelist([str(corpus)], str(tmp_path / "ps.txt")) == \
        jax_filelist.create_supervised_filelist([str(corpus)], str(tmp_path / "js.txt"))
    (corpus / "durations" / "b.txt").write_text("6")
    with pytest.raises(ValueError, match="durations"):
        filelist.create_supervised_filelist([str(corpus)], str(tmp_path / "ps.txt"))


@pytest.fixture(scope="module")
def signal(corpora):
    audio, sr = read_wav(os.path.join(corpora[1], "wavs", "nu_001.wav"))
    return audio, sr


def test_f0_functions_bit_equal_jax_on_the_plain_path(signal):
    audio, sr = signal
    for kw in ({}, dict(fmin=71.0, fmax=800.0)):
        np.testing.assert_array_equal(features.yin_f0(audio, sr, HOP, use_native=False, **kw),
                                      jax_features.yin_f0(audio, sr, HOP, use_native=False, **kw))
    ac = features.ac_f0(audio, sr, HOP)
    np.testing.assert_array_equal(ac, jax_features.ac_f0(audio, sr, HOP))
    dio = features.dio_f0(audio, sr, HOP)
    np.testing.assert_array_equal(dio, jax_features.dio_f0(audio, sr, HOP))
    assert (dio > 0).any() and (ac > 0).any()
    np.testing.assert_array_equal(features.stonemask(audio, dio, sr, HOP),
                                  jax_features.stonemask(audio, dio, sr, HOP))
    mel_len = len(audio) // HOP + 1
    for backend in ("auto", "yin", "ac"):
        f0, coarse = features.extract_f0(audio, mel_len, sr, HOP, with_pitch=True,
                                         backend=backend)
        want, want_coarse = jax_features.extract_f0(audio, mel_len, sr, HOP, with_pitch=True,
                                                    backend=backend)
        np.testing.assert_array_equal(f0, want)
        np.testing.assert_array_equal(coarse, want_coarse)
        assert len(f0) == mel_len
    for backend in ("auto", "dio", "yin"):
        np.testing.assert_array_equal(features.extract_pitch(audio, sr, HOP, backend=backend),
                                      jax_features.extract_pitch(audio, sr, HOP, backend=backend))
    np.testing.assert_array_equal(features.f0_to_coarse(ac), jax_features.f0_to_coarse(ac))
    values = np.random.RandomState(0).standard_cauchy(500)
    np.testing.assert_array_equal(features.remove_outliers(values),
                                  jax_features.remove_outliers(values))


def test_reference_backends_raise_without_their_library(signal):
    audio, sr = signal
    with pytest.raises(ImportError, match="parselmouth"):
        features.extract_f0(audio, 10, sr, HOP, backend="praat")
    with pytest.raises(ImportError, match="pyworld"):
        features.extract_pitch(audio, sr, HOP, backend="pyworld")


def test_native_yin_against_its_plain_version(signal):
    audio, sr = signal
    t = np.arange(sr) / sr
    tone = 0.5 * np.sin(2 * np.pi * 196 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    for x in (audio, tone):
        native = features.yin_f0(x, sr, HOP)
        plain = features.yin_f0(x, sr, HOP, use_native=False)
        assert native.shape == plain.shape
        np.testing.assert_array_equal(native > 0, plain > 0)
        assert (native > 0).sum() > 10
        assert np.abs(native - plain).max() < NATIVE_HZ
    assert (native_yin_f0(np.zeros(SR, np.float32), SR, HOP) == 0).all()
    assert native_yin_f0(np.zeros(100, np.float32), SR, HOP).shape == (1,)


def test_native_yin_is_the_ports_own_library():
    from e2e_tts_tpu_torch.native import build

    path = build.lib_path("yin")
    assert path.startswith(os.path.dirname(build.__file__) + os.sep)
    assert os.path.exists(path)  # built by the tests above, from the port's yin.cc


def test_features_match_jax(corpora):
    port, jax_root = corpora
    for sub in data_features.FEATURE_DIRS:
        assert _files(port, sub) == _files(jax_root, sub) == [
            n.replace(".wav", ".npy") for n in _files(port, "wavs")]
    for name in _files(port, "wavs"):
        got = data_features.load_utterance_features(os.path.join(port, "wavs", name))
        want = jax_data_features.load_utterance_features(os.path.join(jax_root, "wavs", name))
        for k in data_features.FEATURE_DIRS:
            assert got[k].dtype == want[k].dtype == np.float32, k
            assert got[k].shape == want[k].shape, k
        assert np.abs(got["mels"] - want["mels"]).mean() < MEL_MAE
        assert np.abs(got["energy"] - want["energy"]).max() < ENERGY_MAX
        np.testing.assert_array_equal(got["f0"], want["f0"])
        np.testing.assert_array_equal(got["pitch"], want["pitch"])
    # the cache is read back, not recomputed, unless asked
    wav = os.path.join(port, "wavs", _files(port, "wavs")[0])
    again = data_features.create_utterance_features(wav, default_config(), device="cpu")
    np.testing.assert_array_equal(again["mels"], np.load(
        data_features.utterance_paths(wav)["mels"]))


def _entries(root, tmp):
    path = os.path.join(tmp, "list.txt")
    filelist.create_unsupervised_filelist([root], path)
    return filelist.read_filelist(path)


def test_compute_stats_equal_on_the_same_files(corpora, tmp_path):
    entries = _entries(corpora[1], str(tmp_path))
    got = data_features.compute_stats(entries)
    assert got == jax_data_features.compute_stats(entries)
    assert set(got) == {"pitch", "energy", "f0"}


def _datasets(root, tmp, **kw):
    entries = _entries(root, tmp)
    speakers = filelist.build_speaker_map(entries)
    stats = jax_data_features.compute_stats(entries)
    return (dataset.AcousticDataset(entries, speakers, stats, default_config(), **kw),
            jax_dataset.AcousticDataset(entries, speakers, stats, jax_default_config(), **kw))


FIELDS = ("speakers", "texts", "txt_lens", "word_ids", "mel", "mel_lens", "attn_prior",
          "duration_target", "f0", "uv", "pitch", "energy")


def _equal_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for name in FIELDS:
            a, b = getattr(g, name).numpy(), np.asarray(getattr(w, name))
            assert a.shape == b.shape, name
            if name == "attn_prior":
                assert np.abs(a - b).max() < PRIOR_TOL
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed,batch_size,drop_last,shuffle", [
    (0, 4, False, True), (1, 4, False, True), (0, 4, True, True), (1, 2, True, False)])
def test_acoustic_batches_equal_jax(corpora, tmp_path, seed, batch_size, drop_last, shuffle):
    port_ds, jax_ds = _datasets(corpora[1], str(tmp_path))
    kw = dict(shuffle=shuffle, seed=seed, drop_last=drop_last)
    got = list(dataset.make_acoustic_batches(port_ds, batch_size, device="cpu", **kw))
    want = list(jax_dataset.make_acoustic_batches(jax_ds, batch_size, **kw))
    _equal_batches(got, want)
    assert all(b.texts.dtype == torch.int64 and b.mel.dtype == torch.float32 for b in got)


def test_acoustic_batches_with_paths_and_prior_cache(corpora, tmp_path):
    port_ds, jax_ds = _datasets(corpora[1], str(tmp_path), prior_cache_dir=str(tmp_path / "pr"))
    got = list(dataset.make_acoustic_batches(port_ds, 4, seed=1, with_paths=True, device="cpu"))
    want = list(jax_dataset.make_acoustic_batches(jax_ds, 4, seed=1, with_paths=True))
    assert [p for _, p in got] == [p for _, p in want]
    _equal_batches([b for b, _ in got], [b for b, _ in want])
    assert os.listdir(tmp_path / "pr")  # the priors were cached, then read back
    again = list(dataset.make_acoustic_batches(port_ds, 4, seed=1, device="cpu"))
    _equal_batches(again, [b for b, _ in want])
    assert dataset.split_train_valid(port_ds.entries, 2) == jax_dataset.split_train_valid(
        port_ds.entries, 2)
    for counts, n in (([2, 3, 1], 6), ([2, 1], 5), ([], 3)):
        np.testing.assert_array_equal(dataset.boundaries_to_word_ids(counts, n),
                                      jax_dataset.boundaries_to_word_ids(counts, n))


@pytest.mark.parametrize("batch_size,seed,segment", [(4, 0, 8192), (16, 1, 8192), (2, 2, 2048)])
def test_vocoder_batches_equal_jax(corpora, tmp_path, batch_size, seed, segment):
    """Batch 16 over 6 utterances: a corpus smaller than half a batch."""
    entries = _entries(corpora[1], str(tmp_path))
    port_ds = dataset.VocoderDataset(entries, default_config(), segment_size=segment)
    jax_ds = jax_dataset.VocoderDataset(entries, jax_default_config(), segment_size=segment)
    got = list(dataset.make_vocoder_batches(port_ds, batch_size, seed=seed, device="cpu"))
    want = list(jax_dataset.make_vocoder_batches(jax_ds, batch_size, seed=seed))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mel.numpy(), w.mel)
        np.testing.assert_array_equal(g.audio.numpy(), w.audio)
        assert g.mel.shape == (batch_size, segment // HOP, 80)


def test_vocoder_dataset_skips_missing_predicted_mels(corpora, tmp_path):
    entries = _entries(corpora[1], str(tmp_path))
    root = corpora[1]
    os.makedirs(os.path.join(root, "mels_pred"), exist_ok=True)
    shutil.copy(os.path.join(root, "mels", "nu_000.npy"), os.path.join(root, "mels_pred"))
    with pytest.warns(UserWarning, match="mels_pred"):
        ds = dataset.VocoderDataset(entries, default_config(), mel_dir="mels_pred")
    assert [e[0] for e in ds.entries] == [e[0] for e in entries if e[0].endswith("nu_000.wav")]
    with pytest.raises(ValueError, match="empty"):
        dataset.make_vocoder_batches(dataset.VocoderDataset([], default_config()), 2,
                                     device="cpu")


TEXTGRID = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 0.7
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 0.7
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = 0.7
            text = "xin"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 0.7
        intervals: size = 4
        intervals [1]:
            xmin = 0
            xmax = 0.113
            text = ""
        intervals [2]:
            xmin = 0.113
            xmax = 0.29
            text = "X"
        intervals [3]:
            xmin = 0.29
            xmax = 0.571
            text = "IN_0"
        intervals [4]:
            xmin = 0.571
            xmax = 0.7
            text = ""
'''


def test_textgrid_durations_and_nan_filter(corpora, tmp_path):
    path = tmp_path / "utt.TextGrid"
    path.write_text(TEXTGRID, encoding="utf8")
    assert mfa.parse_textgrid(str(path)) == jax_mfa.parse_textgrid(str(path))
    assert len(mfa.parse_textgrid(str(path), tier="words")) == 1
    for mel_len in (60, 61, 57):
        labels, durs = mfa.textgrid_to_durations(str(path), mel_len)
        want_labels, want_durs = jax_mfa.textgrid_to_durations(str(path), mel_len)
        assert labels == want_labels == ["<SILENT>", "X", "IN_0", "<SILENT>"]
        np.testing.assert_array_equal(durs, want_durs)
        assert durs.sum() == mel_len
    with pytest.raises(ValueError, match="tier"):
        mfa.parse_textgrid(str(path), tier="syllables")

    root = str(tmp_path / "nan")
    shutil.copytree(corpora[1], root)
    entries = _entries(root, str(tmp_path))
    pitch = np.load(os.path.join(root, "pitch", "nam_001.npy"))
    pitch[3] = np.nan
    np.save(os.path.join(root, "pitch", "nam_001.npy"), pitch)
    os.remove(os.path.join(root, "energy", "nu_002.npy"))
    kept, dropped = mfa.filter_nan_utterances(entries)
    assert (kept, dropped) == jax_mfa.filter_nan_utterances(entries)
    assert sorted(os.path.basename(e[0]) for e in dropped) == ["nam_001.wav", "nu_002.wav"]


def test_mfa_corpus_equal_jax(corpora, tmp_path):
    root = corpora[1]
    meta = os.path.join(root, "metadata.csv")
    wavs = os.path.join(root, "wavs")
    mfa.build_mfa_corpus(meta, wavs, str(tmp_path / "p"))
    jax_mfa.build_mfa_corpus(meta, wavs, str(tmp_path / "j"))
    for dirpath, _, names in os.walk(tmp_path / "j"):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name), tmp_path / "j")
            assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
    assert (tmp_path / "p" / "lexicon.txt").read_text(encoding="utf8").count("\n") > 10


def test_audio_prep_equal_jax(tmp_path):
    """A 44.1 kHz stereo wav with silence around a tone: mono, 22.05 kHz,
    -20 dBFS, trimmed; the two packages' files byte-equal."""
    sr = 44100
    rng = np.random.RandomState(0)
    t = np.arange(sr) / sr
    tone = 0.3 * np.sin(2 * np.pi * 220 * t)
    left = np.concatenate([np.zeros(sr // 2), tone, np.zeros(sr // 3)])
    stereo = np.stack([left, 0.5 * left + 0.001 * rng.randn(len(left))], axis=1)
    write_wav(str(tmp_path / "in.wav"), stereo.astype(np.float32), sr)
    audio_prep.process_file(str(tmp_path / "in.wav"), str(tmp_path / "p" / "out.wav"))
    jax_audio_prep.process_file(str(tmp_path / "in.wav"), str(tmp_path / "j" / "out.wav"))
    assert (tmp_path / "p" / "out.wav").read_bytes() == (tmp_path / "j" / "out.wav").read_bytes()
    out, out_sr = read_wav(str(tmp_path / "p" / "out.wav"))
    assert out_sr == 22050 and out.ndim == 1 and len(out) < 1.3 * 22050
    audio_prep.main(["--input-dir", str(tmp_path), "--output-dir", str(tmp_path / "m"),
                     "--no-trim"])
    assert os.listdir(tmp_path / "m") == ["in.wav"]
    x = rng.randn(1000).astype(np.float32)
    for fn in ("to_mono", "normalize_loudness"):
        np.testing.assert_array_equal(getattr(audio_prep, fn)(x),
                                      getattr(jax_audio_prep, fn)(x))
    np.testing.assert_array_equal(audio_prep.resample(x, 44100, 16000),
                                  jax_audio_prep.resample(x, 44100, 16000))

