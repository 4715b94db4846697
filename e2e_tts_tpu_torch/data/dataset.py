"""Datasets and bucketed batch iterators (port of
``e2e_tts_tpu/data/dataset.py``): host-side NumPy, batches handed to the
device as the port's ``AcousticBatch`` / ``VocoderBatch``.

Every batch pads (text, mel) to one of a small set of bucket sizes, the
JAX package's, and the batchers draw from ``np.random.RandomState`` as it
does, so the order, the buckets and the vocoder crops equal the JAX
package's batch for batch.  The batchers take ``device=`` (CUDA unless the
caller passes another; ``device=None`` without CUDA raises when the batcher
is made, before any batch).  The acoustic batcher's work is traced
(``utils/tracing``): ``data.batch`` from resuming the batcher to its next
batch, and inside it ``data.load`` (an utterance's features),
``data.collate`` (padding and the prior) with ``data.prior``, and
``data.copy`` (``AcousticBatch.from_numpy``).

Deviation from the reference noted: the reference computes the UV mask from
*normalized* f0 == 0 (utils.py:172-173), which is only correct when the mean
is 0; here UV comes from raw f0 == 0 before normalization.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..audio.features import beta_binomial_prior
from ..config import Config
from ..device import resolve_device
from ..text import phonemes_to_sequence
from ..train.acoustic_step import AcousticBatch
from ..train.vocoder_step import VocoderBatch
from ..utils import tracing
from .features import load_utterance_features

TEXT_BUCKETS = (32, 64, 96, 128, 192, 256)
MEL_BUCKETS = (128, 256, 384, 512, 640, 768, 896, 1024)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def boundaries_to_word_ids(boundaries: Sequence[int], n_phonemes: int) -> np.ndarray:
    """Per-word phoneme counts -> word index per phoneme."""
    ids = np.zeros(n_phonemes, np.int32)
    pos = 0
    for w, count in enumerate(boundaries):
        ids[pos : pos + count] = w
        pos += count
    if pos < n_phonemes:
        ids[pos:] = max(len(boundaries) - 1, 0)
    return ids


@dataclass
class Utterance:
    text_ids: np.ndarray      # (L,)
    word_ids: np.ndarray      # (L,)
    speaker: int
    mel: np.ndarray           # (T, n_mels)
    f0: np.ndarray            # (T,)
    uv: np.ndarray            # (T,)
    pitch: np.ndarray         # (T,)
    energy: np.ndarray        # (T,)
    durations: Optional[np.ndarray]  # (L,) supervised mode
    wav_path: str


class AcousticDataset:
    """Loads cached features per utterance and normalizes prosody targets."""

    def __init__(
        self,
        entries,                      # from filelist.read_filelist
        speaker_map: Dict[str, int],
        stats: Dict[str, Dict[str, float]],
        config: Config,
        supervised: bool = False,
        prior_cache_dir: Optional[str] = None,
        symbol_table: Optional[Dict[str, int]] = None,
    ):
        self.entries = entries
        self.speaker_map = speaker_map
        self.stats = stats
        self.config = config
        self.supervised = supervised
        self.prior_cache_dir = prior_cache_dir
        self.symbol_table = symbol_table  # None -> default VN inventory
        self.max_seq_len = config.models.fastspeech2.max_seq_len

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Utterance:
        wav, speaker, phonemes, tail = self.entries[i]
        feats = load_utterance_features(wav)
        mel = feats["mels"].T  # (T, n_mels)
        T = mel.shape[0]

        text_ids = np.asarray(
            phonemes_to_sequence(phonemes, table=self.symbol_table), np.int32
        )
        L = len(text_ids)

        if self.supervised:
            durations = np.asarray(tail, np.float32)
            word_ids = np.arange(L, dtype=np.int32)
        else:
            durations = None
            word_ids = boundaries_to_word_ids(tail, L)

        f0_raw = feats["f0"][:T]
        uv = (f0_raw == 0).astype(np.float32)
        s = self.stats
        f0 = np.where(
            f0_raw > 0, (f0_raw - s["f0"]["mean"]) / s["f0"]["std"], 0.0
        ).astype(np.float32)
        pitch = ((feats["pitch"][:T] - s["pitch"]["mean"]) / s["pitch"]["std"]).astype(
            np.float32
        )
        energy = (
            (feats["energy"][:T] - s["energy"]["mean"]) / s["energy"]["std"]
        ).astype(np.float32)

        return Utterance(
            text_ids=text_ids,
            word_ids=word_ids,
            speaker=self.speaker_map[speaker],
            mel=mel.astype(np.float32),
            f0=f0,
            uv=uv,
            pitch=pitch,
            energy=energy,
            durations=durations,
            wav_path=wav,
        )

    def attn_prior(self, n_phonemes: int, mel_len: int) -> np.ndarray:
        if self.prior_cache_dir:
            os.makedirs(self.prior_cache_dir, exist_ok=True)
            path = os.path.join(self.prior_cache_dir, f"{n_phonemes}_{mel_len}.npy")
            if os.path.exists(path):
                return np.load(path)
            prior = beta_binomial_prior(n_phonemes, mel_len).astype(np.float32)
            np.save(path, prior)
            return prior
        return beta_binomial_prior(n_phonemes, mel_len).astype(np.float32)


def split_train_valid(entries, n_valid: int = 50, seed: int = 1234):
    """Shuffle then hold out the tail for validation
    (reference dataloader.py:19-40 keeps the last 50)."""
    rng = np.random.RandomState(seed)
    entries = list(entries)
    rng.shuffle(entries)
    n_valid = min(n_valid, max(1, len(entries) // 10))
    return entries[:-n_valid], entries[-n_valid:]


def make_acoustic_batches(
    dataset: AcousticDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = False,
    with_paths: bool = False,
    device=None,
) -> Iterator[AcousticBatch]:
    """Yield fixed-shape ``AcousticBatch``es on ``device``, grouped by (text,
    mel) bucket.

    With ``with_paths``, yields (batch, [wav_path per row]) so offline jobs
    (e.g. predicted-mel generation) can map rows back to utterances.
    """
    if len(dataset) == 0:
        raise ValueError(
            "make_acoustic_batches: empty dataset (no training utterances)"
        )
    device = resolve_device(device)
    return _acoustic_batches(dataset, batch_size, shuffle, seed, drop_last, with_paths, device)


def _acoustic_batches(dataset, batch_size, shuffle, seed, drop_last, with_paths, device):
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)

    n_mels = dataset.config.audio.mel.channels

    def emit(utts, key):
        if len(utts) < batch_size:
            # fill the partial tail by cycling real utterances rather than
            # fabricating dummy rows (txt_lens=1 zero-mel rows would feed
            # invented targets into every epoch-tail gradient)
            utts = [utts[i % len(utts)] for i in range(batch_size)]
        with tracing.span("data.collate"):
            arrays = _collate(utts, key, batch_size, n_mels, dataset)
        batch = AcousticBatch.from_numpy(arrays, device)
        if with_paths:
            return batch, [u.wav_path for u in utts]
        return batch

    def begin():  # closed before each yield, so that it holds no consumer's time
        return tracing.start("data.batch", batch=tracing.new_id() if tracing.enabled() else None)

    groups: Dict[Tuple[int, int], List[Utterance]] = {}
    made = begin()
    for i in order:
        with tracing.span("data.load"):
            utt = dataset[int(i)]
        if (
            len(utt.text_ids) > min(dataset.max_seq_len, TEXT_BUCKETS[-1])
            or utt.mel.shape[0] > MEL_BUCKETS[-1]
        ):
            # beyond the largest collate bucket: _collate would overflow
            continue
        key = (_bucket(len(utt.text_ids), TEXT_BUCKETS), _bucket(utt.mel.shape[0], MEL_BUCKETS))
        groups.setdefault(key, []).append(utt)
        if len(groups[key]) == batch_size:
            batch = emit(groups.pop(key), key)
            made.close()
            yield batch
            made = begin()

    if not drop_last:
        for key, utts in groups.items():
            batch = emit(utts, key)
            made.close()
            yield batch
            made = begin()
    made.close()


def _collate(
    utts: List[Utterance],
    key: Tuple[int, int],
    batch_size: int,
    n_mels: int,
    dataset: AcousticDataset,
) -> List[np.ndarray]:
    """The 12 numpy arrays of one batch, in ``AcousticBatch``'s order."""
    L, T = key
    B = batch_size
    speakers = np.zeros(B, np.int32)
    texts = np.zeros((B, L), np.int32)
    txt_lens = np.ones(B, np.int32)
    word_ids = np.zeros((B, L), np.int32)
    mel = np.zeros((B, T, n_mels), np.float32)
    mel_lens = np.ones(B, np.int32)
    attn_prior = np.zeros((B, T, L), np.float32)
    duration_target = np.zeros((B, L), np.float32)
    f0, uv, pitch, energy = (np.zeros((B, T), np.float32) for _ in range(4))
    for row, u in enumerate(utts):
        l, t = len(u.text_ids), u.mel.shape[0]
        speakers[row] = u.speaker
        texts[row, :l] = u.text_ids
        txt_lens[row] = l
        word_ids[row, :l] = u.word_ids
        mel[row, :t] = u.mel
        mel_lens[row] = t
        f0[row, :t] = u.f0[:t]
        uv[row, :t] = u.uv[:t]
        pitch[row, :t] = u.pitch[:t]
        energy[row, :t] = u.energy[:t]
        if u.durations is not None:
            duration_target[row, :l] = u.durations[:l]
        else:
            with tracing.span("data.prior"):
                attn_prior[row, :t, :l] = dataset.attn_prior(l, t)
    return [speakers, texts, txt_lens, word_ids, mel, mel_lens, attn_prior, duration_target,
            f0, uv, pitch, energy]


class VocoderDataset:
    """(mel, audio) segment pairs for GAN training
    (reference MelAudioLoader, dataloader.py:330-396)."""

    def __init__(
        self,
        entries,
        config: Config,
        segment_size: int = 8192,
        mel_dir: str = "mels",
    ):
        self.config = config
        self.segment_size = segment_size
        self.hop = config.audio.stft.hop_length
        self.seg_frames = segment_size // self.hop
        self.mel_dir = mel_dir
        if mel_dir != "mels":
            # predicted mels are only written for utterances that fit the
            # acoustic collate buckets (generate-mels skips the rest);
            # drop entries whose file is absent instead of crashing
            import warnings

            kept = [e for e in entries if os.path.exists(self._mel_path(e[0]))]
            if len(kept) < len(entries):
                warnings.warn(
                    f"VocoderDataset: {len(entries) - len(kept)} utterances "
                    f"have no {mel_dir} file; skipping them"
                )
            entries = kept
        self.entries = entries

    def __len__(self):
        return len(self.entries)

    def _mel_path(self, wav_path: str) -> str:
        base = os.path.splitext(os.path.basename(wav_path))[0]
        root = os.path.dirname(os.path.dirname(wav_path))
        return os.path.join(root, self.mel_dir, f"{base}.npy")

    def __getitem__(self, i: int):
        from ..audio.wav import read_wav

        wav_path = self.entries[i][0]
        audio, _ = read_wav(wav_path)
        mel = np.load(self._mel_path(wav_path)).T  # (T, n_mels)
        return audio, mel


def make_vocoder_batches(
    dataset: VocoderDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    device=None,
) -> Iterator[VocoderBatch]:
    """Yield ``VocoderBatch``es of ``batch_size`` aligned (mel, audio)
    segments on ``device``, each at a random start drawn from the batcher's
    ``RandomState(seed)``."""
    if len(dataset) == 0:
        raise ValueError(
            "make_vocoder_batches: empty dataset (no training utterances)"
        )
    device = resolve_device(device)
    return _vocoder_batches(dataset, batch_size, shuffle, seed, device)


def _vocoder_batches(dataset, batch_size, shuffle, seed, device):
    order = np.arange(len(dataset))
    rng = np.random.RandomState(seed)
    if shuffle:
        rng.shuffle(order)
    # fill the epoch tail with real utterances (cycled) so a corpus smaller
    # than batch_size still yields one full fixed-shape batch per epoch;
    # without it a tiny corpus yields no batch and an epoch loop spins
    tail = (-len(order)) % batch_size
    if tail:
        # np.resize repeats the (shuffled) order cyclically, so this also
        # covers corpora smaller than HALF the batch (a 7-utterance corpus
        # at batch 16 needs 2.3 cycles)
        order = np.resize(order, len(order) + tail)

    seg, seg_frames, hop = dataset.segment_size, dataset.seg_frames, dataset.hop
    buf_mel, buf_audio = [], []
    for i in order:
        audio, mel = dataset[int(i)]
        T = min(mel.shape[0], len(audio) // hop)
        if T >= seg_frames:
            start = rng.randint(0, T - seg_frames + 1)
        else:
            mel = np.pad(mel, ((0, seg_frames - T), (0, 0)))
            audio = np.pad(audio, (0, seg * 2))
            start = 0
        buf_mel.append(mel[start : start + seg_frames])
        buf_audio.append(audio[start * hop : start * hop + seg])
        if len(buf_mel) == batch_size:
            yield VocoderBatch.from_numpy(
                (np.stack(buf_mel).astype(np.float32), np.stack(buf_audio).astype(np.float32)),
                device)
            buf_mel, buf_audio = [], []
