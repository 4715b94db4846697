"""Streaming chunked synthesis (port of ``e2e_tts_tpu/serve/streaming.py``).

The vocoder runs over fixed mel chunks with a receptive-field halo: it is
fully convolutional, so vocoding mel[c-H : c+C+H] and trimming H * hop
samples from each side gives the full pass's waveform chunk by chunk, and
the first audio arrives after one chunk instead of the whole utterance.
Each segment is the fixed C + 2H frames, zero-padded at the ends, as in the
JAX package: the samples near an end depend on that padding.

Both entry points run under ``torch.no_grad()`` (grad mode is per thread, so
a caller's thread may have it on).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

# a halo of 16 mel frames covers HiFi-GAN's receptive field
# (conv_pre k7 + 3 resblocks k <= 11, dilation <= 5 a stage: ~8 input frames)
DEFAULT_HALO = 16
DEFAULT_CHUNK = 64


class StreamingVocoder:
    """Incremental mel -> int16 waveform with overlap-halo chunking.

    ``vocoder``: mel (B, T, n_mels) -> float waveform (B, T * hop), such as
    the port's ``HifiGanGenerator`` or an engine's ``_vocode``.  The mel is
    a tensor on the vocoder's device, or a numpy array for a CPU vocoder."""

    def __init__(self, vocoder, hop_length: int = 256, chunk_frames: int = DEFAULT_CHUNK,
                 halo_frames: int = DEFAULT_HALO):
        self.vocoder = vocoder
        self.hop = hop_length
        self.chunk = chunk_frames
        self.halo = halo_frames

    @torch.no_grad()
    def stream(self, mel, mel_len: Optional[int] = None) -> Iterator[np.ndarray]:
        """mel (T, n_mels) -> yields int16 waveform chunks totalling T * hop."""
        mel = torch.as_tensor(mel)
        T = int(mel_len if mel_len is not None else mel.shape[0])
        C, H = self.chunk, self.halo
        for start in range(0, T, C):
            end = min(start + C, T)
            lo, hi = max(0, start - H), min(T, end + H)
            seg = torch.zeros((C + 2 * H, mel.shape[1]), dtype=mel.dtype, device=mel.device)
            seg[: hi - lo] = mel[lo:hi]
            audio = self.vocoder(seg[None])[0]
            up = audio.shape[0] // (C + 2 * H)
            a = (start - lo) * up          # skip the left halo
            b = a + (end - start) * up     # keep exactly the chunk
            codes = torch.clamp(audio[a:b].float() * 32767.0, -32768, 32767).to(torch.int16)
            yield codes.cpu().numpy()

    def vocode(self, mel, mel_len: Optional[int] = None) -> np.ndarray:
        parts = list(self.stream(mel, mel_len))
        return np.concatenate(parts) if parts else np.zeros(0, np.int16)


@torch.no_grad()
def stream_synthesize(engine, text: str, speaker_id: Optional[str] = None,
                      chunk_frames: int = DEFAULT_CHUNK, halo_frames: int = DEFAULT_HALO,
                      **controls) -> Iterator[np.ndarray]:
    """Text -> int16 chunks: the acoustic stages give each text chunk's mel,
    then the vocoder streams it out.

    Text is chunked as ``engine.synthesize`` chunks it (``prepare_request``:
    the character budget, speaker validation).  Each chunk runs alone in row
    0 of a full ``batch_size`` batch at its text bucket, then stage 2 without
    the vocoder at the mel bucket of its predicted length.  A chunk predicted
    past the largest mel bucket is re-split at phoneme seams, or, for one
    unsplittable phoneme, rendered k times at duration_control d / k, as the
    engine does, so long inputs stream instead of truncating.
    """
    from .engine import MAX_MEL_LEN, TEXT_BUCKETS, _bucket_for, _mel_bucket

    seqs, speaker = engine.prepare_request(text, speaker_id)
    if not seqs:
        return
    p = float(controls.get("pitch_control", 1.0))
    e = float(controls.get("energy_control", 1.0))
    d = float(controls.get("duration_control", 1.0))

    streamer = StreamingVocoder(engine._vocode, engine.hop_length, chunk_frames, halo_frames)
    B = engine.batch_size
    put = lambda a: torch.from_numpy(a).to(engine.device)  # noqa: E731
    # each pending item carries its own duration_control (the duration split)
    pending = [(np.asarray(s, np.int64), d) for s in seqs]
    while pending:
        seq, d_i = pending.pop(0)
        L = _bucket_for(len(seq), TEXT_BUCKETS)
        texts = np.zeros((B, L), np.int64)
        lens = np.ones((B,), np.int64)
        texts[0, : len(seq)] = seq
        lens[0] = len(seq)
        spk = np.full((B,), speaker, np.int64)
        x, durations = engine.acoustic.synthesize_stage1(
            put(spk), put(texts), put(lens), p_control=p, e_control=e, d_control=d_i)
        total = int(durations[0].sum())
        if total > MAX_MEL_LEN:
            pieces = engine._split_sequence(seq, total)
            if len(pieces) > 1:
                pending = [(piece, d_i) for piece in pieces] + pending
            else:
                k = max(2, -(-total // MAX_MEL_LEN))
                pending = [(seq, d_i / k)] * k + pending
            continue
        mel, mel_lens = engine.acoustic.synthesize_stage2(
            x, durations, max_mel_len=_mel_bucket(total), p_control=p, e_control=e)
        yield from streamer.stream(mel[0], int(mel_lens[0]))
