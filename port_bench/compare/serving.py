"""What decides ``correct`` in a serving cell.

Once the window has closed, a sample of the requests that finished (drawn
from the seed, the longest always in it) is run through the plain
reference, row by row, on the benchmark's own weights:

- the reference's frontend and chunking give each request's phoneme
  sequences; each must be a row that the engine's stage 1 ran for that
  speaker (``unmatched_rows``, exact);
- stage 1: the reference's log durations and pitch and energy predictions
  against those the engine's stage 1 produced for the row (widest gaps);
- stage 2 and the vocoder: the reference decodes the row from its own
  stage 1 (its durations and pitch and energy bins) at the mel bucket the
  engine ran the row at (a choice of the batch the row was in), encodes
  int16 and stitches the request; the widest gap to the program's int16
  array, in LSB (``wave_lsb``).  A phoneme's duration or bin follows the
  engine's only where the two differ and moving the reference's prediction
  by no more than the cell's limit on that prediction's gap flips it: a
  rounding or bin boundary that the two sides' last bits straddle, which
  would otherwise move a whole phoneme.  The run notes how many phonemes
  and rows followed, and how many differ away from any boundary (those keep
  the reference's choice, and the waveform shows them).

The control (``control="tf32"``) puts the reference itself, computed with
TF32 products, in the program's place.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from ..reference.fs2 import FastSpeech2
from ..reference.serving_rules import (MAX_MEL_LEN, durations_from_log, mel_bucket,
                                       request_sequences, stitch, text_bucket, to_int16)
from ..reference.vocoders import vocode


@contextlib.contextmanager
def tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sample_requests(texts, ok, n: int, seed: int) -> List[int]:
    done = [i for i, good in enumerate(ok) if good]
    if not done:
        return []
    longest = max(done, key=lambda i: len(texts[i]))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([seed, 6])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(k)] for k in pick]


def _index(host) -> Dict:
    index = {}
    for k, rec in enumerate(host["records"]):
        toks, spk = rec["tokens"], rec["speakers"]
        for r in (toks[:, 0] != 0).nonzero().flatten().tolist():
            n = int((toks[r] != 0).sum())
            index.setdefault((int(spk[r]), tuple(toks[r, :n].tolist())), []).append((k, r))
    return index


def _bucket(rec, row, totals) -> int:
    """The mel bucket the engine's row came from: the batch's estimate, or
    the re-render's bucket for the rows past it."""
    T_est = rec["T"]
    if int(totals[row]) <= T_est:
        return T_est
    real = (rec["tokens"][:, 0] != 0).nonzero().flatten().tolist()
    over = [int(totals[r]) for r in real if int(totals[r]) > T_est]
    return mel_bucket(min(max(over), MAX_MEL_LEN))


class Reference:
    def __init__(self, cfg_file, wa, wv, device):
        self.cfg = cfg_file
        self.model = FastSpeech2(wa, cfg_file["config"], cfg_file["stats"])
        self.wv = wv
        self.kind = cfg_file["vocoder"]
        self.vcfg = cfg_file["config"]["models"]["hifigan" if self.kind == "hifigan" else "istft"]
        self.hop = cfg_file["config"]["audio"]["stft"]["hop_length"]
        self.sr = cfg_file["config"]["audio"]["signal"]["sampling_rate"]
        self.device = device

    @torch.no_grad()
    def stage1(self, seq, spk):
        """Stage 1 of one row at its text bucket (the predictors' convolutions
        read the padding, which holds the speaker embedding), cut to the row."""
        L = len(seq)
        tokens = torch.zeros(1, text_bucket(L), dtype=torch.int64, device=self.device)
        tokens[0, :L] = torch.as_tensor(seq, dtype=torch.int64)
        speakers = torch.tensor([spk], device=self.device)
        x, log_d, pitch, energy, _ = self.model.stage1(tokens, speakers)
        return x[:, :L], log_d[0, :L], pitch[0, :L], energy[0, :L]

    @torch.no_grad()
    def render(self, x, pitch, energy, durations, T) -> np.ndarray:
        d = torch.as_tensor(durations, device=self.device)[None]
        mel, mel_lens = self.model.stage2(x, pitch[None].to(self.device),
                                          energy[None].to(self.device), d, T)
        audio = vocode(self.wv, self.kind, self.vcfg, mel)
        return to_int16(audio[0, : int(mel_lens[0]) * self.hop])

    def follow_straddles(self, own, other, limits):
        """Stage 2's inputs (log durations, pitch, energy of one row) from
        the reference's own predictions ``own``, with ``other``'s (the
        program's) at each phoneme whose discrete choice differs on the two
        sides and flips within the cell's limit around the reference's
        prediction.  Returns the inputs, the phonemes followed and the
        phonemes whose choice differs away from any boundary."""
        m = self.model
        log_d, pitch, energy = (t.to(self.device) for t in own)
        o_log_d, o_pitch, o_energy = (t.to(self.device) for t in other)
        lim_d, lim_p, lim_e = (float(limits.get(k, 0.0))
                               for k in ("logd_gap", "pitch_gap", "energy_gap"))
        f0, uv = pitch[..., 0], pitch[..., 1]

        def pitch_ix(f, u):
            return m.pitch_index(f, u > 0)

        differ_d = durations_from_log(log_d) != durations_from_log(o_log_d)
        near_d = durations_from_log(log_d - lim_d) != durations_from_log(log_d + lim_d)
        differ_p = pitch_ix(f0, uv) != pitch_ix(o_pitch[..., 0], o_pitch[..., 1])
        near_p = ((pitch_ix(f0 - lim_p, uv) != pitch_ix(f0 + lim_p, uv)) | (uv.abs() <= lim_p))
        differ_e = m.energy_index(energy) != m.energy_index(o_energy)
        near_e = m.energy_index(energy - lim_e) != m.energy_index(energy + lim_e)
        fd, fp, fe = differ_d & near_d, differ_p & near_p, differ_e & near_e
        followed = int(fd.sum() + fp.sum() + fe.sum())
        apart = int((differ_d & ~near_d).sum() + (differ_p & ~near_p).sum()
                    + (differ_e & ~near_e).sum())
        return ((torch.where(fd, o_log_d, log_d), torch.where(fp[..., None], o_pitch, pitch),
                 torch.where(fe, o_energy, energy)), followed, apart)


def compare_requests(run, cfg_file, host, texts, speakers, audio, ok, wa, wv, silence,
                     control: str = None) -> Dict[str, float]:
    if abs(silence - 0.5) > 1e-9:
        raise ValueError("the reference stitches the engine's 0.5 s gap")
    ref = Reference(cfg_file, wa, wv, run.device)
    index = _index(host)
    pick = sample_requests(texts, ok, run.mix["check_requests"], run.seed)
    out = dict(unmatched_rows=0, logd_gap=0.0, pitch_gap=0.0, energy_gap=0.0, wave_lsb=0.0)
    n_rows = followed_rows = followed = apart = 0
    with tf32(False):
        for i in pick:
            seqs = request_sequences(texts[i])
            n_rows += len(seqs)
            hits = [index.get((speakers[i], tuple(int(t) for t in seq)), []) for seq in seqs]
            if any(not h for h in hits) or (len(seqs) > 1 and any(len(h) > 1 for h in hits)):
                # a row the engine never ran; or, past one row, a row it ran
                # for several requests, which the check cannot tell apart
                out["unmatched_rows"] += sum(len(h) != 1 for h in hits)
                continue
            # two requests with the same text and speaker make the same row:
            # the engine computed it for each, the one this request got fits best
            best = None
            for cand in hits[0] if len(seqs) == 1 else [hits[0][0]]:
                chosen = [cand] if len(seqs) == 1 else [h[0] for h in hits]
                res = _compare_one(ref, host, seqs, chosen, speakers[i], audio[i], control, run, i)
                if best is None or res["wave_lsb"] < best["wave_lsb"]:
                    best = res
            for k in ("logd_gap", "pitch_gap", "energy_gap", "wave_lsb"):
                out[k] = max(out[k], best[k])
            followed_rows += best["followed_rows"]
            followed += best["followed"]
            apart += best["apart"]
    run.note(f"checked {len(pick)} requests, {n_rows} rows, the longest "
             f"{max((len(texts[i]) for i in pick), default=0)} characters; stage 2 followed "
             f"the {'control' if control else 'program'}'s duration or bin at {followed} phonemes "
             f"in {followed_rows} rows (a boundary within the limits); {apart} phonemes differ "
             f"away from any boundary")
    return out


def _compare_one(ref, host, seqs, chosen, spk, served_audio, control, run, i):
    out = dict(logd_gap=0.0, pitch_gap=0.0, energy_gap=0.0, wave_lsb=0.0, followed_rows=0,
               followed=0, apart=0)
    served, expect = [], []
    for seq, (k, r) in zip(seqs, chosen):
        rec = host["records"][k]
        L = len(seq)
        x, log_d, pitch, energy = ref.stage1(seq, spk)
        if control == "tf32":
            with tf32(True):
                xc, p_log_d, p_pitch, p_energy = ref.stage1(seq, spk)
            p_log_d, p_pitch, p_energy = (t.cpu() for t in (p_log_d, p_pitch, p_energy))
        else:
            p_log_d, p_pitch, p_energy = (rec["log_d"][r, :L], rec["pitch"][r, :L],
                                          rec["energy"][r, :L])
        out["logd_gap"] = max(out["logd_gap"], float((log_d.cpu() - p_log_d).abs().max()))
        out["pitch_gap"] = max(out["pitch_gap"], float((pitch.cpu() - p_pitch).abs().max()))
        out["energy_gap"] = max(out["energy_gap"], float((energy.cpu() - p_energy).abs().max()))
        if control == "tf32":
            p_durations = durations_from_log(p_log_d)
            total = int(p_durations.sum())
            T = rec["T"] if total <= rec["T"] else mel_bucket(total)
            with tf32(True):
                served.append(ref.render(xc, p_pitch, p_energy, p_durations, T))
        else:
            totals = (durations_from_log(rec["log_d"]) * (rec["tokens"] != 0)).sum(-1)
            if int(totals[r]) > MAX_MEL_LEN:
                raise RuntimeError(f"a row of {int(totals[r])} frames: past the engine's "
                                   f"largest bucket, which this check does not follow")
            T = _bucket(rec, r, totals)
        (f_log_d, f_pitch, f_energy), n_followed, n_apart = ref.follow_straddles(
            (log_d, pitch, energy), (p_log_d, p_pitch, p_energy), run.limits)
        out["followed_rows"] += int(n_followed > 0)
        out["followed"] += n_followed
        out["apart"] += n_apart
        expect.append(ref.render(x, f_pitch, f_energy, durations_from_log(f_log_d), T))
    got = stitch(served, ref.sr) if control == "tf32" else served_audio
    want = stitch(expect, ref.sr)
    if got.shape != want.shape:
        run.note(f"request {i}: {got.shape[0]} samples served, {want.shape[0]} from the reference")
        out["wave_lsb"] = float("inf")
    else:
        out["wave_lsb"] = float(np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0))
    return out
