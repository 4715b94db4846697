"""What decides ``correct`` in the training cell.

The reference follows two runs of steps (the mix's ``reference_steps``
each), on batches it builds itself from the workdir's files: the loop's
first steps, from the benchmark's seeded weights, a fresh optimizer and
the dropout generator's seed; and the window's first steps, from the
training state as the window found it (the program's weights, Adam's
moments and count, the step number and the dropout generator's state,
after the first epoch: the steps between the two are not followed).
Counts add up over the two, gaps take the wider:

- ``batch_mismatch`` (exact) and ``batch_gap``: the reference's batch for
  the utterances and bucket each step ran (its token ids from its own
  frontend copy, word ids, mel, f0, voiced flags and energy normalised by
  ``stats.json``, the beta-binomial prior of "One TTS Alignment"; the
  order and the bucket are the batcher's) against the program's;
- ``mas_rows_differ``: rows whose hard alignment the reference's MAS, on
  the reference's soft attention, does not give as the program's did.  The
  reference's steps take the program's hard alignment (a near-tie that the
  two sides' last bits break apart would otherwise move a phoneme
  boundary: the alignment is followed, and compared here);
- ``loss_gap``: each step's total loss, the relative gap, the widest;
- ``grad_gap``: the first step's gradient as the optimizer got it (the
  change of its first moment, mu1 - beta1 mu0, over 1 - beta1), per leaf
  the gap between the two sides'
  norms over the larger of the reference leaf's norm and the median leaf's,
  the worst leaf;
- ``update_gap``: the same of each leaf's change over the steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (below that a leaf moves under Adam by round-off alone).

Dropout masks come from a generator seeded as the training state's, drawn
in the layers' order; the control (``control="tf32"``) runs the reference
with TF32 products in the program's place.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..reference.fs2 import FastSpeech2
from ..reference.training import train_steps
from ..reference.vie_text.symbols import SYMBOL_TO_ID
from .serving import tf32

FIELDS_INT = ("speakers", "texts", "txt_lens", "word_ids", "mel_lens")
FIELDS_FLOAT = ("mel", "prior", "f0", "uv", "energy")
PROGRAM_ORDER = ("speakers", "texts", "txt_lens", "word_ids", "mel", "mel_lens", "prior",
                 "duration_target", "f0", "uv", "pitch", "energy")


def beta_binomial_prior(P: int, M: int) -> np.ndarray:
    from scipy.stats import betabinom

    i = np.arange(1, M + 1, dtype=np.float64)[:, None]
    return betabinom.pmf(np.arange(P)[None, :], P, i, M + 1 - i).astype(np.float32)


def build_batch(program_batch, records, root: str, device) -> Dict[str, torch.Tensor]:
    """The reference's batch for the rows of ``program_batch``: the same
    utterances in the same rows and bucket, every array made from the files."""
    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(root, "speakers.json")) as f:
        spk_map = json.load(f)
    by_key = {(tuple(SYMBOL_TO_ID[p] for p in r["phonemes"]), r["frames"]): r for r in records}
    texts = program_batch.texts.cpu().numpy()
    lens = program_batch.txt_lens.cpu().numpy()
    mlens = program_batch.mel_lens.cpu().numpy()
    B, L = texts.shape
    T = program_batch.mel.shape[1]
    n_mels = program_batch.mel.shape[2]
    out = {k: np.zeros((B, L), np.int64) for k in ("texts", "word_ids")}
    out.update(speakers=np.zeros(B, np.int64), txt_lens=np.ones(B, np.int64),
               mel_lens=np.ones(B, np.int64), mel=np.zeros((B, T, n_mels), np.float32),
               prior=np.zeros((B, T, L), np.float32))
    for k in ("f0", "uv", "energy"):
        out[k] = np.zeros((B, T), np.float32)
    corpus = os.path.join(root, "corpus")
    for row in range(B):
        rec = by_key[(tuple(int(t) for t in texts[row, :lens[row]]), int(mlens[row]))]
        ids = [SYMBOL_TO_ID[p] for p in rec["phonemes"]]
        n, t = len(ids), rec["frames"]
        out["speakers"][row] = spk_map[rec["speaker"]]
        out["texts"][row, :n] = ids
        out["txt_lens"][row], out["mel_lens"][row] = n, t
        out["word_ids"][row, :n] = np.repeat(np.arange(len(rec["words"])), rec["words"])
        load = lambda d: np.load(os.path.join(corpus, d, f"{rec['id']}.npy"))  # noqa: E731
        out["mel"][row, :t] = load("mels").T
        f0 = load("f0")[:t]
        out["uv"][row, :t] = (f0 == 0).astype(np.float32)
        out["f0"][row, :t] = np.where(f0 > 0, (f0 - stats["f0"]["mean"]) / stats["f0"]["std"], 0.0)
        out["energy"][row, :t] = (load("energy")[:t] - stats["energy"]["mean"]) / stats["energy"]["std"]
        out["prior"][row, :t, :n] = beta_binomial_prior(n, t)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _worst(prog: torch.Tensor, ref: torch.Tensor, names, keep=None):
    """(gap, leaf): the worst leaf's |norm gap| over max(reference norm,
    median reference norm)."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
        names = [n for n, k in zip(names, keep.tolist()) if k]
    gaps = (prog - ref).abs() / torch.clamp(ref, min=float(ref.median()))
    k = int(gaps.argmax())
    return float(gaps[k]), names[k]


def _follow(run, cfg_file, root, records, cap, seg, control, stats) -> Dict[str, float]:
    """The reference's ``reference_steps`` steps of segment ``seg``, against
    the program's (or, with the control, the reference's own in float32)."""
    config = cfg_file["config"]
    device = run.device
    out = dict(batch_mismatch=0, batch_gap=0.0, mas_rows_differ=0)
    batches: List[Dict] = []
    for program_batch, _ in seg.steps:
        ref = build_batch(program_batch, records, root, device)
        prog = dict(zip(PROGRAM_ORDER, program_batch))
        for k in FIELDS_INT:
            out["batch_mismatch"] += int((prog[k].long() != ref[k]).sum())
        for k in FIELDS_FLOAT:
            out["batch_gap"] = max(out["batch_gap"], float((prog[k].float() - ref[k]).abs().max()))
        batches.append(ref)
    names = cap.names
    n_words = max(config["models"]["fastspeech2"]["max_seq_len"], 256)
    # the program's hard alignments, where they are of the batch's shape
    hards = [h if h.shape == b["prior"].shape else None for h, b in zip(seg.hards, batches)]

    def steps(allow_tf32):
        params = {n: seg.weights[n].detach().clone() for n in names}
        P = dict(params)
        P.update({k: v for k, v in cap.weights.items() if k not in params})
        rng = torch.Generator(device=device)
        if seg.rng_state is None:
            rng.manual_seed(config["train"]["seed"])
        else:
            rng.set_state(seg.rng_state)
        opt = None if seg.opt is None else (
            dict(zip(names, seg.opt[0])), dict(zip(names, seg.opt[1])), seg.opt[2])
        with tf32(allow_tf32):
            return params, train_steps(FastSpeech2(P, config, stats), params, batches, hards,
                                       config, rng, n_words, seg.first_step, opt)

    params, (losses, grads, own) = steps(control == "tf32")
    for hard, mine in zip(hards, own):
        out["mas_rows_differ"] += (mine.shape[0] if hard is None
                                   else int((hard != mine).flatten(1).any(1).sum()))
    if control == "tf32":
        # the control's own steps stand in the program's place: run the
        # reference again in float32 and compare the two
        prog_losses = [ls["total"] for ls in losses]
        prog_grads = torch.stack([torch.linalg.vector_norm(grads[n]) for n in names])
        prog_delta = torch.stack([torch.linalg.vector_norm(params[n] - seg.weights[n])
                                  for n in names])
        params, (losses, grads, _) = steps(False)
    else:
        prog_losses = [float(m["total"]) for _, m in seg.steps]
        prog_grads, prog_delta = seg.grad_norms, seg.delta_norms
    ref_grads = torch.stack([torch.linalg.vector_norm(grads[n]) for n in names])
    ref_delta = torch.stack([torch.linalg.vector_norm(params[n] - seg.weights[n]) for n in names])
    out["loss_gap"] = max(abs(p - r["total"]) / abs(r["total"]) for p, r in zip(prog_losses, losses))
    out["grad_gap"], worst_g = _worst(prog_grads, ref_grads, names)
    keep = (ref_grads >= 1e-3 * ref_grads.median()).cpu()
    out["update_gap"], worst_u = _worst(prog_delta, ref_delta, names, keep)
    run.note(f"followed steps {seg.first_step}-{seg.first_step + len(seg.steps) - 1}; losses "
             f"{[round(r['total'], 6) for r in losses]}; worst leaves: gradient {worst_g}, "
             f"change {worst_u}; {int((~keep).sum())} leaves left out of the change: "
             f"{[n for n, k in zip(names, keep.tolist()) if not k]}")
    return out


def compare_steps(run, cfg_file, root, records, cap, control: str = None) -> Dict[str, float]:
    """The numbers of both segments: the loop's first steps from the seed
    and the window's first steps from the state the window found; counts
    add up, gaps take the wider."""
    segments = [cap.first, cap.win]
    for seg in segments:
        if seg is None or len(seg.steps) < cap.ref_steps:
            raise RuntimeError(f"a segment of {0 if seg is None else len(seg.steps)} steps; "
                               f"the check follows {cap.ref_steps}")
    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)  # the corpus's, as the CLI builds its model with them
    out: Dict[str, float] = {}
    for seg in segments:
        for k, v in _follow(run, cfg_file, root, records, cap, seg, control, stats).items():
            out[k] = v if k not in out else (out[k] + v if isinstance(v, int) else max(out[k], v))
    return out
