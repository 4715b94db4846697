"""Plain-PyTorch FastSpeech2 training: the losses, the hard alignment, the
forward-sum loss and the optimizer step, float32.

- Losses (FastSpeech2 and "One TTS Alignment"): masked L1 of the mel and
  of the postnet mel; log-duration MSE over every phoneme slot, word-level
  (words whose target duration is positive) and sentence-level; the
  forward-sum CTC over a blank at log-energy -1 and the phonemes, divided
  by the text length and averaged over rows (``F.ctc_loss``); the
  binarization term, ramped in from ``binarization_loss_enable_steps``;
  voiced/unvoiced BCE over phonemes, f0 MSE over voiced phonemes, energy
  MSE over phonemes.  Their plain sum is the total.
- Monotonic alignment search (Glow-TTS, arXiv:2005.11129): a max-plus
  recurrence over frames on log attention, a step from the left phoneme
  preferred on ties, a backtrack from the last frame and phoneme.
- The optimizer: gradients clipped to a global norm, Adam (bias-corrected,
  eps outside the root) scaled by the Noam schedule
  hidden^-0.5 * min(s^-0.5, s * warmup^-1.5), s = max(step, 1), read at
  the update count from 0, with its annealing milestones.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

NEG = -1e30


def masked_mean(x, mask):
    m = mask.float()
    while m.dim() < x.dim():
        m = m[..., None]
    return (x * m).sum() / torch.clamp(m.sum() * (x.numel() / m.numel()), min=1.0)


def word_sums(values, word_ids, n_words):
    return torch.einsum("blw,bl->bw", F.one_hot(word_ids, n_words).to(values.dtype), values)


def forward_sum(logprob, txt_lens, mel_lens):
    B, T, K = logprob.shape
    classes = torch.cat([logprob.new_full((B, T, 1), -1.0), logprob], -1)
    valid = torch.arange(K + 1, device=logprob.device)[None] <= txt_lens[:, None]
    classes = torch.where(valid[:, None], classes, torch.full_like(classes, NEG))
    lp = torch.log_softmax(classes, -1)
    targets = torch.arange(1, K + 1, device=logprob.device)[None].expand(B, -1)
    nll = F.ctc_loss(lp.transpose(0, 1), targets, mel_lens, txt_lens, blank=0,
                     reduction="none", zero_infinity=True)
    return (nll / txt_lens.clamp(min=1).float()).mean()


def losses(out, batch, step, loss_cfg, n_words) -> Dict[str, torch.Tensor]:
    txt_mask, mel_mask = out["txt_mask"], out["mel_mask"]
    nonpad = txt_mask.float()
    dur_t = out["dur"].detach().float() * nonpad
    log_d = out["log_d"]
    dur_p = torch.clamp(torch.exp(log_d) - 1.0, min=0.0)
    mel_t = batch["mel"]
    r = {"mel": masked_mean(torch.abs(out["mel"] - mel_t), mel_mask),
         "postnet": masked_mean(torch.abs(out["postnet"] - mel_t), mel_mask),
         "pdur": torch.mean((log_d - torch.log(dur_t + 1.0)) ** 2)}
    wp = word_sums(dur_p * nonpad, batch["word_ids"], n_words)
    wt = word_sums(dur_t, batch["word_ids"], n_words)
    wmask = (wt > 0).float()
    r["wdur"] = ((torch.log(wp + 1.0) - torch.log(wt + 1.0)) ** 2 * wmask).sum() / torch.clamp(
        wmask.sum(), min=1.0)
    r["sdur"] = torch.mean((torch.log(dur_p.sum(-1) + 1.0) - torch.log(dur_t.sum(-1) + 1.0)) ** 2)
    r["ctc"] = forward_sum(out["logprob"], batch["txt_lens"], batch["mel_lens"])
    w = min(max((step - loss_cfg["binarization_loss_enable_steps"])
                / loss_cfg["binarization_loss_warmup_steps"], 0.0), 1.0)
    hard = out["hard"]
    r["bin"] = (-(torch.log(torch.clamp(out["soft"], min=1e-12)) * hard).sum()
                / torch.clamp(hard.sum(), min=1.0)) * w
    uv_p, f0_p = out["pitch"][..., 1], out["pitch"][..., 0]
    uv_t = out["uv_t"]
    bce = torch.clamp(uv_p, min=0) - uv_p * uv_t + torch.log1p(torch.exp(-torch.abs(uv_p)))
    r["uv"] = (bce * nonpad).sum() / torch.clamp(nonpad.sum(), min=1.0)
    voiced = nonpad * (uv_t == 0)
    r["f0"] = (((f0_p - out["f0_t"]) ** 2) * voiced).sum() / torch.clamp(voiced.sum(), min=1.0)
    r["energy"] = masked_mean((out["energy"] - out["energy_t"]) ** 2, txt_mask)
    r["total"] = (r["mel"] + r["postnet"] + loss_cfg["pdur_lambda"] * r["pdur"]
                  + loss_cfg["wdur_lambda"] * r["wdur"] + loss_cfg["sdur_lambda"] * r["sdur"]
                  + r["ctc"] + r["bin"] + r["uv"] + r["f0"] + r["energy"])
    return r


@torch.no_grad()
def monotonic_alignment(soft, txt_lens, mel_lens):
    """(B, T, L) soft attention -> (B, T, L) 0/1 hard alignment."""
    B, T, L = soft.shape
    dev = soft.device
    j = torch.arange(L, device=dev)
    tl, ml = txt_lens.long().clamp(0, L), mel_lens.long().clamp(0, T)
    la = torch.log(torch.clamp(soft.float(), min=1e-30))
    la = torch.where(j[None, None] < tl[:, None, None], la, torch.full_like(la, NEG))
    neg = torch.full((B, 1), NEG, device=dev)
    prev = torch.where(j[None] == 0, la[:, 0], neg)
    left = torch.zeros(B, T, L, dtype=torch.bool, device=dev)
    for i in range(1, T):
        shifted = torch.cat([neg, prev[:, :-1]], 1)
        left[:, i] = shifted >= prev
        prev = torch.where((i < ml)[:, None], la[:, i] + torch.maximum(shifted, prev), prev)
    out = torch.zeros(B, T, L, device=dev)
    rows = torch.arange(B, device=dev)
    cur = tl - 1
    for i in range(T - 1, -1, -1):
        active = i < ml
        out[rows, i, cur.clamp(min=0)] = (active & (cur >= 0)).float()
        if i > 0:
            idx = torch.where(cur < 0, cur + L, cur).clamp(0, L - 1)
            cur = cur - (left[rows, i, idx] & active).long()
    out[:, 0, 0] = torch.where(ml > 0, 1.0, out[:, 0, 0])
    return out * (j[None, None] < tl[:, None, None])


def noam(step: int, hidden: int, opt_cfg) -> float:
    s = float(max(int(step), 1))
    lr = hidden ** -0.5 * min(s ** -0.5, s * opt_cfg["warm_up_step"] ** -1.5)
    for m in opt_cfg["anneal_steps"]:
        if s > m:
            lr *= opt_cfg["anneal_rate"]
    return lr


class Adam:
    """Clip to ``grad_clip_thresh``, Adam, Noam-scaled, on a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], opt_cfg, hidden: int, start=None):
        """``start``: (mu, nu, count) to resume from; zero moments at count 0 if None."""
        self.cfg, self.hidden = opt_cfg, hidden
        if start is None:
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.count = 0
        else:
            mu, nu, self.count = start
            self.mu = {k: mu[k].clone() for k in params}
            self.nu = {k: nu[k].clone() for k in params}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Update ``params`` in place; return the clipped gradients."""
        b1, b2 = self.cfg["betas"]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads.values()]))
        clip = 1.0 if norm < self.cfg["grad_clip_thresh"] else self.cfg["grad_clip_thresh"] / norm
        lr = noam(self.count, self.hidden, self.cfg)
        c = self.count + 1
        clipped = {}
        for k, p in params.items():
            g = grads[k] * clip
            clipped[k] = g
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g * g
            u = (self.mu[k] / (1 - b1 ** c)) / (torch.sqrt(self.nu[k] / (1 - b2 ** c)) + self.cfg["eps"])
            if self.cfg.get("weight_decay"):
                u = u + self.cfg["weight_decay"] * p
            p -= lr * u
        self.count = c
        return clipped


def train_steps(model, params: Dict[str, torch.Tensor], batches: List[dict], hards, config,
                rng: torch.Generator, n_words: int, first_step: int = 0, opt_start=None):
    """Run ``len(batches)`` steps from ``params`` (updated in place), the
    first numbered ``first_step``, the optimizer resumed from ``opt_start``
    ((mu, nu, count); fresh if None): each step's losses, the first step's
    clipped gradients, and each step's own hard alignment (to compare with
    the one it was given)."""
    fs2 = config["models"]["fastspeech2"]
    opt = Adam(params, config["train"]["fastspeech2_optimizer"], fs2["encoder_hidden"], opt_start)
    out_losses, first_grads, own_hards = [], None, []
    for step, (batch, hard) in enumerate(zip(batches, hards), start=first_step):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        out = model.train_forward(batch, step, rng, hard)
        own_hards.append(out["hard"] if hard is None else monotonic_alignment(
            out["soft"].detach(), batch["txt_lens"], batch["mel_lens"]))
        ls = losses(out, batch, step, config["train"]["fastspeech2_loss"], n_words)
        ls["total"].backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in params.items()}
        for p in params.values():
            p.requires_grad_(False)
        clipped = opt.step(params, grads)
        if first_grads is None:
            first_grads = clipped
        out_losses.append({k: float(v.detach()) for k, v in ls.items()})
    return out_losses, first_grads, own_hards
