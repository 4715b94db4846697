"""The port's twin of the JAX package's multichip dry run
(``__graft_entry__.dryrun_multichip``): one acoustic step, one vocoder GAN
step and one joint e2e step, each over a (data, model) mesh of N ranks with
the batch split over "data" and the wide weights over "model"
(``parallel/tensor_parallel``), at the dry run's tiny sizes.

    python -m e2e_tts_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]

starts the N ranks as processes of their own (gloo on 127.0.0.1; on the card
they share it), each a ``--rank``; rank 0 prints one line a step, as JAX's
does.  The mesh is (N / 2, 2) where N is even and at least 4, else (N, 1),
as JAX's.  The steps' inputs are JAX's: the same shapes and the same numpy
draws.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

N_WORDS = 8
SEGMENT = 16
TIMEOUT_S = 600.0


def tiny_config():
    """The dry run's configuration: two 128-wide transformer layers a side
    (FFN 256), a 128-wide postnet, and a 16-channel HiFi-GAN with one
    resblock kind."""
    from ..config import default_config

    cfg = default_config()
    fs2 = cfg.models.fastspeech2
    small = fs2.replace(
        encoder_layers=2, decoder_layers=2, encoder_hidden=128, decoder_hidden=128,
        building_block=fs2.building_block.replace(
            transformer=fs2.building_block.transformer.replace(conv_filter_size=256)),
        postnet=fs2.postnet.replace(embedding_dim=128))
    hifi = cfg.models.hifigan.replace(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                                      resblock_dilation_sizes=((1, 3),))
    return cfg.replace(models=cfg.models.replace(fastspeech2=small, hifigan=hifi))


def tiny_discriminators(device):
    """MPD and MSD with the reference's layers at shrunk widths."""
    from ..nn.discriminators import TINY_MSD_SPECS, build_discriminators

    return build_discriminators(device, periods=(2, 3), mpd_channels=(4, 8), n_scales=2,
                                msd_specs=TINY_MSD_SPECS)


def model_parallel(n_ranks: int) -> int:
    return 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1


def acoustic_arrays(B: int, L: int = 16, T: int = 48, seed: int = 0):
    """The dry run's acoustic batch as numpy arrays (``AcousticBatch``
    order)."""
    from ..text.symbols import symbols

    rng = np.random.RandomState(seed)
    texts = rng.randint(4, len(symbols), (B, L))
    mel = rng.randn(B, T, 80).astype(np.float32)
    f0 = rng.randn(B, T).astype(np.float32)
    uv = (rng.rand(B, T) > 0.7).astype(np.float32)
    pitch = rng.randn(B, T).astype(np.float32)
    energy = np.abs(rng.randn(B, T)).astype(np.float32)
    word_ids = np.minimum(np.arange(L) // 2, N_WORDS - 1)[None].repeat(B, 0)
    return [np.zeros(B, np.int64), texts, np.full(B, L), word_ids, mel, np.full(B, T),
            np.full((B, T, L), 1.0 / L, np.float32), np.zeros((B, L), np.float32), f0, uv,
            pitch, energy], rng


def _mesh_line(mesh) -> str:
    return str(dict(zip(mesh.mesh_dim_names, mesh.shape)))


def acoustic_step(cfg, mesh, device) -> str:
    from ..text.symbols import symbols
    from ..train import (AcousticBatch, acoustic_optimizer, build_acoustic_model,
                         init_train_state, make_train_step)
    from .data_parallel import data_group
    from .mesh import model_group
    from .sharding import shard_batch
    from .tensor_parallel import parallelize

    group, tp = data_group(mesh), model_group(mesh)
    model = parallelize(build_acoustic_model(cfg, len(symbols), 4, device=device), mesh)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                             cfg.models.fastspeech2.encoder_hidden)
    state = init_train_state(model, opt, group=group)
    step = make_train_step(model, cfg, opt, N_WORDS, group=group, model_group=tp)
    n = int(np.prod(mesh.shape))
    arrays, _ = acoustic_arrays(max(2 * n, 4))
    state, metrics = step(state, shard_batch(AcousticBatch.from_numpy(arrays, device), mesh))
    total = metrics["total"].item()
    if not np.isfinite(total):
        raise AssertionError(f"non-finite loss {total}")
    return (f"dryrun acoustic OK: mesh={_mesh_line(mesh)} ranks={n} loss={total:.4f} "
            f"grad_norm={metrics['grad_norm'].item():.4f}")


def vocoder_step(cfg, mesh, device) -> str:
    from ..nn.hifigan import TrainableHifiGan
    from ..train import (VocoderBatch, gan_optimizer, init_vocoder_train_state,
                         make_vocoder_train_step)
    from .data_parallel import data_group
    from .mesh import model_group
    from .sharding import axis_sizes, shard_batch
    from .tensor_parallel import parallelize

    group, tp = data_group(mesh), model_group(mesh)
    gen = parallelize(TrainableHifiGan.from_config(cfg.models.hifigan, device=device), mesh)
    mpd, msd = tiny_discriminators(device)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
    step = make_vocoder_train_step(gen, cfg, g_opt, d_opt, "hifigan", mpd, msd, group=group,
                                   model_group=tp)
    B, hop = max(axis_sizes(mesh)["data"], 2), cfg.audio.stft.hop_length
    rng = np.random.RandomState(1)
    arrays = [rng.randn(B, SEGMENT, cfg.audio.mel.channels), 0.1 * rng.randn(B, SEGMENT * hop)]
    state, metrics = step(state, shard_batch(VocoderBatch.from_numpy(arrays, device), mesh))
    g, d = metrics["g_total"].item(), metrics["d_total"].item()
    if not (np.isfinite(g) and np.isfinite(d)) or state.step != 1:
        raise AssertionError(f"vocoder GAN step: g={g} d={d} step={state.step}")
    return f"dryrun vocoder-GAN OK: mesh={_mesh_line(mesh)} g={g:.4f} d={d:.4f}"


def e2e_step(cfg, mesh, device) -> str:
    from ..nn.hifigan import TrainableHifiGan
    from ..text.symbols import symbols
    from ..train import (AcousticBatch, E2EBatch, acoustic_optimizer, build_acoustic_model,
                         gan_optimizer, init_e2e_state, make_e2e_train_step)
    from .data_parallel import data_group
    from .mesh import model_group
    from .sharding import axis_sizes, shard_batch
    from .tensor_parallel import parallelize

    group, tp = data_group(mesh), model_group(mesh)
    model = parallelize(build_acoustic_model(cfg, len(symbols), 4, device=device), mesh)
    gen = parallelize(TrainableHifiGan.from_config(cfg.models.hifigan, device=device), mesh)
    mpd, msd = tiny_discriminators(device)
    am_opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                                cfg.models.fastspeech2.encoder_hidden)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    state = init_e2e_state(model, gen, am_opt, g_opt, d_opt, mpd, msd, seed=2, group=group)
    step = make_e2e_train_step(model, gen, cfg, am_opt, g_opt, d_opt, N_WORDS, SEGMENT, mpd, msd,
                               group=group, model_group=tp)
    B, T = max(axis_sizes(mesh)["data"], 2), 48
    arrays, rng = acoustic_arrays(B, T=T, seed=3)
    audio = (0.1 * rng.randn(B, T * cfg.audio.stft.hop_length)).astype(np.float32)
    batch = shard_batch(E2EBatch(AcousticBatch.from_numpy(arrays, device),
                                 torch.from_numpy(audio).to(device)), mesh)
    state, metrics = step(state, batch)
    total, d = metrics["total"].item(), metrics["discriminator"].item()
    if not (np.isfinite(total) and np.isfinite(d)) or state.step != 1:
        raise AssertionError(f"e2e step: total={total} d={d} step={state.step}")
    return f"dryrun e2e OK: mesh={_mesh_line(mesh)} total={total:.4f} d={d:.4f}"


def run_rank(rank: int, n_ranks: int, port: int, device: Optional[str]) -> int:
    """One rank: the three steps over the (data, model) mesh; rank 0 prints."""
    from .distributed import device as rank_device
    from .distributed import initialize
    from .mesh import make_mesh

    if not initialize(f"127.0.0.1:{port}", n_ranks, rank, device=device,
                      timeout_s=TIMEOUT_S) and n_ranks > 1:
        raise RuntimeError("torch.distributed did not start")
    dev = rank_device()
    cfg = tiny_config()
    mesh = make_mesh(n_ranks, model_parallel=model_parallel(n_ranks))
    for step in (acoustic_step, vocoder_step, e2e_step):
        line = step(cfg, mesh, dev)
        if rank == 0:
            print(line, flush=True)
    if rank == 0:
        print(f"dryrun OK: mesh={_mesh_line(mesh)} ranks={n_ranks}", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


def launch(n_ranks: int, device: Optional[str], timeout_s: float = TIMEOUT_S) -> int:
    """Start the ranks as processes of their own and wait for them; a rank
    that fails, or that has not ended within ``timeout_s``, fails the run
    (the ranks are killed).  Rank 0's output goes to stdout."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "e2e_tts_tpu_torch.parallel.dryrun", "--ranks", str(n_ranks),
           "--port", str(port)] + (["--device", device] if device else [])
    env = dict(os.environ)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(name, None)
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                              stdout=None if r == 0 else subprocess.DEVNULL)
             for r in range(n_ranks)]
    t0 = time.monotonic()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout_s - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        print(f"dryrun: a rank did not end within {timeout_s} s", file=sys.stderr)
        return 1
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        print(f"dryrun: rank(s) {failed} failed", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        return launch(args.ranks, args.device)
    torch.set_num_threads(1)
    return run_rank(args.rank, args.ranks, args.port, args.device)


if __name__ == "__main__":
    sys.exit(main())
