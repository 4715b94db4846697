"""One rank of the port's data- and tensor-parallel checks (gloo ranks on
127.0.0.1: ``tests/test_torch_parallel_steps.py`` and
``tests/test_torch_tensor_parallel.py`` on the CPU, and a card test of
``tests/test_torch_cuda.py``).  Imports torch and the port only.

    python tests/_torch_parallel_worker.py INPUTS RANK WORLD PORT OUT

``INPUTS`` is a ``torch.save``d dict whose "tasks" name what to run, in
order, with their inputs beside them (an input's "task" names the function
where it is not the task's own name; "model_parallel" sets the mesh's model
axis, 1 by default, and the modules are then split by ``parallelize``):

- "acoustic", "vocoder", "e2e": one train step of each on this rank's rows
  of the global batch (the port's global step over the data group, and over
  the model group);
- "forward": the eval forward (stage 1 and 2) of a bundle's or a random
  default-width acoustic model, unsplit and then split;
- "serve": a ``global_mesh=True`` engine on the given texts;
- "shard": ``shard_params`` of a small model on a (1, WORLD) mesh;
- "cli": the training CLI's argument lists, run in turn.

The ranks run on the CPU, or on the card where INPUTS' "device" is "cuda".
Writes ``OUT`` (``torch.save``): what each task produced on this rank.
:func:`run_ranks` starts the ranks from a test.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(spec: dict, tmp, world: int, timeout_s: float) -> list:
    """Run the worker's tasks on ``world`` gloo ranks; each rank's results.
    A rank that fails, or that has not finished within ``timeout_s``, fails
    the caller (the ranks are killed)."""
    inputs = os.path.join(tmp, "inputs.pt")
    torch.save(spec, inputs)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(name, None)
    outs = [os.path.join(tmp, f"out_{r}.pt") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), inputs, str(r),
                               str(world), str(port), outs[r]],
                              cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"a rank did not finish within {timeout_s} s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def _split(mesh, *modules):
    """``parallelize`` each module over the mesh's model axis (a no-op where
    it has one rank); the model group."""
    from e2e_tts_tpu_torch.parallel.mesh import model_group
    from e2e_tts_tpu_torch.parallel.tensor_parallel import parallelize

    for m in modules:
        parallelize(m, mesh)
    return model_group(mesh)


def _acoustic(inp, mesh, group):
    from e2e_tts_tpu_torch.parallel import shard_batch
    from e2e_tts_tpu_torch.train import (AcousticBatch, acoustic_optimizer, build_acoustic_model,
                                         init_train_state, make_train_step)

    cfg = inp["config"]
    model = build_acoustic_model(cfg, inp["n_symbols"], inp["n_speakers"],
                                 dropout=inp.get("dropout", False), device="cpu")
    model.load_state_dict(inp["state_dict"])
    tp = _split(mesh, model)
    opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                             cfg.models.fastspeech2.encoder_hidden)
    state = init_train_state(model, opt, group=group)
    state.step = inp["step"]
    step = make_train_step(model, cfg, opt, inp["n_words"], group=group, model_group=tp)
    batch = shard_batch(AcousticBatch.from_numpy(inp["batch"], "cpu"), mesh)
    state, metrics = step(state, batch)
    names = [n for n, _ in model.named_parameters()]
    return dict(metrics={k: v.item() for k, v in metrics.items()},
                mu=dict(zip(names, state.opt_state.mu)), state_dict=model.state_dict(),
                rows=len(batch.speakers))


def _vocoder(inp, mesh, group):
    from e2e_tts_tpu_torch.nn import discriminators
    from e2e_tts_tpu_torch.nn.hifigan import TrainableHifiGan
    from e2e_tts_tpu_torch.parallel import shard_batch
    from e2e_tts_tpu_torch.train import (VocoderBatch, gan_optimizer, init_vocoder_train_state,
                                         make_vocoder_train_step)

    cfg = inp["config"]
    gen = TrainableHifiGan.from_config(cfg.models.hifigan, device="cpu")
    mpd, msd = discriminators.build_discriminators(**inp["disc"])
    for m, sd in zip((gen, mpd, msd), inp["state_dicts"]):
        m.load_state_dict(sd)
    tp = _split(mesh, gen)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    state = init_vocoder_train_state(gen, g_opt, d_opt, mpd, msd)
    step = make_vocoder_train_step(gen, cfg, g_opt, d_opt, "hifigan", mpd, msd, group=group,
                                   model_group=tp)
    batch = shard_batch(VocoderBatch.from_numpy(inp["batch"], "cpu"), mesh)
    state, metrics = step(state, batch)
    return dict(metrics={k: v.item() for k, v in metrics.items()},
                state_dicts=[m.state_dict() for m in (gen, mpd, msd)], rows=len(batch.mel))


def _e2e(inp, mesh, group):
    from e2e_tts_tpu_torch.nn import discriminators
    from e2e_tts_tpu_torch.nn.hifigan import TrainableHifiGan
    from e2e_tts_tpu_torch.parallel import local_rows, shard_batch
    from e2e_tts_tpu_torch.train import (E2EBatch, acoustic_optimizer, build_acoustic_model,
                                         gan_optimizer, init_e2e_state, make_e2e_train_step)

    cfg = inp["config"]
    model = build_acoustic_model(cfg, inp["n_symbols"], inp["n_speakers"], dropout=False,
                                 device="cpu")
    gen = TrainableHifiGan.from_config(cfg.models.hifigan, device="cpu")
    mpd, msd = discriminators.build_discriminators(**inp["disc"])
    for m, sd in zip((model, gen, mpd, msd), inp["state_dicts"]):
        m.load_state_dict(sd)
    tp = _split(mesh, model, gen)
    am_opt = acoustic_optimizer(cfg.train.fastspeech2_optimizer,
                                cfg.models.fastspeech2.encoder_hidden)
    g_opt, d_opt = (gan_optimizer(cfg.train.hifigan_optimizer) for _ in range(2))
    state = init_e2e_state(model, gen, am_opt, g_opt, d_opt, mpd, msd, group=group)
    state.step = inp["step"]
    step = make_e2e_train_step(model, gen, cfg, am_opt, g_opt, d_opt, inp["n_words"],
                               inp["segment"], mpd=mpd, msd=msd, group=group, model_group=tp)
    rows = local_rows(len(inp["audio"]), mesh)
    batch = E2EBatch(shard_batch(E2EBatch.from_numpy(inp["batch"], inp["audio"], "cpu").acoustic,
                                 mesh), torch.from_numpy(inp["audio"][rows]))
    state, metrics = step(state, batch, torch.from_numpy(inp["starts"][rows]))
    names = [n for n, _ in model.named_parameters()]
    return dict(metrics={k: v.item() for k, v in metrics.items()},
                mu=dict(zip(names, state.am_opt_state.mu)),
                state_dicts=[m.state_dict() for m in (model, gen, mpd, msd)])


def _forward(inp, mesh, group):
    """Stage 1 and 2 of the acoustic model, unsplit and then split: each
    one's durations and mel, the (B * H, T, D) shapes that reached the flash
    wrapper in the split run, and its launch count there."""
    import e2e_tts_tpu_torch.nn.transformer as transformer
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    device = "cpu" if inp.get("device", "cpu") == "cpu" else None
    eng = (SynthesisEngine.from_checkpoint(inp["bundle"], device=device) if inp.get("bundle")
           else SynthesisEngine.from_random(seed=0, device=device))
    model, dev = eng.acoustic, eng.device
    args = [torch.from_numpy(inp[k]).to(dev) for k in ("speakers", "texts", "txt_lens")]

    def run():
        x, durations = model.synthesize_stage1(*args)
        mel, mel_lens = model.synthesize_stage2(x, durations, inp["T"])
        return dict(durations=durations.cpu(), mel=mel.float().cpu(), mel_lens=mel_lens.cpu())

    out = dict(single=run())
    _split(mesh, model)
    real, shapes = transformer.flash_attention, []
    transformer.flash_attention = lambda q, *a, **k: shapes.append(tuple(q.shape)) or real(
        q, *a, **k)
    before = real.launches
    try:
        out["split"] = run()
    finally:
        transformer.flash_attention = real
    out.update(flash_shapes=shapes, launches=real.launches - before,
               wq_rows=model.decoder.layers[0].slf_attn.w_q.weight.shape[0])
    return out


def _serve(inp, mesh, group):
    from e2e_tts_tpu_torch.serve.engine import SynthesisEngine

    eng = SynthesisEngine.from_checkpoint(inp["bundle"], device="cpu", global_mesh=True,
                                          batch_size=inp["batch_size"])
    return dict(audio=[eng.synthesize(t) for t in inp["texts"]], batch_size=eng.batch_size,
                row_buckets=eng._row_buckets, n_devices=eng.n_devices)


def _shard(inp, mesh, group):
    from e2e_tts_tpu_torch.parallel import make_mesh, param_sharding_rules, shard_params

    module = inp["module"]
    tp = make_mesh(model_parallel=int(os.environ["WORLD"]))
    return dict(local={n: d.to_local() for n, d in shard_params(module, tp).items()},
                dims={n: [p.dim for p in pl if p.is_shard()]
                      for n, pl in param_sharding_rules(module, tp).items()})


def _cli(inp, mesh, group):
    """Each argument list through ``cli.main``: the steps it returns, what it
    printed, and the acoustic model it trained last (its state_dict)."""
    import contextlib
    import io

    from e2e_tts_tpu_torch.train import cli

    built = []
    real = cli._acoustic_model
    cli._acoustic_model = lambda *a, **k: built.append(real(*a, **k)) or built[-1]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            steps = [cli.main(argv) for argv in inp["argvs"]]
    finally:
        cli._acoustic_model = real
    return dict(steps=steps, printed=out.getvalue(), state_dict=built[-1].state_dict(),
                work=inp["work"])


TASKS = dict(acoustic=_acoustic, vocoder=_vocoder, e2e=_e2e, forward=_forward, serve=_serve,
             shard=_shard, cli=_cli)


def main(inputs: str, rank: int, world: int, port: int, out: str) -> None:
    from e2e_tts_tpu_torch.parallel import initialize, make_data_mesh
    from e2e_tts_tpu_torch.parallel.data_parallel import data_group
    from e2e_tts_tpu_torch.parallel.distributed import backend

    os.environ["WORLD"] = str(world)
    spec = torch.load(inputs, weights_only=False)
    device = spec.get("device", "cpu")
    if device != "cpu":  # parity on the card: full float32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    assert initialize(f"127.0.0.1:{port}", world, rank, device="cpu" if device == "cpu" else None,
                      timeout_s=120)
    assert backend() == "gloo"
    result = {}
    for task in spec["tasks"]:
        inp = spec[task]
        mesh = make_data_mesh(inp.get("global_batch", world), inp.get("model_parallel", 1))
        result[task] = TASKS[inp.get("task", task)](dict(inp, device=device), mesh,
                                                    data_group(mesh))
    torch.save(result, out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    np.seterr(all="ignore")
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
