"""Train checkpoints and warm start (port of
``e2e_tts_tpu/train/checkpoint.py`` and ``warm_start_params`` of
``e2e_tts_tpu/train/cli.py``).

A checkpoint is a numbered step directory ``<directory>/<step>/`` holding
``state.pt``, PyTorch's own format (``torch.save`` of plain containers of
CPU tensors), so ``scan_checkpoint`` reads the port's directories and the
JAX package's orbax directories alike; the port does not read orbax's
files (bundles are the format the two packages share).

Across processes (``parallel/distributed``), a manager given the data group
saves as Orbax's multi-process save does for JAX: rank 0 alone writes, and
waits for the file, then every rank of the group meets at a barrier, so
that what one rank reads next the others read too.  Every rank restores
into its own template, on its own device: the twin of JAX's
``restore_sharded`` with the model axis at 1, where every placement is
replicated.

A state is any tree of: modules (their ``state_dict``: parameters and
BatchNorm statistics), tensors, ``torch.Generator``s (their state),
dataclasses (``AcousticTrainState``, ``VocoderTrainState``, ``E2EState``,
``AdamState``: the step, the moments and the update count), dicts, lists,
tuples and plain numbers.  The vocoder and e2e states hold the optimizers'
moments but not the modules, so a caller saves them together, e.g.
``{"state": state, "generator": g, "mpd": mpd, "msd": msd}``.  ``save``
copies every tensor to the host at once and writes in a background thread;
``restore`` loads into the template in place (on the template's devices)
and returns it.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import warnings
from typing import Any, Optional

import numpy as np
import torch

_FILE = "state.pt"
_MODULE, _GENERATOR = "__module__", "__generator__"


def _snapshot(x):
    """The tree with every tensor copied to the host, modules as their
    ``state_dict``s and generators as their states."""
    if isinstance(x, torch.nn.Module):
        return {_MODULE: {k: v.detach().to("cpu", copy=True) for k, v in x.state_dict().items()}}
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.Generator):
        return {_GENERATOR: x.get_state()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _snapshot(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_snapshot(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _restore(template, saved, path: str = ""):
    """Load ``saved`` into ``template`` in place; returns the restored value
    (the template itself for everything but plain numbers)."""
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(saved[_MODULE])
        return template
    if isinstance(template, torch.Tensor):
        if tuple(template.shape) != tuple(saved.shape):
            raise ValueError(f"{path}: saved {tuple(saved.shape)} vs template "
                             f"{tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(saved)
        return template
    if isinstance(template, torch.Generator):
        if saved is not None:  # a generator that the saving run did not hold stays as it is
            template.set_state(saved[_GENERATOR])
        return template
    if template is None and isinstance(saved, dict) and _GENERATOR in saved:
        return None  # a generator of the saving run that this run does not hold
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        for f in dataclasses.fields(template):
            if f.name not in saved and f.default is None:
                continue  # an optional field that the saving version did not have
            setattr(template, f.name,
                    _restore(getattr(template, f.name), saved[f.name], f"{path}.{f.name}"))
        return template
    if isinstance(template, dict):
        for k in template:
            template[k] = _restore(template[k], saved[k], f"{path}/{k}")
        return template
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError(f"{path}: saved {len(saved)} items vs template {len(template)}")
        out = [_restore(t, s, f"{path}[{i}]") for i, (t, s) in enumerate(zip(template, saved))]
        if isinstance(template, list):
            template[:] = out
            return template
        return type(template)(out)
    return saved


class CheckpointManager:
    """Numbered checkpoints in ``directory``, the newest ``max_to_keep``
    kept.  ``group``: the process group that saves together (module
    docstring; None and one process: this process writes alone)."""

    def __init__(self, directory: str, max_to_keep: int = 5, group=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.group = group
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _steps(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n, _FILE)))

    def _write(self, step: int, tree) -> None:
        try:
            final = os.path.join(self.directory, str(step))
            tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
            os.makedirs(tmp, exist_ok=True)
            torch.save(tree, os.path.join(tmp, _FILE))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Copy ``state``'s tensors to the host now, write them in the
        background (after any save still being written).  Across processes
        rank 0 writes and waits, and the group meets at a barrier."""
        from ..parallel.distributed import barrier, is_primary, process_count

        if process_count() > 1:
            if is_primary():
                self._save(step, state, wait=True)
            barrier(self.group)
            return
        self._save(step, state, wait)

    def _save(self, step: int, state: Any, wait: bool) -> None:
        tree = _snapshot(state)
        self.wait()
        self._thread = threading.Thread(target=self._write, args=(int(step), tree), daemon=True)
        self._thread.start()
        if wait:
            self.wait()

    def wait(self) -> None:
        """Block until the last save is on disk; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Load step ``step`` (the latest when None) into ``template`` in
        place and return it; the template unchanged when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return template
        self.wait()
        saved = torch.load(os.path.join(self.directory, str(step), _FILE), map_location="cpu",
                           weights_only=True)
        return _restore(template, saved)

    def close(self) -> None:
        self.wait()


def scan_checkpoint(directory: str) -> Optional[int]:
    """Latest checkpoint step in a directory (reference scan_checkpoint,
    tools_for_model.py:180-185)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.isdigit():
            steps.append(int(name))
    return max(steps) if steps else None


@torch.no_grad()
def warm_start_params(model: torch.nn.Module, bundle_dir: str) -> torch.nn.Module:
    """Graft a deploy bundle's acoustic weights onto a fresh ``model`` in
    place, for fine-tuning on a new voice: parameters whose shapes match
    copy over; a speaker-embedding table with another number of rows copies
    the overlapping speakers and starts the new ones from the bundle's mean
    voice.  Other mismatches, and parameters the bundle lacks, keep their
    fresh init with a warning.  Buffers (BatchNorm's statistics) keep
    theirs, as the JAX package grafts ``params`` only."""
    from ..convert import convert
    from ..serve.bundle import read_msgpack

    src = read_msgpack(os.path.join(bundle_dir, "acoustic.msgpack"))
    arrays = convert({"params": src.get("params", src)})
    for name, p in model.named_parameters():
        if name not in arrays:
            warnings.warn(f"warm start: no source for {name}")
            continue
        a = arrays[name]
        if tuple(a.shape) == tuple(p.shape):
            p.copy_(torch.from_numpy(a))
        elif "speaker_emb" in name and a.ndim == p.dim() == 2 and a.shape[1] == p.shape[1]:
            out = np.empty(tuple(p.shape), np.float32)
            n = min(len(a), len(out))
            out[:n] = a[:n]
            if len(out) > n:  # new speakers start from the mean voice
                out[n:] = a.mean(axis=0)
            p.copy_(torch.from_numpy(out))
        else:
            warnings.warn(f"warm start: shape mismatch at {name} {a.shape} vs "
                          f"{tuple(p.shape)}; keeping fresh init")
    return model
