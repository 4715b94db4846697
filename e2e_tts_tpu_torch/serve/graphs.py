"""Per-shape CUDA graphs of the engine's serving modules.

A serving stage at phoneme rate is hundreds of kernels of a few
microseconds each, and the host takes longer to issue each one than the
card takes to run it, so eagerly the card waits on the launches.  A CUDA
graph replays a module's whole chain of kernels with one launch.

``SynthesisEngine`` on CUDA installs a cache (``GraphCache.install``) on
each of its serving modules (``serving_modules``: the encoder, the
decoder, the duration, pitch and energy predictors, the postnet and the
vocoder generator), and on each replica's copies.  The speaker and
variance embeddings, ``mel_linear``, the length regulator, the inverse
STFT and the wire encoding stay eager (a few launches each), and so does
the folded HiFi-GAN tail (``use_folded_vocoder``), which is not the
generator's call.  Only classes that declare ``graph_safe = True`` are
graphed: their call launches no host copy, synchronises nothing and reads
no tensor that the module replaces between calls.  The other block
families' encoders and decoders (conformer, fastformer, lstransformer,
reformer) do not declare it and stay eager.

The cache is the module's own ``forward`` (an instance attribute), so a
call still goes through ``nn.Module.__call__`` and its hooks fire on every
call.  It engages on a call with positional CUDA tensors on the module's
device, on that device's default stream, autograd off, the module in eval
mode and none of its layers split over a model group; its key is each
argument's shape, strides and dtype (a non-tensor argument: its type and
value).  At a key:

- the first call runs eagerly, as without the cache (it is also the cold
  call that builds cuDNN's plans and the kernels' lazy state);
- the second runs eagerly on a side stream, which is the call's result and
  the stream's warm-up, then captures the module there into a graph
  (``capture_error_mode="thread_local"``, so other threads keep launching);
- every later call copies its tensors into the graph's static inputs,
  replays it, and copies each output out on the same stream, so that every
  call returns fresh tensors.

So the shapes that a warm-up sweep runs once capture nothing until traffic
calls them again.  A capture that fails raises: nothing falls back.

The graphs of one device share one memory pool
(``torch.cuda.graph_pool_handle``), so a graph's replay overwrites the
blocks that another graph's capture freed, the other's static outputs
included.  A lock per pool therefore holds each replay, from its inputs'
copies to its outputs' copies, and each capture.

A graph reads the weights it captured, and a 16-bit engine's are the cast
copies that ``nn/common.cast_param`` keeps, which it makes anew (and frees)
when a parameter changes.  So each engaged call sums the versions of the
module's parameters, and a sum that moved (a load or any in-place update)
drops the module's graphs: the shapes capture anew.  A parameter replaced
by another tensor, or moved, is not seen: it must stay where it was while
the module is installed.

Counters (``utils/tracing.py``): ``graph.replay`` or ``graph.eager`` once
a call of an installed module, and ``graph.capture`` once a capture.  The
flash kernel's launches inside a capture are tallied, not counted
(``kernels/flash_attention.tallied_launches``), and each replay adds them.
"""

from __future__ import annotations

import contextlib
import threading
import types
from typing import Dict, List, Tuple

import torch

from ..kernels.flash_attention import count_launches, tallied_launches
from ..utils import tracing

_SEEN = object()  # a key called once: the next call captures


def serving_modules(acoustic, vocoder) -> List[torch.nn.Module]:
    """The modules of a FastSpeech2 and a vocoder generator that the engine
    graphs, where their classes declare it."""
    va = acoustic.variance_adaptor
    mods = [acoustic.encoder, acoustic.decoder, va.duration_predictor, va.pitch_predictor,
            va.energy_predictor, acoustic.postnet, vocoder]
    return [m for m in mods if getattr(type(m), "graph_safe", False)]


class _Pool:
    """What the graphs of one device share: the memory pool, the side stream
    their captures run on, and the lock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device)
        self.lock = threading.Lock()


class GraphCache:
    """The graph pools of one engine's models, one per CUDA device."""

    def __init__(self):
        self._pools: Dict[torch.device, _Pool] = {}

    def install(self, *modules: torch.nn.Module) -> None:
        for m in modules:
            device = next(m.parameters()).device
            if device.type == "cuda" and device not in self._pools:
                self._pools[device] = _Pool(device)
            m._graphs = _ModuleGraphs(self._pools.get(device))
            m.forward = types.MethodType(_graphed_forward, m)


class _ModuleGraphs:
    """One module's keys and graphs, on its device's pool (None off the
    card).  A deep copy (an engine's replica) starts with none, on the same
    pool."""

    def __init__(self, pool):
        self.pool = pool
        self.entries: Dict[tuple, object] = {}
        self.splittable = None  # the layers that parallelize may split (found at first call)
        self.params = None  # the module's parameters (found at first call)
        self.version = None  # the sum of their versions that the entries were made at

    def split(self, module) -> bool:
        """Whether a layer of ``module`` is split over a model group
        (``parallel/tensor_parallel.parallelize`` sets its ``tp``): its
        collectives and sliced weights are not what a graph captured."""
        if self.splittable is None:
            self.splittable = [m for m in module.modules() if hasattr(type(m), "tp")]
        return any(m.tp is not None for m in self.splittable)

    def drop_if_changed(self, module) -> None:
        """Drop the entries if a parameter of ``module`` changed in place
        since they were made (module docstring)."""
        if self.params is None:
            self.params = list(module.parameters())
        version = sum(p._version for p in self.params)
        if version != self.version:
            self.entries.clear()
            self.version = version

    def __deepcopy__(self, memo):
        return _ModuleGraphs(self.pool)


class _Graph:
    """A captured call: the graph, its static inputs and outputs, the flash
    launches it replays, and whether the module returns a tuple."""

    def __init__(self, graph, pool, inputs, outputs, launches, as_tuple):
        self.graph, self.pool = graph, pool
        self.inputs, self.outputs = inputs, outputs
        self.launches, self.as_tuple = launches, as_tuple

    def replay(self, tensors):
        with self.pool.lock:
            for static, t in zip(self.inputs, tensors):
                static.copy_(t)
            self.graph.replay()
            outs = tuple(o.clone() for o in self.outputs)
        if self.launches:
            count_launches(self.launches)
        return outs if self.as_tuple else outs[0]


def _key(args, device: torch.device):
    """(key, tensors) of a call the cache may graph on ``device``, or None."""
    key, tensors = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.device != device:
                return None
            key.append((a.shape, a.stride(), a.dtype))
            tensors.append(a)
        elif a is None or isinstance(a, (bool, int, float, str)):
            key.append((type(a), a))
        else:
            return None
    stream = torch.cuda.current_stream(device).cuda_stream
    if not tensors or stream != torch.cuda.default_stream(device).cuda_stream:
        return None
    return tuple(key), tensors


def _outputs(out) -> Tuple[torch.Tensor, ...]:
    """A module's result as a tuple of tensors (a tensor, or a tuple of them)."""
    if isinstance(out, torch.Tensor):
        return (out,)
    if isinstance(out, tuple) and all(isinstance(o, torch.Tensor) for o in out):
        return out
    raise TypeError(f"a graphed module returns a tensor or a tuple of them, not {type(out)}")


def _graphed_forward(module, *args, **kwargs):
    """The installed ``forward``: eager, capture or replay (module docstring)."""
    graphs = module._graphs
    call = None
    if (graphs.pool is not None and not _Held.depth and not kwargs and not module.training
            and not torch.is_grad_enabled() and not graphs.split(module)):
        call = _key(args, graphs.pool.device)
    if call is None:
        tracing.count("graph.eager")
        return type(module).forward(module, *args, **kwargs)
    key, tensors = call
    graphs.drop_if_changed(module)
    entry = graphs.entries.get(key)
    if isinstance(entry, _Graph):
        tracing.count("graph.replay")
        return entry.replay(tensors)
    if entry is None:
        graphs.entries[key] = _SEEN
        tracing.count("graph.eager")
        return type(module).forward(module, *args)
    return _capture(module, graphs, key, tensors, args)


def _capture(module, graphs: _ModuleGraphs, key, tensors, args):
    """The second call at ``key``: eager on the pool's side stream (the
    result), then the capture of the module on the same stream."""
    forward = type(module).forward
    pool = graphs.pool
    device = pool.device
    stream = torch.cuda.current_stream(device)
    with pool.lock:
        entry = graphs.entries.get(key)
        if not isinstance(entry, _Graph):  # else another thread captured it meanwhile
            static = {id(t): t.clone() for t in tensors}
            s_args = [static.get(id(a), a) for a in args]
            pool.side.wait_stream(stream)
            with torch.cuda.device(device), torch.cuda.stream(pool.side):
                out = forward(module, *args)
                graph = torch.cuda.CUDAGraph()
                with tallied_launches() as launches:
                    graph.capture_begin(pool=pool.handle, capture_error_mode="thread_local")
                    try:
                        s_out = forward(module, *s_args)
                    finally:
                        graph.capture_end()
            stream.wait_stream(pool.side)
            for t in _outputs(out):
                t.record_stream(stream)
            graphs.entries[key] = _Graph(graph, pool, [static[id(t)] for t in tensors],
                                         _outputs(s_out), launches, isinstance(s_out, tuple))
            tracing.count("graph.capture")
            tracing.count("graph.eager")
            return out
    tracing.count("graph.replay")
    return entry.replay(tensors)


class _Held:
    """How many ``_eager()`` blocks hold every installed module eager."""

    depth = 0
    lock = threading.Lock()


@contextlib.contextmanager
def _eager():
    """Test hook: within, every installed module of the process runs
    eagerly, from any thread, and its calls count ``graph.eager``."""
    with _Held.lock:
        _Held.depth += 1
    try:
        yield
    finally:
        with _Held.lock:
            _Held.depth -= 1
