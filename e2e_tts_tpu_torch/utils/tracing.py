"""Spans and counters inside the port, recorded while a ``torch.profiler``
session records.

A span is a named interval of one thread: its start and end on
``time.time_ns()`` (the clock ``port_bench/trace.py`` maps the profiler's
device operations onto), the thread's CPU time over it
(``time.thread_time_ns``), the span open on the same thread when it began
(its parent), its kind, and three ids: the request it serves, the queue
cycle and the batch.  An id left out is taken from the parent.  The kind
says what the thread does in it: ``HOST`` work, ``DEVICE_WAIT`` (blocked
on the card: a ``.cpu()`` fetch, a copy from pageable memory) or ``WAIT``
(blocked on another thread: a queue, a condition).  A counter is a name,
an amount and the same ids.

The switch is the profiler: sites record only while
``torch.autograd.profiler._is_profiler_enabled`` is set, which
``torch.profiler.profile``'s ``start()`` and ``stop()`` flip.  Off, a site
checks that flag and gets the shared ``NOOP``: nothing is allocated and no
clock is read.  Records are kept in memory (the newest ``LIMIT`` of each)
and handed out by ``spans()`` and ``counts()``, which leave them in place,
so that every reader of a run sees the same records.

Readers: ``utils/profiling.device_trace`` writes them into its Chrome trace
beside the kernels (``chrome_events``), and the benchmark's per-layer
metrics read them after a traced window.

Sites (the module and what each span covers):

- ``serve/queue.py``: ``request.frontend`` (``prepare_request`` on the
  caller's thread), ``request.queued`` (enqueue to the collector's pop;
  ``WAIT``), ``queue.collect`` (first pop to the batch closing; ``WAIT``),
  ``queue.cycle`` (a cycle's dispatch to its last future resolved; one a
  ``n_cycles``) with counter ``queue.rows``, ``request.stitch``,
  ``request.resolve`` (``set_result`` and its callbacks);
- ``serve/engine.py``: ``engine.pack``, ``engine.launch``, ``engine.fetch``
  (``DEVICE_WAIT``), ``engine.drain`` with counter
  ``engine.rerender_rows``, counter ``engine.cold_shape``; ``synthesize``'s
  ``request.frontend`` and ``request.stitch``;
- ``utils/prefetch.py``: ``train.batch_wait`` (the consumer in ``q.get()``;
  ``WAIT``);
- ``data/dataset.py``: ``data.batch`` (one acoustic batch made) and its
  children ``data.load``, ``data.collate``, ``data.prior``;
  ``train/acoustic_step.py``: ``data.copy`` (``AcousticBatch.from_numpy``;
  ``DEVICE_WAIT``), ``step.forward``, ``step.backward``, ``step.reduce``
  (data or model groups only), ``step.optimizer``;
- ``train/cli.py``: ``train.log``, ``train.checkpoint`` (the ``acoustic`` loop).
"""

from __future__ import annotations

import itertools
import statistics
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

HOST, DEVICE_WAIT, WAIT = "host", "device_wait", "wait"
LIMIT = 1 << 18  # records of each kind kept (the oldest go first)
MARK = "tracing.clock_mark"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int            # threading.get_native_id(), the profiler's tid
    cpu_ns: Optional[int]  # the thread's CPU time over the span; None across threads
    kind: str
    sid: int
    parent: Optional[int]  # sid of the span open on the thread when it began
    request: Optional[int]
    cycle: Optional[int]
    batch: Optional[int]


class Count(NamedTuple):
    name: str
    amount: float
    t_ns: int
    thread: int
    request: Optional[int]
    cycle: Optional[int]
    batch: Optional[int]


class _Noop:
    """What a site gets while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def close(self):
        pass


NOOP = _Noop()


class Tracer:
    """The records of one process (``TRACER``, which the module's functions
    use): spans and counters, the open spans of each thread, the ids."""

    def __init__(self, limit: int = LIMIT):
        self.spans: deque = deque(maxlen=limit)
        self.counts: deque = deque(maxlen=limit)
        self.local = threading.local()
        self.ids = itertools.count(1)

    def stack(self) -> list:
        """The calling thread's open spans, innermost last."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


TRACER = Tracer()


class _Open:
    """A span being recorded: a context manager, or ``start``/``close``."""

    __slots__ = ("name", "kind", "request", "cycle", "batch", "sid", "parent", "t0", "cpu0",
                 "done")

    def __init__(self, name, kind, request, cycle, batch):
        self.name, self.kind = name, kind
        self.request, self.cycle, self.batch = request, cycle, batch
        self.done = False

    def __enter__(self):
        stack = TRACER.stack()
        up = stack[-1] if stack else None
        if up is not None:
            self.request = up.request if self.request is None else self.request
            self.cycle = up.cycle if self.cycle is None else self.cycle
            self.batch = up.batch if self.batch is None else self.batch
        self.parent = up.sid if up is not None else None
        self.sid = next(TRACER.ids)
        stack.append(self)
        self.cpu0 = time.thread_time_ns()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.time_ns()
        cpu = time.thread_time_ns() - self.cpu0
        if self.done:
            return None
        self.done = True
        stack = TRACER.stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        TRACER.spans.append(Span(self.name, self.t0, t1, threading.get_native_id(), cpu,
                                 self.kind, self.sid, self.parent, self.request, self.cycle,
                                 self.batch))
        return None

    def close(self):
        self.__exit__(None, None, None)


def enabled() -> bool:
    """Whether a profiler records, and with it the sites."""
    return _profiler._is_profiler_enabled


def new_id() -> int:
    """A fresh id, unique in the process (for a request, a batch)."""
    return next(TRACER.ids)


def span(name: str, kind: str = HOST, request=None, cycle=None, batch=None):
    """``with span(...):`` records the block as a span."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    return _Open(name, kind, request, cycle, batch)


def start(name: str, kind: str = HOST, request=None, cycle=None, batch=None):
    """A span begun now and recorded by its ``close()``, for a span that no
    block holds (one that ends before a generator's ``yield``)."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    return _Open(name, kind, request, cycle, batch).__enter__()


def record(name: str, start_ns: int, end_ns: int, kind: str = WAIT, request=None, cycle=None,
           batch=None) -> None:
    """A span measured by the caller (``time.time_ns()``), such as one that
    begins on one thread and ends on another: no CPU time, no parent."""
    if _profiler._is_profiler_enabled:
        TRACER.spans.append(Span(name, start_ns, end_ns, threading.get_native_id(), None, kind,
                                 new_id(), None, request, cycle, batch))


def count(name: str, amount: float = 1, request=None, cycle=None, batch=None) -> None:
    """A counter; ids left out are the innermost open span's."""
    if not _profiler._is_profiler_enabled:
        return
    stack = TRACER.stack()
    if stack:
        up = stack[-1]
        request = up.request if request is None else request
        cycle = up.cycle if cycle is None else cycle
        batch = up.batch if batch is None else batch
    TRACER.counts.append(Count(name, amount, time.time_ns(), threading.get_native_id(),
                               request, cycle, batch))


def spans() -> List[Span]:
    """The spans recorded (a copy; the records stay)."""
    return list(TRACER.spans)


def counts() -> List[Count]:
    """The counters recorded (a copy; the records stay)."""
    return list(TRACER.counts)


def clear() -> None:
    TRACER.spans.clear()
    TRACER.counts.clear()


def clock_marks(n: int = 3) -> List[int]:
    """Inside a profiler session: the host times (``time.time_ns``) of ``n``
    ``record_function`` marks, for ``clock_offset_ns``."""
    marks = []
    for _ in range(n):
        a = time.time_ns()
        with _profiler.record_function(MARK):
            b = time.time_ns()
        marks.append((a + b) // 2)
    return marks


def clock_offset_ns(prof, marks: List[int]) -> int:
    """The profiler's clock minus ``time.time_ns``'s, from the marks'
    events of a stopped ``torch.profiler.profile`` (the median, as
    ``port_bench/trace.py`` takes it from its marker kernels)."""
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == MARK)[:len(marks)]
    if len(starts) != len(marks) or not marks:
        return 0
    return int(statistics.median(s - m for s, m in zip(starts, marks)))


def chrome_events(offset_ns: int, base_ns: int, t0_ns: int, t1_ns: int, pid: int) -> List[dict]:
    """Chrome trace events of the spans and counters between ``t0_ns`` and
    ``t1_ns`` (host clock), at ``(t + offset_ns - base_ns) / 1e3`` us: the
    profiler's clock less the trace's ``baseTimeNanoseconds``."""
    us = lambda t: (t + offset_ns - base_ns) / 1e3  # noqa: E731
    ids = lambda r: {k: v for k, v in (("request", r.request), ("cycle", r.cycle),  # noqa: E731
                                       ("batch", r.batch)) if v is not None}
    out = []
    for s in spans():
        if s.end_ns < t0_ns or s.start_ns > t1_ns:
            continue
        args = dict(kind=s.kind, sid=s.sid, parent=s.parent, **ids(s))
        if s.cpu_ns is not None:
            args["cpu_us"] = s.cpu_ns / 1e3
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                    "tid": s.thread, "ts": us(s.start_ns), "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": args})
    for c in counts():
        if t0_ns <= c.t_ns <= t1_ns:
            out.append({"ph": "i", "s": "t", "cat": "program_counter", "name": c.name,
                        "pid": pid, "tid": c.thread, "ts": us(c.t_ns),
                        "args": dict(amount=c.amount, **ids(c))})
    return out
