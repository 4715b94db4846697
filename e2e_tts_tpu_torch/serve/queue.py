"""Cross-request batching queue for multi-tenant serving (port of
``e2e_tts_tpu/serve/queue.py``).

Concurrent requests are packed into the engine's bucketed batches: a
collector thread drains the lanes for up to ``max_wait_ms``, groups requests
by their (pitch, energy, duration) control scalars (one batch runs one set
of controls), flattens every request's chunk sequences
into one sequence list with per-row speaker ids, and runs the engine's
batched two-stage pipeline once per group.  Requests resolve through
``concurrent.futures.Future``; a failed request fails only its own future.

Priority lanes: ``submit(..., priority=N)`` (higher = more urgent, default
0).  Each collection cycle fills the batch from the highest non-empty lane
first, so interactive traffic jumps ahead of bulk jobs without separate
server processes; dispatch groups run most-urgent first within the cycle.
Starvation protection: a request that has waited longer than
``age_promote_ms`` is served before any fresher request regardless of lane
(bulk work is delayed, never parked).

The collector thread launches the engine's kernels, so it runs them under
``torch.no_grad()`` (grad mode is per thread).  ``close()`` serves what is
pending and joins the thread.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class _Request:
    seqs: List[np.ndarray]
    speaker: int
    controls: Tuple[float, float, float]
    gap: int
    priority: int = 0
    t_enq: float = 0.0
    future: Future = field(default_factory=Future)


class BatchingServer:
    """Wraps a SynthesisEngine with a submit()/Future request interface."""

    def __init__(
        self,
        engine,
        max_wait_ms: float = 5.0,
        max_batch: Optional[int] = None,
        age_promote_ms: float = 200.0,
    ):
        self.engine = engine
        self.max_wait = max_wait_ms / 1000.0
        self.age_promote = age_promote_ms / 1000.0
        # cap the sequences collected per cycle; default 4 full batches
        self.max_batch = max_batch or 4 * engine.batch_size
        self._lanes: Dict[int, Deque[_Request]] = {}
        self._pending = 0
        self._cv = threading.Condition()
        self._closed = False
        self.n_cycles = 0  # dispatch cycles run (observability)
        self.n_promoted = 0  # aged low-priority requests served early
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # --- client API ---------------------------------------------------------

    def submit(
        self,
        text,
        speaker_id: Optional[str] = None,
        pitch_control: float = 1.0,
        energy_control: float = 1.0,
        duration_control: float = 1.0,
        silence_distance: float = 0.5,
        priority: int = 0,
    ) -> Future:
        """Enqueue a request; resolves to the int16 waveform."""
        if self._closed:
            raise RuntimeError("BatchingServer is closed")
        req = _Request(
            seqs=[], speaker=0,
            controls=(
                float(pitch_control), float(energy_control),
                float(duration_control),
            ),
            gap=int(silence_distance * self.engine.sample_rate),
            priority=int(priority),
        )
        try:
            # host-side text work happens on the caller's thread, so the
            # collector thread only does batching + device dispatch
            req.seqs, req.speaker = self.engine.prepare_request(
                text, speaker_id
            )
        except Exception as exc:  # unknown speaker, bad text
            req.future.set_exception(exc)
            return req.future
        if not req.seqs:
            req.future.set_result(np.zeros(0, np.int16))
            return req.future
        with self._cv:
            if self._closed:
                # close() may have won the race while prepare_request ran;
                # enqueueing now would strand the future (worker is gone)
                req.future.set_exception(
                    RuntimeError("BatchingServer is closed")
                )
                return req.future
            req.t_enq = time.monotonic()
            self._lanes.setdefault(req.priority, deque()).append(req)
            self._pending += 1
            self._cv.notify()
        return req.future

    def synthesize(self, text, **kw) -> np.ndarray:
        """Blocking convenience: submit + wait."""
        return self.submit(text, **kw).result()

    def close(self):
        """Stop accepting requests; pending ones are still served."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- collector ----------------------------------------------------------

    def _pop_locked(self, now: float) -> _Request:
        """Next request under _cv: oldest-if-aged, else highest lane FIFO."""
        oldest = min(
            (lane[0] for lane in self._lanes.values() if lane),
            key=lambda r: r.t_enq,
        )
        if now - oldest.t_enq > self.age_promote:
            req = oldest
            top = max(p for p, lane in self._lanes.items() if lane)
            if req.priority < top:
                self.n_promoted += 1
        else:
            top = max(p for p, lane in self._lanes.items() if lane)
            req = self._lanes[top][0]
        lane = self._lanes[req.priority]
        lane.popleft()
        if not lane:
            # drop empty lanes so the min/max scans stay O(live priorities)
            del self._lanes[req.priority]
        self._pending -= 1
        return req

    def _collect(self) -> List[_Request]:
        """Block for the first request, then drain for up to max_wait,
        taking from the highest-priority lane at every step."""
        with self._cv:
            while self._pending == 0:
                if self._closed:
                    return []
                self._cv.wait()
            now = time.monotonic()
            batch = [self._pop_locked(now)]
            n_seqs = len(batch[0].seqs)
            deadline = now + self.max_wait
            while n_seqs < self.max_batch:
                if self._pending == 0:
                    if self._closed:
                        break
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    self._cv.wait(timeout=timeout)
                    continue
                if time.monotonic() >= deadline:
                    break
                req = self._pop_locked(time.monotonic())
                batch.append(req)
                n_seqs += len(req.seqs)
        return batch

    def _worker(self):
        with torch.no_grad():
            self._serve()

    def _serve(self):
        while True:
            batch = self._collect()
            if not batch:
                return
            self.n_cycles += 1
            # group by control scalars (one dispatch group per distinct
            # (p, e, d)); dispatch the most urgent group first
            groups: Dict[Tuple[float, float, float], List[_Request]] = {}
            for req in batch:
                groups.setdefault(req.controls, []).append(req)
            ordered = sorted(
                groups.items(),
                key=lambda kv: -max(r.priority for r in kv[1]),
            )
            for (p, e, d), reqs in ordered:
                seqs, speakers, owners = [], [], []
                for ri, req in enumerate(reqs):
                    seqs.extend(req.seqs)
                    speakers.extend([req.speaker] * len(req.seqs))
                    owners.extend([ri] * len(req.seqs))
                try:
                    audios = self.engine._synthesize_sequences(
                        seqs, speakers, p, e, d
                    )
                except Exception as exc:
                    for req in reqs:
                        if not req.future.done():
                            req.future.set_exception(exc)
                    continue
                per_req: List[List[np.ndarray]] = [[] for _ in reqs]
                for audio, ri in zip(audios, owners):
                    per_req[ri].append(audio)
                for req, parts in zip(reqs, per_req):
                    try:
                        req.future.set_result(
                            self.engine._combine(parts, req.gap)
                        )
                    except Exception as exc:
                        if not req.future.done():
                            req.future.set_exception(exc)
