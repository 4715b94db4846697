"""Background-thread batch prefetching (a copy of
``e2e_tts_tpu/utils/prefetch.py``).

Host-side batch assembly (feature .npy loads, padding, the prior, the copy
to the device) runs in a worker thread so it overlaps the device step, as
the reference's DataLoader worker does (dataloader.py num_workers=1).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch_iterator(iterable: Iterable[T], size: int = 2) -> Iterator[T]:
    """Yield from ``iterable`` with up to ``size`` items computed ahead; an
    exception of the worker is raised again in the consumer, after the items
    made before it."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    err: list = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        yield item
    if err:
        raise err[0]
