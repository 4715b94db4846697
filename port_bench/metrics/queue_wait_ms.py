"""Mean wait of a request in the queue, in ms: the program's
``request.queued`` spans (``serve/queue.py``: from the enqueue in
``submit`` to the collector's pop) over the window's requests."""

from port_bench import spans as program


def read(rec):
    r = program.records()
    waits = [program.duration_ns(s) for s in (r[0] if r else ()) if s.name == "request.queued"]
    return sum(waits) / len(waits) / 1e6 if waits else None
