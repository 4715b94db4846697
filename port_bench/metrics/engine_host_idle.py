"""Share of the window in which the card is idle while the engine's thread
does host work, in %: on each thread that ran an ``engine.*`` span, the
union of its host-work spans (``request.frontend``, ``engine.pack``,
``engine.launch``, ``engine.drain``, ``request.stitch``, ...) less its
waiting spans (``engine.fetch``: blocked on the card), less the device
operations' union, over the window.  At most ``device_idle``: the spans lie
inside the window."""

import collections

from port_bench import spans as program

HOST = "host"


def read(rec):
    r = program.records()
    if r is None or rec["window_s"] <= 0:
        return None
    by_thread = collections.defaultdict(list)
    for s in r[0]:
        by_thread[s.thread].append(s)
    work = []
    for spans in by_thread.values():
        if not any(s.name.startswith("engine.") for s in spans):
            continue
        host = program.union((s.start_ns, s.end_ns) for s in spans if s.kind == HOST)
        waits = program.union((s.start_ns, s.end_ns) for s in spans if s.kind != HOST)
        work.extend(program.minus(host, waits))
    if not work:
        return None
    idle = program.measure(program.minus(program.union(work), program.device_busy(rec)))
    return 100.0 * idle / (rec["window_s"] * 1e9)
