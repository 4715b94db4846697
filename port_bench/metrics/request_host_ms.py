"""Host ms a request spends in the host frontend layer: per request id,
its ``request.frontend`` (``prepare_request`` on the caller's thread),
``request.stitch`` and ``request.resolve`` spans summed, the mean over the
window's requests."""

import collections

from port_bench import spans as program

NAMES = ("request.frontend", "request.stitch", "request.resolve")


def read(rec):
    r = program.records()
    per = collections.defaultdict(int)
    for s in (r[0] if r else ()):
        if s.name in NAMES and s.request is not None:
            per[s.request] += program.duration_ns(s)
    return sum(per.values()) / len(per) / 1e6 if per else None
