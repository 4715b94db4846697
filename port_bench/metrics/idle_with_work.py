"""Share of the window in which no device operation runs while a request is
in the system, in %: the union of each request's interval from the end of
its ``request.frontend`` span to the end of its ``request.resolve`` span,
less the device operations' union, over the window.  Requests' intervals lie
inside the window (it opens before the first is sent and closes after the
last resolves), so this is at most ``device_idle``."""

from port_bench import spans as program


def read(rec):
    r = program.records()
    if r is None or rec["window_s"] <= 0:
        return None
    begin, end = {}, {}
    for s in r[0]:
        if s.name == "request.frontend" and s.request is not None:
            begin[s.request] = s.end_ns
        elif s.name == "request.resolve" and s.request is not None:
            end[s.request] = s.end_ns
    work = program.union((begin[k], end[k]) for k in begin.keys() & end.keys())
    if not work:
        return None
    idle = program.measure(program.minus(work, program.device_busy(rec)))
    return 100.0 * idle / (rec["window_s"] * 1e9)
