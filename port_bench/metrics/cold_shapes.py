"""Shapes the engine ran for the first time in the process during the
window: the program's ``engine.cold_shape`` counts (``serve/engine.py``; a
stage-1 (rows, text bucket) or stage-2 (rows, mel bucket) shape new to the
process needs cuDNN plans and allocator blocks of its own).  None where the
window recorded no queue cycle, so that a silent tracer does not read 0."""

from port_bench import spans as program


def read(rec):
    r = program.records()
    if r is None or not any(s.name == "queue.cycle" for s in r[0]):
        return None
    return float(sum(c.amount for c in r[1] if c.name == "engine.cold_shape"))
