"""Share of the calls of the engine's graphed serving modules in the window
that replayed a CUDA graph, in %: the program's ``graph.replay`` counts over
its ``graph.replay`` and ``graph.eager`` counts (``serve/graphs.py`` counts
one of the two a call).  None where the window recorded neither, as a
program without the graphs records."""

from port_bench import spans as program


def read(rec):
    r = program.records()
    if r is None:
        return None
    replay = sum(c.amount for c in r[1] if c.name == "graph.replay")
    eager = sum(c.amount for c in r[1] if c.name == "graph.eager")
    if replay + eager <= 0:
        return None
    return 100.0 * replay / (replay + eager)
