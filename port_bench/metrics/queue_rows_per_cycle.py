"""Chunk rows a queue cycle hands the engine: the rows the engine's stage 1
ran (the recorder's hooks) over ``BatchingServer.n_cycles`` in the window."""


def read(rec):
    c = rec["counters"]
    return c["rows"] / c["cycles"] if c.get("cycles") else None
