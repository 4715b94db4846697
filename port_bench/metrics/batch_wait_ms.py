"""Ms a training step waits for its batch: the loop's ``train.batch_wait``
spans (``utils/prefetch.py``: the consumer blocked in ``q.get()``) summed,
over the window's steps (one ``step.optimizer`` span a step)."""

from port_bench import spans as program


def read(rec):
    r = program.records()
    if r is None:
        return None
    steps = sum(1 for s in r[0] if s.name == "step.optimizer")
    wait = sum(program.duration_ns(s) for s in r[0] if s.name == "train.batch_wait")
    return wait / steps / 1e6 if steps else None
