"""Host ms to make one batch: the mean over the window's batches of the time
the batcher's generator took to yield each, in the prefetch thread (the
benchmark's wrapper around ``data.make_acoustic_batches``)."""


def read(rec):
    ms = rec["counters"].get("batch_host_ms")
    return sum(ms) / len(ms) if ms else None
