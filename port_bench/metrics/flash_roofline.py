"""The flash attention kernel's share of its roofline, in %: the least time
the card could take for the window's attention work (``counts.kernels.flash``
at the peaks of ``counts/peaks.json``) over the profiler's time of the
``flash_fwd_*`` and ``flash_merge`` kernels."""


def read(rec):
    t = sum(e - s for name, s, e, _ in rec["ops"]
            if "flash_fwd" in name or "flash_merge" in name) / 1e9
    c, peaks = rec["counters"], rec["peaks"]
    if t <= 0 or not c.get("flash_flops"):
        return None
    least = max(c["flash_flops"] / peaks["flops_per_s"], c["flash_bytes"] / peaks["bytes_per_s"])
    return 100.0 * least / t
