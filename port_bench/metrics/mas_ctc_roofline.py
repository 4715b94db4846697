"""MAS and the forward-sum CTC kernels' share of their roofline, in %: the
least time the card could take for the window's alignment work
(``counts.kernels.mas`` and ``ctc``) over the profiler's time of
``mas_kernel`` and the ``ctc_*_kernel``s."""


def read(rec):
    ops = rec["ops"]
    t = sum(e - s for name, s, e, _ in ops if "mas_kernel" in name or "ctc_" in name) / 1e9
    c, peaks = rec["counters"], rec["peaks"]
    if t <= 0 or not c.get("mas_bytes"):
        return None
    least = sum(max(c[f"{k}_flops"] / peaks["flops_per_s"], c[f"{k}_bytes"] / peaks["bytes_per_s"])
                for k in ("mas", "ctc"))
    return 100.0 * least / t
