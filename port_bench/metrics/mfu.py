"""The whole step's share of the card's peak, in %: the model FLOPs of the
window's work at real lengths (``counts.model``) over (window seconds x the
peak of ``counts/peaks.json``)."""


def read(rec):
    flops = rec["counters"].get("model_flops")
    if not flops or rec["window_s"] <= 0:
        return None
    return 100.0 * flops / (rec["window_s"] * rec["peaks"]["flops_per_s"])
