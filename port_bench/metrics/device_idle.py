"""Share of the traced window in which no operation ran on the card, in %:
1 - (the union of the device operations' intervals) / (the window)."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
