"""Share of the decoder's frame slots that hold no audio: 1 - (frames of
audio returned) / (rows x bucket frames of every decoder call), in %."""


def read(rec):
    c = rec["counters"]
    if not c.get("decoder_frames"):
        return None
    return 100.0 * (1.0 - c["frames"] / c["decoder_frames"])
