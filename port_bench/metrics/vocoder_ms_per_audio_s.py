"""Device ms of the vocoder a second of audio: the kernels launched inside
a call of ``engine.vocoder``, over the audio seconds of the window."""


def read(rec):
    audio_s = rec["counters"].get("audio_s")
    if not audio_s:
        return None
    ms = sum(e - s for _, s, e, label in rec["ops"] if label == "vocoder") / 1e6
    return ms / audio_s if ms > 0 else None
