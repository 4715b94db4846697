"""Device ms of the acoustic model a second of audio: the kernels launched
inside a call of one of ``engine.acoustic``'s parts (encoder, duration,
pitch and energy predictors and embeddings, speaker embedding, decoder,
``mel_linear``, postnet), over the audio seconds of the window."""


def read(rec):
    audio_s = rec["counters"].get("audio_s")
    if not audio_s:
        return None
    ms = sum(e - s for _, s, e, label in rec["ops"] if label and label.startswith("acoustic.")) / 1e6
    return ms / audio_s if ms > 0 else None
