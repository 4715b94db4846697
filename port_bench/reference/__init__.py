"""The plain reference: FastSpeech2, HiFi-GAN V1 and iSTFTNet, and
FastSpeech2's training, in plain PyTorch on a weight dict.  It imports
nothing of the port (``e2e_tts_tpu_torch``) nor of the JAX package; the
Vietnamese frontend it reads text with is a frozen copy (``vie_text/``)."""
