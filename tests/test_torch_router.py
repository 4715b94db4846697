"""The port's multi-lingual router (``e2e_tts_tpu_torch/synthesizer.py``)
against the JAX package's repo-root ``synthesizer.py``, on the CPU.

- ``discover_bundles()`` finds what JAX's finds.
- The router serves the three checked-in bundles, each language equal to
  the port's own engine on that bundle (which ``test_torch_engine.py`` and
  ``test_torch_serve.py`` hold to JAX), all on one device.
- The unknown-language error keeps JAX's text; ``extra_models`` registers
  a backend; ``voice_conversion`` and ``synthesis(target_filepath=)`` write
  wavs through the kNN converter on the Vietnamese engine.
- ``device=None`` without CUDA raises.
"""

import os

import numpy as np
import pytest
import torch

from _torch_one_thread import one_thread  # noqa: F401
import synthesizer as jax_router
from e2e_tts_tpu_torch.audio.wav import read_wav
from e2e_tts_tpu_torch.serve import SynthesisEngine
from e2e_tts_tpu_torch.synthesizer import Synthesizer, discover_bundles
from e2e_tts_tpu_torch.text.frontends import get_frontend

pytestmark = pytest.mark.usefixtures("one_thread")

TEXTS = {"vie": "xin chào việt nam", "eng": "hello world", "mya": "မင်္ဂလာပါ"}


@pytest.fixture(scope="module")
def router(tmp_path_factory):
    return Synthesizer(device="cpu", output_dir=str(tmp_path_factory.mktemp("router")))


def test_discover_bundles_matches_jax():
    found = discover_bundles()
    assert found == jax_router.discover_bundles()
    assert set(found) == {"vie", "eng", "mya"}


def test_languages_and_devices(router):
    assert router.languages == ["eng", "mya", "vie"]
    assert {m.engine.device for m in router.model_dict.values()} == {torch.device("cpu")}
    assert router.voice_converter.engine is router.model_dict["vie"].engine
    assert router.voice_converter.feature_mode == "ppg"


@pytest.mark.parametrize("lang", sorted(TEXTS))
def test_each_language_equals_its_engine(router, lang):
    path, vc_path = router.synthesis(TEXTS[lang], language=lang)
    assert vc_path is None
    got, sr = read_wav(path)
    engine = SynthesisEngine.from_checkpoint(discover_bundles()[lang], device="cpu")
    want = engine.synthesize(get_frontend(lang).normalize(TEXTS[lang]))
    assert sr == engine.sample_rate and len(want) > 0
    np.testing.assert_array_equal(np.round(got * 32768.0).astype(np.int16), want)


def test_unknown_language_error(router):
    want = ("no model for language 'fra'; available: ['eng', 'mya', 'vie']. "
            "Register external backends via extra_models.")
    with pytest.raises(ValueError) as err:
        router.synthesis("bonjour", language="fra")
    assert str(err.value) == want


def test_extra_models_register_a_backend(tmp_path):
    class Backend:
        def synthesis(self, text, save_filepath=None, speed=1.0):
            return f"{text}@{speed}"

    r = Synthesizer(device="cpu", auto_discover=False, engine=None, output_dir=str(tmp_path),
                    extra_models={"fra": Backend()},
                    bundles={"vie": discover_bundles()["vie"]})
    assert r.languages == ["fra", "vie"]
    assert r.synthesis("bonjour", language="fra", speed=1.5) == ("bonjour@1.5", None)


def test_voice_conversion_writes_a_file(router):
    src, _ = router.synthesis(TEXTS["vie"], language="vie")
    tgt, _ = router.synthesis("em yêu hoa lá trên núi cao", language="vie")
    out = router.voice_conversion(src, tgt)
    assert os.path.exists(out) and os.path.dirname(out) == router.output_dir
    audio, sr = read_wav(out)
    assert sr == 22050 and len(audio) > 0 and np.isfinite(audio).all()
    tts, vc = router.synthesis(TEXTS["vie"], target_filepath=tgt)
    assert os.path.exists(tts) and os.path.exists(vc)


def test_no_cuda_raises_without_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer(output_dir=str(tmp_path))
