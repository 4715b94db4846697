"""Deploy bundle reader (port of ``e2e_tts_tpu/serve/bundle.py``, read side).

A bundle directory holds ``config.yaml``, ``speakers.json``, ``stats.json``,
``meta.json`` (optional), ``foreign_words.json`` (optional) and the weights
as flax-msgpack files ``acoustic.msgpack`` and ``vocoder.msgpack``.  The
msgpack files are read with ``msgpack`` alone: flax stores each array as ext
type 1 holding ``(shape, dtype name, raw bytes)``.  ``yaml`` and ``msgpack``
are imported inside the functions that need them.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from ..config import Config, load_config
from ..nn.variance import FeatureStats

_EXT_NDARRAY = 1


class Bundle(NamedTuple):
    config: Config
    acoustic_variables: dict   # {"params": ..., "batch_stats": ...} of numpy arrays
    vocoder_variables: dict    # {"params": ...}
    speakers: dict
    stats: FeatureStats
    vocoder_kind: str
    foreign_dict: dict
    language: str


def _ext_hook(code, data):
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code} in a weights file")
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape).copy()


def read_msgpack(path: str) -> dict:
    """A flax ``serialization.to_bytes`` file -> nested dict of numpy arrays."""
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)


def _json(path: str, default=None):
    """The JSON file at ``path``; ``default`` when it is optional and absent."""
    if default is not None and not os.path.exists(path):
        return default
    with open(path, encoding="utf8") as f:
        return json.load(f)


def load_bundle(bundle_dir: str) -> Bundle:
    meta = _json(os.path.join(bundle_dir, "meta.json"), {})
    return Bundle(
        config=load_config(os.path.join(bundle_dir, "config.yaml")),
        acoustic_variables=read_msgpack(os.path.join(bundle_dir, "acoustic.msgpack")),
        vocoder_variables=read_msgpack(os.path.join(bundle_dir, "vocoder.msgpack")),
        speakers=_json(os.path.join(bundle_dir, "speakers.json")),
        stats=FeatureStats.from_dict(_json(os.path.join(bundle_dir, "stats.json"))),
        vocoder_kind=meta.get("vocoder_kind", "hifigan"),
        foreign_dict=_json(os.path.join(bundle_dir, "foreign_words.json"), {}),
        language=meta.get("language", "vie"),
    )
