"""Deploy bundle I/O (port of ``e2e_tts_tpu/serve/bundle.py``).

A bundle directory holds ``config.yaml``, ``speakers.json``, ``stats.json``,
``meta.json`` (optional), ``foreign_words.json`` (optional) and the weights
as flax-msgpack files ``acoustic.msgpack`` and ``vocoder.msgpack``.  The
msgpack files are read and written with ``msgpack`` alone: flax stores each
array as ext type 1 holding ``(shape, dtype name, raw bytes)``.  The
weights are written under the JAX package's names (``convert.to_jax``), so
either package serves a bundle that either wrote.  ``yaml`` and ``msgpack``
are imported inside the functions that need them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, NamedTuple, Optional

import numpy as np

from ..config import Config, load_config, save_config
from ..convert import to_jax
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


def _ext_pack(x):
    """The mirror of ``_ext_hook``: a numpy array as ext type 1."""
    import msgpack

    if not isinstance(x, np.ndarray):
        raise TypeError(f"cannot write {type(x).__name__} into a weights file")
    return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
        (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))


def write_msgpack(path: str, tree: dict) -> None:
    """A nested dict of numpy arrays -> a file that flax's
    ``serialization.from_bytes`` (and ``read_msgpack``) reads, keys sorted."""
    import msgpack

    def sort(node):
        return {k: sort(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    with open(path, "wb") as f:
        f.write(msgpack.packb(sort(tree), default=_ext_pack, strict_types=True))


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


def save_bundle(
    bundle_dir: str,
    config: Config,
    acoustic,
    vocoder,
    speakers: Dict[str, int],
    stats: FeatureStats,
    vocoder_kind: str = "hifigan",
    foreign_dict: Optional[dict] = None,
    language: str = "vie",
) -> None:
    """Write a bundle that both packages' ``SynthesisEngine.from_checkpoint``
    read.  ``acoustic`` and ``vocoder`` are port modules (the acoustic model;
    a serving or training generator), whose weights go out under the JAX
    names, or JAX variable trees already (nested dicts of numpy arrays)."""
    def tree(weights):
        return weights if isinstance(weights, dict) else to_jax(weights)

    os.makedirs(bundle_dir, exist_ok=True)
    save_config(config, os.path.join(bundle_dir, "config.yaml"))
    with open(os.path.join(bundle_dir, "speakers.json"), "w") as f:
        json.dump(speakers, f, ensure_ascii=False, indent=1)
    with open(os.path.join(bundle_dir, "stats.json"), "w") as f:
        json.dump(stats.to_dict(), f, indent=1)
    with open(os.path.join(bundle_dir, "meta.json"), "w") as f:
        json.dump({"vocoder_kind": vocoder_kind, "language": language}, f)
    if foreign_dict:
        with open(os.path.join(bundle_dir, "foreign_words.json"), "w", encoding="utf8") as f:
            json.dump(foreign_dict, f, ensure_ascii=False, indent=1)
    write_msgpack(os.path.join(bundle_dir, "acoustic.msgpack"), tree(acoustic))
    write_msgpack(os.path.join(bundle_dir, "vocoder.msgpack"), tree(vocoder))
