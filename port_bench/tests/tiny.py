"""A narrow copy of a configuration file and a ``BENCHMARK.json`` of its own,
for running the harness on the CPU in the tests (the real cells are sized
for the card)."""

from __future__ import annotations

import argparse
import copy
import json
import os

from port_bench import harness


def tiny_config(name: str = "fs2_hifigan_v1", block_type: str = None) -> dict:
    """The configuration file ``name``, narrowed, on the block family
    ``block_type`` (None: the file's own)."""
    with open(os.path.join(harness.HERE, "configs", f"{name}.json"), encoding="utf8") as f:
        cfg = json.load(f)
    c = cfg["config"]
    fs2 = c["models"]["fastspeech2"]
    fs2.update(encoder_layers=2, decoder_layers=2, encoder_hidden=32, decoder_hidden=32)
    bb = fs2["building_block"]
    if block_type is not None:
        bb["block_type"] = block_type
    blk = bb[bb["block_type"]]
    if "conv_filter_size" in blk:  # the families with a convolutional FFN
        blk["conv_filter_size"] = 64
    fs2["variance"]["variance_predictor"]["filter_size"] = 32
    fs2["postnet"]["embedding_dim"] = 32
    for voc in ("hifigan", "istft"):
        c["models"][voc]["upsample_initial_channel"] = 32
    return cfg


def tiny_bench(tmp_path, workload: str, config_name: str, traffic: str,
               block_type: str = None) -> dict:
    """A benchmark of one cell on the narrow configuration (on the block
    family ``block_type``), whose file lies under ``tmp_path``."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), encoding="utf8") as f:
        real = json.load(f)
    cfg_path = os.path.join(tmp_path, f"{config_name}.json")
    with open(cfg_path, "w", encoding="utf8") as f:
        json.dump(tiny_config(config_name, block_type), f)
    bench = copy.deepcopy(real)
    bench["configs"] = [{"name": config_name, "source": "test", "file": cfg_path, "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": workload, "config": config_name, "traffic": traffic,
                           "chips": 1, "why": "test"}]
    return bench


def args(workload: str, seed: int = 5, seconds: float = 1.0, trace: int = 0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
