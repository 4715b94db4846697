"""Parameter introspection (port of ``e2e_tts_tpu/utils/params.py``).

Each function takes an ``nn.Module``, whose ``named_parameters()`` are
counted (not its buffers, as the JAX package counts ``params`` and not
``batch_stats``), or a nested dict of arrays, whose leaves are.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _leaves(params: Any) -> Iterator[Tuple[Tuple[str, ...], tuple]]:
    """(path, shape) of every parameter, in order."""
    if isinstance(params, torch.nn.Module):
        for name, p in params.named_parameters():
            yield tuple(name.split(".")), tuple(p.shape)
    elif isinstance(params, dict):
        for k, v in params.items():
            for path, shape in _leaves(v):
                yield (str(k),) + path, shape
    else:
        yield (), tuple(np.shape(params))


def get_param_num(params: Any) -> int:
    """Total parameter count."""
    return sum(int(np.prod(shape)) for _, shape in _leaves(params))


def show_params(params: Any, max_rows: int = 0) -> int:
    """Print name/shape per parameter; returns the total count."""
    total = 0
    print("=" * 40, "Model Parameters", "=" * 40)
    for i, (path, shape) in enumerate(_leaves(params)):
        if not max_rows or i < max_rows:
            print(".".join(path), shape)
        total += int(np.prod(shape))
    print(f"[*] Parameter Size: {total}")
    print("=" * 100)
    return total


def param_summary(params: Any, depth: int = 1) -> dict:
    """Parameter counts grouped by the first ``depth`` parts of each name."""
    groups: dict = {}
    for path, shape in _leaves(params):
        key = "/".join(path[:depth])
        groups[key] = groups.get(key, 0) + int(np.prod(shape))
    return groups
