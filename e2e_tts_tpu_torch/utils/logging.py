"""Serving observability: ``ServeLogger`` from ``e2e_tts_tpu/utils/logging.py``.
The training loggers come with the training slice (ROADMAP.md, A7)."""

from __future__ import annotations

import json
import os
import time


class ServeLogger:
    """Structured JSONL request logs for the serving path, one line a
    request; ``close`` closes the file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def log_request(self, **fields):
        fields["ts"] = time.time()
        self._f.write(json.dumps(fields, ensure_ascii=False) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
