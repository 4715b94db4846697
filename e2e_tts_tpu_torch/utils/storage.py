"""Media storage / upload backends: a copy of ``e2e_tts_tpu/utils/storage.py``.

The same ``upload(path) -> url`` surface, config-driven:

- ``LocalStorage``: copy into a served directory, return its URL/path
  (the default; works everywhere).
- ``HttpStorage``: multipart POST to a configured endpoint with token auth
  (the CDN-shaped backend; endpoint/keys come from env or constructor, never
  hard-coded).
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional


class LocalStorage:
    def __init__(self, root: str = "served_media", base_url: Optional[str] = None):
        self.root = root
        self.base_url = base_url

    def upload(self, path: str, folder: str = "audio") -> str:
        dest_dir = os.path.join(self.root, folder, time.strftime("%Y%m%d"))
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, os.path.basename(path))
        shutil.copy(path, dest)
        if self.base_url:
            rel = os.path.relpath(dest, self.root)
            return f"{self.base_url.rstrip('/')}/{rel}"
        return os.path.abspath(dest)


class HttpStorage:
    def __init__(
        self,
        endpoint: Optional[str] = None,
        token: Optional[str] = None,
        timeout: float = 30.0,
    ):
        self.endpoint = endpoint or os.environ.get("TTS_UPLOAD_ENDPOINT")
        self.token = token or os.environ.get("TTS_UPLOAD_TOKEN")
        self.timeout = timeout
        if not self.endpoint:
            raise ValueError(
                "HttpStorage needs an endpoint (arg or TTS_UPLOAD_ENDPOINT)"
            )

    def upload(self, path: str, folder: str = "audio") -> str:
        import requests

        with open(path, "rb") as f:
            r = requests.post(
                self.endpoint,
                files={"file": (os.path.basename(path), f)},
                data={"folder": folder},
                headers={"Authorization": f"Bearer {self.token}"} if self.token else {},
                timeout=self.timeout,
            )
        r.raise_for_status()
        body = r.json()
        return body.get("url") or body.get("path") or str(body)


def default_storage() -> LocalStorage:
    return LocalStorage(os.environ.get("TTS_MEDIA_ROOT", "served_media"))
