"""Local-filesystem model store (reference: storage/localfs/LocalFSModels.scala).

Copy of ``predictionio_tpu/data/storage/localfs.py``: model blobs are files
under ``PIO_FS_BASEDIR`` (default ``~/.pio_store``), one file per model id,
published with write-temp → fsync → rename.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.utils.fs import atomic_write, pio_base_dir


class LocalFSModels(base.Models):
    def __init__(self, source_name: str = "default", path: Optional[str] = None, **_):
        if path is None:
            path = os.path.join(pio_base_dir(), "models", source_name)
        self._dir = path
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, model_id: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in model_id)
        if safe != model_id:
            # keep sanitized ids collision-free ("a/b" vs "a_b")
            digest = hashlib.sha1(model_id.encode()).hexdigest()[:12]
            safe = f"{safe}.{digest}"
        return os.path.join(self._dir, safe)

    def insert(self, model: base.Model) -> None:
        atomic_write(self._path(model.id), model.models)

    def get(self, model_id: str):
        p = self._path(model_id)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return base.Model(model_id, f.read())

    def delete(self, model_id: str) -> None:
        p = self._path(model_id)
        if os.path.exists(p):
            os.remove(p)
