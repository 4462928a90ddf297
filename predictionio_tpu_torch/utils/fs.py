"""Filesystem root and crash-safe write primitive (copy of the JAX
package's ``utils/fs.py``, without its fault-injection crash sites)."""

from __future__ import annotations

import os
import tempfile


def pio_base_dir() -> str:
    """The framework's on-disk root (PIO_FS_BASEDIR, parity: conf/pio-env)."""
    return os.environ.get("PIO_FS_BASEDIR", os.path.expanduser("~/.pio_store"))


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename into it survives power loss; a
    filesystem that refuses downgrades durability, not the write."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes, fsync: bool = True) -> None:
    """Crash-safe file publish: write temp → flush → fsync → rename, so
    readers see the old content or the new, never a torn mix."""
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=dirname
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(dirname)
