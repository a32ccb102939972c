"""URI-pluggable filesystem abstraction.

A copy of ``tfplus_tpu/io/filesystem.py`` (the port imports nothing of the
JAX package): a scheme registry that the checkpoint bundles resolve paths
through, the local filesystem as the default, an in-memory filesystem
(``ram://``) for tests, and the reference's OSS URI credential parser.
The remote backends register themselves here: ``oss://``
(:func:`.object_store.register_oss`, signed OSS REST), ``s3://``
(:func:`.s3.register_s3`, SigV4) and ``dfs://`` (:func:`.dfs.register_dfs`,
WebHDFS REST, also registrable as ``pangu://``). This registry is the
port's own: a client registered with the JAX package's ``register_*`` is
not seen here.
"""
from __future__ import annotations

import io
import os
import threading
from typing import Dict, List

_REGISTRY: Dict[str, "FileSystem"] = {}
_LOCK = threading.Lock()


class FileSystem:
    """Minimal surface the checkpoint layer needs (mirrors the subset of
    TF's FileSystem the reference plugins implement: random-access read,
    writable/appendable files, dir emulation, listing, delete)."""

    def open(self, path: str, mode: str = "rb"):
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def makedirs(self, path: str):
        raise NotImplementedError

    def remove(self, path: str):
        raise NotImplementedError

    def rename(self, src: str, dst: str):
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def open(self, path, mode="rb"):
        if "w" in mode or "a" in mode:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        return open(path, mode)

    def exists(self, path):
        return os.path.exists(path)

    def listdir(self, path):
        return os.listdir(path)

    def makedirs(self, path):
        os.makedirs(path, exist_ok=True)

    def remove(self, path):
        os.remove(path)

    def rename(self, src, dst):
        os.replace(src, dst)

    def size(self, path):
        return os.path.getsize(path)


class MemFileSystem(FileSystem):
    """In-memory FS (tests / scratch). Paths are flat keys."""

    def __init__(self):
        self._files: Dict[str, bytes] = {}

    def open(self, path, mode="rb"):
        fs = self

        if "r" in mode:
            if path not in self._files:
                raise FileNotFoundError(path)
            return io.BytesIO(self._files[path])

        class _W(io.BytesIO):
            def close(self_inner):
                fs._files[path] = self_inner.getvalue()
                super().close()

        w = _W()
        if "a" in mode and path in self._files:
            w.write(self._files[path])
        return w

    def exists(self, path):
        return path in self._files or any(
            k.startswith(path.rstrip("/") + "/") for k in self._files)

    def listdir(self, path):
        if path in ("", "."):
            # flat keys have no directory structure: root lists them all
            return sorted({k.split("/")[0] for k in self._files})
        prefix = path.rstrip("/") + "/"
        out = set()
        for k in self._files:
            if k.startswith(prefix):
                out.add(k[len(prefix):].split("/")[0])
        return sorted(out)

    def makedirs(self, path):
        pass

    def remove(self, path):
        self._files.pop(path, None)

    def rename(self, src, dst):
        self._files[dst] = self._files.pop(src)

    def size(self, path):
        return len(self._files[path])


def parse_oss_uri(uri: str):
    """Parse the reference's OSS URI credential embedding
    (oss_file_system.cc:512-577 ParseOSSURIPath):
    ``oss://bucket\\x01id=..\\x02key=..\\x02host=endpoint/path/to/object``.
    The authority (everything before the first ``/`` after the scheme)
    carries bucket + credentials — delimited by ``\\x01``/``\\x02`` or the
    ``?``/``&`` variant — and the remainder is the object key. Missing
    fields fall back to OSS_ACCESS_ID / OSS_ACCESS_KEY / OSS_HOST env."""
    rest = uri[len("oss://"):] if uri.startswith("oss://") else uri
    authority, _, object_path = rest.partition("/")
    creds = {"id": os.environ.get("OSS_ACCESS_ID", ""),
             "key": os.environ.get("OSS_ACCESS_KEY", ""),
             "host": os.environ.get("OSS_HOST", "")}
    bucket_delim, access_delim = ("\x01", "\x02") if "\x01" in authority \
        else ("?", "&")
    bucket, sep, cred_part = authority.partition(bucket_delim)
    if sep:
        for kvp in cred_part.split(access_delim):
            if "=" in kvp:
                k, v = kvp.split("=", 1)
                creds[k] = v
    return bucket, object_path, creds


def register_filesystem(scheme: str, fs: FileSystem):
    with _LOCK:
        _REGISTRY[scheme] = fs


def get_filesystem(path: str) -> tuple[FileSystem, str]:
    """Resolve ``scheme://...`` to (fs, fs-local path)."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        with _LOCK:
            fs = _REGISTRY.get(scheme)
        if fs is None:
            raise ValueError(
                f"no filesystem registered for scheme {scheme!r} "
                f"(register one with tfplus_tpu_torch.io.register_filesystem)")
        return fs, rest if scheme != "file" else "/" + rest.lstrip("/")
    with _LOCK:
        return _REGISTRY["file"], path


register_filesystem("file", LocalFileSystem())
register_filesystem("ram", MemFileSystem())
