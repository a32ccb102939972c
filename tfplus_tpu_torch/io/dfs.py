"""DFS filesystem — a REAL remote backend for the ``dfs://`` scheme.

Equivalent of the reference's DFS plugin
(``dfs/kernels/dfs/dfs_file_system.{h,cc}``, 602 LoC: per-cluster
connection cache GetConnection :189-212, DfsRandomAccessFile PRead loop
:118-179, DfsWritableFile 1 MB Append chunks :230-287, overwrite-vs-append
NewWritableFileInternal :289-321; op registration
``REGISTER_FILE_SYSTEM("dfs")`` dfs/ops/dfs_ops.cc). The reference talks
to the proprietary ``zdfs::PanguFileSystem`` SDK; that SDK does not exist
outside Alibaba infra, so this client speaks the open protocol with the
same shape — the WebHDFS REST API (ranged ``OPEN``, two-step
``CREATE``/``APPEND`` with 307 redirect, ``LISTSTATUS``,
``GETFILESTATUS``, native ``RENAME``, recursive ``DELETE``) — and points
at any WebHDFS-compatible endpoint (HDFS namenodes, Alluxio, Ozone HttpFS
gateways). Tests run it against :mod:`tfplus_tpu_torch.io.dfs_emulator` over a
genuine HTTP wire, over loopback.

Semantics kept from the reference plugin:
  * ``dfs://cluster/abs/path`` — the authority is the cluster endpoint;
    one cached client per cluster (dfs_file_system.cc:189-212).
  * Writable files are append-streams: bytes leave the host in bounded
    1 MB chunks as they are written (``DfsWritableFile::Append``'s loop),
    NOT spooled whole — bundle shards bigger than host RAM stream through.
  * ``open(mode="wb")`` overwrites (CREATE overwrite=true);
    ``mode="ab"`` appends to an existing file (NewAppendableFile).
  * Rename is NATIVE (a metadata op) — unlike the ``oss://`` backend's
    copy+delete, the bundle's atomic index publish stays atomic here.

Authentication follows WebHDFS pseudo-auth (``user.name`` query param,
from ``DFS_USER`` env or the URI's ``user@cluster`` authority form); the
emulator rejects unknown users with 403 like a secured gateway.

A copy of ``tfplus_tpu/io/dfs.py`` (stdlib only; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import http.client
import io
import json
import os
import threading
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote, urlparse

from .filesystem import FileSystem, register_filesystem
from .retry import retry_transient

_READAHEAD = 4 << 20          # ranged-OPEN readahead
_CHUNK = 1 << 20              # append chunk (reference buffer_size, :260)
_API = "/webhdfs/v1"


def parse_dfs_path(path: str) -> Tuple[str, str, str]:
    """Split a registry-local path (``cluster/abs/path`` or
    ``user@cluster/abs/path``) into (cluster, user, file_path) — the
    reference's ParseDfsPath (dfs_file_system.cc:66-83): cluster and
    file_path must both be non-empty."""
    authority, sep, file_path = path.partition("/")
    user = ""
    if "@" in authority:
        user, _, authority = authority.rpartition("@")
    if not authority or not sep or not file_path:
        raise ValueError(
            f"dfs path needs 'dfs://cluster/file_path', got dfs://{path}")
    return authority, user or os.environ.get("DFS_USER", "tfplus"), \
        "/" + file_path


class _Pool:
    """Reusable HTTP connections to one cluster endpoint (the per-cluster
    connection cache, dfs_file_system.cc:189-212)."""

    def __init__(self, cluster: str, max_connections: int = 8):
        u = urlparse(cluster if "//" in cluster else "http://" + cluster)
        self._addr = (u.hostname, u.port or 80)
        self._free: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        self._max = max_connections

    def acquire(self) -> http.client.HTTPConnection:
        with self._lock:
            if self._free:
                return self._free.pop()
        return http.client.HTTPConnection(*self._addr, timeout=60)

    def release(self, conn: http.client.HTTPConnection):
        with self._lock:
            if len(self._free) < self._max:
                self._free.append(conn)
                return
        conn.close()


class DfsError(IOError):
    pass


class DfsClient:
    """WebHDFS REST client for one cluster."""

    def __init__(self, cluster: str, user: str):
        self.cluster = cluster
        self.user = user
        self._pool = _Pool(cluster)

    # -- wire -----------------------------------------------------------
    def _do(self, verb: str, url: str,
            body: Optional[bytes]) -> Tuple[int, bytes, Optional[str]]:
        conn = self._pool.acquire()
        try:
            conn.request(verb, url, body=body,
                         headers={} if body else {"Content-Length": "0"})
            resp = conn.getresponse()
            data = resp.read()
            status = resp.status
            location = resp.getheader("Location")
        except (http.client.HTTPException, OSError):
            conn.close()
            raise
        self._pool.release(conn)
        return status, data, location

    def _do_retry(self, verb: str, url: str, body: Optional[bytes], *,
                  idempotent: bool) -> Tuple[int, bytes, Optional[str]]:
        """Bounded retry (io/retry.py policy) for IDEMPOTENT legs only.
        APPEND is never retried here — a lost response after a partial
        server-side apply would duplicate bytes (the writer layer owns
        that recovery, if any); CREATE(overwrite) / reads / MKDIRS /
        namenode redirect legs are all safe to replay. RENAME and DELETE
        replay too, but a hidden success flips their boolean result — the
        op-level wrappers resolve that (see :meth:`rename`)."""
        if not idempotent:
            return self._do(verb, url, body)
        try:
            return retry_transient(lambda: self._do(verb, url, body),
                                   describe=f"{verb} {url}",
                                   status_of=lambda r: r[0])
        except IOError as e:
            raise DfsError(str(e)) from e

    def _request(self, verb: str, path: str, op: str, *, body=None,
                 **params) -> Tuple[int, bytes]:
        q = [f"op={op}", f"user.name={quote(self.user, safe='')}"]
        q += [f"{k}={quote(str(v), safe='')}" for k, v in params.items()
              if v is not None]
        url = _API + quote(path, safe="/") + "?" + "&".join(q)
        # APPEND is the only non-idempotent leg (partial-apply ambiguity);
        # everything else replays safely, incl. CREATE with overwrite=true
        idem = op != "APPEND"
        two_step = body is not None and verb in ("PUT", "POST")
        if not two_step:
            st, data, loc = self._do_retry(verb, url, body, idempotent=idem)
            if st == 307 and loc:          # gateways may redirect reads too
                u = urlparse(loc)
                st, data, _ = self._do_retry(
                    verb, u.path + ("?" + u.query if u.query else ""), body,
                    idempotent=idem)
            return st, data
        # WebHDFS two-step write: the namenode answers 307 with the
        # datanode Location; only the second request carries the payload.
        # The namenode leg carries no body — always safe to retry.
        st, data, loc = self._do_retry(verb, url, None, idempotent=True)
        if st != 307 or not loc:
            if 200 <= st < 300:
                # a non-redirecting server just created an EMPTY file —
                # refuse rather than silently dropping the payload
                raise DfsError(
                    f"dfs:{path}: endpoint accepted {verb} op={op} without "
                    f"the datanode redirect; payload not transferred")
            return st, data
        u = urlparse(loc)
        st, data, _ = self._do_retry(
            verb, u.path + ("?" + u.query if u.query else ""), body,
            idempotent=idem)
        return st, data

    @staticmethod
    def _raise(path: str, status: int, data: bytes):
        try:
            msg = json.loads(data)["RemoteException"]["message"]
        except Exception:
            msg = data[:200].decode(errors="replace")
        if status == 404:
            raise FileNotFoundError(f"dfs:{path}: {msg}")
        raise DfsError(f"dfs:{path}: HTTP {status}: {msg}")

    # -- ops --------------------------------------------------------------
    def open(self, path: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        st, data = self._request("GET", path, "OPEN", offset=offset,
                                 length=length)
        if st != 200:
            self._raise(path, st, data)
        return data

    def create(self, path: str, data: bytes = b"", overwrite: bool = True):
        st, out = self._request(
            "PUT", path, "CREATE", body=data,
            overwrite="true" if overwrite else "false")
        if st not in (200, 201):
            self._raise(path, st, out)

    def append(self, path: str, data: bytes):
        st, out = self._request("POST", path, "APPEND", body=data)
        if st != 200:
            self._raise(path, st, out)

    def status(self, path: str) -> Optional[dict]:
        """FileStatus dict (type/length), or None if absent."""
        st, data = self._request("GET", path, "GETFILESTATUS")
        if st == 404:
            return None
        if st != 200:
            self._raise(path, st, data)
        return json.loads(data)["FileStatus"]

    def list(self, path: str) -> List[dict]:
        st, data = self._request("GET", path, "LISTSTATUS")
        if st != 200:
            self._raise(path, st, data)
        return json.loads(data)["FileStatuses"]["FileStatus"]

    def mkdirs(self, path: str):
        st, data = self._request("PUT", path, "MKDIRS")
        if st != 200:
            self._raise(path, st, data)

    def delete(self, path: str, recursive: bool = False) -> bool:
        st, data = self._request(
            "DELETE", path, "DELETE",
            recursive="true" if recursive else "false")
        if st != 200:
            self._raise(path, st, data)
        ok = bool(json.loads(data).get("boolean"))
        if not ok and self.status(path) is None:
            return True        # hidden-success replay: it IS deleted
        return ok

    def rename(self, src: str, dst: str):
        st, data = self._request("PUT", src, "RENAME", destination=dst)
        ok = st == 200 and bool(json.loads(data).get("boolean"))
        if not ok:
            # hidden-success replay: a retried RENAME whose FIRST attempt
            # applied before the response was lost finds src gone and
            # answers 404 (or boolean:false) — if dst now exists and src
            # doesn't, the rename DID happen (this is the checkpoint index
            # publish; erroring here would fail a save that succeeded)
            if self.status(dst) is not None and self.status(src) is None:
                return
            if st != 200:
                self._raise(src, st, data)
            raise DfsError(f"dfs:{src}: RENAME to {dst} refused")


class _DfsReadFile(io.RawIOBase):
    """Random-access reader over ranged OPENs with readahead buffering
    (DfsRandomAccessFile's PRead loop, dfs_file_system.cc:118-179)."""

    def __init__(self, client: DfsClient, path: str, size: int):
        self._c = client
        self._path = path
        self._size = size
        self._pos = 0
        self._buf = b""
        self._buf_start = 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def seek(self, pos, whence=0):
        if whence == 0:
            self._pos = pos
        elif whence == 1:
            self._pos += pos
        else:
            self._pos = self._size + pos
        return self._pos

    def tell(self):
        return self._pos

    def read(self, n=-1):
        if n is None or n < 0:
            n = self._size - self._pos
        n = max(0, min(n, self._size - self._pos))
        if n == 0:
            return b""
        out = []
        remaining = n
        while remaining > 0:
            bo = self._pos - self._buf_start
            if 0 <= bo < len(self._buf):
                take = min(remaining, len(self._buf) - bo)
                out.append(self._buf[bo:bo + take])
                self._pos += take
                remaining -= take
                continue
            fetch = min(max(remaining, _READAHEAD), self._size - self._pos)
            self._buf = self._c.open(self._path, self._pos, fetch)
            self._buf_start = self._pos
            if not self._buf:
                raise DfsError(
                    f"dfs:{self._path}: empty ranged read at {self._pos} "
                    f"(file changed during read?)")
        return b"".join(out)

    def readinto(self, b):
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)


class _DfsWriteFile(io.RawIOBase):
    """Append-stream writer: CREATE on first flush, then 1 MB APPENDs —
    bytes leave the host as written (DfsWritableFile::Append's chunk loop,
    dfs_file_system.cc:257-270), so multi-GB bundle shards never buffer
    whole in RAM (unlike the oss:// backend's single-PUT spool)."""

    def __init__(self, client: DfsClient, path: str, append: bool):
        self._c = client
        self._path = path
        self._buf = bytearray()
        self._written = 0
        # NewWritableFile force-overwrites; NewAppendableFile opens the
        # existing file without truncation (dfs_file_system.cc:289-321)
        self._created = append and client.status(path) is not None
        self._closed = False

    def writable(self):
        return True

    def _flush_chunks(self, final: bool):
        while len(self._buf) >= _CHUNK or (final and
                                           (self._buf or not self._created)):
            chunk = bytes(self._buf[:_CHUNK])
            del self._buf[:_CHUNK]
            if not self._created:
                self._c.create(self._path, chunk, overwrite=True)
                self._created = True
            else:
                self._c.append(self._path, chunk)
            self._written += len(chunk)
            if final and not self._buf:
                break

    def write(self, b):
        self._buf += b
        if len(self._buf) >= _CHUNK:
            self._flush_chunks(final=False)
        return len(b)

    def tell(self):
        return self._written + len(self._buf)

    def close(self):
        if self._closed:
            return
        self._flush_chunks(final=True)
        self._closed = True
        super().close()


class DfsFileSystem(FileSystem):
    """``dfs://cluster/abs/path`` filesystem over :class:`DfsClient`.

    Real directory hierarchy (MKDIRS/LISTSTATUS), native rename — the
    surface DfsFileSystem implements over zdfs in the reference."""

    def __init__(self):
        self._clients: Dict[Tuple[str, str], DfsClient] = {}
        self._lock = threading.Lock()

    def _resolve(self, path: str) -> Tuple[DfsClient, str]:
        cluster, user, fpath = parse_dfs_path(path)
        with self._lock:
            client = self._clients.get((cluster, user))
            if client is None:
                client = DfsClient(cluster, user)
                self._clients[(cluster, user)] = client
        return client, fpath

    def open(self, path, mode="rb"):
        c, p = self._resolve(path)
        if "r" in mode:
            st = c.status(p)
            if st is None or st.get("type") == "DIRECTORY":
                raise FileNotFoundError(f"dfs://{path}")
            f = _DfsReadFile(c, p, int(st["length"]))
            return io.BufferedReader(f) if "b" in mode else f
        return _DfsWriteFile(c, p, append="a" in mode)

    def exists(self, path):
        c, p = self._resolve(path)
        return c.status(p) is not None

    def listdir(self, path):
        c, p = self._resolve(path)
        return sorted(e["pathSuffix"] for e in c.list(p))

    def makedirs(self, path):
        c, p = self._resolve(path)
        c.mkdirs(p)

    def remove(self, path):
        c, p = self._resolve(path)
        if not c.delete(p, recursive=False):
            raise FileNotFoundError(f"dfs://{path}")

    def remove_tree(self, path):
        """Recursive delete (the reference's DeleteRecursively)."""
        c, p = self._resolve(path)
        c.delete(p, recursive=True)

    def rename(self, src, dst):
        sc, sp = self._resolve(src)
        dc, dp = self._resolve(dst)
        if (sc.cluster, sc.user) != (dc.cluster, dc.user):
            raise DfsError(f"cross-cluster rename {src} -> {dst}")
        sc.rename(sp, dp)

    def size(self, path):
        c, p = self._resolve(path)
        st = c.status(p)
        if st is None:
            raise FileNotFoundError(f"dfs://{path}")
        return int(st["length"])


def register_dfs(scheme: str = "dfs") -> DfsFileSystem:
    """Install the ``dfs://`` scheme (reference: REGISTER_FILE_SYSTEM("dfs"),
    dfs/ops/dfs_ops.cc). The reference's Pangu plugin is the same client
    stack under a second scheme (its DFS plugin itself wraps
    zdfs::PanguFileSystem) — ``register_dfs("pangu")`` mirrors that."""
    fs = DfsFileSystem()
    register_filesystem(scheme, fs)
    return fs
