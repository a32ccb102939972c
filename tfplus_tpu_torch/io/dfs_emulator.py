"""In-process WebHDFS-compatible DFS server (test harness).

Stands in for a real HDFS/Pangu-gateway endpoint in tests
so the ``dfs://`` client (:mod:`tfplus_tpu_torch.io.dfs`) is exercised over a
genuine HTTP wire, including the protocol's two-step write: CREATE/APPEND
first hit the "namenode" which answers 307 with a datanode Location, and
only the redirected request carries the payload — exactly the handshake a
real WebHDFS client must implement. Maintains a true directory tree
(unlike the object-store emulator's flat keys): MKDIRS creates parents,
LISTSTATUS lists one level, DELETE refuses non-empty dirs unless
``recursive=true``, RENAME moves whole subtrees atomically.

Unknown ``user.name``s are rejected 403 like a secured gateway.

Usage::

    with DfsEmulator(users={"alice"}) as host:     # "127.0.0.1:PORT"
        path = f"dfs://alice@{host}/ckpt/model"

A copy of ``tfplus_tpu/io/dfs_emulator.py`` (stdlib only; the port imports
nothing of the JAX package), but for one change: each file is held in a
``bytearray``, so an APPEND costs its own bytes (the original's ``bytes``
copy the whole file on every append, quadratic in a multi-GB bundle
shard's 1 MB appends).
"""
from __future__ import annotations

import json
import posixpath
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Set
from urllib.parse import parse_qs, unquote, urlparse

_API = "/webhdfs/v1"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # injected per-server (see DfsEmulator)
    files: Dict[str, bytes]
    dirs: Set[str]
    users: Optional[Set[str]]
    lock: threading.Lock
    host: str
    faults: Dict[str, object]

    def log_message(self, *a):       # silence
        pass

    def _maybe_fault(self) -> bool:
        """Fault injection (DfsEmulator.fail_next): 503 or a broken
        connection for the next n requests — the client's idempotent-op
        retry must survive both."""
        only_step2 = False
        with self.lock:
            if int(self.faults.get("n", 0)) <= 0:
                return False
            only_step2 = bool(self.faults.get("only_step2", False))
            if only_step2 and "step2=" not in urlparse(self.path).query:
                return False              # aimed at datanode legs only
            self.faults["n"] = int(self.faults["n"]) - 1
            mode = self.faults.get("mode", "status")
        self._body()                  # drain so keep-alive stays in sync
        if mode == "drop":
            self.wfile.write(b"garbage\r\n")
            self.close_connection = True
            return True
        body = b'{"RemoteException":{"message":"injected 503"}}'
        self.send_response(503)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return True

    # -- helpers ------------------------------------------------------------
    def _parse(self):
        u = urlparse(self.path)
        q = parse_qs(u.query)
        path = unquote(u.path)
        if path.startswith(_API):
            path = path[len(_API):] or "/"
        return posixpath.normpath(path), q

    def _q(self, q, key, default=""):
        return q.get(key, [default])[0]

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", "0") or 0)
        return self.rfile.read(n) if n else b""

    def _reply(self, status: int, obj=None, raw: bytes = b"",
               headers: Optional[dict] = None):
        body = raw if obj is None else json.dumps(obj).encode()
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _exc(self, status: int, kind: str, msg: str):
        self._reply(status, {"RemoteException":
                             {"exception": kind, "message": msg}})

    def _auth(self, q) -> bool:
        if self.users is None:
            return True
        user = self._q(q, "user.name")
        if user in self.users:
            return True
        self._body()        # drain before erroring (keep-alive desync)
        self._exc(403, "SecurityException", f"user {user!r} not authorized")
        return False

    def _status_obj(self, path: str) -> Optional[dict]:
        if path in self.files:
            return {"type": "FILE", "length": len(self.files[path]),
                    "pathSuffix": posixpath.basename(path)}
        if path in self.dirs or path == "/":
            return {"type": "DIRECTORY", "length": 0,
                    "pathSuffix": posixpath.basename(path)}
        return None

    def _parent_ok(self, path: str) -> bool:
        parent = posixpath.dirname(path)
        return parent == "/" or parent in self.dirs

    def _mkdirs(self, path: str):
        parts = [p for p in path.split("/") if p]
        cur = ""
        for p in parts:
            cur += "/" + p
            self.dirs.add(cur)

    # -- verbs ----------------------------------------------------------
    def do_GET(self):
        if self._maybe_fault():
            return
        path, q = self._parse()
        if not self._auth(q):
            return
        op = self._q(q, "op").upper()
        with self.lock:
            if op == "OPEN":
                if "step2" not in q:
                    # reads redirect to the datanode too, like real HDFS
                    u = urlparse(self.path)
                    return self._reply(307, raw=b"", headers={
                        "Location": f"http://{self.host}{u.path}?"
                                    f"{u.query}&step2=1"})
                data = self.files.get(path)
                if data is None:
                    return self._exc(404, "FileNotFoundException", path)
                off = int(self._q(q, "offset", "0") or 0)
                ln = self._q(q, "length")
                end = off + int(ln) if ln else len(data)
                return self._reply(200, raw=data[off:end])
            if op == "GETFILESTATUS":
                st = self._status_obj(path)
                if st is None:
                    return self._exc(404, "FileNotFoundException", path)
                return self._reply(200, {"FileStatus": st})
            if op == "LISTSTATUS":
                if path in self.files:
                    return self._reply(200, {"FileStatuses": {"FileStatus": [
                        self._status_obj(path)]}})
                if path not in self.dirs and path != "/":
                    return self._exc(404, "FileNotFoundException", path)
                prefix = path.rstrip("/") + "/"
                names = set()
                for p in list(self.files) + list(self.dirs):
                    if p.startswith(prefix):
                        names.add(p[len(prefix):].split("/")[0])
                entries = [self._status_obj(
                    prefix + n) or {"type": "DIRECTORY", "length": 0,
                                    "pathSuffix": n}
                    for n in sorted(names)]
                return self._reply(200,
                                   {"FileStatuses": {"FileStatus": entries}})
        self._exc(400, "UnsupportedOperationException", op)

    def do_PUT(self):
        if self._maybe_fault():
            return
        path, q = self._parse()
        if not self._auth(q):
            return
        op = self._q(q, "op").upper()
        if op == "CREATE" and "step2" not in q:
            self._body()
            u = urlparse(self.path)
            return self._reply(307, raw=b"", headers={
                "Location": f"http://{self.host}{u.path}?{u.query}&step2=1"})
        body = self._body()
        with self.lock:
            if op == "CREATE":
                overwrite = self._q(q, "overwrite", "true") == "true"
                if path in self.dirs:
                    return self._exc(403, "FileAlreadyExistsException",
                                     f"{path} is a directory")
                if path in self.files and not overwrite:
                    return self._exc(403, "FileAlreadyExistsException", path)
                self._mkdirs(posixpath.dirname(path))
                # a bytearray, so that an APPEND copies only its own bytes
                self.files[path] = bytearray(body)
                return self._reply(201, raw=b"")
            if op == "MKDIRS":
                if path in self.files:
                    return self._exc(403, "FileAlreadyExistsException", path)
                self._mkdirs(path)
                return self._reply(200, {"boolean": True})
            if op == "RENAME":
                dst = posixpath.normpath(self._q(q, "destination"))
                if path in self.files:
                    if not self._parent_ok(dst):
                        return self._reply(200, {"boolean": False})
                    self.files[dst] = self.files.pop(path)
                    return self._reply(200, {"boolean": True})
                if path in self.dirs:
                    moved_f = {p: b for p, b in self.files.items()
                               if p == path or p.startswith(path + "/")}
                    for p in moved_f:
                        self.files[dst + p[len(path):]] = self.files.pop(p)
                    for p in [d for d in self.dirs
                              if d == path or d.startswith(path + "/")]:
                        self.dirs.discard(p)
                        self.dirs.add(dst + p[len(path):])
                    return self._reply(200, {"boolean": True})
                return self._exc(404, "FileNotFoundException", path)
        self._exc(400, "UnsupportedOperationException", op)

    def do_POST(self):
        if self._maybe_fault():
            return
        path, q = self._parse()
        if not self._auth(q):
            return
        op = self._q(q, "op").upper()
        if op == "APPEND" and "step2" not in q:
            self._body()
            u = urlparse(self.path)
            return self._reply(307, raw=b"", headers={
                "Location": f"http://{self.host}{u.path}?{u.query}&step2=1"})
        body = self._body()
        with self.lock:
            if op == "APPEND":
                if path not in self.files:
                    return self._exc(404, "FileNotFoundException", path)
                self.files[path] += body
                return self._reply(200, raw=b"")
        self._exc(400, "UnsupportedOperationException", op)

    def do_DELETE(self):
        if self._maybe_fault():
            return
        path, q = self._parse()
        if not self._auth(q):
            return
        op = self._q(q, "op").upper()
        recursive = self._q(q, "recursive", "false") == "true"
        with self.lock:
            if op == "DELETE":
                if path in self.files:
                    del self.files[path]
                    return self._reply(200, {"boolean": True})
                if path in self.dirs:
                    children = [p for p in list(self.files) + list(self.dirs)
                                if p.startswith(path + "/")]
                    if children and not recursive:
                        return self._exc(403, "PathIsNotEmptyDirectoryException",
                                         path)
                    for p in children:
                        self.files.pop(p, None)
                        self.dirs.discard(p)
                    self.dirs.discard(path)
                    return self._reply(200, {"boolean": True})
                return self._reply(200, {"boolean": False})
        self._exc(400, "UnsupportedOperationException", op)


class DfsEmulator:
    """Threaded WebHDFS server; context manager yields ``host:port``."""

    def __init__(self, users: Optional[Set[str]] = None):
        handler = type("Handler", (_Handler,), {
            "files": {}, "dirs": set(),
            "users": set(users) if users is not None else None,
            "lock": threading.Lock(), "host": "", "faults": {"n": 0}})
        self._handler = handler
        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        handler.host = f"127.0.0.1:{self._srv.server_address[1]}"
        # a 20 ms shutdown poll (the stdlib's is 0.5 s): closing the
        # emulator is a test's or a script's own wait
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        args=(0.02,), daemon=True)

    @property
    def host(self) -> str:
        return self._handler.host

    @property
    def files(self) -> Dict[str, bytes]:
        return self._handler.files

    def fail_next(self, n: int, mode: str = "status",
                  only_step2: bool = False):
        """Fail the next ``n`` requests (503, or ``mode="drop"`` for a
        broken connection). ``only_step2`` aims the fault at datanode
        (payload-carrying) legs only, leaving namenode legs healthy."""
        with self._handler.lock:
            self._handler.faults.update(n=n, mode=mode,
                                        only_step2=only_step2)

    def __enter__(self) -> str:
        self._thread.start()
        return self.host

    def __exit__(self, *exc):
        self._srv.shutdown()
        self._srv.server_close()
