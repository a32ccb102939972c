"""In-process OSS-compatible object-store server (test harness).

Stands in for the real OSS service in tests so the
``oss://`` client (:mod:`tfplus_tpu_torch.io.object_store`) is exercised over a
genuine HTTP wire: PUT/GET/HEAD/DELETE, ranged GET (206), server-side copy
(``x-oss-copy-source``), paginated prefix listing, the multipart-upload
protocol (Initiate/UploadPart/Complete/Abort, with per-part ETag checks
and an enforceable single-PUT size cap — ``max_put_size`` rejects
oversized plain PUTs 413 EntityTooLarge the way the real service does),
and verification of the OSS ``Authorization: OSS <id>:<hmac-sha1>``
signature including multipart query subresources — requests signed with a
wrong key are rejected 403, like the service.

Usage::

    with OSSEmulator({"my-id": "my-secret"}) as host:   # "127.0.0.1:PORT"
        uri = f"oss://bucket\\x01id=my-id\\x02key=my-secret\\x02host={host}"

A copy of ``tfplus_tpu/io/oss_emulator.py`` (stdlib only; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import hashlib
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

from .object_store import _canonical_subresources, _sign


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # objects + creds injected per-server (see OSSEmulator)
    store: Dict[str, bytes]
    creds: Dict[str, str]
    lock: threading.Lock
    page_size: int = 1000      # listing keys per page (tests shrink this)
    max_put_size: Optional[int] = None   # single-PUT cap (None = unlimited)
    # in-flight multipart uploads: upload_id -> (target key, {n: bytes})
    uploads: Dict[str, Tuple[str, Dict[int, bytes]]]
    # keys created via AppendObject (x-oss-object-type: Appendable);
    # a plain PUT / copy / multipart over the key reverts it to Normal
    appendable: set
    # fault injection (see OSSEmulator.fail_next): {"n", "mode", "status"}
    faults: Dict[str, object]

    def _maybe_fault(self) -> bool:
        with self.lock:
            if int(self.faults.get("n", 0)) <= 0:
                return False
            self.faults["n"] = int(self.faults["n"]) - 1
            mode = self.faults.get("mode", "status")
            status = int(self.faults.get("status", 503))
        self._drain()
        if mode == "drop":
            # malformed status line: the client sees BadStatusLine (a
            # connection-level failure), exercising its reconnect+retry
            self.wfile.write(b"garbage\r\n")
            self.close_connection = True
            return True
        self._reply(status,
                    b"<Error><Code>ServiceUnavailable</Code></Error>")
        return True

    def log_message(self, *a):       # silence
        pass

    def _key(self):
        u = urlparse(self.path)
        # keep_blank_values: "?uploads" is a bare subresource key
        return (unquote(u.path.lstrip("/")),
                parse_qs(u.query, keep_blank_values=True))

    def _authorized(self, verb: str) -> bool:
        auth = self.headers.get("Authorization", "")
        if not auth.startswith("OSS "):
            return False
        try:
            access_id, signature = auth[4:].split(":", 1)
        except ValueError:
            return False
        secret = self.creds.get(access_id)
        if secret is None:
            return False
        date = self.headers.get("Date", "")
        path, _ = self._key()
        # signed subresources (uploads/uploadId/partNumber) are part of the
        # CanonicalizedResource — same rule as the client's _request
        raw_query = urlparse(self.path).query
        oss_headers = {k: v for k, v in self.headers.items()
                       if k.lower().startswith("x-oss-")}
        want = _sign(secret, verb, date,
                     "/" + path + _canonical_subresources(raw_query),
                     oss_headers=oss_headers)
        return signature == want

    def _drain(self):
        n = int(self.headers.get("Content-Length", "0") or 0)
        while n > 0:
            n -= len(self.rfile.read(min(n, 1 << 20)))

    def _deny(self):
        # drain the unread body first or the keep-alive connection desyncs
        # (the next pooled request would parse stale body bytes)
        self._drain()
        self.send_response(403)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _reply(self, status: int, body: bytes = b"",
               headers: Optional[dict] = None):
        self.send_response(status)
        headers = dict(headers or {})
        if "Content-Length" not in headers:
            headers["Content-Length"] = str(len(body))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        if body:
            self.wfile.write(body)

    def do_PUT(self):
        if self._maybe_fault():
            return
        if not self._authorized("PUT"):
            return self._deny()
        key, q = self._key()
        src = self.headers.get("x-oss-copy-source")
        n = int(self.headers.get("Content-Length", "0"))
        is_part = "uploadId" in q and "partNumber" in q
        if src is None and not is_part and self.max_put_size is not None \
                and n > self.max_put_size:
            # the real service's single-PUT cap: oversized objects MUST
            # arrive via the multipart protocol (whose PARTS are exempt —
            # the cap exists to force multipart, not to break it)
            self._drain()
            return self._reply(
                413, b"<Error><Code>EntityTooLarge</Code></Error>")
        if is_part:                                    # UploadPart
            upload_id = q["uploadId"][0]
            part_no = int(q["partNumber"][0])
            body = self.rfile.read(n)
            with self.lock:
                up = self.uploads.get(upload_id)
                if up is None or up[0] != key:
                    return self._reply(404)
                up[1][part_no] = body
            etag = hashlib.md5(body).hexdigest()
            return self._reply(200, headers={"ETag": f'"{etag}"'})
        with self.lock:
            if src is not None:
                skey = src.lstrip("/")
                if skey not in self.store:
                    return self._reply(404)
                self.store[key] = self.store[skey]
                # copy of an appendable source yields a NORMAL object
                # (the real service's rule); same for plain overwrite below
                self.appendable.discard(key)
            else:
                self.store[key] = self.rfile.read(n)
                self.appendable.discard(key)
        self._reply(200)

    def do_POST(self):
        if self._maybe_fault():
            return
        if not self._authorized("POST"):
            return self._deny()
        key, q = self._key()
        if "append" in q:                  # AppendObject
            n = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(n)
            try:
                pos = int(q.get("position", ["-1"])[0])
            except ValueError:
                pos = -1
            with self.lock:
                cur = self.store.get(key)
                if cur is not None and key not in self.appendable:
                    return self._reply(
                        409,
                        b"<Error><Code>ObjectNotAppendable</Code></Error>")
                cur = cur or b""
                if pos != len(cur):
                    # the real service reports where the next append must
                    # land so a retried/conflicting writer can resolve
                    return self._reply(
                        409,
                        b"<Error><Code>PositionNotEqualToLength</Code>"
                        b"</Error>",
                        headers={"x-oss-next-append-position":
                                 str(len(cur))})
                self.store[key] = cur + body
                self.appendable.add(key)
                nxt = len(self.store[key])
            return self._reply(
                200, headers={"x-oss-next-append-position": str(nxt)})
        if "uploads" in q:                 # InitiateMultipartUpload
            self._drain()
            upload_id = secrets.token_hex(12)
            with self.lock:
                self.uploads[upload_id] = (key, {})
            return self._reply(
                200, ("<InitiateMultipartUploadResult><UploadId>"
                      f"{upload_id}</UploadId>"
                      "</InitiateMultipartUploadResult>").encode())
        if "uploadId" in q:                # CompleteMultipartUpload
            import re
            n = int(self.headers.get("Content-Length", "0"))
            xml = self.rfile.read(n).decode()
            upload_id = q["uploadId"][0]
            declared = [(int(pn), et) for pn, et in re.findall(
                r"<PartNumber>(\d+)</PartNumber>\s*<ETag>\"?([^\"<]+)\"?"
                r"</ETag>", xml)]
            with self.lock:
                up = self.uploads.pop(upload_id, None)
            if up is None or up[0] != key:
                return self._reply(404)
            if declared != sorted(declared):   # parts must be ascending
                return self._reply(
                    400, b"<Error><Code>InvalidPartOrder</Code></Error>")
            blobs = []
            for pn, etag in declared:
                body = up[1].get(pn)
                if body is None or hashlib.md5(body).hexdigest() != etag:
                    return self._reply(
                        400, b"<Error><Code>InvalidPart</Code></Error>")
                blobs.append(body)
            with self.lock:
                self.store[key] = b"".join(blobs)
                self.appendable.discard(key)
            return self._reply(
                200, b"<CompleteMultipartUploadResult/>")
        self._drain()
        self._reply(400)

    def do_GET(self):
        if self._maybe_fault():
            return
        if not self._authorized("GET"):
            return self._deny()
        key, q = self._key()
        if "prefix" in q:       # bucket listing: real XML ListBucketResult
            bucket = key.split("/")[0]
            prefix = bucket + "/" + q["prefix"][0]
            marker = q.get("marker", [""])[0]
            page = min(int(q.get("max-keys", ["1000"])[0]), self.page_size)
            with self.lock:
                keys = sorted(k[len(bucket) + 1:] for k in self.store
                              if k.startswith(prefix))
            if marker:
                keys = [k for k in keys if k > marker]
            truncated = len(keys) > page
            out = keys[:page]
            body = ["<?xml version='1.0'?><ListBucketResult>"]
            body += [f"<Contents><Key>{k}</Key></Contents>" for k in out]
            body.append(f"<IsTruncated>{'true' if truncated else 'false'}"
                        "</IsTruncated>")
            if truncated and out:
                body.append(f"<NextMarker>{out[-1]}</NextMarker>")
            body.append("</ListBucketResult>")
            return self._reply(200, "".join(body).encode())
        with self.lock:
            data = self.store.get(key)
        if data is None:
            return self._reply(404)
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            lo, _, hi = rng[6:].partition("-")
            start = int(lo)
            end = int(hi) + 1 if hi else len(data)
            return self._reply(206, data[start:end])
        self._reply(200, data)

    def do_HEAD(self):
        if self._maybe_fault():
            return
        if not self._authorized("HEAD"):
            return self._deny()
        key, _ = self._key()
        with self.lock:
            data = self.store.get(key)
            kind = "Appendable" if key in self.appendable else "Normal"
        if data is None:
            return self._reply(404)
        self._reply(200, headers={"Content-Length": str(len(data)),
                                  "x-oss-object-type": kind})
        # body suppressed for HEAD by _reply writing b"" only

    def do_DELETE(self):
        if self._maybe_fault():
            return
        if not self._authorized("DELETE"):
            return self._deny()
        key, q = self._key()
        with self.lock:
            if "uploadId" in q:            # AbortMultipartUpload
                self.uploads.pop(q["uploadId"][0], None)
            else:
                self.store.pop(key, None)
                self.appendable.discard(key)
        self._reply(204)


class OSSEmulator:
    """Threaded object-store server; context manager yields ``host:port``."""

    def __init__(self, creds: Dict[str, str], page_size: int = 1000,
                 max_put_size: Optional[int] = None):
        handler = type("Handler", (_Handler,), {
            "store": {}, "creds": dict(creds), "lock": threading.Lock(),
            "page_size": page_size, "max_put_size": max_put_size,
            "uploads": {}, "appendable": set(), "faults": {"n": 0}})
        self._handler = handler
        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        # a 20 ms shutdown poll (the stdlib's is 0.5 s): closing the
        # emulator is a test's or a script's own wait
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        args=(0.02,), daemon=True)

    @property
    def host(self) -> str:
        return f"127.0.0.1:{self._srv.server_address[1]}"

    @property
    def objects(self) -> Dict[str, bytes]:
        return self._handler.store

    def fail_next(self, n: int, mode: str = "status", status: int = 503):
        """Make the next ``n`` requests fail: ``mode="status"`` answers
        ``status`` (default 503), ``mode="drop"`` breaks the connection
        mid-response — both must be survived by the client's retry."""
        with self._handler.lock:
            self._handler.faults.update(n=n, mode=mode, status=status)

    def __enter__(self) -> str:
        self._thread.start()
        return self.host

    def __exit__(self, *exc):
        self._srv.shutdown()
        self._srv.server_close()
