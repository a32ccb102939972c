"""In-process S3-compatible server (test harness) with REAL SigV4
verification.

Stands in for an S3-compatible service in tests so the
``s3://`` client (:mod:`tfplus_tpu_torch.io.s3`) is exercised over a genuine
HTTP wire. For every request the server parses the ``AWS4-HMAC-SHA256``
Authorization header, REBUILDS the canonical request from what actually
arrived (verb, path, query, the client's SignedHeaders list, the
``x-amz-content-sha256`` the client declared), re-derives the signing key
from its own copy of the secret and compares signatures — a wrong secret,
a tampered signed header, or an unknown access id is rejected 403, as the
real service does. The declared payload hash is also checked against the
received body (SigV4's payload-integrity property).

Protocol surface: PUT/GET/HEAD/DELETE, ranged GET (206), server-side copy
(``x-amz-copy-source``), ListObjectsV2 with continuation-token
pagination, the multipart protocol (CreateMultipartUpload / UploadPart /
CompleteMultipartUpload / Abort with ETag checks), and an enforceable
single-PUT cap (400 EntityTooLarge) to force the multipart path.

Usage::

    with S3Emulator({"my-id": "my-secret"}) as host:      # "127.0.0.1:PORT"
        uri = f"s3://bucket\\x01id=my-id\\x02key=my-secret\\x02host={host}"

A copy of ``tfplus_tpu/io/s3_emulator.py`` (stdlib only; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import hashlib
import hmac
import re
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlparse

from .s3 import _uri_encode, derive_signing_key

_AUTH_RE = re.compile(
    r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d{8})/([^/]+)/s3/aws4_request, "
    r"SignedHeaders=([^,]+), Signature=([0-9a-f]{64})")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    store: Dict[str, bytes]
    creds: Dict[str, str]
    lock: threading.Lock
    page_size: int = 1000
    max_put_size: Optional[int] = None
    uploads: Dict[str, Tuple[str, Dict[int, bytes]]]
    faults: Dict[str, object]

    def log_message(self, *a):
        pass

    # -- helpers -----------------------------------------------------------
    def _key(self):
        u = urlparse(self.path)
        return (unquote(u.path.lstrip("/")),
                dict(parse_qsl(u.query, keep_blank_values=True)))

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length", "0") or 0)
        out = b""
        while len(out) < n:
            out += self.rfile.read(n - len(out))
        return out

    def _reply(self, status: int, body: bytes = b"",
               headers: Optional[dict] = None, head_only=False):
        self.send_response(status)
        headers = dict(headers or {})
        if "Content-Length" not in headers:
            headers["Content-Length"] = str(len(body))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        if body and not head_only:
            self.wfile.write(body)

    def _maybe_fault(self) -> bool:
        with self.lock:
            if int(self.faults.get("n", 0)) <= 0:
                return False
            self.faults["n"] = int(self.faults["n"]) - 1
        self._read_body()
        self._reply(503, b"<Error><Code>SlowDown</Code></Error>")
        return True

    def _verify(self, verb: str, body: bytes) -> bool:
        """Re-derive the SigV4 signature from the arrived request."""
        m = _AUTH_RE.match(self.headers.get("Authorization", ""))
        if not m:
            return False
        access_id, date, region, signed_headers, got_sig = m.groups()
        secret = self.creds.get(access_id)
        if secret is None:
            return False
        # the client's declared payload hash must match the actual body
        declared_sha = self.headers.get("x-amz-content-sha256", "")
        if hashlib.sha256(body).hexdigest() != declared_sha:
            return False
        u = urlparse(self.path)
        q = dict(parse_qsl(u.query, keep_blank_values=True))
        canonical_query = "&".join(
            f"{_uri_encode(k, encode_slash=True)}="
            f"{_uri_encode(v, encode_slash=True)}"
            for k, v in sorted(q.items()))
        names = signed_headers.split(";")
        canonical_headers = "".join(
            f"{n}:{' '.join((self.headers.get(n) or '').split())}\n"
            for n in sorted(names))
        canonical_request = "\n".join([
            verb, _uri_encode(unquote(u.path), encode_slash=False),
            canonical_query, canonical_headers, signed_headers,
            declared_sha])
        amz_date = self.headers.get("x-amz-date", "")
        if not amz_date.startswith(date):
            return False
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date,
            f"{date}/{region}/s3/aws4_request",
            hashlib.sha256(canonical_request.encode()).hexdigest()])
        want = hmac.new(derive_signing_key(secret, date, region),
                        string_to_sign.encode(), hashlib.sha256).hexdigest()
        return hmac.compare_digest(want, got_sig)

    # -- verbs -------------------------------------------------------------
    def do_PUT(self):
        if self._maybe_fault():
            return
        body = self._read_body()
        if not self._verify("PUT", body):
            return self._reply(403, b"<Error><Code>SignatureDoesNotMatch"
                                    b"</Code></Error>")
        key, q = self._key()
        src = self.headers.get("x-amz-copy-source")
        if "uploadId" in q and "partNumber" in q:
            with self.lock:
                up = self.uploads.get(q["uploadId"])
                if up is None or up[0] != key:
                    return self._reply(404)
                up[1][int(q["partNumber"])] = body
            etag = hashlib.md5(body).hexdigest()
            return self._reply(200, headers={"ETag": f'"{etag}"'})
        if src is not None:
            skey = unquote(src.lstrip("/"))
            with self.lock:
                if skey not in self.store:
                    return self._reply(404)
                self.store[key] = self.store[skey]
            return self._reply(200, b"<CopyObjectResult/>")
        if self.max_put_size is not None and len(body) > self.max_put_size:
            return self._reply(
                400, b"<Error><Code>EntityTooLarge</Code></Error>")
        with self.lock:
            self.store[key] = body
        self._reply(200)

    def do_POST(self):
        if self._maybe_fault():
            return
        body = self._read_body()
        if not self._verify("POST", body):
            return self._reply(403)
        key, q = self._key()
        if "uploads" in q:
            upload_id = secrets.token_hex(12)
            with self.lock:
                self.uploads[upload_id] = (key, {})
            return self._reply(
                200, ("<InitiateMultipartUploadResult><UploadId>"
                      f"{upload_id}</UploadId>"
                      "</InitiateMultipartUploadResult>").encode())
        if "uploadId" in q:
            declared = [(int(pn), et) for pn, et in re.findall(
                r"<PartNumber>(\d+)</PartNumber><ETag>\"?([^\"<]+)\"?"
                r"</ETag>", body.decode())]
            with self.lock:
                up = self.uploads.pop(q["uploadId"], None)
            if up is None or up[0] != key:
                return self._reply(404)
            if declared != sorted(declared):
                return self._reply(
                    200, b"<Error><Code>InvalidPartOrder</Code></Error>")
            blobs = []
            for pn, etag in declared:
                part = up[1].get(pn)
                if part is None or hashlib.md5(part).hexdigest() != etag:
                    return self._reply(
                        200, b"<Error><Code>InvalidPart</Code></Error>")
                blobs.append(part)
            with self.lock:
                self.store[key] = b"".join(blobs)
            return self._reply(200, b"<CompleteMultipartUploadResult/>")
        self._reply(400)

    def do_GET(self):
        if self._maybe_fault():
            return
        if not self._verify("GET", b""):
            return self._reply(403)
        key, q = self._key()
        if q.get("list-type") == "2":
            bucket = key.split("/")[0]
            prefix = bucket + "/" + q.get("prefix", "")
            token = q.get("continuation-token", "")
            with self.lock:
                keys = sorted(k[len(bucket) + 1:] for k in self.store
                              if k.startswith(prefix))
            if token:
                keys = [k for k in keys if k > token]
            page = min(int(q.get("max-keys", "1000")), self.page_size)
            truncated = len(keys) > page
            out = keys[:page]
            xml = ["<?xml version='1.0'?><ListBucketResult>"]
            xml += [f"<Contents><Key>{k}</Key></Contents>" for k in out]
            xml.append(f"<IsTruncated>{'true' if truncated else 'false'}"
                       "</IsTruncated>")
            if truncated and out:
                xml.append(f"<NextContinuationToken>{out[-1]}"
                           "</NextContinuationToken>")
            xml.append("</ListBucketResult>")
            return self._reply(200, "".join(xml).encode())
        with self.lock:
            data = self.store.get(key)
        if data is None:
            return self._reply(404, b"<Error><Code>NoSuchKey</Code></Error>")
        rng = self.headers.get("range") or self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            lo, _, hi = rng[6:].partition("-")
            start = int(lo)
            end = int(hi) + 1 if hi else len(data)
            return self._reply(206, data[start:end])
        self._reply(200, data)

    def do_HEAD(self):
        if not self._verify("HEAD", b""):
            return self._reply(403, head_only=True)
        key, _ = self._key()
        with self.lock:
            data = self.store.get(key)
        if data is None:
            return self._reply(404, head_only=True)
        self._reply(200, headers={"Content-Length": str(len(data))},
                    head_only=True)

    def do_DELETE(self):
        if not self._verify("DELETE", b""):
            return self._reply(403)
        key, q = self._key()
        with self.lock:
            if "uploadId" in q:
                self.uploads.pop(q["uploadId"], None)
            else:
                self.store.pop(key, None)
        self._reply(204)


class S3Emulator:
    """Threaded S3-compatible server; context manager yields ``host:port``."""

    def __init__(self, creds: Dict[str, str], page_size: int = 1000,
                 max_put_size: Optional[int] = None):
        handler = type("Handler", (_Handler,), {
            "store": {}, "creds": dict(creds), "lock": threading.Lock(),
            "page_size": page_size, "max_put_size": max_put_size,
            "uploads": {}, "faults": {"n": 0}})
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

    def fail_next(self, n: int):
        with self._handler.lock:
            self._handler.faults["n"] = n

    def __enter__(self) -> str:
        self._thread.start()
        return self.host

    def __exit__(self, *exc):
        self._srv.shutdown()
        self._srv.server_close()
