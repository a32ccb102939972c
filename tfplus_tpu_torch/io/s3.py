"""S3-compatible object-store filesystem — the ``s3://`` scheme.

A third, genuinely distinct remote backend next to ``oss://`` (OSS
SigV1-style ``Authorization: OSS id:hmac-sha1``, :mod:`.object_store`)
and ``dfs://`` (WebHDFS two-step redirect REST, :mod:`.dfs`). This one
speaks **AWS Signature Version 4**: per-request canonical-request
hashing, an HMAC-SHA256 key-derivation chain
(AWS4<secret> → date → region → service → "aws4_request"), signed
headers incl. ``x-amz-content-sha256``, and S3's ListObjectsV2 /
multipart-upload XML protocols. Shares ONLY the
:class:`~tfplus_tpu_torch.io.filesystem.FileSystem` interface with the other
backends.

Reference context: the reference ships three filesystem plugins (OSS,
DFS/zdfs, Pangu — pangu/kernels/pangufs/pangu_file_system.cc). Its Pangu
backend needs a proprietary SDK that cannot exist here, so this repo
aliases ``pangu://`` to the WebHDFS client (PARITY.md N28 says so
explicitly) and instead proves the "third distinct protocol" capability
with S3 — the protocol most deployments actually meet (S3/GCS-style
object stores).

Point it at any S3-compatible endpoint (path-style addressing). Tests
run against :mod:`tfplus_tpu_torch.io.s3_emulator`, an in-process server that
RE-DERIVES the SigV4 signature — a wrong secret or a tampered header is
rejected 403, like the real service.

Credentials: ``s3://bucket\\x01id=..\\x02key=..\\x02host=..`` URI
embedding (same delimiter grammar as the reference's OSS URIs) or
AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY / S3_ENDPOINT env; region from
AWS_REGION (default us-east-1).

A copy of ``tfplus_tpu/io/s3.py`` (stdlib only; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import io
import os
import re
import tempfile
import threading
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote

from .filesystem import FileSystem, register_filesystem
from .retry import retry_transient

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
_MULTIPART_THRESHOLD = 32 << 20
_PART_SIZE = 16 << 20
_READAHEAD = 4 << 20
_SPOOL_MAX = 64 << 20


def parse_s3_uri(uri: str):
    """``s3://bucket\\x01id=..\\x02key=..\\x02host=..\\x02region=../key``
    (or ``?``/``&`` delimiters); missing fields fall back to
    AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY / S3_ENDPOINT / AWS_REGION."""
    rest = uri[len("s3://"):] if uri.startswith("s3://") else uri
    authority, _, object_path = rest.partition("/")
    creds = {"id": os.environ.get("AWS_ACCESS_KEY_ID", ""),
             "key": os.environ.get("AWS_SECRET_ACCESS_KEY", ""),
             "host": os.environ.get("S3_ENDPOINT", ""),
             "region": os.environ.get("AWS_REGION", "us-east-1")}
    bucket_delim, access_delim = ("\x01", "\x02") if "\x01" in authority \
        else ("?", "&")
    bucket, sep, cred_part = authority.partition(bucket_delim)
    if sep:
        for kvp in cred_part.split(access_delim):
            if "=" in kvp:
                k, v = kvp.split("=", 1)
                creds[k] = v
    return bucket, object_path, creds


def _uri_encode(s: str, *, encode_slash: bool) -> str:
    """SigV4 UriEncode: unreserved chars pass, everything else %XX
    (uppercase hex); '/' passes only in paths."""
    return quote(s, safe="-._~" + ("" if encode_slash else "/"))


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def derive_signing_key(secret: str, date: str, region: str,
                       service: str = "s3") -> bytes:
    """The SigV4 key chain: HMAC("AWS4"+secret, date) → region → service
    → "aws4_request"."""
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def sign_v4(*, verb: str, path: str, query: Dict[str, str],
            headers: Dict[str, str], payload_sha256: str,
            access_id: str, secret: str, region: str,
            amz_date: str) -> str:
    """Return the ``Authorization`` header value for one request.

    ``headers`` must already contain host / x-amz-date /
    x-amz-content-sha256 — every entry is signed (SignedHeaders lists
    them all, sorted)."""
    date = amz_date[:8]
    canonical_query = "&".join(
        f"{_uri_encode(k, encode_slash=True)}="
        f"{_uri_encode(v, encode_slash=True)}"
        for k, v in sorted(query.items()))
    low = {k.lower(): " ".join(v.split()) for k, v in headers.items()}
    signed_headers = ";".join(sorted(low))
    canonical_headers = "".join(f"{k}:{low[k]}\n" for k in sorted(low))
    canonical_request = "\n".join([
        verb, _uri_encode(path, encode_slash=False), canonical_query,
        canonical_headers, signed_headers, payload_sha256])
    scope = f"{date}/{region}/s3/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])
    sig = hmac.new(derive_signing_key(secret, date, region),
                   string_to_sign.encode(), hashlib.sha256).hexdigest()
    return (f"AWS4-HMAC-SHA256 Credential={access_id}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={sig}")


class S3ConnectionPool:
    def __init__(self, host: str, max_connections: int = 8):
        self._host = host
        self._lock = threading.Lock()
        self._free: List[http.client.HTTPConnection] = []

    def acquire(self) -> http.client.HTTPConnection:
        with self._lock:
            if self._free:
                return self._free.pop()
        return http.client.HTTPConnection(self._host, timeout=60)

    def release(self, conn: http.client.HTTPConnection):
        with self._lock:
            self._free.append(conn)


class S3Client:
    """Path-style S3 REST client with SigV4 signing."""

    def __init__(self, bucket: str, access_id: str, secret: str,
                 endpoint: str, region: str = "us-east-1"):
        if not endpoint:
            raise ValueError("S3 endpoint missing (URI host= or "
                             "S3_ENDPOINT env)")
        self.bucket = bucket
        self._id = access_id
        self._secret = secret
        self._region = region
        self._host = endpoint
        self._pool = S3ConnectionPool(endpoint)

    # -- core request ------------------------------------------------------
    def _request(self, verb: str, key: str, *, body: bytes = b"",
                 query: Optional[Dict[str, str]] = None,
                 headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, dict, bytes]:
        query = dict(query or {})
        payload_sha = hashlib.sha256(body).hexdigest() if body \
            else _EMPTY_SHA256
        path = "/" + self.bucket + ("/" + key if key else "")

        def attempt() -> Tuple[int, dict, bytes]:
            amz_date = datetime.datetime.now(
                datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
            h = {"host": self._host, "x-amz-date": amz_date,
                 "x-amz-content-sha256": payload_sha}
            h.update({k.lower(): v for k, v in (headers or {}).items()})
            auth = sign_v4(verb=verb, path=path, query=query, headers=h,
                           payload_sha256=payload_sha, access_id=self._id,
                           secret=self._secret, region=self._region,
                           amz_date=amz_date)
            qs = "&".join(f"{quote(k, safe='')}={quote(v, safe='')}"
                          for k, v in sorted(query.items()))
            url = path + ("?" + qs if qs else "")
            conn = self._pool.acquire()
            try:
                conn.putrequest(verb, url, skip_host=True,
                                skip_accept_encoding=True)
                for k, v in h.items():
                    conn.putheader(k, v)
                conn.putheader("Authorization", auth)
                conn.putheader("Content-Length", str(len(body)))
                conn.endheaders()
                if body:
                    conn.send(body)
                resp = conn.getresponse()
                data = resp.read()
                status, rheaders = resp.status, dict(resp.getheaders())
                self._pool.release(conn)
                return status, rheaders, data
            except Exception:
                conn.close()
                raise

        return retry_transient(attempt, describe=f"s3 {verb} {path}",
                               status_of=lambda r: r[0])

    # -- object verbs ------------------------------------------------------
    def put(self, key: str, data: bytes):
        status, _, body = self._request("PUT", key, body=data)
        if status == 413 or (status == 400 and b"EntityTooLarge" in body):
            raise _TooLarge()
        if status != 200:
            raise IOError(f"s3 PUT {key}: {status} {body[:200]!r}")

    def get(self, key: str, start: Optional[int] = None,
            end: Optional[int] = None) -> bytes:
        headers = {}
        if start is not None:
            headers["range"] = f"bytes={start}-" + (
                str(end - 1) if end is not None else "")
        status, _, data = self._request("GET", key, headers=headers)
        if status in (200, 206):
            return data
        if status == 404:
            raise FileNotFoundError(f"s3://{self.bucket}/{key}")
        raise IOError(f"s3 GET {key}: {status}")

    def head(self, key: str) -> Optional[int]:
        status, headers, _ = self._request("HEAD", key)
        if status == 200:
            return int(headers.get("Content-Length", "0"))
        return None

    def delete(self, key: str):
        status, _, _ = self._request("DELETE", key)
        if status not in (200, 204, 404):
            raise IOError(f"s3 DELETE {key}: {status}")

    def copy(self, src_key: str, dst_key: str,
             src_bucket: Optional[str] = None):
        src = f"/{src_bucket or self.bucket}/{src_key}"
        status, _, body = self._request(
            "PUT", dst_key, headers={"x-amz-copy-source": src})
        if status != 200:
            raise IOError(f"s3 COPY {src} -> {dst_key}: {status}")

    def list(self, prefix: str) -> List[str]:
        """ListObjectsV2 with continuation-token pagination."""
        out: List[str] = []
        token: Optional[str] = None
        while True:
            q = {"list-type": "2", "prefix": prefix}
            if token:
                q["continuation-token"] = token
            status, _, body = self._request("GET", "", query=q)
            if status != 200:
                raise IOError(f"s3 LIST {prefix}: {status}")
            text = body.decode()
            out += re.findall(r"<Key>([^<]+)</Key>", text)
            if "<IsTruncated>true</IsTruncated>" not in text:
                return out
            m = re.search(r"<NextContinuationToken>([^<]+)"
                          r"</NextContinuationToken>", text)
            if not m:
                return out
            token = m.group(1)

    # -- multipart ---------------------------------------------------------
    def initiate_multipart(self, key: str) -> str:
        status, _, body = self._request("POST", key, query={"uploads": ""})
        if status != 200:
            raise IOError(f"s3 CreateMultipartUpload {key}: {status}")
        m = re.search(r"<UploadId>([^<]+)</UploadId>", body.decode())
        if not m:
            raise IOError("s3 CreateMultipartUpload: no UploadId")
        return m.group(1)

    def upload_part(self, key: str, upload_id: str, part_number: int,
                    data: bytes) -> str:
        status, headers, body = self._request(
            "PUT", key, body=data,
            query={"partNumber": str(part_number), "uploadId": upload_id})
        if status != 200:
            raise IOError(f"s3 UploadPart {key}#{part_number}: {status}")
        return headers.get("ETag", "").strip('"')

    def complete_multipart(self, key: str, upload_id: str,
                           etags: List[Tuple[int, str]]):
        xml = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag></Part>"
            for n, e in sorted(etags)) + "</CompleteMultipartUpload>"
        status, _, body = self._request(
            "POST", key, body=xml.encode(), query={"uploadId": upload_id})
        if status != 200 or b"<Error>" in body:
            raise IOError(f"s3 CompleteMultipartUpload {key}: {status} "
                          f"{body[:200]!r}")

    def abort_multipart(self, key: str, upload_id: str):
        self._request("DELETE", key, query={"uploadId": upload_id})

    def put_stream(self, key: str, fileobj, size: int):
        """Single PUT below the multipart threshold, multipart above —
        ALSO the fallback when the service rejects a plain PUT as too
        large (EntityTooLarge)."""
        if size <= _MULTIPART_THRESHOLD:
            data = fileobj.read()
            try:
                return self.put(key, data)
            except _TooLarge:
                fileobj = io.BytesIO(data)
        upload_id = self.initiate_multipart(key)
        try:
            etags = []
            n = 1
            while True:
                chunk = fileobj.read(_PART_SIZE)
                if not chunk:
                    break
                etags.append((n, self.upload_part(key, upload_id, n,
                                                  chunk)))
                n += 1
            if not etags:
                etags.append((1, self.upload_part(key, upload_id, 1, b"")))
            self.complete_multipart(key, upload_id, etags)
        except Exception:
            self.abort_multipart(key, upload_id)
            raise


class _TooLarge(Exception):
    pass


class _S3ReadFile(io.RawIOBase):
    """Ranged-GET reader with readahead."""

    def __init__(self, client: S3Client, key: str, size: int):
        self._c = client
        self._key = key
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
        n = min(n, self._size - self._pos)
        if n <= 0:
            return b""
        lo = self._pos - self._buf_start
        if 0 <= lo and lo + n <= len(self._buf):
            out = self._buf[lo:lo + n]
        else:
            want = max(n, _READAHEAD)
            self._buf = self._c.get(self._key, self._pos,
                                    min(self._pos + want, self._size))
            self._buf_start = self._pos
            out = self._buf[:n]
        self._pos += len(out)
        return out

    def readinto(self, b):
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)


class _S3WriteFile(io.RawIOBase):
    """Spooled writer: single PUT / multipart on close (S3 objects are
    immutable — no append verb exists in the protocol)."""

    def __init__(self, client: S3Client, key: str,
                 initial: Optional[bytes] = None):
        self._c = client
        self._key = key
        self._spool = tempfile.SpooledTemporaryFile(max_size=_SPOOL_MAX)
        if initial:
            self._spool.write(initial)
        self._closed = False

    def writable(self):
        return True

    def write(self, b):
        self._spool.write(b)
        return len(b)

    def tell(self):
        return self._spool.tell()

    def seek(self, pos, whence=0):
        return self._spool.seek(pos, whence)

    def close(self):
        if self._closed:
            return
        size = self._spool.seek(0, 2)
        self._spool.seek(0)
        self._c.put_stream(self._key, self._spool, size)
        self._spool.close()
        self._closed = True
        super().close()


class S3FileSystem(FileSystem):
    """``s3://bucket/key`` filesystem over :class:`S3Client`. Append mode
    is emulated by read + rewrite (S3 has no append — documented cost);
    rename is server-side copy + delete."""

    def __init__(self, default_client: Optional[S3Client] = None):
        self._clients: Dict[str, S3Client] = {}
        if default_client is not None:
            self._clients[default_client.bucket] = default_client

    def _resolve(self, path: str) -> Tuple[S3Client, str]:
        bucket, key, creds = parse_s3_uri("s3://" + path)
        client = self._clients.get(bucket)
        if client is None:
            client = S3Client(bucket, creds["id"], creds["key"],
                              creds["host"], creds.get("region",
                                                       "us-east-1"))
            self._clients[bucket] = client
        return client, key

    def open(self, path, mode="rb"):
        c, key = self._resolve(path)
        if "r" in mode:
            size = c.head(key)
            if size is None:
                raise FileNotFoundError(f"s3://{path}")
            f = _S3ReadFile(c, key, size)
            return io.BufferedReader(f) if "b" in mode else f
        if "a" in mode:
            size = c.head(key)
            return _S3WriteFile(c, key, c.get(key) if size else None)
        return _S3WriteFile(c, key)

    def exists(self, path):
        c, key = self._resolve(path)
        if c.head(key) is not None:
            return True
        return bool(c.list(key.rstrip("/") + "/"))

    def listdir(self, path):
        c, key = self._resolve(path)
        prefix = key.rstrip("/") + "/" if key else ""
        out = set()
        for k in c.list(prefix):
            rest = k[len(prefix):]
            if rest:
                out.add(rest.split("/")[0])
        return sorted(out)

    def makedirs(self, path):
        c, key = self._resolve(path)
        if key:
            c.put(key.rstrip("/") + "/", b"")

    def remove(self, path):
        c, key = self._resolve(path)
        c.delete(key)

    def rename(self, src, dst):
        sc, skey = self._resolve(src)
        dc, dkey = self._resolve(dst)
        dc.copy(skey, dkey, src_bucket=sc.bucket)
        sc.delete(skey)

    def size(self, path):
        c, key = self._resolve(path)
        n = c.head(key)
        if n is None:
            raise FileNotFoundError(f"s3://{path}")
        return n


def register_s3(default_client: Optional[S3Client] = None) -> S3FileSystem:
    """Install the ``s3://`` scheme."""
    fs = S3FileSystem(default_client)
    register_filesystem("s3", fs)
    return fs
