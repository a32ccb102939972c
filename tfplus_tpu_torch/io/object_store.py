"""OSS-style object-store filesystem — a REAL remote backend for the
``oss://`` scheme.

Equivalent of the reference's Alibaba OSS filesystem plugin
(``oss/kernels/ossfs/oss_file_system.{h,cc}``, 1,293 LoC: OSSConnection
pool :83-120, Random/Writable/Appendable files, dir emulation over
objects; op registration ``REGISTER_FILE_SYSTEM("oss", ...)``
ops/ossfs_ops.cc:9). This is an actual HTTP client — OSS-compatible REST
verbs (PUT/GET/HEAD/DELETE, ranged GET, prefix listing) with the OSS
``Authorization: OSS <id>:<hmac-sha1 signature>`` header — not a local
shim; point it at any OSS-compatible endpoint. Tests run it against
:mod:`tfplus_tpu_torch.io.oss_emulator` (an in-process object-store server that
verifies the signatures), over loopback.

Credentials follow the reference's URI embedding
(``oss://bucket\\x01id=..\\x02key=..\\x02host=..``, oss_file_system.cc) or
the OSS_ACCESS_ID / OSS_ACCESS_KEY / OSS_HOST environment variables —
:func:`tfplus_tpu_torch.io.filesystem.parse_oss_uri`.

Listings follow GetBucket pagination (IsTruncated/NextMarker — real OSS
serves at most 1000 keys per page), and writes above
``_MULTIPART_THRESHOLD`` go through the OSS multipart-upload protocol
(InitiateMultipartUpload / UploadPart / CompleteMultipartUpload, the
same three-verb dance the reference's OSSWritableFile delegates to the
SDK for, oss_file_system.cc) — single-PUT size limits on real OSS make
multipart mandatory for multi-GB bundle shards. The test emulator
enforces the PUT cap (413 EntityTooLarge) so the multipart path is the
one actually exercised.

Capabilities the checkpoint layer needs and gets here:
  * streaming writes — spooled to a temp file, single PUT on close
    (bounded memory for multi-GB bundle shards),
  * random-access reads — ranged GETs with a readahead buffer
    (BundleReader.lookup_slice / stream hit this),
  * atomic-ish publish — rename = server-side copy + delete (OSS has no
    rename; same emulation as the reference),
  * dir emulation over key prefixes.

A copy of ``tfplus_tpu/io/object_store.py`` (stdlib only; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
import http.client
import io
import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote, urlparse

from .filesystem import FileSystem, parse_oss_uri, register_filesystem
from .retry import retry_transient

_READAHEAD = 4 << 20          # ranged-GET readahead
_SPOOL_MAX = 64 << 20         # writes spill to disk beyond this
_MULTIPART_THRESHOLD = 32 << 20   # objects above this upload in parts
_PART_SIZE = 16 << 20             # multipart part size
# Query subresources that are part of the OSS CanonicalizedResource (the
# signing spec's list; prefix/marker/max-keys are deliberately NOT in it).
_SIGNED_SUBRESOURCES = ("append", "partNumber", "position", "uploadId",
                        "uploads")


def _canonical_subresources(query: str) -> str:
    """``?``-suffix of the CanonicalizedResource: the signed subresources
    present in ``query``, sorted, ``k=v`` (or bare ``k``) joined by ``&``."""
    if not query:
        return ""
    picked = []
    for kv_pair in query.split("&"):
        k, sep, v = kv_pair.partition("=")
        if k in _SIGNED_SUBRESOURCES:
            picked.append((k, v if sep else None))
    if not picked:
        return ""
    picked.sort()
    return "?" + "&".join(k if v is None else f"{k}={v}" for k, v in picked)


def _sign(key: str, verb: str, date: str, resource: str,
          content_md5: str = "", content_type: str = "",
          oss_headers: Optional[Dict[str, str]] = None) -> str:
    """OSS header signature: base64(hmac-sha1(key, VERB\\nMD5\\nTYPE\\nDATE\\n
    CanonicalizedOSSHeaders + /bucket/object)) — the contract the
    reference's SDK signs with. ``oss_headers``: any ``x-oss-*`` request
    headers, canonicalized (lowercased, sorted, ``k:v\\n`` each) per the
    OSS signing spec — required for copy (x-oss-copy-source) to verify."""
    canon = ""
    if oss_headers:
        items = sorted((k.lower(), v) for k, v in oss_headers.items()
                       if k.lower().startswith("x-oss-"))
        canon = "".join(f"{k}:{v}\n" for k, v in items)
    msg = "\n".join([verb, content_md5, content_type, date, canon + resource])
    mac = hmac.new(key.encode(), msg.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


class OSSConnectionPool:
    """Reusable HTTP connections per host (reference OSSConnection pool,
    oss_file_system.cc:83-120)."""

    def __init__(self, host: str, max_connections: int = 8):
        u = urlparse(host if "//" in host else "http://" + host)
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


class ObjectStoreClient:
    """Signed OSS-REST client for one bucket."""

    def __init__(self, bucket: str, access_id: str, access_key: str,
                 host: str):
        if not host:
            raise ValueError("object store host required "
                             "(URI \\x02host=... or OSS_HOST)")
        self.bucket = bucket
        self._id = access_id
        self._key = access_key
        self._pool = OSSConnectionPool(host)

    def _request(self, verb: str, key: str, *, body=None,
                 headers: Optional[Dict[str, str]] = None,
                 query: str = "") -> Tuple[int, dict, bytes]:
        """One signed request with bounded retry (io/retry.py policy) —
        each attempt re-signs, since the Date header changes. Every body
        here is bytes, so re-sending is always safe; the one
        non-idempotent ambiguity (CompleteMultipartUpload succeeding just
        before a dropped response) is resolved by its caller via a
        size-verified HEAD."""
        path = "/" + quote(f"{self.bucket}/{key}", safe="/")
        if query:
            path += "?" + query
        resource = f"/{self.bucket}/{key}" + _canonical_subresources(query)

        def attempt() -> Tuple[int, dict, bytes]:
            date = email.utils.formatdate(usegmt=True)
            sig = _sign(self._key, verb, date, resource, oss_headers=headers)
            h = {"Date": date, "Authorization": f"OSS {self._id}:{sig}"}
            if headers:
                h.update(headers)
            conn = self._pool.acquire()
            try:
                conn.request(verb, path, body=body, headers=h)
                resp = conn.getresponse()
                data = resp.read()
                out_headers = dict(resp.getheaders())
                status = resp.status
            except (http.client.HTTPException, OSError):
                conn.close()
                raise
            self._pool.release(conn)
            return status, out_headers, data

        return retry_transient(
            attempt, describe=f"{verb} oss://{self.bucket}/{key}",
            status_of=lambda r: r[0])

    # -- object verbs -------------------------------------------------------
    def put(self, key: str, data: bytes):
        st, _, body = self._request("PUT", key, body=data)
        if st != 200:
            raise IOError(f"PUT oss://{self.bucket}/{key}: {st} {body[:200]}")

    def get(self, key: str, start: Optional[int] = None,
            end: Optional[int] = None) -> bytes:
        headers = {}
        if start is not None:
            # HTTP Range is inclusive
            headers["Range"] = f"bytes={start}-{'' if end is None else end - 1}"
        st, _, data = self._request("GET", key, headers=headers)
        if st == 404:
            raise FileNotFoundError(f"oss://{self.bucket}/{key}")
        if st not in (200, 206):
            raise IOError(f"GET oss://{self.bucket}/{key}: {st}")
        return data

    def head(self, key: str) -> Optional[int]:
        """Object size, or None if absent."""
        st, headers, _ = self._request("HEAD", key)
        if st == 404:
            return None
        if st != 200:
            raise IOError(f"HEAD oss://{self.bucket}/{key}: {st}")
        return int(headers.get("Content-Length", "0"))

    def stat(self, key: str) -> Tuple[Optional[int], str]:
        """(size, object type) — type is "Normal", "Appendable", or
        "Multipart" (x-oss-object-type); (None, "") if absent."""
        st, headers, _ = self._request("HEAD", key)
        if st == 404:
            return None, ""
        if st != 200:
            raise IOError(f"HEAD oss://{self.bucket}/{key}: {st}")
        return (int(headers.get("Content-Length", "0")),
                headers.get("x-oss-object-type", "Normal"))

    def append(self, key: str, data: bytes, position: int) -> int:
        """Native AppendObject (reference surface: OSS AppendableFile,
        oss_file_system.h:126): appends ``data`` at byte ``position``
        (which must equal the current length) and returns the next append
        position. Single-writer contract: a 409 position conflict whose
        server-side next position equals ``position + len(data)`` is OUR
        OWN retried request that already landed (the transport retry can
        re-send after a dropped response) and reads as success; any other
        conflict (a concurrent appender, or a Normal object under the key)
        raises."""
        st, headers, body = self._request(
            "POST", key, body=data, query=f"append&position={position}")
        next_pos = headers.get("x-oss-next-append-position")
        if st == 200:
            return int(next_pos) if next_pos else position + len(data)
        if (st == 409 and next_pos is not None
                and int(next_pos) == position + len(data)):
            return int(next_pos)       # own retried append already applied
        raise IOError(f"APPEND oss://{self.bucket}/{key} @{position}: "
                      f"{st} {body[:200]}")

    def delete(self, key: str):
        st, _, _ = self._request("DELETE", key)
        if st not in (200, 204, 404):
            raise IOError(f"DELETE oss://{self.bucket}/{key}: {st}")

    def copy(self, src_key: str, dst_key: str,
             src_bucket: Optional[str] = None):
        src = f"/{src_bucket or self.bucket}/{src_key}"
        st, _, body = self._request(
            "PUT", dst_key, headers={"x-oss-copy-source": src})
        if st == 404:
            raise FileNotFoundError(f"oss:/{src}")
        if st != 200:
            raise IOError(f"COPY {src_key} -> {dst_key}: {st} {body[:200]}")

    def list(self, prefix: str) -> List[str]:
        """Full prefix listing — follows GetBucket pagination
        (IsTruncated/NextMarker; OSS serves at most 1000 keys per page, so
        a single-page read would silently drop keys of any non-trivial
        checkpoint directory)."""
        import re
        out: List[str] = []
        marker = ""
        while True:
            query = "prefix=" + quote(prefix, safe="") + "&max-keys=1000"
            if marker:
                query += "&marker=" + quote(marker, safe="")
            st, _, data = self._request("GET", "", query=query)
            if st != 200:
                raise IOError(
                    f"LIST oss://{self.bucket}?prefix={prefix}: {st}")
            text = data.decode()
            if text.lstrip().startswith("<"):
                # real OSS GetBucket responses are XML ListBucketResult
                keys = re.findall(r"<Key>([^<]*)</Key>", text)
                out.extend(keys)
                if "<IsTruncated>true</IsTruncated>" not in text:
                    return out
                nm = re.search(r"<NextMarker>([^<]*)</NextMarker>", text)
                marker = nm.group(1) if nm else (keys[-1] if keys else "")
                if not marker:
                    return out
            else:
                out.extend(k for k in text.splitlines() if k)
                return out       # plaintext emulators return everything

    # -- multipart upload (InitiateMultipartUpload / UploadPart /
    #    CompleteMultipartUpload — the protocol the reference's
    #    OSSWritableFile gets from the SDK, oss_file_system.cc) ------------
    def initiate_multipart(self, key: str) -> str:
        st, _, data = self._request("POST", key, query="uploads")
        if st != 200:
            raise IOError(f"InitiateMultipartUpload {key}: {st}")
        import re
        m = re.search(r"<UploadId>([^<]+)</UploadId>", data.decode())
        if not m:
            raise IOError(f"InitiateMultipartUpload {key}: no UploadId")
        return m.group(1)

    def upload_part(self, key: str, upload_id: str, part_number: int,
                    data: bytes) -> str:
        """Returns the part's ETag (echoed back in the complete call)."""
        st, headers, body = self._request(
            "PUT", key, body=data,
            query=f"partNumber={part_number}&uploadId={upload_id}")
        if st != 200:
            raise IOError(f"UploadPart {key}#{part_number}: {st} "
                          f"{body[:200]}")
        return headers.get("ETag", "").strip('"')

    def complete_multipart(self, key: str, upload_id: str,
                           parts: List[Tuple[int, str]],
                           expected_size: Optional[int] = None):
        """``expected_size``: total bytes uploaded — disambiguates a 404
        after a retried complete (hidden success vs genuine NoSuchUpload
        over a STALE same-named object from an earlier save)."""
        body = "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>\"{etag}\"</ETag>"
            "</Part>" for n, etag in parts)
        xml = f"<CompleteMultipartUpload>{body}</CompleteMultipartUpload>"
        st, _, resp = self._request("POST", key, body=xml.encode(),
                                    query=f"uploadId={upload_id}")
        if st == 404 and expected_size is not None \
                and self.head(key) == expected_size:
            # a retried complete whose FIRST attempt succeeded just before
            # the response was lost: the upload is gone but the object is
            # published at exactly the uploaded size — that IS success.
            # (A bare HEAD-exists check would be fooled by a stale object
            # from a previous save to the same key.)
            return
        if st != 200:
            raise IOError(f"CompleteMultipartUpload {key}: {st} "
                          f"{resp[:200]}")

    def abort_multipart(self, key: str, upload_id: str):
        self._request("DELETE", key, query=f"uploadId={upload_id}")

    def put_stream(self, key: str, fileobj, size: int):
        """Upload from a seekable file object: one PUT when small, the
        multipart protocol above ``_MULTIPART_THRESHOLD`` (real OSS caps
        single PUTs; a multi-GB bundle shard MUST go up in parts). A
        service whose PUT cap sits BELOW the client threshold answers 413
        EntityTooLarge — fall back to multipart rather than failing."""
        if size <= _MULTIPART_THRESHOLD:
            start = fileobj.tell()
            try:
                self.put(key, fileobj.read())
                return
            except IOError as e:
                if "413" not in str(e):
                    raise
                fileobj.seek(start)      # service cap < threshold: go parts
        upload_id = self.initiate_multipart(key)
        try:
            parts: List[Tuple[int, str]] = []
            n, total = 1, 0
            while True:
                chunk = fileobj.read(_PART_SIZE)
                if not chunk:
                    break
                parts.append((n, self.upload_part(key, upload_id, n, chunk)))
                total += len(chunk)
                n += 1
            self.complete_multipart(key, upload_id, parts,
                                    expected_size=total)
        except BaseException:
            self.abort_multipart(key, upload_id)   # don't leak server state
            raise


class _OSSReadFile(io.RawIOBase):
    """Random-access reader over ranged GETs with readahead buffering."""

    def __init__(self, client: ObjectStoreClient, key: str, size: int):
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
            fetch = max(remaining, _READAHEAD)
            end = min(self._pos + fetch, self._size)
            self._buf = self._c.get(self._key, self._pos, end)
            self._buf_start = self._pos
            if not self._buf:
                # the object shrank under us (size was cached at open):
                # raise instead of refetching the same empty range forever
                raise IOError(
                    f"oss://{self._c.bucket}/{self._key}: empty ranged read "
                    f"at {self._pos} (object changed during read?)")
        return b"".join(out)

    def readinto(self, b):
        # io.BufferedReader drives the raw file through readinto
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)


class _OSSWriteFile(io.RawIOBase):
    """Spooled writer: bytes buffer in a temp file, one PUT (or a
    multipart upload beyond ``_MULTIPART_THRESHOLD``) on close."""

    def __init__(self, client: ObjectStoreClient, key: str,
                 initial: bytes = b""):
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
        size = self._spool.seek(0, io.SEEK_END)
        self._spool.seek(0)
        self._c.put_stream(self._key, self._spool, size)
        self._spool.close()
        self._closed = True
        super().close()


class _OSSAppendFile(io.RawIOBase):
    """True append writer over AppendObject: buffered 1 MB flushes, each an
    ``append`` at the tracked position — no read-modify-write, O(append)
    wire bytes regardless of object size (the reference's AppendableFile
    semantics, oss_file_system.h:126)."""

    _FLUSH = 1 << 20

    def __init__(self, client: ObjectStoreClient, key: str, position: int):
        self._c = client
        self._key = key
        self._pos = position
        self._buf = bytearray()
        self._closed = False

    def writable(self):
        return True

    def write(self, b):
        self._buf += bytes(b)
        while len(self._buf) >= self._FLUSH:
            chunk = bytes(self._buf[:self._FLUSH])
            del self._buf[:self._FLUSH]
            self._pos = self._c.append(self._key, chunk, self._pos)
        return len(b)

    def tell(self):
        return self._pos + len(self._buf)

    def flush(self):
        if self._buf:
            self._pos = self._c.append(self._key, bytes(self._buf),
                                       self._pos)
            self._buf.clear()

    def close(self):
        if self._closed:
            return
        self.flush()
        self._closed = True
        super().close()


class OSSFileSystem(FileSystem):
    """``oss://bucket/key`` filesystem over :class:`ObjectStoreClient`.

    Paths arriving from the registry are ``bucket/key`` (scheme stripped);
    the bucket may carry the reference's ``\\x01``-embedded credentials.
    Directories are emulated over key prefixes (zero-byte ``dir/`` markers
    on makedirs, like the reference's CreateDir)."""

    def __init__(self, default_client: Optional[ObjectStoreClient] = None):
        self._clients: Dict[str, ObjectStoreClient] = {}
        if default_client is not None:
            self._clients[default_client.bucket] = default_client

    def _resolve(self, path: str) -> Tuple[ObjectStoreClient, str]:
        bucket, key, creds = parse_oss_uri("oss://" + path)
        client = self._clients.get(bucket)
        if client is None:
            client = ObjectStoreClient(bucket, creds["id"], creds["key"],
                                       creds["host"])
            self._clients[bucket] = client
        return client, key

    def open(self, path, mode="rb"):
        c, key = self._resolve(path)
        if "r" in mode:
            size = c.head(key)
            if size is None:
                raise FileNotFoundError(f"oss://{path}")
            f = _OSSReadFile(c, key, size)
            return io.BufferedReader(f) if "b" in mode else f
        if "a" in mode:
            size, kind = c.stat(key)
            if size is None or kind == "Appendable":
                # native AppendObject: no read-modify-write
                return _OSSAppendFile(c, key, size or 0)
            # the key holds a Normal/Multipart object, which OSS cannot
            # append to — fall back to read + rewrite (documented cost)
            return _OSSWriteFile(c, key, c.get(key))
        return _OSSWriteFile(c, key)

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
        # OSS has no rename: server-side copy + delete (the reference's
        # RenameFile does the same). The bundle's atomic-publish guarantee
        # degrades to copy-then-delete on object stores. The DESTINATION
        # bucket's client issues the copy (cross-bucket renames must land
        # in the destination, under its credentials).
        sc, skey = self._resolve(src)
        dc, dkey = self._resolve(dst)
        dc.copy(skey, dkey, src_bucket=sc.bucket)
        sc.delete(skey)

    def size(self, path):
        c, key = self._resolve(path)
        n = c.head(key)
        if n is None:
            raise FileNotFoundError(f"oss://{path}")
        return n


def register_oss(default_client: Optional[ObjectStoreClient] = None
                 ) -> OSSFileSystem:
    """Install the ``oss://`` scheme (reference: REGISTER_FILE_SYSTEM("oss"),
    ops/ossfs_ops.cc:9). Credentials resolve per-bucket from the URI or
    env at first touch."""
    fs = OSSFileSystem(default_client)
    register_filesystem("oss", fs)
    return fs
