"""Port parity for the remote-storage clients (``oss://``, ``s3://``,
``dfs://``) and their in-process emulators.

The port's ``io`` modules are stdlib copies of the JAX package's, so the
checks are that they speak the same protocol: the signing functions give
the originals' bytes on fixed inputs; each package's client works against
the other package's emulator; the client and emulator cases of the JAX
package's ``test_io``/``test_oss``/``test_s3``/``test_dfs`` hold for the
port's copies (merged into tests parametrised by backend where they
repeat); and checkpoints, serving exports and delta refreshes written by
either package through each scheme restore in the other bit for bit. Each
package has its own scheme registry, so a test that crosses packages
registers the clients with both."""
import contextlib
import io as _io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfplus_tpu import checkpoint as jckpt
from tfplus_tpu import io as jio
from tfplus_tpu import kv as jkv
from tfplus_tpu import serving as jserving
from tfplus_tpu.checkpoint import saver as jsaver
from tfplus_tpu.io import dfs_emulator as jdfs_emu
from tfplus_tpu.io import object_store as jos
from tfplus_tpu.io import oss_emulator as joss_emu
from tfplus_tpu.io import s3 as js3
from tfplus_tpu.io import s3_emulator as js3_emu
from tfplus_tpu_torch import checkpoint as tckpt
from tfplus_tpu_torch import io as tio
from tfplus_tpu_torch import kv as tkv
from tfplus_tpu_torch import serving as tserving
from tfplus_tpu_torch.checkpoint import saver as tsaver
from tfplus_tpu_torch.io import dfs as tdfs
from tfplus_tpu_torch.io import dfs_emulator as tdfs_emu
from tfplus_tpu_torch.io import object_store as tos
from tfplus_tpu_torch.io import oss_emulator as toss_emu
from tfplus_tpu_torch.io import s3 as ts3
from tfplus_tpu_torch.io import s3_emulator as ts3_emu
from test_torch_checkpoint import _mutate
from test_torch_growth import _filled
from test_torch_serving import (_assert_same_tables, _load_both, _metadata,
                                _trained_pair, DIM)
from test_torch_table import assert_same_table, to_port

CREDS = {"test-id": "sekrit-key"}
USERS = {"alice"}
BACKENDS = ("oss", "s3", "dfs")
PKGS = {"jax": {"io": jio, "oss_emu": joss_emu, "s3_emu": js3_emu,
                "dfs_emu": jdfs_emu},
        "port": {"io": tio, "oss_emu": toss_emu, "s3_emu": ts3_emu,
                 "dfs_emu": tdfs_emu}}


def emulator(pkg, backend, **kw):
    """The emulator of ``pkg`` ("jax" or "port") for ``backend``."""
    mods = PKGS[pkg]
    if backend == "oss":
        return mods["oss_emu"].OSSEmulator(CREDS, **kw)
    if backend == "s3":
        return mods["s3_emu"].S3Emulator(CREDS, **kw)
    return mods["dfs_emu"].DfsEmulator(users=USERS, **kw)


def register(pkg, backend):
    io = PKGS[pkg]["io"]
    {"oss": io.register_oss, "s3": io.register_s3,
     "dfs": io.register_dfs}[backend]()


def uri(backend, host, path, key=None):
    """A credential-embedded URI (the reference's grammar for oss:// and
    s3://; ``user@cluster`` for dfs://)."""
    if backend == "dfs":
        return f"dfs://alice@{host}/{path}"
    return (f"{backend}://bkt\x01id=test-id\x02key="
            f"{CREDS['test-id'] if key is None else key}\x02host={host}/{path}")


@contextlib.contextmanager
def served(backend, emulator_pkg="port", **kw):
    """An emulator of ``emulator_pkg`` with both packages' clients
    registered; yields ``(emulator, host)``."""
    srv = emulator(emulator_pkg, backend, **kw)
    with srv as host:
        register("jax", backend)
        register("port", backend)
        yield srv, host


def _tenc(ids):
    return tkv.encode_ids_np_to_device(np.asarray(ids, np.int64), "cpu")


def _jenc(ids):
    return jkv.encode_ids_np_to_device(np.asarray(ids, np.int64))


# ---------------------------------------------------------------------------
# the copies: names, signatures, URI parsing
# ---------------------------------------------------------------------------

def test_io_exports_the_jax_package_names():
    want = {n for n in dir(jio) if not n.startswith("_")}
    got = {n for n in dir(tio) if not n.startswith("_")}
    assert want <= got, sorted(want - got)
    for name in ("_MULTIPART_THRESHOLD", "_PART_SIZE", "_SPOOL_MAX",
                 "_READAHEAD", "_SIGNED_SUBRESOURCES"):
        assert getattr(tos, name) == getattr(jos, name), name
    assert (ts3._MULTIPART_THRESHOLD, ts3._PART_SIZE) == (
        js3._MULTIPART_THRESHOLD, js3._PART_SIZE)


QUERIES = ["", "prefix=a%2Fb&max-keys=1000", "uploads",
           "partNumber=3&uploadId=abc", "uploadId=x&partNumber=12",
           "append&position=4096", "position=0&append&marker=k"]


@pytest.mark.parametrize("query", QUERIES)
def test_oss_signature_equals_the_original(query):
    res = "/bkt/dir/obj" + jos._canonical_subresources(query)
    assert tos._canonical_subresources(query) == \
        jos._canonical_subresources(query)
    date = "Sat, 17 Oct 2026 10:00:00 GMT"
    for verb, headers in (("PUT", None), ("GET", {"Range": "bytes=0-9"}),
                          ("PUT", {"x-oss-copy-source": "/bkt/src",
                                   "X-OSS-Meta-b": "2"})):
        assert tos._sign("sekrit", verb, date, res, oss_headers=headers) == \
            jos._sign("sekrit", verb, date, res, oss_headers=headers)


@pytest.mark.parametrize("date,region,service", [
    ("20150830", "us-east-1", "iam"), ("20261017", "eu-west-2", "s3")])
def test_sigv4_equals_the_original(date, region, service):
    secret = "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
    k = ts3.derive_signing_key(secret, date, region, service)
    assert k == js3.derive_signing_key(secret, date, region, service)
    if service == "iam":       # AWS's published example
        assert k.hex() == ("c4afb1cc5771d871763a393e44b703571b"
                           "55cc28424d1a5e86da6ed3c154a4b9")
    kw = dict(verb="PUT", path="/bkt/a b/c~d.bin",
              query={"partNumber": "2", "uploadId": "u/1+x"},
              headers={"Host": "127.0.0.1:9", "x-amz-date": date + "T000102Z",
                       "x-amz-content-sha256": "UNSIGNED-PAYLOAD",
                       "Content-Type": "  a   b "},
              payload_sha256="UNSIGNED-PAYLOAD", access_id="AKID",
              secret=secret, region=region, amz_date=date + "T000102Z")
    assert ts3.sign_v4(**kw) == js3.sign_v4(**kw)


def test_uri_and_path_parsers_equal_the_originals(monkeypatch):
    for u in ["oss://bkt\x01id=a\x02key=b\x02host=h:1/x/y",
              "oss://bkt?id=a&key=b&host=h/x", "oss://plain/k"]:
        assert tio.parse_oss_uri(u) == jio.parse_oss_uri(u)
    monkeypatch.setenv("AWS_REGION", "ap-south-1")
    for u in ["s3://bkt\x01id=a\x02key=b\x02host=h:1/x/y", "s3://b/k"]:
        assert tio.parse_s3_uri(u) == jio.parse_s3_uri(u)
    assert tio.parse_s3_uri("s3://b/k")[2]["region"] == "ap-south-1"
    from tfplus_tpu.io import dfs as jdfs
    for p in ["alice@nn1:9870/a/b/c", "nn1/a"]:
        assert tdfs.parse_dfs_path(p) == jdfs.parse_dfs_path(p)
    for bad in ["cluster-only", "/no/cluster"]:
        with pytest.raises(ValueError):
            tdfs.parse_dfs_path(bad)
    monkeypatch.setenv("DFS_USER", "bob")
    assert tdfs.parse_dfs_path("nn1/a")[1] == "bob"


# ---------------------------------------------------------------------------
# the filesystem surface, each package's client against each emulator
# ---------------------------------------------------------------------------

DIRECTIONS = [("port", "port"), ("port", "jax"), ("jax", "port")]


@pytest.mark.parametrize("client_pkg,emulator_pkg", DIRECTIONS,
                         ids=["port-client-port-emu", "port-client-jax-emu",
                              "jax-client-port-emu"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_filesystem_surface(backend, client_pkg, emulator_pkg):
    """Write in chunks, ranged reads with seeks, append, listdir, rename,
    exists, size and remove through ``get_filesystem``."""
    with served(backend, emulator_pkg) as (_, host):
        fs, p = PKGS[client_pkg]["io"].get_filesystem(uri(backend, host,
                                                          "d/f.bin"))
        data = bytes(range(256)) * 40
        with fs.open(p, "wb") as f:
            for i in range(0, len(data), 3001):
                f.write(data[i:i + 3001])
        assert fs.exists(p) and fs.size(p) == len(data)
        with fs.open(p, "rb") as f:
            f.seek(100)
            assert f.read(50) == data[100:150]
            f.seek(-7, 2)
            assert f.read() == data[-7:]
        with fs.open(p, "ab") as f:
            f.write(b"tail")
        with fs.open(p, "rb") as f:
            assert f.read() == data + b"tail"
        base = p.rsplit("/", 1)[0]
        with fs.open(base + "/g", "wb") as f:
            f.write(b"G")
        fs.makedirs(base + "/sub")
        assert fs.listdir(base) == ["f.bin", "g", "sub"]
        fs.rename(base + "/g", base + "/h")
        assert fs.listdir(base) == ["f.bin", "h", "sub"]
        assert not fs.exists(base + "/g")
        fs.remove(base + "/h")
        assert fs.listdir(base) == ["f.bin", "sub"]
        with pytest.raises(FileNotFoundError):
            fs.open(base + "/missing", "rb")


@pytest.mark.parametrize("backend", BACKENDS)
def test_unknown_credentials_are_rejected(backend):
    """A wrong secret (or an unknown WebHDFS user) is refused with 403 and
    the connection stays usable for a good client."""
    with served(backend) as (_, host):
        if backend == "oss":
            bad = tos.ObjectStoreClient("bkt", "test-id", "WRONG", host)
            who = tos.ObjectStoreClient("bkt", "who", CREDS["test-id"], host)
            good = tos.ObjectStoreClient("bkt", "test-id", CREDS["test-id"],
                                         host)
            calls = [lambda c: c.put("x", b"data")]
        elif backend == "s3":
            bad = ts3.S3Client("bkt", "test-id", "WRONG", host)
            who = ts3.S3Client("bkt", "who", CREDS["test-id"], host)
            good = ts3.S3Client("bkt", "test-id", CREDS["test-id"], host)
            calls = [lambda c: c.put("x", b"data")]
        else:
            bad = who = tdfs.DfsClient(host, "mallory")
            good = tdfs.DfsClient(host, "alice")
            calls = [lambda c: c.create("/x", b"data")]
        for c in (bad, who):
            for call in calls:
                with pytest.raises(IOError, match="403"):
                    call(c)
        calls[0](good)


@pytest.mark.parametrize("backend", ["oss", "s3"])
def test_object_client_verbs(backend):
    with served(backend) as (_, host):
        c = (tos.ObjectStoreClient if backend == "oss" else ts3.S3Client)(
            "bkt", "test-id", CREDS["test-id"], host)
        c.put("a/b.bin", b"0123456789")
        assert c.head("a/b.bin") == 10
        assert c.get("a/b.bin") == b"0123456789"
        assert c.get("a/b.bin", 2, 6) == b"2345"
        assert c.list("a/") == ["a/b.bin"]
        c.copy("a/b.bin", "a/c.bin")
        assert c.get("a/c.bin") == b"0123456789"
        c.delete("a/b.bin")
        assert c.head("a/b.bin") is None
        with pytest.raises(FileNotFoundError):
            c.get("a/b.bin")


@pytest.mark.parametrize("backend", ["oss", "s3"])
def test_paged_listing_returns_every_key(backend):
    """Seven keys per page (real services serve 1000): the client follows
    the continuation markers, and listdir sees every key."""
    with served(backend, page_size=7) as (_, host):
        c = (tos.ObjectStoreClient if backend == "oss" else ts3.S3Client)(
            "bkt", "test-id", CREDS["test-id"], host)
        names = [f"d/obj{i:03d}" for i in range(25)]
        for nm in names:
            c.put(nm, b"x")
        c.put("e/other", b"y")
        assert c.list("d/") == names
        fs, p = tio.get_filesystem(uri(backend, host, "d"))
        assert len(fs.listdir(p)) == 25


@pytest.mark.parametrize("backend", ["oss", "s3"])
def test_multipart_over_the_put_cap(backend, monkeypatch):
    """A 1 MB object through the fs write path past a 200 KB PUT cap goes
    up in 77 KB parts (the last one short) and reads back byte for byte; a
    plain PUT past the cap is 413."""
    mod = tos if backend == "oss" else ts3
    monkeypatch.setattr(mod, "_MULTIPART_THRESHOLD", 200_000)
    monkeypatch.setattr(mod, "_PART_SIZE", 77_000)
    with served(backend, max_put_size=200_000) as (srv, host):
        c = (tos.ObjectStoreClient if backend == "oss" else ts3.S3Client)(
            "bkt", "test-id", CREDS["test-id"], host)
        with pytest.raises(IOError if backend == "oss" else ts3._TooLarge):
            c.put("big", b"\x00" * 200_001)
        data = np.random.default_rng(0).integers(
            0, 256, 1_000_000, dtype=np.uint8).tobytes()
        fs, p = tio.get_filesystem(uri(backend, host, "blob.bin"))
        with fs.open(p, "wb") as f:
            for i in range(0, len(data), 123_457):
                f.write(data[i:i + 123_457])
        assert c.head("blob.bin") == len(data)
        with fs.open(p, "rb") as f:
            assert f.read() == data
        c.put_stream("s", _io.BytesIO(data[:300_000]), 300_000)
        assert c.get("s") == data[:300_000]


@pytest.mark.parametrize("backend", BACKENDS)
def test_retries_past_transient_faults(backend):
    """Injected 503s (and, where the emulator can, dropped connections)
    are retried; a fault that persists surfaces as the last status."""
    with served(backend) as (srv, host):
        if backend == "dfs":
            c = tdfs.DfsClient(host, "alice")
            c.mkdirs("/d")
            srv.fail_next(2)
            c.create("/d/k", b"v")
            srv.fail_next(3)
            assert c.open("/d/k") == b"v"
            srv.fail_next(2, mode="drop")
            assert c.status("/d/k")["length"] == 1
            return
        c = (tos.ObjectStoreClient if backend == "oss" else ts3.S3Client)(
            "bkt", "test-id", CREDS["test-id"], host)
        srv.fail_next(2)
        c.put("k", b"v")
        srv.fail_next(3 if backend == "oss" else 2)
        assert c.get("k") == b"v"
        if backend == "oss":
            srv.fail_next(2, mode="drop")
            assert c.get("k") == b"v"
        srv.fail_next(50)
        with pytest.raises(IOError, match="503"):
            c.put("k2", b"v")


def test_oss_multipart_abort_and_hidden_success():
    with served("oss", max_put_size=10_000) as (_, host):
        c = tos.ObjectStoreClient("bkt", "test-id", CREDS["test-id"], host)
        uid = c.initiate_multipart("obj")
        etag = c.upload_part("obj", uid, 1, b"\x01" * 50_000)   # no 413
        c.complete_multipart("obj", uid, [(1, etag)], expected_size=50_000)
        # a replayed complete after a lost response: 404, size matches
        c.complete_multipart("obj", uid, [(1, etag)], expected_size=50_000)
        assert c.head("obj") == 50_000
        uid = c.initiate_multipart("obj")
        etag = c.upload_part("obj", uid, 1, b"other")
        c.abort_multipart("obj", uid)
        with pytest.raises(IOError, match="404"):
            c.complete_multipart("obj", uid, [(1, etag)], expected_size=5)
        assert c.head("obj") == 50_000


def test_oss_append_object():
    """AppendObject positions, a wrong position's 409, an own retried
    append read as success, the fs append mode's native appends and the
    read-and-rewrite fallback over a Normal object."""
    with served("oss") as (srv, host):
        c = tos.ObjectStoreClient("bkt", "test-id", CREDS["test-id"], host)
        p = c.append("a.log", b"one", 0)
        p = c.append("a.log", b"two", p)
        assert (p, c.get("a.log")) == (6, b"onetwo")
        assert c.stat("a.log") == (6, "Appendable")
        with pytest.raises(IOError, match="409"):
            c.append("a.log", b"x", 2)
        assert c.append("a.log", b"two", 3) == 6      # own retry landed
        c.put("n.bin", b"normal")
        with pytest.raises(IOError, match="409"):
            c.append("n.bin", b"x", 6)
        fs, path = tio.get_filesystem(uri("oss", host, "a.log"))
        with fs.open(path, "ab") as f:
            f.write(b"three")
        assert c.get("a.log") == b"onetwothree"
        fs, path = tio.get_filesystem(uri("oss", host, "n.bin"))
        with fs.open(path, "ab") as f:
            f.write(b"+more")
        assert c.get("n.bin") == b"normal+more"
        srv.fail_next(1)
        assert c.append("a.log", b"!", 11) == 12


def test_dfs_client_semantics():
    """Overwrite refusal, append to a missing file, recursive delete,
    subtree rename, hidden-success replays, and an append that is never
    retried (a 503 on its datanode leg surfaces and appends nothing)."""
    with served("dfs") as (srv, host):
        c = tdfs.DfsClient(host, "alice")
        c.create("/d/f.bin", b"0123456789")
        assert c.open("/d/f.bin", offset=2, length=4) == b"2345"
        c.append("/d/f.bin", b"AB")
        assert c.status("/d/f.bin")["length"] == 12
        with pytest.raises(tdfs.DfsError):
            c.create("/d/f.bin", b"2", overwrite=False)
        with pytest.raises(FileNotFoundError):
            c.append("/nope", b"z")
        c.create("/r/src/f1", b"1")
        c.create("/r/src/sub/f2", b"2")
        c.rename("/r/src", "/r/dst")
        assert c.open("/r/dst/sub/f2") == b"2"
        c.rename("/r/src", "/r/dst")                   # replay: no raise
        with pytest.raises((tdfs.DfsError, FileNotFoundError)):
            c.rename("/r/nope", "/r/also-nope")
        with pytest.raises(tdfs.DfsError):
            c.delete("/r/dst", recursive=False)
        assert c.delete("/r/dst", recursive=True)
        assert c.delete("/r/dst") is True              # replay
        srv.fail_next(1, only_step2=True)
        with pytest.raises(tdfs.DfsError, match="503|injected"):
            c.append("/d/f.bin", b"-more")
        assert c.open("/d/f.bin") == b"0123456789AB"
        fs, p = tio.get_filesystem(uri("dfs", host, "e/empty"))
        with fs.open(p, "wb"):
            pass
        assert fs.exists(p) and fs.size(p) == 0


def test_dfs_registers_as_pangu():
    with served("dfs") as (_, host):
        tio.register_dfs(scheme="pangu")
        fs, p = tio.get_filesystem(f"pangu://alice@{host}/x/y")
        with fs.open(p, "wb") as f:
            f.write(b"pangu")
        with fs.open(p, "rb") as f:
            assert f.read() == b"pangu"


# ---------------------------------------------------------------------------
# checkpoints, exports and refreshes across packages through each scheme
# ---------------------------------------------------------------------------

ROWS = 1 << 10


@pytest.fixture(scope="module")
def filled():
    """A JAX table of 2^10 rows with slot columns (made once: JAX compiles
    per shape) and its ids."""
    jt, _, ids = _filled(np.random.RandomState(17), ROWS, capacity=2 * ROWS,
                         slots=True)
    return jt, ids


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_crosses_packages(backend, writer, filled):
    """A 2^10-row table with slot columns: a full checkpoint, inserts and
    deletes, a delta, written by one package through the remote scheme
    (dfs:// with two injected faults on the save); both packages restore
    the lineage from there to the same tables, equal to the live one per
    key."""
    rng = np.random.RandomState(17)
    jt, ids = filled
    tt = to_port(jt)
    with served(backend) as (srv, host):
        root = uri(backend, host, f"ck/{writer}")
        if backend == "dfs":
            srv.fail_next(2)
        if writer == "jax":
            jt = jsaver.save(root + "/full", {"emb": jt})["emb"]
        else:
            tt = tsaver.save(root + "/full", {"emb": tt})["emb"]
        jt, tt = _mutate(rng, jt, tt, 64, 32, ids)
        if writer == "jax":
            jt = jsaver.save(root + "/delta", {"emb": jt}, delta=True,
                             first_n=jsaver.FIRST_N_DELTA)["emb"]
        else:
            tt = tsaver.save(root + "/delta", {"emb": tt}, delta=True,
                             first_n=tsaver.FIRST_N_DELTA)["emb"]
        jtmpl = jkv.ensure_slots(jkv.create(8, 4 * ROWS, seed=9),
                                 {"m": 1, "v": 2})
        jout = jsaver.restore(root + "/full", {"emb": jtmpl})[0]
        jout = jsaver.restore(root + "/delta", jout, delta=True)[0]
        ttmpl = tkv.ensure_slots(tkv.create(8, 4 * ROWS, seed=9,
                                            device="cpu"), {"m": 1, "v": 2})
        tout = tsaver.restore(root + "/full", {"emb": ttmpl})[0]
        tout = tsaver.restore(root + "/delta", tout, delta=True)[0]
    assert_same_table(jout["emb"], tout["emb"])
    live = ids[32:]
    want = tkv.lookup_or_zeros(tt, _tenc(live))
    assert torch.equal(tkv.lookup_or_zeros(tout["emb"], _tenc(live)), want)
    np.testing.assert_array_equal(
        np.asarray(jkv.lookup_or_zeros(jt, _jenc(live))), want.numpy())
    assert not bool(tkv.find(tout["emb"], _tenc(ids[:32])).found.any())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_serving_export_and_refresh_cross_packages(backend, writer):
    """One package exports a user table and a 2-shard item table to the
    remote scheme and later writes a trainer's delta there; both packages
    load the export and refresh from the delta, to the same tables (int8
    loads differ only after the bytes: ``test_torch_serving`` crosses them
    on a local directory)."""
    rng = np.random.RandomState(29)
    ids, jt, tt = _trained_pair(rng, 40)
    item_ids = rng.randint(1, 1 << 40, 30)
    rows = rng.randn(2, 15, DIM).astype(np.float32)
    jitems = [jkv.insert(jkv.create(DIM, 128, init_pool_rows=20, seed=s),
                         _jenc(item_ids[s::2]), jnp.asarray(rows[s]), day=4)
              for s in range(2)]
    titems = [tkv.insert(tkv.create(DIM, 128, init_pool_rows=20, seed=s,
                                    device="cpu"),
                         _tenc(item_ids[s::2]), torch.from_numpy(rows[s]),
                         day=4) for s in range(2)]
    with served(backend) as (_, host):
        d = uri(backend, host, f"srv-{writer}")
        if writer == "jax":
            jserving.export_for_serving(
                d, {"user_emb": jt, "item_emb": jitems},
                _metadata(jserving, True))
        else:
            tserving.export_for_serving(
                d, {"user_emb": tt, "item_emb": titems},
                _metadata(tserving, True))
        jtabs, ttabs = _load_both(d, False)
        _assert_same_tables(jtabs, ttabs, False)
        jt, tt = jkv.clear_deltalist(jt), tkv.clear_deltalist(tt)
        upd = np.concatenate([ids[10:20], rng.randint(1 << 41, 1 << 42, 70)])
        new = rng.randn(len(upd), DIM).astype(np.float32)
        jt = jkv.insert(jt, _jenc(upd), jnp.asarray(new), day=11)
        tt = tkv.insert(tt, _tenc(upd), torch.from_numpy(new), day=11)
        delta = uri(backend, host, f"t/delta-{writer}")
        if writer == "jax":
            jckpt.save(delta, {"user_emb": jt}, delta=True,
                       first_n=jckpt.FIRST_N_DELTA)
        else:
            tckpt.save(delta, {"user_emb": tt}, delta=True,
                       first_n=tckpt.FIRST_N_DELTA)
        jtabs = jserving.refresh_from_delta(jtabs, delta)
        ttabs = tserving.refresh_from_delta(ttabs, delta)
        _assert_same_tables(jtabs, ttabs, False)
    got = tkv.lookup_or_zeros(ttabs["user_emb"], _tenc(upd))
    np.testing.assert_array_equal(got.numpy(), new)


@pytest.mark.parametrize("backend", BACKENDS)
def test_manager_lineage_on_remote_storage(backend):
    """``CheckpointManager`` keeps its state file, bundles and garbage
    collection on the remote scheme: full, two deltas, a restore by a
    second manager equal per key to the live table."""
    rng = np.random.RandomState(5)
    tt = tkv.insert(tkv.create(8, 512, seed=2, device="cpu"),
                    _tenc(rng.randint(1, 1 << 40, 256)),
                    torch.from_numpy(rng.randn(256, 8).astype(np.float32)),
                    day=9)
    with served(backend) as (_, host):
        d = uri(backend, host, "mgr")
        mgr = tckpt.CheckpointManager(d, max_to_keep=2)
        tt = mgr.save({"emb": tt}, step=1, full=True)["emb"]
        for s in (2, 3):
            more = rng.randint(1 << 41, 1 << 42, 32)
            tt = tkv.insert(tt, _tenc(more),
                            torch.from_numpy(rng.randn(32, 8).astype(
                                np.float32)), day=12)
            tt = mgr.save({"emb": tt}, step=s, full=False)["emb"]
        tmpl = tkv.create(8, 128, seed=1, device="cpu")
        out, _, step = tckpt.CheckpointManager(d).restore({"emb": tmpl})
    assert step == 3
    ex = tkv.export_arrays(tt)
    q = _tenc(ex["keys"])
    assert torch.equal(tkv.lookup_or_zeros(out["emb"], q),
                       tkv.lookup_or_zeros(tt, q))
    assert int(tkv.size(out["emb"])) == int(tkv.size(tt))


@pytest.mark.parametrize("backend", ["oss", "s3"])
def test_multihost_union_on_paged_listings(backend):
    """Two processes' bundles on a flat-key store listed seven keys per
    page: the union restore finds both; a save that lacks a process's
    bundle is refused as incomplete."""
    rng = np.random.RandomState(3)
    shards = [tkv.insert(tkv.create(4, 128, seed=i, device="cpu"),
                         _tenc(np.arange(1, 41) * 2 + i),
                         torch.from_numpy(rng.randn(40, 4).astype(
                             np.float32))) for i in range(2)]
    with served(backend, page_size=7) as (_, host):
        base = uri(backend, host, "mh/ck")
        for p in range(2):
            tsaver.save_multihost(base, {"emb": [shards[p]]}, process_id=p,
                                  num_processes=2)
        tmpl = {"emb": [tkv.create(4, 128, device="cpu") for _ in range(2)]}
        out, _ = tsaver.restore_multihost(base, tmpl)
        jout, _ = jsaver.restore_multihost(
            base, {"emb": [jkv.create(4, 128) for _ in range(2)]})
        for a, b in zip(jout["emb"], out["emb"]):
            assert_same_table(a, b)
        for s, t in zip(shards, out["emb"]):
            ex = tkv.export_arrays(s)
            assert torch.equal(tkv.lookup_or_zeros(t, _tenc(ex["keys"])),
                               tkv.lookup_or_zeros(s, _tenc(ex["keys"])))
        lone = uri(backend, host, "mh/lone")
        tsaver.save_multihost(lone, {"emb": [shards[0]]}, process_id=0,
                              num_processes=3)
        with pytest.raises(IOError, match="incomplete"):
            tsaver.UnionReader(lone)
