"""Serving: ranking metadata, the inference export, a template-free load and
a refresh from a trainer's delta checkpoint.

Counterpart of ``tfplus_tpu/serving.py``. :class:`RankingMetadata` writes
the same ``__rank_service_embedding`` JSON and signature, text for text, so
that a ranking service can address a table's ``<var>-keys`` and
``<var>-values`` tensors without the model. Exports are the JAX package's
bundles, readable by either package.

Only the native bundle format is written: ``format="tfplus"`` (a TensorFlow
TensorBundle for an existing TFPlus service) needs TensorFlow, which the
port does not use, and raises ``ValueError``.

Tables update in place, as everywhere in the port: :func:`refresh_from_delta`
upserts into the tables it is given (an int8 table gets its new header and
payload written into the same object) and returns them; a table that had to
grow comes back as a new one.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from .checkpoint import bundle, saver
from .io.filesystem import get_filesystem
from .kv import quant
from .kv import table as kvt

RANK_SERVICE_COLLECTION = "__rank_service_embedding"


def _join(a: str, b: str) -> str:
    return a.rstrip("/") + "/" + b


class RankingMetadata:
    def __init__(self):
        self._columns: List[dict] = []

    def add_embedding_column(self, *, column_name: str, var_name: str,
                             embedding_dim: int, combiner: str = "mean",
                             num_shards: int = 1,
                             partition_strategy: str = "mod",
                             bucket_size: int = 0):
        """Register one embedding column; its checkpoint tensor names follow
        the saver's (``<var>-keys``, ``<var>-values``, ``/part_i`` for
        shards)."""
        shard_names = ([var_name] if num_shards == 1 else
                       [f"{var_name}/part_{i}" for i in range(num_shards)])
        self._columns.append({
            "column_name": column_name,
            "bucket_size": bucket_size,          # 0 = dynamic (KV) table
            "embedding_dim": embedding_dim,
            "combiner": combiner,
            "partition_strategy": partition_strategy,
            "num_shards": num_shards,
            "embedding_var_keys": [n + "-keys" for n in shard_names],
            "embedding_var_values": [n + "-values" for n in shard_names],
        })

    def to_json(self) -> str:
        return json.dumps({RANK_SERVICE_COLLECTION: self._columns}, indent=1)

    def generate_signature(self) -> Dict[str, dict]:
        """Input signature per column."""
        sig = {}
        for c in self._columns:
            sig[c["column_name"]] = {
                "dtype": "int64",
                "embedding_dim": c["embedding_dim"],
                "combiner": c["combiner"],
            }
        return sig

    def save(self, path: str):
        fs, p = get_filesystem(path)
        with fs.open(p, "wb") as f:
            f.write(self.to_json().encode())

    @staticmethod
    def load(path: str) -> "RankingMetadata":
        fs, p = get_filesystem(path)
        with fs.open(p, "rb") as f:
            data = json.loads(f.read().decode())
        md = RankingMetadata()
        md._columns = data[RANK_SERVICE_COLLECTION]
        return md


def export_for_serving(directory: str, tables, metadata: RankingMetadata, *,
                       enable_cutoff: bool = True,
                       cutoff_value: float = 1e-20,
                       extra: Optional[dict] = None,
                       format: str = "native") -> str:
    """Write an inference export: a ``first_n = 3`` checkpoint (keys, values
    and init pool; no optimizer slots; rows with max|v| < ``cutoff_value``
    dropped) under ``<directory>/serving``, the metadata as
    ``rank_service_embedding.json`` and the signature as
    ``signature.json``. ``tables``: ``{var_name: KvTable or [shards]}``,
    named as the metadata's columns. Returns the checkpoint prefix.

    A full export at ``first_n = 3`` resets the tables' prediction delta
    stream, in place (as the saver does)."""
    if format == "tfplus":
        raise ValueError(
            "format='tfplus' writes a TensorFlow TensorBundle and needs "
            "TensorFlow (the JAX package's checkpoint/tf_export.py), which "
            "tfplus_tpu_torch does not port; use format='native'")
    fs, d = get_filesystem(directory)
    fs.makedirs(d)
    prefix = _join(directory, "serving")
    saver.save(prefix, tables, dense=extra, first_n=saver.FIRST_N_INFERENCE,
               enable_cutoff=enable_cutoff, cutoff_value=cutoff_value)
    metadata.save(_join(directory, "rank_service_embedding.json"))
    sig_fs, sig_p = get_filesystem(_join(directory, "signature.json"))
    with sig_fs.open(sig_p, "wb") as f:
        f.write(json.dumps(metadata.generate_signature(), indent=1).encode())
    return prefix


def load_for_serving(directory: str, *, load_factor: float = 0.6,
                     quantize: bool = False, device="cuda"):
    """Load an :func:`export_for_serving` directory with no templates: each
    table's dim comes from the metadata and its capacity from the bundle's
    row count (the least power of two >= 64 that holds the rows under
    ``load_factor``). Returns ``(tables, metadata)``, tables as
    ``{var_name: KvTable or [shards]}`` on ``device``; with ``quantize``
    each is an int8 :class:`~tfplus_tpu_torch.kv.quant.QuantKvTable`."""
    metadata = RankingMetadata.load(
        _join(directory, "rank_service_embedding.json"))
    reader = bundle.BundleReader(_join(directory, "serving"))
    tables = {}
    for col in metadata._columns:
        dim = col["embedding_dim"]
        names = [col["embedding_var_keys"][i][:-len("-keys")]
                 for i in range(col["num_shards"])]
        shards = []
        for n in names:
            rows = reader.shape(n + "-keys")[0]
            cap = 64
            while cap * load_factor < max(rows, 1):
                cap *= 2
            t = saver.restore_table(reader, n,
                                    kvt.create(dim, cap, device=device))
            shards.append(quant.quantize_table(t) if quantize else t)
        var = names[0].split("/part_")[0]
        tables[var] = shards if len(shards) > 1 else shards[0]
    return tables, metadata


def refresh_from_delta(tables, delta_prefix: str, *, quantize: bool = False):
    """Apply a trainer's DELTA checkpoint to loaded serving tables: the
    delta's deletes, then its rows upserted. ``tables`` is the dict of
    :func:`load_for_serving`; pass ``quantize`` as it was loaded (a flag
    that does not match a table's type raises). An int8 table is rebuilt in
    f32 (``int8 × scale``), upserted and quantized again. Optimizer slot
    tensors in the delta are not loaded. Returns the refreshed dict."""
    reader = bundle.BundleReader(delta_prefix)
    out = {}
    for name, t in tables.items():
        shards = list(t) if isinstance(t, (list, tuple)) else [t]
        n = len(shards)
        new = [refresh_shard(reader, saver.shard_name(name, i, n), s,
                             quantize=quantize, name=name)
               for i, s in enumerate(shards)]
        out[name] = new if isinstance(t, (list, tuple)) else new[0]
    return out


def refresh_shard(reader, base: str, s, *, quantize: bool, name: str):
    """One shard of :func:`refresh_from_delta`: the delta's part ``base``
    upserted into ``s`` (``s`` itself when the delta has no such part)."""
    if isinstance(s, quant.QuantKvTable) != quantize:
        raise ValueError(
            f"refresh_from_delta(quantize={quantize}) but table "
            f"'{name}' is {type(s).__name__} — pass quantize="
            f"{isinstance(s, quant.QuantKvTable)}")
    if base + "-keys" not in reader:
        return s
    if not quantize:
        return saver.restore_table(reader, base, s, delta=True,
                                   load_slots=False)
    full = kvt.KvTable(
        header=s.header, payload=s.payload.float() * s.scale[:, None],
        init_pool=s.payload[:1].float(), config=s.config,
        **kvt._empty_deletion_log(s.device))
    full = saver.restore_table(reader, base, full, delta=True,
                               load_slots=False)
    qt = quant.quantize_table(full)
    s.header, s.payload, s.config = qt.header, qt.payload, qt.config
    return s
