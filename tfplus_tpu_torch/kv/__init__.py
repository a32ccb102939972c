"""KV embedding table engine (PyTorch port of tfplus_tpu.kv)."""
from . import hashing, unique, table
from .hashing import (encode_ids, encode_ids_raw, encode_ids_np_to_device,
                      decode_ids_np, shard_of)
from .table import (KvConfig, KvTable, LookupResult, FindResult, create, find,
                    lookup_or_insert, lookup_or_zeros, lookup_with_init,
                    insert, insert_raw, delete, size, sum_freq, stats,
                    occupied_mask, load_factor, needs_grow, ensure_slots,
                    get_slot, set_slot_rows, grow, grow_to_fit, compact,
                    export_arrays, import_arrays, clear_deltalist,
                    FLAG_BLACKLIST, FLAG_TOUCH_TRAIN, FLAG_TOUCH_PRED)
from .unique import unique_with_counts, UniqueResult
