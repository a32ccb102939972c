"""CheckpointManager — full + delta (incremental) checkpoint lineage.

Counterpart of ``tfplus_tpu/checkpoint/manager.py`` (the reference's
CheckpointStateManager): a ``checkpoint_ext.json`` state file records the
current full checkpoint, the ordered delta checkpoints layered on it and the
history, so that cheap delta snapshots (the rows touched since the last
export) can be taken between full exports and replayed in order on restore.
A lineage either package wrote restores in the other.
"""
from __future__ import annotations

import json
import time
from typing import Dict, Optional

from . import saver as _saver
from ..io.filesystem import get_filesystem

_STATE_FILE = "checkpoint_ext.json"


def _join(directory: str, name: str) -> str:
    return directory.rstrip("/") + "/" + name


class CheckpointManager:
    """Works on any registered filesystem scheme — local paths, ``ram://``,
    ``oss://`` object stores (the reference's checkpoints land on OSS the
    same way: gfile through the registered plugin)."""

    def __init__(self, directory: str, *, max_to_keep: int = 5,
                 first_n: int = _saver.FIRST_N_TRAIN,
                 num_file_shards: int = 1):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.first_n = first_n
        self.num_file_shards = num_file_shards
        self._fs, self._dir = get_filesystem(directory)
        self._fs.makedirs(self._dir)
        self._state = self._load_state()

    # -- state file --------------------------------------------------------
    def _state_path(self) -> str:
        return _join(self._dir, _STATE_FILE)

    def _load_state(self) -> dict:
        if self._fs.exists(self._state_path()):
            with self._fs.open(self._state_path(), "rb") as f:
                return json.loads(f.read().decode())
        return {"current_full": None, "deltas": [], "history": []}

    def _write_state(self):
        tmp = self._state_path() + ".tmp"
        with self._fs.open(tmp, "wb") as f:
            f.write(json.dumps(self._state, indent=1).encode())
        self._fs.rename(tmp, self._state_path())

    # -- save --------------------------------------------------------------
    def save(self, tables, dense=None, *, step: int, full: bool = True,
             background: bool = False):
        """Full export starts a new lineage; delta layers on the current one.

        Returns the tables (a delta save clears their delta bits in
        place).

        ``background=True``: the bundle write runs on a worker thread
        (:func:`saver.save_async`) — exports happen now, so training can
        continue immediately. Lineage state, GC, and the state-file publish
        are DEFERRED until the write finishes (joined at the start of the
        next ``save``/``restore``/``wait``), so a crash mid-write never
        records an unreadable checkpoint.
        """
        self.wait()
        if not full and getattr(self, "_force_full", False):
            # a previous background save FAILED after its export already
            # cleared the live tables' touch bits — those rows are in no
            # bundle on disk, so only a full export can recapture them
            full = True
        if not full and self._deletion_log_overflowed(tables):
            # the delta's delete list would be truncated (need_full_import):
            # restore refuses to layer such a delta, so never record one —
            # escalate this snapshot to a full export (resets the log)
            full = True
        kind = "full" if full else "delta"
        prefix = _join(self.directory, f"ckpt-{kind}-{step}")
        if not full and self._state["current_full"] is None:
            raise ValueError("cannot take a delta checkpoint before any full one")
        kw = dict(first_n=self.first_n if full else _saver.FIRST_N_DELTA,
                  delta=not full, num_file_shards=self.num_file_shards)
        if background:
            new_tables, handle = _saver.save_async(prefix, tables, dense, **kw)
            self._pending = (handle, step, full, prefix)
            return new_tables
        new_tables = _saver.save(prefix, tables, dense, **kw)
        self._commit(step, full, prefix)
        if full:
            self._force_full = False
        return new_tables

    @staticmethod
    def _deletion_log_overflowed(tables) -> bool:
        for t in tables.values():
            for s in _saver._shards(t):
                ov = getattr(s, "deleted_overflow", None)
                if ov is not None and bool(ov):
                    return True
        return False

    def _commit(self, step: int, full: bool, prefix: str):
        entry = {"prefix": prefix, "step": step, "time": time.time()}
        if full:
            if self._state["current_full"] is not None:
                self._state["history"].append(
                    {"full": self._state["current_full"],
                     "deltas": self._state["deltas"]})
                self._gc()
            self._state["current_full"] = entry
            self._state["deltas"] = []
        else:
            self._state["deltas"].append(entry)
        self._write_state()

    def wait(self):
        """Join a pending background save (no-op otherwise); commits its
        lineage state on success, re-raises its error on failure."""
        pending = getattr(self, "_pending", None)
        if pending is None:
            return
        handle, step, full, prefix = pending
        self._pending = None
        try:
            handle.result()
        except BaseException:
            # the export ALREADY cleared the live tables' touch bits (they
            # were cleared synchronously when the save was issued), so the
            # touched-row window exists nowhere on disk: escalate the next
            # save to full, and drop the failed write's partial files
            self._force_full = True
            self._remove_prefix(prefix)
            raise
        self._commit(step, full, prefix)
        if full:
            self._force_full = False

    def _gc(self):
        while len(self._state["history"]) >= self.max_to_keep:
            old = self._state["history"].pop(0)
            for entry in [old["full"]] + old["deltas"]:
                self._remove_prefix(entry["prefix"])

    def _remove_prefix(self, prefix: str):
        fs, p = get_filesystem(prefix)
        d, base = p.rsplit("/", 1) if "/" in p else ("", p)
        for fn in fs.listdir(d):
            if fn.startswith(base + "."):
                try:
                    fs.remove(_join(d, fn) if d else fn)
                except OSError:
                    pass

    # -- restore -----------------------------------------------------------
    def latest(self) -> Optional[Dict]:
        if self._state["current_full"] is None:
            return None
        return {"full": self._state["current_full"],
                "deltas": list(self._state["deltas"])}

    def restore(self, tables, dense=None):
        """Restore full checkpoint then replay deltas in order
        (checkpoint_manager.py restore chain). Returns (tables, dense, step)."""
        self.wait()
        lineage = self.latest()
        if lineage is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        tables, dense = _saver.restore(lineage["full"]["prefix"], tables, dense)
        step = lineage["full"]["step"]
        for d in lineage["deltas"]:
            # replay the delta's DENSE state too — every save writes dense
            # into its bundle, so the last delta carries the freshest DNN
            # weights; restoring them only from the full checkpoint would
            # resume with dense stale by the whole delta window
            tables, dense = _saver.restore(d["prefix"], tables, dense,
                                           delta=True)
            step = d["step"]
        return tables, dense, step
