"""Port parity for ``utils/profiling``: ``StepMeter`` gives the JAX
package's snapshots on the same clock, and ``trace`` writes a
torch.profiler trace (the TensorBoard profiler's ``*.pt.trace.json``) that
holds the ``annotate`` ranges and the work inside them."""
import glob
import json
import time

import numpy as np
import pytest
import torch

from tfplus_tpu.utils import profiling as jprof
from tfplus_tpu_torch import kv as tkv
from tfplus_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("window,steps", [(200, 1), (200, 12), (4, 11)])
def test_step_meter_matches_jax(monkeypatch, window, steps):
    """One patched ``perf_counter`` sequence (uneven step times) feeds
    both meters; every snapshot along the way is equal."""
    rng = np.random.RandomState(window + steps)
    clock = np.cumsum(rng.uniform(1e-3, 5e-2, 2 * steps + 2)).tolist()
    ticks = iter(clock[:steps] + clock[:steps])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    metas = {"jax": jprof.StepMeter(window), "port": tprof.StepMeter(window)}
    snaps = {k: [] for k in metas}
    sizes = rng.randint(1, 4096, steps)
    for name, meter in metas.items():
        assert meter.snapshot() == {"steps": 0}
        for b in sizes:
            meter.step(int(b))
            snaps[name].append(meter.snapshot())
    assert snaps["jax"] == snaps["port"]
    assert metas["port"].total_examples == int(sizes.sum())
    if steps > 1:
        assert set(snaps["port"][-1]) == {"steps", "examples_per_s",
                                          "step_ms_p50", "step_ms_p99"}


def test_trace_holds_the_annotations(tmp_path):
    """A CPU trace of a table insert and lookup inside two annotated
    ranges: the TensorBoard trace file holds both names, and the ranges
    enclose the table's work."""
    t = tkv.create(8, 256, seed=0, device="cpu")
    ids = tkv.encode_ids_np_to_device(np.arange(1, 65, dtype=np.int64), "cpu")
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("tfp_insert"):
            tkv.insert(t, ids, torch.ones(64, 8))
        with tprof.annotate("tfp_lookup"):
            rows = tkv.lookup_or_zeros(t, ids)
    assert torch.equal(rows, torch.ones(64, 8))
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"tfp_insert", "tfp_lookup"} <= names
    ranges = {e["name"]: e for e in events
              if e.get("name") in ("tfp_insert", "tfp_lookup")
              and e.get("ph") == "X"}
    look = ranges["tfp_lookup"]
    inside = [e for e in events if e.get("ph") == "X"
              and e.get("name", "").startswith("aten::")
              and look["ts"] <= e["ts"] <= look["ts"] + look["dur"]]
    assert inside, "no operator inside the lookup range"
    assert {"tfp_insert", "tfp_lookup"} <= {
        e.key for e in prof.key_averages()}
