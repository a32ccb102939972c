"""The program's layers in the traced stretch, read from its own spans.

The port marks its sparse step with ``tfp::`` spans (``record_function``
ranges, ``user_annotation`` events of the same trace as the kernels). An
instant of the stretch belongs to the layer of the innermost ``tfp::`` span
that covers it on the thread that holds ``tfp::step``; the step's own time
and the time outside any span belong to no layer (``None``). A program
without the spans (an older one) gives no layers, and every reader here
then returns None.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from . import layers
from .trace import HARNESS, SYNC_CALLS, innermost

STEP = "tfp::step"
CLAIM_ROUND = "tfp::claim_round"
LAYER_OF = {
    "tfp::feed": "feed",
    "tfp::lookup": "lookup", "tfp::dedup": "lookup", "tfp::probe": "lookup",
    "tfp::gather": "lookup",
    "tfp::insert": "insert", CLAIM_ROUND: "insert",
    "tfp::sparse_opt": "sparse_opt",
    "tfp::forward": "dense", "tfp::backward": "dense",
    "tfp::dense_opt": "dense",
}
LAYERS = ("feed", "lookup", "insert", "sparse_opt", "dense")


def step_spans(trace):
    """The ``tfp::`` spans ``(start, end, name)`` of the thread that holds
    the most ``tfp::step`` spans, or None where no thread holds one."""
    best, most = None, 0
    for evs in trace.host.values():
        n = sum(1 for e in evs if e[2] == STEP)
        if n > most:
            best, most = evs, n
    if best is None:
        return None
    return [e for e in best if e[2].startswith("tfp::")]


def pieces(trace, spans):
    """The stretch cut where a span starts or ends: sorted ``(start, end,
    layer)`` pieces that cover ``[lo, hi]`` exactly."""
    cuts = sorted({trace.lo, trace.hi} | {
        min(max(t, trace.lo), trace.hi) for a, b, _ in spans for t in (a, b)})
    mids = [(a + b) / 2 for a, b in zip(cuts, cuts[1:])]
    inner = innermost(spans, mids)
    return [(a, b, None if e is None else LAYER_OF.get(e[2]))
            for a, b, e in zip(cuts, cuts[1:], inner)]


def split(trace):
    """``{"idle_us": {layer: us}, "syncs": {layer: n}, "claim_rounds": n}``
    over the stretch (``None`` keys: outside any layer), or None where the
    program recorded no ``tfp::step``. Each idle gap of ``trace.gaps()`` is
    cut exactly at the pieces' bounds; a synchronize call of the program
    (the harness's ranges left out, as ``Trace.syncs`` does) counts in the
    layer where it starts, on whichever thread it ran."""
    spans = step_spans(trace)
    if spans is None:
        return None
    ps = pieces(trace, spans)
    starts = [a for a, _, _ in ps]
    idle = defaultdict(float)
    i = 0
    for a, b in trace.gaps():
        while ps[i][1] <= a:
            i += 1
        j = i
        while j < len(ps) and ps[j][0] < b:
            p, q, layer = ps[j]
            idle[layer] += min(b, q) - max(a, p)
            j += 1
    host = [e for evs in trace.host.values() for e in evs]
    harness = [(a, b) for a, b, name in host if name in HARNESS]
    syncs = defaultdict(int)
    for ts, _, name in host:
        if name in SYNC_CALLS and not any(a <= ts < b for a, b in harness):
            k = bisect.bisect_right(starts, ts) - 1
            syncs[ps[k][2]] += 1
    return {"idle_us": dict(idle), "syncs": dict(syncs),
            "claim_rounds": sum(1 for e in spans if e[2] == CLAIM_ROUND)}


def _split(view, kind):
    if not layers._on_device(view, kind):
        return None
    return split(view.trace)


def idle_ms(view, kind, layer):
    """Device-idle time inside ``layer`` per step or request, in ms."""
    s = _split(view, kind)
    if s is None:
        return None
    return s["idle_us"].get(layer, 0.0) / 1e3 / view.steps


def syncs(view, kind, layer):
    """Synchronize calls that start inside ``layer`` per step or request."""
    s = _split(view, kind)
    if s is None:
        return None
    return s["syncs"].get(layer, 0) / view.steps


def claim_rounds(view, kind):
    """``tfp::claim_round`` spans per step."""
    s = _split(view, kind)
    if s is None:
        return None
    return s["claim_rounds"] / view.steps
