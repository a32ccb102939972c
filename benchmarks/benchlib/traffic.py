"""The one traffic generator. A mix is a data file of parameters
(``traffic/<mix>.json``); a model's adapter composes its batches from the
draws below, all made on the device from the seed, then kept on the host as
the numpy arrays a feed hands to the step.

Ids of a table are drawn Zipf(``zipf_s``) over the table's resident ids,
ranked in a seeded random order; a ``fresh_share`` of the positions
instead hold ids that no table holds. ``pool_batches`` distinct batches are
made; the window goes round them. In a training loop the fresh positions
of step ``s`` get ids that no earlier step used, so every step inserts.
"""
from __future__ import annotations

import numpy as np
import torch

from . import inputs


class Traffic:
    def __init__(self, mix: dict, resident: dict, seed: int, device):
        """``resident[table]``: how many resident ids the table holds."""
        self.mix = mix
        self.seed = seed
        self.device = device
        self.gen = inputs.generator(seed, device, "traffic")
        self.train = mix["loop"] == "train"
        self._ranked, self._cdf = {}, {}
        for name, n in resident.items():
            order = torch.randperm(n, generator=self.gen, device=device)
            self._ranked[name] = inputs.key_of(order, seed, name)
            w = torch.arange(1, n + 1, device=device,
                             dtype=torch.float64) ** -float(mix["zipf_s"])
            cdf = torch.cumsum(w, 0)
            self._cdf[name] = cdf / cdf[-1]
        self.streams = []            # stream names in a fixed order
        self.pool = []

    # draws the adapters compose ------------------------------------------
    def ids(self, table: str, shape) -> tuple:
        """``(ids, fresh)``: int64 ids of ``table`` and where they are
        fresh (their values are set per step by :meth:`batch`)."""
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float64)
        rank = torch.searchsorted(self._cdf[table], u.reshape(-1))
        rank = torch.clamp(rank, max=self._cdf[table].shape[0] - 1)
        ids = self._ranked[table][rank].reshape(shape)
        fresh = torch.rand(shape, generator=self.gen,
                           device=self.device) < self.mix["fresh_share"]
        return ids, fresh

    def lengths(self, batch: int, longest: int) -> torch.Tensor:
        """History lengths: uniform on 1..longest, an ``empty_share`` 0."""
        n = torch.randint(1, longest + 1, (batch,), generator=self.gen,
                          device=self.device)
        empty = torch.rand(batch, generator=self.gen,
                           device=self.device) < self.mix["empty_share"]
        return torch.where(empty, 0, n)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def labels(self, batch: int) -> torch.Tensor:
        return (torch.rand(batch, generator=self.gen, device=self.device)
                < self.mix["label_p"]).float()

    # the pool ---------------------------------------------------------------
    def fill(self, draw) -> None:
        """Make the pool: ``draw(self)`` returns one batch as
        ``{"ids": {stream: (ids, fresh)}, "features": ..., "labels": ...}``
        of device tensors."""
        for _ in range(self.mix["pool_batches"]):
            b = draw(self)
            if not self.streams:
                self.streams = sorted(b["ids"])
            ids = {n: b["ids"][n][0].reshape(-1).cpu().numpy()
                   for n in self.streams}
            fresh = {n: np.nonzero(b["ids"][n][1].reshape(-1).cpu()
                                   .numpy())[0] for n in self.streams}
            self.pool.append({"ids": ids, "fresh": fresh,
                              "features": _host(b["features"]),
                              "labels": _host(b["labels"])})
        self.pool = [self._set_fresh(b, i) for i, b in enumerate(self.pool)]

    def _set_fresh(self, b: dict, step: int) -> dict:
        out = dict(b, ids=dict(b["ids"]))
        for k, name in enumerate(self.streams):
            pos = b["fresh"][name]
            if pos.size:
                ids = b["ids"][name].copy()
                width = ids.shape[0]
                ids[pos] = (inputs.FRESH_BASE
                            + (step * len(self.streams) + k) * width + pos)
                out["ids"][name] = ids
        return out

    def batch(self, step: int) -> dict:
        """The batch that step or request ``step`` of the run takes."""
        b = self.pool[step % len(self.pool)]
        if self.train and step >= len(self.pool):
            b = self._set_fresh(b, step)
        return b

    @staticmethod
    def feed(b: dict) -> dict:
        """What the program is handed: ids, features and labels."""
        return {"ids": b["ids"], "features": b["features"],
                "labels": b["labels"]}


def _host(x):
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x.cpu().numpy()
