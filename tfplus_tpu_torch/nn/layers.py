"""Dense layers for the model towers, as ``nn.Module``s.

Same math and parameter layout as the JAX package's ``dense_apply`` /
``mlp_apply`` / ``cross_net_apply`` (``tfplus_tpu/nn/layers.py``): a dense
kernel is ``w[in, out]`` with bias ``b[out]``, and :class:`MLP` and
:class:`CrossNet` are module lists, so their state-dict names (``0.w``,
``1.b``, ...) follow the JAX parameter pytree's paths. Like the port's
entry points, the constructors default to ``device="cuda"`` and raise
without a card; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..utils import device as _dev


def _normal(shape, scale, generator, device):
    # drawn on the CPU generator so a seed gives the same weights anywhere
    return nn.Parameter((torch.randn(shape, generator=generator) * scale)
                        .to(_dev.resolve(device)))


class Dense(nn.Module):
    """``activation(x @ w + b)``, cast back to ``x``'s dtype. Weights are
    RandomNormal(0, scale), as in the JAX package's ``dense_init``."""

    def __init__(self, in_dim: int, out_dim: int,
                 activation: Optional[Callable] = None, *, scale: float = 0.1,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.w = _normal((in_dim, out_dim), scale, generator, device)
        self.b = _normal((out_dim,), scale, generator, device)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.w.dtype), self.w) + self.b
        if self.activation is not None:
            y = self.activation(y)
        return y.to(x.dtype)


class MLP(nn.ModuleList):
    """Dense stack: ``activation`` between layers, ``final_activation``
    after the last."""

    def __init__(self, in_dim: int, hidden: Sequence[int],
                 activation: Callable = torch.relu,
                 final_activation: Optional[Callable] = None, *,
                 scale: float = 0.1,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        layers, d = [], in_dim
        for i, h in enumerate(hidden):
            act = activation if i + 1 < len(hidden) else final_activation
            layers.append(Dense(d, h, act, scale=scale, generator=generator,
                                device=device))
            d = h
        super().__init__(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x)
        return x


class CrossLayer(nn.Module):
    """One DCN cross layer's parameters: ``w[dim]``, ``b[dim]``."""

    def __init__(self, dim: int, *, scale: float = 0.1,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.w = _normal((dim,), scale, generator, device)
        self.b = _normal((dim,), scale, generator, device)


class CrossNet(nn.ModuleList):
    """DCN cross network: ``x_{l+1} = x0 * (x_l · w_l) + b_l + x_l``."""

    def __init__(self, dim: int, num_layers: int = 2, *, scale: float = 0.1,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__([CrossLayer(dim, scale=scale, generator=generator,
                                     device=device)
                          for _ in range(num_layers)])

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for p in self:
            xw = torch.sum(x * p.w, dim=-1, keepdim=True)
            x = x0 * xw + p.b + x
        return x
