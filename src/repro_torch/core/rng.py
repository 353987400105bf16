"""The one seam every random draw of the fleet simulator goes through.

A `DrawSource` yields, per slot and in this order:

    n        -- the truncated-Poisson arrival count, an int64 scalar tensor
    u_hot    -- (B,) uniforms in [0, 1): task b is hot iff u_hot[b] < p_hot
    r        -- (B, 3) uniforms for the distinct-3 replica offsets
    u_serve  -- (M,) uniforms: server m completes iff u_serve[m] < rate_m

Bernoullis are ``u < p``, which is how `jax.random.bernoulli` is built, so
a source that recomputes the reference's uniforms from its key schedule
(the tests' replay source) drives the port through the reference's exact
sample path.  The default `DeviceSource` draws from a seeded
`torch.Generator` on the device: Philox4x32 on CUDA (PyTorch's CPU
generator is a Mersenne twister).  All draws stay on the device; nothing
is read back to the host.
"""

from __future__ import annotations

import abc
from typing import NamedTuple

import torch


class SlotDraws(NamedTuple):
    n: torch.Tensor        # () int64 arrivals this slot, <= B
    u_hot: torch.Tensor    # (B,) float32
    r: torch.Tensor        # (B, 3) float32
    u_serve: torch.Tensor  # (M,) float32


class DrawSource(abc.ABC):
    """Per-slot random draws of the fleet simulator."""

    @abc.abstractmethod
    def slot(self, t: int) -> SlotDraws:
        """The draws of slot `t` (slots are asked for in increasing order)."""


class DeviceSource(DrawSource):
    """Draws from one seeded `torch.Generator` on `device`, in slot order."""

    def __init__(self, seed: int, lam: float, batch: int, num_servers: int,
                 device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.lam = torch.tensor(float(lam), dtype=torch.float32,
                                device=self.device)
        self.batch = batch
        self.num_servers = num_servers

    def slot(self, t: int) -> SlotDraws:
        g, dev = self.gen, self.device
        n = torch.poisson(self.lam, generator=g)
        n = torch.clamp(n, max=self.batch).to(torch.int64)
        u_hot = torch.rand((self.batch,), generator=g, device=dev)
        r = torch.rand((self.batch, 3), generator=g, device=dev)
        u_serve = torch.rand((self.num_servers,), generator=g, device=dev)
        return SlotDraws(n, u_hot, r, u_serve)
