"""Balanced-PANDAS (paper §3.2), port of `repro.core.balanced_pandas`.

Queueing structure: K queues per server, one per locality tier, stored
as one (M, K) int32 matrix ``q``.  Workload

    W_m = sum_k  q[m, k] / rates[m, k]   (+ the in-service residual).

Routing sends an arrival to argmin_m W_m / rate(m, tier); scheduling lets
an idle server serve its fastest-tier nonempty queue.  The scheduler
decides with estimated rates ``est`` (M, K); service uses the true rates.

This slice ports what the fleet path runs: the state, `workload`, the
service/scheduling phase, and the registered policy.  Random draws come
in as uniforms (`core.rng`), so a Bernoulli with probability p is
``u < p`` — how `jax.random.bernoulli` is built, which lets the tests
replay the reference's draws exactly.  The dense sequential `slot_step`
(`route_one` with Gumbel tie-breaks) comes with the dense slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import claiming, locality as loc
from repro_torch.core.policy import SlotPolicy, register_policy


class PandasState(NamedTuple):
    q: torch.Tensor        # (M, K) int32 waiting tasks per (server, tier)
    serving: torch.Tensor  # (M,) int32 class in service (0 idle, 1..K)


def init_state(topo: loc.Topology, device=None) -> PandasState:
    m, k = topo.num_servers, topo.num_tiers
    return PandasState(torch.zeros((m, k), dtype=torch.int32, device=device),
                       torch.zeros((m,), dtype=torch.int32, device=device))


def num_in_system(s: PandasState) -> torch.Tensor:
    return s.q.sum() + (s.serving > 0).sum()


def workload(s: PandasState, est: torch.Tensor) -> torch.Tensor:
    """(M,) estimated weighted workload W_m (waiting + in-service share).

    The tier sum is accumulated left to right in float32 and the
    in-service task adds its expected residual 1/rate at the class it is
    served at, bit for bit as the reference computes it.
    """
    k = s.q.shape[1]
    w = s.q[:, 0] / est[:, 0]
    for t in range(1, k):
        w = w + s.q[:, t] / est[:, t]
    idx = torch.clamp(s.serving.long() - 1, 0, k - 1)
    resid_rate = torch.gather(est, 1, idx[:, None])[:, 0]
    return w + torch.where(s.serving > 0, 1.0 / resid_rate,
                           torch.zeros_like(resid_rate))


def service_completions(s: PandasState, u_serve: torch.Tensor,
                        true_rates: torch.Tensor):
    """Bernoulli service completions at the *true* rates: ``u_serve < p``
    for the (M,) uniforms of this slot.  `true_rates` is the shared (K,)
    vector or an (M, K) matrix.  Returns (done (M,) bool, completions)."""
    tmk = loc.per_server_rates(true_rates, s.serving.shape[0])
    done = u_serve < claiming.tier_rates(s.serving, tmk)
    return done, done.sum().to(torch.int32)


def schedule_idle(s: PandasState, done: torch.Tensor) -> PandasState:
    """Idle servers (post-completion) pick their fastest nonempty tier
    queue (local > rack-local > ... > remote, conflict-free)."""
    k = s.q.shape[1]
    serving = torch.where(done, torch.zeros_like(s.serving), s.serving)
    nonempty = s.q > 0                                   # (M, K)
    first = torch.argmax(nonempty.to(torch.int32), dim=1)  # first max wins
    has_task = nonempty.any(dim=1)
    take = (serving == 0) & has_task
    tiers = torch.arange(k, device=s.q.device)
    dec = take[:, None] & (tiers[None, :] == first[:, None])
    return PandasState(
        q=s.q - dec.to(torch.int32),
        serving=torch.where(take, (first + 1).to(torch.int32), serving),
    )


def serve_and_schedule(s: PandasState, u_serve: torch.Tensor,
                       true_rates: torch.Tensor):
    """Service completions (true rates) + idle-server scheduling.
    Returns (state, completions)."""
    done, completions = service_completions(s, u_serve, true_rates)
    return schedule_idle(s, done), completions


@register_policy
class BalancedPandasPolicy(SlotPolicy):
    """Balanced-PANDAS: weighted-workload routing over estimated per-tier
    rates — the paper's headline throughput- and heavy-traffic-optimal
    policy."""

    name = "balanced_pandas"

    def init_state(self, topo: loc.Topology, device=None,
                   **opts) -> PandasState:
        return init_state(topo, device)

    def slot_step(self, s, draws, types, active, est, true_rates, ancestors):
        raise NotImplementedError(
            "the dense sequential Balanced-PANDAS step comes with the dense "
            "slice of the port; only the fleet path (sharding.sim) runs now")

    def num_in_system(self, s: PandasState) -> torch.Tensor:
        return num_in_system(s)
