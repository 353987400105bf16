"""The marginal law of the port's dense draws (`core.rng.DenseDeviceSource`)
on the CPU, at the tail study's configuration: Topology(24, 6), lam 9.9
(0.99 of the hot-rack capacity), max_arrivals 24, p_hot 0.5.

At rho 0.99 a bias of 0.3% in a rate moves the mean delay by tens of
percent, so each sampled frequency below is held within four standard
errors, at a sample size (128 cells x 1536 slots) where that error is
under 1e-3 of the value; the exceptions, stated where they are held,
are the count's variance (3.3e-3; the count's law is also held exactly)
and the share of one of the 24 servers (1.3e-3):

- the truncated-Poisson count: the exact law of the inverse CDF at a
  24-bit uniform (the CPU generator's resolution, checked on the draws)
  against the truncated Poisson's pmf by recursion, to 1e-6; then the
  sampled mean and variance against it;
- the hot fraction of the arriving tasks against p_hot;
- each server's share as one of a task's three locals, a chi-square
  against uniform, hot tasks (rack 0) and the others apart;
- the service uniforms' Bernoulli frequencies at the study's rates 0.5,
  0.45 and 0.25;
- under a schedule with rack weights (3, 2, 0, 2), each rack's share of
  the hot tasks against its weight (every lane hot).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import workloads as wl
from repro_torch.core import locality as loc
from repro_torch.core.rng import DenseDeviceSource, DrawPlan, poisson_cdf
from _torch_port import single_torch_thread  # noqa: F401

TOPO = loc.Topology(24, 6)
LAM, BATCH, P_HOT = 9.9, 24, 0.5
CELLS = [(s, LAM) for s in range(128)]
RATES = (0.5, 0.45, 0.25)
WEIGHTS = (3.0, 2.0, 0.0, 2.0)
SIGMAS = 4.0


def _truncated_poisson(lam, batch):
    """pmf of min(N, batch), N ~ Poisson(lam), by the recursion
    p_k = p_{k-1} lam / k (float64)."""
    p = np.empty(batch + 1)
    p[0] = math.exp(-lam)
    for k in range(1, batch):
        p[k] = p[k - 1] * lam / k
    p[batch] = 1.0 - p[:batch].sum()
    return p


def _moments(p):
    k = np.arange(len(p))
    mean = (k * p).sum()
    return mean, ((k - mean) ** 2 * p).sum()


@pytest.fixture(scope="module")
def draws():
    """(count, types of hot tasks, types of the others, u_hot, u_serve)
    over 1536 slots of the 128 cells.  A lane's type does not depend on
    the count, so every lane is typed, once as a hot task and once as
    another (p_hot 1 and 0)."""
    src = DenseDeviceSource(CELLS, DrawPlan(), BATCH, TOPO.num_servers,
                            "cpu")
    rack_of = torch.as_tensor(np.array(TOPO.rack_of))
    out = [[] for _ in range(5)]
    for t in range(1536):
        d = src.slot(t)
        for i, x in enumerate((d.n, *[loc.sample_task_types_at(
                d.u_hot, d.g_type, rack_of, p) for p in (1.0, 0.0)],
                d.u_hot, d.u_serve)):
            out[i].append(x)
    n, hot, other, u_hot, u_serve = (torch.cat(x).numpy() for x in out)
    return n.astype(np.float64), hot.reshape(-1, 3), other.reshape(-1, 3), \
        u_hot, u_serve


def test_count_inverse_cdf_is_the_truncated_poisson(draws):
    """The count is #{k : cdf[k] <= u} for one float32 uniform u, on the
    CPU generator's 2^-24 grid: P(count <= k) = P(u < cdf[k]) =
    ceil(cdf[k] 2^24) / 2^24, whose mean and variance equal the
    truncated Poisson's within 1e-6."""
    for u in draws[3:]:
        assert (u * 2 ** 24 == np.round(u * 2 ** 24)).all()
    cdf = poisson_cdf(LAM, BATCH)
    law = np.diff(np.concatenate([[0.0], np.ceil(cdf * 2 ** 24) / 2 ** 24,
                                  [1.0]]))
    want = _truncated_poisson(LAM, BATCH)
    np.testing.assert_allclose(law, want, atol=1e-7)
    for got, ref in zip(_moments(law), _moments(want)):
        assert got == pytest.approx(ref, rel=1e-6)


def test_count_mean_and_variance(draws):
    n = draws[0]
    mean, var = _moments(_truncated_poisson(LAM, BATCH))
    k = np.arange(BATCH + 1)
    mu4 = ((k - mean) ** 4 * _truncated_poisson(LAM, BATCH)).sum()
    se_mean = math.sqrt(var / n.size)
    se_var = math.sqrt((mu4 - var ** 2) / n.size)
    assert se_mean / mean < 1e-3
    assert abs(n.mean() - mean) < SIGMAS * se_mean, (n.mean(), mean)
    assert abs(n.var() - var) < SIGMAS * se_var, (n.var(), var)


def test_hot_fraction(draws):
    hot = draws[3] < P_HOT
    se = math.sqrt(P_HOT * (1 - P_HOT) / hot.size)
    assert se / P_HOT < 1e-3
    assert abs(hot.mean() - P_HOT) < SIGMAS * se


@pytest.mark.parametrize("hot", [True, False], ids=["hot", "other"])
def test_local_shares_are_uniform(draws, hot):
    """Each server's count as one of a task's three locals (three distinct
    servers a task): uniform over the hot rack's six servers for hot
    tasks, over all 24 for the others; a chi-square within four of its
    standard deviations of its mean.  The relative standard error of a
    server's share is 5.9e-4 (hot) and 1.3e-3 (other)."""
    typ = draws[1] if hot else draws[2]
    assert (np.diff(np.sort(typ, axis=1), axis=1) > 0).all()
    servers = np.arange(6) if hot else np.arange(TOPO.num_servers)
    counts = np.bincount(typ.ravel(), minlength=TOPO.num_servers)
    assert counts.sum() == counts[servers].sum()
    obs = counts[servers]
    exp = obs.sum() / len(servers)
    assert math.sqrt((1 - 1 / len(servers)) / exp) < 1.4e-3
    chi2 = ((obs - exp) ** 2 / exp).sum()
    df = len(servers) - 1
    assert chi2 < df + SIGMAS * math.sqrt(2 * df), (chi2, obs)


@pytest.mark.parametrize("rate", RATES)
def test_service_uniforms(draws, rate):
    u = draws[4]
    p = math.ceil(np.float32(rate) * 2 ** 24) / 2 ** 24
    se = math.sqrt(p * (1 - p) / u.size)
    assert se / p < 1e-3
    assert abs((u < np.float32(rate)).mean() - p) < SIGMAS * se


def test_rack_weights():
    """Under a schedule with rack weights, the rack of each hot task (all
    lanes hot, p_hot 1) against its weight; a zero weight is never
    drawn."""
    sched = wl.compile_schedule(wl.Scenario("weighted", (
        wl.Segment(0.0, rack_weights=WEIGHTS),)), TOPO, 1024, P_HOT,
        device="cpu")
    src = DenseDeviceSource(CELLS, DrawPlan(), BATCH, TOPO.num_servers,
                            "cpu", sched)
    rack_of = torch.as_tensor(np.array(TOPO.rack_of))
    w = sched.rack_weights[0]
    counts = torch.zeros(len(WEIGHTS), dtype=torch.int64)
    for t in range(1024):
        d = src.slot(t)
        typ = loc.sample_task_types_at(d.u_hot, d.g_type, rack_of, 1.0,
                                       rack_weights=w, g_rack=d.g_rack)
        racks = rack_of[typ.long()]
        assert torch.equal(racks.amin(-1), racks.amax(-1))
        counts += torch.bincount(racks[..., 0].ravel(),
                                 minlength=len(WEIGHTS))
    n = int(counts.sum())
    p = np.asarray(WEIGHTS) / sum(WEIGHTS)
    assert counts[2] == 0
    for r in (0, 1, 3):
        se = math.sqrt(p[r] * (1 - p[r]) / n)
        assert se / p[r] < 1e-3
        assert abs(int(counts[r]) / n - p[r]) < SIGMAS * se, (r, counts)
