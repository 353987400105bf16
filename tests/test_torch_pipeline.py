"""The port's data pipeline (`repro_torch.data.pipeline`) against the JAX
reference's (`repro.data.pipeline`) on the CPU.

Both are numpy on the host with the same three generators, the same
router, placement, replication and scenario machinery, so under one
configuration the first six batches (``tokens``, ``labels``) must be
equal byte for byte and dtype for dtype, and ``metrics`` (``virtual_time``
included), ``state_dict()`` and ``locality_fractions`` exactly equal:
over the schedulers, placements, scenarios, a replication lifecycle with
failovers and lost reads, a K = 4 topology, skewed tokens, stragglers and
the tracer's events.  A pipeline restored mid-run from a state dict (its
own, a JSON round trip of it, or the reference's) gives the batches of
the uninterrupted run; the reference's `ValueError`s are the port's.
"""

import json

import numpy as np
import pytest

from repro.core import locality as rloc
from repro.data import pipeline as R
from repro.telemetry import EventRecorder as REventRecorder
from repro.workloads import ScenarioConfig as RScenarioConfig
from repro_torch.core import cluster, locality as loc
from repro_torch.data import pipeline as T
from repro_torch.telemetry import EventRecorder
from repro_torch.train.trainer import _np_to_list
from repro_torch.workloads import ScenarioConfig

BATCHES = 6
BASE = dict(num_chunks=64, tokens_per_chunk=32, seq_len=31, global_batch=4,
            vocab_size=500, seed=5)
TRACE = {"name": "flash_day", "max_segments": 16}
# server_loss kills hosts 0 and 1 for a stretch of every 16-unit cycle;
# with two replicas a chunk, some chunks lose both (lost reads) and some
# routed reads land on a dead host (failovers)
FAILURE = dict(num_hosts=8, hosts_per_pod=4, replication=2,
               replication_policy="repair", scenario="server_loss",
               scenario_horizon=16.0, seq_len=63, seed=0)


def _pair(slow=None, topology=None, scenario=None, **kw):
    """(reference, port) pipelines of one configuration."""
    opts = dict(BASE, **kw)
    r_opts, t_opts = dict(opts), dict(opts)
    if topology is not None:
        r_opts["topology"] = rloc.Topology(*topology)
        t_opts["topology"] = loc.Topology(*topology)
    if isinstance(scenario, dict):
        r_opts["scenario"] = RScenarioConfig("trace", scenario)
        t_opts["scenario"] = ScenarioConfig("trace", scenario)
    elif scenario is not None:
        r_opts["scenario"] = t_opts["scenario"] = scenario
    return (R.DataPipeline(R.PipelineConfig(**r_opts), slow_hosts=slow),
            T.DataPipeline(T.PipelineConfig(**t_opts), slow_hosts=slow))


def assert_same(a, b, path="state"):
    """Exact equality of nested dicts / lists / numpy arrays / numbers,
    dtypes of arrays included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def assert_batches(ref, port, n=BATCHES):
    for _ in range(n):
        want, got = next(ref), next(port)
        assert sorted(want) == sorted(got) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].tobytes() == want[k].tobytes(), k


def assert_pipelines_equal(ref, port, n=BATCHES):
    assert_batches(ref, port, n)
    assert_same(ref.metrics, port.metrics, "metrics")
    assert_same(ref.state_dict(), port.state_dict())
    assert ref.locality_fractions == port.locality_fractions


@pytest.mark.parametrize("scheduler", ["balanced_pandas", "jsq_maxweight",
                                       "fifo", "pandas_po2"])
def test_schedulers(scheduler):
    ref, port = _pair(scheduler=scheduler, slow={3: 0.1})
    assert_pipelines_equal(ref, port)
    assert port.metrics["reads"] >= 20


@pytest.mark.parametrize("placement,every", [("uniform", 0), ("hdfs", 0),
                                             ("spread", 0),
                                             ("hot_aware", 4)])
def test_placements(placement, every):
    ref, port = _pair(placement=placement, rebalance_every=every)
    assert_pipelines_equal(ref, port)
    if every:
        assert port.metrics["rebalanced"] == ref.metrics["rebalanced"]


@pytest.mark.parametrize("scenario", ["static", "stragglers", TRACE],
                         ids=["static", "stragglers", "trace"])
def test_scenarios(scenario):
    ref, port = _pair(scenario=scenario, scenario_horizon=16.0)
    assert_pipelines_equal(ref, port)


@pytest.mark.parametrize("scheduler", ["balanced_pandas", "fifo"])
def test_repair_under_server_loss_with_failover(scheduler):
    ref, port = _pair(scheduler=scheduler, **FAILURE)
    assert_pipelines_equal(ref, port)
    m = port.metrics
    assert m["lost_reads"] > 0 and m["repair_moves"] > 0
    assert m.get("failovers", 0) > 0


def test_k4_topology_with_tier_rates_skewed_tokens_and_stragglers():
    ref, port = _pair(topology=(16, (4, 8)),
                      tier_rates=(1.0, 0.8, 0.6, 0.4), token_skew=1.2,
                      slow={0: 0.1, 9: 0.3})
    assert_pipelines_equal(ref, port)
    assert port.metrics["tier_reads"].shape == (4,)


def test_token_skew_chunk_tokens():
    cfg_r = R.PipelineConfig(**dict(BASE, token_skew=1.2))
    cfg_t = T.PipelineConfig(**dict(BASE, token_skew=1.2))
    for chunk in (0, 7, 63):
        want, got = R.chunk_tokens(cfg_r, chunk), T.chunk_tokens(cfg_t, chunk)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert T.chunk_replicas(5, 16, 3, 0) == R.chunk_replicas(5, 16, 3, 0)


def test_tracer_events_event_for_event():
    rtr, ttr = REventRecorder(), EventRecorder()
    ref = R.DataPipeline(R.PipelineConfig(**dict(BASE, **FAILURE,
                                                 tracer=rtr)))
    port = T.DataPipeline(T.PipelineConfig(**dict(BASE, **FAILURE,
                                                  tracer=ttr)))
    assert_pipelines_equal(ref, port)
    names = [e["name"] for e in ttr.events()]
    assert "chunk_read" in names and "failover" in names
    assert ttr.events() == rtr.events()


@pytest.mark.parametrize("kw", [dict(), dict(placement="hot_aware",
                                             rebalance_every=3, **FAILURE)],
                         ids=["default", "hot_aware_repair"])
def test_resume_from_state_dict(kw):
    """A pipeline restored mid-run gives the uninterrupted batches: from
    its own state, from the state's JSON round trip (what a checkpoint's
    metadata holds) and from the reference's state."""
    ref, port = _pair(**kw)
    for _ in range(3):
        next(ref), next(port)
    snaps = {"own": port.state_dict(),
             "json": json.loads(json.dumps(_np_to_list(port.state_dict()))),
             "reference": ref.state_dict()}
    later = [_pair(**kw)[1] for _ in snaps]
    for p, snap in zip(later, snaps.values()):
        p.load_state_dict(snap)
    for _ in range(3):
        want = next(port)
        for p in later:
            got = next(p)
            assert got["tokens"].tobytes() == want["tokens"].tobytes()
            assert got["labels"].tobytes() == want["labels"].tobytes()
    for p in later:
        assert_same(port.state_dict()["placement"],
                    p.state_dict()["placement"])


def test_reference_value_errors():
    for mod in (R, T):
        with pytest.raises(ValueError, match="rebalance_every"):
            mod.DataPipeline(mod.PipelineConfig(rebalance_every=-1))
        with pytest.raises(ValueError, match="tier rates"):
            mod.DataPipeline(mod.PipelineConfig(tier_rates=(1.0, 0.5)))
    _, port = _pair(**FAILURE)
    next(port)
    snap = port.state_dict()
    assert "replication" in snap
    with pytest.raises(ValueError, match="replication"):
        _pair()[1].load_state_dict(snap)


def test_cluster_spec_alias():
    from repro.core import cluster as rcluster
    a, b = cluster.ClusterSpec(16, 8), rcluster.ClusterSpec(16, 8)
    assert a.group_sizes == b.group_sizes and a.num_tiers == b.num_tiers
    with pytest.raises(ValueError):
        cluster.ClusterSpec(20, 8)
    with pytest.raises(ValueError):
        rcluster.ClusterSpec(20, 8)
