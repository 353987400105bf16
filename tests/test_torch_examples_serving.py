"""The port's quickstart, `serve_cluster` and scenario replay on the CPU:
the quickstart's three layers at horizon 200 / 50 and 5 training steps
(`--fast`'s 12 take about 25 s on a CPU; the loss logged at step 5 is
already 0.4 below step 1's) under the reference's asserts, with its
routing layer equal to the reference's `ref.wwl_route` exactly;
`serve_cluster` at 8 requests x 3 new tokens draining every request
under each scheduler; `replay_trace` exporting a re-recorded trace that
round-trips."""

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as rref
from repro_torch.examples import quickstart, replay, serve_cluster, trace_replay
from _torch_port import single_torch_thread  # noqa: F401


def test_quickstart_run_holds_the_reference_asserts(capsys):
    out = quickstart.run(200, 50, 5, device="cpu")
    assert capsys.readouterr().out.rstrip().endswith("done.")
    assert set(out["delays"]) == set(quickstart.ALGOS)
    assert all(len(d) == 3 and np.isfinite(d).all()
               for d in out["delays"].values())
    hist = out["history"]
    assert [h["step"] for h in hist] == [1, 5]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2
    theirs = rref.wwl_route(*(jnp.asarray(x)
                              for x in quickstart.route_inputs()))
    for ours, want in zip(out["route"], theirs):
        np.testing.assert_array_equal(ours, np.asarray(want))
    assert len(out["route"][0]) == quickstart.B_ROUTE


def test_serve_cluster_drains_under_each_scheduler(capsys):
    results = serve_cluster.main(["--requests", "8", "--new-tokens", "3"],
                                 device="cpu")
    assert tuple(results) == serve_cluster.SCHEDULERS
    for scheduler, (eng, out) in results.items():
        assert len(out) == 8 and eng.completed == 8, scheduler
        assert all(r.finish_time > 0 and len(r.generated) == 4
                   for r in out), scheduler
        assert sum(eng.assign_tiers.values()) == 8
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.split()[0] in serve_cluster.SCHEDULERS
               for line in lines if line) == 4


def test_replay_trace_exports_a_round_trip(tmp_path):
    export = tmp_path / "traces" / "rerecorded.jsonl"
    rows = replay.replay_trace(export_path=str(export), device="cpu")
    assert len(rows) == 1
    name, steps, derived = rows[0]
    assert name == "serve_balanced_pandas_scn_trace_diurnal_week"
    assert 0 < steps <= 1200 and derived.startswith("tiers=")
    rerec, rescn = trace_replay.check_round_trip(export, 64)
    assert rerec.num_intervals == 32 and int(rerec.arrivals.sum()) == 12
    assert rerec.name == "trace:diurnal_week" and rescn.segments
