"""The port's durable fleet serving on the CPU: the watchdog, thread mode
with a live HTTP scrape, the file sink, the fault schedules against the
JAX package's, ``serve --fleet`` with checkpoints, SIGKILL-and-resume
through ``python -m repro_torch.launch.serve --fleet``, and the train
CLI's ``--ckpt-dir``/``--resume``.

The m = 64 sessions are ``build_linreg_fleet_session(device="cpu")``;
the fault schedules are held to ``repro.launch.faults`` on the same
schedules and batches.
"""
import json
import re
import shutil
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.launch.faults import AgentFault as JAgentFault
from repro.launch.faults import FaultInjector as JFaultInjector
from repro.launch.faults import fault_mask as jfault_mask
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.comm.rollup import CommRollup
from repro_torch.configs.paper_linreg import (
    TIERED_M64_CFG,
    TIERED_M64_QUADRATIC,
)
from repro_torch.core import regression as R
from repro_torch.data.synthetic import step_generator
from repro_torch.launch import faults, serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.faults import (
    AgentFault,
    FaultInjector,
    fault_mask,
    make_stall,
)
from repro_torch.launch.session import (
    FleetSession,
    SessionOptions,
    TelemetryServer,
    Watchdog,
    build_linreg_fleet_session,
    file_sink,
)
from test_checkpoint import _batch as jbatch

torch.set_num_threads(1)


def _equal_states(a, b):
    la = jax.tree_util.tree_leaves(convert.to_numpy(a))
    lb = jax.tree_util.tree_leaves(convert.to_numpy(b))
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


# ----------------------------------------------------------------------
# watchdog
# ----------------------------------------------------------------------


def test_watchdog_one_event_per_episode():
    roll = CommRollup()
    wd = Watchdog(roll, timeout=1.0, clock=lambda: 0.0)
    assert not wd.check(now=0.5)
    assert wd.check(now=1.5)        # stall flagged once...
    assert not wd.check(now=9.0)    # ...not re-flagged while ongoing
    wd.beat()
    assert wd.check(now=99.0)       # re-armed by the beat
    assert roll.snapshot()["degradation_events"] == {"stall": 2}


def test_watchdog_in_session_flags_a_stall():
    """One hung round is one stall event (the first rounds, which may
    pay one-time set-up costs, run before the count is taken)."""
    slept = []
    stall = make_stall(4, 0.4, on_round=lambda k, m: slept.append(k))
    s = build_linreg_fleet_session(
        device="cpu", on_round=stall,
        options=SessionOptions(watchdog_timeout=0.1))
    s.run(rounds=2)
    before = s.rollup.snapshot().get("degradation_events", {})
    assert s.run(rounds=4) == 4
    after = s.rollup.snapshot()["degradation_events"]
    assert slept == list(range(6))
    assert after["stall"] - before.get("stall", 0) == 1


# ----------------------------------------------------------------------
# thread mode, the HTTP endpoint, the file sink
# ----------------------------------------------------------------------


def _scrape(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def test_thread_mode_with_http_scrape_and_file_sink(tmp_path):
    """start()/stop() on a daemon thread while a TelemetryServer scrape
    and a file sink read the same rollup live; the session serves until
    stop()."""
    path = tmp_path / "snap.json"
    holder = {}
    session = build_linreg_fleet_session(
        device="cpu", on_round=lambda k, m: holder["sink"](k, m))
    holder["sink"] = sink = file_sink(str(path), session.rollup, every=2)
    server = session.serve_telemetry(port=0)
    try:
        session.start(rounds=0)
        deadline = time.monotonic() + 60
        while session.rollup.rounds < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = json.loads(_scrape(f"{server.url}/stats.json"))
        metrics = _scrape(f"{server.url}/metrics")
        while (session.rollup.rounds <= stats["rounds"]
               and time.monotonic() < deadline):
            time.sleep(0.01)
        later = json.loads(_scrape(f"{server.url}/stats.json"))
        session.stop()
        sink.flush()
    finally:
        session.stop()
        server.stop()
    assert 3 <= stats["rounds"] < later["rounds"]
    assert metrics.startswith("# HELP fleet_rounds_total ")
    assert 'fleet_tier_tx_rate{tier="backbone"}' in metrics
    on_disk = json.loads(path.read_text())
    assert on_disk["rounds"] == session.rollup.rounds == session.round_index
    # the loop really stopped: no more rounds accumulate
    settled = session.rollup.rounds
    time.sleep(0.2)
    assert session.rollup.rounds == settled


def test_thread_error_surfaces_and_double_start_is_refused():
    def bad_step(state, batch):
        raise RuntimeError("boom")

    sess = FleetSession(bad_step, {"w": torch.zeros(2)}, lambda k: None,
                        CommRollup())
    sess.start(rounds=1)
    sess._thread.join(30)
    with pytest.raises(RuntimeError, match="boom"):
        sess.stop()
    sess.stop()  # the error is raised once

    gate = threading.Event()

    def slow_step(state, batch):
        gate.wait(30)
        return state, {}

    sess = FleetSession(slow_step, {}, lambda k: None, CommRollup())
    sess.start(rounds=0)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            sess.start(rounds=0)
    finally:
        gate.set()
        sess.stop()
    assert sess.round_index >= 1


def test_telemetry_server_404():
    server = TelemetryServer(CommRollup(), port=0)
    server.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{server.url}/nope", timeout=10)
        assert e.value.code == 404
        assert json.loads(_scrape(f"{server.url}/stats.json"))["rounds"] == 0
    finally:
        server.stop()


def test_file_sink_writes_whole_snapshots(tmp_path):
    roll = CommRollup()
    path = tmp_path / "deep" / "snap.json"
    sink = file_sink(str(path), roll, every=3)
    for k in range(5):
        roll.update({"num_tx": 1.0, "wire_bytes": 2.0})
        sink(k, None)
        written = json.loads(path.read_text()) if path.exists() else None
        assert written is None if k < 2 else written["rounds"] == 3
    sink.flush()
    assert json.loads(path.read_text()) == json.loads(roll.to_json())
    assert not (tmp_path / "deep" / "snap.json.tmp").exists()


# ----------------------------------------------------------------------
# fault schedules against the JAX package's
# ----------------------------------------------------------------------

SCHEDULES = (
    (0, 3, 0, 0), (1, 2, 2, 0), (2, 4, 1, 3), (3, 0, 2, 5), (5, 1, 0, 0),
)


def test_agent_faults_and_masks_match_jax():
    port = [AgentFault(*s) for s in SCHEDULES]
    ref = [JAgentFault(*s) for s in SCHEDULES]
    for k in range(20):
        assert [f.down(k) for f in port] == [f.down(k) for f in ref]
        for m in (4, 6):
            np.testing.assert_array_equal(fault_mask(port, m, k),
                                          jfault_mask(ref, m, k))


def test_fault_injector_matches_jax():
    """The port's injector reads the round from its argument; the JAX
    one counts its calls.  Called round by round from 0 they zero the
    same rows of the same batches."""
    key = jax.random.key(3)
    port = FaultInjector(
        lambda k: convert.to_torch(jax.device_get(
            jbatch(jax.random.fold_in(key, k))), "cpu"),
        [AgentFault(*s) for s in SCHEDULES], 4)
    ref = JFaultInjector(jbatch, [JAgentFault(*s) for s in SCHEDULES], 4)
    for k in range(8):
        got = convert.to_numpy(port(k))
        want = jax.device_get(ref(jax.random.fold_in(key, k)))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        down = 1.0 - jfault_mask([JAgentFault(*s) for s in SCHEDULES], 4, k)
        assert all(np.abs(got[0][i]).max() == 0 for i in np.flatnonzero(down))


def test_fault_injector_across_a_resume(tmp_path):
    """A crashed metro agent sends nothing in the rounds it is down, and
    a session resumed mid-outage keeps the schedule on the lineage's
    rounds: bit for bit the unbroken session."""
    net = TIERED_M64_QUADRATIC
    agent = net.tier_index().index(1)  # the first metro agent
    fault = AgentFault(agent=agent, start=2, duration=4)
    problem = R.make_problem(TIERED_M64_CFG, step_generator(0, 0, "cpu"),
                             device="cpu")
    batches = FaultInjector(
        lambda k: R.agent_batches(problem, step_generator(1, k, "cpu")),
        [fault], net.num_agents)
    down = []

    def session(options=None):
        return build_linreg_fleet_session(
            net=net, device="cpu", options=options, batch_fn=batches,
            on_round=lambda k, m: down.append(
                (k, float(m["agent_tx"][agent]))))

    opts = SessionOptions(ckpt_dir=str(tmp_path), ckpt_every=3)
    session(opts).run(rounds=3)
    resumed = session(opts)
    assert resumed.round_index == 3
    resumed.run(rounds=5)
    lineage = list(down)
    down.clear()
    unbroken = session()
    unbroken.run(rounds=8)
    assert lineage == down
    assert [tx for k, tx in down if fault.down(k)] == [0.0] * 4
    assert _equal_states(resumed.state, unbroken.state)


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------


def test_serve_fleet_checkpoints_then_resumes(tmp_path, capsys):
    args = ["--fleet", "--device", "cpu", "--mix", "tiered_m64_lossy",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "2", "--telemetry-file",
            str(tmp_path / "t.json")]
    assert serve.main(args + ["--rounds", "4"]) == 0
    out = capsys.readouterr().out
    assert "fleet: mix=tiered_m64_lossy m=64 rounds=4" in out
    assert "resumed" not in out
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert serve.main(args + ["--rounds", "2"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from checkpoint at round 4 ({tmp_path})" in out
    assert re.search(r"^round 6: loss=", out, re.M), out
    snap = json.loads((tmp_path / "t.json").read_text())
    assert snap["rounds"] == 6 and snap["restarts"] == 1
    assert ckpt.latest_step(str(tmp_path)) == 6
    manifest = ckpt.read_manifest(str(tmp_path))
    assert manifest["extra"]["round"] == 6
    assert manifest["paths"][:2] == ["['key']", "['state'].step"]
    assert serve.main(args + ["--rounds", "1", "--no-resume"]) == 0
    assert "resumed" not in capsys.readouterr().out


def test_kill_and_resume_on_the_cpu(tmp_path):
    """JAX's defaults: 30 rounds of the adaptive m = 64 mix, a SIGKILL at
    round 10, a checkpoint every 5 rounds."""
    record = faults.kill_and_resume(str(tmp_path), device="cpu",
                                    verbose=False)
    assert record["ok"] and record["device"] == "cpu"
    assert record["restarts"] == 1
    assert record["rounds_final"] >= 30
    assert record["rounds_at_kill"] >= 10
    assert record["resume_round"] % 5 == 0
    assert record["wire_bytes_final"] >= record["wire_bytes_at_kill"]
    assert record["recovery_s"] > 0


def test_entry_points_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for call in (
        lambda: serve.main(["--fleet", "--rounds", "1"]),
        lambda: faults.main(["--ckpt-dir", str(tmp_path)]),
        lambda: train_cli.main(["--reduced", "--steps", "1"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _npz(path):
    with np.load(path) as data:
        return [data[k] for k in sorted(data.files,
                                        key=lambda f: int(f[5:]))]


def test_train_cli_resume_is_bitwise(tmp_path, capsys):
    """A reduced model with m = 2 runs 4 steps with ``--ckpt-every 2``;
    a relaunch with ``--resume`` over a directory holding only the step-2
    checkpoint (what a run killed after it leaves) ends bit for bit where
    the unbroken run ends."""
    args = ["--device", "cpu", "--reduced", "--steps", "4", "--seq", "16",
            "--batch", "4", "--agents", "2", "--ckpt-every", "2",
            "--comm", "gain_lookahead(lam=0.01)|int8+ef"]
    unbroken, resumed = tmp_path / "a", tmp_path / "b"
    train_cli.main(args + ["--ckpt-dir", str(unbroken)])
    assert ckpt.latest_step(str(unbroken)) == 4
    resumed.mkdir()
    shutil.copytree(unbroken / "step_00000002", resumed / "step_00000002")
    capsys.readouterr()
    train_cli.main(args + ["--ckpt-dir", str(resumed), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert re.search(r"^done: 2 steps, transmissions \d+/4 ", out, re.M)
    a = _npz(unbroken / "step_00000004" / "arrays.npz")
    b = _npz(resumed / "step_00000004" / "arrays.npz")
    assert len(a) == len(b) == 23
    assert all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))
