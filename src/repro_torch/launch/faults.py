"""Fault injection for fleet serving: crash/flap schedules, hung-round
stalls, and a SIGKILL-at-round-k subprocess driver (port of
``repro.launch.faults``).

Three fault families:

* **Agent crashes and flaps** — :class:`AgentFault` schedules applied by
  :class:`FaultInjector`, a ``batch_fn`` wrapper that zeroes a downed
  agent's observation rows (zero residual ⇒ zero gradient ⇒ nothing to
  offer the gate).  This is beyond the scenario churn masks: churn is
  planned arrival/departure baked into the policy mix, faults are
  unplanned mid-serve outages.
* **Hung rounds** — :func:`make_stall` wraps an ``on_round`` callback
  with a scheduled sleep, simulating a stalled round so the session
  :class:`~repro_torch.launch.session.Watchdog` can be exercised end to
  end (degradation event logged, loop keeps going).
* **Process death** — :func:`kill_and_resume` drives
  ``python -m repro_torch.launch.serve --fleet`` in a subprocess,
  SIGKILLs it once telemetry shows round ``kill_round`` reached,
  relaunches with the same ``--ckpt-dir`` (auto-resume), and verifies
  the lineage: resume from the latest complete checkpoint, monotone
  rollup counters across the restart, full round target reached.  The
  CLI is ``python -m repro_torch.launch.faults``; it runs on the card
  unless ``--device cpu`` is given.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map


# ----------------------------------------------------------------------
# agent crash / flap schedules
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AgentFault:
    """One agent's outage schedule.

    agent:
        Agent row index in the fleet.
    start:
        Round the agent first goes down.
    duration:
        Rounds per outage; 0 means a permanent crash.
    period:
        0 for a one-shot outage; >0 makes the agent *flap* — down for
        ``duration`` rounds at the start of every ``period``-round cycle
        (cycles counted from ``start``).
    """

    agent: int
    start: int
    duration: int = 0
    period: int = 0

    def down(self, round_index: int) -> bool:
        if round_index < self.start:
            return False
        if self.period > 0:
            return (round_index - self.start) % self.period < max(
                self.duration, 1)
        if self.duration == 0:
            return True  # permanent crash
        return round_index < self.start + self.duration


def fault_mask(faults: Sequence[AgentFault], num_agents: int,
               round_index: int) -> np.ndarray:
    """float32 ``(num_agents,)`` activity mask (1 = up) for one round."""
    mask = np.ones(num_agents, dtype=np.float32)
    for f in faults:
        if 0 <= f.agent < num_agents and f.down(round_index):
            mask[f.agent] = 0.0
    return mask


class FaultInjector:
    """``batch_fn`` wrapper applying an :class:`AgentFault` schedule.

    The session calls ``batch_fn(k)`` with the absolute round index, so
    the injector reads the round from its argument: the schedule stays
    aligned with the lineage's rounds across a resume, with no counter
    to carry.  Each call zeroes the leading (agent) axis rows of every
    batch tensor for the agents down in round ``k``.
    """

    def __init__(self, batch_fn: Callable, faults: Sequence[AgentFault],
                 num_agents: int):
        self._batch_fn = batch_fn
        self.faults = tuple(faults)
        self.num_agents = num_agents

    def __call__(self, k: int):
        batch = self._batch_fn(k)
        mask = fault_mask(self.faults, self.num_agents, k)
        if mask.min() >= 1.0:
            return batch
        m = torch.from_numpy(mask)

        def zero_down(x):
            rows = m.to(device=x.device, dtype=x.dtype)
            return x * rows.reshape((self.num_agents,) + (1,) * (x.ndim - 1))

        return tree_map(zero_down, batch)


def make_stall(at_round: int, seconds: float,
               on_round: Optional[Callable] = None,
               sleep: Callable = time.sleep) -> Callable:
    """An ``on_round`` callback that hangs round ``at_round`` for
    ``seconds`` (then delegates) — a deterministic stalled-round
    injection for watchdog coverage."""

    def _cb(k, metrics):
        if k == at_round:
            sleep(seconds)
        if on_round is not None:
            on_round(k, metrics)

    return _cb


# ----------------------------------------------------------------------
# SIGKILL-at-round-k subprocess driver
# ----------------------------------------------------------------------


class FaultDriverError(RuntimeError):
    """kill_and_resume lineage verification failure."""


def _serve_cmd(args: dict) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--fleet"]
    for flag, val in args.items():
        cmd += [flag, str(val)]
    return cmd


def _serve_env() -> dict:
    """This process's environment, with the directory that holds this
    ``repro_torch`` first on the subprocess's import path."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    return env


def _read_snapshot(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None  # not yet written


def _wait_for_round(path: str, round_index: int, proc: subprocess.Popen,
                    timeout: float) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = _read_snapshot(path)
        if snap is not None and snap.get("rounds", 0) >= round_index:
            return snap
        if proc.poll() is not None:
            snap = _read_snapshot(path)
            if snap is not None and snap.get("rounds", 0) >= round_index:
                return snap
            raise FaultDriverError(
                f"serve subprocess exited rc={proc.returncode} before "
                f"reaching round {round_index}")
        time.sleep(0.2)
    proc.kill()
    proc.wait(30)
    raise FaultDriverError(
        f"timed out waiting for round {round_index} in {path}")


def kill_and_resume(ckpt_dir: str, *, mix: str = "tiered_m64_adaptive",
                    rounds: int = 30, kill_round: int = 10,
                    ckpt_every: int = 5, log_every: int = 2,
                    seed: int = 0, timeout: float = 600.0,
                    device: DeviceLike = "cuda",
                    verbose: bool = True) -> dict:
    """SIGKILL a serving run on ``device`` at round ``kill_round``,
    relaunch with auto-resume, and verify the lineage reaches ``rounds``
    total with monotone rollup counters.  Returns the verification
    record (also the CLI's JSON output)."""
    from repro_torch import checkpoint as ckpt

    dev = resolve_device(device)  # no card: raise here, not in a child
    os.makedirs(ckpt_dir, exist_ok=True)
    tele = os.path.join(ckpt_dir, "telemetry.json")
    log_path = os.path.join(ckpt_dir, "serve.log")
    base = {
        "--mix": mix, "--seed": seed, "--ckpt-dir": ckpt_dir,
        "--ckpt-every": ckpt_every, "--telemetry-file": tele,
        "--log-every": log_every, "--device": str(dev),
    }
    env = _serve_env()

    def _say(msg):
        if verbose:
            print(f"[faults] {msg}", flush=True)

    with open(log_path, "ab") as log:
        # phase 1: serve toward the full target, SIGKILL mid-flight
        cmd = _serve_cmd({**base, "--rounds": rounds})
        _say(f"phase 1: {' '.join(cmd)}")
        proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=log)
        at_kill = _wait_for_round(tele, kill_round, proc, timeout)
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
        _say(f"SIGKILLed at observed round {at_kill['rounds']}")

        resume_round = ckpt.latest_step(ckpt_dir)
        if resume_round is None:
            raise FaultDriverError(
                f"no complete checkpoint under {ckpt_dir} after the kill")

        # phase 2: relaunch, auto-resume, run the remaining rounds;
        # drop phase 1's stale snapshot so recovery is measured against
        # the resumed process's own writes
        os.remove(tele)
        remaining = max(rounds - resume_round, 1)
        cmd = _serve_cmd({**base, "--rounds": remaining})
        _say(f"phase 2 (resume from round {resume_round}): "
             f"{' '.join(cmd)}")
        t0 = time.monotonic()
        proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=log)
        first = _wait_for_round(tele, resume_round + 1, proc, timeout)
        recovery_s = time.monotonic() - t0
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            raise FaultDriverError(
                f"resumed serve did not finish in {timeout} s") from None
        if rc != 0:
            raise FaultDriverError(f"resumed serve exited rc={rc}, see "
                                   f"{log_path}")

    final = _read_snapshot(tele)
    if final is None:
        raise FaultDriverError(f"no final telemetry snapshot at {tele}")
    record = {
        "mix": mix, "seed": seed, "device": str(dev),
        "rounds_target": rounds, "kill_round": kill_round,
        "rounds_at_kill": at_kill["rounds"],
        "resume_round": resume_round,
        "recovery_s": recovery_s,
        "restarts": final.get("restarts", 0),
        "rounds_final": final["rounds"],
        "wire_bytes_at_kill": at_kill["counters"]["wire_bytes"],
        "wire_bytes_final": final["counters"]["wire_bytes"],
        "degradation_events": final.get("degradation_events", {}),
    }
    problems = []
    if record["restarts"] < 1:
        problems.append("rollup never recorded the restart")
    if record["rounds_final"] < rounds:
        problems.append(
            f"lineage stopped at round {record['rounds_final']} "
            f"< target {rounds}")
    if record["rounds_final"] <= record["rounds_at_kill"] or \
            record["wire_bytes_final"] < record["wire_bytes_at_kill"]:
        problems.append("rollup counters not monotone across the restart")
    if first["rounds"] <= resume_round:
        problems.append("resumed session did not advance past its "
                        "checkpoint")
    record["ok"] = not problems
    if problems:
        raise FaultDriverError("; ".join(problems) + f" — {record}")
    _say(f"lineage ok: {record['rounds_final']} rounds, "
         f"{record['restarts']} restart(s), "
         f"recovery {recovery_s:.2f}s")
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="SIGKILL-and-resume smoke driver over serve --fleet")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--mix", default="tiered_m64_adaptive")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--kill-round", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--log-every", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--json", default=None,
                    help="write the verification record to this path")
    args = ap.parse_args(argv)
    record = kill_and_resume(
        args.ckpt_dir, mix=args.mix, rounds=args.rounds,
        kill_round=args.kill_round, ckpt_every=args.ckpt_every,
        log_every=args.log_every, seed=args.seed, timeout=args.timeout,
        device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
