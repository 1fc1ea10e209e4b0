"""CommRollup — lock-guarded streaming telemetry over CommStats rounds.

A numpy-only copy of ``repro.comm.rollup`` (the port imports nothing of
the JAX package); the JAX and torch sessions feed it the same metric
dicts, so their snapshots compare key for key.

The train step already emits everything an operator needs — per-round
``CommStats`` scalars plus the per-agent vectors behind them
(``agent_tx``/``agent_bytes``, λ trajectories from the budget
controllers, attempted-vs-delivered accounting on lossy channels) — but
in the batch drivers those signals vanish when the run exits.  The
rollup is the missing accumulation layer for a *long-running* fleet
endpoint: one ``update(metrics)`` per round folds a
step's metric dict into streaming aggregates, and ``snapshot()`` /
``to_prometheus()`` export them at any moment without pausing training.

Design constraints the implementation answers:

* **Thread safety.** The serving loop updates from its train thread
  while HTTP scrapes and file sinks read concurrently; one
  ``threading.Lock`` guards all mutation and every export reads a
  consistent cut.  (Plain Python ``+=`` on an int is NOT atomic across
  the reader's ``snapshot``.)
* **Deterministic exports.** The wall clock is injectable
  (``clock=``), so golden tests pin byte-exact JSON and Prometheus
  output; production uses ``time.monotonic``.
* **Tier resolution.** Fleet scenarios (``TieredNetwork``) hand the
  rollup their agent→tier map and per-agent byte budgets; per-tier
  transmit rates, delivered bytes, λ EWMAs and budget-violation
  counters fall out of the same per-agent vectors the frontier
  benchmarks already check budgets against — serving telemetry and
  benchmark accounting cannot drift apart.

Prometheus naming: every metric is prefixed ``fleet_``; counters end in
``_total``; per-tier series carry a ``tier="<name>"`` label.  The text
format is the v0.0.4 exposition format every Prometheus scraper speaks.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence

import numpy as np

# scalar metric keys exported as last-value gauges when present
_GAUGE_KEYS = ("loss", "comm_rate", "any_tx", "mean_gain", "grad_norm",
               "delivered_rate", "mean_staleness", "num_active")
# scalar metric keys accumulated as counters when present
_COUNTER_KEYS = ("num_tx", "wire_bytes", "wire_bytes_attempted",
                 "num_delivered")


class CommRollup:
    """Streaming rollup over per-round train-step metric dicts.

    Parameters
    ----------
    tier_names:
        One name per tier (defines the export order).  ``None`` disables
        the per-tier section entirely.
    tier_index:
        Agent → tier id, length m (``TieredNetwork.tier_index()``).
    budgets:
        Per-agent wire budgets in bytes/round
        (``TieredNetwork.budgets()``); an agent whose delivered bytes
        exceed its budget in a round counts one violation.  ``inf``
        budgets never fire.
    lam_alpha:
        EWMA coefficient for the per-tier λ trajectories
        (``ewma ← (1−α)·ewma + α·tier_mean``).
    window:
        Number of recent update timestamps kept for the windowed
        rounds/sec estimate (the overall estimate uses the full run).
    clock:
        0-arg callable returning seconds; injectable for deterministic
        tests.  Defaults to ``time.monotonic``.
    """

    def __init__(self, *, tier_names: Optional[Sequence[str]] = None,
                 tier_index: Optional[Sequence[int]] = None,
                 budgets: Optional[Sequence[float]] = None,
                 lam_alpha: float = 0.1, window: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        if tier_names is not None and tier_index is None:
            raise ValueError("tier_names requires tier_index (agent→tier)")
        self._lock = threading.Lock()
        self._clock = clock
        self._lam_alpha = float(lam_alpha)
        self._tier_names = tuple(tier_names) if tier_names else ()
        self._tier_index = (np.asarray(tier_index, np.int64)
                            if tier_index is not None else None)
        self._budgets = (np.asarray(budgets, np.float64)
                         if budgets is not None else None)
        T = len(self._tier_names)
        self._tier_agents = (
            np.array([int((self._tier_index == t).sum()) for t in range(T)])
            if T else np.zeros(0, np.int64))
        # --- mutable state (all guarded by _lock) ---
        self.rounds = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._stamps: deque = deque(maxlen=max(int(window), 2))
        self._gauges: Dict[str, float] = {}
        self._counters: Dict[str, float] = {}
        self._tier_tx = np.zeros(T)
        self._tier_bytes = np.zeros(T)
        self._tier_lam_ewma = np.full(T, np.nan)
        self._tier_violations = np.zeros(T, np.int64)
        self._violation_rounds = 0
        # per-tier ACTIVE agent-round denominators: under scenario churn
        # (an ``agent_active`` mask in the metrics) only joined agents
        # count toward the per-tier rate denominators; churn-free
        # streams accumulate rounds × tier size exactly as before
        self._tier_possible = np.zeros(T)
        self._saw_churn = False
        # fault-tolerance bookkeeping: degradation events by
        # kind (watchdog stalls, injected faults), process restarts
        # (checkpoint resumes), and rounds served SINCE the last
        # restart — throughput estimates use the live count so a
        # resumed session reports honest rounds/sec while the monotone
        # ``rounds`` counter keeps the whole history
        self._degradation: Dict[str, int] = {}
        self._restarts = 0
        self._rounds_live = 0

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def update(self, metrics: Dict[str, object]) -> None:
        """Fold one round's metric dict into the rollup.

        Accepts exactly what the train step returns (device arrays are
        fine — values are pulled through ``np.asarray``).  Unknown keys
        are ignored; per-agent keys are tier-reduced only when the
        rollup was built with a tier map.
        """
        scal = {k: float(np.asarray(metrics[k]))
                for k in _GAUGE_KEYS + _COUNTER_KEYS if k in metrics}
        idx = self._tier_index
        agent_tx = agent_bytes = agent_lam = agent_active = None
        if idx is not None:
            if "agent_tx" in metrics:
                agent_tx = np.asarray(metrics["agent_tx"], np.float64)
            if "agent_bytes" in metrics:
                agent_bytes = np.asarray(metrics["agent_bytes"], np.float64)
            if "agent_lam" in metrics:
                agent_lam = np.asarray(metrics["agent_lam"], np.float64)
            if "agent_active" in metrics:
                agent_active = np.asarray(
                    metrics["agent_active"], np.float64)
        now = self._clock()
        with self._lock:
            self.rounds += 1
            self._rounds_live += 1
            if self._t_first is None:
                self._t_first = now
            self._t_last = now
            self._stamps.append(now)
            for k in _GAUGE_KEYS:
                if k in scal:
                    self._gauges[k] = scal[k]
            for k in _COUNTER_KEYS:
                if k in scal:
                    self._counters[k] = self._counters.get(k, 0.0) + scal[k]
            T = len(self._tier_names)
            if agent_active is not None:
                self._saw_churn = True
            for t in range(T):
                mask = idx == t
                if agent_active is not None:
                    act_mask = mask & (agent_active > 0.5)
                    self._tier_possible[t] += float(act_mask.sum())
                else:
                    act_mask = mask
                    self._tier_possible[t] += float(self._tier_agents[t])
                if agent_tx is not None:
                    self._tier_tx[t] += float(agent_tx[mask].sum())
                if agent_bytes is not None:
                    self._tier_bytes[t] += float(agent_bytes[mask].sum())
                if agent_lam is not None and act_mask.any():
                    # λ EWMAs track ACTIVE agents only — a fully-parked
                    # tier holds its last estimate instead of averaging
                    # frozen controller rows into it
                    mean = float(agent_lam[act_mask].mean())
                    prev = self._tier_lam_ewma[t]
                    self._tier_lam_ewma[t] = (
                        mean if np.isnan(prev)
                        else (1.0 - self._lam_alpha) * prev
                        + self._lam_alpha * mean)
            if (self._budgets is not None and agent_bytes is not None):
                over = agent_bytes > self._budgets + 1e-6
                if over.any():
                    self._violation_rounds += 1
                    for t in range(T):
                        self._tier_violations[t] += int(over[idx == t].sum())

    def record_degradation(self, kind: str) -> None:
        """Count one degradation event (watchdog stall, injected fault,
        ...) under ``kind``; exported as
        ``fleet_degradation_events_total{kind=...}`` once any exist."""
        with self._lock:
            self._degradation[kind] = self._degradation.get(kind, 0) + 1

    def record_restart(self) -> None:
        """Count one process restart (a checkpoint resume)."""
        with self._lock:
            self._restarts += 1

    # ------------------------------------------------------------------
    # persistence (the FleetSession checkpoint path)
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable cut of everything a restart must carry.

        Wall-clock state (timestamps) is deliberately NOT included:
        after :meth:`load_state` the throughput estimates restart from
        zero live rounds while every counter stays monotone.
        """
        with self._lock:
            return {
                "rounds": self.rounds,
                "gauges": dict(self._gauges),
                "counters": dict(self._counters),
                "tier_tx": self._tier_tx.tolist(),
                "tier_bytes": self._tier_bytes.tolist(),
                "tier_lam_ewma": [
                    None if np.isnan(v) else float(v)
                    for v in self._tier_lam_ewma
                ],
                "tier_violations": self._tier_violations.tolist(),
                "violation_rounds": self._violation_rounds,
                "tier_possible": self._tier_possible.tolist(),
                "saw_churn": self._saw_churn,
                "degradation": dict(self._degradation),
                "restarts": self._restarts,
            }

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`state_dict` cut (tier layout must match)."""
        T = len(self._tier_names)
        for key in ("tier_tx", "tier_bytes", "tier_lam_ewma",
                    "tier_violations", "tier_possible"):
            if len(state[key]) != T:
                raise ValueError(
                    f"rollup state {key!r} has {len(state[key])} tiers, "
                    f"this rollup has {T} — scenario mismatch"
                )
        with self._lock:
            self.rounds = int(state["rounds"])
            self._rounds_live = 0
            self._t_first = self._t_last = None
            self._stamps.clear()
            self._gauges = {k: float(v)
                            for k, v in state["gauges"].items()}
            self._counters = {k: float(v)
                              for k, v in state["counters"].items()}
            self._tier_tx = np.asarray(state["tier_tx"], np.float64)
            self._tier_bytes = np.asarray(state["tier_bytes"], np.float64)
            self._tier_lam_ewma = np.asarray(
                [np.nan if v is None else v
                 for v in state["tier_lam_ewma"]], np.float64)
            self._tier_violations = np.asarray(
                state["tier_violations"], np.int64)
            self._violation_rounds = int(state["violation_rounds"])
            self._tier_possible = np.asarray(
                state["tier_possible"], np.float64)
            self._saw_churn = bool(state["saw_churn"])
            self._degradation = {k: int(v) for k, v in
                                 state.get("degradation", {}).items()}
            self._restarts = int(state.get("restarts", 0))

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """A JSON-ready consistent cut of the rollup."""
        with self._lock:
            # throughput over LIVE rounds (since construction or the
            # last load_state): a resumed session's restored round
            # count must not inflate its rounds/sec; on fresh rollups
            # rounds == _rounds_live and this is the classic estimate
            live = self._rounds_live
            elapsed = ((self._t_last - self._t_first)
                       if live and self._t_last is not None else 0.0)
            overall = ((live - 1) / elapsed
                       if live > 1 and elapsed > 0 else 0.0)
            stamps = list(self._stamps)
            span = stamps[-1] - stamps[0] if len(stamps) > 1 else 0.0
            windowed = (len(stamps) - 1) / span if span > 0 else overall
            snap = {
                "rounds": self.rounds,
                "elapsed_s": round(elapsed, 6),
                "rounds_per_sec": round(overall, 6),
                "rounds_per_sec_window": round(windowed, 6),
                "gauges": {k: self._gauges[k]
                           for k in _GAUGE_KEYS if k in self._gauges},
                "counters": {k: self._counters[k]
                             for k in _COUNTER_KEYS if k in self._counters},
                "budget_violation_rounds": self._violation_rounds,
            }
            # fault-tolerance section: present only once an event or a
            # restart exists, so fault-free streams keep their exact
            # fault-free exports (the byte-golden contract)
            if self._restarts:
                snap["restarts"] = self._restarts
            if self._degradation:
                snap["degradation_events"] = dict(
                    sorted(self._degradation.items()))
            att = self._counters.get("wire_bytes_attempted")
            if att:
                # lossy channels: fraction of attempted bytes delivered
                snap["delivered_byte_frac"] = round(
                    self._counters.get("wire_bytes", 0.0) / att, 6)
            if self._tier_names:
                tiers = {}
                # ACTIVE agent-rounds; equals rounds × tier size exactly
                # on churn-free streams (no agent_active mask ever seen)
                possible = self._tier_possible
                for t, name in enumerate(self._tier_names):
                    row = {
                        "agents": int(self._tier_agents[t]),
                        "tx_total": self._tier_tx[t],
                        "tx_rate": round(
                            self._tier_tx[t] / possible[t], 6
                        ) if possible[t] else 0.0,
                        "bytes_total": round(self._tier_bytes[t], 3),
                        "bytes_per_agent_round": round(
                            self._tier_bytes[t] / possible[t], 6
                        ) if possible[t] else 0.0,
                        "violations": int(self._tier_violations[t]),
                    }
                    if self._saw_churn:
                        row["active_agent_rounds"] = round(
                            float(possible[t]), 3)
                    if self._budgets is not None:
                        b = float(self._budgets[self._tier_index == t][0])
                        row["budget_bytes_per_round"] = (
                            b if np.isfinite(b) else None)
                    if not np.isnan(self._tier_lam_ewma[t]):
                        row["lam_ewma"] = round(
                            float(self._tier_lam_ewma[t]), 6)
                    tiers[name] = row
                snap["tiers"] = tiers
            return snap

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4) of the current snapshot."""
        s = self.snapshot()
        out = []

        def emit(name, kind, help_, value, labels=""):
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            out.append(f"{name}{labels} {_fmt(value)}")

        emit("fleet_rounds_total", "counter",
             "Training rounds completed by the serving loop.", s["rounds"])
        emit("fleet_uptime_seconds", "gauge",
             "Seconds between first and latest round.", s["elapsed_s"])
        emit("fleet_rounds_per_sec", "gauge",
             "Overall training throughput (rounds/sec).",
             s["rounds_per_sec"])
        emit("fleet_rounds_per_sec_window", "gauge",
             "Windowed training throughput (rounds/sec).",
             s["rounds_per_sec_window"])
        gauge_help = {
            "loss": "Latest round's training loss.",
            "comm_rate": "Latest round's fleet transmit fraction.",
            "any_tx": "1 if any agent transmitted in the latest round.",
            "mean_gain": "Latest round's mean estimated gain.",
            "grad_norm": "Latest round's aggregated gradient norm.",
            "delivered_rate": "Latest round's delivered-transmission rate.",
            "mean_staleness": "Latest round's mean EF staleness (rounds).",
            "num_active": "Latest round's active (joined) agent count.",
        }
        for k, v in s["gauges"].items():
            emit(f"fleet_{k}", "gauge", gauge_help[k], v)
        counter_help = {
            "num_tx": "Transmissions attempted, cumulative.",
            "wire_bytes": "Effective (delivered) wire bytes, cumulative.",
            "wire_bytes_attempted": "Attempted wire bytes, cumulative.",
            "num_delivered": "Transmissions delivered, cumulative.",
        }
        for k, v in s["counters"].items():
            emit(f"fleet_{k}_total", "counter", counter_help[k], v)
        emit("fleet_budget_violation_rounds_total", "counter",
             "Rounds with at least one agent over its wire budget.",
             s["budget_violation_rounds"])
        if "delivered_byte_frac" in s:
            emit("fleet_delivered_byte_frac", "gauge",
                 "Cumulative delivered/attempted wire-byte ratio.",
                 s["delivered_byte_frac"])
        if "restarts" in s:
            emit("fleet_restarts_total", "counter",
                 "Process restarts (checkpoint resumes), cumulative.",
                 s["restarts"])
        if "degradation_events" in s:
            out.append("# HELP fleet_degradation_events_total Degradation "
                       "events (watchdog stalls, injected faults), "
                       "cumulative.")
            out.append("# TYPE fleet_degradation_events_total counter")
            for kind, n in s["degradation_events"].items():
                out.append(
                    f'fleet_degradation_events_total{{kind="{kind}"}} '
                    f"{_fmt(n)}")
        for metric, kind, help_, key in (
            ("fleet_tier_agents", "gauge", "Agents in the tier.", "agents"),
            ("fleet_tier_tx_rate", "gauge",
             "Cumulative per-tier transmit rate.", "tx_rate"),
            ("fleet_tier_wire_bytes_total", "counter",
             "Per-tier delivered wire bytes, cumulative.", "bytes_total"),
            ("fleet_tier_bytes_per_agent_round", "gauge",
             "Per-tier delivered bytes per agent per round.",
             "bytes_per_agent_round"),
            ("fleet_tier_lam_ewma", "gauge",
             "EWMA of the tier's controller threshold lambda.", "lam_ewma"),
            ("fleet_tier_budget_violations_total", "counter",
             "Per-tier agent-round budget violations, cumulative.",
             "violations"),
            ("fleet_tier_active_agent_rounds_total", "counter",
             "Per-tier ACTIVE agent-rounds under scenario churn, "
             "cumulative.", "active_agent_rounds"),
        ):
            rows = [(name, row[key]) for name, row in
                    s.get("tiers", {}).items() if key in row]
            if not rows:
                continue
            out.append(f"# HELP {metric} {help_}")
            out.append(f"# TYPE {metric} {kind}")
            for name, value in rows:
                out.append(f'{metric}{{tier="{name}"}} {_fmt(value)}')
        return "\n".join(out) + "\n"


def _fmt(v) -> str:
    """Prometheus sample formatting: integral floats print as ints."""
    if v is None:
        return "NaN"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)
