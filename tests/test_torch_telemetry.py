"""The port's ``CommRollup`` exports against the JAX package's, on the CPU.

The JAX package's golden tests (``tests/test_telemetry.py``: the
snapshot, the Prometheus text, the lossy keys, churn, thread safety)
run here against the port's rollup, under their deterministic clock.
The state a checkpoint carries (``state_dict`` → ``load_state``, the
restart and degradation records) is held to ``repro.comm.rollup`` on the
same updates, and crosses between the packages.
"""
import json

import numpy as np
import pytest

import test_telemetry as JT
from repro.comm.rollup import CommRollup as JCommRollup
from repro_torch.comm.rollup import CommRollup

GOLDENS = (
    "test_snapshot_golden",
    "test_prometheus_golden",
    "test_empty_rollup_exports_cleanly",
    "test_lossy_keys_roll_up",
    "test_churn_snapshot_golden",
    "test_churn_prometheus_series",
    "test_counters_monotone_under_churn",
    "test_tier_names_without_index_rejected",
    "test_concurrent_producers_lose_no_updates",
)


@pytest.mark.parametrize("golden", GOLDENS)
def test_port_rollup_meets_the_jax_goldens(monkeypatch, golden):
    monkeypatch.setattr(JT, "CommRollup", CommRollup)
    getattr(JT, golden)()


TIERS = dict(tier_names=("edge", "core"), tier_index=(0, 0, 1, 1),
             budgets=(10.0, 10.0, float("inf"), float("inf")))


def _updates(rounds: int, seed: int = 0):
    """Seeded per-round metric dicts with every key the rollup reads."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(rounds):
        tx = (rng.random(4) < 0.6).astype(np.float32)
        active = np.ones(4, np.float32) if k % 3 else np.array(
            [1, 0, 1, 1], np.float32)
        out.append({
            "loss": np.float32(1.0 / (k + 1)),
            "comm_rate": np.float32(tx.mean()),
            "num_tx": np.float32(tx.sum()),
            "wire_bytes": np.float32(16.0 * tx.sum()),
            "wire_bytes_attempted": np.float32(20.0 * tx.sum()),
            "num_delivered": np.float32(tx.sum()),
            "mean_staleness": np.float32(rng.random()),
            "num_active": np.float32(active.sum()),
            "agent_active": active,
            "agent_tx": tx * active,
            "agent_bytes": 16.0 * tx * active,
            "agent_lam": rng.random(4).astype(np.float32),
        })
    return out


def _pair(updates):
    clock = (JT.make_clock(), JT.make_clock())
    port = CommRollup(**TIERS, clock=clock[0])
    ref = JCommRollup(**TIERS, clock=clock[1])
    for u in updates:
        port.update(u)
        ref.update(u)
    return port, ref


def test_state_dict_restart_and_degradation_match_jax():
    port, ref = _pair(_updates(7))
    for roll in (port, ref):
        roll.record_degradation("stall")
        roll.record_degradation("stall")
        roll.record_degradation("crash")
    assert json.dumps(port.state_dict(), sort_keys=True) == json.dumps(
        ref.state_dict(), sort_keys=True)
    assert port.snapshot() == ref.snapshot()
    assert port.to_prometheus() == ref.to_prometheus()

    # each package loads the other's state (a checkpoint's "rollup"),
    # records the restart and keeps counting
    port_next = CommRollup(**TIERS, clock=JT.make_clock())
    ref_next = JCommRollup(**TIERS, clock=JT.make_clock())
    port_next.load_state(json.loads(json.dumps(ref.state_dict())))
    ref_next.load_state(json.loads(json.dumps(port.state_dict())))
    for roll in (port_next, ref_next):
        roll.record_restart()
        for u in _updates(3, seed=1):
            roll.update(u)
    a, b = port_next.snapshot(), ref_next.snapshot()
    assert a == b
    assert a["restarts"] == 1 and a["rounds"] == 10
    assert a["degradation_events"] == {"stall": 2, "crash": 1}
    assert port_next.to_prometheus() == ref_next.to_prometheus()
    assert all(a["counters"][k] >= port.snapshot()["counters"][k]
               for k in a["counters"])


def test_load_state_rejects_another_scenario():
    src = CommRollup(tier_names=("a",), tier_index=(0, 0),
                     budgets=(10.0, 10.0))
    src.update({"loss": 1.0, "agent_bytes": np.full(2, 1.0)})
    dst = CommRollup(tier_names=("a", "b"), tier_index=(0, 1),
                     budgets=(10.0, 20.0))
    with pytest.raises(ValueError, match="scenario mismatch"):
        dst.load_state(src.state_dict())
