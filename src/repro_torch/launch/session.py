"""FleetSession — the fleet serving loop on the card.

The port of ``repro.launch.session``'s ``FleetSession.run`` and
``build_linreg_fleet_session``: continuous per-round observation batches
fed into the triggered train step, with every round's metrics folded
into a :class:`~repro_torch.comm.rollup.CommRollup`.

Overlap discipline (the double buffer): round k is dispatched to the
card (PyTorch returns before the device finishes), round k+1's batch is
drawn while the device works, and only then are round k's metrics
pulled to the host.  The batch for round k comes from a
``torch.Generator`` seeded from ``(seed, k)``, so a run is reproducible
round by round; tests inject ``batch_fn`` to feed JAX-drawn batches.

Checkpointing, the watchdog, the telemetry HTTP server and the
``serve.py`` CLI are not ported yet.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch.comm.rollup import CommRollup
from repro_torch.data.synthetic import step_generator
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.todo import not_ported, todo

_SERVING_ITEM = "queue 1 item 9"


class FleetSession:
    """Continuous train-on-arrival loop over a triggered train step.

    ``step_fn(state, batch) -> (state, metrics)`` is the train step;
    ``batch_fn(k) -> batch`` draws round ``k``'s per-agent observations;
    every round's metrics (pulled to numpy) stream into ``rollup`` and
    then, if given, ``on_round(k, metrics)``.
    """

    def __init__(self, step_fn: Callable, state, batch_fn: Callable,
                 rollup: CommRollup, *,
                 on_round: Optional[Callable] = None):
        self._step = step_fn
        self._state = state
        self._batch_fn = batch_fn
        self.rollup = rollup
        self._on_round = on_round
        self._round = 0

    @property
    def state(self):
        """The latest TrainState (read it between rounds)."""
        return self._state

    @property
    def step_fn(self) -> Callable:
        """The train step the session drives."""
        return self._step

    @property
    def round_index(self) -> int:
        """The next round to run (== rounds completed)."""
        return self._round

    def run(self, rounds: int) -> int:
        """Run ``rounds`` more rounds; returns the number run."""
        if rounds <= 0:
            raise todo("serving until stop() (rounds=0)", _SERVING_ITEM)
        k, target = self._round, self._round + rounds
        batch = self._batch_fn(k)
        while k < target:
            # 1. dispatch round k (returns before the card finishes)
            self._state, metrics = self._step(self._state, batch)
            # 2. draw round k+1's observations in the card's shadow
            if k + 1 < target:
                batch = self._batch_fn(k + 1)
            # 3. pull round k's metrics (waits for the card), roll up
            metrics = {name: v.cpu().numpy() for name, v in metrics.items()}
            self.rollup.update(metrics)
            if self._on_round is not None:
                self._on_round(k, metrics)
            k += 1
            self._round = k
        return rounds


def build_linreg_fleet_session(
    net=None, cfg_lr=None, *, lam_base: float = 1.0, seed: int = 0,
    device: DeviceLike = "cuda", window: int = 64,
    clock: Callable[[], float] = time.monotonic,
    on_round: Optional[Callable] = None,
    batch_fn: Optional[Callable] = None,
    churn: Optional[Tuple[Tuple[int, int], ...]] = None,
) -> FleetSession:
    """A :class:`FleetSession` serving the paper's linreg fleet on
    ``device``.

    ``net`` defaults to the budget-adaptive m=64 mix
    ``TIERED_M64_ADAPTIVE``, as in the JAX package: its metered tiers
    run ``budget_window``/``budget_dual`` controllers whose rows the
    state carries; any other :class:`TieredNetwork` may be passed: the
    fixed-λ ``TIERED_M64_QUADRATIC``, or a fleet over lossy or delayed
    wires (``TIERED_M64_LOSSY``, ``TIERED_M64_ADAPTIVE_LOSSY``,
    ``TIERED_M64_DELAYED``, ``TIERED_M64_ADAPTIVE_DELAYED``, ...), whose
    channel rows and delay lines the state then carries and whose
    delivered bytes the rollup counts.  ``churn`` is a per-agent
    ``(join, leave)`` schedule (``StepOptions.churn``, e.g.
    ``churn_schedule(net, rounds)``).  ``cfg_lr`` defaults to
    ``TIERED_M64_CFG``.  The problem is drawn from ``seed`` and round
    ``k``'s batch from ``(seed + 1, k)``; ``batch_fn(k)`` replaces that
    stream when given.
    """
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.paper_linreg import (
        TIERED_M64_ADAPTIVE,
        TIERED_M64_CFG,
    )
    from repro_torch.core import regression as R
    from repro_torch.core.api import (
        StepOptions,
        init_train_state,
        make_triggered_train_step,
    )
    from repro_torch.optim import optimizers as opt_lib

    dev = resolve_device(device)
    net = net or TIERED_M64_ADAPTIVE
    cfg_lr = cfg_lr or TIERED_M64_CFG
    if net.num_agents != cfg_lr.num_agents:
        raise ValueError(
            f"network {net.name} has {net.num_agents} agents but problem "
            f"{cfg_lr.name} expects {cfg_lr.num_agents}")

    def loss_fn(params, batch):
        xs, ys = batch
        r = xs @ params["w"] - ys
        return 0.5 * torch.mean(r * r)

    cfg = TrainConfig(lr=cfg_lr.stepsize, optimizer="sgd",
                      num_agents=cfg_lr.num_agents,
                      comm=net.policies(lam_base=lam_base))
    opt = opt_lib.from_config(cfg)
    step_fn = make_triggered_train_step(
        loss_fn, opt, cfg,
        options=StepOptions(agent_metrics=True, churn=churn), device=dev)
    state = init_train_state(
        {"w": torch.zeros(cfg_lr.n, dtype=torch.float32)}, opt, cfg,
        device=dev)
    if batch_fn is None:
        problem = R.make_problem(cfg_lr, step_generator(seed, 0, dev),
                                 device=dev)

        def batch_fn(k):
            return R.agent_batches(problem,
                                   step_generator(seed + 1, k, dev))

    rollup = CommRollup(
        tier_names=tuple(t.name for t in net.tiers),
        tier_index=net.tier_index(),
        budgets=net.budgets(),
        window=window, clock=clock)
    return FleetSession(step_fn, state, batch_fn, rollup, on_round=on_round)


__getattr__ = not_ported(__name__, {
    name: _SERVING_ITEM
    for name in ("SessionOptions", "Watchdog", "TelemetryServer",
                 "file_sink")
})
