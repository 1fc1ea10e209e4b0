"""FleetSession — the long-running fleet serving loop on the card (port
of ``repro.launch.session``).

A fleet of agents streams observations into a learner indefinitely,
with budgets monitored over time.  A ``FleetSession`` is that loop:
continuous per-round observation batches fed into the triggered train
step, with every round's metrics folded into a live
:class:`~repro_torch.comm.rollup.CommRollup` that HTTP scrapes and file
sinks read while training runs.

Overlap discipline (the double buffer): round k is dispatched to the
card (PyTorch returns before the device finishes), round k+1's batch is
drawn while the device works, and only then are round k's metrics
pulled to the host.  Round k's batch is ``batch_fn(k)``, keyed by the
absolute round index: the builder draws it from a ``torch.Generator``
seeded from ``(seed + 1, k)``, and tests inject ``batch_fn`` to feed
JAX-drawn batches.

Run modes:

* ``run(rounds)`` — blocking loop, ``rounds=0`` means until ``stop()``.
* ``start()`` / ``stop()`` — the same loop on a daemon thread, for
  embedding under a CLI that also serves HTTP.  Every caller that
  starts the thread calls ``stop()``, so no CUDA work is left running
  when the interpreter exits.

``serve_telemetry()`` attaches a :class:`TelemetryServer` exposing
``/stats.json`` (rollup snapshot) and ``/metrics`` (Prometheus text);
``python -m repro_torch.launch.serve --fleet`` is the CLI around all of
this.

Durability: a :class:`SessionOptions` with ``ckpt_dir`` set arms
crash-safe checkpointing through ``repro_torch.checkpoint``, in the JAX
package's format — every ``ckpt_every`` rounds the TrainState, the PRNG
key, the round index and the rollup's state are written atomically, and
a relaunched session auto-resumes from the latest complete checkpoint
(either package's) with the same observation stream (the batches are
keyed by the restored round index) and monotone rollup counters.
``watchdog_timeout`` arms a :class:`Watchdog` that flags stalled rounds
as a ``"stall"`` degradation event without killing the loop.

Sharded serving: with a ``mesh`` of gateway ranks every rank runs its
own session over its own agents (the fleet-sharded step,
:mod:`repro_torch.sharding.agent_shard`), and its rollup counts the
tiers of those agents; the scalar counters are the fleet's.  A
checkpoint is written by rank 0 from the gathered state, in the JAX
package's format, with every gateway's rollup beside it; on restore
every rank takes its slice.  A sharded session's checkpoint restores in
an unsharded session of either package (whose rollup then starts
afresh), and the other way round.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import random as prng
from repro_torch.comm.rollup import CommRollup
from repro_torch.data.synthetic import step_generator
from repro_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SessionOptions:
    """Durability knobs for a :class:`FleetSession`.

    ckpt_dir:
        Checkpoint directory; ``None`` (default) disables checkpointing
        and resume entirely.
    ckpt_every:
        Write a checkpoint every N completed rounds (0 = only explicit
        :meth:`FleetSession.checkpoint` calls).
    resume:
        Auto-restore from the latest complete checkpoint under
        ``ckpt_dir`` at construction time (no-op when none exists).
    watchdog_timeout:
        Seconds without a completed round before the watchdog records a
        ``"stall"`` degradation event (0 disables the watchdog).
    """

    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    resume: bool = True
    watchdog_timeout: float = 0.0


class Watchdog:
    """Flags stalled rounds as rollup degradation events.

    The serving loop calls :meth:`beat` after every completed round;
    :meth:`check` compares the time since the last beat against
    ``timeout`` and records one ``"stall"`` event per stall episode
    (re-armed by the next beat) — the session keeps running, the event
    stream is the signal.  ``check`` takes an explicit ``now`` so tests
    drive it synchronously; :meth:`start` runs it on a daemon thread.
    """

    def __init__(self, rollup: CommRollup, timeout: float, *,
                 clock=time.monotonic):
        self.rollup = rollup
        self.timeout = float(timeout)
        self._clock = clock
        self._last = clock()
        self._flagged = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last = self._clock()
        self._flagged = False

    def check(self, now: Optional[float] = None) -> bool:
        """Returns True iff this call newly flagged a stall."""
        now = self._clock() if now is None else now
        if not self._flagged and now - self._last > self.timeout:
            self._flagged = True
            self.rollup.record_degradation("stall")
            return True
        return False

    def start(self) -> None:
        def _loop():
            while not self._stop.wait(max(self.timeout / 4.0, 0.01)):
                self.check()

        self._thread = threading.Thread(
            target=_loop, name="fleet-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None


class FleetSession:
    """Continuous train-on-arrival loop over a triggered train step.

    Parameters
    ----------
    step_fn:
        The ``(state, batch) -> (state, metrics)`` train step
        (``make_triggered_train_step`` output).
    state:
        Initial TrainState (``init_train_state``).
    batch_fn:
        ``batch_fn(k) -> batch`` — round ``k``'s per-agent observation
        batch, keyed by the absolute round index.
    rollup:
        The :class:`CommRollup` every round's metrics stream into.
    key:
        A ``repro_torch.random`` key (default ``PRNGKey(0)``), the JAX
        session's observation key.  The port's batches do not read it;
        it travels in the checkpoint so that both packages' checkpoints
        hold the same leaves.
    on_round:
        Optional ``on_round(round_index, metrics_dict)`` host callback
        (logging, file sinks); runs outside the rollup lock.
    options:
        :class:`SessionOptions` durability knobs.  When ``ckpt_dir`` is
        set and ``resume`` is on, construction restores the latest
        complete checkpoint (state, key, round index, rollup) before the
        first round runs.
    mesh:
        The gateway mesh of a sharded ``step_fn`` (``state`` is then
        this rank's); every rank constructs its session, and the
        checkpoints gather and scatter the per-agent slots over it.
    """

    def __init__(self, step_fn: Callable, state, batch_fn: Callable,
                 rollup: CommRollup, *, key: Optional[torch.Tensor] = None,
                 on_round: Optional[Callable] = None,
                 options: Optional[SessionOptions] = None, mesh=None):
        self._mesh = mesh
        self._step = step_fn
        self._state = state
        self._batch_fn = batch_fn
        self.rollup = rollup
        self._key = key if key is not None else prng.PRNGKey(0)
        self._on_round = on_round
        self.options = options or SessionOptions()
        self._round = 0
        self._watchdog: Optional[Watchdog] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if self.options.ckpt_dir and self.options.resume:
            self._try_resume()

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
        """The next round to run (== rounds completed this lineage,
        across restarts)."""
        return self._round

    # -- durability ----------------------------------------------------

    def _ckpt_tree(self):
        """The tree a session checkpoint round-trips: the full TrainState
        (gathered from every gateway when sharded: a collective) and the
        key's two words as uint32, as the JAX session writes
        ``key_data`` of its key."""
        state = self._state
        if self._mesh is not None:
            from repro_torch.sharding.agent_shard import gather_agents

            state = gather_agents(state, self._mesh)
        return {"state": state,
                "key": self._key.cpu().numpy().astype(np.uint32)}

    def checkpoint(self) -> Optional[int]:
        """Atomically persist the session at its current round (the state
        is pulled to the host: one sync); returns the checkpoint step
        (the round index) or None when disabled.  Sharded, every rank
        calls it and rank 0 writes."""
        if not self.options.ckpt_dir:
            return None
        tree = self._ckpt_tree()
        if self._mesh is None:
            extra = {"round": self._round,
                     "rollup": self.rollup.state_dict()}
            ckpt.save(self.options.ckpt_dir, self._round, tree, extra=extra)
            return self._round
        rollups = self._mesh.all_gather_object(self.rollup.state_dict(),
                                               "gather")
        if self._mesh.rank == 0:
            ckpt.save(self.options.ckpt_dir, self._round, tree,
                      extra={"round": self._round,
                             "gateway_rollups": rollups})
        self._mesh.barrier()
        return self._round

    def _try_resume(self) -> None:
        step = ckpt.latest_step(self.options.ckpt_dir)
        if step is None:
            return
        tree = ckpt.restore(self.options.ckpt_dir, self._ckpt_tree(),
                            step=step)
        extra = ckpt.read_manifest(
            self.options.ckpt_dir, step=step).get("extra") or {}
        self._state = tree["state"]
        rollup = extra.get("rollup")
        if self._mesh is not None:
            from repro_torch.sharding.agent_shard import scatter_agents

            self._state = scatter_agents(self._state, self._mesh)
            # this gateway's rollup, where the checkpoint has one per
            # gateway of this mesh (a whole-fleet rollup is not its)
            shards = extra.get("gateway_rollups") or ()
            rollup = (shards[self._mesh.rank]
                      if len(shards) == self._mesh.size else None)
        self._key = torch.from_numpy(tree["key"].astype(np.int64)).to(
            self._key.device)
        self._round = int(extra.get("round", step))
        if rollup:
            self.rollup.load_state(rollup)
        self.rollup.record_restart()

    def run(self, rounds: int = 0) -> int:
        """Blocking serve loop; returns the number of rounds executed.

        ``rounds=N`` runs N MORE rounds from the current (possibly
        resumed) position; ``rounds=0`` runs until :meth:`stop` is
        called (or KeyboardInterrupt).  The observation stream is keyed
        by absolute round index, so a resumed session consumes exactly
        the batches the killed one would have.  ``ckpt_every`` counts
        rounds from this call's start.
        """
        opts = self.options
        start = self._round
        target = 0 if rounds == 0 else start + rounds
        k = start
        if opts.watchdog_timeout > 0:
            self._watchdog = Watchdog(self.rollup, opts.watchdog_timeout)
            self._watchdog.start()
        try:
            batch = self._batch_fn(k)
            while not self._stop.is_set() and (target == 0 or k < target):
                # 1. dispatch round k (returns before the card finishes)
                self._state, metrics = self._step(self._state, batch)
                # 2. draw round k+1's observations in the card's shadow
                if target == 0 or k + 1 < target:
                    batch = self._batch_fn(k + 1)
                # 3. pull round k's metrics (waits for the card), roll up
                metrics = {name: v.cpu().numpy()
                           for name, v in metrics.items()}
                self.rollup.update(metrics)
                if self._watchdog is not None:
                    self._watchdog.beat()
                if self._on_round is not None:
                    self._on_round(k, metrics)
                k += 1
                self._round = k
                if (opts.ckpt_dir and opts.ckpt_every > 0
                        and (k - start) % opts.ckpt_every == 0):
                    self.checkpoint()
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
        return k - start

    # -- thread mode ---------------------------------------------------

    def start(self, rounds: int = 0) -> None:
        """Run the serve loop on a daemon thread."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("session already running")
        self._stop.clear()

        def _target():
            try:
                self.run(rounds)
            except BaseException as e:  # surfaced by stop()
                self._error = e

        self._thread = threading.Thread(
            target=_target, name="fleet-session", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Signal the loop to finish its round and join the thread;
        re-raises the thread's error."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def serve_telemetry(self, port: int = 0) -> "TelemetryServer":
        """Start an HTTP telemetry endpoint over this session's rollup."""
        server = TelemetryServer(self.rollup, port=port)
        server.start()
        return server


# ----------------------------------------------------------------------
# telemetry sinks
# ----------------------------------------------------------------------


class TelemetryServer:
    """Threaded HTTP exporter: ``/stats.json`` + Prometheus ``/metrics``.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    """

    def __init__(self, rollup: CommRollup, *, port: int = 0,
                 host: str = "127.0.0.1"):
        self.rollup = rollup
        roll = rollup

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                if self.path in ("/", "/stats.json", "/stats"):
                    body = roll.to_json().encode()
                    ctype = "application/json"
                elif self.path == "/metrics":
                    body = roll.to_prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet scrape spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-telemetry",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None


def file_sink(path: str, rollup: CommRollup, every: int = 50):
    """An ``on_round`` callback writing rollup snapshots to ``path``.

    A whole snapshot is written each ``every`` rounds via replace, so a
    concurrent reader never sees a torn file.
    """
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)

    def _write():
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(rollup.to_json())
        os.replace(tmp, path)

    def _cb(k, metrics):
        if (k + 1) % every == 0:
            _write()

    _cb.flush = _write
    return _cb


# ----------------------------------------------------------------------
# scenario builder: the m=64 tiered linreg fleet
# ----------------------------------------------------------------------


def build_linreg_fleet_session(
    net=None, cfg_lr=None, *, lam_base: float = 1.0, seed: int = 0,
    device: DeviceLike = "cuda", window: int = 64,
    clock: Callable[[], float] = time.monotonic,
    on_round: Optional[Callable] = None,
    options: Optional[SessionOptions] = None,
    batch_fn: Optional[Callable] = None,
    churn: Optional[Tuple[Tuple[int, int], ...]] = None,
    mesh=None,
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
    stream when given.  ``options`` arms checkpointing, resume and the
    watchdog; the session's key is ``PRNGKey(seed + 1)``, as the JAX
    builder's.  ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh` of
    gateway ranks) routes through ``StepOptions.mesh`` to the
    fleet-sharded step: every rank builds its session, serves its agents
    (the global batch is drawn and each gateway takes its slice) and
    rolls up its agents' tiers.
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
    from repro_torch.sharding.agent_shard import (
        ShardedTrainStep,
        gateway_agents,
        scatter_agents,
    )

    step_fn = make_triggered_train_step(
        loss_fn, opt, cfg,
        options=StepOptions(agent_metrics=True, churn=churn, mesh=mesh),
        device=dev)
    state = init_train_state(
        {"w": torch.zeros(cfg_lr.n, dtype=torch.float32)}, opt, cfg,
        device=dev)
    agents = range(net.num_agents)
    if isinstance(step_fn, ShardedTrainStep):
        state = scatter_agents(state, mesh, device=dev)
        agents = gateway_agents(mesh, net.num_agents)
    else:
        mesh = None  # one gateway: the plain hybrid step
    if batch_fn is None:
        problem = R.make_problem(cfg_lr, step_generator(seed, 0, dev),
                                 device=dev)

        def batch_fn(k):
            return R.agent_batches(problem,
                                   step_generator(seed + 1, k, dev))

    # the tiers of the agents this session serves, in tier order
    index = [net.tier_index()[a] for a in agents]
    tiers = sorted(set(index))
    rollup = CommRollup(
        tier_names=tuple(net.tiers[t].name for t in tiers),
        tier_index=tuple(tiers.index(t) for t in index),
        budgets=tuple(net.budgets()[a] for a in agents),
        window=window, clock=clock)
    return FleetSession(step_fn, state, batch_fn, rollup,
                        key=prng.PRNGKey(seed + 1), on_round=on_round,
                        options=options, mesh=mesh)
