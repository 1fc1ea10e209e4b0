"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the CPU: one on-disk format for both packages.

Every TrainState slot layout of ``tests/test_checkpoint.py``
(``SLOT_SPECS``, M = 4, N = 6) and a reduced LM state round-trip in the
port bit for bit, restore across the packages in both directions with
equal manifests (``paths``, ``shapes``, ``dtypes``), and the failure
modes give the JAX package's messages.  A session resumes the other
package's session checkpoint and is held to an unbroken JAX run under
ROADMAP's parity contract (JAX is the oracle; ``rtol=1e-5, atol=1e-6``,
decisions exact).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.comm.rollup import CommRollup as JCommRollup
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.api import StepOptions as JStepOptions
from repro.core.api import init_train_state as jinit
from repro.core.api import make_triggered_train_step as jmake
from repro.launch.session import FleetSession as JFleetSession
from repro.launch.session import SessionOptions as JSessionOptions
from repro.models import build as jax_build
from repro.optim import optimizers as jopt_lib
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointError
from repro_torch.comm.rollup import CommRollup
from repro_torch.configs.base import TrainConfig
from repro_torch.core.api import (
    StepOptions,
    init_train_state,
    make_triggered_train_step,
)
from repro_torch.launch.session import FleetSession, SessionOptions
from repro_torch.optim import optimizers as opt_lib
from repro_torch.utils.tree import tree_map
from test_checkpoint import CHURN, M, N, SLOT_SPECS
from test_checkpoint import _batch as jbatch
from test_checkpoint import _loss_fn as jloss
from test_torch_fleet import _mismatch

torch.set_num_threads(1)

SLOTS = sorted(SLOT_SPECS)
# the sessions across the packages: JAX's kill/resume layout (the retx
# channel's (rows, line) tuple) without its int8 stage.  Two free-running
# runs of the two packages drift by float ULPs, and an int8 payload entry
# on a rounding midpoint is then sent one level apart (ROADMAP §3); the
# compressed layouts are held round by round in
# test_jax_checkpoint_restores_in_port.
SESSION_SPEC = "always @ retx(k=2,p=0.3,seed=1)"


def tloss(params, batch):
    xs, ys = batch
    r = xs @ params["w"] - ys
    return 0.5 * torch.mean(r * r)


def _configs(spec):
    return (JTrainConfig(lr=0.1, optimizer="sgd", num_agents=M, comm=spec),
            TrainConfig(lr=0.1, optimizer="sgd", num_agents=M, comm=spec))


def _port(spec, churn=None):
    """The port's step and initial state for ``spec`` on the CPU."""
    _, cfg = _configs(spec)
    opt = opt_lib.from_config(cfg)
    step = make_triggered_train_step(
        tloss, opt, cfg, device="cpu",
        options=StepOptions(agent_metrics=True, churn=churn))
    return step, init_train_state({"w": torch.zeros(N)}, opt, cfg,
                                  device="cpu")


def _jax(spec, dispatch="hybrid"):
    """The JAX step (not jitted: the JAX session jits it) and initial
    state for ``spec``."""
    cfg, _ = _configs(spec)
    opt = jopt_lib.from_config(cfg)
    step = jmake(jloss, opt, cfg, options=JStepOptions(
        agent_metrics=True, hetero_dispatch=dispatch))
    return step, jinit({"w": jnp.zeros(N)}, opt, cfg)


def _jkey(k, seed=0):
    return jax.random.fold_in(jax.random.key(seed), k)


def _tbatch(k, seed=0):
    """Round ``k``'s JAX-drawn batch, as the port's tensors."""
    return convert.to_torch(jax.device_get(jbatch(_jkey(k, seed))), "cpu")


def _zeros(state):
    """A zeros template of a port tree (a host int leaf stays an int)."""
    return tree_map(lambda x: x if x is None or isinstance(x, int)
                    else torch.zeros_like(x), state)


def _np_leaves(tree):
    """A tree's leaves as numpy arrays, in ``jax.tree_util`` order."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        convert.to_numpy(tree))]


def _equal(a, b):
    la, lb = _np_leaves(a), _np_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(la, lb))


def _manifest_layout(manifest):
    return {k: manifest[k] for k in ("num_leaves", "paths", "shapes",
                                     "dtypes")}


# ----------------------------------------------------------------------
# round trips in the port
# ----------------------------------------------------------------------


@pytest.mark.parametrize("slot", SLOTS)
def test_port_roundtrip_bitwise_continuation(tmp_path, slot):
    """Save mid-run, restore into a zeros template, continue BOTH: the
    restored trajectory is bitwise the original's."""
    step, state = _port(SLOT_SPECS[slot])
    for k in range(4):
        state, _ = step(state, _tbatch(k))
    ckpt.save(str(tmp_path), 4, state)
    restored = ckpt.restore(str(tmp_path), _zeros(state))
    assert restored.step == 4 and isinstance(restored.step, int)
    assert _equal(state, restored)
    for k in range(4, 7):
        state, _ = step(state, _tbatch(k))
        restored, _ = step(restored, _tbatch(k))
    assert _equal(state, restored)


def test_port_churned_roundtrip_bitwise(tmp_path):
    """Churn masks key off TrainState.step: a restored state replays the
    joins and leaves in the same rounds as the original."""
    step, state = _port(SLOT_SPECS["net_retx_tuple"], churn=CHURN)
    for k in range(3):
        state, _ = step(state, _tbatch(k, seed=1))
    ckpt.save(str(tmp_path), 3, state)
    restored = ckpt.restore(str(tmp_path), _zeros(state))
    for k in range(3, 6):  # crosses agent 2's leave at step 4
        state, ma = step(state, _tbatch(k, seed=1))
        restored, mb = step(restored, _tbatch(k, seed=1))
        assert _equal(ma, mb)
    assert _equal(state, restored)


# ----------------------------------------------------------------------
# across the packages
# ----------------------------------------------------------------------


@pytest.mark.parametrize("slot", SLOTS)
def test_port_checkpoint_restores_in_jax(tmp_path, slot):
    """``repro.checkpoint.restore`` reads a port checkpoint into the JAX
    template, leaf for leaf the port's state, and the port's manifest
    lays the leaves out as a JAX manifest of the same state does."""
    spec = SLOT_SPECS[slot]
    tstep, tstate = _port(spec)
    jstep, jstate = _jax(spec)
    jstep = jax.jit(jstep)
    for k in range(4):
        tstate, _ = tstep(tstate, _tbatch(k))
        jstate, _ = jstep(jstate, jbatch(_jkey(k)))
    ckpt.save(str(tmp_path / "port"), 4, tstate)
    jckpt.save(str(tmp_path / "jax"), 4, jax.device_get(jstate))
    assert _manifest_layout(ckpt.read_manifest(str(tmp_path / "port"))) \
        == _manifest_layout(jckpt.read_manifest(str(tmp_path / "jax")))
    got = jckpt.restore(str(tmp_path / "port"),
                        jax.tree_util.tree_map(jnp.zeros_like, jstate))
    assert int(got.step) == 4 and got.step.dtype == jnp.int32
    assert _equal(got, tstate)


@pytest.mark.parametrize("slot", SLOTS)
def test_jax_checkpoint_restores_in_port(tmp_path, slot):
    """The port's ``restore`` reads a checkpoint ``repro.checkpoint.save``
    wrote, bit for bit, and the port's step continues from it as the JAX
    ``unroll`` step does (each round from the JAX state, decisions
    exact, floats within the parity contract)."""
    spec = SLOT_SPECS[slot]
    jstep, jstate = _jax(spec, dispatch="unroll")
    jstep = jax.jit(jstep)
    for k in range(4):
        jstate, _ = jstep(jstate, jbatch(_jkey(k)))
    jckpt.save(str(tmp_path), 4, jax.device_get(jstate))
    tstep, tstate = _port(spec)
    tstate = ckpt.restore(str(tmp_path), _zeros(tstate))
    assert tstate.step == 4
    assert _equal(tstate, jax.device_get(jstate))
    for k in range(4, 7):
        if k > 4:
            tstate = convert.state_from_jax(jax.device_get(jstate),
                                            device="cpu")
        batch = jbatch(_jkey(k))
        g_eff = np.asarray(jax.vmap(jax.grad(jloss), in_axes=(None, 0))(
            jstate.params, batch)["w"])
        if jstate.ef_memory is not None:
            g_eff = g_eff + np.asarray(jstate.ef_memory["w"])
        jnext, jm = jstep(jstate, batch)
        tnext, tm = tstep(tstate, _tbatch(k))
        assert tnext.step == int(jnext.step) == k + 1
        why = _mismatch(tnext, convert.to_numpy(tm), jnext,
                        jax.device_get(jm), g_eff)
        assert why is None, f"round {k}: {why}"
        jstate = jnext


def _lm_states():
    """A reduced smollm-135m TrainState, m = 2, ``int8+ef``, in both
    packages: the JAX init with its EF memory filled from a seed, and
    the port's copy of it."""
    cfg = JTrainConfig(lr=0.05, optimizer="sgd", num_agents=2,
                       comm="gain_lookahead(lam=0.01)|int8+ef")
    model = jax_build(jax_reduced(jax_get_config("smollm-135m")))
    params, _ = model.init(jax.random.key(0))
    jstate = jax.device_get(jinit(params, jopt_lib.from_config(cfg), cfg))
    rng = np.random.default_rng(0)
    jstate = jstate._replace(
        step=np.int32(3),
        ef_memory=jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(x.dtype),
            jstate.ef_memory))
    return jstate, convert.state_from_jax(jstate, device="cpu")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lm_state_crosses_the_packages(tmp_path, writer):
    jstate, tstate = _lm_states()
    src, dst = str(tmp_path / writer), str(tmp_path / "other")
    if writer == "port":
        ckpt.save(src, 3, tstate)
        jckpt.save(dst, 3, jstate)
        got = jckpt.restore(src, jax.tree_util.tree_map(np.zeros_like,
                                                        jstate))
    else:
        jckpt.save(src, 3, jstate)
        ckpt.save(dst, 3, tstate)
        got = ckpt.restore(src, _zeros(tstate))
        assert got.step == 3
    layout = _manifest_layout(ckpt.read_manifest(src))
    assert layout == _manifest_layout(ckpt.read_manifest(dst))
    assert layout["paths"][:2] == [".step", ".params['blocks']['attn']['wk']"]
    assert _equal(got, jstate)


# ----------------------------------------------------------------------
# failure modes: the JAX package's messages
# ----------------------------------------------------------------------


def test_atomic_save_ignores_tmp_orphans(tmp_path):
    ckpt.save(str(tmp_path), 5, {"w": torch.ones(3)})
    # a crashed save leaves only a .tmp sibling, never a visible step
    orphan = tmp_path / "step_00000009.tmp"
    orphan.mkdir()
    (orphan / "arrays.npz").write_bytes(b"half-written")
    assert ckpt.latest_step(str(tmp_path)) == 5
    # and a re-save over a crashed .tmp of the SAME step succeeds
    (tmp_path / "step_00000005.tmp").mkdir()
    ckpt.save(str(tmp_path), 5, {"w": torch.full((3,), 2.0)})
    out = ckpt.restore(str(tmp_path), {"w": torch.zeros(3)})
    assert torch.equal(out["w"], torch.full((3,), 2.0))
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore(str(tmp_path / "missing"), {"w": torch.zeros(3)})


def _corrupt(path):
    npz = os.path.join(path, "arrays.npz")
    blob = bytearray(open(npz, "rb").read())
    blob[-1] ^= 0xFF
    open(npz, "wb").write(bytes(blob))


# (saved tree, template) in numpy; each case's template breaks one check
FAILURES = {
    "corrupt": ({"w": np.ones(8, np.float32)}, {"w": np.zeros(8, np.float32)},
                CheckpointCorruptionError, "checksum"),
    "leaves": ({"w": np.ones(3, np.float32), "b": np.ones(2, np.float32)},
               {"w": np.zeros(3, np.float32)}, CheckpointError, "leaves"),
    "shape": ({"a": np.ones(3, np.float32),
               "b": (np.ones((2, 2), np.float32),)},
              {"a": np.zeros(3, np.float32),
               "b": (np.zeros((2, 3), np.float32),)},
              CheckpointError, r"leaf \"\['b'\]\[0\]\""),
    "dtype": ({"a": np.ones(3, np.float32)}, {"a": np.zeros(3, np.int32)},
              CheckpointError, r"leaf \"\['a'\]\" .*dtype float32"),
}


@pytest.mark.parametrize("case", sorted(FAILURES))
def test_failure_messages_match_jax(tmp_path, case):
    """Corruption and each template mismatch raise the JAX package's
    error type and message (with the first wrong leaf's path), for a
    port checkpoint restored into a tensor template and a JAX one
    restored into a JAX template."""
    saved, like, _, _ = FAILURES[case]
    port_dir, jax_dir = str(tmp_path / "p"), str(tmp_path / "j")
    ckpt.save(port_dir, 1, tree_map(torch.from_numpy, saved))
    jckpt.save(jax_dir, 1, jax.tree_util.tree_map(jnp.asarray, saved))
    if case == "corrupt":
        for d in (port_dir, jax_dir):
            _corrupt(os.path.join(d, "step_00000001"))
    with pytest.raises(CheckpointError) as port_err:
        ckpt.restore(port_dir, tree_map(torch.from_numpy, like))
    with pytest.raises(jckpt.CheckpointError) as jax_err:
        jckpt.restore(jax_dir, jax.tree_util.tree_map(jnp.asarray, like))
    want_type, pattern = FAILURES[case][2:]
    assert type(port_err.value) is want_type
    assert type(jax_err.value).__name__ == want_type.__name__
    assert str(port_err.value).replace(port_dir, "<dir>") == \
        str(jax_err.value).replace(jax_dir, "<dir>")
    port_err.match(pattern)


def test_extra_metadata_roundtrip(tmp_path):
    extra = {"round": 17, "rollup": {"rounds": 17, "counters": {}}}
    ckpt.save(str(tmp_path), 17, {"w": torch.ones(2)}, extra=extra)
    manifest = ckpt.read_manifest(str(tmp_path))
    assert manifest["step"] == 17 and manifest["extra"] == extra
    assert manifest["treedef"] == "{'w': *}"


# ----------------------------------------------------------------------
# sessions across the packages
# ----------------------------------------------------------------------


def _jax_session(spec, options=None, on_round=None):
    step, state = _jax(spec)
    return JFleetSession(step, state, jbatch, JCommRollup(),
                         key=jax.random.key(7), options=options,
                         on_round=on_round)


def _port_session(spec, options=None, on_round=None):
    step, state = _port(spec)
    return FleetSession(step, state, lambda k: _tbatch(k, seed=7),
                        CommRollup(), key=prng.PRNGKey(7), options=options,
                        on_round=on_round)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_session_resumes_across_packages(tmp_path, writer):
    """One package's session writes round 6; the other's resumes there
    (round index, rollup rounds, one restart) and serves 6 more rounds,
    held to an unbroken 12-round JAX session under the parity
    contract."""
    opts = SessionOptions(ckpt_dir=str(tmp_path), ckpt_every=3)
    jopts = JSessionOptions(ckpt_dir=str(tmp_path), ckpt_every=3)
    if writer == "jax":
        first = _jax_session(SESSION_SPEC, options=jopts)
    else:
        first = _port_session(SESSION_SPEC, options=opts)
    assert first.run(rounds=6) == 6
    before = first.rollup.snapshot()
    assert ckpt.latest_step(str(tmp_path)) == 6

    last = {}
    if writer == "jax":
        second = _port_session(SESSION_SPEC, options=opts,
                               on_round=lambda k, m: last.update(m=m))
    else:
        second = _jax_session(SESSION_SPEC, options=jopts,
                              on_round=lambda k, m: last.update(m=m))
    assert second.round_index == 6
    assert second.rollup.rounds == 6
    assert second.rollup.snapshot()["restarts"] == 1
    assert second.run(rounds=6) == 6
    after = second.rollup.snapshot()
    assert after["rounds"] == 12 and after["restarts"] == 1
    assert all(after["counters"][k] >= before["counters"][k]
               for k in before["counters"])

    ref_last = {}
    ref = _jax_session(SESSION_SPEC,
                       on_round=lambda k, m: ref_last.update(m=m))
    ref.run(rounds=11)
    jstate = jax.device_get(ref.state)  # before round 11 donates it
    ref.run(rounds=1)
    batch = jbatch(jax.random.fold_in(jax.random.key(7), 11))
    g_eff = np.asarray(jax.vmap(jax.grad(jloss), in_axes=(None, 0))(
        jstate.params, batch)["w"])
    got = second.state
    if writer == "port":  # the JAX session resumed: hold it as the port's
        got = convert.state_from_jax(jax.device_get(got), device="cpu")
    assert got.step == 12
    why = _mismatch(got, last["m"], ref.state, ref_last["m"], g_eff)
    assert why is None, why
    assert after["counters"]["num_tx"] == \
        ref.rollup.snapshot()["counters"]["num_tx"]


def test_session_no_resume_starts_fresh(tmp_path):
    spec = SLOT_SPECS["ef"]
    a = _port_session(spec, options=SessionOptions(ckpt_dir=str(tmp_path),
                                                   ckpt_every=2))
    a.run(rounds=4)
    assert ckpt.latest_step(str(tmp_path)) == 4
    fresh = _port_session(spec, options=SessionOptions(
        ckpt_dir=str(tmp_path), resume=False))
    assert fresh.round_index == 0 and fresh.rollup.rounds == 0
    assert fresh.state.step == 0


def test_session_resume_rejects_slot_mismatch(tmp_path):
    """A checkpoint from another slot layout fails loudly, not restore
    garbage."""
    opts = SessionOptions(ckpt_dir=str(tmp_path), ckpt_every=2)
    _port_session(SLOT_SPECS["net_delay_tuple"], options=opts).run(rounds=2)
    with pytest.raises(CheckpointError, match="leaves"):
        _port_session(SLOT_SPECS["ef"], options=opts)
