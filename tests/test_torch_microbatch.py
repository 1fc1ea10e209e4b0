"""Microbatching (``TrainConfig.microbatches``) and the memory knobs of
``plan_run`` in the port against the JAX package, on the CPU.

* ``TOY4`` (the m = 4 linear-regression fleet): the port's step with
  ``microbatches=2`` against JAX ``make_triggered_train_step`` with the
  same, under the parity contract (tests/test_torch_fleet.py's
  ``_parity_run``: losses and parameters within ``rtol = 1e-5, atol =
  1e-6``, decisions and bytes exact but for a threshold tie).
* reduced smollm-135m, m = 2: two ``gain_lookahead(lam=0.01)|int8+ef``
  steps with ``microbatches=2`` against JAX's (its ``unroll`` path),
  alone and with ``remat``, under tests/test_torch_train.py's checks;
  the microbatched step against the port's own whole-batch step within
  the contract (the slices' sums associate otherwise).
* A batch that ``m`` does not divide raises in both packages; the train
  CLI's ``--microbatches 2`` trains; ``plan_run(remat=, attn_q_block=)``
  gives the JAX package's model config.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.api import init_train_state as jinit
from repro.core.api import make_triggered_train_step as jmake
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, TrainConfig
from repro_torch.core.api import init_train_state, make_triggered_train_step
from repro_torch.launch import steps as S
from repro_torch.launch import train as train_cli
from repro_torch.optim import optimizers as opt_lib
from repro_torch.utils import tree as T
from test_torch_fleet import TOY4, _parity_run, jloss, tloss
from test_torch_moe import LR, lm_batches, step_parity
from test_torch_train import _models

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
POLICY = "gain_lookahead(lam=0.01)|int8+ef"

# ----------------------------------------------------------------------
# the linear-regression fleet
# ----------------------------------------------------------------------

TOY4_CASES = {
    "quadratic_int8_ef": ("gain_quadratic(lam=0.05,kernel=true)|int8+ef",
                          "hybrid"),
    # one policy per agent, against JAX's reference loop over agents
    "hetero": (("always", "gain_lookahead(lam=0.02)|int8+ef", "never",
                "gain_quadratic(lam=0.05)|topk(0.5)+ef"), "unroll"),
}


@pytest.mark.parametrize("case", list(TOY4_CASES))
def test_toy4_microbatched_steps_match_jax(case):
    specs, dispatch = TOY4_CASES[case]
    assert TOY4.samples_per_agent % 2 == 0
    _parity_run(TOY4, specs, dispatch, microbatches=2)


def test_a_batch_that_microbatches_do_not_divide_raises():
    """Three samples per agent in two microbatches: the port raises, as
    the JAX package's reshape does."""
    cfg = TrainConfig(optimizer="sgd", num_agents=2, comm="always",
                      microbatches=2)
    opt = opt_lib.from_config(cfg)
    step = make_triggered_train_step(tloss, opt, cfg, device="cpu")
    state = init_train_state({"w": torch.ones(3)}, opt, cfg, device="cpu")
    with pytest.raises(ValueError, match="microbatches=2 does not divide"):
        step(state, (torch.ones(2, 3, 3), torch.zeros(2, 3)))
    jcfg = JTrainConfig(optimizer="sgd", num_agents=2, comm="always",
                        microbatches=2)
    jo = jopt.from_config(jcfg)
    jstep = jmake(jloss, jo, jcfg)
    with pytest.raises(TypeError):
        jstep(jinit({"w": np.ones(3, np.float32)}, jo, jcfg),
              (np.ones((2, 3, 3), np.float32), np.zeros((2, 3), np.float32)))


# ----------------------------------------------------------------------
# the LM train step
# ----------------------------------------------------------------------

def _smollm(remat: bool):
    jm, tm, jp = _models()
    if not remat:
        return jm, tm, jp
    from repro.models import build as jax_build
    from repro_torch.models import build

    return (jax_build(jm.cfg.replace(remat=True)),
            build(tm.cfg.replace(remat=True)), jp)


@pytest.mark.parametrize("remat", [False, True])
def test_microbatched_lm_steps_match_jax(remat):
    jm, tm, jp = _smollm(remat)
    batches = lm_batches(jm, 2, 2, 16, (700, 701))
    outcomes = step_parity(jm, tm, jp, POLICY, batches, microbatches=2)
    assert outcomes.count("checked") >= 1, outcomes


def test_microbatched_lm_step_is_the_whole_batch_step():
    """The mean of two slices' mean token losses is the whole batch's:
    one ``always`` step from the same state, microbatched and not,
    agrees within the contract (the sums associate otherwise)."""
    jm, tm, jp = _models()
    batch = convert.to_torch(lm_batches(jm, 2, 2, 16, (702,))[0], "cpu")
    params = convert.params_from_jax(jax.device_get(jp), device="cpu")
    out = {}
    for m in (1, 2):
        cfg = TrainConfig(lr=LR, optimizer="sgd", num_agents=2,
                          comm="always", microbatches=m)
        opt = opt_lib.from_config(cfg)
        step = make_triggered_train_step(tm.loss_fn, opt, cfg, device="cpu")
        out[m] = step(init_train_state(params, opt, cfg, device="cpu"),
                      batch)
    (s1, m1), (s2, m2) = out[1], out[2]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=RTOL)
    for (path, a), (_, b) in zip(T.tree_flatten_with_path(s2.params),
                                 T.tree_flatten_with_path(s1.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=str(path))
    assert float(m2["num_tx"]) == float(m1["num_tx"]) == 2.0


# ----------------------------------------------------------------------
# the CLI and plan_run
# ----------------------------------------------------------------------

def _step_losses(text: str) -> list:
    return [float(x) for x in re.findall(r"loss (\d+\.\d+)", text)]


def test_train_cli_with_microbatches_trains(capsys):
    """``--microbatches 2`` runs the CLI's steps, each loss within the
    printed digits of the whole-batch run's."""
    base = ["--device", "cpu", "--reduced", "--steps", "3", "--seq", "16",
            "--batch", "4", "--agents", "2", "--log-every", "1"]
    runs = {}
    for m in ("1", "2"):
        train_cli.main(base + ["--microbatches", m])
        runs[m] = capsys.readouterr().out
    assert re.search(r"done: 3 steps, transmissions \d/6", runs["2"])
    got, want = _step_losses(runs["2"]), _step_losses(runs["1"])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("remat,q_block", [(True, 512), (True, None),
                                           (False, 256), (False, None)])
def test_plan_run_sets_remat_like_jax(remat, q_block):
    """``plan_run(remat=, attn_q_block=)`` gives the JAX package's
    model config: both are set together when either is given (so
    ``remat=True`` alone clears ``attn_q_block``), and neither when
    neither is; ``microbatches`` lands in the TrainConfig."""
    arch = "whisper-medium"
    shape = InputShape("t", 64, 4, "train")
    base = dict(attn_q_block=500)  # a config-level tile to keep or clear
    tplan = S.plan_run(get_config(arch).replace(**base), shape,
                       num_agents=1, remat=remat, attn_q_block=q_block,
                       microbatches=2)
    jplan = JS.plan_run(jax_get_config(arch).replace(**base),
                        JInputShape("t", 64, 4, "train"), make_host_mesh(),
                        remat=remat, attn_q_block=q_block, microbatches=2)
    want = dataclasses.asdict(jplan.cfg)
    got = dataclasses.asdict(tplan.cfg)
    assert got == {k: want[k] for k in got}
    assert (tplan.cfg.remat, tplan.cfg.attn_q_block) == (
        (remat, q_block) if remat or q_block else (False, 500))
    assert tplan.train_cfg.microbatches == jplan.train_cfg.microbatches == 2
