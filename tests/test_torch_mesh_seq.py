"""``seq_shard`` and ``inner_batch_shard`` on the port's (data, model)
mesh of gloo ranks on the CPU, against the JAX package.

One module fixture runs every rank program in one spawn of 4 ranks
(``tests/torch_mesh_ranks.py``, which imports no JAX); the test process
runs the JAX side on the same inputs.  Reduced smollm-135m (2 layers,
d 256, vocab 512) at (data 2, model 2), m = 2 agents × 2 rows × 16
tokens:

* ``seq_shard``: each model rank holds its chunk of the sequence
  (Megatron's sequence parallelism: the residual stream, the norms and
  the embedding on the chunk; the chunk gathered before the
  column-parallel projections and the row-parallel outputs
  reduce-scattered back to it); with 4/2 heads (split) fsdp off, on and
  with ``fleet_shard``, and 3/1 heads (attention whole on every rank,
  its output cut to the chunk);
* ``inner_batch_shard``: each model rank computes on its row of each
  agent's two, every weight gathered whole at use and its gradient
  summed over "model" into the rank's block; fsdp off, and on with
  ``fleet_shard``;
* one ``gain_quadratic`` step under each knob (the HVP through the new
  collectives' forward-mode rules);
* one ``seq_shard`` prefill (no cache) against JAX's ``forward``.

The contract is ROADMAP's "Parity contract" (the JAX package's SPMD
partitioning does not change what its step computes, so the port is
held to JAX's unsharded step, as ``tests/test_torch_mesh_lm.py`` holds
the tensor-parallel jobs): metrics and parameters within ``rtol =
1e-5, atol = 1e-6``, decisions exact but for a gain within 1e-5 of its
threshold, EF memory within ``rtol = 1e-5`` of each agent's
``max|g + ef|``, and an int8 element whose ``g + ef`` lies within that
gap of a rounding boundary allowed one level (counted).  The collective
log of each knob is held to the count worked out from the code.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import test_torch_mesh_lm as lm
import torch_mesh_ranks as ranks
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import Mesh, spawn

torch.set_num_threads(1)

P2, PQ = lm.P2, lm.PQ
SEQ_KNOB = {"seq_shard": True}
INNER_KNOB = {"inner_batch_shard": True}
TIMEOUT_S = 300


def _job(policy, fsdp, fleet, knobs, steps, cfg=None):
    return dict(lm._job(policy, fsdp, fleet, cfg=cfg, steps=steps),
                knobs=knobs)


JOBS = {
    "seq_fsdp0": _job(P2, False, False, SEQ_KNOB, 2),
    "seq_fsdp1": _job(P2, True, False, SEQ_KNOB, 1),
    "seq_fleet": _job(P2, True, True, SEQ_KNOB, 1),
    "seq_heads31": _job(P2, True, False, SEQ_KNOB, 1,
                        cfg={"num_heads": 3, "num_kv_heads": 1}),
    "inner_fsdp0": _job(P2, False, False, INNER_KNOB, 2),
    "inner_fleet": _job(P2, True, True, INNER_KNOB, 1),
    "quadratic_seq": _job(PQ, False, False, SEQ_KNOB, 1),
    "quadratic_inner": _job(PQ, False, False, INNER_KNOB, 1),
}
PREFILL = {"prefill_heads42": {}, "prefill_heads31": {
    "num_heads": 3, "num_kv_heads": 1}}
PROMPT = (4, 16)


@functools.lru_cache(maxsize=None)
def _prompt():
    return np.asarray(jax.random.randint(jax.random.key(7), PROMPT, 0, 512,
                                         dtype=np.int32))


def _prefill_args():
    out = {}
    for name, cfg in PREFILL.items():
        _, jp = lm._jax_model("smollm-135m", tuple(sorted(cfg.items())))
        out[name] = ("prefill_run", (dict(
            cfg=cfg, fsdp=name.endswith("31"),
            params=convert.to_numpy(convert.params_from_jax(jp,
                                                            device="cpu")),
            prompt=_prompt()),))
    return out


@pytest.fixture(scope="module")
def runs():
    jobs = dict(lm.rank_args(JOBS), **_prefill_args())
    return spawn(ranks.run_jobs, 4, timeout_s=TIMEOUT_S, device="cpu",
                 args=(jobs,))


@pytest.mark.parametrize("name", sorted(JOBS))
def test_mesh_knob_step_matches_jax(runs, name):
    lm.check_job(runs, name, JOBS[name])


def _tags(runs, name):
    return {k: v["count"]
            for k, v in runs[0][name]["steps"][0]["by_tag"].items()}


def test_seq_shard_collectives_replace_the_row_parallel_reduces(runs):
    """``seq_shard`` (2 layers, 4/2 heads, int8): the sequence's gathers
    and reduce-scatters in place of the tensor-parallel reduces, each
    once in the loss's and once in the probe's forward and once in the
    backward; the token ids and labels gathered once a forward; the
    norms' gradients summed over "model"."""
    layers, norms, split_leaves = 2, 2 * 2 + 1, 8
    want = {
        # forward (loss, probe): the ids, the embedding's reduce-scatter,
        # each block's two gathers and two reduce-scatters, the loss's
        # gather of the hidden and its vocabulary-parallel combine
        "sp_tokens": 2, "sp_embed": 2, "sp_labels": 2, "sp_loss_in": 2,
        "sp_attn_in": 2 * layers, "sp_attn_out": 2 * layers,
        "sp_mlp_in": 2 * layers, "sp_mlp_out": 2 * layers,
        "ce_max": 2, "ce_lse": 2, "ce_gold": 2,
        # backward: each collective's transpose once
        "sp_loss_in_grad": 1, "sp_embed_grad": 1,
        "sp_attn_in_grad": layers, "sp_attn_out_grad": layers,
        "sp_mlp_in_grad": layers, "sp_mlp_out_grad": layers,
        "seq_param_grad": norms,
        # the block epilogue: int8's scale per split leaf, the
        # aggregate's norm; the round over data
        "int8_scale": split_leaves, "grad_norm": 1,
        "agent_vectors": 1, "payload": 1,
    }
    assert _tags(runs, "seq_fsdp0") == want
    for name in ("seq_fsdp0", "seq_heads31"):
        tags = _tags(runs, name)
        assert not [t for t in tags if t.startswith("tp_")], (name, tags)
    # 3/1 heads: attention whole on every rank, its output cut to the
    # chunk (no reduce-scatter), its weights' gradients summed
    tags = _tags(runs, "seq_heads31")
    assert "sp_attn_out" not in tags and tags["sp_attn_in"] == 2 * layers
    assert tags["seq_param_grad"] == norms + 4 * layers


def test_inner_batch_gathers_every_split_leaf(runs):
    """``inner_batch_shard``: no tensor parallelism; each split leaf
    (the 7 stacked weights per layer slice and the table) gathered whole
    over "model" in the loss's and the probe's forward, its gradient
    summed once; the norms' gradients summed; the loss summed over the
    ranks' rows."""
    layers = 2
    split = 7 * layers + 1
    tags = _tags(runs, "inner_fsdp0")
    assert tags == {"rows_gather": 2 * split, "rows_gather_grad": split,
                    "rows_param_grad": 2 * layers + 1, "loss_sum": 2,
                    "int8_scale": 8, "grad_norm": 1, "agent_vectors": 1,
                    "payload": 1}, tags


def test_knobs_keep_the_kernel_launches(runs):
    """Each rank launches the kernels as the single-process step does:
    attention on the rank's heads over the whole sequence (seq) or on
    its rows (inner), the loss once for the losses and once for the
    probes."""
    for name in JOBS:
        for r in runs:
            for s in r[name]["steps"]:
                assert s["launches"] == (2 * 2, 2), (name, s["launches"])


def test_seq_shard_prefill_matches_jax(runs):
    """The ``seq_shard`` prefill (4 × 16 prompt, each rank its 2 rows ×
    8 positions) against JAX's unsharded ``forward`` on the same
    weights: the logits within 1e-5, 2 ``swa_attention`` launches per
    rank (one a layer), and the row-parallel outputs reduce-scattered
    where the heads split."""
    for name, cfg in PREFILL.items():
        jm, jp = lm._jax_model("smollm-135m", tuple(sorted(cfg.items())))
        want = np.asarray(jax.device_get(jm.forward(
            jp, {"tokens": _prompt()})[0]))
        for r in runs:
            got = r[name]
            assert got["split"] == "seq" and got["tokens"] == [2, 8], got
            np.testing.assert_allclose(got["logits"], want, rtol=1e-5,
                                       atol=1e-5, err_msg=name)
            assert got["launches"] == 2
        tags = {k: v["count"] for k, v in runs[0][name]["by_tag"].items()}
        assert tags["sp_attn_in"] == 2 and tags["sp_logits_in"] == 1
        assert ("sp_attn_out" in tags) == (name == "prefill_heads42")


def test_knobs_are_no_ops_without_a_mesh(capsys):
    """With no mesh (or a model axis of 1) both knobs plan JAX's rules
    and change nothing: the one-card step with either is bitwise the
    plain one, and ``hillclimb --seq-shard --inner-batch`` traces on the
    CPU as JAX's does on a mesh whose model axis is 1."""
    from repro_torch.core.api import init_train_state
    from repro_torch.launch import hillclimb
    from repro_torch.models import build
    from repro_torch.optim import optimizers as opt_lib

    cfg = reduced(get_config("smollm-135m"))
    shape = InputShape("t", 16, 4, "train")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))[0]
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 17), generator=gen)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    outs = []
    for knobs in ({}, SEQ_KNOB, INNER_KNOB, dict(SEQ_KNOB, **INNER_KNOB)):
        for mesh in (None, Mesh(("data", "model"), (1, 1))):
            plan = S.plan_run(cfg, shape, mesh, num_agents=2, comm=P2,
                              lr=0.1, **knobs)
            assert plan.seq_shard == bool(knobs.get("seq_shard"))
            assert plan.inner_batch_shard == bool(
                knobs.get("inner_batch_shard"))
            step = S.build_train_step(plan, compute_dtype="float32",
                                      device="cpu", mesh=mesh)
            state = init_train_state(params, opt_lib.from_config(
                plan.train_cfg), plan.train_cfg, device="cpu")
            outs.append(step(state, batch)[0].params)
    for other in outs[1:]:
        for a, b in zip(lm._flat(outs[0]).values(), lm._flat(other).values()):
            np.testing.assert_array_equal(a, b)
    hillclimb.main(["--arch", "smollm-135m", "--shape", "train_4k",
                    "--seq-shard", "--inner-batch", "--top", "2"])
    assert "smollm-135m × train_4k" in capsys.readouterr().out
