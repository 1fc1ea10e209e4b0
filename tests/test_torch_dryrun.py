"""The port's dry-run on the port alone, on the CPU.

* A reduced smollm train step (m = 2, ``gain_lookahead(lam=0.01)|int8+ef``)
  counts exactly the same flops, HBM bytes, device ops, per-op table and
  memory high-water on the CPU as on ``meta``: the kernels record their
  own work and mute their plain versions, and the plain
  ``swa_attention`` returns the kernel's contiguous layout.
* A reduced smollm prefill's product flops equal the closed-form sum
  over its layers, and its ``swa_attention`` rows the kernel's own cost.
* Each kernel wrapper on ``meta`` returns the right shape and records
  exactly its ``cost()``, as on the CPU.
* The serve step's 0-d tensor position (the dry-run's traced input)
  writes and returns bitwise what an int position does, per family;
  the prefill step is bitwise ``model.forward``.
* A dry-run record has the JAX record's keys (``hlo_cost`` → ``cost``,
  ``compile_seconds`` → ``trace_seconds``; no ``xla_cost_analysis``),
  a skipped pair JAX's reason; the CLIs run, and the mesh's knobs raise.
"""
import copy
import json

import pytest
import torch

from repro.analysis import hlo_cost
from repro.analysis.roofline import Roofline as JaxRoofline
from repro_torch.analysis.cost import CostCounter, MemoryTracker, summarize
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.core.api import init_train_state
from repro_torch.data.synthetic import batch_iterator
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.kernels.gain_reduce import ops as gr_ops
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import steps as S
from repro_torch.models import build, input_specs
from repro_torch.optim import optimizers as opt_lib
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

COMM = "gain_lookahead(lam=0.01)|int8+ef"
JAX_RECORD_KEYS = {"name", "status", "arch", "shape", "mesh", "tag", "chips",
                   "compile_seconds", "plan", "memory_analysis",
                   "xla_cost_analysis", "hlo_cost", "roofline"}
JAX_PLAN_KEYS = {"fsdp", "num_agents", "agent_axes", "remat", "attn_q_block",
                 "swa_window"}


def _traced(step, *args):
    with CostCounter() as counter, MemoryTracker() as tracker:
        step(*args)
    return counter, tracker


def _train_args(plan, shape, dev):
    model = build(plan.cfg)
    if dev == "meta":
        params, _ = model.init(abstract=True)
        batch = input_specs(plan.cfg, shape, num_agents=plan.num_agents)
    else:
        params, _ = model.init(torch.Generator().manual_seed(0))
        batch = {k: v.contiguous() for k, v in next(batch_iterator(
            plan.cfg, shape, num_agents=plan.num_agents, seed=0,
            device=dev)).items()}
    state = init_train_state(params, opt_lib.from_config(plan.train_cfg),
                             plan.train_cfg, device=dev)
    return state, batch


def test_train_step_counts_the_same_on_cpu_and_meta():
    shape = InputShape("toy", 16, 4, "train")
    plan = S.plan_run(reduced(get_config("smollm-135m")), shape,
                      num_agents=2, comm=COMM, lr=0.05)
    runs = {}
    for dev in ("cpu", "meta"):
        step = S.build_train_step(plan, compute_dtype="float32", device=dev)
        runs[dev] = _traced(step, *_train_args(plan, shape, dev))
    (cpu, cpu_mem), (meta, meta_mem) = runs["cpu"], runs["meta"]
    assert summarize(cpu) == summarize(meta)
    assert cpu.dot_flops == meta.dot_flops
    assert dict(cpu.by_op) == dict(meta.by_op)
    layers = plan.cfg.num_layers
    # the losses and the lookahead probe: one launch each per kernel call
    assert cpu.by_op["kernel:swa_attention"].count == 2 * layers
    assert cpu.by_op["kernel:fused_ce"].count == 2
    assert cpu_mem.peak_bytes == meta_mem.peak_bytes > 0


def test_prefill_products_match_closed_form():
    cfg = reduced(get_config("smollm-135m"))
    b, s = 2, 32
    plan = S.plan_run(cfg, InputShape("p", s, b, "prefill"))
    lowered = S.lower_for(plan, compute_dtype="float32")
    cost = lowered.cost()
    t, d, f, v = b * s, cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    per_layer = (2 * t * d * (h + 2 * kv) * hd   # q, k, v projections
                 + 2 * t * h * hd * d            # the output projection
                 + 3 * 2 * t * d * f)            # SwiGLU
    assert cost.dot_flops == cfg.num_layers * per_layer + 2 * t * d * v
    swa = swa_ops.cost(b, s, h, kv, hd, s, torch.float32)
    row = cost.by_op["kernel:swa_attention"]
    assert row.count == cfg.num_layers
    assert row.flops == cfg.num_layers * swa["flops"]
    assert row.hbm_bytes == cfg.num_layers * swa["hbm_bytes"]
    mem = lowered.memory()
    assert mem["output_bytes"] == t * v * 4  # the fp32 logits
    assert mem["argument_bytes"] == sum(
        x.nbytes for x in tree_leaves(lowered.args))
    assert mem["temp_bytes"] > 0


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_kernels_record_their_own_cost(dev):
    def rand(*shape):
        return torch.randn(shape).to(dev)

    q, k = rand(2, 40, 4, 16), rand(2, 40, 2, 16)
    x, table = rand(1, 24, 16), rand(1, 30, 16)
    labels = torch.randint(0, 30, (1, 24)).to(dev)
    g = rand(3, 50)
    with CostCounter() as c:
        assert swa_ops._forward(q, k, k, 8).shape == q.shape
        nll, lse = ce_ops._forward(x, table, labels)
        assert nll.shape == lse.shape == (1, 24)
        assert gr_ops.gain_reduce(g, g).shape == (3, 2)
    want = {"kernel:swa_attention": swa_ops.cost(2, 40, 4, 2, 16, 8,
                                                 torch.float32),
            "kernel:fused_ce": ce_ops.cost(1, 24, 16, 30, torch.float32),
            "kernel:gain_reduce": gr_ops.cost(3, 50, torch.float32)}
    assert set(c.by_op) == set(want)
    for name, work in want.items():
        row = c.by_op[name]
        assert (row.count, row.flops, row.hbm_bytes) == (
            1, work["flops"], work["hbm_bytes"])
    assert c.device_ops == 3


SERVED = [("smollm-135m", None), ("smollm-135m", 4), ("mixtral-8x7b", None),
          ("zamba2-1.2b", None), ("xlstm-350m", None),
          ("whisper-medium", None)]


@pytest.mark.parametrize("arch,window", SERVED)
def test_serve_step_tensor_position_is_bitwise_int_position(arch, window):
    cfg = reduced(get_config(arch))
    if window:
        cfg = cfg.replace(swa_window=window)
    plan = S.plan_run(cfg, InputShape("d", 6, 2, "decode"))
    step, params, (cache, tokens, pos) = S.build_serve_step(
        plan, compute_dtype="float32", device="cpu")
    assert pos.dtype == torch.int32 and pos.shape == () and int(pos) == 5
    model = build(plan.cfg.replace(compute_dtype="float32"))
    direct = copy.deepcopy(cache)
    for p in (3, 4, 5):
        got, cache = step(params, cache, tokens, torch.tensor(
            p, dtype=torch.int32))
        want, direct = model.decode_step(params, direct, tokens, p)
        assert torch.equal(got, want), p
    for a, b in zip(tree_leaves(cache), tree_leaves(direct)):
        assert torch.equal(a, b)


def test_prefill_step_is_bitwise_forward():
    cfg = reduced(get_config("smollm-135m"))
    plan = S.plan_run(cfg, InputShape("p", 12, 2, "prefill"))
    step, params, batch = S.build_prefill_step(
        plan, compute_dtype="float32", device="cpu")
    assert batch["tokens"].shape == (2, 12)
    want, _ = build(plan.cfg.replace(compute_dtype="float32")).forward(
        params, batch)
    assert torch.equal(step(params, batch), want)
    _, meta_params, meta_batch = S.build_prefill_step(plan, device="meta")
    assert all(x.device.type == "meta" for x in tree_leaves(
        (meta_params, meta_batch)))


def test_dryrun_record_has_the_jax_keys(tmp_path):
    rec = dryrun.run_one("smollm-135m", "long_500k", False, tmp_path)
    want = (JAX_RECORD_KEYS - {"compile_seconds", "xla_cost_analysis",
                               "hlo_cost"}) | {"trace_seconds", "cost"}
    assert want <= set(rec) and rec["status"] == "ok"
    assert set(rec["plan"]) == JAX_PLAN_KEYS
    assert rec["plan"]["swa_window"] == 4096  # long_500k's variant
    assert set(rec["memory_analysis"]) == {"argument_bytes", "temp_bytes",
                                           "output_bytes", "total_bytes"}
    assert set(hlo_cost.summarize(hlo_cost.HloCost())) <= set(rec["cost"])
    jax_roof = JaxRoofline("a", "s", "m", 1, 1.0, 1.0, 0.0, 1.0).to_dict()
    assert set(jax_roof) <= set(rec["roofline"])
    assert rec["roofline"]["path"] == "bf16"
    assert rec["cost"]["wire_bytes"] == 0 and rec["cost"]["collectives"] == {}
    saved = json.loads((tmp_path / f"{rec['name']}.json").read_text())
    assert saved["roofline"] == rec["roofline"]
    skip = dryrun.run_one("whisper-medium", "long_500k", False, tmp_path)
    assert skip["status"] == "skipped" and "448" in skip["reason"]
    opt = dryrun.run_one("smollm-135m", "decode_32k", True, tmp_path)
    assert opt["status"] == "skipped" and "item 11" in opt["reason"]


def test_clis_run_and_the_mesh_knobs_raise(tmp_path, capsys, monkeypatch):
    args = ["--arch", "smollm-135m", "--shape", "long_500k",
            "--out", str(tmp_path)]
    assert dryrun.main(args) == 0
    assert dryrun.main(args) == 0
    out = capsys.readouterr().out
    assert "[ok] smollm-135m_long_500k_h100x1_base" in out
    assert "[cached]" in out
    monkeypatch.chdir(tmp_path)
    hillclimb.main(["--arch", "smollm-135m", "--shape", "long_500k",
                    "--save", "t"])
    out = capsys.readouterr().out
    assert "fits H100 80 GB: OK" in out and "MFU bound" in out
    assert (tmp_path / "experiments" / "hillclimb_torch"
            / "smollm-135m_long_500k_t.json").exists()
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        dryrun.main(["--all", "--multi-pod"])
    # seq_shard plans on one card (JAX's rules, a no-op without a model
    # axis); the multi-pod mesh still raises above
    plan = S.plan_run(get_config("smollm-135m"), SHAPES["decode_32k"],
                      seq_shard=True)
    assert plan.seq_shard and plan.rules["seq"] == "model"
