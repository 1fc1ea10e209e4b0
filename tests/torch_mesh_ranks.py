"""Rank programs for tests/test_torch_mesh_{lm,hetero,serve,seq,
epilogue}.py.

Each function runs on one gloo rank that ``repro_torch.launch.mesh.spawn``
starts on the CPU (``fn(mesh, *args)``, the mesh a (data, model) host
mesh), imports nothing of JAX, and returns numpy copies of the gathered
(global) trees, so that the test process can hold them against the JAX
package.  Inputs arrive as numpy arrays drawn by the test from JAX's
keys: the global parameters and the global batches.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.analysis.cost import MemoryTracker
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.agent_shard import gather_agents
from repro_torch.sharding.rules import gather_tree, shard_tree
from repro_torch.utils.tree import (
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
)

_MESHES = {}


_COUNTED = []


def _count_plain_calls():
    """Count the kernels' plain versions' calls as their launches (on the
    CPU the wrappers run them in the kernels' place), so that a rank's
    launches per step can be read; once per rank process."""
    if _COUNTED:
        return
    for module, name, counter in (
            (swa_ops, "swa_attention_ref", swa_ops.swa_attention),
            (ce_ops, "fused_ce_lse_ref", ce_ops.fused_ce)):
        plain = getattr(module, name)

        def call(*args, plain=plain, counter=counter, **kwargs):
            counter.launches += 1
            return plain(*args, **kwargs)

        setattr(module, name, call)
    _COUNTED.append(True)


def _mesh(base, model):
    """The (world / model, model) host mesh, made once per shape in a
    rank (every rank makes them in the same order)."""
    if model not in _MESHES:
        _MESHES[model] = make_host_mesh(model, device="cpu")
    return _MESHES[model]


def _np_tree(tree):
    """``{"a/b/c": numpy copy of the leaf}``, bf16 leaves as fp32 (numpy
    has none); a copy, so that a cache written in place later leaves it
    as it was."""
    return {"/".join(str(p) for p in path): np.array((
        x.float() if x.dtype == torch.bfloat16 else x).detach().cpu())
        for path, x in tree_flatten_with_path(tree)}


SUB_CONFIGS = ("moe", "xlstm")


def config(arch, overrides):
    """The port's reduced ``arch`` with ``overrides`` (a ``"moe"`` or
    ``"xlstm"`` entry holds that sub-config's, as sorted items)."""
    over = dict(overrides)
    cfg = reduced(get_config(arch))
    for sub in SUB_CONFIGS:
        if sub in over:
            over[sub] = dataclasses.replace(getattr(cfg, sub),
                                            **dict(over[sub]))
    return cfg.replace(**over)


def _rest_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def train_run(base, job):
    """``job``: arch, cfg overrides, the model axis's size, policy (a
    spec or a per-agent tuple), fsdp, fleet_shard, lr, remat and, where
    set, the heterogeneous dispatch path, the parameters' dtype and
    ``plan_run``'s sharding knobs (``knobs``); the
    global batches and, per step, the global state it starts from (numpy
    trees: the JAX step's states, so that the gaps do not compound).
    Returns per step the fleet's metrics, the gathered parameters, EF
    memory, controller rows and channel slot, this rank's own rows of
    the last two, the collectives by tag and by axis and the kernel
    launches and this rank's bytes of EF memory at rest; and this rank's
    bytes of parameters and optimizer state at rest and its mesh
    coordinates.  With ``job["grads"]`` the first step's record also
    holds every agent's gradient at the start state, computed on the
    mesh (the rank's blocks of its agents', gathered)."""
    _count_plain_calls()
    mesh = _mesh(base, job["model"])
    cfg = config(job.get("arch", "smollm-135m"), job.get("cfg", {}))
    batches = job["batches"]
    m, per = batches[0]["labels"].shape[:2]
    # the shape's sequence: whisper's frames (its tokens are at most 448)
    seq = batches[0].get("frame_embeds", batches[0]["labels"]).shape[2]
    shape = InputShape("mesh", seq, m * per, "train")
    plan = S.plan_run(cfg, shape, mesh, num_agents=m, comm=job["policy"],
                      lr=job["lr"], fsdp=job["fsdp"],
                      remat=job.get("remat", False), **job.get("knobs", {}))
    step = S.build_train_step(
        plan, compute_dtype="float32", param_dtype=job.get("param_dtype"),
        device="cpu", mesh=mesh, fleet_shard=job["fleet_shard"],
        agent_metrics=True,
        hetero_dispatch=job.get("dispatch", "hybrid"))
    shardings = step.state_shardings
    out = {"steps": [], "rank": mesh.rank, "coords": mesh.coords}
    for k, b in enumerate(batches):
        start = convert.to_torch(job["states"][k], "cpu")
        if job.get("param_dtype"):
            dt = getattr(torch, job["param_dtype"])
            start = start._replace(params=tree_map(lambda x: x.to(dt),
                                                   start.params))
        state = shard_tree(start._replace(step=k), shardings)
        if k == 0:
            out["param_bytes"] = _rest_bytes(state.params)
            out["global_param_bytes"] = _rest_bytes(start.params)
        grads = (_agent_grads(step, cfg, state, b)
                 if k == 0 and job.get("grads") else None)
        mesh.collectives.reset()
        swa0, ce0 = swa_ops.swa_attention.launches, ce_ops.fused_ce.launches
        with MemoryTracker() as tracker:
            state, met = step(state, convert.to_torch(b, "cpu"))
        rec = {"peak_bytes": tracker.peak_bytes,
               "by_tag": mesh.collectives.by_tag(),
               "by_axis": mesh.collectives.by_axis(),
               "launches": (swa_ops.swa_attention.launches - swa0,
                            ce_ops.fused_ce.launches - ce0)}
        if job["fleet_shard"]:
            # the sharded step's per-agent vectors are its gateway's
            met = gather_agents(met, mesh)
        if grads is not None:
            rec["grads"] = grads
        rec["metrics"] = {k: v.detach().cpu().numpy() for k, v in met.items()}
        rec["params"] = _np_tree(gather_tree(state.params, shardings.params))
        for key, slot in (("ef", "ef_memory"), ("ctrl", "ctrl_state"),
                          ("net", "net_state")):
            local = getattr(state, slot)
            if local is None:
                continue
            rec[key] = _np_tree(gather_tree(local, getattr(shardings, slot)))
            if key != "ef":
                rec[f"{key}_local"] = _np_tree(local)
            else:
                rec["ef_bytes"] = _rest_bytes(local)
        out["steps"].append(rec)
    return out


def _agent_grads(step, cfg, state, batch):
    """Every agent's gradient of the loss at ``state``'s parameters on
    the mesh step's layout (the rank's blocks of its agents' gradients,
    as the step's prologue computes them), gathered whole."""
    from repro_torch.comm.bank import batch_prologue
    from repro_torch.models import build
    from repro_torch.sharding.rules import NamedSharding, PartitionSpec

    pl = step.placement
    model = build(cfg.replace(compute_dtype="float32"))
    with pl.active():
        _, grads = batch_prologue(model.loss_fn)(
            pl.gather_params(state.params),
            pl.local_rows(convert.to_torch(batch, "cpu")))
    lead = tuple(pl.agent_sharding.spec)[:1] or (None,)
    shardings = tree_map(lambda sh: NamedSharding(
        pl.mesh, PartitionSpec(*lead, *sh.spec)), pl.model_shardings)
    return _np_tree(gather_tree(grads, shardings))


def serve_run(base, job):
    """``job``: the arch (default smollm-135m) and cfg overrides, the
    model axis's size (default 2), fsdp,
    cache_seq_shard and, for the prefill, seq_shard; the global
    parameters (numpy), the prompt ``(B, S)`` (for whisper the frames
    ``(B, F, D)``, whose count is the cross cache's) and the
    teacher-forced decode tokens ``(B, T)``, the cache length and the
    first decode position (default S).  Runs the mesh prefill (with its
    cache) and T decode steps.  Returns the prefill's and each decode
    step's logits (gathered over the batch's rows; whisper's prefill
    has none), the gathered cache and this rank's cache block after the
    prefill and after the last step, the collectives by tag of the
    prefill and of each decode step, the kernel launches of each and
    this rank's coordinates."""
    _count_plain_calls()
    mesh = _mesh(base, job.get("model", 2))
    cfg = config(job.get("arch", "smollm-135m"), job["cfg"])
    prompt = torch.from_numpy(job["prompt"])
    toks = torch.from_numpy(job["decode"])
    b, s = prompt.shape[:2]
    audio = cfg.is_encoder_decoder
    knobs = dict(fsdp=job["fsdp"], cache_seq_shard=job["cache_seq_shard"])
    pstep, _, _ = S.build_prefill_step(
        S.plan_run(cfg, InputShape("serve", s, b, "prefill"), mesh,
                   seq_shard=job.get("seq_shard", False), **knobs),
        compute_dtype="float32", device="cpu", mesh=mesh,
        cache_len=job["cache_len"], init_params=False)
    dstep, _, _ = S.build_serve_step(
        S.plan_run(cfg, InputShape("serve", job["cache_len"], b, "decode"),
                   mesh, **knobs),
        compute_dtype="float32", device="cpu", mesh=mesh, init_params=False)
    params = shard_tree(convert.to_torch(job["params"], "cpu"),
                        pstep.param_shardings)
    out = {"coords": mesh.coords, "logits": [], "launches": [],
           "by_tag": []}

    def run(fn, *args):
        mesh.collectives.reset()
        swa0 = swa_ops.swa_attention.launches
        res = fn(*args)
        out["launches"].append(swa_ops.swa_attention.launches - swa0)
        out["by_tag"].append(mesh.collectives.by_tag())
        return res

    logits, cache = run(pstep, params, {"frame_embeds" if audio
                                        else "tokens": prompt})
    out["cache_prefill"] = _np_tree(gather_tree(cache, dstep.cache_shardings))
    out["block_prefill"] = _np_tree(cache)
    if logits is not None:
        out["logits"].append(pstep.logits_sharding.gather(logits).numpy())
    pos0 = job.get("pos0", s)
    for t in range(toks.shape[1]):
        logits, cache = run(dstep, params, cache, toks[:, t:t + 1],
                            torch.tensor(pos0 + t, dtype=torch.int32))
        out["logits"].append(dstep.logits_sharding.gather(logits).numpy())
    out["cache"] = _np_tree(gather_tree(cache, dstep.cache_shardings))
    out["block"] = _np_tree(cache)
    return out


def moe_drops_run(base, job):
    """``job``: arch, cfg overrides, ``plan_run``'s knobs, the global
    parameters and one global batch (numpy).  Runs the model's loss of
    each of this rank's agents on its part of the tokens under the mesh
    step's context (no ``torch.func`` transform, so the moe layers'
    dropped pairs can be recorded) and returns, per agent, each layer's
    (T, K) mask of the dropped (token, k) pairs over the agent's whole
    token set, with the agents' indices and the step's split."""
    from repro_torch.models import build
    from repro_torch.models import moe as MOE

    mesh = _mesh(base, 2)
    cfg = config(job["arch"], job["cfg"])
    batch = convert.to_torch(job["batch"], "cpu")
    m, per, seq = batch["labels"].shape
    plan = S.plan_run(cfg, InputShape("mesh", seq, m * per, "train"), mesh,
                      num_agents=m, fsdp=False, **job["knobs"])
    step = S.build_train_step(plan, compute_dtype="float32", device="cpu",
                              mesh=mesh)
    pl = step.placement
    params = shard_tree(convert.to_torch(job["params"], "cpu"),
                        pl.param_shardings)
    local = pl.local_rows(batch)
    model = build(cfg.replace(compute_dtype="float32"))
    drops = []
    for a in range(local["labels"].shape[0]):
        with pl.active(), MOE.record_drops() as rec:
            model.loss_fn(params, {k: v[a] for k, v in local.items()})
        drops.append([r.numpy() for r in rec])
    return {"agents": list(pl.agents), "drops": drops,
            "split": pl.model_axis.split,
            "tokens": list(local["tokens"].shape)}


def prefill_run(base, job):
    """``job``: cfg overrides, fsdp, the global parameters (numpy) and
    the prompt ``(B, S)``.  Runs the ``seq_shard`` mesh prefill (no
    cache).  Returns its logits gathered over the batch's rows, the
    collectives by tag, the ``swa_attention`` launches, the step's
    split and this rank's tokens' shape."""
    _count_plain_calls()
    mesh = _mesh(base, 2)
    cfg = config(job.get("arch", "smollm-135m"), job["cfg"])
    prompt = torch.from_numpy(job["prompt"])
    b, s = prompt.shape
    step, _, _ = S.build_prefill_step(
        S.plan_run(cfg, InputShape("serve", s, b, "prefill"), mesh,
                   fsdp=job["fsdp"], seq_shard=True),
        compute_dtype="float32", device="cpu", mesh=mesh, init_params=False)
    params = shard_tree(convert.to_torch(job["params"], "cpu"),
                        step.param_shardings)
    mesh.collectives.reset()
    swa0 = swa_ops.swa_attention.launches
    logits = step(params, {"tokens": prompt})
    return {"logits": step.logits_sharding.gather(logits).numpy(),
            "by_tag": mesh.collectives.by_tag(),
            "launches": swa_ops.swa_attention.launches - swa0,
            "split": step.split,
            "tokens": list(step.rows({"tokens": prompt})["tokens"].shape)}


def epilogue_forms(base, job):
    """Each compressor chain of ``job["chains"]`` on every leaf of reduced
    smollm-135m's per-agent gradients (2 agents, drawn from
    ``job["seed"]``; integer-valued for the chains in ``job["integer"]``,
    whose fp32 sums are then exact): this rank's model block under the
    mesh step's context against the whole leaf's result cut to the
    block.  Returns per chain the leaves, the split leaves, whether every
    block is bitwise the whole leaf's, and the largest gap; for int8 also
    whether ``quantize_int8``'s values and scale are; for a sketch the
    largest grid gap, and over its fp32 bound (the bucket's Σ|s·x| times
    2^-24 times the entries summed)."""
    from repro_torch.comm.compressors import (
        _device_tables,
        quantize_int8,
        sketch_encode,
    )
    from repro_torch.comm.policy import CommPolicy
    from repro_torch.models import build
    from repro_torch.sharding import blocks
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.rules import resolve_rules

    mesh = _mesh(base, 2)
    cfg = reduced(get_config("smollm-135m"))
    shapes, axes = build(cfg).init(abstract=True)
    pl = Placement(mesh, axes, shapes, resolve_rules(mesh), 2)
    out = {}
    for spec in job["chains"]:
        chain = CommPolicy.parse("always|" + spec).chain()
        rng = np.random.default_rng(job["seed"])
        rec = {"leaves": 0, "split": 0, "bitwise": True, "gap": 0.0,
               "int8_bitwise": True, "sketch_over_bound": 0.0}
        for path, ref in tree_flatten_with_path(shapes):
            shape = (2,) + tuple(ref.shape)
            if spec in job["integer"]:
                g = rng.integers(-8, 9, size=shape).astype(np.float32)
            else:
                g = rng.standard_normal(shape).astype(np.float32)
            g = torch.from_numpy(g)
            blk = pl.layouts[path]
            local = g if blk is None else blk.cut(g).contiguous()
            whole = chain.compress(g)
            with pl.active(), blocks.at_leaf(path):
                got = chain.compress(local)
                if spec == "int8":
                    q, scale = quantize_int8(local)
                if spec.startswith("sketch"):
                    grid = sketch_encode(local, 5, 64, 0)
            want = whole if blk is None else blk.cut(whole)
            rec["leaves"] += 1
            rec["split"] += blk is not None
            rec["bitwise"] &= torch.equal(got, want)
            rec["gap"] = max(rec["gap"], float((got - want).abs().max()))
            if spec == "int8":
                wq, ws = quantize_int8(g)
                wq = wq if blk is None else blk.cut(wq)
                rec["int8_bitwise"] &= torch.equal(q, wq) and torch.equal(
                    scale, ws)
            if spec.startswith("sketch"):
                wgrid = sketch_encode(g, 5, 64, 0)
                # each bucket's Σ|s·x| times its entries' count times
                # 2^-24: what a reassociated fp32 sum may round apart by
                n = g[0].numel()
                idx, _ = _device_tables(5, 64, 0, n, g.device)
                absum = torch.zeros((2, 5, 64)).scatter_add(
                    2, idx.expand(2, 5, n),
                    g.reshape(2, 1, n).abs().expand(2, 5, n))
                count = torch.zeros((5, 64)).scatter_add(
                    1, idx, torch.ones((5, n)))
                bound = absum * count * 2.0 ** -24 + 1e-30
                rec["sketch_grid_gap"] = max(
                    rec.get("sketch_grid_gap", 0.0),
                    float((grid - wgrid).abs().max()))
                rec["sketch_over_bound"] = max(
                    rec["sketch_over_bound"],
                    float(((grid - wgrid).abs() / bound).max()))
        out[spec] = rec
    return out


def gather_methods(base, model):
    """Every rank's block of seeded global tensors under several specs,
    gathered back by ``NamedSharding.gather`` (on these CPU tensors
    gloo's ``all_gather``) and by ``gather_tree(..., dst=1)`` (each
    block sent to rank 1 alone); per spec, whether the first gives the
    global tensor and the collective kinds it logged, and whether the
    second gives it on rank 1 and None on the others."""
    from repro_torch.sharding.rules import (
        NamedSharding,
        PartitionSpec,
        gather_tree,
    )

    mesh = _mesh(base, model)
    x = torch.randn(8, 4, 12, generator=torch.Generator().manual_seed(3))
    out = {}
    for spec in (PartitionSpec("data", "model"),
                 PartitionSpec(None, "model"), PartitionSpec(("data",)),
                 PartitionSpec(None, None, ("data", "model")),
                 PartitionSpec()):
        sh = NamedSharding(mesh, spec)
        block = sh.local(x)
        mesh.collectives.reset()
        same = torch.equal(sh.gather(block), x)
        kinds = sorted(mesh.collectives.stats())
        to1 = gather_tree({"x": block}, {"x": sh}, dst=1)["x"]
        out[repr(spec)] = (same, kinds, torch.equal(to1, x)
                           if mesh.rank == 1 else to1 is None)
    return out


def run_jobs(base, jobs):
    """``{name: (function name, args)}``: each job's result, in one
    spawn (each spawn pays the ranks' start-up)."""
    torch.set_num_threads(1)  # four ranks share the test's cores
    return {name: globals()[fn](base, *args) for name, (fn, args) in
            jobs.items()}


def fail_on_rank(base, bad):
    if base.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    return base.rank


def mismatched_collectives(base, _):
    """Rank 0 issues one more all_reduce than the others: the others
    wait in their barrier until the process group times out."""
    mesh = _mesh(base, 2)
    x = torch.ones(4)
    if mesh.rank == 0:
        mesh.all_reduce(x, "odd", ("model",))
    mesh.barrier()
    return float(x.sum())

