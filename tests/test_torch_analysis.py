"""The dry-run's inputs and counts against the JAX package's, on the CPU.

Everything here is abstract and at full width: the port's ``SHAPES``,
``runs_shape`` (flag and reason), ``input_axes``, ``input_specs`` (empty
``meta`` tensors) and the abstract parameter and cache trees
(``init(abstract=True)``, ``init_cache(device="meta")``) against the
JAX package's ``jax.ShapeDtypeStruct`` stand-ins for every arch × shape,
by ``keystr`` path, shape and dtype; ``model_flops``; ``lower_for``'s
``argument_bytes`` against the JAX step builders' abstract arguments
(the port keeps the train state's round counter on the host, the JAX
package's is a 0-d int32 leaf: 4 bytes); and the cost counter's product
flops against ``hlo_cost.analyze``'s dots for one SwiGLU MLP block and
one attention projection at toy width, exactly (both count 2·M·N·K).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo_cost
from repro.analysis.roofline import model_flops as jax_model_flops
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import steps as JS
from repro.models import build as jax_build
from repro.models import input_axes as jax_input_axes
from repro.models import input_specs as jax_input_specs
from repro.models import runs_shape as jax_runs_shape
from repro.models import layers as JL
from repro_torch.analysis.cost import CostCounter
from repro_torch.analysis.roofline import (
    PEAK_FLOPS,
    Roofline,
    kernel_bound,
    model_flops,
    step_path,
)
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import steps as S
from repro_torch.models import build, input_axes, input_specs, runs_shape
from repro_torch.models import decode as D
from repro_torch.models.attention import abstract_kv_cache
from repro_torch.models.layers import swiglu

torch.set_num_threads(1)

ARCHS = list_archs()


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(p), leaf) for p, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _same_tree(port, ref):
    """Equal ``keystr`` paths, shapes and dtypes, every port leaf on
    ``meta``."""
    got, want = _flatten(port), _jax_leaves(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        assert x.device.type == "meta", path
        assert tuple(x.shape) == tuple(y.shape), path
        assert str(x.dtype).removeprefix("torch.") == str(y.dtype), path


def _agents(shape):
    return 16 if shape.kind == "train" else 1


def test_shapes_equal_jax():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        ref = JAX_SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch,
                shape.kind) == (ref.name, ref.seq_len, ref.global_batch,
                                ref.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_runs_shape_and_input_axes_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        assert runs_shape(cfg, shape) == jax_runs_shape(jcfg,
                                                        JAX_SHAPES[name])
        m = _agents(shape)
        assert input_axes(cfg, shape, num_agents=m) == jax_input_axes(
            jcfg, JAX_SHAPES[name], num_agents=m)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        m = _agents(shape)
        _same_tree(input_specs(cfg, shape, num_agents=m),
                   jax_input_specs(jcfg, JAX_SHAPES[name], num_agents=m))
    _same_tree(input_specs(cfg, SHAPES["prefill_32k"],
                           compute_dtype=torch.float32),
               jax_input_specs(jcfg, JAX_SHAPES["prefill_32k"],
                               compute_dtype=jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_cache_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params, axes = build(cfg).init(abstract=True)
    jparams, jaxes = jax_build(jcfg).init(abstract=True)
    _same_tree(params, jparams)
    assert axes == jaxes
    bf16, _ = build(cfg).init(abstract=True, dtype=torch.bfloat16)
    _same_tree(bf16, jax_build(jcfg).init(abstract=True,
                                          dtype=jnp.bfloat16)[0])
    cache, cache_axes = D.init_cache(cfg, 3, 40, device="meta")
    jcache, jcache_axes = jax_build(jcfg).init_cache(3, 40, abstract=True)
    _same_tree(cache, jcache)
    assert cache_axes == jcache_axes


def test_abstract_kv_cache_and_meta_device():
    from repro.models.attention import abstract_kv_cache as jax_abstract

    _same_tree(abstract_kv_cache(2, 16, 3, 64, torch.bfloat16),
               jax_abstract(2, 16, 3, 64, jnp.bfloat16))
    with pytest.raises(ValueError, match="Generator"):
        build(get_config("smollm-135m")).init()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        assert model_flops(cfg, shape) == jax_model_flops(jcfg,
                                                          JAX_SHAPES[name])


def _jax_argument_bytes(arch: str, shape_name: str) -> int:
    """The JAX step builders' abstract arguments, in bytes: the train
    step's state and batch (``build_train_step`` on a one-device mesh),
    prefill's and decode's parameters at the compute dtype and
    ``input_specs``."""
    jcfg, shape = jax_get_config(arch), JAX_SHAPES[shape_name]
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    plan = JS.plan_run(jcfg, shape, mesh)
    if shape.kind == "train":
        _, state, batch, *_ = JS.build_train_step(mesh, plan)
        args = (state, batch)
    else:
        cfg = plan.cfg.replace(compute_dtype="bfloat16")
        params, _ = jax_build(cfg).init(abstract=True, dtype=jnp.bfloat16)
        args = (params, jax_input_specs(cfg, shape))
    return sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(args))


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b",
                                  "zamba2-1.2b", "whisper-medium"])
def test_argument_bytes_equal_jax(arch):
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        plan = S.plan_run(get_config(arch), SHAPES[name])
        got = S.lower_for(plan).argument_bytes
        host_step = 4 if SHAPES[name].kind == "train" else 0
        assert got == _jax_argument_bytes(arch, name) - host_step, name


def _jax_dot_flops(fn, *args) -> float:
    comps, _ = hlo_cost.parse_module(
        jax.jit(fn).lower(*args).compile().as_text())
    return sum(hlo_cost._dot_flops(ins, comp) for comp in comps.values()
               for ins in comp.instrs if ins.opcode == "dot")


def _counted(fn, *args) -> CostCounter:
    with CostCounter() as counter:
        fn(*args)
    return counter


def test_dot_flops_equal_hlo_cost():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 32), dtype=np.float32)
    w = {k: rng.standard_normal(s, dtype=np.float32) for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    want = _jax_dot_flops(JL.swiglu, {k: jnp.asarray(v) for k, v in
                                      w.items()}, jnp.asarray(x))
    got = _counted(swiglu, {k: torch.from_numpy(v) for k, v in w.items()},
                   torch.from_numpy(x))
    assert want == 3 * 2 * 16 * 32 * 48
    assert got.dot_flops == want
    wq = rng.standard_normal((32, 4, 8), dtype=np.float32)
    proj = "bsd,dhk->bshk"
    want = _jax_dot_flops(lambda a, b: jnp.einsum(proj, a, b),
                          jnp.asarray(x), jnp.asarray(wq))
    got = _counted(lambda a, b: torch.einsum(proj, a, b),
                   torch.from_numpy(x), torch.from_numpy(wq))
    assert want == 2 * 16 * 32 * 32
    assert got.dot_flops == want


def test_roofline_terms_and_kernel_bound():
    cfg, shape = get_config("smollm-135m"), SHAPES["train_4k"]
    roof = Roofline(arch=cfg.name, shape=shape.name, mesh="h100x1",
                    chips=1, flops_per_device=2.0e15,
                    bytes_per_device=6.7e12, wire_bytes_per_device=0.0,
                    model_flops_global=model_flops(cfg, shape),
                    path=step_path("bfloat16"))
    assert roof.t_compute == pytest.approx(2.0e15 / 989e12)
    assert roof.t_memory == pytest.approx(2.0)
    assert roof.t_collective == 0.0 and roof.bottleneck == "compute"
    assert roof.mfu_bound == pytest.approx(
        roof.model_flops_global / (989e12 * roof.t_compute))
    assert step_path("float32") == "fp32" and PEAK_FLOPS["fp32"] == 67e12
    assert kernel_bound(67e9, 1.0, "fp32") == pytest.approx((1.0,
                                                             "operations"))
    assert kernel_bound(1.0, 3.35e9, "bf16-mma") == pytest.approx(
        (1.0, "bytes"))
