"""The port's communication stack against the JAX package, on the CPU.

Spec strings parse and render identically; each ported compressor and
trigger, fed the same numpy inputs, agrees with its JAX counterpart
(``rtol=1e-5, atol=1e-6``; transmit decisions exactly).  The JAX stages
act on one agent and are vmapped over agents; the port's act on the
whole agent block at once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommPolicy as JCommPolicy
from repro_torch.comm import (
    CommPolicy,
    comm_stats,
    dense_bits,
    fold_sum,
    per_agent_wire_bytes,
    structural_bytes,
)
from repro_torch.comm.policy import resolve_policy, with_kernel
from repro_torch.configs.base import TrainConfig, TriggerConfig
from repro_torch.core.aggregation import masked_mean

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

# the round-trip list of tests/test_comm.py
ROUND_TRIP_SPECS = [
    "always",
    "never",
    "periodic(period=3)",
    "grad_norm(mu=4.0)",
    "grad_norm(mu=4.0,kernel=true)",
    "gain_lookahead(lam=0.1,decay=inv_t)",
    "gain_quadratic(lam=0.01,decay=geometric,decay_rate=0.9)",
    "gain_estimated(lam=0.3)",
    "gain_exact(lam=2.0)",
    "always|int8",
    "always|topk(frac=0.05)",
    "gain_lookahead(lam=0.1)|topk(frac=0.05)|int8+ef",
    "gain_lookahead|int8+ef",
    "never|identity",
]

# the full grammar: channels, the not-yet-ported stages, whitespace
GRAMMAR_SPECS = ROUND_TRIP_SPECS + [
    "always|int8 @ ideal",
    "budget_dual(rate=0.5)|int8+ef @ bernoulli(p=0.2,boost=0.05)",
    "budget_window(bytes=44.8)|fp16 @ delay(dist=geometric,lag=2.0,max_lag=6)",
    " gain_quadratic(lam=0.5,kernel=true) | topk(0.05) | int8+ef ",
    "always|bf16 @ retx(k=2,fresh=true)",
    "never|randk(0.1,seed=3)|sketch(rows=3,cols=16) @ rate(bytes_per_round=64.0)",
    "grad_norm(1.5) @ gilbert_elliott(p_gb=0.2)",
]


@pytest.mark.parametrize("spec", ROUND_TRIP_SPECS)
def test_spec_round_trip(spec):
    pol = CommPolicy.parse(spec)
    rendered = str(pol)
    again = CommPolicy.parse(rendered)
    assert again == pol
    assert str(again) == rendered


@pytest.mark.parametrize("spec", GRAMMAR_SPECS)
def test_spec_renders_like_jax(spec):
    """Same canonical rendering as the JAX package, channels included."""
    assert str(CommPolicy.parse(spec)) == str(JCommPolicy.parse(spec))


def test_heterogeneous_specs_and_describe():
    pols = CommPolicy.parse("always|int8 ; never")
    assert isinstance(pols, tuple) and len(pols) == 2
    from repro.comm import describe as jdescribe
    from repro_torch.comm import describe

    def body(text):
        return [line.split()[0] for line in text.splitlines()
                if line.startswith("  ")]

    assert body(describe()) == body(jdescribe())


def test_spec_errors():
    with pytest.raises(ValueError, match="unknown trigger"):
        CommPolicy.parse("warp_drive")
    with pytest.raises(ValueError, match="error feedback"):
        CommPolicy.parse("always|ef")
    with pytest.raises(ValueError, match="bernoulli p"):
        CommPolicy.parse("always @ bernoulli(p=2.0)").needs_net


def test_unported_stages_raise_with_roadmap_pointer():
    """Every compressor and channel stage is ported now: ``randk`` builds
    and compresses, and ``budget_dual`` given a channel's delivery draw
    prices DELIVERED transmissions (its signal EWMA sees α × d).  The
    session's durability knobs are ported too; what is still unported
    (the HLO lowering) raises with its ROADMAP item."""
    chain = CommPolicy.parse("always|randk(0.1)").chain()
    out = chain.compress(torch.arange(40.0).reshape(2, 20))
    assert ((out != 0).sum(1) == 2).all()
    trig = CommPolicy.parse("budget_dual").build_trigger(loss_fn=_tloss)
    gains = torch.tensor([-1.0, -1.0])
    d = torch.tensor([1.0, 0.0])
    (alpha, _), rows = trig(None, None, None, None, 0, torch.zeros(2, 3),
                            pre=gains, delivered=d)
    np.testing.assert_array_equal(alpha.numpy(), [1.0, 1.0])
    np.testing.assert_allclose(rows[:, 1].numpy(), [0.1, 0.0])
    assert CommPolicy.parse("always @ bernoulli(p=0.2)").needs_net
    assert not CommPolicy.parse("always @ ideal").needs_net
    from repro_torch.launch import session, steps

    opts = session.SessionOptions(ckpt_dir="ckpt", ckpt_every=5)
    assert (opts.ckpt_every, opts.resume, opts.watchdog_timeout) == (
        5, True, 0.0)
    # the dry-run's step (ROADMAP queue 1 item 12) is ported
    assert callable(steps.lower_for)


def test_policy_resolution_and_kernel_flag():
    cfg = TrainConfig(trigger=TriggerConfig(kind="gain_quadratic", lam=0.1))
    pol = resolve_policy(cfg)
    assert str(pol) == "gain_quadratic(lam=0.1)"
    assert str(with_kernel(pol)) == "gain_quadratic(lam=0.1,kernel=true)"
    assert resolve_policy(cfg, "always|int8+ef") == CommPolicy.parse(
        "always|int8+ef")
    assert with_kernel(CommPolicy.parse("always")) == CommPolicy.parse(
        "always")
    built = CommPolicy.of("gain_lookahead", "topk(0.05)", "int8",
                          error_feedback=True, lam=0.1)
    assert built == CommPolicy.parse(
        "gain_lookahead(lam=0.1)|topk(frac=0.05)|int8+ef")


# ----------------------------------------------------------------------
# compressors: the JAX per-agent stage vmapped vs the port's batched one
# ----------------------------------------------------------------------

CHAINS = ["identity", "int8", "topk(0.05)", "topk(0.25)", "fp16",
          "topk(0.05)|int8", "int8|fp16", "fp16|int8"]


@pytest.mark.parametrize("chain", CHAINS)
def test_compressor_chain_matches_jax(chain):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 64)) * 3.0).astype(np.float32)
    x[2] = 0.0  # a silent agent: the zero-safe int8 scale
    x[3, :4] = [1e-3, -1e-3, 70000.0, -2.5]  # fp16 overflow + ties
    spec = f"always|{chain}"
    jchain = JCommPolicy.parse(spec).chain()
    tchain = CommPolicy.parse(spec).chain()
    want = np.asarray(jax.vmap(jchain.compress)(jnp.asarray(x)))
    got = tchain.compress(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for bits in (32.0, 16.0):
        assert tchain.ratio_for(bits) == jchain.ratio_for(bits)
    assert CommPolicy.parse(spec).wire_ratio == \
        JCommPolicy.parse(spec).wire_ratio


def test_wire_accounting_matches_jax():
    from repro.comm import comm_stats as jstats
    from repro.comm import per_agent_wire_bytes as jper_agent

    rng = np.random.default_rng(1)
    alphas = (rng.random(8) < 0.5).astype(np.float32)
    gains = rng.standard_normal(8).astype(np.float32)
    ratios = tuple(float(r) for r in rng.random(8))
    for rs in (ratios, ratios[:1]):
        want = jstats(jnp.asarray(alphas), jnp.asarray(gains),
                      structural=128, ratios=rs)
        got = comm_stats(torch.from_numpy(alphas), torch.from_numpy(gains),
                         structural=128, ratios=rs)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_allclose(
            per_agent_wire_bytes(torch.from_numpy(alphas), structural=128,
                                 ratios=rs).numpy(),
            np.asarray(jper_agent(jnp.asarray(alphas), structural=128,
                                  ratios=rs)), rtol=RTOL)
    grads = {"w": torch.zeros(4, 6), "b": torch.zeros(4, 2,
                                                      dtype=torch.bfloat16)}
    assert structural_bytes(grads) == 6 * 4 + 2 * 2
    assert dense_bits(grads) == 8.0 * (24 * 4 + 8 * 2) / 32
    x = torch.tensor([1e8, 1.0, -1e8, 1.0])
    assert float(fold_sum(x)) == float(np.float32(np.float32(
        np.float32(1e8) + np.float32(1.0)) - np.float32(1e8)) + 1.0)


def test_masked_mean_matches_jax():
    from repro.core.aggregation import masked_mean as jmasked_mean

    rng = np.random.default_rng(2)
    g = rng.standard_normal((6, 5)).astype(np.float32)
    for alphas in (np.array([1, 0, 1, 1, 0, 1], np.float32),
                   np.zeros(6, np.float32)):
        want = jmasked_mean({"w": jnp.asarray(g)}, jnp.asarray(alphas))
        got = masked_mean({"w": torch.from_numpy(g)},
                          torch.from_numpy(alphas))
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# triggers: per-agent JAX trigger vmapped vs the port's batched trigger
# ----------------------------------------------------------------------

def _jloss(params, batch):
    xs, ys = batch
    r = xs @ params["w"] - ys
    return 0.5 * jnp.mean(r * r)


def _tloss(params, batch):
    xs, ys = batch
    r = xs @ params["w"] - ys
    return 0.5 * torch.mean(r * r)


@pytest.fixture(scope="module")
def agents():
    """Six agents' params/grads/batches/losses from one numpy draw."""
    rng = np.random.default_rng(3)
    n, N, A = 5, 12, 6
    w = rng.standard_normal(n).astype(np.float32)
    xs = rng.standard_normal((A, N, n)).astype(np.float32)
    ys = rng.standard_normal((A, N)).astype(np.float32)
    jparams = {"w": jnp.asarray(w)}
    jbatch = (jnp.asarray(xs), jnp.asarray(ys))
    jlosses, jgrads = jax.vmap(jax.value_and_grad(_jloss),
                               in_axes=(None, 0))(jparams, jbatch)
    torch_side = (
        {"w": torch.from_numpy(w)},
        {"w": torch.tensor(np.asarray(jgrads["w"]))},
        (torch.from_numpy(xs), torch.from_numpy(ys)),
        torch.tensor(np.asarray(jlosses)),
    )
    return (jparams, jgrads, jbatch, jlosses), torch_side


TRIGGER_SPECS = [
    "always", "never", "grad_norm(mu=4.0)", "grad_norm(mu=4.0,kernel=true)",
    "gain_lookahead(lam=0.05)", "gain_lookahead(lam=0.05,decay=inv_t)",
    "gain_quadratic(lam=0.05)", "gain_quadratic(lam=0.05,kernel=true)",
    "gain_quadratic(lam=0.05,decay=geometric,decay_rate=0.8,kernel=true)",
]


@pytest.mark.parametrize("scale", [None, 0.5])
@pytest.mark.parametrize("spec", TRIGGER_SPECS)
def test_trigger_matches_jax(agents, spec, scale):
    (jp, jg, jb, jl), (tp, tg, tb, tl) = agents
    eps, step = 0.1, 3
    jtrig = JCommPolicy.parse(spec).build_trigger(loss_fn=_jloss,
                                                  probe_eps=eps)
    ttrig = CommPolicy.parse(spec).build_trigger(loss_fn=_tloss,
                                                 probe_eps=eps)
    jalpha, jgain = jax.vmap(
        lambda g, b, loss: tuple(jtrig(jp, g, b, loss, step, scale)),
    )(jg, jb, jl)
    talpha, tgain = ttrig(tp, tg, tb, tl, step, scale)
    np.testing.assert_allclose(tgain.numpy(), np.asarray(jgain), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(talpha.numpy(), np.asarray(jalpha))
    if hasattr(jtrig, "prologue"):
        assert ttrig.prologue_key == jtrig.prologue_key
        pre = ttrig.prologue(tp, tg, tb, tl)
        jpre = jax.vmap(lambda g, b, loss: jtrig.prologue(jp, g, b, loss))(
            jg, jb, jl)
        np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), rtol=RTOL,
                                   atol=ATOL)
        again = ttrig(tp, tg, tb, tl, step, scale, pre=pre)
        np.testing.assert_array_equal(again.alpha.numpy(), talpha.numpy())


def test_quadratic_gain_kernel_and_plain_agree(agents):
    _, (tp, tg, tb, tl) = agents
    fused, plain = (
        CommPolicy.parse(f"gain_quadratic(lam=0.05{k})").build_trigger(
            loss_fn=_tloss, probe_eps=0.1).prologue(tp, tg, tb, tl)
        for k in (",kernel=true", ""))
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)
    # a threshold inside the gains' range gates both ways
    lam = -float(fused.median())
    alpha = CommPolicy.parse(f"gain_quadratic(lam={lam},kernel=true)") \
        .build_trigger(loss_fn=_tloss, probe_eps=0.1)(tp, tg, tb, tl, 0).alpha
    assert 0 < float(alpha.sum()) < alpha.numel()


@pytest.mark.parametrize("fmt", ["int8", "fp16", "bf16"])
def test_wire_spacing_and_rounding_ties(fmt):
    """``spacing`` is the distance between the two wire values around
    each entry (the wire value lies within half of it), and
    ``rounding_ties`` gives that spacing exactly at the entries that
    round apart when moved by ±``tol``, 0 elsewhere: half the entries
    are planted on a midpoint, a quarter of ``tol`` off it."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 64)) * 10.0 ** rng.integers(
        -6, 3, (3, 64))).astype(np.float32)
    x[:, 0] = 1000.0  # each row's largest entry: the int8 scale
    chain = CommPolicy.parse(f"always|{fmt}").chain()
    step = chain.spacing(torch.from_numpy(x)).numpy()
    wire = chain.compress(torch.from_numpy(x)).numpy()
    if fmt == "int8":
        np.testing.assert_array_equal(step, np.float32(1000.0 / 127.0))
    else:
        dtype = torch.float16 if fmt == "fp16" else torch.bfloat16
        up = torch.from_numpy(np.abs(x)).to(dtype).float().numpy()
        # the next wire value above |x|'s rounding, one spacing on
        nxt = torch.from_numpy(up + step).to(dtype).float().numpy()
        np.testing.assert_array_equal(nxt - up, step)
    assert np.all(np.abs(wire - x) <= step / 2)
    levels = np.floor(np.abs(x) / step)
    x[:, 1::2] = (np.sign(x) * (levels + 0.5) * step
                  + 0.25e-3 * step)[:, 1::2]
    step = chain.spacing(torch.from_numpy(x)).numpy()
    tol = 1e-3 * step
    ties = chain.rounding_ties(torch.from_numpy(x),
                               torch.from_numpy(tol)).numpy()

    def sent(v):
        return chain.compress(torch.from_numpy(v.astype(np.float32))
                              ).numpy() if fmt != "int8" else np.round(
            v / step)

    moved = sent(x - tol) != sent(x + tol)
    assert moved[:, 1::2].all() and not moved[:, 0].any()
    np.testing.assert_array_equal(ties, np.where(moved, step, 0.0))
