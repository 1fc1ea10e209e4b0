"""The port's ``fused_ce`` against the JAX package's, on the CPU.

On a CPU tensor the port's wrapper computes the kernel's plain version
(``ref.py``); it is held to the JAX oracle ``fused_ce_ref`` and to the
JAX wrapper, whose Pallas kernel runs in interpret mode on the CPU, at
the shapes and tolerances of tests/test_fused_ce.py: 1e-5 for fp32 (both
sides form fp32 logits and a logsumexp, in other orders of summation),
3e-2 for bf16 (inputs rounded to bf16 once, then the same fp32 math).

The wrapper is a ``torch.autograd.Function`` on both devices, so its
plain backward (logits recomputed chunk by chunk) and its ``vmap`` rule
run here: (dx, dtable) are held to ``jax.grad`` of the JAX oracle's
(masked) mean within ``rtol = atol = 1e-5``, and both mapped cases —
tokens mapped with one shared table (the per-agent gradient prologue),
tokens and tables mapped (the lookahead probe) — to a loop over the
mapped dimension, bit for bit.  The CUDA kernel itself is built and held
against the plain version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_ce import ops as jax_ops
from repro.kernels.fused_ce import ref as jax_ref
from repro_torch.kernels.fused_ce import ops
from repro_torch.kernels.fused_ce import ref

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(128, 32, 257), (200, 64, 1000), (64, 16, 7), (130, 48, 4096)]
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(t, d, v, dtype="float32", seed=0):
    """The same inputs in both packages: numpy draws (x ~ 0.5·N, table
    ~ 0.1·N, as the JAX tests scale them) rounded once to the working
    dtype (both round to nearest even), and int32 labels."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    x = (0.5 * rng.standard_normal((t, d))).astype(np.float32)
    tbl = (0.1 * rng.standard_normal((v, d))).astype(np.float32)
    lab = rng.integers(0, v, t).astype(np.int32)
    return ((jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)),
            (jnp.asarray(tbl).astype(jd), torch.from_numpy(tbl).to(td)),
            (jnp.asarray(lab), torch.from_numpy(lab)))


@pytest.mark.parametrize("t,d,v", SHAPES)
def test_fused_ce_matches_jax_ref_and_kernel(t, d, v):
    (xj, xt), (tj, tt), (lj, lt) = _inputs(t, d, v, seed=t + v)
    nll = ops.fused_ce_nll(xt, tt, lt)
    assert nll.shape == (t,) and nll.dtype == torch.float32
    np.testing.assert_allclose(nll.numpy(),
                               np.asarray(jax_ref.fused_ce_ref(xj, tj, lj)),
                               rtol=1e-5, atol=1e-5)
    got = float(ops.fused_ce(xt, tt, lt))
    want = float(jnp.mean(jax_ref.fused_ce_ref(xj, tj, lj)))
    kernel = float(jax_ops.fused_ce(xj, tj, lj, bt=64, bv=128))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_fused_ce_dtypes(dtype, tol):
    (xj, xt), (tj, tt), (lj, lt) = _inputs(128, 32, 500, dtype, seed=1)
    got = float(ops.fused_ce(xt, tt, lt))
    want = float(jnp.mean(jax_ref.fused_ce_ref(xj, tj, lj)))
    kernel = float(jax_ops.fused_ce(xj, tj, lj, bt=64, bv=128))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, kernel, rtol=tol, atol=tol)


def test_batched_layout_is_the_flat_one():
    """(B, S, D) hidden states with (B, S) labels: the mean over all
    B·S tokens, as the JAX wrapper flattens them."""
    (_, xt), (_, tt), (_, lt) = _inputs(96, 32, 300, seed=2)
    flat = ops.fused_ce(xt, tt, lt)
    assert torch.equal(ops.fused_ce(xt.view(4, 24, 32), tt, lt.view(4, 24)),
                       flat)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [512, 48])
def test_fused_ce_gradient_matches_jax(masked, chunk, monkeypatch):
    """(dx, dtable) of the (masked) mean NLL against ``jax.grad`` of the
    JAX oracle; ``chunk = 48`` runs the backward over several ragged
    token chunks."""
    monkeypatch.setattr(ops, "BACKWARD_CHUNK", chunk)
    (xj, xt), (tj, tt), (lj, lt) = _inputs(130, 48, 1000, seed=3)
    mask = (np.random.default_rng(4).random(130) < 0.6).astype(np.float32)

    def jloss(x, tbl):
        nll = jax_ref.fused_ce_ref(x, tbl, lj)
        return (jnp.sum(nll * mask) / jnp.sum(mask) if masked
                else jnp.mean(nll))

    def tloss(x, tbl):
        nll = ops.fused_ce_nll(x, tbl, lt)
        m = torch.from_numpy(mask)
        return (nll * m).sum() / m.sum() if masked else nll.mean()

    x = xt.clone().requires_grad_(True)
    tbl = tt.clone().requires_grad_(True)
    loss = tloss(x, tbl)
    assert loss.grad_fn is not None
    got = torch.autograd.grad(loss, (x, tbl))
    want = jax.grad(jloss, argnums=(0, 1))(xj, tj)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_plain_backward_matches_autograd_of_the_plain_version():
    (_, xt), (_, tt), (_, lt) = _inputs(130, 48, 1000, seed=5)
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        130).astype(np.float32))
    leaves = [xt.clone().requires_grad_(True), tt.clone().requires_grad_(True)]
    got = torch.autograd.grad((ops.fused_ce_nll(*leaves, lt) * w).sum(),
                              leaves)
    plain = [xt.clone().requires_grad_(True), tt.clone().requires_grad_(True)]
    want = torch.autograd.grad((ref.fused_ce_ref(*plain, lt) * w).sum(),
                               plain)
    for g, p in zip(got, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), **GRAD_TOL)


def _counted(monkeypatch):
    """Count the forward's plain calls (one per would-be launch)."""
    calls = []
    plain = ops.fused_ce_lse_ref

    def counted(x, table, labels):
        calls.append((tuple(x.shape), tuple(table.shape),
                      table.stride(0)))
        return plain(x, table, labels)

    monkeypatch.setattr(ops, "fused_ce_lse_ref", counted)
    return calls


def _agents(a, t, d, v, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((0.5 * rng.standard_normal((a, t, d))).astype(
        np.float32))
    tbl = torch.from_numpy((0.1 * rng.standard_normal((a, v, d))).astype(
        np.float32))
    lab = torch.from_numpy(rng.integers(0, v, (a, t)))
    return x, tbl, lab


def test_vmap_of_grad_with_a_shared_table_is_one_forward(monkeypatch):
    """The per-agent gradient prologue: tokens and labels mapped, the
    table shared.  Equal to a loop; the forward runs once, on the table
    expanded with group stride 0 (no copy)."""
    x, tbl, lab = _agents(3, 70, 24, 300, seed=7)
    table = tbl[0]
    grad = torch.func.grad(lambda x, t, l: ops.fused_ce(x, t, l),
                           argnums=(0, 1))
    calls = _counted(monkeypatch)
    mapped = torch.func.vmap(grad, in_dims=(0, None, 0))(x, table, lab)
    assert calls == [((3, 70, 24), (3, 300, 24), 0)]
    looped = [grad(x[i], table, lab[i]) for i in range(3)]
    for j in range(2):
        assert torch.equal(mapped[j], torch.stack([g[j] for g in looped]))


def test_vmap_with_mapped_tables_is_one_forward(monkeypatch):
    """The lookahead probe: every agent's tokens with its own table,
    mapped in ONE forward (the group axis carries the tables)."""
    x, tbl, lab = _agents(3, 70, 24, 300, seed=8)
    calls = _counted(monkeypatch)
    mapped = torch.func.vmap(ops.fused_ce)(x, tbl, lab)
    assert calls == [((3, 70, 24), (3, 300, 24), 300 * 24)]
    looped = torch.stack([ops.fused_ce(x[i], tbl[i], lab[i])
                          for i in range(3)])
    assert torch.equal(mapped, looped)


def test_cpu_path_counts_no_launch():
    before = ops.fused_ce.launches
    (_, xt), (_, tt), (_, lt) = _inputs(16, 8, 10)
    ops.fused_ce(xt, tt, lt)
    assert ops.fused_ce.launches == before


@pytest.mark.parametrize("bad", ["rank", "table", "labels", "dtype",
                                 "mixed_dtype", "label_dtype", "empty",
                                 "device", "width"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, tbl, lab = torch.zeros(8, 16), torch.zeros(10, 16), torch.zeros(
        8, dtype=torch.int64)
    if bad == "rank":
        x = x[None]
    elif bad == "table":
        tbl = torch.zeros(10, 12)
    elif bad == "labels":
        lab = lab[:5]
    elif bad == "dtype":
        x, tbl = x.half(), tbl.half()
    elif bad == "mixed_dtype":
        tbl = tbl.bfloat16()
    elif bad == "label_dtype":
        lab = lab.float()
    elif bad == "empty":
        x, lab = x[:0], lab[:0]
    elif bad == "device":
        # meta is the dry-run's shape-only device: tensors on two devices
        x = x.to("meta")
    elif bad == "width":
        x, tbl = torch.zeros(8, ops.MAX_D + 1), torch.zeros(10, ops.MAX_D + 1)
    with pytest.raises((ValueError, TypeError)):
        ops.fused_ce_nll(x, tbl, lab)


@pytest.mark.parametrize("tokens,vocab", [(8192, 49152), (64, 7),
                                          (4096, 128256), (1000, 1000)])
def test_vocab_split_covers_every_tile_once(tokens, vocab):
    """The ranges of the kernel's plan tile the vocab exactly, and no
    range is empty."""
    nsplit, per = ops.vocab_split(1, tokens, vocab, sms=132)
    tiles = -(-vocab // ops.BLOCK_V)
    assert 1 <= nsplit <= min(tiles, ops.MAX_GRID)
    assert (nsplit - 1) * per < tiles <= nsplit * per


def test_kernel_build_is_named_by_source_hash():
    lib = ops.library_path()
    assert lib.parent == ops.SOURCE.parent.parent / "build"
    assert lib.name.startswith("libfused_ce_")
    assert ops.SOURCE.name == "fused_ce.cu" and ops.SOURCE.exists()
