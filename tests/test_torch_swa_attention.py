"""The port's ``swa_attention`` against the JAX package's, on the CPU.

On a CPU tensor the port's wrapper computes the kernel's plain version
(``ref.py``); it is held to the JAX oracle ``swa_attention_ref`` and to
the JAX wrapper, whose Pallas kernel runs in interpret mode on the CPU,
at the shapes and tolerances of tests/test_kernels.py: 2e-5 for fp32
(both sides compute the softmax in fp32 and differ only in the order of
their sums), 3e-2 for bf16 (one bf16 rounding of the output).  The CUDA
kernel itself is built and held against the plain version on the card
by ``chip_smoke.py``.

The wrapper is a ``torch.autograd.Function`` on both devices, so its
plain backward and its ``vmap`` rule run here: gradients are held to
autograd through the plain version and to ``jax.grad`` of the JAX
oracle within ``rtol = atol = 1e-5`` (fp32, sums in other orders), and
``torch.func.vmap`` of its gradient to a loop over the mapped dimension
bit for bit (the same ops on the same slices).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention import ops as jax_ops
from repro.kernels.swa_attention import ref as jax_ref
from repro.models.attention import attend as jax_attend
from repro_torch.kernels.swa_attention import ops
from repro_torch.kernels.swa_attention import ref
from repro_torch.models import attention as A
from repro_torch.utils.device import resolve_device

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(b, s, h, kv, hd, dtype="float32", seed=0):
    """The same inputs in both packages: numpy draws rounded once to the
    working dtype (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    out = []
    for heads in (h, kv, kv):
        x = rng.standard_normal((b, s, heads, hd)).astype(np.float32)
        out.append((jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)))
    return out


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


@pytest.mark.parametrize("s", [64, 128, 200, 384])
@pytest.mark.parametrize("window", [32, 128, 1 << 30])
def test_swa_matches_jax_ref_and_kernel(s, window):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, s, 4, 2, 64, seed=s + window % 997)
    got = ops.swa_attention(qt, kt, vt, window=window)
    assert got.shape == (2, s, 4, 64) and got.dtype == torch.float32
    oracle = jax_ref.swa_attention_ref(qj, kj, vj, window=window)
    kernel = jax_ops.swa_attention(qj, kj, vj, window=window, bq=64, bk=64)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(got), _np(kernel), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_swa_dtypes(dtype, atol):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 128, 2, 1, 64, dtype, seed=3)
    got = ops.swa_attention(qt, kt, vt, window=64)
    assert got.dtype == DTYPES[dtype][1]
    want = jax_ops.swa_attention(qj, kj, vj, window=64, bq=64, bk=64)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=atol)


def test_swa_head_dim_128():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 160, 6, 2, 128, seed=5)
    got = ops.swa_attention(qt, kt, vt, window=96)
    want = jax_ref.swa_attention_ref(qj, kj, vj, window=96)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [48, None])
def test_model_attention_is_the_kernel_path(window):
    """The port's causal ``attention`` (what prefill and forward call) is
    ``swa_attention``, and equals the JAX model's ``attend``."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 96, 4, 2, 64, seed=11)
    got = A.attention(qt, kt, vt, causal=True, window=window)
    via_ops = ops.swa_attention(qt, kt, vt, window=window or 96)
    assert torch.equal(got, via_ops)
    want = jax_attend(qj, kj, vj, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_cpu_path_counts_no_launch():
    before = ops.swa_attention.launches
    (_, qt), (_, kt), (_, vt) = _qkv(1, 16, 2, 2, 64)
    ops.swa_attention(qt, kt, vt, window=4)
    assert ops.swa_attention.launches == before


def test_strided_model_layout_input():
    """A head-major tensor viewed in the model layout gives the same
    result as its contiguous copy (the kernel reads strides)."""
    (_, qt), (_, kt), (_, vt) = _qkv(2, 40, 4, 2, 64, seed=2)
    q_hm = qt.transpose(1, 2).contiguous().transpose(1, 2)
    assert not q_hm.is_contiguous()
    assert torch.equal(ops.swa_attention(q_hm, kt, vt, window=8),
                       ops.swa_attention(qt, kt, vt, window=8))


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed_dtype",
                                 "gqa", "window", "rank", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 2, 64),
               torch.zeros(1, 8, 2, 64))
    window = 4
    if bad == "head_dim":
        # hd 48 has no kernel instance: the card's path raises before the
        # launch; a CPU tensor gets the plain version at any hd
        # (tests/test_torch_head_dims.py)
        with pytest.raises(ValueError, match="head dim 48 not supported"):
            ops.check_head_dim(48)
        return
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "gqa":
        k = v = torch.zeros(1, 8, 3, 64)
    elif bad == "window":
        window = 0
    elif bad == "rank":
        q = q[0]
    elif bad == "device":
        # meta is the dry-run's shape-only device: tensors on two devices
        q = q.to("meta")
    with pytest.raises((ValueError, TypeError)):
        ops.swa_attention(q, k, v, window=window)


def test_cuda_request_without_cuda_raises():
    """No entry point moves to the CPU on its own: asking for the card
    on a machine without CUDA raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def test_kernel_build_is_named_by_source_hash():
    lib = ops.library_path()
    assert lib.parent == ops.SOURCE.parent.parent / "build"
    assert lib.name.startswith("libswa_attention_")
    assert ops.SOURCE.name == "swa_attention.cu" and ops.SOURCE.exists()


# ----------------------------------------------------------------------
# the gradient (plain backward) and the vmap rule
# ----------------------------------------------------------------------

GRAD_SHAPE = (2, 96, 4, 2, 64)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _weights(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("window", [32, 96, 1 << 30])
def test_swa_gradient_matches_autograd_and_jax(window):
    """d/d(q, k, v) of Σ w ⊙ attention: the Function's backward against
    autograd through the plain version and ``jax.grad`` of the JAX
    oracle."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(*GRAD_SHAPE, seed=17)
    w = _weights(qt.shape, 18)
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    out = ops.swa_attention(*leaves, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    plain = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    want = torch.autograd.grad(
        (ref.swa_attention_ref(*plain, window=window)
         * torch.from_numpy(w)).sum(), plain)
    jgrads = jax.grad(
        lambda q, k, v: jnp.sum(jax_ref.swa_attention_ref(q, k, v,
                                                          window=window) * w),
        argnums=(0, 1, 2))(qj, kj, vj)
    for g, p, j in zip(got, want, jgrads):
        assert g.shape == p.shape
        np.testing.assert_allclose(g.numpy(), p.numpy(), **GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **GRAD_TOL)


@pytest.mark.parametrize("window", [32, 1 << 30])
def test_swa_vmap_of_grad_equals_a_loop(window, monkeypatch):
    """``vmap(grad)`` over a mapped q, k (v shared) equals a Python loop
    over the mapped dimension, and the forward runs ONCE for all three
    slices (the vmap rule folds them into the batch)."""
    b, s, h, kv, hd = GRAD_SHAPE
    rng = np.random.default_rng(23)
    qa = torch.from_numpy(rng.standard_normal((3, b, s, h, hd), np.float32))
    ka = torch.from_numpy(rng.standard_normal((3, b, s, kv, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kv, hd), np.float32))
    w = torch.from_numpy(_weights((b, s, h, hd), 24))

    def loss(q, k, v):
        return (ops.swa_attention(q, k, v, window=window) * w).sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2))
    calls = []
    plain = ops.swa_attention_ref

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(ops, "swa_attention_ref", counted)
    mapped = torch.func.vmap(grad, in_dims=(0, 0, None))(qa, ka, v)
    assert calls == [torch.Size((3 * b, s, h, hd))]
    looped = [grad(qa[i], ka[i], v) for i in range(3)]
    for j in range(3):
        assert torch.equal(mapped[j], torch.stack([g[j] for g in looped]))
