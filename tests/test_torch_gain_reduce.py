"""The port's ``gain_reduce`` against the JAX package's, on the CPU.

On a CPU tensor the port's wrapper computes the kernel's plain version
(``ref.py``); the JAX op runs its Pallas kernel in interpret mode on the
CPU.  Shapes, dtypes and tolerances are those of tests/test_kernels.py:
``atol = 1e-5·size`` (fp32) or ``2e-2·size`` (bf16), ``rtol = 1e-4``.
The CUDA kernel itself is built and held against the plain version on
the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gain_reduce import ops as jax_ops
from repro.kernels.gain_reduce import ref as jax_ref
from repro_torch.kernels.gain_reduce import ops
from repro_torch.kernels.gain_reduce import ref

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(shape, dtype, seed):
    """The same inputs in both packages: numpy draws rounded once to the
    working dtype (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    out = []
    for _ in range(2):
        x = rng.standard_normal(shape).astype(np.float32)
        xj = jnp.asarray(x).astype(jd)
        xt = torch.from_numpy(x).to(td)
        np.testing.assert_array_equal(np.asarray(xj.astype(jnp.float32)),
                                      xt.float().numpy())
        out.append((xj, xt))
    return out


def _tol(size, dtype):
    return 1e-5 * size if dtype == "float32" else 2e-2 * size


@pytest.mark.parametrize(
    "shape", [(7,), (1024,), (1000, 37), (8, 128), (3, 5, 17), (4096, 64)]
)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gain_reduce_matches_jax(shape, dtype):
    (gj, gt), (hj, ht) = _pair(shape, dtype, seed=sum(shape))
    want = [float(v) for v in jax_ops.gain_reduce(gj, hj)]
    oracle = [float(v) for v in jax_ref.gain_reduce_ref(gj, hj)]
    got = ops.gain_reduce(gt.reshape(-1), ht.reshape(-1))
    assert got.shape == (2,) and got.dtype == torch.float32
    tol = _tol(gt.numel(), dtype)
    for g, w, o in zip(got.tolist(), want, oracle):
        np.testing.assert_allclose(g, w, atol=tol, rtol=1e-4)
        np.testing.assert_allclose(g, o, atol=tol, rtol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_rows_match_per_row_jax(dtype):
    """The (A, N) form — what the hybrid prologue calls with every
    agent's gradient rows — against a loop of the JAX op per row."""
    (gj, gt), (hj, ht) = _pair((6, 1000), dtype, seed=7)
    got = ops.gain_reduce(gt, ht)
    assert got.shape == (6, 2)
    tol = _tol(1000, dtype)
    for i in range(6):
        want = [float(v) for v in jax_ops.gain_reduce(gj[i], hj[i])]
        np.testing.assert_allclose(got[i].tolist(), want, atol=tol,
                                   rtol=1e-4)


def test_cpu_path_counts_no_launch():
    before = ops.gain_reduce.launches
    g = torch.ones(3, 5)
    np.testing.assert_array_equal(ops.gain_reduce(g, 2 * g).numpy(),
                                  [[5.0, 10.0]] * 3)
    assert ops.gain_reduce.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "empty", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    g = torch.zeros(4, 8)
    h = {"shape": torch.zeros(4, 9), "dtype": torch.zeros(4, 8).double(),
         "empty": None, "rank": None}[bad]
    if bad == "empty":
        g = h = torch.zeros(0, 8)
    if bad == "rank":
        g = h = torch.zeros(2, 4, 8)
    with pytest.raises((ValueError, TypeError)):
        ops.gain_reduce(g, h)


def test_kernel_build_is_named_by_source_hash():
    lib = ops.library_path()
    assert lib.parent == ops.BUILD_DIR
    assert ops.SOURCE.name == "gain_reduce.cu" and ops.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in ops.NVCC_FLAGS


def test_vmap_folds_lanes_into_rows_on_the_cpu():
    """The ``vmap`` rule: the mapped dims fold into the rows, so a map
    over 16 lanes of (64, 32) (and 4 × 4 nested, and a map over dim 1)
    equals the plain version lane by lane; the CPU path counts no
    launch."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((16, 64, 32)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((16, 64, 32)).astype(np.float32))
    before = ops.gain_reduce.launches
    want = torch.stack([ref.gain_reduce_ref(g[i], h[i]) for i in range(16)])
    got = torch.func.vmap(ops.gain_reduce)(g, h)
    assert got.shape == (16, 64, 2) and torch.equal(got, want)
    nested = torch.func.vmap(torch.func.vmap(ops.gain_reduce))(
        g.reshape(4, 4, 64, 32), h.reshape(4, 4, 64, 32))
    assert torch.equal(nested.reshape(16, 64, 2), want)
    # mapped over dim 1 of g, h shared by every lane (unmapped)
    moved = torch.func.vmap(ops.gain_reduce, in_dims=(1, None))(
        g.transpose(0, 1), h[0])
    assert torch.equal(moved, torch.stack(
        [ref.gain_reduce_ref(g[i], h[0]) for i in range(16)]))
    # 1-D rows under the map: one (2,) result per lane
    rows = torch.func.vmap(ops.gain_reduce)(g[:, 0], h[:, 0])
    assert torch.equal(rows, want[:, 0])
    assert ops.gain_reduce.launches == before


def test_vmap_rule_matches_jax_per_lane():
    """Each lane of the mapped call against the JAX op on that lane."""
    (gj, gt), (hj, ht) = _pair((4, 8, 128), "float32", seed=11)
    got = torch.func.vmap(ops.gain_reduce)(gt, ht)
    for i in range(4):
        for r in range(8):
            want = np.asarray(jax_ops.gain_reduce(gj[i, r], hj[i, r]))
            np.testing.assert_allclose(got[i, r].numpy(), want,
                                       atol=_tol(128, "float32"), rtol=1e-4)
