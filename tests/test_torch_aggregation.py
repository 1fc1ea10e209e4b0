"""``repro_torch.core.aggregation`` against ``repro.core.aggregation``
on the same numpy inputs, on the CPU: the masked mean of eq. (10), its
whole-tree int8 and top-k variants with and without error feedback,
and the round statistics."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro_torch.core import aggregation as tagg

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(17)
    grads = {"b": rng.standard_normal((5, 3)).astype(np.float32),
             "w": rng.standard_normal((5, 4, 6)).astype(np.float32)}
    mem = {k: 0.1 * rng.standard_normal(v.shape).astype(np.float32)
           for k, v in grads.items()}
    return grads, mem


ALPHAS = {"some": [1.0, 0.0, 1.0, 1.0, 0.0], "none": [0.0] * 5,
          "all": [1.0] * 5}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want):
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("which", list(ALPHAS))
def test_masked_mean_variants_match_jax(inputs, which, ef):
    grads, mem = inputs
    a = np.asarray(ALPHAS[which], np.float32)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    _close(tagg.masked_mean(_t(grads), ta), jagg.masked_mean(_j(grads), ja))
    tm = _t(mem) if ef else None
    jm = _j(mem) if ef else None
    for got, want in (
        (tagg.masked_mean_quantized(_t(grads), ta, tm),
         jagg.masked_mean_quantized(_j(grads), ja, jm)),
        (tagg.masked_mean_topk(_t(grads), ta, 0.25, tm),
         jagg.masked_mean_topk(_j(grads), ja, 0.25, jm)),
    ):
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("which", list(ALPHAS))
def test_aggregate_stats_match_jax(which):
    a = np.asarray(ALPHAS[which], np.float32)
    g = np.linspace(-2.0, 1.0, 5).astype(np.float32)
    got = tagg.aggregate_stats(torch.from_numpy(a), torch.from_numpy(g))
    want = jagg.aggregate_stats(jnp.asarray(a), jnp.asarray(g))
    assert got._fields == want._fields
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL)
