"""The LM train step on a data-only (4, 1) mesh of gloo ranks with fsdp
on, for the moe, hybrid, ssm, audio and vlm families (the dense one is
in tests/test_torch_mesh_lm.py, whose harness this file reuses), against
the JAX package's unsharded step.  The parameters are gathered over the
data axis at the start of a round and the gather hook hands every use
site the whole leaf, where the JAX package leaves the layout to XLA.
"""
import pytest

import test_torch_mesh_lm as M
import torch_mesh_ranks as ranks
from repro_torch.launch.mesh import spawn

JOBS = {f"data_only_{arch}": M._job(M.P1, True, False, arch=arch, model=1,
                                    m=4, steps=1)
        for arch in M.FAMILIES}


@pytest.fixture(scope="module")
def results():
    return spawn(ranks.run_jobs, 4, timeout_s=M.TIMEOUT_S, device="cpu",
                 args=(M.rank_args(JOBS),))


@pytest.mark.parametrize("name", sorted(JOBS))
def test_data_only_mesh_step_matches_jax(results, name):
    M.check_job(results, name, JOBS[name])
    layers = [r[name]["steps"][0]["launches"] for r in results]
    assert all(ce == 2 for _, ce in layers), layers
