"""The comm epilogue on model blocks (``repro_torch.sharding.blocks``):
on a (data, model) mesh each agent's gradient, its EF memory and its
payload are the rank's model block of every leaf, and each compressor's
block form gives the whole leaf's result.

One spawn of 4 gloo ranks on the CPU (``tests/torch_mesh_ranks.py``,
which imports no JAX) runs, on reduced smollm-135m's leaf shapes at
(data 2, model 2):

* every compressor on the same per-agent gradients, the block under the
  mesh step's context against the whole leaf's result cut to the block:
  ``int8``'s values and scale bitwise (its scale is a maximum over
  "model"), ``topk``'s kept set bitwise (each block's k largest gathered
  over "model"), ``fp16``/``bf16`` bitwise (elementwise), ``randk``
  bitwise on integer-valued gradients, whose fp32 sums (the salt: the
  blocks' sums summed over "model") are exact, and the sketch's counter
  grid within the fp32 rounding of a reassociated sum (each bucket's
  Σ|s·x| times its entries' count times 2^-24) and its decoded blocks
  within the counters' largest gap (a median moves no more);
* one train step (``int8+ef``, fsdp off): each rank holds 1/model of
  every split leaf of its agent's EF memory at rest, and its payload
  reduce carries the blocks.

The parity of the JAX name ``AgentStage`` is checked in-process.
"""
import pytest
import torch

import test_torch_mesh_lm as lm
import torch_mesh_ranks as ranks
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import spawn

torch.set_num_threads(1)

CHAINS = ("int8", "topk(0.05)", "fp16", "bf16", "randk(0.1)",
          "sketch(rows=5,cols=64)", "topk(0.05)|int8")
INTEGER = ("randk(0.1)",)
EF_JOB = dict(lm._job(lm.P2, False, False, steps=1))


@pytest.fixture(scope="module")
def runs():
    jobs = dict(lm.rank_args({"ef": EF_JOB}),
                forms=("epilogue_forms", (dict(chains=CHAINS,
                                               integer=INTEGER, seed=3),)))
    return spawn(ranks.run_jobs, 4, timeout_s=240, device="cpu",
                 args=(jobs,))


@pytest.mark.parametrize("chain", CHAINS)
def test_block_form_matches_the_whole_leaf(runs, chain):
    """Every rank's block of every leaf against the whole leaf's result
    (the module doc's tolerances)."""
    for r in runs:
        rec = r["forms"][chain]
        # reduced smollm: the 7 stacked weights and the table split over
        # model 2, the three norms whole
        assert (rec["leaves"], rec["split"]) == (11, 8), rec
        if chain.startswith("sketch"):
            # the median of the rows' estimates moves no more than the
            # counters it reads
            assert rec["sketch_over_bound"] <= 1.0, rec
            assert rec["gap"] <= rec["sketch_grid_gap"], rec
            continue
        assert rec["bitwise"], (chain, rec)
        if chain == "int8":
            assert rec["int8_bitwise"], rec


def test_each_rank_holds_its_blocks_of_the_ef_memory(runs):
    """After a step each rank's EF memory at rest is its agent's (one of
    m = 2 on its data slice) model block of every leaf: half of each
    split leaf, the norms whole; the payload reduce carries those
    blocks' bytes; the gathered EF memory is every agent's whole tree
    (the step itself is held to JAX in tests/test_torch_mesh_lm.py)."""
    from repro_torch.models import build
    from repro_torch.utils.tree import tree_leaves

    cfg = reduced(get_config("smollm-135m"))
    shapes, _ = build(cfg).init(abstract=True)
    norm = (2 * cfg.num_layers + 1) * cfg.d_model * 4
    whole = sum(x.numel() * 4 for x in tree_leaves(shapes))
    block = (whole - norm) // 2 + norm
    for r in runs:
        step = r["ef"]["steps"][0]
        assert step["ef_bytes"] == block, (step["ef_bytes"], block, whole)
        assert step["by_tag"]["payload"]["operand_bytes"] == block
        assert sum(v.nbytes for v in step["ef"].values()) == 2 * whole
    lm.check_job(runs, "ef", EF_JOB)


def test_agent_stage_is_the_jax_alias():
    """``AgentStage`` names the epilogue signature, as JAX's alias."""
    from repro.comm import bank as jbank
    from repro_torch.comm import bank

    assert bank.AgentStage is bank.AgentEpilogue
    assert jbank.AgentStage is jbank.AgentEpilogue
