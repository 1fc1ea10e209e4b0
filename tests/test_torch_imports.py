"""The port runs where only torch is installed: importing every module of
``repro_torch`` and ``chip_smoke.py`` loads neither ``jax`` nor the JAX
package ``repro``.  Checked in a fresh interpreter, since this test
process has imported both."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

GUARD = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {repo!r}]
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert len(names) >= {floor}, names
missing = sorted(set({required!r}) - set(names))
assert not missing, missing
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print(len(names))
"""


# the package's module count: a module dropped from the walk (renamed,
# or left without an __init__) fails the floor
MODULE_FLOOR = 94
# modules of the LM train path that the walk must reach by name
REQUIRED = ("repro_torch.kernels.fused_ce.ops", "repro_torch.launch.train",
            "repro_torch.launch.steps", "repro_torch.optim.schedules",
            "repro_torch.checkpoint.checkpointer", "repro_torch.launch.faults",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.xlstm", "repro_torch.configs.whisper_medium",
            "repro_torch.configs.phi3_vision_4_2b",
            "repro_torch.configs.xlstm_350m", "repro_torch.utils.remat",
            "repro_torch.analysis.cost", "repro_torch.analysis.roofline",
            "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
            "repro_torch.launch.mesh", "repro_torch.sharding.rules",
            "repro_torch.sharding.agent_shard",
            "repro_torch.sharding.collectives",
            "repro_torch.sharding.constraint",
            "repro_torch.sharding.placement",
            "repro_torch.analysis.hlo_stats")


def test_port_imports_no_jax_and_nothing_of_repro():
    code = GUARD.format(src=str(REPO / "src"), repo=str(REPO),
                        floor=MODULE_FLOOR, required=REQUIRED)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= MODULE_FLOOR
