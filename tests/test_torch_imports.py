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
assert len(names) >= 20, names
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    code = GUARD.format(src=str(REPO / "src"), repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
