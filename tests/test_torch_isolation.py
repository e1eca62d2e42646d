"""The port stands alone: with ``jax`` and the JAX package blocked from
import, every module of ``outerspace_tpu_torch`` imports and the main
path runs on the CPU; and no source of the port names either."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_RUN = r"""
import importlib, pkgutil, sys

class Blocker:
    BLOCKED = ("jax", "outerspace_tpu")

    def find_spec(self, name, path=None, target=None):
        for b in self.BLOCKED:
            if name == b or name.startswith(b + "."):
                raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
for b in Blocker.BLOCKED:
    for mod in [m for m in sys.modules if m == b or m.startswith(b + ".")]:
        del sys.modules[mod]

import outerspace_tpu_torch
names = [m.name for m in pkgutil.walk_packages(outerspace_tpu_torch.__path__, "outerspace_tpu_torch.")]
for name in names:
    importlib.import_module(name)
try:
    import jax  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("blocker failed")

from outerspace_tpu_torch.formats import rmat
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm, spgemm_scipy

a = rmat(6, edge_factor=8, seed=5)
assert_csr_allclose(spgemm(a, a, device="cpu"), spgemm_scipy(a, a), rtol=1e-5)
leaked = [m for m in sys.modules if m in Blocker.BLOCKED or m.startswith(("jax.", "outerspace_tpu."))]
assert not leaked, leaked
print("isolated", len(names))
"""


def test_port_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("isolated")
    assert int(out.stdout.split()[1]) >= 15


def port_sources():
    root = os.path.join(REPO, "outerspace_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_name_no_jax():
    sources = list(port_sources())
    assert len(sources) >= 17
    for path in sources:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for banned in ("outerspace_tpu.", "import jax"):
            assert banned not in text, f"{path} contains {banned!r}"
