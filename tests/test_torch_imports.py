"""Import boundary of the PyTorch port.

madrona_tpu_torch, chip_smoke.py, the port's scripts
(scripts/torch_*.py; chip_smoke.py loads two) and its learners
(examples/torch_*.py; chip_smoke.py loads them too) run on machines without
JAX: no module of theirs may import jax or anything of the JAX package
(madrona_tpu), not even a numpy-only module; nor triton, which no kernel
of the port uses and the CPU machines lack. Checked by parsing every
source file, and by importing the package in a fresh interpreter."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "madrona_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
] + sorted((ROOT / "scripts").glob("torch_*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "madrona_tpu", "triton")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_no_jax_import(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_import_leaves_jax_out():
    code = (
        "import sys; import madrona_tpu_torch; "
        "import madrona_tpu_torch.models.escape_room, "
        "madrona_tpu_torch.interop, madrona_tpu_torch.ops.broadphase_cuda, "
        "madrona_tpu_torch.ops.contacts_cuda, "
        "madrona_tpu_torch.ops.solver_cuda, "
        "madrona_tpu_torch.ops.raycast_cuda, madrona_tpu_torch.render, "
        "madrona_tpu_torch.render.kernel, "
        "madrona_tpu_torch.render.blas, madrona_tpu_torch.render.tlas, "
        "madrona_tpu_torch.render.materials, "
        "madrona_tpu_torch.render.lights, madrona_tpu_torch.assets, "
        "madrona_tpu_torch.assets.png, madrona_tpu_torch.assets.usd, "
        "madrona_tpu_torch.utils.checkpoint, "
        "madrona_tpu_torch.utils.morton, "
        "madrona_tpu_torch.models.hide_seek, "
        "madrona_tpu_torch.models.pile, madrona_tpu_torch.models.cartpole, "
        "madrona_tpu_torch.models.projectiles, "
        "madrona_tpu_torch.ops.lifecycle, madrona_tpu_torch.graph.executor, "
        "madrona_tpu_torch.physics.broadphase, "
        "madrona_tpu_torch.models.hanabi, "
        "madrona_tpu_torch.models.overcooked; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
