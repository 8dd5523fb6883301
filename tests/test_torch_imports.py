"""The port stands alone: ``src/repro_torch``, its examples
(``examples/*_torch.py``) and ``chip_smoke.py`` import neither JAX nor
anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401 — the test process itself may hold both
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
FILES = sorted(PORT.rglob("*.py")) + EXAMPLES + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_pulls_in_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke, importlib.util\n"
        f"for i, path in enumerate({[str(p) for p in EXAMPLES]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(modules) > 20 and len(EXAMPLES) == 4


def test_the_rank_launcher_is_checked():
    """``launch/ranks.py``, which every spawned rank imports first, and the
    test workers' modules that the ranks run, are among the files held to
    the rule (the workers import neither JAX nor ``repro``)."""
    assert PORT / "launch" / "ranks.py" in FILES
    for worker in ("torch_ranks_workers.py", "torch_engine_workers.py"):
        tree = ast.parse((ROOT / "tests" / worker).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names] + [
            n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if _forbidden(m)], worker
