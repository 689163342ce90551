"""Nothing the benchmark runs loads JAX, its libraries or the JAX
package; the reference loads nothing of the port either."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.core import FORBIDDEN

HERE = Path(__file__).resolve().parents[1]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    bad = top_level_imports(path) & {"mld_tpu_torch", "mld_tpu", "jax",
                                     "flax", "jaxlib", "optax"}
    assert not bad, f"{path.name} imports {bad}"


def test_harness_and_tiny_builds_load_no_jax(tmp_path):
    """In a fresh process: the harness, a tiny CPU build of each
    configuration and one call of each; then sys.modules is read."""
    code = f"""
import json, sys
sys.path.insert(0, {str(HERE.parent)!r})
import torch
from benchmark import core, calibrate, run
from benchmark.families import mld_latent as fam
from benchmark.tests import tiny
from pathlib import Path
home = tiny.make_home(Path({str(tmp_path)!r}))
for cell in ("t2m_b128", "a2m_b128"):
    core.execute(cell, 3, 0.0, False, "cpu", env=tiny.CPU_ENV, home=home)
print(json.dumps(core.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert set(FORBIDDEN) >= {"jax", "jaxlib", "flax", "optax", "mld_tpu"}


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    from benchmark import core
    monkeypatch.setitem(sys.modules, "mld_tpu_torch_fake", object())
    assert "mld_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mld_tpu.fake", object())
    assert "mld_tpu" in core.forbidden_modules()
