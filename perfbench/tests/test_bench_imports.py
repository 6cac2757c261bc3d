"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared by
their whole top-level name: ``lqer_tpu_torch`` is the port,
``lqer_tpu`` the JAX package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "lqer_tpu", "bench", "experiments"}

REHEARSAL = """
import json, sys, time
sys.path.insert(0, {root!r})
from perfbench import run
from perfbench.tests.rehearsal import MIXES, config_path
run.run_cell("mistral7b.ppl", 5, 0.5, False, "cpu",
             config_path=config_path("tiny-mistral"),
             mix_override=MIXES["eval"], t0=time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        assert "lqer_tpu_torch" not in top_level_imports(path), path
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import perfbench.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "lqer_tpu_torch" not in out and "'jax'" not in out


def test_a_rehearsed_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", REHEARSAL.format(root=str(ROOT))],
        capture_output=True, text=True, check=True, cwd=ROOT,
        timeout=600).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert "lqer_tpu_torch" in loaded and "perfbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "lqer_tpu"}
