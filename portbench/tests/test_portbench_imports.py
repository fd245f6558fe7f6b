"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program. Module names are compared by
their top-level name as a whole: ``himo_tpu_torch`` is not ``himo_tpu``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "himo_tpu"}


def _imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imported(path) & BANNED, (path, _imported(path) & BANNED)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "himo_tpu_torch" not in _imported(path), path


def test_top_level_names_are_compared_whole():
    sys.path.insert(0, str(BENCH))
    import harness

    saved = dict(sys.modules)
    try:
        sys.modules["himo_tpu_torch_extra"] = sys.modules["json"]
        assert harness.banned_modules() == []
        sys.modules["himo_tpu.ops"] = sys.modules["json"]
        assert harness.banned_modules() == ["himo_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r}, {str(BENCH.parent)!r}]\n"
        "from conftest import small_cell, run_small\n"
        "import harness\n"
        "for name in ('seflowpp-512.infer-65k', 'seflowpp-512.train-65k'):\n"
        "    run_small(small_cell(name), 5, 0.2, trace=True)\n"
        "print(json.dumps(harness.banned_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
