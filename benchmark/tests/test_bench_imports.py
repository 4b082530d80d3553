"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the reference loads neither, nor the program."""

import ast
import subprocess
import sys
from pathlib import Path

from harness import runner

BENCH = Path(__file__).resolve().parent.parent


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "light_loam_tpu_torch_x", sys)
    monkeypatch.delitem(sys.modules, "light_loam_tpu", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    loaded = runner.forbidden_modules()
    assert "light_loam_tpu" not in loaded
    monkeypatch.setitem(sys.modules, "light_loam_tpu.ops", sys)
    assert "light_loam_tpu" in runner.forbidden_modules()


def _top_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_reference_sources_import_no_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = _top_imports(path)
        assert not names & {"jax", "jaxlib", "flax", "light_loam_tpu",
                            "light_loam_tpu_torch", "harness"}, path


def test_no_benchmark_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _top_imports(path) & {"jax", "jaxlib", "flax",
                                         "light_loam_tpu"}, path


def _loaded_after(code):
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]\n"
            f"{code}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(ast.literal_eval(out.strip().splitlines()[-1]))


def test_reference_loads_no_program():
    loaded = _loaded_after("import reference.slam, reference.mapping")
    assert not loaded & {"jax", "jaxlib", "flax", "light_loam_tpu",
                         "light_loam_tpu_torch"}


def test_harness_and_program_load_no_jax():
    loaded = _loaded_after(
        "import harness.runner, harness.drivers\n"
        "from harness import manifest\n"
        "for w in ('live', 'lanes', 'odometry'): manifest.driver({'driver': w})\n"
        "import light_loam_tpu_torch.models.pipeline\n"
        "import light_loam_tpu_torch.models.batch\n"
        "import light_loam_tpu_torch.models.stages\n"
        "import light_loam_tpu_torch.utils.timing")
    assert "light_loam_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "light_loam_tpu"}
