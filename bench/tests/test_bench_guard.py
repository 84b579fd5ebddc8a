"""Nothing the harness loads is JAX or the JAX package; the reference
loads nothing of the program; nothing here reads the JAX package's own
benchmark."""
import ast
import json
import subprocess
import sys

from bench.lib import spec
from bench.lib.guard import FORBIDDEN, forbidden_loaded

BENCH = spec.BENCH


def _fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_guard_compares_whole_top_level_names():
    mods = {"repro_torch.train": 1, "repro_torchish": 1, "jaxtyping": 1}
    assert forbidden_loaded(mods) == []
    assert forbidden_loaded({"repro.core": 1, "jax.numpy": 1}) == [
        "jax.numpy", "repro.core"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def test_run_cells_and_reference_load_no_jax():
    """run.py's modules, both cells' trainers (the whole training path on
    the CPU at a tiny size) and the reference, in a fresh process."""
    code = f"""
import json, runpy, sys
sys.path[:0] = [{str(spec.ROOT / 'src')!r}, {str(spec.ROOT)!r},
                {str(BENCH / 'tests')!r}]
runpy.run_path({str(BENCH / 'run.py')!r}, run_name='not_main')
from conftest import tiny, tiny_traffic
from bench.lib import spec
from bench.lib.cell import run_cell
from bench.lib.guard import forbidden_loaded
b = spec.load_benchmark()
for w in b['workloads']:
    run_cell(b, w, 3, 0.2, False, device='cpu', cfg=tiny(w['config']),
             traffic=tiny_traffic(w['name']))
print(json.dumps(forbidden_loaded()))
"""
    assert _fresh(code) == []


def test_reference_imports_nothing_of_the_program():
    code = f"""
import json, sys
sys.path[:0] = [{str(spec.ROOT)!r}]
import bench.reference.transformer, bench.reference.precision
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in ('repro_torch', 'jax',
                                               'jaxlib', 'flax', 'repro'))))
"""
    assert _fresh(code) == []
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch",) + FORBIDDEN, \
                    f"{path.name} imports {n}"


def test_nothing_reads_the_jax_packages_benchmark():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_perf" not in text, path
        assert "benchmarks/" not in text and '"benchmarks"' not in text, path
