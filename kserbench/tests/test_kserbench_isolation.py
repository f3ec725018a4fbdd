"""No module a run loads has the top-level name jax, jaxlib, flax or
close_kmers_tpu (names compared whole: close_kmers_tpu_torch is the
program), and the plain reference and the input generators load nothing
of the program."""

import ast
import os
import subprocess
import sys

from conftest import DATA, REPO, TINY_SPEC

PKG = os.path.join(REPO, "kserbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "close_kmers_tpu"}


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*subdirs):
    for sub in subdirs:
        for root, _, files in os.walk(os.path.join(PKG, sub)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources("."):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_and_generators_import_nothing_of_the_program():
    for path in _sources("reference", "gen", "roofline", "endpoints"):
        assert "close_kmers_tpu_torch" not in _imports(path), path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import kserbench.reference.answers, kserbench.reference.family\n"
            "import kserbench.gen.traffic, kserbench.gen.scale_mapping\n"
            "import kserbench.endpoints.query\n"
            "import kserbench.endpoints.lookup_best_match\n"
            "import kserbench.roofline.probe_search\n"
            "import kserbench.roofline.family_group\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "close_kmers_tpu_torch" not in out
    assert not FORBIDDEN & set(eval(out))


def test_a_whole_run_loads_no_forbidden_module(tmp_path):
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from kserbench.harness.cell import run_cell\n"
        "from kserbench.harness.spec import Spec\n"
        "if __name__ == '__main__':\n"
        "    r = run_cell('tiny-query', 3, 1.0, True, 'cpu', Spec(%r, %r))\n"
        "    print(json.dumps(r))\n"
        "    print(sorted({m.split('.')[0] for m in sys.modules}))"
        % (REPO, TINY_SPEC, DATA))
    script = tmp_path / "one_run.py"
    script.write_text(code)
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    loaded = set(eval(lines[-1]))
    assert "close_kmers_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
    assert '"correct": true' in lines[-2]


def test_the_check_refuses_a_forbidden_module(monkeypatch):
    from kserbench.harness import cell
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert cell.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "close_kmers_tpu_torch_x", sys)
    assert cell.forbidden_modules() == []


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    """Only BENCHMARK.json and kserbench/: the run exits non-zero and
    prints no result line."""
    import shutil
    shutil.copytree(PKG, tmp_path / "kserbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    p = subprocess.run(
        [sys.executable, "kserbench/run.py", "--workload", "query-small",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_the_load_generator_gets_a_core_of_its_own():
    from kserbench.harness.cell import _pin_threads, pin
    before = os.sched_getaffinity(0)
    other = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    cpus = None
    try:
        cpus = pin(other.pid)
        if len(before) < 2:
            assert cpus is None
            return
        assert os.sched_getaffinity(other.pid) == {max(before)}
        assert os.sched_getaffinity(0) == before - {max(before)}
    finally:
        if cpus is not None:
            _pin_threads(cpus)
        other.kill()
        other.wait()
    assert os.sched_getaffinity(0) == before
