"""Import rules of the benchmark, compared by whole top-level names (the
port's name begins with the JAX package's)."""
import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "xeve_tpu"}
REFERENCE = os.path.join(BENCH, "evcbench", "reference")


def _imports(path):
    """Top-level names of the absolute imports of one file."""
    tree = ast.parse(open(path).read(), filename=path)
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
            out.add(n.module.split(".")[0])
    return out


def _files(top):
    for d, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {p: _imports(p) & FORBIDDEN for p in _files(BENCH)}
    assert not {p: s for p, s in bad.items() if s}


def test_the_reference_imports_nothing_of_the_program():
    """The frozen reference takes the standard library, numpy and torch,
    and its own modules by relative import."""
    for p in _files(REFERENCE):
        extra = _imports(p) - set(sys.stdlib_module_names)
        assert extra <= {"numpy", "torch"}, (p, extra)


def test_the_check_is_by_whole_names():
    assert "xeve_tpu_torch" not in FORBIDDEN
    sys.path.insert(0, BENCH)
    import run
    sys.modules.setdefault("xeve_tpu_torch_probe", sys)
    assert "xeve_tpu_torch_probe" not in run.forbidden_modules()


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_run_exits_non_zero_without_a_card():
    p = _run(["--workload", "baseline_1080p.ra_gop16", "--seed", "1",
              "--seconds", "10", "--trace", "0"], ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_exits_non_zero_without_the_port(tmp_path):
    """A checkout holding only BENCHMARK.json and benchmark/ fails even
    where torch reports a card."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy, torch; "
            "torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "sys.argv = ['benchmark/run.py', '--workload', "
            "'baseline_1080p.ai', '--seed', '1', '--seconds', '1']; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "xeve_tpu_torch" in p.stderr
    assert '"correct"' not in p.stdout
