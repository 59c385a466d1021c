"""The port is complete: every definition of the JAX package has its
counterpart in xeve_tpu_torch, and every Pallas kernel has a hand-written
kernel in chip_smoke.py's record.  A static check: it reads the sources
with ast and imports neither package.

A definition is a module-level def, class or assigned name, or a method of
a class.  Its counterpart is the same name in the port's module at the
same path (the modules below renamed), bound there by a def, a class, an
assignment or a relative import, or a method of the same class.  A name
without one needs a COUNTERPART entry naming the port's definition, which
must exist, or a BY_DESIGN entry with the reason the port has none."""
import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIG = os.path.join(ROOT, "xeve_tpu")
PORT = os.path.join(ROOT, "xeve_tpu_torch")

RENAMED = {f"enc/{m}_jax.py": f"enc/{m}_torch.py"
           for m in ("analysis", "analysis_inter", "analysis_main", "me",
                     "winmc")}
RENAMED["ops/pallas_me.py"] = "ops/me_cuda.py"

# (JAX module, name) -> "port file:name" (a CUDA source names its kernel)
COUNTERPART = {
    ("api.py", "GopEncoder.encode_stream"):
        "api.py:GopEncoder._encode_stream",
    ("enc/analysis_jax.py", "_TMf"): "tables.py:load_tables",
    ("enc/analysis_jax.py", "_SCAN_RANK"): "tables.py:_SCAN_RANK",
    ("enc/analysis_jax.py", "_sel_matrices"): "tables.py:_sel_matrices",
    ("enc/analysis_jax.py", "analyze_frame_jax"):
        "enc/analysis_torch.py:analyze_frame_torch",
    ("enc/analysis_inter_jax.py", "analyze_frame_inter_jax"):
        "enc/analysis_inter_torch.py:analyze_frame_inter_torch",
    ("enc/analysis_main_jax.py", "_nbr_main_jax"):
        "enc/analysis_main_torch.py:_nbr_main_torch",
    ("enc/analysis_main_jax.py", "_level_cost_main_impl"):
        "enc/analysis_main_torch.py:_level_cost_main",
    ("enc/analysis_main_jax.py", "dispatch_main_jax"):
        "enc/analysis_main_torch.py:dispatch_main_torch",
    ("enc/analysis_main_jax.py", "collect_main_jax"):
        "enc/analysis_main_torch.py:collect_main_torch",
    ("enc/analysis_main_jax.py", "analyze_frame_main_jax"):
        "enc/analysis_main_torch.py:analyze_frame_main_torch",
    ("enc/device_analyzer.py", "_mv_for_level_dev"):
        "enc/analysis_inter_torch.py:_mv_for_level",
    ("enc/me_jax.py", "integer_me_jax"): "enc/me_torch.py:integer_me_plain",
    ("enc/winmc_jax.py", "_ceil_div"): "enc/device_analyzer.py:_ceil_div",
    ("enc/winmc_jax.py", "_HI"): "device.py:resolve_device",
    ("ops/pallas_me.py", "_me_kernel"):
        "csrc/me_full_search.cu:me_full_search_kernel",
    ("ops/pallas_me.py", "_me_pallas_jit"): "ops/me_cuda.py:integer_me",
    ("ops/pallas_me.py", "integer_me_pallas"):
        "ops/me_cuda.py:integer_me_np",
}

_JIT = "a jax.jit wrapper; the port calls the function it wraps"
BY_DESIGN = {
    ("enc/analysis_jax.py", "_level_cost"): _JIT,
    ("enc/analysis_jax.py", "BatchAnalyzer._fn"):
        _JIT + " (BatchAnalyzer._run)",
    ("enc/analysis_inter_jax.py", "_inter_costs_jit"): _JIT,
    ("enc/analysis_inter_jax.py", "_mv_only_jit"): _JIT,
    ("enc/device_analyzer.py", "_fused_jit"): _JIT,
    ("enc/me_jax.py", "_me_int_jit"): _JIT,
    ("enc/analysis_inter_np.py", "ME_ENGINE"):
        "a process-wide switch; Encoder builds an integer_me_fn per encoder",
    ("enc/analysis_inter_np.py", "_integer_me_dispatch"):
        "reads ME_ENGINE; analyze_frame_inter takes integer_me_fn instead",
    ("api.py", "Encoder._ef_raw"): "the DRA double-map wrappers "
        "(api.py:101-110): the port's entry points map once",
    ("api.py", "Encoder._pf_raw"): "the DRA double-map wrappers",
    ("api.py", "Encoder._fl_raw"): "the DRA double-map wrappers",
    ("api.py", "Encoder._wrap_dra_api"): "the DRA double-map wrappers",
}


def _modules():
    out = []
    for d, _dirs, files in os.walk(ORIG):
        out += [os.path.relpath(os.path.join(d, f), ORIG)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _definitions(path):
    """Module-level defs, classes and assigned names, and Class.method."""
    tree = ast.parse(open(path).read(), path)
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            out.append(node.name)
            out += [f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out += [n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)]
    return out


def _bound(path):
    """The port's names: its definitions, class-level assignments and the
    names its relative imports bind."""
    tree = ast.parse(open(path).read(), path)
    names = set(_definitions(path))
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.ClassDef):
            names |= {f"{node.name}.{t.id}" for a in node.body
                      if isinstance(a, ast.Assign) for t in a.targets
                      if isinstance(t, ast.Name)}
    return names


def _port_path(rel):
    return os.path.join(PORT, RENAMED.get(rel, rel))


def _resolves(target):
    rel, name = target.split(":")
    path = os.path.join(PORT, rel)
    if not os.path.exists(path):
        return False
    if rel.endswith(".cu"):
        return re.search(r"__global__[^;{]*\b" + name + r"\s*\(",
                         open(path).read()) is not None
    return name in _bound(path)


def _missing(rel):
    """The JAX module's definitions without a same-named counterpart."""
    have = _bound(_port_path(rel))
    return [n for n in _definitions(os.path.join(ORIG, rel))
            if n not in have]


@pytest.mark.parametrize("rel", _modules())
def test_every_definition_has_a_counterpart(rel):
    assert os.path.exists(_port_path(rel)), f"no port module for {rel}"
    bare = [n for n in _missing(rel)
            if (rel, n) not in COUNTERPART and (rel, n) not in BY_DESIGN]
    assert not bare, f"{rel}: not ported: {bare}"
    for n in _missing(rel):
        if (rel, n) in COUNTERPART:
            assert _resolves(COUNTERPART[rel, n]), \
                f"{rel}:{n}: {COUNTERPART[rel, n]} does not exist"


def test_exception_lists_hold_only_what_they_must():
    """Every entry names a JAX definition that has no same-named
    counterpart (no stale entry), none is in both lists, every reason is
    one line, and the meshed analysis step is ported."""
    keys = list(COUNTERPART) + list(BY_DESIGN)
    assert not set(COUNTERPART) & set(BY_DESIGN)
    for rel, n in keys:
        assert n in _definitions(os.path.join(ORIG, rel)), (rel, n)
        assert n in _missing(rel), f"{rel}:{n} has a same-named counterpart"
    assert all(r and "\n" not in r for r in BY_DESIGN.values())
    assert not any(n == "meshed_analysis_step" for _rel, n in keys)
    assert "meshed_analysis_step" in _bound(_port_path("parallel/mesh.py"))


def _pallas_kernels():
    """(file, line) of the def of each kernel a pl.pallas_call launches."""
    out = []
    for rel in _modules():
        path = os.path.join(ORIG, rel)
        tree = ast.parse(open(path).read(), path)
        defs = {n.name: n.lineno for n in tree.body
                if isinstance(n, ast.FunctionDef)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    getattr(node.func, "attr", None) == "pallas_call":
                k = node.args[0]
                if isinstance(k, ast.Call):       # functools.partial(k, ...)
                    k = k.args[0]
                out.append((f"xeve_tpu/{rel}", defs[k.id]))
    return out


def test_every_pallas_call_is_replaced_by_a_listed_kernel():
    """chip_smoke.py's kernels record names, for every pl.pallas_call site
    of the JAX package, the file:line of the kernel's def."""
    path = os.path.join(ROOT, "chip_smoke.py")
    tree = ast.parse(open(path).read(), path)
    replaces = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces":
                    f, line = v.value.split(":")
                    replaces.add((f, int(line)))
    kernels = _pallas_kernels()
    assert ("xeve_tpu/ops/pallas_me.py", 34) in kernels
    assert set(kernels) <= replaces
    for f, line in replaces:
        assert open(os.path.join(ROOT, f)).read().splitlines()[line - 1] \
            .startswith("def ")
