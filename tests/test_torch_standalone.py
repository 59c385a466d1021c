"""The torch port stands alone: it imports neither `jax` nor anything of
`xeve_tpu`, its copies of the JAX package's host modules equal their
originals, its native C coding pass is built from byte-identical sources
under a name of its own, and its own decoder decodes the golden Baseline
and Main streams (every Main tool, DRA and tiles included) and its own
streams bit-exactly."""
import ast
import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import DATA, load_rec10, load_yuv8
from xeve_tpu import constants as jax_constants
from xeve_tpu.enc import analysis_inter_np as jax_inter_np
from xeve_tpu.enc import analysis_np as jax_analysis_np
from xeve_tpu.enc import intra_frame_native as jax_intra_native
from xeve_tpu.enc.frame_pass import PAD_L as JAX_PAD_L
from xeve_tpu.native import build as jax_native_build
from xeve_tpu.ops import mc_np as jax_mc_np
from xeve_tpu_torch import api as torch_api
from xeve_tpu_torch import constants as port_constants
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.enc import analysis_inter_np as port_inter_np
from xeve_tpu_torch.enc import analysis_inter_torch, device_analyzer
from xeve_tpu_torch.enc import analysis_np as port_analysis_np
from xeve_tpu_torch.enc import intra_frame_native as port_intra_native
from xeve_tpu_torch.native import build as port_native_build
from xeve_tpu_torch.params import EncoderParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "xeve_tpu_torch")
ORIG = os.path.join(ROOT, "xeve_tpu")

# ---------------------------------------------------------------------------
# No import of jax or xeve_tpu
# ---------------------------------------------------------------------------

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["xeve_tpu"] = None
import numpy as np
from tools.gen_test_content import gen_frame
from xeve_tpu_torch import api
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.params import EncoderParams

GOPS = {"ldp": (dict(keyint=0), 3),
        "ra": (dict(keyint=0, bframes=15), 17),
        "main_ai": (dict(keyint=1, profile=1), 3),
        "main_ra": (dict(keyint=0, bframes=15, profile=1), 17),
        "ra_abr": (dict(keyint=0, bframes=15, rc_type="abr",
                        bitrate_kbps=300.0), 17),
        "main_ai_dra": (dict(keyint=1, profile=1, tool_dra=1), 2)}
engine, gop = sys.argv[1], sys.argv[2]
kw, n = GOPS[gop]
frames = []
for t in range(n):
    y, u, v = gen_frame(64, 64, t)
    frames.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                   v.astype(np.int16) << 2))
enc = api.GopEncoder(EncoderParams(w=64, h=64, qp=32, **kw),
                     analysis=engine, device="cpu")
out = list(enc.encode_stream(iter(frames)))
assert len(out) == n, len(out)
if engine == "jax" or gop.startswith("main_ai"):
    assert enc.analysis_calls == n
else:
    assert enc._device().dispatches == n and enc._device().failures == 0
recs = {poc: rec for _bs, rec, poc in out}
dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r, _p in out))
assert len(dec) == n
for f in dec:
    for a, b in zip((f.y, f.u, f.v), recs[f.poc]):
        assert np.array_equal(a, b), f"poc {f.poc}"
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "xeve_tpu")]
assert not loaded, loaded
print("ok", sum(len(bs) for bs, _r, _p in out))
"""


@pytest.mark.parametrize("engine", ["jax", "device"])
@pytest.mark.parametrize("gop", ["ldp", "ra", "main_ai", "main_ra", "ra_abr",
                                 "main_ai_dra"])
def test_port_encodes_and_decodes_without_jax_package(engine, gop):
    """A fresh interpreter in which neither jax nor xeve_tpu can be
    imported encodes Baseline LD-P and RA GOP16, Main AI and Main RA GOP16,
    an ABR RA GOP16 and a DRA Main AI with both engines and decodes its own
    stream bit-exactly through the port's decoder (the DRA recon
    backward-mapped on both sides).  Main AI analyses every frame with the
    EIPD analysis on either engine (analysis_calls)."""
    # one intra-op thread, as in the test workers (test_torch_encode.py)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", SCRIPT, engine, gop], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok ")


ROUTES_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["xeve_tpu"] = None
import numpy as np
from tools.gen_test_content import gen_frame
from xeve_tpu_torch import api, graft_entry
from xeve_tpu_torch.dec.decoder import BaselineIntraDecoder
from xeve_tpu_torch.params import EncoderParams
from xeve_tpu_torch.parallel.mesh import make_mesh

def frames(n):
    out = []
    for t in range(n):
        y, u, v = gen_frame(64, 64, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out

route = sys.argv[1]
if route == "encode_frames":
    enc = api.Encoder(EncoderParams(w=64, h=64, qp=32, keyint=1),
                      device="cpu")
    out = enc.encode_frames(frames(3), batch=2)
    assert enc._batch_analyzer is not None
elif route == "me_engine_pallas":
    enc = api.Encoder(EncoderParams(w=64, h=64, qp=32, keyint=0),
                      analysis="numpy", me_engine="pallas", device="cpu")
    out = [(bs, rec) for bs, rec, _p in enc.encode_stream(iter(frames(3)))]
else:
    enc = api.GopEncoder(EncoderParams(w=64, h=64, qp=32, keyint=0,
                                       bframes=15),
                         analysis="device", device="cpu")
    out = [(bs, rec) for bs, rec, _p in enc.encode_stream_meshed(
        iter(frames(17)), make_mesh(2, "cpu"))]
    graft_entry.dryrun_multichip(2, device="cpu")
dec = BaselineIntraDecoder().decode(b"".join(bs for bs, _r in out))
assert len(dec) == len(out)
for f, (_bs, rec) in zip(dec, out):              # coding order
    for a, b in zip((f.y, f.u, f.v), rec):
        assert np.array_equal(a, b), f"poc {f.poc}"
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "xeve_tpu")]
assert not loaded, loaded
print("ok", sum(len(bs) for bs, _r in out))
"""


@pytest.mark.parametrize("route", ["encode_frames", "me_engine_pallas",
                                   "encode_stream_meshed"])
def test_new_routes_without_jax_package(route):
    """encode_frames (BatchAnalyzer), the numpy engine with
    me_engine="pallas", and encode_stream_meshed over a 2-device CPU mesh
    with graft_entry.dryrun_multichip, in an interpreter where jax and
    xeve_tpu cannot be imported: each stream decodes to its recon."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", ROUTES_SCRIPT, route],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok ")


CLI_SCRIPT = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["xeve_tpu"] = None
from xeve_tpu_torch import app, dec_app

tmp = sys.argv[1]
bs, rec, dec = (os.path.join(tmp, n) for n in ("o.evc", "rec.yuv",
                                              "dec.yuv"))
assert app.main(["-i", "tests/data/s96b.yuv", "-w", "96", "-h2", "80",
                 "--frames", "3", "--rc", "abr", "--bitrate", "200",
                 "--device", "cpu", "-o", bs, "-r", rec]) == 0
assert dec_app.main(["-i", bs, "-o", dec]) == 0
assert open(rec, "rb").read() == open(dec, "rb").read()
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "xeve_tpu")]
assert not loaded, loaded
print("ok", os.path.getsize(bs))
"""


def test_port_cli_round_trip_without_jax_package(tmp_path):
    """The port's encoder CLI (ABR, numpy engine with --device cpu) and
    its decoder CLI in an interpreter where jax and xeve_tpu cannot be
    imported: the decoder writes the recon the encoder dumped."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", CLI_SCRIPT, str(tmp_path)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ok " in r.stdout


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    """Absolute module names a source imports, at any level of nesting
    (function-level imports and import_module/__import__ calls too)."""
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", None)) \
                in ("import_module", "__import__"):
            names.append(node.args[0].value)
    return names


def test_no_source_imports_jax_or_xeve_tpu():
    srcs = _port_sources()
    assert len(srcs) > 30
    bad = [(os.path.relpath(p, ROOT), m) for p in srcs
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "xeve_tpu")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# Copies held to their originals
# ---------------------------------------------------------------------------

VERBATIM = ["params.py", "hls.py", "io/bits.py",
            "enc/analysis_np.py", "enc/syntax.py", "enc/frame_native.py",
            "enc/intra_frame_native.py", "enc/aq.py", "ops/mc_np.py",
            "ops/picman_np.py", "ops/motion_np.py", "ops/intra_main_np.py",
            "ops/deblock_np.py", "native/xt_core.c", "native/tables.h",
            # the Main profile's host modules
            "constants_ats.py", "entropy/ctx_init.py", "entropy/adcc.py",
            "ops/htdf_np.py", "ops/addb_np.py", "ops/dra_np.py",
            "ops/intra_main_batch.py", "enc/analysis_main_np.py",
            # restored in full once the Main modules above were copied
            "entropy/sbac.py", "ops/reference_kernels.py",
            "dec/decoder.py",
            # rate control, checkpoint/resume, video I/O and the numpy
            # coding passes
            "enc/rc.py", "state.py", "io/video.py", "ops/intra_np.py",
            "enc/rdoq.py", "enc/syntax_main.py", "enc/frame_pass.py",
            "enc/main_intra_frame.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_is_byte_identical(rel):
    """Modules copied unchanged, and the C pass's sources, equal the JAX
    package's byte for byte."""
    with open(os.path.join(PORT, rel), "rb") as a, \
            open(os.path.join(ORIG, rel), "rb") as b:
        assert a.read() == b.read()


def _code_without_docstrings(path, package=None):
    """The AST of `path` without docstrings; with `package`, the module
    paths of the JAX package read as that package's."""
    src = open(path).read()
    if package:
        src = src.replace("xeve_tpu.", package + ".")
    tree = ast.parse(src, path)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", ["constants.py", "native/gen_tables.py"])
def test_copy_code_equals_original(rel):
    """Copies whose docstrings were reworded keep the original's code, the
    port's module paths in place of the JAX package's."""
    assert _code_without_docstrings(os.path.join(PORT, rel)) == \
        _code_without_docstrings(os.path.join(ORIG, rel), "xeve_tpu_torch")


def test_gen_tables_reproduces_tables_h(tmp_path):
    """The port's gen_tables.py, from the port's own copies of the tables,
    writes the committed tables.h byte for byte."""
    from xeve_tpu_torch.native import gen_tables
    out = tmp_path / "tables.h"
    gen_tables.main(str(out))
    with open(os.path.join(PORT, "native", "tables.h"), "rb") as f:
        assert out.read_bytes() == f.read()


def test_pad_l_equals_original():
    assert torch_api.PAD_L == JAX_PAD_L == 80
    assert device_analyzer.PAD == analysis_inter_torch.PAD == JAX_PAD_L


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def test_constants_equal_originals():
    names = [n for n in vars(jax_constants) if n.isupper()]
    assert len(names) > 30
    for n in names:
        assert _equal(getattr(port_constants, n), getattr(jax_constants, n)), n
    for main in (0, 1):
        for qp in range(-12, 58):
            assert port_constants.chroma_qp_dynamic(qp, main) == \
                jax_constants.chroma_qp_dynamic(qp, main)


def test_params_equal_originals():
    from xeve_tpu.params import EncoderParams as JaxParams
    for preset in ("fast", "medium", "slow", "placebo"):
        kw = dict(w=100, h=60, qp=30, keyint=0, bframes=15, preset=preset)
        a = dataclasses.asdict(EncoderParams(**kw).validate())
        b = dataclasses.asdict(JaxParams(**kw).validate())
        assert a == b, preset


def _same_analysis(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert _equal(x, y), f.name


def test_numpy_oracles_equal_originals():
    """The device analyzer's host fallback runs the port's copies of the
    numpy oracles; on the s96 fixture they give the originals' results.
    The inter copy's integer ME is the numpy full search whatever the
    original's process-global ME_ENGINE says."""
    assert not hasattr(port_inter_np, "ME_ENGINE")
    y0, u0, v0 = (p << 2 for p in load_yuv8(os.path.join(DATA, "s96.yuv"),
                                             96, 80, 0))
    y1, u1, v1 = (p << 2 for p in load_yuv8(os.path.join(DATA, "s96.yuv"),
                                             96, 80, 1))
    args = (30, 42, 41, 41, 10)
    _same_analysis(port_analysis_np.analyze_frame(y0, u0, v0, *args),
                   jax_analysis_np.analyze_frame(y0, u0, v0, *args))
    ref = {"poc": 0, "y_pad": jax_mc_np.pad_picture(y0, 80),
           "u_pad": jax_mc_np.pad_picture(u0, 40),
           "v_pad": jax_mc_np.pad_picture(v0, 40)}
    _same_analysis(
        port_inter_np.analyze_frame_inter(y1, u1, v1, [ref], *args,
                                          search_range=8),
        jax_inter_np.analyze_frame_inter(y1, u1, v1, [ref], *args,
                                         search_range=8))


def test_two_native_libraries_side_by_side():
    """The port's C pass is its own library, loaded beside the JAX
    package's in one process; both code one frame to the same bytes."""
    lib_p, lib_j = port_native_build.get_lib(), jax_native_build.get_lib()
    assert lib_p is not lib_j
    assert os.path.basename(lib_p._name) == "libxevetpu_torch.so"
    assert os.path.realpath(lib_p._name).startswith(
        os.path.join(ROOT, "build", "xeve_tpu_torch") + os.sep)
    y, u, v = (p << 2 for p in load_yuv8(os.path.join(DATA, "s96.yuv"),
                                         96, 80, 0))
    an = jax_analysis_np.analyze_frame(y, u, v, 30, 42, 41, 41, 10)
    rp = port_intra_native.encode_intra_frame_native(96, 80, 10, 30, 0, 0,
                                                     y, u, v, an)
    rj = jax_intra_native.encode_intra_frame_native(96, 80, 10, 30, 0, 0,
                                                    y, u, v, an)
    assert rp[0] == rj[0] and rp[1] == rj[1]
    for a, b in zip(rp[2:5], rj[2:5]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The port's decoder on the golden streams
# ---------------------------------------------------------------------------

# (name, width, height, frames, every picture carries a signature SEI)
GOLDEN = [
    ("tiny_ai_q32", 64, 64, 1, False),     # I
    ("s96_ai_q27", 96, 80, 2, False),
    ("cif_ai_q32", 352, 288, 2, False),
    ("s96_zl", 96, 80, 2, False),          # LD-P
    ("s96_zl6", 96, 80, 6, False),
    ("s96_ldp_q30", 96, 80, 2, False),     # LD-B
    ("s96_ldp6", 96, 80, 6, False),
    ("s96_ra", 96, 80, 20, False),         # RA GOP16, recon in display order
    ("s96_mm_ai", 96, 80, 2, True),        # Main syntax, tools off
    ("s96_mm_zl", 96, 80, 6, True),
    ("s96_mm_ra", 96, 80, 20, True),
    # Main tools (test_conformance.py), each on top of the ones before
    ("s96_eipd_ai", 96, 80, 2, True),
    ("s96_eipd_zl", 96, 80, 6, True),
    ("s96_eipd_ra", 96, 80, 20, True),
    ("cif_eipd_ai", 352, 288, 2, True),
    ("s96_cmi_ai", 96, 80, 2, True),
    ("s96_cmi_zl", 96, 80, 6, True),
    ("s96_cmi_ra", 96, 80, 20, True),
    ("s96_adcc_ai", 96, 80, 2, True),
    ("s96_adcc_zl", 96, 80, 6, True),
    ("s96_adcc_ra", 96, 80, 20, True),
    ("cif_adcc_ai", 352, 288, 2, True),
    ("s96_iqt_ai", 96, 80, 2, True),
    ("s96_iqt_zl", 96, 80, 6, True),
    ("s96_iqt_ra", 96, 80, 20, True),
    ("s96_ats_ai", 96, 80, 2, True),
    ("s96_ats_zl", 96, 80, 6, True),
    ("s96_ats_ra", 96, 80, 20, True),
    ("s96_htdf_ai", 96, 80, 2, True),
    ("s96_htdf_zl", 96, 80, 6, True),
    ("s96_htdf_ra", 96, 80, 20, True),
    ("s96_btt_ai", 96, 80, 2, False),      # BTT split tree
    ("s96_bttsuco_ai", 96, 80, 2, False),  # + SUCO
    ("cif_bttsuco_ai", 352, 288, 2, False),  # 128 CTU
    ("s96_btt_ld", 96, 80, 2, False),
    ("s96_btt_ra", 96, 80, 18, False),
    ("s96_addb_ai", 96, 80, 3, False),     # ADDB (test_addb.py)
    ("s96_addb_ld", 96, 80, 6, False),
    ("s96_addb_ra", 96, 80, 24, False),
    ("s96_fullset_ra", 96, 80, 24, False),  # the whole default toolset
    ("s96_dra_ai", 96, 80, 4, False),      # DRA: outputs backward-mapped
    ("s96_dra_ld", 96, 80, 12, False),
    ("t176_2t_ai", 176, 144, 2, True),     # tiles (test_tiles.py)
    ("t176_4t_ai", 176, 144, 2, True),
    ("t176_2t_zl", 176, 144, 4, True),
]


@pytest.mark.parametrize("name,w,h,n,sigs", GOLDEN)
def test_port_decoder_decodes_golden_streams(name, w, h, n, sigs):
    """Twin of test_conformance.py, test_addb.py, test_dra.py and
    test_tiles.py: bit-exact recon of the reference encoder's streams in
    display order, and every signature SEI checked."""
    dec = BaselineIntraDecoder()
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = sorted(dec.decode(stream), key=lambda f: f.poc)
    assert len(frames) == n
    if sigs:
        assert dec.signatures_checked == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h,
                                i)
        assert np.array_equal(f.y, gy), f"{name} display {i} luma"
        assert np.array_equal(f.u, gu), f"{name} display {i} cb"
        assert np.array_equal(f.v, gv), f"{name} display {i} cr"


def test_port_decoder_checks_signature_sei():
    y, u, v = load_yuv8(os.path.join(DATA, "s96.yuv"), 96, 80, 0)
    enc = torch_api.Encoder(EncoderParams(w=96, h=80, qp=30, keyint=1,
                                          use_pic_sign=True), device="cpu")
    bs, rec = enc.encode_frame(y << 2, u << 2, v << 2)
    d = BaselineIntraDecoder()
    f, = d.decode(bs)
    assert d.signatures_checked == 1 and np.array_equal(f.y, rec[0])


def test_port_modules_import_by_name():
    """Every module of the port imports on its own (no module of the JAX
    package is needed to resolve its names)."""
    for p in _port_sources():
        rel = os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        if rel != "chip_smoke":
            importlib.import_module(rel.removesuffix(".__init__"))
