"""The port's C pass (xeve_tpu_torch/native/xt_core.c) against the JAX
package's (xeve_tpu/native/xt_core.c), transform by transform: the port
prunes its inverse DCT-2 to the nonzero coefficient rectangle and runs
both directions as partial butterflies, and every int32 it writes must
equal what the JAX package's plain products write, for every input.

A shim that #includes an xt_core.c and exports its transform functions is
compiled once from each file, with the flags native/build.py uses.  The
port's inverse transforms also count their work (xt_tq_counters), which
the native.ccall spans carry while the recorder is on."""
import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from tools.gen_test_content import gen_frame
from xeve_tpu_torch import api, trace
from xeve_tpu_torch.native import build
from xeve_tpu_torch.params import EncoderParams

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {"port": os.path.join(ROOT, "xeve_tpu_torch", "native",
                                "xt_core.c"),
           "jax": os.path.join(ROOT, "xeve_tpu", "native", "xt_core.c")}

SHIM = """#include "{src}"
XT_API void shim_fwd_dct2(const int32_t *a, int32_t *b, int lw, int lh,
                          int bd) {{ xt_fwd_dct2(a, b, lw, bd); }}
XT_API void shim_inv_dct2(const int32_t *a, int32_t *b, int lw, int lh,
                          int bd) {{ xt_inv_dct2(a, b, lw, bd); }}
XT_API void shim_inv_dct2_iqt(const int32_t *a, int32_t *b, int lw, int lh,
                              int bd) {{ xt_inv_dct2_iqt(a, b, lw, bd); }}
XT_API void shim_inv_dct2_wh(const int32_t *a, int32_t *b, int lw, int lh,
                             int bd) {{ xt_inv_dct2_wh(a, b, lw, lh, bd); }}
XT_API void shim_inv_dct2_iqt_wh(const int32_t *a, int32_t *b, int lw,
                                 int lh, int bd)
{{ xt_inv_dct2_iqt_wh(a, b, lw, lh, bd); }}
"""

I32P = ctypes.POINTER(ctypes.c_int32)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{"port": CDLL, "jax": CDLL}, the two shims, compiled side by side."""
    d = tmp_path_factory.mktemp("tq_shim")
    procs = {}
    for name, src in SOURCES.items():
        c = d / f"shim_{name}.c"
        c.write_text(SHIM.format(src=src))
        procs[name] = subprocess.Popen(
            ["gcc", "-O3", "-march=native", "-fPIC", "-shared",
             "-fvisibility=hidden", "-o", str(d / f"shim_{name}.so"), str(c),
             "-lm", "-lpthread"])
    assert all(p.wait() == 0 for p in procs.values())
    return {name: ctypes.CDLL(str(d / f"shim_{name}.so")) for name in procs}


def _run(lib, fn, block, lgw, lgh, bd):
    a = np.ascontiguousarray(block, dtype=np.int32)
    out = np.zeros_like(a)
    getattr(lib, "shim_" + fn)(a.ctypes.data_as(I32P), out.ctypes.data_as(I32P),
                               lgw, lgh, bd)
    return out


def _patterns(h, w, seed):
    """(name, h x w int64 block) for every pattern of the comparison."""
    rng = np.random.default_rng(seed)
    out = [("dense", rng.integers(-4096, 4097, (h, w))),
           ("residual_1023", rng.integers(-1023, 1024, (h, w))),
           ("residual_extremes", rng.choice([-1023, 1023], (h, w)))]
    r, c = rng.integers(1, h + 1), rng.integers(1, w + 1)
    b = np.zeros((h, w), np.int64)
    b[:r, :c] = rng.integers(-3000, 3001, (r, c)) * (rng.random((r, c)) < .5)
    out.append(("rectangle", b))
    for y, x in [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)]:
        for v in (-32768, 32767):
            b = np.zeros((h, w), np.int64)
            b[y, x] = v
            out.append((f"corner_{y}_{x}_{v}", b))
    b = np.zeros((h, w), np.int64)
    b[h - 1] = rng.integers(-600, 601, w)
    out.append(("last_row", b))
    b = np.zeros((h, w), np.int64)
    b[:, w - 1] = rng.integers(-600, 601, h)
    out.append(("last_column", b))
    out += [("int16_extremes", rng.choice([-32768, 32767], (h, w))),
            ("int16_min", np.full((h, w), -32768)),
            ("int16_max", np.full((h, w), 32767)),
            # beyond int16: the sums that int32 cannot hold
            ("wide", rng.integers(-2 ** 28, 2 ** 28, (h, w)))]
    # magnitudes across the bound of int32 sums, 2^30 / (90 n), for n 2..64:
    # random, and with the signs of T's first two rows, which sum in step
    sign = np.where(np.arange(w) < w // 2, 1, -1)
    for k in range(14, 25):
        out += [(f"dense_2^{k}", rng.integers(-2 ** k, 2 ** k, (h, w))),
                (f"const_2^{k}", np.full((h, w), 2 ** k)),
                (f"halves_2^{k}", np.outer(sign if h == w else np.ones(h),
                                           sign) * 2 ** k)]
    return out


def _inverse_only_patterns(h, w, seed):
    """int32 extremes: the inverse's stage-1 clamp to +-(2^31 - 1)."""
    rng = np.random.default_rng(seed)
    b = np.zeros((h, w), np.int64)
    b[0, 0], b[h - 1, w - 1] = 2 ** 31 - 1, -2 ** 31
    return [("int32_corners", b),
            ("int32_dense", rng.integers(-2 ** 31, 2 ** 31, (h, w))),
            ("int32_min", np.full((h, w), -2 ** 31))]


def _compare(libs, fn, lgw, lgh, bd):
    h, w = 1 << lgh, 1 << lgw
    cases = _patterns(h, w, 1000 * lgw + 10 * lgh + bd)
    if fn != "fwd_dct2":
        cases += _inverse_only_patterns(h, w, lgw + lgh)
    for name, block in cases:
        got = _run(libs["port"], fn, block, lgw, lgh, bd)
        want = _run(libs["jax"], fn, block, lgw, lgh, bd)
        assert np.array_equal(got, want), \
            (name, int(np.sum(got != want)), got.ravel()[:8], want.ravel()[:8])


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("lg", range(1, 7))
@pytest.mark.parametrize("fn", ["fwd_dct2", "inv_dct2", "inv_dct2_iqt"])
def test_square_transform_equals_jax_package(libs, fn, lg, bd):
    _compare(libs, fn, lg, lg, bd)


RECT = [(lw, lh) for lw in range(1, 7) for lh in range(1, 7)
        if 1 <= abs(lw - lh) <= 2]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("lgw,lgh", RECT)
@pytest.mark.parametrize("fn", ["inv_dct2_wh", "inv_dct2_iqt_wh"])
def test_rectangular_inverse_equals_jax_package(libs, fn, lgw, lgh, bd):
    """The BTT twins share the square inverse's body."""
    _compare(libs, fn, lgw, lgh, bd)


def _counters(lib):
    c = (ctypes.c_int64 * 3)()
    lib.xt_tq_counters(c)
    return list(c)


PLANTED = [(6, 6, 16, 16), (6, 6, 0, 0), (6, 6, 63, 0), (6, 6, 0, 63),
           (5, 5, 3, 9), (2, 2, 3, 3)]


@pytest.mark.parametrize("fn,lgw,lgh,r,c", [
    (fn, *case) for fn in ("inv_dct2", "inv_dct2_iqt") for case in PLANTED]
    + [("inv_dct2_wh", 4, 5, 31, 2), ("inv_dct2_iqt_wh", 6, 5, 7, 40)])
def test_counters_hold_the_nonzero_rectangle(libs, fn, lgw, lgh, r, c):
    """One inverse adds 1, (r + 1)(c + 1) for the rectangle through its last
    nonzero row r and column c, and w * h."""
    h, w = 1 << lgh, 1 << lgw
    block = np.zeros((h, w), np.int64)
    block[r, 0], block[0, c], block[r // 2, c // 2] = -7, 300, 5
    before = _counters(libs["port"])
    _run(libs["port"], fn, block, lgw, lgh, 10)
    after = _counters(libs["port"])
    assert [a - b for a, b in zip(after, before)] == \
        [1, (r + 1) * (c + 1), w * h]


def test_an_untraced_call_reads_no_counters():
    """Off, _ccall calls through without reading the counters; on, its
    span carries the counters' gain over the call."""
    state, reads = [0, 0, 0], []

    def counters(out):
        reads.append(1)
        out[:] = state

    def work(x):
        state[:] = [state[0] + 2, state[1] + 40, state[2] + 8192]
        return x + 1

    call = build._ccall(work, counters)
    trace.stop()
    assert call(1) == 2 and reads == []
    trace.start()
    try:
        with trace.span("frame.task", poc=7):
            assert call(5) == 6
    finally:
        recs = trace.stop()
    assert len(reads) == 2
    (cc,) = [r for r in recs if r["name"] == "native.ccall"]
    assert cc["attrs"] == {"poc": 7, "inv_n": 2, "inv_area": 40,
                           "inv_full": 8192}


def _traced_main_ai(threads):
    y, u, v = gen_frame(176, 144, 0)
    frame = (y.astype(np.int16) << 2, u.astype(np.int16) << 2,
             v.astype(np.int16) << 2)
    enc = api.Encoder(EncoderParams(w=176, h=144, qp=32, keyint=1, profile=1,
                                    tile_columns=2, threads=threads,
                                    use_pic_sign=True), device="cpu")
    trace.start()
    try:
        bs, _rec = enc.encode_frame(*frame)
    finally:
        recs = trace.stop()
    (cc,) = [r for r in recs if r["name"] == "native.ccall"]
    return bs, cc["attrs"]


def test_tile_threads_add_their_counts_to_the_call():
    """With two tiles on two threads the tile threads run the inverse
    transforms; the call's span counts them as one thread does."""
    bs1, one = _traced_main_ai(1)
    bs2, two = _traced_main_ai(2)
    assert bs1 == bs2
    assert two == one
    assert one["inv_n"] > 0 and 0 < one["inv_area"] < one["inv_full"]
