"""Build + load the native library (gcc -O3 shared object via ctypes).

The port's copy of xeve_tpu/native/build.py.  xt_core.c and tables.h are
byte-identical to the JAX package's; tables.h is committed and never
regenerated here.  The library is built at first use into
build/xeve_tpu_torch/ at the root of the checkout, under a name of its
own (libxevetpu_torch.so), so that it and the JAX package's library can
be loaded side by side in one process: ctypes loads each RTLD_LOCAL and
the sources are compiled with -fvisibility=hidden.  gcc writes a
temporary file that is then renamed into place, so that concurrent first
uses (test workers) never load a half-written library.

While xeve_tpu_torch.trace records, the build-or-load of the library is a
`native.load` span (`built`: whether gcc ran), and each call of a frame
entry point (xt_encode_frame, xt_encode_intra_frame,
xt_encode_main_intra_frame) a `native.ccall` span around the foreign
call alone, in which the calling thread has released the GIL.  Its
`poc` is the inter pass's poc argument, or for an intra pass the `poc`
of the span the caller has open (a frame worker's `frame.task`).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from .. import trace
from ..ops._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(BUILD_DIR, "libxevetpu_torch.so")
_SRC = os.path.join(_DIR, "xt_core.c")
_TABLES = os.path.join(_DIR, "tables.h")

_lib = None
_lock = threading.Lock()


class XtFrameCfg(ctypes.Structure):
    _fields_ = [("w", ctypes.c_int32), ("h", ctypes.c_int32),
                ("bd", ctypes.c_int32), ("qp", ctypes.c_int32),
                ("qp_u_off", ctypes.c_int32), ("qp_v_off", ctypes.c_int32),
                ("use_rdoq", ctypes.c_int32), ("use_deblock", ctypes.c_int32),
                ("main_eipd", ctypes.c_int32), ("tool_iqt", ctypes.c_int32),
                ("cm_init", ctypes.c_int32),
                ("tile_cols", ctypes.c_int32), ("tile_rows", ctypes.c_int32),
                ("threads", ctypes.c_int32),
                ("cu_qp_delta", ctypes.c_int32),
                ("cu_qp_delta_area", ctypes.c_int32),
                ("dquant_flag", ctypes.c_int32),
                ("tool_ats", ctypes.c_int32),
                ("tool_htdf", ctypes.c_int32),
                ("tool_addb", ctypes.c_int32),
                ("addb_alpha_off", ctypes.c_int32),
                ("addb_beta_off", ctypes.c_int32),
                ("sps_btt", ctypes.c_int32),
                ("exact_rd", ctypes.c_int32)]


class XtStats(ctypes.Structure):
    _fields_ = [("payload_bytes", ctypes.c_int64),
                ("bin_count", ctypes.c_int64),
                ("n_leaf", ctypes.c_int32),
                ("n_tiles", ctypes.c_int32),
                ("tile_len", ctypes.c_int32 * 64)]


class XtRefPic(ctypes.Structure):
    """Reference picture (padded planes + motion map) for the inter pass."""
    _fields_ = [("y", ctypes.POINTER(ctypes.c_uint16)),
                ("u", ctypes.POINTER(ctypes.c_uint16)),
                ("v", ctypes.POINTER(ctypes.c_uint16)),
                ("map_mv", ctypes.POINTER(ctypes.c_int32)),
                ("poc", ctypes.c_int32),
                ("list0_poc", ctypes.c_int32)]


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    so_t = os.path.getmtime(_SO)
    return any(os.path.getmtime(dep) > so_t
               for dep in (_SRC, _TABLES, __file__))


def build() -> str:
    """Compile xt_core.c into the port's library; returns its path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    subprocess.check_call(
        ["gcc", "-O3", "-march=native", "-fPIC", "-shared",
         "-fvisibility=hidden", "-o", tmp, _SRC, "-lm", "-lpthread"])
    os.replace(tmp, _SO)
    return _SO


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            with trace.span("native.load") as sp:
                built = _needs_build()
                if built:
                    build()
                _lib = _bind(ctypes.CDLL(_SO))
                sp.set(built=built)
    return _lib


def _ccall(fn, poc_arg=None):
    """fn (a bound entry point) inside a native.ccall span."""
    def call(*args):
        if poc_arg is None:
            poc = trace.attr("poc")
        else:       # a ctypes c_int32, or a plain int
            poc = getattr(args[poc_arg], "value", args[poc_arg])
        with trace.span("native.ccall", poc=poc):
            return fn(*args)
    return call


def _bind(lib):
    """Set the argument and result types of the library's entry points."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.xt_encode_intra_frame.restype = ctypes.c_int
    lib.xt_encode_intra_frame.argtypes = [
        ctypes.POINTER(XtFrameCfg), i16p, i16p, i16p,
        u8p, u8p, u8p, u8p, u8p,      # split maps 2..6
        u8p, u8p, u8p, u8p, u8p,      # mode maps 2..6
        i8p,                          # per-SCU AQ offsets or NULL
        u8p, ctypes.c_int64,
        u16p, u16p, u16p,
        ctypes.POINTER(XtStats),
    ]
    lib.xt_encode_main_intra_frame.restype = ctypes.c_int
    lib.xt_encode_main_intra_frame.argtypes = \
        lib.xt_encode_intra_frame.argtypes
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.xt_encode_frame.restype = ctypes.c_int
    lib.xt_encode_frame.argtypes = [
        ctypes.POINTER(XtFrameCfg),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,   # slice_type, poc, pad_l
        i16p, i16p, i16p,
        ctypes.POINTER(XtRefPic), ctypes.c_int32,         # L0 list, count
        ctypes.POINTER(XtRefPic), ctypes.c_int32,         # L1 list, count
        ctypes.POINTER(u8p), ctypes.POINTER(u8p),         # split/mode map tables
        ctypes.POINTER(i32p), ctypes.POINTER(i32p),       # mv/mv1 map tables
        ctypes.POINTER(i32p), ctypes.POINTER(i32p),       # mv0b/mv1b (refi=1)
        ctypes.POINTER(i32p),                             # mvbi (bi-refined L1)
        ctypes.POINTER(ctypes.c_int8),                    # per-SCU AQ offsets
        u8p, ctypes.c_int64,
        u16p, u16p, u16p,
        i32p, ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(XtStats),
    ]
    lib.xt_encode_frame = _ccall(lib.xt_encode_frame, poc_arg=2)
    lib.xt_encode_intra_frame = _ccall(lib.xt_encode_intra_frame)
    lib.xt_encode_main_intra_frame = _ccall(lib.xt_encode_main_intra_frame)
    return lib
