"""Raw YUV and Y4M readers/writers (8- and 10-bit 4:2:0)."""
from __future__ import annotations

import re

import numpy as np


class YuvReader:
    def __init__(self, path: str, w: int, h: int, depth: int = 8,
                 codec_depth: int = 10):
        self.f = open(path, "rb")
        self.w, self.h, self.depth = w, h, depth
        self.codec_depth = codec_depth
        self.dtype = np.dtype(np.uint8) if depth == 8 else np.dtype("<u2")
        self.frame_bytes = (w * h * 3 // 2) * self.dtype.itemsize

    def read_frame(self):
        w, h = self.w, self.h
        n = w * h * 3 // 2
        raw = self.f.read(n * (1 if self.depth == 8 else 2))
        if len(raw) < n * (1 if self.depth == 8 else 2):
            return None
        a = np.frombuffer(raw, dtype=self.dtype)
        y = a[:w * h].reshape(h, w).astype(np.int32)
        u = a[w * h:w * h + w * h // 4].reshape(h // 2, w // 2).astype(np.int32)
        v = a[w * h + w * h // 4:].reshape(h // 2, w // 2).astype(np.int32)
        sh = self.codec_depth - self.depth     # to the internal depth
        if sh > 0:
            y, u, v = y << sh, u << sh, v << sh
        elif sh < 0:
            y, u, v = y >> -sh, u >> -sh, v >> -sh
        return y, u, v

    def close(self):
        self.f.close()


class Y4mReader:
    def __init__(self, path: str, codec_depth: int = 10):
        self.codec_depth = codec_depth
        self.f = open(path, "rb")
        header = b""
        while not header.endswith(b"\n"):
            c = self.f.read(1)
            if not c:
                raise ValueError("bad y4m header")
            header += c
        hdr = header.decode()
        assert hdr.startswith("YUV4MPEG2")
        self.w = int(re.search(r"W(\d+)", hdr).group(1))
        self.h = int(re.search(r"H(\d+)", hdr).group(1))
        m = re.search(r"F(\d+):(\d+)", hdr)
        self.fps = (int(m.group(1)) / int(m.group(2))) if m else 30.0
        cm = re.search(r"C(\S+)", hdr)
        cs = cm.group(1) if cm else "420"
        if "p10" in cs:
            self.depth = 10
        else:
            self.depth = 8
        assert cs.startswith("420"), f"unsupported y4m colourspace {cs}"
        self.dtype = np.uint8 if self.depth == 8 else np.dtype("<u2")

    def read_frame(self):
        line = b""
        while not line.endswith(b"\n"):
            c = self.f.read(1)
            if not c:
                return None
            line += c
        assert line.startswith(b"FRAME")
        w, h = self.w, self.h
        n = w * h * 3 // 2
        raw = self.f.read(n * (1 if self.depth == 8 else 2))
        a = np.frombuffer(raw, dtype=self.dtype)
        y = a[:w * h].reshape(h, w).astype(np.int32)
        u = a[w * h:w * h + w * h // 4].reshape(h // 2, w // 2).astype(np.int32)
        v = a[w * h + w * h // 4:].reshape(h // 2, w // 2).astype(np.int32)
        sh = self.codec_depth - self.depth
        if sh > 0:
            y, u, v = y << sh, u << sh, v << sh
        elif sh < 0:
            y, u, v = y >> -sh, u >> -sh, v >> -sh
        return y, u, v

    def close(self):
        self.f.close()


def open_video(path: str, w: int = 0, h: int = 0, depth: int = 8,
               codec_depth: int = 10):
    if path.endswith(".y4m"):
        return Y4mReader(path, codec_depth=codec_depth)
    assert w > 0 and h > 0, "raw yuv needs -w/-h"
    return YuvReader(path, w, h, depth, codec_depth=codec_depth)


def write_recon_frame(f, y, u, v):
    """16-bit little-endian planar (any codec depth), matching xeve_app's
    recon dump container."""
    f.write(np.asarray(y, dtype="<u2").tobytes())
    f.write(np.asarray(u, dtype="<u2").tobytes())
    f.write(np.asarray(v, dtype="<u2").tobytes())
