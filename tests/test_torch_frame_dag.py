"""The RA frame-DAG C pass of the device engine on the CPU, without the
JAX package (so it runs on a machine that has none): sub-GOPs overlapping
on more workers than cores code the stream of a single worker, and a
stream closed while the next sub-GOP's tasks still wait stops cleanly."""
import logging
import sys
import threading
import time

import numpy as np
import torch

from tools.gen_test_content import gen_frame
from xeve_tpu_torch import api
from xeve_tpu_torch.params import EncoderParams

torch.set_num_threads(1)

W, H = 128, 64
RA = dict(w=W, h=H, qp=32, keyint=0, bframes=15)


def _frames(n):
    out = []
    for t in range(n):
        y, u, v = gen_frame(W, H, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def _encoder():
    return api.GopEncoder(EncoderParams(**RA), analysis="device",
                          device="cpu")


def test_ra_overlap_with_more_workers_than_cores(monkeypatch):
    """Sixteen workers, a short switch interval: the stream equals the one
    coded on a single worker."""
    frames = _frames(36)
    monkeypatch.setenv("XEVE_TPU_FRAME_WORKERS", "1")
    ref = list(_encoder().encode_stream(iter(frames)))
    monkeypatch.setenv("XEVE_TPU_FRAME_WORKERS", "16")
    enc = _encoder()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = list(enc.encode_stream(iter(frames)))
    finally:
        sys.setswitchinterval(interval)
    assert [(bs, poc) for bs, _r, poc in out] == \
        [(bs, poc) for bs, _r, poc in ref]
    assert enc.ahead_tasks >= 1


def test_ra_stream_closed_mid_stream_stops_cleanly(monkeypatch, caplog):
    """The benchmark's way out: close the stream after the first full
    sub-GOP's last emission, while the next sub-GOP's tasks run and wait
    (the C pass slowed so that they do), then shut the pools down.
    Nothing raises, nothing is submitted once the stream is closed (a
    done-callback submitting to a pool that is shut down would be logged
    by concurrent.futures), and it ends."""
    monkeypatch.setenv("XEVE_TPU_FRAME_WORKERS", "4")
    enc = _encoder()
    real = enc._code_slice

    def slow(*a, **k):
        time.sleep(0.2)
        return real(*a, **k)

    enc._code_slice = slow
    frames = _frames(52)
    errors, late = [], []
    closed = threading.Event()

    def run():
        try:
            stream = enc.encode_stream(iter(frames))
            got = [next(stream)[2]]     # the I frame; the pool exists now
            pool = enc._code_pool
            submit = pool.submit

            def counted(*a, **k):
                if closed.is_set():
                    late.append(a)
                return submit(*a, **k)

            pool.submit = counted
            got += [next(stream)[2] for _ in range(16)]
            assert got[0] == 0 and sorted(got[1:]) == list(range(1, 17))
            stream.close()
            closed.set()
            for p in (pool, enc._device()._pool):
                p.shutdown(wait=True)
        except BaseException as e:      # reported on the test's thread
            errors.append(e)

    with caplog.at_level(logging.ERROR, logger="concurrent.futures"):
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=300)
    assert not t.is_alive()
    assert errors == []
    assert late == []
    assert not [r for r in caplog.records if r.name == "concurrent.futures"]
    assert enc.ahead_tasks >= 1
