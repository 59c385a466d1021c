"""The frozen reference against the program it was frozen from, at small
sizes on the CPU: in float32 the analysis reproduces the program's fused
graph decision for decision, in float64 its MVs stay equal; the decoder
decodes the port's streams to their reconstructions."""
import numpy as np
import pytest
import torch

from evcbench import check, content
from evcbench.reference import fused

from xeve_tpu_torch.enc import device_analyzer as dan
from xeve_tpu_torch.params import EncoderParams
from xeve_tpu_torch import api

W, H = 160, 96


def _frames(n, seed=5):
    import json
    import os
    from conftest import BENCH
    spec = json.load(open(os.path.join(BENCH, "traffic", "ai.json")))
    spec = dict(spec["content"], frames=n, chunk=n)
    return content.make_clip(spec, W, H, seed, "cpu")


SIGS = {"I": {}, "P": {"l0": 0}, "B": {"l0": 0, "l1": 2}}


def _program(y, u, v, refs, qp, qps):
    dev = dan.DeviceAnalyzer(W, H, 10, search_range=16, device="cpu")
    for k, fr in enumerate(zip(y, u, v)):
        dev.put_frame(k, *fr)
    kw = {}
    if "l0" in refs:
        kw["ref_poc"] = refs["l0"]
    if "l1" in refs:
        kw["ref1_poc"] = refs["l1"]
    return dev.collect(dev.dispatch(1, qp, *qps, **kw))


@pytest.mark.parametrize("sig", list(SIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_frozen_analysis_follows_the_program(sig, dtype):
    y, u, v = _frames(3)
    qp = 35
    qps = check.qp_triplet(qp, 10, 0)
    refs = SIGS[sig]
    prog = _program(y, u, v, refs, qp, qps)
    ref = fused.analyze((y[1], u[1], v[1]),
                        {k: (y[i], u[i], v[i]) for k, i in refs.items()},
                        qp, *qps, dtype=dtype, device="cpu")
    mv_bad, ms_bad, ms_n = check.decisions(ref, prog)
    assert set(ref) >= {"mode", "split"}
    assert ("mv" in ref) == bool(refs) and ("mvbi" in ref) == (sig == "B")
    assert mv_bad == 0
    if dtype == torch.float32:
        assert ms_bad == 0
    else:
        assert ms_bad / ms_n < 1e-3


def test_the_decisions_count_every_altered_entry():
    y, u, v = _frames(3)
    qps = check.qp_triplet(35, 10, 0)
    ref = fused.analyze((y[1], u[1], v[1]), {"l0": (y[0], u[0], v[0])}, 35,
                        *qps, device="cpu")
    prog = _program(y, u, v, {"l0": 0}, 35, qps)
    prog.mode[2] = prog.mode[2].copy()
    prog.mode[2][0, :3] = (prog.mode[2][0, :3] + 1) % 5
    prog.mv[6] = prog.mv[6] + 4
    mv_bad, ms_bad, _n = check.decisions(ref, prog)
    assert ms_bad == 3 and mv_bad == prog.mv[6].size


@pytest.mark.parametrize("profile", [0, 1])
def test_the_frozen_decoder_decodes_the_ports_streams(profile):
    y, u, v = _frames(18)
    enc = api.GopEncoder(EncoderParams(w=W, h=H, qp=32, bframes=15,
                                       profile=profile),
                         analysis="device", device="cpu")
    out = list(enc.encode_stream(zip(y, u, v)))
    assert len(out) == 18
    streams = [bs for bs, _r, _p in out]
    recons = [r for _b, r, _p in out]
    assert check.decode_errors(streams, recons) == 0
    recons[5] = (recons[5][0] + 1, *recons[5][1:])
    assert check.decode_errors(streams, recons) == 1
    assert check.decode_errors(streams[:3] + [streams[3][:-9]],
                               recons[:4]) == 4


def _structure(mix):
    import json
    import os
    from conftest import BENCH
    spec = json.load(open(os.path.join(BENCH, "traffic", mix + ".json")))
    return check.Structure(spec["structure"])


def _recorded(enc, n, seed=5):
    y, u, v = _frames(n, seed)
    dev = enc._device()
    recs = []
    real = dev.dispatch

    def rec(*a, **k):
        recs.append((a, k))
        return real(*a, **k)

    dev.dispatch = rec
    out = list(enc.encode_stream(zip(y, u, v)))
    return recs, [p for _b, _r, p in out]


def test_the_structure_gives_the_programs_dispatches():
    """The GOP structure worked out by the check equals what the program
    dispatches on an RA stream of two sub-GOPs."""
    enc = api.GopEncoder(EncoderParams(w=W, h=H, qp=32, bframes=15),
                         analysis="device", device="cpu")
    recs, order = _recorded(enc, 33)
    st = _structure("ra_gop16")
    assert len(recs) == 33
    assert check.dispatch_errors(recs, 32, 10, 0, st) == 0
    assert order == check.expected_order(33, st)


# structures that no cell uses yet, as a later traffic file would state
# them: the program's own dispatches and emission order must follow
OTHER = {
    "ai": ({"keyint": 1}, {"encoder": "Encoder", "order": "ai",
                           "qp": {"model": "fixed"}}),
    "ld": ({"keyint": 8}, {"encoder": "Encoder", "order": "ld",
                           "intra_period": 8, "qp": {
                               "model": "ladder", "table": "QP_ADAPT_LD",
                               "i_depth": 0, "tid_depth": [2]}}),
    "ld_2ref": ({"keyint": 8, "ref_pics": 2},
                {"encoder": "Encoder", "order": "ld", "intra_period": 8,
                 "refs": 2, "qp": {"model": "ladder", "table": "QP_ADAPT_LD",
                                   "i_depth": 0, "tid_depth": [2]}}),
    "ra_abr": ({"bframes": 15, "rc_type": "abr", "bitrate_kbps": 60.0},
               {"encoder": "GopEncoder", "order": "ra", "gop": 16,
                "qp": {"model": "rc"}}),
}


@pytest.mark.parametrize("name", list(OTHER))
def test_a_stated_structure_gives_the_programs_dispatches(name):
    params, spec = OTHER[name]
    st = check.Structure(spec)
    enc = getattr(api, st.encoder)(EncoderParams(w=W, h=H, qp=32, **params),
                                   analysis="device", device="cpu")
    recs, order = _recorded(enc, 33)        # whole sub-GOPs in RA
    assert len(recs) == 33
    assert check.dispatch_errors(recs, 32, 10, 0, st) == 0
    assert order == check.expected_order(33, st)
    # the same stream held to another structure's refs or qps is not
    wrong = dict(spec, **({"intra_period": 4} if st.order == "ld" else
                          {"order": "ld"} if st.order == "ra" else
                          {"qp": {"model": "ladder", "table": "QP_ADAPT_LD",
                                  "i_depth": 0, "tid_depth": [2]}}))
    assert check.dispatch_errors(recs, 32, 10, 0,
                                 check.Structure(wrong)) > 0


def _numpy_route(y, u, v, cur, refs, qp, qps):
    """The port's numpy analysis route (analysis="numpy"), held to the
    JAX package's, on the same frames: code apart from the fused graph
    that the reference was frozen from."""
    from xeve_tpu_torch.enc.analysis_inter_np import analyze_frame_inter
    from xeve_tpu_torch.enc.analysis_np import analyze_frame
    from xeve_tpu_torch.ops import mc_np

    def f(a):
        return np.asarray(a, np.int32)

    def rp(i):
        return {"poc": i, "y_pad": mc_np.pad_picture(f(y[i]), 80),
                "u_pad": mc_np.pad_picture(f(u[i]), 40),
                "v_pad": mc_np.pad_picture(f(v[i]), 40)}

    if not refs:
        return analyze_frame(f(y[cur]), f(u[cur]), f(v[cur]), qp, *qps, 10)
    r1 = [rp(refs["l1"])] if "l1" in refs else None
    return analyze_frame_inter(f(y[cur]), f(u[cur]), f(v[cur]),
                               [rp(refs["l0"])], qp, *qps, 10,
                               search_range=16, refp1=r1), rp(refs["l0"])


def _sad16(y, cur, mvs, ref):
    """Luma SAD of 16x16 motion-compensated blocks of frame cur."""
    from xeve_tpu_torch.ops import mc_np
    h, w = y[cur].shape
    total = 0
    for by in range(mvs.shape[0]):
        for bx in range(mvs.shape[1]):
            o = np.asarray(y[cur], np.int64)[by * 16:by * 16 + 16,
                                              bx * 16:bx * 16 + 16]
            p = mc_np.mc_cu(bx * 16, by * 16, 16, 16,
                            tuple(int(c) for c in mvs[by, bx]), ref["y_pad"],
                            ref["u_pad"], ref["v_pad"], 80, 40, w, h, 10)[0]
            total += int(np.abs(o - np.asarray(p, np.int64)).sum())
    return total


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 7])
@pytest.mark.parametrize("sig", list(SIGS))
def test_the_frozen_analysis_agrees_with_an_independent_route(seed, sig):
    """The reference in float64 against the port's numpy route, which does
    not share the fused graph's code: the intra modes of every frame, and
    an I frame's splits, are equal; a P or B frame's splits differ in under
    1% of entries (the two motion searches differ by design); and the
    reference's MVs predict the frame at least as well as the numpy
    route's full search (luma SAD of the 16x16 blocks)."""
    y, u, v = _frames(3, seed)
    qp = 35
    qps = check.qp_triplet(qp, 10, 0)
    refs = SIGS[sig]
    ref = fused.analyze((y[1], u[1], v[1]),
                        {k: (y[i], u[i], v[i]) for k, i in refs.items()},
                        qp, *qps, dtype=torch.float64, device="cpu")
    other = _numpy_route(y, u, v, 1, refs, qp, qps)
    if refs:
        other, r0 = other
    n = sum(a.size for a in ref["mode"].values())
    assert sum(int(np.count_nonzero(ref["mode"][lg] != other.mode[lg]))
               for lg in ref["mode"]) == 0
    split_off = sum(int(np.count_nonzero(ref["split"][lg] != other.split[lg]))
                    for lg in ref["split"])
    assert split_off == 0 if not refs else split_off / n < 0.01
    if refs:
        assert _sad16(y, 1, ref["mv"][4], r0) <= _sad16(y, 1, other.mv[4], r0)
