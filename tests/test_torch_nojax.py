"""The torch port runs with JAX and the JAX package unimportable: a fresh
interpreter with sys.modules["jax"] = sys.modules["xeve_tpu"] = None
encodes two LD-P frames on the CPU with each analysis engine ("jax" and
the fused "device" analyzer)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["xeve_tpu"] = None
import numpy as np
import xeve_tpu_torch.api as api
from xeve_tpu_torch.params import EncoderParams
rng = np.random.default_rng(1)
base = rng.integers(64, 900, (64, 64))
enc = api.Encoder(EncoderParams(w=64, h=64, qp=32, keyint=0), device="cpu")
n = 0
for t in range(2):
    y = np.roll(base, (t, 2 * t), axis=(0, 1)).astype(np.int32)
    u = np.full((32, 32), 512, np.int32)
    bs, rec = enc.encode_frame(y, u, u)
    assert len(bs) > 0 and rec[0].shape == (64, 64)
    n += len(bs)
assert enc.analysis_calls == 2
dev_enc = api.Encoder(EncoderParams(w=64, h=64, qp=32, keyint=0),
                      analysis="device", device="cpu")
frames = [(np.roll(base, (t, 2 * t), axis=(0, 1)).astype(np.int16),
           np.full((32, 32), 512, np.int16),
           np.full((32, 32), 512, np.int16)) for t in range(2)]
for bs, rec, poc in dev_enc.encode_stream(iter(frames)):
    assert len(bs) > 0 and rec[0].shape == (64, 64)
    n += len(bs)
assert dev_enc._device().dispatches == 2
assert not any(m.split(".")[0] in ("jax", "xeve_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("bytes", n)
"""


def test_port_encodes_without_jax():
    # one intra-op thread, as in the test workers (test_torch_encode.py)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("bytes ")
