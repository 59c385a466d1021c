"""The port's CLIs, `python -m xeve_tpu_torch.app` and
`python -m xeve_tpu_torch.dec_app`, against the JAX package's
xeve_tpu_app.py and xeve_tpu_dec.py on tests/data/s96b.yuv: the same
bitstream and summary with the same engine, a recon dump equal to the
decoder's output, and no carrying on without a card."""
import os
import subprocess
import sys

import pytest
import torch

from conftest import DATA
from xeve_tpu_torch import app

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = ["-i", os.path.join(DATA, "s96b.yuv"), "-w", "96", "-h2", "80"]
# one intra-op thread, as in the test workers (test_torch_encode.py)
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")


def _run(args, env=ENV):
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _summary(stdout):
    """The summary lines but the speed line."""
    lines = stdout.splitlines()
    i = lines.index("=== Summary " + "=" * 40)
    return [l for l in lines[i:] if not l.startswith("Encoding speed")]


CASES = {
    "ldp": ["-q", "30", "-I", "0", "--frames", "4"],
    "ai_main": ["-q", "30", "-I", "1", "--profile", "main", "--frames", "1"],
    "ra_abr": ["-q", "30", "-b", "15", "--rc", "abr", "--bitrate", "300"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_equals_jax_cli(case, tmp_path):
    """`--analysis auto --device cpu` picks the numpy engine and writes the
    JAX CLI's bitstream (numpy engine) and summary; the port's decoder CLI
    writes the recon the encoder dumped."""
    port_bs, jax_bs = tmp_path / "port.evc", tmp_path / "jax.evc"
    rec, dec = tmp_path / "rec.yuv", tmp_path / "dec.yuv"
    r = _run(["-m", "xeve_tpu_torch.app"] + CLIP + CASES[case]
             + ["--analysis", "auto", "--device", "cpu", "-v", "3",
                "-o", str(port_bs), "-r", str(rec)])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("analysis engine numpy, coder native, "
                               "device cpu")
    j = _run(["xeve_tpu_app.py"] + CLIP + CASES[case]
             + ["--analysis", "numpy", "-o", str(jax_bs)])
    assert j.returncode == 0, j.stderr[-3000:]
    assert port_bs.read_bytes() == jax_bs.read_bytes()
    assert _summary(r.stdout) == _summary(j.stdout)
    d = _run(["-m", "xeve_tpu_torch.dec_app", "-i", str(port_bs),
              "-o", str(dec)])
    assert d.returncode == 0, d.stderr[-3000:]
    if case != "ra_abr":
        # display order on both sides (an RA decode dumps coding order)
        assert subprocess.run(["cmp", str(rec), str(dec)]).returncode == 0


@pytest.mark.parametrize("name", ["s96_ra", "s96_dra_ld"])
def test_dec_app_equals_jax_dec(name, tmp_path):
    """The decoder CLIs print and write the same on a golden stream."""
    outs = []
    for cmd in (["-m", "xeve_tpu_torch.dec_app"], ["xeve_tpu_dec.py"]):
        out = tmp_path / f"{len(outs)}.yuv"
        r = _run(cmd + ["-i", os.path.join(DATA, f"{name}.evc"),
                        "-o", str(out)])
        assert r.returncode == 0, r.stderr[-3000:]
        outs.append((r.stdout, out.read_bytes()))
    assert outs[0] == outs[1]
    assert outs[0][0].rstrip().endswith("frames")


def test_dec_app_reports_a_broken_stream(tmp_path):
    """A truncated stream: exit code 1 and the JAX CLI's message."""
    bad = tmp_path / "bad.evc"
    stream = open(os.path.join(DATA, "s96_zl.evc"), "rb").read()
    bad.write_bytes(stream[:len(stream) // 2])
    r = _run(["-m", "xeve_tpu_torch.dec_app", "-i", str(bad)])
    j = _run(["xeve_tpu_dec.py", "-i", str(bad)])
    assert r.returncode == j.returncode == 1
    assert r.stderr == j.stderr and r.stderr.startswith("error: ")


def test_no_card_exits_non_zero(monkeypatch, capsys):
    """Without a card and without --device cpu the CLI exits non-zero
    with a message before it reads a frame: it never carries on on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = app.main(CLIP + ["--analysis", "auto", "-o", os.devnull])
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_no_card_subprocess_exits_non_zero():
    r = _run(["-m", "xeve_tpu_torch.app"] + CLIP + ["--analysis", "auto"],
             env=dict(ENV, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "Summary" not in r.stdout
