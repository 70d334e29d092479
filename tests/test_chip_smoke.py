"""chip_smoke.py's checks at a tiny width on the CPU: the result line, the
wire client's frame checks, the wire and quality bars, and the refusal to
report anything without an accelerator. The on-card phases themselves run
only on the card (``python chip_smoke.py``)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_result_line_is_the_contract(smoke):
    line = smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }


def _frames(n_sig=3, L=256, n=12, lag=0, phase_deg=0.0, gseq0=100, gap=None):
    """Aligned wire frames: every signal channel a copy of the reference
    (optionally circularly shifted / rotated), int8 at a quarter scale."""
    from coherent_rtlsdr_tpu.io.wire import pack_frame, unpack_frame

    rng = np.random.default_rng(0)
    out = []
    for k in range(n):
        ref = (rng.normal(size=L) + 1j * rng.normal(size=L)) * 30
        sig = np.roll(ref, lag) * np.exp(1j * np.radians(phase_deg))
        x = np.stack([ref] + [sig] * n_sig)
        iq = np.clip(np.round(np.stack([x.real, x.imag], -1)), -128, 127)
        g = gseq0 + k + (1 if gap is not None and k >= gap else 0)
        out.append(unpack_frame(pack_frame(g, np.arange(n_sig + 1),
                                           iq.astype(np.int8))))
    return out


def test_frame_checks_accept_aligned_stream(smoke):
    stats = smoke.frame_checks(_frames(), 3)
    assert len(stats) == 3
    assert all(lag == 0 and corr > 0.99 and abs(ph) < 1 for lag, corr, ph in stats)


@pytest.mark.parametrize("kw,msg", [
    (dict(lag=3), "lag=3"),
    (dict(phase_deg=2.0), "phase="),
    (dict(gap=5), "gseq not contiguous"),
])
def test_frame_checks_reject(smoke, kw, msg):
    with pytest.raises(AssertionError, match=msg):
        smoke.frame_checks(_frames(**kw), 3)


def test_wire_bars(smoke):
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, (4, 3, 64, 2)).astype(np.int8)
    b = a.copy()
    b.ravel()[::50] += 1
    st = smoke.check_wire_match(a, b, "one-LSB flips")
    assert st["max"] == 1 and st["mean"] < 0.05
    with pytest.raises(AssertionError, match="beyond the bars"):
        smoke.check_wire_match(a, (a.astype(np.int32) + 4).clip(-128, 127), "off")


def test_quality_and_cpu_bar(smoke):
    rng = np.random.default_rng(2)
    T, N, L = 6, 2, 128
    ref = (rng.normal(size=(T, L)) + 1j * rng.normal(size=(T, L))) * 30
    ph = np.radians([[0.5, -0.25]] * T)                  # per-channel phase
    sig = ref[:, None, :] * np.exp(1j * ph)[..., None]
    to_i8 = lambda x: np.round(np.stack([x.real, x.imag], -1)).astype(np.int8)
    truth = np.array([1.0, -2.0])
    delay = np.tile(truth + [0.01, 0.0], (T, 1))
    deg, lag = smoke.quality(to_i8(sig), to_i8(ref), delay, truth)
    assert abs(deg - np.sqrt((0.5**2 + 0.25**2) / 2)) < 0.05
    assert abs(lag - np.sqrt(0.01**2 / 2)) < 1e-6
    smoke.check_quality_bar((deg, lag), (deg, lag), "same")
    with pytest.raises(AssertionError, match="phase error"):
        smoke.check_quality_bar((deg * 2, lag), (deg, lag), "worse")


def test_refuses_without_accelerator(tmp_path):
    """On a host with no GPU the script exits non-zero and prints no
    result line (here: JAX held to the CPU, and no nvidia-smi)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH="/usr/bin:/bin")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_refuses_outside_the_repo(tmp_path):
    """Alone in a directory (no package beside it) the script fails."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and '"ok"' not in r.stdout
