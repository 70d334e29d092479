"""Every bench.py path at tiny shapes on CPU — a broken bench can never be
committed again. These do NOT measure performance, only that each path
constructs, compiles, runs, and returns finite numbers."""

import importlib.util
import os
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # tiny shapes (the fused engine needs a square 2L, so L >= 2048)
    mod.N_CH = 3
    mod.L = 2048
    mod.T_BLOCKS = 4
    mod.SCAN_K = 2
    mod.SCAN_K_DEEP = 3

    def _fast_best(call, n_batches=1, inner=1):
        mod._sync(call())  # compile
        t0 = time.perf_counter()
        out = call()
        mod._sync(out)
        return time.perf_counter() - t0

    mod._best = _fast_best
    return mod


def _finite_positive(v):
    return np.isfinite(v) and v > 0


class TestBenchPaths:
    def test_offline_xla(self, bench):
        assert _finite_positive(bench.bench_offline())

    def test_offline_fused(self, bench):
        assert _finite_positive(bench.bench_offline(**bench.FUSED))

    def test_streaming_scan_xla(self, bench):
        assert _finite_positive(bench.bench_streaming_scan())

    def test_streaming_scan_fused(self, bench):
        assert _finite_positive(bench.bench_streaming_scan(**bench.FUSED))

    def test_streaming_scan_pipelined(self, bench):
        assert _finite_positive(
            bench.bench_streaming_scan_pipelined(chain=2, **bench.FUSED)
        )

    def test_streaming_single_fused(self, bench):
        assert _finite_positive(
            bench.bench_streaming_single(n_iters=2, **bench.FUSED)
        )

    def test_dispatch_floor(self, bench):
        assert _finite_positive(bench.bench_dispatch_floor())

    def test_dispatch_pipelining(self, bench):
        issue, serial, burst = bench.bench_dispatch_pipelining(reps=2)
        assert all(_finite_positive(v) for v in (issue, serial, burst))

    def test_sharded_1x1(self, bench):
        assert _finite_positive(bench.bench_sharded_1x1())

    def test_sharded_fused_1x1(self, bench):
        assert _finite_positive(bench.bench_sharded_fused_1x1())

    def test_quality(self, bench):
        phase_rms, lag_rms = bench.bench_quality(n_blocks=6)
        assert np.isfinite(phase_rms) and np.isfinite(lag_rms)
        # tiny synthetic run through the full fused path still locks on
        assert lag_rms < 1.0

    def test_server_path(self, bench):
        from coherent_rtlsdr_tpu import native

        if not native.available():
            pytest.skip("native library not built")
        fps, sps, drops, fill = bench.bench_server(n_blocks=4, warmup=2)
        assert _finite_positive(fps) and _finite_positive(sps)

    def test_trace_flag_without_dir_errors_cleanly(self, bench):
        import subprocess
        import sys

        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "bench.py"), "--trace"],
            capture_output=True, text=True, cwd=REPO, timeout=60,
        )
        assert r.returncode == 2  # argparse usage error, not a traceback
        assert "expected one argument" in r.stderr

    def test_sharded_server_scan_1x1(self, bench):
        assert _finite_positive(
            bench.bench_sharded_server_scan_1x1(scan_k=2, chain=2)
        )

    def test_fused_time_sharded_1x1(self, bench):
        assert _finite_positive(bench.bench_fused_time_sharded_1x1())

    def test_streaming_packed(self, bench):
        assert _finite_positive(
            bench.bench_streaming_packed(scan_k=2, chain=2)
        )

    def test_sharded_dispatch_floor(self, bench):
        assert _finite_positive(bench.bench_sharded_dispatch_floor())

    def test_envelope_ascending_with_memory(self, bench, monkeypatch):
        """The envelope sweep must keep the best PASSING candidate even
        when a colder (smaller) one failed first, and must apply all
        three criteria (drops, end-of-window backlog, fps bound)."""
        calls = []

        def fake_server(n_blocks=0, warmup=0, rate_fps=0.0, port_base=0):
            calls.append(rate_fps)
            # smallest candidate: cold window (fps far under target)
            if rate_fps < 20:
                return 0.5 * rate_fps, 0.0, 0, 5
            # 250 kHz point: sustained
            if abs(rate_fps - 250e3 / bench.L) < 1e-6:
                return 0.95 * rate_fps, 0.0, 0, 10
            # largest: zero drops but runaway backlog -> NOT sustained
            return 0.92 * rate_fps, 0.0, 0, 120

        monkeypatch.setattr(bench, "bench_server", fake_server)
        fs, fps, rt250 = bench.bench_server_envelope(40.0)
        assert calls == sorted(calls)          # ascending sweep
        assert fs == 250e3 and rt250 == 1      # best pass remembered
        # a drop in the window disqualifies even with good fps
        monkeypatch.setattr(
            bench, "bench_server",
            lambda **kw: (kw["rate_fps"], 0.0, 3, 5),
        )
        fs, fps, rt250 = bench.bench_server_envelope(40.0)
        assert fs == 0.0 and rt250 == 0

    def test_server_envelope_paced(self, bench):
        from coherent_rtlsdr_tpu import native

        if not native.available():
            pytest.skip("native library not built")
        # a paced run at a trivially sustainable rate must verify realtime
        fps, sps, drops, fill = bench.bench_server(
            n_blocks=4, warmup=2, rate_fps=1000.0, port_base=17655
        )
        assert _finite_positive(fps)
        assert drops >= 0 and fill >= 0
