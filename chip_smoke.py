#!/usr/bin/env python3
"""On-card smoke test of the alignment pipeline at the reference's largest
deployment: URA21 — 21 signal channels plus the reference channel, block
length L = 8192 (FFT window 16384), synthetic ground truth from
``signal/synth.make_truth`` (seeded).

  python chip_smoke.py             one card: served, offline and streaming
                                   paths through the entry points, every
                                   engine compared with the plain XLA engine,
                                   the synthetic truth and the CPU result,
                                   and a timing table
  python chip_smoke.py --four      four cards: the fused time-sharded
                                   offline engine and the channel-sharded
                                   server, each against one card on the
                                   same bytes
  python chip_smoke.py --trace DIR one card: profiler trace of a steady
                                   window of the fused scan32 step, reduced
                                   to its top device operations

Every phase runs; any failure exits non-zero. The last line of standard
output is one JSON object naming the device, printed only when every phase
passed on a GPU. ``--rehearse`` runs the same phases at a tiny width on the
host CPU (for checking the script without a card) and prints no result.
"""

import argparse
import glob
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from coherent_rtlsdr_tpu._bootstrap import (  # noqa: E402
    force_virtual_devices,
    setup_compile_cache,
)

# URA21 at the reference's -b 8192; the rehearsal width is CPU-sized.
FULL = dict(n=21, L=8192, T=256, K=32, frames=320, t_cpu=64, reps=7)
TINY = dict(n=3, L=2048, T=16, K=4, frames=24, t_cpu=8, reps=2)
# Bars of tests/test_kernels.py::test_step_fused_u8_wire_matches_xla.
DELAY_TOL = 2e-2          # samples, fused vs xla applied delay
WIRE_MEAN_TOL = 1.0       # int8 LSB, mean |fused - xla| wire difference
WIRE_P99_TOL = 3          # int8 LSB, 99th percentile of the same
# Quality against the synthetic truth may not be worse than the CPU run
# of the same code on the same bytes, beyond this slack.
QUALITY_SLACK = (1.10, 1e-3, 1e-4)  # (factor, deg RMS, samples RMS)


# ---- helpers (numpy-only, tested on the CPU) ----------------------------

class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(cond, msg) -> None:
    if not cond:
        raise SmokeFailure(msg)


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def wire_diff(w_a: np.ndarray, w_b: np.ndarray) -> dict:
    """|a - b| statistics of two int8 wire arrays of equal size."""
    d = np.abs(np.asarray(w_a, np.int32).ravel()
               - np.asarray(w_b, np.int32).ravel())
    return {"mean": float(d.mean()), "p99": float(np.percentile(d, 99)),
            "max": int(d.max())}


def check_wire_match(w_a, w_b, what: str) -> dict:
    st = wire_diff(w_a, w_b)
    check(st["mean"] < WIRE_MEAN_TOL and st["p99"] <= WIRE_P99_TOL, (
        f"{what}: wire bytes differ beyond the bars: {st}"))
    return st


def quality(aligned_i8, ref_i8, delay, true_delays, skip: int = 2):
    """(phase error deg RMS, residual lag RMS samples) against the
    synthetic truth: the residual inter-channel phase is arg <aligned_ch,
    ref> per (block, channel); the lag residual is applied delay minus the
    true delay. The first ``skip`` blocks are transients."""
    a = np.asarray(aligned_i8, np.float32)
    r = np.asarray(ref_i8, np.float32)
    ac = a[..., 0] + 1j * a[..., 1]                     # [T', N, L]
    rc = r[..., 0] + 1j * r[..., 1]                     # [T', L]
    z = np.sum(ac * np.conj(rc)[:, None, :], axis=-1)  # [T', N]
    deg = np.degrees(np.angle(z))[skip:]
    lag = np.asarray(delay)[skip:] - np.asarray(true_delays)[None, :]
    return float(np.sqrt(np.mean(deg**2))), float(np.sqrt(np.mean(lag**2)))


def check_quality_bar(q_dev, q_cpu, what: str):
    f, deg_abs, lag_abs = QUALITY_SLACK
    check(q_dev[0] <= q_cpu[0] * f + deg_abs, (
        f"{what}: phase error {q_dev[0]:.5f} deg RMS vs CPU {q_cpu[0]:.5f}"))
    check(q_dev[1] <= q_cpu[1] * f + lag_abs, (
        f"{what}: lag error {q_dev[1]:.6f} samples RMS vs CPU {q_cpu[1]:.6f}"))


def frame_checks(frames, n_sig: int) -> list:
    """The wire client's checks on received frames (io/wire.Frame): gseq
    contiguous over all, and on each of the last ten frames every signal
    channel at residual lag 0 against channel 0 (the reference), corr >=
    0.99, |phase| < 1 deg. Returns the per-channel (lag, corr, phase) of
    the last frame."""
    from coherent_rtlsdr_tpu.io.wire import frame_to_matrix

    gseq = [f.globalseqn for f in frames]
    check(all(b - a == 1 for a, b in zip(gseq, gseq[1:])), (
        f"gseq not contiguous: {gseq[:5]}...{gseq[-5:]}"))
    stats = []
    for f in frames[-10:]:
        X = frame_to_matrix(f)
        check(X.shape[0] == n_sig + 1, X.shape)
        L = X.shape[1]
        ref = X[0]
        Fr = np.conj(np.fft.fft(ref))
        stats = []
        for ch in range(1, n_sig + 1):
            s = X[ch]
            c = np.fft.ifft(np.fft.fft(s) * Fr)
            pk = int(np.argmax(np.abs(c)))
            lag = pk if pk <= L // 2 else pk - L
            z = np.vdot(ref, s)
            corr = float(abs(z) / (np.linalg.norm(s) * np.linalg.norm(ref)))
            ph = float(np.degrees(np.angle(z)))
            check(lag == 0 and corr >= 0.99 and abs(ph) < 1.0, (
                f"gseq {f.globalseqn} ch{ch}: lag={lag} corr={corr:.4f} "
                f"phase={ph:+.3f} deg"))
            stats.append((lag, corr, ph))
    return stats


def top_device_ops(trace_dir: str, n: int = 15):
    """Reduce a jax.profiler trace to device time per kernel: returns
    (rows [(name, total_ns, share_of_busy, count)], busy_ns, window_ns,
    shares {"cuFFT", "XLA fusions", "other"}). Kernels are the events of
    the ``Stream`` lines of the ``/device:GPU:*`` planes; busy time is the
    union of their intervals, the window spans the first to the last."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    check(paths, f"no trace under {trace_dir}")
    per_op, intervals = {}, []
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                tot, cnt = per_op.get(e.name, (0.0, 0))
                per_op[e.name] = (tot + e.duration_ns, cnt + 1)
                intervals.append((e.start_ns, e.end_ns))
    check(intervals, "no device kernel events in the trace")
    intervals.sort()
    busy, (cur_s, cur_e) = 0.0, intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    total = sum(t for t, _ in per_op.values())
    shares = {"cuFFT": 0.0, "XLA fusions": 0.0, "other": 0.0}
    for k, (t, _) in per_op.items():
        key = ("cuFFT" if "fft" in k.lower() else
               "XLA fusions" if "fusion" in k or k.startswith("wrapped_")
               else "other")
        shares[key] += t / total
    rows = sorted(((k, t, t / total, c) for k, (t, c) in per_op.items()),
                  key=lambda r: -r[1])[:n]
    return rows, busy, window, shares


# ---- device phases -------------------------------------------------------

def _load_app(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_app_{name}", os.path.join(HERE, "apps", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timed(fn, *args, reps: int):
    """(first call s incl. compile, median steady s, all steady s)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), ts


def phase_served(sz, server_extra, rehearse: bool, tag: str):
    """apps/coherent_server.py in this process (main thread) publishing
    frames to a ZMQ wire client on a thread (numpy + zmq only)."""
    import zmq

    from coherent_rtlsdr_tpu import native
    from coherent_rtlsdr_tpu.io.wire import unpack_frame

    data, ctrl, dbg = (f"tcp://127.0.0.1:{_free_port()}" for _ in range(3))
    n_sig = sz["n"]
    res = {}

    def client():
        ctx = zmq.Context()
        sub = ctx.socket(zmq.SUB)
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        sub.setsockopt(zmq.RCVTIMEO, 600_000)  # first frame waits for compile
        sub.connect(data)
        ctl = ctx.socket(zmq.DEALER)
        ctl.setsockopt(zmq.RCVTIMEO, 60_000)
        ctl.setsockopt(zmq.LINGER, 2000)
        ctl.connect(ctrl)
        try:
            frames, t_first = [], None
            while len(frames) < sz["frames"]:
                frames.append(unpack_frame(sub.recv()))
                if t_first is None:
                    t_first = time.perf_counter()
                    sub.setsockopt(zmq.RCVTIMEO, 60_000)
                if len(frames) > 10:  # keep payloads of the last ten only
                    frames[-11] = frames[-11]._replace(iq=None)
            res["fps"] = (len(frames) - 1) / (time.perf_counter() - t_first)
            res["frames"] = frames
            ctl.send_string("status")
            res["status"] = ctl.recv().decode()
        except Exception as e:  # reported by the main thread
            res["error"] = repr(e)
        finally:
            ctl.send_string("quit")
            sub.close(linger=0)
            ctl.close()
            ctx.term()

    th = threading.Thread(target=client, name="wire-client", daemon=True)
    th.start()
    argv = ["-n", str(n_sig), "-b", str(sz["L"]), "--scan-depth", str(sz["K"]),
            "--blocks", str(10 * sz["frames"]), "-A", data,
            "--ctrl-address", ctrl, "--debug-address", dbg] + server_extra
    if rehearse:
        argv.append("--cpu")
    print(f"[{tag}] coherent_server.py {' '.join(argv)}", flush=True)
    _load_app("coherent_server").main(argv)
    th.join(timeout=120)
    check(not th.is_alive(), "wire client did not finish")
    check("error" not in res, f"wire client: {res.get('error')}")
    frames = res["frames"]
    # gseq over all frames; alignment on the last ten (full payloads)
    stats = frame_checks(frames, n_sig)
    syn = f"{n_sig} / {n_sig} synchronized"
    check(syn in res["status"], res["status"])
    edge = "native C++ publisher" if native.available() else "pyzmq publisher"
    worst = max(stats, key=lambda s: abs(s[2]))
    print(f"[{tag}] served {len(frames)} frames over ZMQ ({edge}), gseq "
          f"contiguous, all {n_sig} ch lag 0, min corr "
          f"{min(s[1] for s in stats):.4f}, worst |phase| {abs(worst[2]):.3f} "
          f"deg, status '{syn}'; client {res['fps']:.1f} frames/s "
          f"(synthetic source rendered on the host)", flush=True)


def make_capture(sz, seed: int = 7):
    """URA21 synthetic capture with known truth, rendered on the default
    device; returns host bytes."""
    import jax

    from coherent_rtlsdr_tpu.signal.synth import make_truth, synth_capture

    truth = make_truth(sz["n"], seed=seed, max_delay=40.0, snr_db=30.0)
    cap = synth_capture(jax.random.PRNGKey(seed), truth, n_blocks=sz["T"],
                        block_len=sz["L"])
    return truth, np.asarray(cap.sig_u8), np.asarray(cap.ref_u8)


def _cfg(sz, impl):
    from coherent_rtlsdr_tpu.pipeline import PipelineConfig

    kw = {"fused": dict(fft_impl="fused", lag_method="phase_zoom"),
          "mxu": dict(fft_impl="mxu", mxu_precision="bf16")}.get(impl, {})
    return PipelineConfig(n_channels=sz["n"], block_len=sz["L"], **kw)


def phase_offline(sz, truth, sig, ref, tmp, rehearse: bool):
    """apps/align_offline.py on a saved capture, xla and fused engines;
    fused vs xla on the same bytes; both against the truth."""
    from coherent_rtlsdr_tpu.io.streamio import Capture, save_capture

    app = _load_app("align_offline")
    cap_path = os.path.join(tmp, "capture.npz")
    T, N = sig.shape[:2]
    save_capture(cap_path, Capture(
        sig_u8=sig, ref_u8=ref,
        seqnums=np.tile(np.arange(1, T + 1, dtype=np.uint32)[:, None], (1, N)),
        fs=2.048e6, fcenter=868e6))
    outs = {}
    for impl in ("xla", "fused"):
        out = os.path.join(tmp, f"aligned_{impl}.npz")
        argv = [cap_path, "-o", out, "--fft-impl", impl]
        print(f"[offline] align_offline.py {' '.join(argv[1:])}", flush=True)
        app.main(argv + (["--cpu"] if rehearse else []))
        z = dict(np.load(out))
        check(z["aligned_i8"].shape == (T - 1, N, sz["L"], 2),
              f"{impl}: aligned shape {z['aligned_i8'].shape}")
        check(np.all(np.isfinite(z["delay"])) and np.all(np.isfinite(z["mag"])),
              f"{impl}: non-finite delay or mag")
        outs[impl] = z
        q = quality(z["aligned_i8"], z["ref_i8"], z["delay"], truth.delays)
        print(f"[offline] {impl}: vs truth phase {q[0]:.5f} deg RMS, lag "
              f"{q[1]:.6f} samples RMS, min corr {z['mag'].min():.4f}",
              flush=True)
    x, f = outs["xla"], outs["fused"]
    dd = float(np.abs(f["delay"] - x["delay"]).max())
    check(dd <= DELAY_TOL, f"fused vs xla delay differs by {dd}")
    st = check_wire_match(f["aligned_i8"], x["aligned_i8"], "offline fused")
    np.testing.assert_array_equal(f["ref_i8"], x["ref_i8"])
    print(f"[offline] fused vs xla (same bytes): max |delay diff| {dd:.2e} "
          f"samples (bar {DELAY_TOL}), wire |diff| mean {st['mean']:.4f} LSB "
          f"(bar < {WIRE_MEAN_TOL}), p99 {st['p99']:.0f} (bar <= "
          f"{WIRE_P99_TOL}), max {st['max']}; reference channel bit-exact",
          flush=True)


def phase_cpu_bar(sz, truth, sig, ref):
    """Quality on the device vs the same code on the host CPU, same bytes
    (the first t_cpu blocks)."""
    import jax

    app = _load_app("align_offline")
    cpu = jax.devices("cpu")[0]
    dev = jax.devices()[0]
    t = sz["t_cpu"]
    s, r = sig[:t], ref[:t]
    for impl in ("xla", "fused"):
        run = app.make_runner(_cfg(sz, impl))
        qs = {}
        for name, d in (("device", dev), ("cpu", cpu)):
            w, wr, delay, *_ = jax.device_get(run(jax.device_put(s, d),
                                                  jax.device_put(r, d)))
            qs[name] = quality(np.asarray(w).reshape(t - 1, sz["n"], sz["L"], 2),
                               np.asarray(wr).reshape(t - 1, sz["L"], 2),
                               delay, truth.delays)
        check_quality_bar(qs["device"], qs["cpu"], f"{impl} T={t}")
        print(f"[cpu-bar] {impl} T={t}: phase {qs['device'][0]:.5f} vs CPU "
              f"{qs['cpu'][0]:.5f} deg RMS, lag {qs['device'][1]:.6f} vs CPU "
              f"{qs['cpu'][1]:.6f} samples RMS", flush=True)


def phase_streaming(sz, truth, sig, ref):
    """The server's packed scan runner (pipeline/drivers.py), scan depth K,
    over 2K blocks per engine: converged delays at truth, all channels
    synced, fused wire vs xla wire on the same bytes."""
    import jax
    import jax.numpy as jnp

    from coherent_rtlsdr_tpu.pipeline import init_state
    from coherent_rtlsdr_tpu.pipeline.drivers import make_packed_scan_runner
    from coherent_rtlsdr_tpu.pipeline.state import (
        TELEMETRY_COLS,
        pack_state_host,
        unpack_state_host,
    )

    K, N, L = sz["K"], sz["n"], sz["L"]
    gate = jnp.array(True)
    wires = {}
    for impl in ("xla", "fused"):
        cfg = _cfg(sz, impl)
        run = make_packed_scan_runner(cfg, donate=False)
        ps = pack_state_host(init_state(cfg))
        for b in range(2):
            blk = slice(b * K, (b + 1) * K)
            seqs = jnp.asarray(np.tile(
                np.arange(b * K + 1, (b + 1) * K + 1, dtype=np.uint32)[:, None],
                (1, N)))
            ps, (w, wr), telem = run(ps, jnp.asarray(sig[blk]),
                                     jnp.asarray(ref[blk]), gate, seqs)
        st = unpack_state_host(*ps)
        telem = np.asarray(telem)
        check(np.all(np.isfinite(telem)), f"{impl}: non-finite telemetry")
        derr = float(np.abs(np.asarray(st.delay) - truth.delays).max())
        check(derr < 0.1 and bool(np.all(st.synced)), (impl, derr, st.synced))
        wires[impl] = np.asarray(w).reshape(K, N, L, 2)[-K // 2:]
        mag = telem[-1, :, TELEMETRY_COLS.index("mag")]
        print(f"[stream] {impl} scan{K}: after {2 * K} blocks max |delay - "
              f"truth| {derr:.4f} samples, all {N} synced, min corr "
              f"{mag.min():.4f}", flush=True)
    st = check_wire_match(wires["fused"], wires["xla"], "streaming fused")
    print(f"[stream] fused vs xla wire (last {K // 2} blocks): mean "
          f"{st['mean']:.4f} LSB, p99 {st['p99']:.0f}, max {st['max']}",
          flush=True)


def phase_timing(sz, sig, ref, card: str):
    """samples/s per engine, offline (T blocks) and streaming scan K;
    median of ``reps`` steady runs after a compile/warm-up call."""
    import jax
    import jax.numpy as jnp

    from coherent_rtlsdr_tpu.pipeline import init_state
    from coherent_rtlsdr_tpu.pipeline.drivers import make_packed_scan_runner
    from coherent_rtlsdr_tpu.pipeline.state import pack_state_host

    app = _load_app("align_offline")
    T, K, N, L = sz["T"], sz["K"], sz["n"], sz["L"]
    s_dev, r_dev = jnp.asarray(sig), jnp.asarray(ref)
    sk, rk = jnp.asarray(sig[:K]), jnp.asarray(ref[:K])
    seqs = jnp.asarray(np.tile(np.arange(1, K + 1, dtype=np.uint32)[:, None],
                               (1, N)))
    gate = jnp.array(True)
    rows, delays = [], {}
    for impl in ("xla", "mxu", "fused"):
        cfg = _cfg(sz, impl)
        run = app.make_runner(cfg)
        first, med, _ = _timed(run, s_dev, r_dev, reps=sz["reps"])
        rows.append((impl, f"offline T={T}", (T - 1) * N * L / med, first, med))
        delays[impl] = np.asarray(run(s_dev, r_dev)[2])
        if impl == "fused":
            mem = run.lower(s_dev, r_dev).compile().memory_analysis()
            if mem is not None:
                print(f"[timing] fused offline T={T} memory: temp "
                      f"{mem.temp_size_in_bytes / 2**30:.2f} GiB, args "
                      f"{mem.argument_size_in_bytes / 2**30:.2f} GiB, out "
                      f"{mem.output_size_in_bytes / 2**30:.2f} GiB", flush=True)
        srun = make_packed_scan_runner(cfg, donate=False)
        ps = pack_state_host(init_state(cfg))
        first, med, _ = _timed(srun, ps, sk, rk, gate, seqs, reps=sz["reps"])
        rows.append((impl, f"scan{K}", K * N * L / med, first, med))
    # the bf16 four-step engine is timed, not on the main path: its delays
    # must still agree with the XLA engine to the bf16 test's bar
    dm = float(np.abs(delays["mxu"] - delays["xla"]).max())
    check(np.all(np.isfinite(delays["mxu"])) and dm < 0.1, dm)
    print(f"[timing] mxu (bf16) vs xla offline delay: max |diff| {dm:.2e} "
          f"samples (bar 0.1)", flush=True)
    print(f"[timing] {card}; {N} ch x L={L}; median of {sz['reps']} steady "
          f"runs, block_until_ready", flush=True)
    print(f"[timing] {'engine':6s} {'path':14s} {'samples/s':>14s} "
          f"{'first call s':>13s} {'steady s':>10s}", flush=True)
    for impl, path, sps, first, med in rows:
        print(f"[timing] {impl:6s} {path:14s} {sps:14.6e} {first:13.3f} "
              f"{med:10.6f}", flush=True)


def phase_trace(sz, sig, ref, trace_dir, card: str):
    """One steady window of the fused scan-K step under jax.profiler."""
    import jax
    import jax.numpy as jnp

    from coherent_rtlsdr_tpu.pipeline import init_state
    from coherent_rtlsdr_tpu.pipeline.drivers import make_packed_scan_runner
    from coherent_rtlsdr_tpu.pipeline.state import pack_state_host

    K, N = sz["K"], sz["n"]
    cfg = _cfg(sz, "fused")
    run = make_packed_scan_runner(cfg, donate=False)
    ps = pack_state_host(init_state(cfg))
    sk, rk = jnp.asarray(sig[:K]), jnp.asarray(ref[:K])
    seqs = jnp.asarray(np.tile(np.arange(1, K + 1, dtype=np.uint32)[:, None],
                               (1, N)))
    gate = jnp.array(True)
    for _ in range(3):
        jax.block_until_ready(run(ps, sk, rk, gate, seqs))
    with jax.profiler.trace(trace_dir):
        for _ in range(5):
            jax.block_until_ready(run(ps, sk, rk, gate, seqs))
    rows, busy, window, shares = top_device_ops(trace_dir)
    print(f"[trace] {card}; fused scan{K}, 5 dispatches of {K} blocks",
          flush=True)
    print(f"[trace] window {window / 1e6:.3f} ms, device busy "
          f"{busy / 1e6:.3f} ms, idle share {1 - busy / window:.4f}; "
          + ", ".join(f"{k} {v:.2%}" for k, v in shares.items()), flush=True)
    for name, t, share, cnt in rows:
        print(f"[trace] {share:7.2%} {t / 1e6:10.3f} ms  x{cnt:<5d} "
              f"{name[:90]}", flush=True)


def phase_four(sz, truth, sig, ref, card: str, rehearse: bool):
    """Four cards: fused time-sharded offline (time 4 x channel 1) and the
    channel-sharded server jits, each against one card on the same bytes."""
    import jax
    import jax.numpy as jnp

    from coherent_rtlsdr_tpu.parallel import (
        make_fused_time_sharded_align,
        make_mesh,
    )
    from coherent_rtlsdr_tpu.parallel.sharded import make_sharded_server_jits
    from coherent_rtlsdr_tpu.pipeline import align_offline, init_state
    from coherent_rtlsdr_tpu.pipeline.drivers import make_packed_scan_runner
    from coherent_rtlsdr_tpu.pipeline.state import pack_state_host
    import dataclasses

    devs = jax.devices()
    check(len(devs) >= 4, devs)
    T, K, N, L = sz["T"], sz["K"], sz["n"], sz["L"]
    cfg = _cfg(sz, "fused")
    sflat = sig.reshape(T, N, 2 * L)
    rflat = ref.reshape(T, 2 * L)

    # one card: the unsharded fused engine on device 0
    one = jax.jit(lambda s, r: align_offline(cfg, s, r, smoothing="global"))
    s0, r0 = jax.device_put(sflat, devs[0]), jax.device_put(rflat, devs[0])
    res = jax.block_until_ready(one(s0, r0))
    run4 = make_fused_time_sharded_align(cfg, make_mesh(4, 1))
    out4 = jax.block_until_ready(run4(jnp.asarray(sflat), jnp.asarray(rflat)))
    wire4, wref4, delay4, mag4 = out4
    used = {sh.device for sh in wire4.addressable_shards}
    check(len(used) == 4, f"time-sharded output on {used}")
    dd = float(np.abs(np.asarray(delay4)[1:] - np.asarray(res.delay)).max())
    check(dd <= 1e-4, f"4-card vs 1-card delay differs by {dd}")
    st = wire_diff(np.asarray(wire4)[1:], np.asarray(res.wire))
    check(st["max"] <= 1, f"4-card vs 1-card wire: {st}")
    np.testing.assert_array_equal(np.asarray(wref4)[1:],
                                  np.asarray(res.wire_ref))
    q = quality(np.asarray(wire4)[1:].reshape(T - 1, N, L, 2),
                np.asarray(wref4)[1:].reshape(T - 1, L, 2),
                np.asarray(delay4)[1:], truth.delays)
    t1 = _timed(one, s0, r0, reps=sz["reps"])[1]
    t4 = _timed(run4, jnp.asarray(sflat), jnp.asarray(rflat),
                reps=sz["reps"])[1]
    print(f"[four] fused time-sharded (time 4 x channel 1), {N} ch T={T}: "
          f"output on {len(used)} devices; vs one card max |delay diff| "
          f"{dd:.2e}, wire max |diff| {st['max']} LSB, ref bit-exact; vs "
          f"truth phase {q[0]:.5f} deg RMS, lag {q[1]:.6f} samples RMS",
          flush=True)
    print(f"[four] {card}; offline samples/s: one card {(T - 1) * N * L / t1:.6e}"
          f", four cards {T * N * L / t4:.6e} (median of {sz['reps']})",
          flush=True)

    # channel-sharded server jits (24 rows: 21 channels padded, 6 per card)
    n_pad = 24 if N == 21 else 4 * ((N + 3) // 4)
    cfgp = dataclasses.replace(_cfg(sz, "xla"), n_channels=n_pad)
    sp = np.full((2 * K, n_pad, L, 2), 128, np.uint8)
    sp[:, :N] = sig[:2 * K]
    seqs = np.tile(np.arange(1, 2 * K + 1, dtype=np.uint32)[:, None],
                   (1, n_pad))
    gate = jnp.array(True)
    _, scan4 = make_sharded_server_jits(cfgp, make_mesh(1, 4), scan_depth=K)
    scan1 = make_packed_scan_runner(cfgp, donate=False)
    st4, ps1 = init_state(cfgp), pack_state_host(init_state(cfgp))
    for b in range(2):
        blk = slice(b * K, (b + 1) * K)
        st4, (w4, wr4), _ = scan4(st4, jnp.asarray(sp[blk]),
                                  jnp.asarray(ref[blk]), gate,
                                  jnp.asarray(seqs[blk]))
        ps1, (w1, wr1), _ = scan1(ps1, jax.device_put(sp[blk], devs[0]),
                                  jax.device_put(ref[blk], devs[0]), gate,
                                  jax.device_put(seqs[blk], devs[0]))
    used = {sh.device for sh in w4.addressable_shards}
    check(len(used) == 4, f"sharded server output on {used}")
    st = wire_diff(np.asarray(w4)[:, :N], np.asarray(w1)[:, :N])
    check(st["max"] <= 1, f"sharded server vs one card: {st}")
    np.testing.assert_array_equal(np.asarray(wr4), np.asarray(wr1))
    print(f"[four] server jits on a channel mesh of 4 ({n_pad} rows): output "
          f"on {len(used)} devices; vs one card wire max |diff| {st['max']} "
          f"LSB over {2 * K} blocks, ref bit-exact", flush=True)
    phase_served(sz, ["--mesh", "4", "--max-channels", str(n_pad)],
                 rehearse, "four")


def gpu_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four", action="store_true",
                      help="four-card phases only (sharded paths vs one card)")
    mode.add_argument("--trace", metavar="DIR", default=None,
                      help="profiler trace of the fused scan step only")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny width on the host CPU; prints no result")
    args = ap.parse_args(argv)
    sz = TINY if args.rehearse else FULL

    setup_compile_cache()
    if args.rehearse:
        if args.four:
            force_virtual_devices(4)
        import jax

        jax.config.update("jax_platforms", "cpu")
        card = "host CPU (rehearsal)"
    else:
        card = gpu_card().replace("\n", " | ")
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"card: {card}", flush=True)
    print(f"jax.devices(): {devs}", flush=True)
    print(f"platform={d.platform} device_kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    if d.platform != "gpu" and not args.rehearse:
        sys.exit(f"error: platform '{d.platform}' is not a GPU")
    if args.four and len(devs) < 4:
        sys.exit(f"error: --four needs 4 devices, found {len(devs)}")

    t_start = time.perf_counter()
    if args.trace:
        truth, sig, ref = make_capture(dict(sz, T=sz["K"]))
        phase_trace(sz, sig, ref, args.trace, card)
    elif args.four:
        subprocess.run(["make", "-s", "-C", os.path.join(HERE, "native")],
                       check=True)
        truth, sig, ref = make_capture(sz)
        phase_four(sz, truth, sig, ref, card, args.rehearse)
    else:
        subprocess.run(["make", "-s", "-C", os.path.join(HERE, "native")],
                       check=True)
        phase_served(sz, [], args.rehearse, "served")
        truth, sig, ref = make_capture(sz)
        with tempfile.TemporaryDirectory() as tmp:
            phase_offline(sz, truth, sig, ref, tmp, args.rehearse)
        phase_cpu_bar(sz, truth, sig, ref)
        phase_streaming(sz, truth, sig, ref)
        phase_timing(sz, sig, ref, card)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s; "
          f"card: {card}", flush=True)
    if args.rehearse:
        print("REHEARSAL-OK", flush=True)
        return
    count = 4 if args.four else len(devs)
    print(result_line(d.platform, d.device_kind, count), flush=True)


if __name__ == "__main__":
    main()
