"""Benchmark: aligned IQ samples/s per device at 21 channels (BASELINE.json
metric).

Runs the full coherent-alignment pipeline on the accelerator and prints ONE
JSON line. The baseline is the reference C++ system's real-time operating
point — 21 channels x 2.048 Msps (its maximum demonstrated configuration,
README.md:42 / SURVEY.md §6) — i.e. 43.008e6 aligned complex samples/s.

Paths measured:
  * offline engine (measure->smooth->apply over a 256-block slab) — the
    throughput path;
  * streaming, K-block micro-batches (lax.scan inside one program — the
    online path with K blocks of latency, 4 ms per block at 2.048 Msps);
  * streaming, single block per dispatch (latency-optimal);
  * the served path (native ingest ring -> server -> ZMQ publisher).

Every timing ends in ``jax.block_until_ready``.
"""

import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from coherent_rtlsdr_tpu._bootstrap import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq  # noqa: E402
from coherent_rtlsdr_tpu.pipeline import (  # noqa: E402
    PipelineConfig,
    align_offline,
    init_state,
    step,
)

N_CH = 21
L = 8192
T_BLOCKS = 256  # blocks per offline slab
SCAN_K = 32    # streaming micro-batch depth (throughput mode; 128 ms latency)
SCAN_K_DEEP = 128  # deep micro-batch (512 ms latency)
BASELINE_SAMPLES_PER_S = 21 * 2.048e6  # reference real-time operating point


def _sync(out):
    """Wait until every array of ``out`` is computed."""
    jax.block_until_ready(out)


def _best(call, n_batches=4, inner=2):
    """Min-of-batches wall time per call."""
    _sync(call())  # warmup/compile
    best = 1e9
    for _ in range(n_batches):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = call()
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def _inputs(T=None, flat=False):
    """Random u8 capture bytes; ``flat=True`` ships them as [.., 2L], the
    fused engine's wire layout."""
    rng = np.random.default_rng(0)
    if T is None:
        sig = rng.integers(0, 256, (N_CH, L, 2), dtype=np.uint8)
        ref = rng.integers(0, 256, (L, 2), dtype=np.uint8)
    else:
        sig = rng.integers(0, 256, (T, N_CH, L, 2), dtype=np.uint8)
        ref = rng.integers(0, 256, (T, L, 2), dtype=np.uint8)
    if flat:
        sig = sig.reshape(sig.shape[:-2] + (2 * L,))
        ref = ref.reshape(ref.shape[:-2] + (2 * L,))
    return jnp.asarray(sig), jnp.asarray(ref)


def bench_offline(**cfg_kw):
    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **cfg_kw)
    sig, ref = _inputs(T_BLOCKS, flat=cfg.fft_impl == "fused")

    @jax.jit
    def run(sig, ref):
        res = align_offline(cfg, sig, ref, smoothing="global")
        wire = res.wire if res.wire is not None else c64_to_i8_iq(res.aligned)
        return wire, res.delay, res.mag

    dt = _best(lambda: run(sig, ref))
    return (T_BLOCKS - 1) * N_CH * L / dt


def _scan_jit(cfg):
    """Jitted scan-K streaming runner shared by the synced and pipelined
    streaming benches: (state, sigs [K,..], refs [K,..]) -> (state, outs)."""
    gate = jnp.array(True)

    def scan_fn(state, sigs, refs):
        def body(s, blk):
            s2, out = step(cfg, s, blk[0], blk[1], gate)
            wire = out.wire if out.wire is not None else c64_to_i8_iq(out.aligned)
            return s2, (wire, out.telemetry.residual)
        return jax.lax.scan(body, state, (sigs, refs))

    return jax.jit(scan_fn)


def bench_streaming_scan(scan_k=SCAN_K, **cfg_kw):
    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **cfg_kw)
    sig, ref = _inputs(scan_k, flat=cfg.fft_impl == "fused")
    run = _scan_jit(cfg)
    state = init_state(cfg)

    def call():
        _, outs = run(state, sig, ref)
        return outs

    dt = _best(call) / scan_k
    return N_CH * L / dt


def bench_streaming_scan_pipelined(scan_k=SCAN_K, chain=8, **cfg_kw):
    """Streaming throughput when the consumer syncs OFF the critical path —
    the pipelined server's dispatch pattern (io/server.py run: the main
    thread never syncs; the publisher worker fetches): `chain` scan-K
    dispatches issued back-to-back, state-chained, ONE sync at the end.
    Measures the dispatch+compute capacity at scan-K latency; the end-to-end
    number is server_samples_per_s."""
    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **cfg_kw)
    sig, ref = _inputs(scan_k, flat=cfg.fft_impl == "fused")
    run = _scan_jit(cfg)
    state = init_state(cfg)
    s, outs = run(state, sig, ref)
    _sync(outs)
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        s = state
        outs = None
        for _ in range(chain):
            s, outs = run(s, sig, ref)
        _sync(outs)
        best = min(best, (time.perf_counter() - t0) / (chain * scan_k))
    return N_CH * L / best


def bench_streaming_single(n_iters=16, **cfg_kw):
    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **cfg_kw)
    sig, ref = _inputs(flat=cfg.fft_impl == "fused")
    gate = jnp.array(True)

    # donate the state like the server's jit does (io/server.py) — the
    # chained-dispatch loop below is the pipelined server's single-block
    # pattern, synced once per n_iters
    @partial(jax.jit, donate_argnums=(0,))
    def run(state, sig, ref):
        state, out = step(cfg, state, sig, ref, gate)
        wire = out.wire if out.wire is not None else c64_to_i8_iq(out.aligned)
        return state, wire, out.telemetry.residual

    state = init_state(cfg)
    state, wire, r = run(state, sig, ref)
    _sync(r)
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            state, wire, r = run(state, sig, ref)
        _sync(r)
        best = min(best, (time.perf_counter() - t0) / n_iters)
    return N_CH * L / best


FUSED = dict(fft_impl="fused", lag_method="phase_zoom")


def bench_sharded_server_scan_1x1(scan_k=SCAN_K, chain=4):
    """The multi-device SERVING path: the server's sharded
    scan jit (make_sharded_server_jits, fused backend) at a 1x1 mesh,
    chained dispatches with one sync — directly comparable to
    streaming_scan32_pipelined (its unsharded twin). The gap between the
    two IS the shard_map serving overhead."""
    from coherent_rtlsdr_tpu.parallel import make_mesh
    from coherent_rtlsdr_tpu.parallel.sharded import make_sharded_server_jits

    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **FUSED)
    _, scan_fn = make_sharded_server_jits(
        cfg, make_mesh(1, 1), scan_depth=scan_k
    )
    sig, ref = _inputs(scan_k, flat=True)
    seqs = jnp.broadcast_to(
        jnp.arange(1, scan_k + 1, dtype=jnp.uint32)[:, None], (scan_k, N_CH)
    )
    gate = jnp.array(True)
    state = init_state(cfg)
    s, _, telems = scan_fn(state, sig, ref, gate, seqs)
    _sync(telems)
    best = 1e9
    for _ in range(3):
        s = init_state(cfg)  # outside the timed window (donation consumes it)
        _sync(s.delay)
        t0 = time.perf_counter()
        telems = None
        for _ in range(chain):
            s, _, telems = scan_fn(s, sig, ref, gate, seqs)
        _sync(telems)
        best = min(best, (time.perf_counter() - t0) / (chain * scan_k))
    return N_CH * L / best


def bench_sharded_fused_1x1():
    """make_channel_sharded_align (the fused i8 engine under an explicit
    channel-axis shard_map) at a 1-device mesh."""
    from coherent_rtlsdr_tpu.parallel import make_mesh
    from coherent_rtlsdr_tpu.parallel.sharded import make_channel_sharded_align

    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **FUSED)
    mesh = make_mesh(1, 1)
    run = make_channel_sharded_align(cfg, mesh)
    sig, ref = _inputs(T_BLOCKS, flat=True)
    dt = _best(lambda: run(sig, ref))
    return (T_BLOCKS - 1) * N_CH * L / dt


def bench_fused_time_sharded_1x1():
    """make_fused_time_sharded_align (the fused engine over the FULL
    (time, channel) mesh — raw-byte ppermute halo + psum smoothing) at a
    1x1 mesh (the halo is a no-op at one shard; the extra zero-halo window
    is 1/T work)."""
    from coherent_rtlsdr_tpu.parallel import (
        make_fused_time_sharded_align,
        make_mesh,
    )

    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **FUSED)
    run = make_fused_time_sharded_align(cfg, make_mesh(1, 1))
    sig, ref = _inputs(T_BLOCKS, flat=True)
    dt = _best(lambda: run(sig, ref))
    return T_BLOCKS * N_CH * L / dt


def bench_streaming_packed(scan_k=8, chain=8):
    """The packed-state streaming path (pipeline/state.pack_state: the
    11-leaf carry crosses the jit boundary as THREE tensors — the
    production server's dispatch) at the deployable-latency scan depth,
    chained dispatches, one sync. Compare against
    streaming_scan8_pipelined SAME RUN: the delta is the leaf-count cost."""
    from coherent_rtlsdr_tpu.pipeline.drivers import make_packed_scan_runner
    from coherent_rtlsdr_tpu.pipeline.state import pack_state_host

    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **FUSED)
    run = make_packed_scan_runner(cfg, donate=False)
    sig, ref = _inputs(scan_k, flat=True)
    seqs = jnp.broadcast_to(
        jnp.arange(1, scan_k + 1, dtype=jnp.uint32)[:, None], (scan_k, N_CH)
    )
    gate = jnp.array(True)
    pstate = pack_state_host(init_state(cfg))
    s, outs, telem = run(pstate, sig, ref, gate, seqs)
    _sync(telem)
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        s = pstate
        telem = None
        for _ in range(chain):
            s, outs, telem = run(s, sig, ref, gate, seqs)
        _sync(telem)
        best = min(best, (time.perf_counter() - t0) / (chain * scan_k))
    return N_CH * L / best


def bench_dispatch_floor(scan_k=SCAN_K):
    """The flat per-dispatch cost, measured as an empty lax.scan of the
    same depth. Returns milliseconds."""
    def empty(c, _):
        return c, ()

    @jax.jit
    def run(x):
        c, _ = jax.lax.scan(empty, x, None, length=scan_k)
        return c

    x = jnp.zeros((8,), jnp.float32)
    dt = _best(lambda: run(x))
    return dt * 1e3


def bench_dispatch_pipelining(reps=8):
    """Whether back-to-back jit calls overlap: returns (issue_ms,
    serial_ms, burst_ms). issue << serial and burst << serial mean a
    consumer that syncs off the critical path (the pipelined server /
    bench_streaming_single's sync-at-end loop) runs at ~issue+work per
    block."""
    @jax.jit
    def work(x):
        def body(c, _):
            return c @ c * 1e-3 + x, ()
        c, _ = jax.lax.scan(body, x, None, length=50)
        return c

    x = jnp.asarray(np.eye(512, dtype=np.float32))
    _sync(work(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        _sync(work(x))
    serial = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    r = None
    for _ in range(reps):
        r = work(x)
    _sync(r)
    burst = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    r = work(x)
    issue = time.perf_counter() - t0
    _sync(r)
    return issue * 1e3, serial * 1e3, burst * 1e3


def bench_sharded_dispatch_floor(scan_k=SCAN_K):
    """The empty-scan dispatch floor of the SHARDED (shard_map) path — the
    arbitration term for sharded_server_scan32 vs its unsharded twin.
    Returns milliseconds."""
    from jax.sharding import PartitionSpec as P

    from coherent_rtlsdr_tpu.parallel import make_mesh

    mesh = make_mesh(1, 1)

    def empty(c, _):
        return c, ()

    def fn(x):
        c, _ = jax.lax.scan(empty, x, None, length=scan_k)
        return c

    sfn = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P(None), out_specs=P(None), check_vma=False
    ))
    x = jnp.zeros((8,), jnp.float32)
    dt = _best(lambda: sfn(x))
    return dt * 1e3


def bench_sharded_1x1():
    """make_sharded_align on a 1x1 (time, channel) mesh: the shard_map/jit
    overhead of the multi-device path against the unsharded xla-offline
    number."""
    from coherent_rtlsdr_tpu.parallel import make_mesh, make_sharded_align

    cfg = PipelineConfig(n_channels=N_CH, block_len=L)
    mesh = make_mesh(1, 1)
    align = make_sharded_align(cfg, mesh)
    sig, ref = _inputs(T_BLOCKS)

    @jax.jit
    def run(sig, ref):
        aligned, ref_out, delay, mag = align(sig, ref)
        return c64_to_i8_iq(aligned), delay, mag

    dt = _best(lambda: run(sig, ref))
    return T_BLOCKS * N_CH * L / dt


def bench_quality(n_blocks=16):
    """The OTHER half of BASELINE.json's north star: residual inter-channel
    phase error (deg RMS) and residual lag RMS vs synthetic ground truth,
    measured on the device through the fused path (the reference's
    empirical analog: phasecorrectionplot.m:12-51 30-min drift plots and
    seqnum_and_correlation.m xcorr checks — here with actual ground truth).

    Returns (phase_err_deg_rms, residual_lag_rms_samples)."""
    from coherent_rtlsdr_tpu.pipeline import align_offline
    from coherent_rtlsdr_tpu.signal.synth import make_truth, synth_capture

    # Synthesize on the host CPU backend (the ingest stands in for host-side
    # capture); only the u8 bytes cross to the device.
    with jax.default_device(jax.devices("cpu")[0]):
        truth = make_truth(N_CH, seed=7, max_delay=40.0, snr_db=30.0)
        cap = synth_capture(
            jax.random.PRNGKey(7), truth, n_blocks=n_blocks, block_len=L
        )
        sig_host = np.asarray(cap.sig_u8).reshape(n_blocks, N_CH, 2 * L)
        ref_host = np.asarray(cap.ref_u8).reshape(n_blocks, 2 * L)
    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **FUSED)
    sig = jnp.asarray(sig_host)
    ref = jnp.asarray(ref_host)

    @jax.jit
    def run(sig, ref):
        res = align_offline(cfg, sig, ref, smoothing="global")
        # Residual inter-channel phase: <aligned_ch, ref> per (block, ch),
        # returned as (re, im) planes.
        z = jnp.sum(res.aligned * jnp.conj(res.ref)[:, None, :], axis=-1)
        return jnp.real(z), jnp.imag(z), res.delay

    zre, zim, delay = run(sig, ref)
    zre, zim, delay = np.asarray(zre), np.asarray(zim), np.asarray(delay)
    # Skip the first output blocks (quantizer/window transients), like the
    # offline tests do.
    errs_deg = np.degrees(np.arctan2(zim, zre))[2:]
    phase_rms = float(np.sqrt(np.mean(errs_deg**2)))
    lag_err = delay[2:] - truth.delays[None, :]
    lag_rms = float(np.sqrt(np.mean(lag_err**2)))
    return phase_rms, lag_rms


def bench_server(n_blocks=160, warmup=40, rate_fps=0.0, port_base=16555):
    """End-to-end SERVER throughput: native C++ file producer -> SPSC ring ->
    RingSource -> jitted fused scan step -> int8 fetch -> native ZMQ
    publisher. This is the number the reference's hot loop corresponds to
    (ccoherent::threadf + cpacketize::send, src/ccoherent.cc:245-294), host
    edge included. ``rate_fps`` paces the producer (a live capture at
    fs = rate_fps * L); 0 = flat out. Returns (frames/s, samples/s,
    ring_drops_in_window, ring_fill_at_end); zeros when the native
    library isn't available."""
    import tempfile

    from coherent_rtlsdr_tpu import native
    from coherent_rtlsdr_tpu.io.server import CoherentServer
    from coherent_rtlsdr_tpu.signal.sources import RingSource

    if not native.available():
        return 0.0, 0.0, 0, 0

    cfg = PipelineConfig(n_channels=N_CH, block_len=L, **FUSED)
    block_bytes = (N_CH + 1) * L * 2
    rng = np.random.default_rng(3)
    with tempfile.NamedTemporaryFile(suffix=".raw", delete=False) as f:
        f.write(rng.integers(0, 256, 32 * block_bytes, dtype=np.uint8).tobytes())
        path = f.name
    # per-channel seqnum ring — the production rtlsdr ingest path
    ring = native.NativeBlockRing(128, block_bytes, n_seq=N_CH + 1)
    producer = native.NativeProducer.file(
        ring, path, rate_blocks_per_s=rate_fps, loop=True
    )
    source = RingSource(ring, n_channels=N_CH, block_len=L, timeout_ms=10000)
    server = CoherentServer(
        cfg, source,
        data_addr=f"tcp://127.0.0.1:{port_base}",
        ctrl_addr=f"tcp://127.0.0.1:{port_base + 1}",
        debug_addr=f"tcp://127.0.0.1:{port_base + 2}",
        scan_depth=SCAN_K,
    )
    try:
        server.run(max_blocks=warmup)
        if rate_fps > 0:
            # the ring buffers up to 128 blocks during jit warmup; a
            # paced run must measure SUSTAINED pacing, not backlog drain
            source.drain()
        drops0 = ring.dropped
        t0 = time.perf_counter()
        n = server.run(max_blocks=n_blocks)
        dt = time.perf_counter() - t0
        drops = int(ring.dropped - drops0)
        fill_end = int(ring.fill)  # residual backlog: the lag signal
    finally:
        producer.stop()
        os.unlink(path)
    return n / dt, n * N_CH * L / dt, drops, fill_end


def bench_server_envelope(server_fps):
    """The ≥1x-realtime END-TO-END operating envelope: the largest PACED
    producer rate (a live 21-channel array at fs = rate * L) the full
    server chain sustains — the measured counterpart
    of the reference's defining real-time property (it runs 21ch at
    2.048 Msps on a RockPI with documented dropouts, README.md:42, and
    documents a 250 kHz fallback, install_on_rpi:5). "Sustained" means,
    over a ~20 s paced window (ring backlog drained first): ZERO ring
    drops, END-OF-WINDOW backlog at most one scan batch plus ~1 s of
    tail arrivals (a consumer lagging even 10% accumulates backlog
    linearly and fails this long before the 128-slot ring overflows into
    drops — drops alone have a blind band), and fps >= 0.85 of target
    (the measured fps carries a constant ~0.7 s final-batch publish
    tail, so a strict fps threshold would fail genuinely-sustained
    windows). Candidates bracket the unpaced ceiling and always include
    the reference's 250 kHz fallback point.
    Returns (verified_fs_hz, fps_at_that_point, realtime_at_250k)."""
    if server_fps <= 0:
        return 0.0, 0.0, 0

    def sustained(tgt, port):
        # ~20 s of wall per probe regardless of the rate (a slow server
        # must not turn the bench into minutes per candidate); floor at 60
        # blocks so the window stays meaningful
        nb = int(max(60, min(480, tgt * 20)))
        fps, _, drops, fill_end = bench_server(
            n_blocks=nb, warmup=16, rate_fps=tgt, port_base=port
        )
        ok = (drops == 0 and fill_end <= SCAN_K + tgt
              and fps >= 0.85 * tgt)
        return ok, fps

    fps250 = 250e3 / L
    # ASCENDING with memory: every candidate runs and the best pass wins,
    # so one cold window cannot zero the whole envelope. The 250 kHz
    # reference fallback point is always among the candidates.
    cands = sorted({0.85 * server_fps, 0.60 * server_fps, fps250})
    port = 16655
    best_fs, best_fps, rt250 = 0.0, 0.0, 0
    for tgt in cands:
        ok, fps = sustained(tgt, port)
        port += 10
        if ok:
            best_fs, best_fps = tgt * L, fps
            if best_fs >= 250e3 - 1e-6:
                rt250 = 1
    return best_fs, best_fps, rt250


def main():
    import argparse
    import contextlib

    ap = argparse.ArgumentParser(description="coherent_rtlsdr_tpu benchmark")
    ap.add_argument("--cpu", action="store_true",
                    help="allow running on the host CPU (no device metric "
                         "is then meaningful)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a JAX profiler trace into DIR")
    args = ap.parse_args()
    from coherent_rtlsdr_tpu._bootstrap import report_backend

    report_backend(allow_cpu=args.cpu)
    trace_cm = (
        jax.profiler.trace(args.trace) if args.trace
        else contextlib.nullcontext()
    )
    with trace_cm:
        offline_fused = bench_offline(**FUSED)
        scan_fused = bench_streaming_scan(**FUSED)
        scan_deep_fused = bench_streaming_scan(scan_k=SCAN_K_DEEP, **FUSED)
        scan8_fused = bench_streaming_scan(scan_k=8, **FUSED)
        scan32_pipelined = bench_streaming_scan_pipelined(**FUSED)
        scan8_pipelined = bench_streaming_scan_pipelined(scan_k=8, **FUSED)
        scan8_packed = bench_streaming_packed(scan_k=8)
        scan32_packed = bench_streaming_packed(scan_k=SCAN_K, chain=4)
        floor_ms = bench_dispatch_floor()
        sharded_floor_ms = bench_sharded_dispatch_floor()
        issue_ms, serial_ms, burst_ms = bench_dispatch_pipelining()
        offline = bench_offline()
        scan = bench_streaming_scan()
        single = bench_streaming_single(**FUSED)
        sharded = bench_sharded_1x1()
        sharded_fused = bench_sharded_fused_1x1()
        fused_time_sharded = bench_fused_time_sharded_1x1()
        sharded_server = bench_sharded_server_scan_1x1()
        phase_rms, lag_rms = bench_quality()
        server_fps, server_sps, _, _ = bench_server()
        env_fs, env_fps, rt250 = bench_server_envelope(server_fps)
    best_off = max(offline, offline_fused)
    best_scan = max(scan, scan_fused, scan32_pipelined)
    value = max(best_off, best_scan)
    print(
        json.dumps(
            {
                "metric": "aligned_iq_samples_per_s_per_chip_21ch",
                "value": round(value, 1),
                "unit": "samples/s/chip",
                "vs_baseline": round(value / BASELINE_SAMPLES_PER_S, 3),
                "offline_samples_per_s": round(offline, 1),
                "offline_fused_samples_per_s": round(offline_fused, 1),
                "streaming_scan32_samples_per_s": round(scan, 1),
                "streaming_scan32_fused_samples_per_s": round(scan_fused, 1),
                "streaming_scan128_fused_samples_per_s": round(
                    scan_deep_fused, 1
                ),
                "streaming_scan8_fused_samples_per_s": round(scan8_fused, 1),
                "streaming_scan32_pipelined_samples_per_s": round(
                    scan32_pipelined, 1
                ),
                "streaming_scan8_pipelined_samples_per_s": round(
                    scan8_pipelined, 1
                ),
                "streaming_scan8_packed_samples_per_s": round(
                    scan8_packed, 1
                ),
                "streaming_scan32_packed_samples_per_s": round(
                    scan32_packed, 1
                ),
                "streaming_single_samples_per_s": round(single, 1),
                "dispatch_floor_ms": round(floor_ms, 3),
                "sharded_dispatch_floor_ms": round(sharded_floor_ms, 3),
                "dispatch_issue_ms": round(issue_ms, 3),
                "dispatch_serial_ms": round(serial_ms, 3),
                "dispatch_burst_ms": round(burst_ms, 3),
                "sharded_1x1_samples_per_s": round(sharded, 1),
                "sharded_fused_samples_per_s": round(sharded_fused, 1),
                "fused_time_sharded_samples_per_s": round(
                    fused_time_sharded, 1
                ),
                "sharded_server_scan32_samples_per_s": round(
                    sharded_server, 1
                ),
                "sharded_over_unsharded_ratio": round(
                    sharded_server / scan32_pipelined, 3
                ),
                # apples-to-apples arbitration (the lean pipelined scan
                # emits only wire+residual, flattering the unsharded
                # side): the packed scan32 runner emits the SAME
                # outputs as the sharded server scan (wire + wire_ref +
                # packed telemetry), so this ratio isolates shard_map
                # overhead itself from output-richness
                "sharded_over_unsharded_matched_ratio": round(
                    sharded_server / scan32_packed, 3
                ),
                "streaming_realtime_factor": round(
                    best_scan / BASELINE_SAMPLES_PER_S, 3
                ),
                "phase_err_deg_rms": round(phase_rms, 4),
                "residual_lag_rms_samples": round(lag_rms, 5),
                "server_frames_per_s": round(server_fps, 1),
                "server_samples_per_s": round(server_sps, 1),
                "server_realtime_factor": round(
                    server_sps / BASELINE_SAMPLES_PER_S, 3
                ),
                "server_max_realtime_fs": round(env_fs, 1),
                "server_max_realtime_fps": round(env_fps, 1),
                "server_realtime_at_250k": rt250,
                "device": str(jax.devices()[0]),
                "platform": jax.devices()[0].platform,
                "device_kind": jax.devices()[0].device_kind,
                "device_count": len(jax.devices()),
            }
        )
    )


if __name__ == "__main__":
    main()
