#!/usr/bin/env python3
"""The server executable — CLI parity with the reference's coherentrtlsdr
binary (src/main.cc:88-160), backed by the synthetic or file source.

Reference flags kept (same letters, main.cc:109-160):
  -f <hz>     center frequency        -b <n>   block size (complex samples)
  -s <hz>     sample rate             -n <n>   number of channels
  -g <gain>   tuner gain              -r <g>   reference gain
  -A <addr>   data bind address       -C <fn>  channel config file
  -R          raw mode (no header)    -I <ser> reference dongle serial
  -q          stderr -> console `log` drain
New:
  --source synth|file|ring|rtlsdr  --capture <npz>  --blocks <n>
  --state <npz>  --drop-rate <p>  --seed <n>  --serials  --rtl-lib
  --trace DIR  --scan-depth  --max-channels  --interactive  --cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from coherent_rtlsdr_tpu._bootstrap import setup_compile_cache

    setup_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-f", "--fcenter", type=float, default=1024e6)
    ap.add_argument("-b", "--blocksize", type=int, default=8192)
    ap.add_argument("-s", "--fs", type=float, default=2.048e6)
    ap.add_argument("-n", "--nchannels", type=int, default=4)
    ap.add_argument("-g", "--gain", type=float, default=50.0)
    ap.add_argument("-r", "--refgain", type=float, default=50.0)
    ap.add_argument("-A", "--address", default="tcp://*:5555")
    ap.add_argument("--ctrl-address", default="tcp://*:5556")
    ap.add_argument("--debug-address", default="tcp://*:5557")
    ap.add_argument("-C", "--config", default=None)
    ap.add_argument("-R", "--raw", action="store_true")
    ap.add_argument(
        "-I", "--refserial", default=None,
        help="reference dongle serial (reference CLI -I, main.cc:139-141); "
             "rtlsdr source puts this serial first in the channel order",
    )
    ap.add_argument(
        "-q", "--quiet", action="store_true",
        help="redirect stderr (incl. native librtlsdr writes) into the "
             "console `log` drain (reference -q, main.cc:63-70)",
    )
    ap.add_argument(
        "--source", choices=["synth", "file", "ring", "rtlsdr"],
        default="synth",
    )
    ap.add_argument(
        "--serials", default=None,
        help="rtlsdr source: comma-separated dongle serials, REFERENCE "
             "FIRST (defaults to the -C config file's channel map, or USB "
             "enumeration order when neither is given)",
    )
    ap.add_argument(
        "--rtl-lib", default=None, metavar="PATH",
        help="explicit librtlsdr .so to dlopen (default: "
             "$COHERENT_LIBRTLSDR, then system librtlsdr)",
    )
    ap.add_argument(
        "--agc", action="store_true",
        help="enable tuner AGC on all dongles (reference -A, main.cc:146; "
             "-A is the data address here, so the long flag)",
    )
    ap.add_argument(
        "--hw-drift-relief", type=float, default=None, metavar="SAMPLES",
        help="rtlsdr source: when a channel's applied numerical delay "
             "exceeds this many samples, pulse that dongle's hardware "
             "resampler with the reference's tanh law to swallow the drift "
             "(ccontrol.cc:78-123; needs the tejeez librtlsdr fork)",
    )
    ap.add_argument("--capture", default=None)
    ap.add_argument(
        "--ingest", default=None,
        help="ring-source producer: 'file:<path>[@<blocks/s>]' replays a raw "
             "capture (looping) or 'zmq:<addr>' SUB-receives raw blocks — "
             "both run as native C++ threads (crtlsdr.cc:44-59 analog)",
    )
    ap.add_argument(
        "--ring-slots", type=int, default=16,
        help="ring depth in blocks (power of two; full ring drops = seqnum gaps)",
    )
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--state", default=None, help="calibration checkpoint npz")
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--cpu", action="store_true",
        help="run the pipeline on the host CPU (without it, a host where "
             "JAX finds no accelerator is an error)",
    )
    ap.add_argument(
        "--scan-depth", type=int, default=1,
        help="blocks per device dispatch (throughput mode; adds latency)",
    )
    ap.add_argument(
        "--interactive", action="store_true",
        help="local stdin console next to the remote socket (console.cc:38-57)",
    )
    ap.add_argument(
        "--fft-impl", choices=["xla", "mxu", "fused", "auto"],
        default="xla",
        help="spectral backend (kernels/backend.py); 'fused' = the u8-native "
             "engine: raw bytes in, int8 wire bytes out, one shared spectrum",
    )
    ap.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a JAX profiler trace of the hot loop into DIR "
             "(viewable with TensorBoard / Perfetto; SURVEY.md §5 telemetry)",
    )
    ap.add_argument(
        "--mesh", type=int, default=1, metavar="SHARDS",
        help="shard the channel axis over this many devices (multi-device "
             "serving, docs/SCALING.md; channel count — or --max-channels — "
             "must divide evenly; with --cpu, virtual devices are created)",
    )
    ap.add_argument(
        "--max-channels", type=int, default=None,
        help="pad the channel axis to this width so console add/del reuse "
             "the compiled executable (no mid-stream recompile stall)",
    )
    args = ap.parse_args(argv)

    if args.cpu and args.mesh > 1:
        from coherent_rtlsdr_tpu._bootstrap import force_virtual_devices

        force_virtual_devices(args.mesh)  # before jax initializes
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from coherent_rtlsdr_tpu._bootstrap import report_backend

    report_backend(allow_cpu=args.cpu)

    from coherent_rtlsdr_tpu.io.config import read_config, signal_channels
    from coherent_rtlsdr_tpu.io.server import CoherentServer
    from coherent_rtlsdr_tpu.pipeline import PipelineConfig

    n = args.nchannels
    if args.config:
        defs = read_config(args.config)
        n = len(signal_channels(defs))
        print(f"config {args.config}: {n} signal channels")

    cfg = PipelineConfig(
        n_channels=n, block_len=args.blocksize, fs=args.fs,
        fft_impl=args.fft_impl,
        lag_method="phase_zoom" if args.fft_impl == "fused" else "phase_slope",
    )

    producer = None
    if args.source == "rtlsdr":
        from coherent_rtlsdr_tpu import native
        from coherent_rtlsdr_tpu.io.config import get_refname
        from coherent_rtlsdr_tpu.signal.sources import RtlSource

        if args.rtl_lib or not native.rtlsdr_available():
            if not native.rtlsdr_load(args.rtl_lib):
                ap.error("librtlsdr not found (set --rtl-lib or "
                         "$COHERENT_LIBRTLSDR)")
        gains_db = None
        if args.serials:
            serials = [s for s in args.serials.split(",") if s]
        elif args.config:
            defs = read_config(args.config)
            sig_defs = signal_channels(defs)
            serials = [get_refname(defs)] + [d.serial for d in sig_defs]
            ref_def = next(d for d in defs if d.devindex == 0)
            gains = [ref_def.gain_db] + [d.gain_db for d in sig_defs]
            if any(g is not None for g in gains):
                gains_db = gains  # per-channel gains from the config file
        else:
            serials = native.rtlsdr_enumerate()
            print(f"enumerated {len(serials)} dongles: {serials}")
        if args.refserial:
            if args.refserial not in serials:
                ap.error(f"-I serial '{args.refserial}' not in {serials}")
            i = serials.index(args.refserial)
            serials.insert(0, serials.pop(i))
            if gains_db is not None:
                gains_db.insert(0, gains_db.pop(i))
        if len(serials) < 2:
            ap.error("rtlsdr source needs >= 2 dongles (ref + signal)")
        if len(serials) - 1 != n:
            n = len(serials) - 1
            import dataclasses

            cfg = dataclasses.replace(cfg, n_channels=n)
        # RtlSource owns the NativeRtlCapture handle, so console
        # fcenter/fs/add/del reach the dongles (console.cc:156-270 parity).
        # Ring capacity follows --max-channels for hot-add headroom.
        source = RtlSource.start(
            serials, block_len=args.blocksize, ring_slots=args.ring_slots,
            max_channels=args.max_channels, fs=args.fs,
            fcenter=args.fcenter, gain_db=args.gain,
            ref_gain_db=args.refgain, agc=args.agc, gains_db=gains_db,
        )
        producer = source.capture
    elif args.source == "ring":
        from coherent_rtlsdr_tpu import native
        from coherent_rtlsdr_tpu.signal.sources import RingSource

        block_bytes = (n + 1) * args.blocksize * 2
        # Per-channel seqnum tracks: a zmq ingest daemon publishing header
        # frames (apps/capture_daemon.py default) carries per-device
        # capture seqnums end to end; raw blocks / file replay fall back to
        # a frame counter replicated across the tracks.
        ring = native.NativeBlockRing(args.ring_slots, block_bytes,
                                      n_seq=n + 1)
        if not args.ingest:
            ap.error("--source ring requires --ingest file:<path> | zmq:<addr>")
        kind, _, spec = args.ingest.partition(":")
        if kind == "file":
            path, _, rate = spec.partition("@")
            producer = native.NativeProducer.file(
                ring, path, rate_blocks_per_s=float(rate) if rate else 0.0,
                loop=True,
            )
        elif kind == "zmq":
            producer = native.NativeProducer.zmq(ring, spec)
        else:
            ap.error(f"unknown ingest '{args.ingest}'")
        source = RingSource(ring, n_channels=n, block_len=args.blocksize)
    elif args.source == "file":
        from coherent_rtlsdr_tpu.io.streamio import load_capture
        from coherent_rtlsdr_tpu.signal.sources import FileSource

        source = FileSource(load_capture(args.capture), loop=False)
    else:
        from coherent_rtlsdr_tpu.signal import make_truth
        from coherent_rtlsdr_tpu.signal.sources import SyntheticStreamSource

        truth = make_truth(n, seed=args.seed, max_delay=40.0, snr_db=30.0)
        source = SyntheticStreamSource(
            truth,
            block_len=args.blocksize,
            seed=args.seed,
            drop_rate=args.drop_rate,
        )

    mesh = None
    if args.mesh > 1:
        from coherent_rtlsdr_tpu.parallel import make_mesh

        mesh = make_mesh(1, args.mesh)
    server = CoherentServer(
        cfg,
        source,
        fcenter=args.fcenter,
        data_addr=args.address,
        ctrl_addr=args.ctrl_address,
        debug_addr=args.debug_address,
        header=not args.raw,
        state_path=args.state,
        scan_depth=args.scan_depth,
        max_channels=args.max_channels,
        mesh=mesh,
    )
    print(
        f"coherent_rtlsdr_tpu server: {n} ch x {args.blocksize} @ {args.fs:.0f} "
        f"sps, data {args.address}, ctrl {args.ctrl_address}"
    )
    # Clean shutdown on SIGINT/SIGTERM: finish the current block, stop
    # producers, restore skewed dongles, save calibration state. The
    # reference's teardown is documented as not always clean (README.md:20,
    # main.cc:281-315); here exit is just "leave the loop".
    import signal as _signal

    def _graceful(signum, frame):
        print(f"\nsignal {signum}: shutting down after current block",
              flush=True)
        server.request_exit()

    _signal.signal(_signal.SIGINT, _graceful)
    _signal.signal(_signal.SIGTERM, _graceful)

    if args.hw_drift_relief is not None:
        if args.source != "rtlsdr":
            ap.error("--hw-drift-relief requires --source rtlsdr")
        from coherent_rtlsdr_tpu.io.hwcontrol import HwDriftRelief

        server.hw_relief = HwDriftRelief(
            producer, fs=args.fs, threshold=args.hw_drift_relief
        )
    if args.quiet:
        server.capture_stderr()
    if args.interactive:
        server.start_local_console()
    import contextlib

    if args.trace:
        import jax

        trace_cm = jax.profiler.trace(args.trace)
        print(f"profiler trace -> {args.trace}")
    else:
        trace_cm = contextlib.nullcontext()
    with trace_cm:
        published = server.run(max_blocks=args.blocks)
    if producer is not None:
        producer.stop()
    print(f"published {published} frames")


if __name__ == "__main__":
    main()
