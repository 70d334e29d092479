#!/usr/bin/env python3
"""Capture daemon: publish raw sample blocks from a capture host to a
remote pipeline host.

The multi-host ingest topology: dongles (or a replayed capture, or the
synthetic model) sit on a capture host near the antennas; the pipeline
host runs ``coherent_server.py --source ring --ingest zmq:<this daemon>``
whose native C++ SUB thread (native/coherent_host.cc zmq_producer_main)
receives these blocks straight into the SPSC ring. This is the reference's
raw output mode (main.cc:105,148-150) turned into the czmqsdr stub's intent
(include/csdrdevice.h:270-272): a network-fed device.

Wire (one ZMQ PUB message per block, reference channel first, then N
signal channels — the RingSource slot layout):

  * ``--wire header`` (default): the reference wire frame (io/wire.py —
    hdr0 {gseq, N+1, L} + per-channel uint32 capture seqnums + int8 IQ).
    The seqnums are the per-device capture counters (the reference's
    ``readcnt``, src/crtlsdr.cc:181-188), so a capture-side drop on THIS
    host gaps exactly that channel in the remote pipeline — end-to-end
    readcnt semantics (cpacketizer.cc:142) across the network hop.
  * ``--wire raw``: header-less ``(N+1) * L * 2`` uint8 bytes (the
    reference's -R mode) — no seqnums on the wire; the remote side
    synthesizes a frame counter and upstream drops are invisible.

    python apps/capture_daemon.py -n 4 -b 8192 -A "tcp://*:5554"
    python apps/capture_daemon.py --source rtlsdr -C array.cfg -A "tcp://*:5554"
    # pipeline host:
    python apps/coherent_server.py --source ring --ingest zmq:tcp://cap:5554 -n 4
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _paced_blocks(src, rate):
    """Rate-paced generator over a block source: yields
    ``(frame_u8 [N+1, L, 2], seqnums [N+1] u32)`` — reference channel
    first with its own frame counter (the ref never drops host-side),
    signal channels carrying the source's per-channel capture seqnums."""
    import numpy as np

    def blocks():
        period = 1.0 / rate
        nxt = time.monotonic()
        ref_seq = 0
        while True:
            blk = src.next_block()
            if blk is None:
                return
            sig, ref, seqs = blk
            ref_seq += 1
            nxt += period
            time.sleep(max(0.0, nxt - time.monotonic()))
            frame = np.concatenate(
                [np.asarray(ref)[None], np.asarray(sig)], axis=0
            )
            yield frame, np.concatenate(
                [[np.uint32(ref_seq)], np.asarray(seqs, np.uint32)]
            )

    return blocks


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--nchannels", type=int, default=4)
    ap.add_argument("-b", "--blocksize", type=int, default=8192)
    ap.add_argument("-s", "--fs", type=float, default=2.048e6)
    ap.add_argument("-f", "--fcenter", type=float, default=1024e6)
    ap.add_argument("-g", "--gain", type=float, default=50.0)
    ap.add_argument("-r", "--refgain", type=float, default=50.0)
    ap.add_argument("-A", "--address", default="tcp://*:5554")
    ap.add_argument("-C", "--config", default=None)
    ap.add_argument("--source", choices=["synth", "file", "rtlsdr"],
                    default="synth")
    ap.add_argument("--capture", default=None, help="file source: raw capture")
    ap.add_argument("--serials", default=None,
                    help="rtlsdr: comma-separated serials, reference first")
    ap.add_argument("--rtl-lib", default=None)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="blocks/s pacing (synth/file; 0 = real-time fs/L)")
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wire", choices=["header", "raw"], default="header",
                    help="header = seqnum-carrying reference wire frames "
                         "(per-channel drop visibility downstream); raw = "
                         "header-less blocks (reference -R mode)")
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="synth: per-channel block drop injection (testing "
                         "the end-to-end gap chain)")
    args = ap.parse_args()

    import numpy as np
    import zmq

    n = args.nchannels
    L = args.blocksize
    rate = args.rate if args.rate > 0 else args.fs / L

    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.bind(args.address)

    capture = None
    if args.source == "rtlsdr":
        from coherent_rtlsdr_tpu import native
        from coherent_rtlsdr_tpu.io.config import (
            get_refname,
            read_config,
            signal_channels,
        )

        if args.rtl_lib or not native.rtlsdr_available():
            if not native.rtlsdr_load(args.rtl_lib):
                ap.error("librtlsdr not found")
        if args.serials:
            serials = [s for s in args.serials.split(",") if s]
        elif args.config:
            defs = read_config(args.config)
            serials = [get_refname(defs)] + [
                d.serial for d in signal_channels(defs)
            ]
        else:
            serials = native.rtlsdr_enumerate()
        n = len(serials) - 1
        # per-channel seqnum tracks: the dongles' capture-order readcnt
        # rides the wire in header mode
        ring = native.NativeBlockRing(16, (n + 1) * L * 2, n_seq=n + 1)
        capture = native.NativeRtlCapture(
            ring, serials, block_len=L, fs=args.fs, fcenter=args.fcenter,
            gain_db=args.gain, ref_gain_db=args.refgain,
        )

        def blocks():
            while True:
                out = ring.pop_n(timeout_ms=5000)
                if out is None:
                    if not capture.running:
                        return
                    continue
                buf, seqs64, _ts = out
                yield (buf.reshape(n + 1, L, 2),
                       seqs64[: n + 1].astype(np.uint32))
    elif args.source == "file":
        from coherent_rtlsdr_tpu.io.streamio import load_capture
        from coherent_rtlsdr_tpu.signal.sources import FileSource

        src = FileSource(load_capture(args.capture), loop=True)
        blocks = _paced_blocks(src, rate)
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from coherent_rtlsdr_tpu.signal import make_truth
        from coherent_rtlsdr_tpu.signal.sources import SyntheticStreamSource

        truth = make_truth(n, seed=args.seed, max_delay=40.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, seed=args.seed,
                                    drop_rate=args.drop_rate)
        blocks = _paced_blocks(src, rate)

    header = args.wire == "header"
    if header:
        from coherent_rtlsdr_tpu.io.wire import pack_frame

    print(f"capture daemon: {n}+1 ch x {L} -> PUB {args.address} "
          f"({args.source}, {args.wire} wire, {rate:.1f} blocks/s)",
          flush=True)
    sent = 0
    try:
        for frame_u8, seqs in blocks():
            if header:
                # wire payload is signed int8 (cdsp::convtosigned: u8 ^ 0x80)
                iq = (np.ascontiguousarray(frame_u8) ^ np.uint8(0x80)).view(
                    np.int8
                )
                buf = pack_frame(sent, seqs, iq)
            else:
                buf = np.ascontiguousarray(frame_u8).tobytes()
            pub.send(buf)
            sent += 1
            if args.blocks is not None and sent >= args.blocks:
                break
    except KeyboardInterrupt:
        pass
    finally:
        if capture is not None:
            capture.stop()
        pub.close(0)
        ctx.term()
    print(f"published {sent} blocks", flush=True)


if __name__ == "__main__":
    main()
