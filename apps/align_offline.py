#!/usr/bin/env python3
"""Offline capture alignment: capture .npz in -> aligned .npz + quality
report out. The measure->smooth->apply engine (pipeline/offline.py), the
capability the reference cannot express (it can only stream).

Usage:
  python apps/align_offline.py capture.npz -o aligned.npz [--smoothing ema]
  python apps/align_offline.py --synth 8 --blocks 32 -o aligned.npz  # demo
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_runner(cfg, smoothing: str = "global"):
    """The jitted offline alignment ``run(sig_u8 [T,N,L,2], ref_u8 [T,L,2])
    -> (aligned_i8, ref_i8, delay, mag, papr, phase_f)`` with int8 wire
    blocks for the signal and reference channels and the phase as float
    pairs — what ``main`` writes, and what chip_smoke.py times."""
    import jax

    from coherent_rtlsdr_tpu.ops.convert import c2f, c64_to_i8_iq
    from coherent_rtlsdr_tpu.pipeline import align_offline

    @jax.jit
    def run(s, r):
        res = align_offline(cfg, s, r, smoothing=smoothing)
        return (
            res.wire if res.wire is not None else c64_to_i8_iq(res.aligned),
            res.wire_ref if res.wire_ref is not None else c64_to_i8_iq(res.ref),
            res.delay,
            res.mag,
            res.papr,
            c2f(res.phase),
        )

    return run


def main(argv=None):
    from coherent_rtlsdr_tpu._bootstrap import setup_compile_cache

    setup_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("capture", nargs="?", default=None)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--smoothing", choices=["global", "ema"], default="global")
    ap.add_argument("--synth", type=int, default=None, help="generate N synthetic channels instead")
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--block-len", type=int, default=8192)
    ap.add_argument(
        "--mesh", type=int, default=1, metavar="SHARDS",
        help="shard the channel axis over this many devices "
             "(parallel/sharded.py make_channel_sharded_align — the "
             "multi-device offline engine; n_channels must divide evenly; "
             "with --cpu, virtual devices are created)",
    )
    ap.add_argument(
        "--fft-impl", choices=["xla", "mxu", "fused", "auto"],
        default="xla",
        help="spectral backend; 'fused' = the u8-native engine (raw bytes "
             "in, int8 wire bytes out)",
    )
    ap.add_argument(
        "--cpu", action="store_true",
        help="run on the host CPU (without it, a host where JAX finds no "
             "accelerator is an error)",
    )
    args = ap.parse_args(argv)

    if args.cpu and args.mesh > 1:
        from coherent_rtlsdr_tpu._bootstrap import force_virtual_devices

        force_virtual_devices(args.mesh)  # before jax initializes
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from coherent_rtlsdr_tpu._bootstrap import report_backend

    report_backend(allow_cpu=args.cpu)
    import jax.numpy as jnp
    import numpy as np

    from coherent_rtlsdr_tpu.pipeline import PipelineConfig

    if args.synth:
        from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

        with jax.default_device(jax.devices("cpu")[0]):
            truth = make_truth(args.synth, seed=0, max_delay=40.0, snr_db=30.0)
            cap = synth_capture(
                jax.random.PRNGKey(0), truth, n_blocks=args.blocks,
                block_len=args.block_len,
            )
            sig_u8, ref_u8 = np.asarray(cap.sig_u8), np.asarray(cap.ref_u8)
        print(f"synthetic capture: true delays {truth.delays.round(3)}")
        fs = 2.048e6
    else:
        from coherent_rtlsdr_tpu.io.streamio import load_capture

        c = load_capture(args.capture)
        sig_u8, ref_u8, fs = c.sig_u8, c.ref_u8, c.fs

    T, N, L, _ = sig_u8.shape
    cfg = PipelineConfig(
        n_channels=N, block_len=L, fft_impl=args.fft_impl,
        lag_method="phase_zoom" if args.fft_impl == "fused" else "phase_slope",
    )
    s, r = jnp.asarray(sig_u8), jnp.asarray(ref_u8)

    if args.mesh > 1:
        # Channel-sharded multi-device engine: each device runs the complete
        # offline align on its channel slice, zero hot-loop collectives
        # (docs/SCALING.md). Emits the int8 wire blocks + per-channel
        # delay/mag.
        from coherent_rtlsdr_tpu.parallel import make_mesh
        from coherent_rtlsdr_tpu.parallel.sharded import (
            make_channel_sharded_align,
        )

        if N % args.mesh:
            ap.error(f"--mesh {args.mesh} must divide n_channels={N}")
        if args.smoothing != "global":
            ap.error("--mesh supports --smoothing global only (the "
                     "channel-sharded engine smooths globally per slab)")
        mesh = make_mesh(1, args.mesh)
        run_sh = make_channel_sharded_align(cfg, mesh)
        wire, delay, mag = jax.block_until_ready(run_sh(s, r))
        aligned_i8 = np.asarray(wire).reshape(-1, N, L, 2)
        delay, mag = np.asarray(delay), np.asarray(mag)
        # The reference channel is its own timebase: its aligned wire is
        # exactly the overlap-save window centers of the raw bytes (the
        # u8->f32->i8 roundtrip is the identity on int8 values), so emit
        # it host-side — same npz schema as the unsharded path.
        rfull = (ref_u8.astype(np.int16) - 128).astype(np.int8)  # [T, L, 2]
        ref_i8 = np.concatenate(
            [rfull[:-1, L // 2:], rfull[1:, : L // 2]], axis=1
        )
        np.savez_compressed(
            args.out, aligned_i8=aligned_i8, ref_i8=ref_i8, delay=delay,
            mag=mag, fs=np.float64(fs),
        )
        print(f"aligned {aligned_i8.shape[0]} blocks x {N} ch over a "
              f"{args.mesh}-device channel mesh -> {args.out}")
        print(f"final delays: {delay[-1].round(3)}")
        print(f"mean corr:    {mag.mean(axis=0).round(3)}")
        return

    aligned_i8, ref_i8, delay, mag, papr, phase_f = jax.block_until_ready(
        make_runner(cfg, args.smoothing)(s, r)
    )
    aligned_i8 = np.asarray(aligned_i8).reshape(-1, N, L, 2)
    ref_i8 = np.asarray(ref_i8).reshape(-1, L, 2)
    delay, mag = np.asarray(delay), np.asarray(mag)
    phase = np.asarray(phase_f)
    phase_c = phase[..., 0] + 1j * phase[..., 1]

    np.savez_compressed(
        args.out,
        aligned_i8=aligned_i8,
        ref_i8=ref_i8,
        delay=delay,
        mag=mag,
        papr=np.asarray(papr),
        phase=phase_c,
        fs=np.float64(fs),
    )
    print(f"aligned {T-1} blocks x {N} ch -> {args.out}")
    print(f"final delays: {delay[-1].round(3)}")
    print(f"mean corr:    {mag.mean(axis=0).round(3)}")
    ang = np.degrees(np.angle(phase_c * np.conj(phase_c.mean(axis=0, keepdims=True))))
    print(f"phase stability (deg RMS over blocks): {np.sqrt(np.mean(ang**2)):.3f}")


if __name__ == "__main__":
    main()
