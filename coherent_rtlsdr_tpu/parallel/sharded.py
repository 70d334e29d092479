"""shard_map runners for the pipeline over a (time, channel) mesh.

Communication inventory (cf. SURVEY.md §2.4 — what replaces the reference's
threads/mutex/ZMQ intra-process movement):

  * overlap-save halo: each time shard sends its LAST block (signal + ref) to
    the next shard with ``lax.ppermute`` — one L-sample hop over the
    device interconnect per processed slab, the analog of the FIR-tail exchange in distributed
    overlap-save filtering.
  * reference broadcast: the reference channel is replicated across the
    ``channel`` axis by the input sharding (it is small); no collective in
    the hot loop.
  * smoother reductions: "global" smoothing needs a quality-weighted mean of
    per-block lags and phases — two tiny ``psum``s over the ``time`` axis.

Everything else is local — which is the point of the design: per-device work
is batched FFTs (memory-bandwidth-bound) and collectives are O(N*L) per slab,
so samples/s should scale ~linearly in devices.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from coherent_rtlsdr_tpu.ops.convert import u8_to_c64
from coherent_rtlsdr_tpu.ops.delay import apply_delay_phase_freq
from coherent_rtlsdr_tpu.ops.phase import phase_correction_estimate
from coherent_rtlsdr_tpu.ops.xcorr import lag_estimate_from_spectra
from coherent_rtlsdr_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS
from coherent_rtlsdr_tpu.pipeline.state import PipelineConfig
from coherent_rtlsdr_tpu.pipeline.step import step


def _halo_prev_block(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Receive the previous time shard's last block; shard 0 gets zeros.

    x: local blocks ``[T_loc, ...]``; returns ``[...]`` (one block).
    """
    n = jax.lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(n - 1)]
    halo = jax.lax.ppermute(x[-1], axis_name, perm)
    is_first = jax.lax.axis_index(axis_name) == 0
    return jnp.where(is_first, jnp.zeros_like(halo), halo)


def make_sharded_align(cfg: PipelineConfig, mesh, smoothing: str = "global"):
    """Sharded offline alignment over a (time, channel) mesh.

    Input:  sig_u8 ``[T, N, L, 2]`` sharded P(time, channel);
            ref_u8 ``[T, L, 2]`` sharded P(time) (replicated over channel).
    Output: aligned ``[T, N, L]`` c64 P(time, channel); ref_out ``[T, L]``
            P(time); delay/mag ``[T, N]`` P(time, channel).

    Produces T output blocks: block 0 of the first shard seeds from a zero
    halo (same semantics as the streaming step's first block). Only "global"
    smoothing is supported sharded — it reduces exactly with ``psum``, so the
    result matches the unsharded engine bit-for-bit up to reduction order.
    """
    if smoothing != "global":
        raise NotImplementedError(
            "sharded align supports smoothing='global' (EMA is sequential in "
            "time; use the streaming step or unsharded align for it)"
        )
    L = cfg.block_len

    def local_fn(sig_u8, ref_u8):
        # Local shards: sig_u8 [T_loc, N_loc, L, 2]; ref_u8 [T_loc, L, 2].
        sig = u8_to_c64(sig_u8)
        ref = u8_to_c64(ref_u8)

        prev_sig = _halo_prev_block(sig, TIME_AXIS)  # [N_loc, L]
        prev_ref = _halo_prev_block(ref, TIME_AXIS)  # [L]

        # Extended block axis, then streaming windows w[t] = (t-1, t).
        ext_sig = jnp.concatenate([prev_sig[None], sig], axis=0)
        ext_ref = jnp.concatenate([prev_ref[None], ref], axis=0)
        w_sig = jnp.concatenate([ext_sig[:-1], ext_sig[1:]], axis=-1)  # [T_loc, N_loc, 2L]
        w_ref = jnp.concatenate([ext_ref[:-1], ext_ref[1:]], axis=-1)  # [T_loc, 2L]

        F_sig = jnp.fft.fft(w_sig, axis=-1)
        F_ref = jnp.fft.fft(w_ref, axis=-1)

        est = jax.vmap(
            lambda fs, fr: lag_estimate_from_spectra(fs, fr, method=cfg.lag_method)
        )(F_sig, F_ref)

        # Global quality-weighted mean over ALL time blocks: two psums.
        # The very first window of the capture straddles the zero halo, so
        # its measurement is excluded — this makes the sharded reduction sum
        # exactly the same terms as the unsharded engine (test-verified).
        w = (est.mag >= cfg.min_corr_mag).astype(jnp.float32)
        is_first_shard = jax.lax.axis_index(TIME_AXIS) == 0
        w = w.at[0].set(jnp.where(is_first_shard, 0.0, w[0]))
        q = w * est.mag * est.mag
        num = jax.lax.psum(jnp.sum(q * est.lag, axis=0), TIME_AXIS)
        den = jax.lax.psum(jnp.sum(q, axis=0), TIME_AXIS)
        delay = num / jnp.where(den > 0, den, 1.0)  # [N_loc]
        delay = jnp.clip(delay, -cfg.max_delay, cfg.max_delay)

        y = jnp.fft.ifft(
            apply_delay_phase_freq(
                F_sig, delay[None, :], jnp.ones((), jnp.complex64)
            ),
            axis=-1,
        )
        out_raw = y[..., L // 2 : L // 2 + L]         # [T_loc, N_loc, L]
        out_ref = w_ref[..., L // 2 : L // 2 + L]      # [T_loc, L]

        pc_inst = jax.vmap(phase_correction_estimate)(out_raw, out_ref)
        z = jax.lax.psum(jnp.sum(pc_inst * w, axis=0), TIME_AXIS)  # [N_loc]
        zmag = jnp.abs(z)
        pc = (z / jnp.where(zmag > 0, zmag, 1.0)).astype(jnp.complex64)

        aligned = out_raw * pc[None, :, None]
        delay_blocks = jnp.broadcast_to(delay[None, :], est.lag.shape)
        return aligned, out_ref, delay_blocks, est.mag

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(TIME_AXIS, CHANNEL_AXIS, None, None),
            P(TIME_AXIS, None, None),
        ),
        out_specs=(
            P(TIME_AXIS, CHANNEL_AXIS, None),
            P(TIME_AXIS, None),
            P(TIME_AXIS, CHANNEL_AXIS),
            P(TIME_AXIS, CHANNEL_AXIS),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


def make_channel_sharded_align(cfg: PipelineConfig, mesh):
    """Offline align sharded over the CHANNEL axis only — works with every
    backend. For the fused backend on a mesh with a TIME axis, use
    :func:`make_fused_time_sharded_align` — the raw-byte halo runner that
    scales the fused engine over BOTH axes.

    With channels split and time local, everything is channel-local: each
    shard runs the complete offline engine (measure -> smooth -> apply,
    pipeline/offline.py) on its channel slice with the replicated reference
    — ZERO collectives in the hot path, so scaling is the ideal
    samples/s x n_devices (the reference channel's windows are recomputed
    per shard: 1/N_loc of one shard's work).

    Input: sig_u8 ``[T, N, L, 2]`` (or flat ``[T, N, 2L]``) P(channel on
    axis 1); ref_u8 replicated. Returns (wire, delay, mag): int8 wire
    blocks (the complex aligned blocks stay on the device).
    """
    import dataclasses

    n_sh = mesh.shape[CHANNEL_AXIS]
    if cfg.n_channels % n_sh:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by {n_sh} shards"
        )
    local_cfg = dataclasses.replace(cfg, n_channels=cfg.n_channels // n_sh)

    from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq
    from coherent_rtlsdr_tpu.pipeline.offline import align_offline

    def local_fn(sig_u8, ref_u8):
        res = align_offline(local_cfg, sig_u8, ref_u8, smoothing="global")
        wire = res.wire if res.wire is not None else c64_to_i8_iq(res.aligned)
        return wire, res.delay, res.mag

    # Build the shard_map/jit ONCE per input rank: jit's cache is identity-
    # based, so a fresh closure per call would retrace (and reload the
    # executable) every invocation. Keyed on (sig.ndim, ref.ndim): the
    # fused backend ships flat [T, N, 2L] bytes, the others [T, N, L, 2].
    jits = {}

    def run(sig_u8, ref_u8):
        key = (sig_u8.ndim, ref_u8.ndim)
        fn = jits.get(key)
        if fn is None:
            in_specs = (
                P(None, CHANNEL_AXIS, None, None) if key[0] == 4
                else P(None, CHANNEL_AXIS, None),
                P(*([None] * key[1])),
            )
            # fused backend emits flat [T-1, N_loc, 2L] int8 wire; others
            # [T-1, N_loc, L, 2] via c64_to_i8_iq
            wire_spec = (
                P(None, CHANNEL_AXIS, None) if cfg.fft_impl == "fused"
                else P(None, CHANNEL_AXIS, None, None)
            )
            out_specs = (wire_spec, P(None, CHANNEL_AXIS),
                         P(None, CHANNEL_AXIS))
            fn = jax.jit(shard_map(
                local_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                check_vma=False,
            ))
            jits[key] = fn
        return fn(sig_u8, ref_u8)

    return run


def make_fused_time_sharded_align(
    cfg: PipelineConfig, mesh, smoothing: str = "global"
):
    """The fused i8 offline engine sharded over the FULL (time, channel)
    mesh — the multi-device throughput path.

    The time-axis halo is hand-scheduled exactly like
    :func:`make_sharded_align`'s, but in the fused engine's native currency,
    raw capture bytes: each time shard ``ppermute``s its LAST i8 block
    (signal + reference, one ``[*, L, 2]`` byte block per shard boundary)
    to the next shard, prepends it, and runs the complete fused engine on
    the local slab (measure_i8 -> psum-reduced global smoothing ->
    apply_i8). The windows are assembled from consecutive block pairs by
    the engine, so the halo is the whole exchange — O(N_loc * 2L) bytes per
    slab. Channel shards are collective-free; each recomputes the
    replicated reference's window spectra.

    Input:  sig_u8 ``[T, N, 2L]`` u8 FLAT bytes, P(time, channel);
            ref_u8 ``[T, 2L]`` u8, P(time).
    Output: wire ``[T, N, 2L]`` i8 P(time, channel); wire_ref ``[T, 2L]``
            i8 P(time); delay/mag ``[T, N]`` P(time, channel).

    Window t = blocks (t-1, t), like make_sharded_align: T outputs, the
    first seeded from a zero halo (u8 0x80 = i8 zero IQ, the streaming
    step's init_state seeding) and excluded from the smoothing psums — so
    the global delay/phase solutions sum exactly the terms the unsharded
    engine sums, and ``wire[1:]`` matches the unsharded engine's T-1
    outputs (to reduction order).
    """
    if cfg.fft_impl != "fused":
        raise ValueError(
            "make_fused_time_sharded_align is the fused-backend runner "
            f"(got fft_impl='{cfg.fft_impl}'); use make_sharded_align for "
            "the XLA path"
        )
    if smoothing != "global":
        raise NotImplementedError(
            "fused time-sharded align supports smoothing='global' (EMA is "
            "sequential in time; use the streaming step for it)"
        )
    from coherent_rtlsdr_tpu.kernels.backend import get_spectral
    from coherent_rtlsdr_tpu.ops.convert import u8_to_i8

    L = cfg.block_len
    sp = get_spectral(cfg, 2 * L)

    def local_fn(sig_u8, ref_u8):
        # Local shards: sig_u8 [T_loc, N_loc, 2L] u8; ref_u8 [T_loc, 2L].
        T_loc, N_loc = sig_u8.shape[:2]
        raw = u8_to_i8(sig_u8.reshape(T_loc, N_loc, L, 2))
        ref_raw = u8_to_i8(ref_u8.reshape(T_loc, L, 2))

        # Overlap-save halo: previous time shard's last raw block (zeros on
        # shard 0 — i8 0 == u8 0x80 == zero IQ).
        prev_sig = _halo_prev_block(raw, TIME_AXIS)       # [N_loc, L, 2]
        prev_ref = _halo_prev_block(ref_raw, TIME_AXIS)   # [L, 2]
        ext = jnp.concatenate([prev_sig[None], raw], axis=0)
        ext_ref = jnp.concatenate([prev_ref[None], ref_raw], axis=0)

        # Phase A over T_loc windows; the window spectra are kept for C.
        est = sp.measure_i8(ext, ext_ref)
        lag, mag = est.lag, est.mag

        # Phase B: global quality-weighted smoothing — two psums over the
        # time axis. The zero-halo window (shard 0, window 0) is excluded
        # so the reduction sums exactly the unsharded engine's terms.
        w = (mag >= cfg.min_corr_mag).astype(jnp.float32)
        is_first = jax.lax.axis_index(TIME_AXIS) == 0
        w = w.at[0].set(jnp.where(is_first, 0.0, w[0]))
        q = w * mag * mag
        num = jax.lax.psum(jnp.sum(q * lag, axis=0), TIME_AXIS)
        den = jax.lax.psum(jnp.sum(q, axis=0), TIME_AXIS)
        delay = num / jnp.where(den > 0, den, 1.0)        # [N_loc]
        delay = jnp.clip(delay, -cfg.max_delay, cfg.max_delay)
        delay_b = jnp.broadcast_to(delay[None], lag.shape)

        # Global phase: pc_inst = conj(z)/|z| per window, reduced as float
        # pairs, quality-weighted psum mean, renormalized
        # (pipeline/offline.py _smooth_phases 'global').
        zre, zim = jnp.real(est.z), jnp.imag(est.z)
        zabs = jnp.sqrt(zre * zre + zim * zim)
        safe = jnp.where(zabs > 0, zabs, 1.0)
        pr = jnp.where(zabs > 0, zre / safe, 1.0)
        pi = jnp.where(zabs > 0, -zim / safe, 0.0)
        zr = jax.lax.psum(jnp.sum(pr * w, axis=0), TIME_AXIS)  # [N_loc]
        zi = jax.lax.psum(jnp.sum(pi * w, axis=0), TIME_AXIS)
        zn = jnp.sqrt(zr * zr + zi * zi)
        zsafe = jnp.where(zn > 0, zn, 1.0)
        pc = jax.lax.complex(jnp.where(zn > 0, zr / zsafe, 1.0),
                             jnp.where(zn > 0, zi / zsafe, 0.0))
        pc = jnp.broadcast_to(pc[None], lag.shape)

        # Phase C: apply from the stored spectra -> int8 wire bytes.
        wire = sp.apply_i8(est.spec, delay_b, pc)          # [T_loc, N_loc, 2L]
        wire_ref = jnp.concatenate(
            [ext_ref[:-1, L // 2:], ext_ref[1:, : L // 2]], axis=1
        ).reshape(T_loc, 2 * L)
        return wire, wire_ref, delay_b, mag

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(TIME_AXIS, CHANNEL_AXIS, None),
            P(TIME_AXIS, None),
        ),
        out_specs=(
            P(TIME_AXIS, CHANNEL_AXIS, None),
            P(TIME_AXIS, None),
            P(TIME_AXIS, CHANNEL_AXIS),
            P(TIME_AXIS, CHANNEL_AXIS),
        ),
        check_vma=False,
    )
    return jax.jit(fn)


def state_partition_spec():
    """PartitionSpec pytree for PipelineState sharded over the channel axis
    (per-channel leaves split; reference history and scalars replicated)."""
    from coherent_rtlsdr_tpu.pipeline.state import PipelineState

    return PipelineState(
        delay=P(CHANNEL_AXIS),
        phase=P(CHANNEL_AXIS, None),
        lag=P(CHANNEL_AXIS),
        mag=P(CHANNEL_AXIS),
        papr=P(CHANNEL_AXIS),
        synced=P(CHANNEL_AXIS),
        hist=P(CHANNEL_AXIS, None, None),
        ref_hist=P(None, None),
        block_idx=P(),
        last_seq=P(CHANNEL_AXIS),
        gaps=P(CHANNEL_AXIS),
    )


def make_auto_sharded_align(cfg: PipelineConfig, mesh, smoothing: str = "global"):
    """GSPMD-partitioned offline align: same numerics as the unsharded
    engine for BOTH smoothers (including the sequential-looking EMA — the
    associative scan partitions across time shards automatically), with
    XLA inserting the halo/reduction collectives from sharding constraints.

    Complements make_sharded_align (explicit shard_map): that one is the
    hand-scheduled layout; this one trades explicit control for full
    smoothing generality. Input shardings: sig [T, N, L, 2] P(time,
    channel); ref [T, L, 2] P(time).

    Use it with ``cfg.fft_impl='mxu'``: the four-step matmul
    formulation contains no FFT custom-call, so GSPMD partitions every op
    (XLA's FFT runtime rejects the partitioner's non-major layouts,
    observed on CPU).
    """
    from jax.sharding import NamedSharding

    from coherent_rtlsdr_tpu.pipeline.offline import align_offline

    sig_sh = NamedSharding(mesh, P(TIME_AXIS, CHANNEL_AXIS, None, None))
    ref_sh = NamedSharding(mesh, P(TIME_AXIS, None, None))

    @jax.jit
    def fn(sig_u8, ref_u8):
        sig_u8 = jax.lax.with_sharding_constraint(sig_u8, sig_sh)
        ref_u8 = jax.lax.with_sharding_constraint(ref_u8, ref_sh)
        res = align_offline(cfg, sig_u8, ref_u8, smoothing=smoothing)
        return res

    def run(sig_u8, ref_u8):
        sig_u8 = jax.device_put(sig_u8, sig_sh)
        ref_u8 = jax.device_put(ref_u8, ref_sh)
        return fn(sig_u8, ref_u8)

    return run


def make_sharded_server_jits(cfg: PipelineConfig, mesh, scan_depth: int = 1):
    """The streaming SERVER's jitted entry points, channel-sharded — what a
    multi-device deployment runs (docs/SCALING.md): per-channel DSP split over the
    ``channel`` mesh axis, the reference block replicated, zero hot-loop
    collectives. Signatures match io/server.py's unsharded jits exactly:

      step_fn(state, sig_u8, ref_u8, gate, seq)
          -> (state, wire, wire_ref, packed_telem)
      scan_fn(state, sigs [K,..], refs [K,..], gate, seqs [K,N])
          -> (state, (wires, wire_refs), packed_telems)   (None if depth 1)

    The reference-channel outputs are computed identically on every shard
    (replicated out_specs); telemetry crosses packed ([.., N, 10]).
    """
    import dataclasses

    from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq
    from coherent_rtlsdr_tpu.pipeline.state import pack_telemetry

    n_sh = mesh.shape[CHANNEL_AXIS]
    if cfg.n_channels % n_sh:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by {n_sh} channel "
            "shards (with --max-channels, pick a multiple of the mesh)"
        )
    local_cfg = dataclasses.replace(cfg, n_channels=cfg.n_channels // n_sh)
    fused = cfg.fft_impl == "fused"
    sig_spec = P(CHANNEL_AXIS, None) if fused else P(CHANNEL_AXIS, None, None)
    ref_spec = P(None) if fused else P(None, None)
    telem_spec = P(CHANNEL_AXIS, None)
    sspec = state_partition_spec()

    def local_step(state, sig_u8, ref_u8, gate, seq):
        new_state, out = step(local_cfg, state, sig_u8, ref_u8, gate, seq=seq)
        if out.wire is not None:
            wire, wire_ref = out.wire, out.wire_ref
        else:
            wire = c64_to_i8_iq(out.aligned)
            wire_ref = c64_to_i8_iq(out.ref)
        return new_state, wire, wire_ref, pack_telemetry(out.telemetry)

    step_fn = jax.jit(
        shard_map(
            local_step, mesh=mesh,
            in_specs=(sspec, sig_spec, ref_spec, P(), P(CHANNEL_AXIS)),
            out_specs=(sspec, sig_spec, ref_spec, telem_spec),
            check_vma=False,
        ),
        donate_argnums=(0,),
    )

    scan_fn = None
    if scan_depth > 1:
        def scanned(spec):  # prepend the scan axis to a PartitionSpec
            return P(*((None,) + tuple(spec)))

        def local_scan(state, sigs, refs, gate, seqs):
            def body(s, blk):
                s2, w, wr, t = local_step(s, blk[0], blk[1], gate, blk[2])
                return s2, ((w, wr), t)

            state, (payloads, telem) = jax.lax.scan(
                body, state, (sigs, refs, seqs)
            )
            return state, payloads, telem

        scan_fn = jax.jit(
            shard_map(
                local_scan, mesh=mesh,
                in_specs=(sspec, scanned(sig_spec), scanned(ref_spec), P(),
                          P(None, CHANNEL_AXIS)),
                out_specs=(sspec, (scanned(sig_spec), scanned(ref_spec)),
                           scanned(telem_spec)),
                check_vma=False,
            ),
            donate_argnums=(0,),
        )
    return step_fn, scan_fn


def make_sharded_step(cfg: PipelineConfig, mesh, donate: bool = True):
    """Streaming step sharded over the ``channel`` axis (the online path:
    one block at a time, channels split across chips, reference replicated).

    State must be created with per-shard channel counts consistent with the
    sharding (init_state(cfg) then device_put with the matching sharding).
    The per-channel DSP is collective-free; cross-device traffic is only the
    replicated L-sample reference block per step.
    """
    import dataclasses

    n_ch_shards = mesh.shape[CHANNEL_AXIS]
    if cfg.n_channels % n_ch_shards:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by channel shards={n_ch_shards}"
        )
    # replace() keeps EVERY config field (fft_impl/mxu_precision included —
    # the local step runs whatever backend the global config selects).
    local_cfg = dataclasses.replace(
        cfg, n_channels=cfg.n_channels // n_ch_shards
    )

    def local_fn(state, sig_u8, ref_u8, update_gate):
        return step(local_cfg, state, sig_u8, ref_u8, update_gate)

    # Per-channel state arrays shard over CHANNEL_AXIS on their leading dim;
    # scalars (block_idx) and the reference history replicate.
    from coherent_rtlsdr_tpu.pipeline.state import PipelineState

    sspec = state_partition_spec()
    from coherent_rtlsdr_tpu.pipeline.state import BlockOutput, Telemetry

    tspec = Telemetry(
        lag=P(CHANNEL_AXIS), residual=P(CHANNEL_AXIS), mag=P(CHANNEL_AXIS),
        papr=P(CHANNEL_AXIS), phase=P(CHANNEL_AXIS, None), synced=P(CHANNEL_AXIS),
        rms=P(CHANNEL_AXIS), gap=P(CHANNEL_AXIS), gaps=P(CHANNEL_AXIS),
    )
    if cfg.fft_impl == "fused":
        # the i8 path also emits flat int8 wire bytes (channel-sharded)
        ospec = BlockOutput(
            aligned=P(CHANNEL_AXIS, None), ref=P(None), telemetry=tspec,
            wire=P(CHANNEL_AXIS, None), wire_ref=P(None),
        )
    else:
        ospec = BlockOutput(
            aligned=P(CHANNEL_AXIS, None), ref=P(None), telemetry=tspec
        )

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(sspec, P(CHANNEL_AXIS, None, None), P(None, None), P()),
        out_specs=(sspec, ospec),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,) if donate else ())
