"""The per-block hot path as one pure, jittable function.

This replaces the reference's entire concurrent hot
loop — ccoherent::threadf (ccoherent.cc:245-294), computelag
(ccoherent.cc:154-239), est_phasecorrect/phasecorrect (csdrdevice.cc:58-84)
and the ccontrol feedback (ccontrol.cc:78-123) — with three structural
upgrades:

  * ONE batched FFT pass feeds both lag measurement and delay correction
    (the reference runs a separate zero-padded FFT batch for the lag queue,
    then corrects nothing — timing is fixed in hardware over seconds).
  * All N channels are measured every block (the reference round-robins
    <= 7 channels per block through its nfft=8 slot queue, main.cc:165).
  * Correction is applied *this block*, exactly, via a frequency-domain
    fractional advance with overlap-save — no hardware dwell, no eaten
    samples, no multi-second convergence.

Lag measurement uses circular correlation of contiguous 2L streaming windows
rather than the reference's zero-padded half-buffers (crtlsdr.cc:205-223):
for a continuous stream the wrapped terms are valid samples at wrong offsets
(zero-mean noise for a noise reference), so the estimator keeps full window
energy — slightly *better* SNR than zero-padding, with no extra FFT.
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from coherent_rtlsdr_tpu.constants import IQ_SCALE
from coherent_rtlsdr_tpu.ops.convert import (
    c2f,
    f2c,
    i8_iq_to_c64,
    u8_to_c64,
    u8_to_i8,
)
from coherent_rtlsdr_tpu.ops.phase import ema_complex, phase_correction_estimate
from coherent_rtlsdr_tpu.ops.spectral import rms
from coherent_rtlsdr_tpu.pipeline.control import control_update
from coherent_rtlsdr_tpu.pipeline.state import (
    BlockOutput,
    PipelineConfig,
    PipelineState,
    Telemetry,
)


def _seq_gap(state: PipelineState, seq, update_gate):
    """Shared seqnum-gap detection (see step() docstring): returns
    (seq, gap, new_gaps, meas_ok)."""
    if seq is None:
        seq = state.last_seq + jnp.uint32(1)
    seq = seq.astype(jnp.uint32)
    delta = seq - state.last_seq  # uint32 wraparound-safe
    gap = (delta != 1) & (state.block_idx > 0)  # [N] bool
    new_gaps = state.gaps + gap.astype(jnp.int32)
    meas_ok = update_gate & jnp.logical_not(gap)  # [N] per-channel gating
    return seq, gap, new_gaps, meas_ok


def step(
    cfg: PipelineConfig,
    state: PipelineState,
    sig_u8: jnp.ndarray,  # [N, L, 2] uint8 raw interleaved IQ
    ref_u8: jnp.ndarray,  # [L, 2] uint8 reference-channel raw IQ
    update_gate: jnp.ndarray,  # scalar bool — reference noise injected
    seq: jnp.ndarray = None,  # [N] uint32 per-channel capture seqnums
) -> Tuple[PipelineState, BlockOutput]:
    """Process one block: measure -> control -> correct -> phase -> emit.

    Output samples carry a fixed pipeline latency of L/2 samples (the
    overlap-save center window), which buys an instantaneous +-L/2-sample
    correction range. ``aligned[:, n]`` and ``ref[n]`` refer to the same
    instant — the coherent receive matrix row.

    ``seq`` enables in-pipeline gap detection: a per-channel seqnum jump
    (a dropped capture buffer — the reference's documented failure mode,
    README.md:42, detected only by clients via cpacketizer.cc:113,142)
    marks the channel's measurement invalid THIS block (its overlap-save
    window straddles the discontinuity), freezes its phase, desyncs it
    (policy: flag + freeze until it re-locks), and bumps its cumulative gap
    counter. ``seq=None`` synthesizes contiguous seqnums (no gaps).
    """
    if cfg.fft_impl == "fused":
        return _step_fused_u8(cfg, state, sig_u8, ref_u8, update_gate, seq)

    L = cfg.block_len
    sig = u8_to_c64(sig_u8)  # [N, L]
    ref = u8_to_c64(ref_u8)  # [L]

    # --- seqnum-gap detection -------------------------------------------
    seq, gap, new_gaps, meas_ok = _seq_gap(state, seq, update_gate)

    from coherent_rtlsdr_tpu.kernels.backend import get_spectral

    sp = get_spectral(cfg, 2 * L)

    # One block-preparation pass feeds both measurement and correction;
    # the window of this step is blocks (t-1, t) = (history, current).
    # (State history is stored as float pairs; complexify inside the
    # program.) Backends: kernels/backend.py.
    sig_blocks = jnp.stack([f2c(state.hist), sig])        # [2, N, L]
    ref_blocks = jnp.stack([f2c(state.ref_hist), ref])    # [2, L]
    ctx = sp.prepare(sig_blocks, ref_blocks)

    # Measure absolute lag of every channel (ccoherent::computelag analog).
    meas_b = sp.measure(ctx, cfg.lag_method)
    meas = jax.tree_util.tree_map(lambda a: a[0], meas_b)

    # Control update (ccontrol analog, numerical). Gap-hit channels ignore
    # this block's measurement and drop their sync flag.
    new_delay, new_synced = control_update(
        cfg, state.delay, state.synced, meas.lag, meas.mag, meas_ok
    )
    new_synced = new_synced & jnp.logical_not(gap)

    # Apply the fractional advance in frequency domain; overlap-save slice.
    out_raw = sp.correct(ctx, new_delay[None])[0]         # [N, L] aligned
    out_ref = jnp.concatenate(
        [f2c(state.ref_hist)[L // 2:], ref[: L // 2]]
    )                                                     # [L] same latency

    # Phase estimation on the time-aligned signal (est_phasecorrect analog),
    # gated by the reference-noise flag (ccoherent.cc:271-273) and by
    # measurement quality.
    pc_inst = phase_correction_estimate(out_raw, out_ref)
    good = meas_ok & (meas.mag >= cfg.min_corr_mag)
    old_phase = f2c(state.phase)
    ema = ema_complex(old_phase, pc_inst, alpha=cfg.phase_alpha)
    new_phase = jnp.where(good, ema, old_phase)

    aligned = out_raw * new_phase[:, None]

    telemetry = Telemetry(
        lag=meas.lag,
        residual=meas.lag - new_delay,
        mag=meas.mag,
        papr=meas.papr,
        phase=c2f(new_phase),
        synced=new_synced,
        rms=rms(sig, axis=-1),
        gap=gap,
        gaps=new_gaps,
    )
    new_state = PipelineState(
        delay=new_delay,
        phase=c2f(new_phase),
        lag=meas.lag,
        mag=meas.mag,
        papr=meas.papr,
        synced=new_synced,
        hist=c2f(sig),
        ref_hist=c2f(ref),
        block_idx=state.block_idx + 1,
        last_seq=seq,
        gaps=new_gaps,
    )
    return new_state, BlockOutput(aligned=aligned, ref=out_ref, telemetry=telemetry)


def _step_fused_u8(
    cfg: PipelineConfig,
    state: PipelineState,
    sig_u8: jnp.ndarray,   # [N, L, 2] uint8 (or flat [N, 2L])
    ref_u8: jnp.ndarray,   # [L, 2] uint8 (or flat [2L])
    update_gate: jnp.ndarray,
    seq: jnp.ndarray = None,
) -> Tuple[PipelineState, BlockOutput]:
    """The fft_impl='fused' streaming step: raw u8 bytes in, int8 wire bytes
    out (kernels/backend.FusedSpectral.measure_i8 / apply_i8).

    vs the generic step():
      * history is the signed int8 capture bytes (4x less state than f32
        pairs); dequantization happens inside the window assembly;
      * the phase estimate is arg(z) from the measurement's correlation
        value (Parseval: <y_corrected, ref_window> = z/W at the measured
        lag) — identical to the time-domain conj-dot when the channel is
        locked (applied delay == measured lag), and gated identically;
      * one window spectrum feeds both measurement and correction, and the
        phase correction multiplies it before the inverse transform, which
        requantizes straight to int8 wire bytes.

    Semantic deltas vs the generic step (both below measurement noise once
    locked, and covered by the equivalence tests): the phase estimate uses
    the full 2L window at the measured lag rather than the center half at
    the applied delay, and ``aligned`` is reconstructed from the int8 wire
    bytes (exactly what clients receive).
    """
    if cfg.lag_method not in ("phase_zoom", "auto"):
        raise ValueError(
            "fft_impl='fused' measures lag with the phase_zoom "
            f"estimator; set lag_method='phase_zoom' (got '{cfg.lag_method}')"
        )
    from coherent_rtlsdr_tpu.kernels.backend import get_spectral

    L = cfg.block_len
    N = cfg.n_channels
    sp = get_spectral(cfg, 2 * L)

    seq, gap, new_gaps, meas_ok = _seq_gap(state, seq, update_gate)

    # Offset removal (XOR 0x80) is the only pass over the bytes before the
    # window assembly; either logical input shape is accepted.
    raw_cur = u8_to_i8(sig_u8.reshape(N, L, 2))
    ref_cur = u8_to_i8(ref_u8.reshape(L, 2))
    raw = jnp.stack([state.hist, raw_cur])                # [2, N, L, 2]
    ref_raw = jnp.stack([state.ref_hist, ref_cur])        # [2, L, 2]

    est = sp.measure_i8(raw, ref_raw)
    lag, z, mag, papr = est.lag[0], est.z[0], est.mag[0], est.papr[0]
    zabs = jnp.abs(z)

    new_delay, new_synced = control_update(
        cfg, state.delay, state.synced, lag, mag, meas_ok
    )
    new_synced = new_synced & jnp.logical_not(gap)

    # pc_inst = conj(z)/|z| (phase_correction_estimate convention applied to
    # the Parseval inner product; csdrdevice.cc:58-69 analog).
    pc_inst = jnp.where(zabs > 0, jnp.conj(z) / jnp.where(zabs > 0, zabs, 1.0),
                        1.0 + 0j).astype(jnp.complex64)
    good = meas_ok & (mag >= cfg.min_corr_mag)
    old_phase = f2c(state.phase)
    ema = ema_complex(old_phase, pc_inst, alpha=cfg.phase_alpha)
    new_phase = jnp.where(good, ema, old_phase)

    wire = sp.apply_i8(est.spec, new_delay[None], new_phase[None])[0]
    # Reference channel: raw passthrough at the same pipeline latency
    # (cpacketizer.cc:137-156 — ref is never requantized, only re-signed).
    wire_ref = jnp.concatenate(
        [state.ref_hist[L // 2:], ref_cur[: L // 2]], axis=0
    ).reshape(2 * L)                                      # [2L] int8 flat

    # Wire-fidelity complex views (DCE'd by XLA when the caller only
    # consumes wire/wire_ref — the server/driver hot paths do).
    aligned = i8_iq_to_c64(wire.reshape(N, L, 2))
    out_ref = i8_iq_to_c64(wire_ref.reshape(L, 2))

    # Block RMS: mean(I^2+Q^2) over L samples = 2 * mean(byte^2) over the
    # 2L interleaved bytes.
    f = raw_cur.astype(jnp.float32)
    rms_val = jnp.sqrt(2.0 * jnp.mean(f * f, axis=(-2, -1))) * IQ_SCALE

    telemetry = Telemetry(
        lag=lag,
        residual=lag - new_delay,
        mag=mag,
        papr=papr,
        phase=c2f(new_phase),
        synced=new_synced,
        rms=rms_val,
        gap=gap,
        gaps=new_gaps,
    )
    new_state = PipelineState(
        delay=new_delay,
        phase=c2f(new_phase),
        lag=lag,
        mag=mag,
        papr=papr,
        synced=new_synced,
        hist=raw_cur,
        ref_hist=ref_cur,
        block_idx=state.block_idx + 1,
        last_seq=seq,
        gaps=new_gaps,
    )
    return new_state, BlockOutput(
        aligned=aligned, ref=out_ref, telemetry=telemetry,
        wire=wire, wire_ref=wire_ref,
    )


def make_step(cfg: PipelineConfig, donate: bool = True):
    """Jitted streaming step with the state buffer donated (the hist buffers
    are the large carry; donation keeps device memory traffic at one block
    in, one aligned block out)."""
    f = partial(step, cfg)
    return jax.jit(f, donate_argnums=(0,) if donate else ())
