"""Offline (capture-at-rest) alignment: the measure -> smooth -> apply engine.

The reference can only process a capture the way the hardware produced it:
sequentially, one block at a time, with feedback converging over seconds.
Offline, the sequential dependence is an artifact — only the *smoother* is a
recurrence, and it is linear. So:

  Phase A (parallel over T x N): window FFTs, lag + quality measurement.
  Phase B (tiny): smooth the measurement tracks —
            "global":  quality-weighted average (constant true delays — the
                       shared-clock case, README.md:40);
            "ema":     the streaming EMA control law, computed exactly via
                       ``jax.lax.associative_scan`` (a linear recurrence),
                       bit-matching what the streaming step would converge to;
  Phase C (parallel over T x N): fractional advance + phase, overlap-save.

Phases A and C are embarrassingly parallel over (time-blocks x channels) —
exactly the mesh axes the sharded runner splits (parallel/sharded.py).
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from coherent_rtlsdr_tpu.kernels.backend import FusedSpectral, get_spectral
from coherent_rtlsdr_tpu.ops.convert import i8_iq_to_c64, u8_to_c64, u8_to_i8
from coherent_rtlsdr_tpu.ops.phase import phase_correction_estimate
from coherent_rtlsdr_tpu.pipeline.state import PipelineConfig


class OfflineResult(NamedTuple):
    aligned: jnp.ndarray   # [T-1, N, L] corrected receive matrix blocks
    ref: jnp.ndarray       # [T-1, L] reference channel at the same latency
    lag: jnp.ndarray       # [T-1, N] raw per-block lag measurements
    delay: jnp.ndarray     # [T-1, N] smoothed applied advance
    mag: jnp.ndarray       # [T-1, N]
    papr: jnp.ndarray      # [T-1, N]
    phase: jnp.ndarray     # [T-1, N] c64 applied phase factors
    # fft_impl='fused' i8-native extras: the int8 wire frames straight from
    # apply_i8 (aligned/ref are then wire-fidelity reconstructions).
    wire: Optional[jnp.ndarray] = None      # [T-1, N, 2L] int8 flat bytes
    wire_ref: Optional[jnp.ndarray] = None  # [T-1, 2L] int8 flat bytes


def _ema_scan(x: jnp.ndarray, alpha: float, w: jnp.ndarray) -> jnp.ndarray:
    """Gated EMA along axis 0 as an associative scan.

    y_t = (1 - a_t) y_{t-1} + a_t x_t with a_t = alpha * w_t (w in [0,1]).
    Associative combine on (A, B) pairs representing y -> A*y + B.
    """
    a = alpha * w
    A = 1.0 - a
    B = a * x

    def combine(left, right):
        A1, B1 = left
        A2, B2 = right
        return A1 * A2, A2 * B1 + B2

    _, y = jax.lax.associative_scan(combine, (A, B), axis=0)
    return y


def measure_blocks(cfg: PipelineConfig, sp, ctx):
    """Phase A measurement on the prepared windows (backend-dependent
    spectra). Returns (lag, mag, papr) each [T', N]."""
    est = sp.measure(ctx, cfg.lag_method)
    return est.lag, est.mag, est.papr


def smooth_delays(
    cfg: PipelineConfig,
    lag: jnp.ndarray,   # [T', N]
    mag: jnp.ndarray,   # [T', N]
    smoothing: str,
) -> jnp.ndarray:
    """Phase B: turn raw lag measurements into applied advances [T', N]."""
    w = (mag >= cfg.min_corr_mag).astype(jnp.float32)
    if smoothing == "global":
        q = w * mag * mag
        num = jnp.sum(q * lag, axis=0)
        den = jnp.sum(q, axis=0)
        d = num / jnp.where(den > 0, den, 1.0)
        return jnp.broadcast_to(d[None, :], lag.shape)
    elif smoothing == "ema":
        return _ema_scan(lag, cfg.ctrl_gain, w)
    else:
        raise ValueError(f"unknown smoothing: {smoothing}")


def apply_corrections(
    cfg: PipelineConfig,
    sp,
    ctx,                  # prepared windows (sp.prepare result)
    w_ref: jnp.ndarray,   # [T', W] time-domain reference windows
    delay: jnp.ndarray,   # [T', N]
    mag: jnp.ndarray,     # [T', N]
    smoothing: str,
    phase_alpha: Optional[float] = None,
):
    """Phase C: fractional advance + phase correction, overlap-save slicing."""
    L = cfg.block_len
    out_raw = sp.correct(ctx, delay)                   # [T', N, L]
    out_ref = w_ref[..., L // 2 : L // 2 + L]          # [T', L]

    pc_inst = jax.vmap(phase_correction_estimate)(out_raw, out_ref)  # [T', N]
    wgt = (mag >= cfg.min_corr_mag).astype(jnp.float32)
    if smoothing == "global":
        z = jnp.sum(pc_inst * wgt, axis=0)
        zmag = jnp.abs(z)
        pc = jnp.where(zmag > 0, z / jnp.where(zmag > 0, zmag, 1.0), 1.0 + 0j)
        pc = jnp.broadcast_to(pc[None, :], pc_inst.shape).astype(jnp.complex64)
    else:
        alpha = phase_alpha if phase_alpha is not None else cfg.phase_alpha
        z = _ema_scan(pc_inst, alpha, wgt.astype(jnp.complex64))
        zmag = jnp.abs(z)
        pc = (z / jnp.where(zmag > 0, zmag, 1.0)).astype(jnp.complex64)

    aligned = out_raw * pc[..., None]
    return aligned, out_ref, pc


def _smooth_phases(
    cfg: PipelineConfig,
    pc_inst: jnp.ndarray,  # [T', N] c64 instantaneous estimates
    mag: jnp.ndarray,      # [T', N]
    smoothing: str,
    phase_alpha: Optional[float] = None,
) -> jnp.ndarray:
    """Quality-gated phase smoothing (shared by the generic and i8-native
    offline paths; mirrors the streaming EMA / reference csdrdevice.cc:66)."""
    wgt = (mag >= cfg.min_corr_mag).astype(jnp.float32)
    if smoothing == "global":
        z = jnp.sum(pc_inst * wgt, axis=0)
        zmag = jnp.abs(z)
        pc = jnp.where(zmag > 0, z / jnp.where(zmag > 0, zmag, 1.0), 1.0 + 0j)
        return jnp.broadcast_to(pc[None, :], pc_inst.shape).astype(jnp.complex64)
    alpha = phase_alpha if phase_alpha is not None else cfg.phase_alpha
    z = _ema_scan(pc_inst, alpha, wgt.astype(jnp.complex64))
    zmag = jnp.abs(z)
    return (z / jnp.where(zmag > 0, zmag, 1.0)).astype(jnp.complex64)


def _align_offline_fused_i8(
    cfg: PipelineConfig,
    sp: FusedSpectral,
    sig_u8: jnp.ndarray,  # [T, N, L, 2] uint8 (or flat [T, N, 2L])
    ref_u8: jnp.ndarray,  # [T, L, 2] uint8 (or flat [T, 2L])
    smoothing: str,
) -> OfflineResult:
    """The i8-native offline engine: the same measure -> smooth -> apply
    phases on raw bytes (FusedSpectral.measure_i8 / apply_i8), one window
    spectrum shared by phases A and C. The phase estimate is arg(z) from
    the measurement (Parseval inner product at the measured lag; see
    pipeline/step.py:_step_fused_u8), and ``aligned`` is the int8 wire
    reconstruction — what clients receive."""
    T, N = sig_u8.shape[:2]
    L = cfg.block_len
    raw = u8_to_i8(sig_u8.reshape(T, N, L, 2))
    ref_raw = u8_to_i8(ref_u8.reshape(T, L, 2))

    est = sp.measure_i8(raw, ref_raw)
    zabs = jnp.abs(est.z)

    delay = smooth_delays(cfg, est.lag, est.mag, smoothing)
    delay = jnp.clip(delay, -cfg.max_delay, cfg.max_delay)

    pc_inst = jnp.where(
        zabs > 0, jnp.conj(est.z) / jnp.where(zabs > 0, zabs, 1.0), 1.0 + 0j
    ).astype(jnp.complex64)
    pc = _smooth_phases(cfg, pc_inst, est.mag, smoothing)

    wire = sp.apply_i8(est.spec, delay, pc)              # [T-1, N, 2L] flat
    wire_ref = jnp.concatenate(
        [ref_raw[:-1, L // 2:], ref_raw[1:, : L // 2]], axis=1
    ).reshape(T - 1, 2 * L)                              # [T-1, 2L] flat
    return OfflineResult(
        aligned=i8_iq_to_c64(wire.reshape(T - 1, N, L, 2)),
        ref=i8_iq_to_c64(wire_ref.reshape(T - 1, L, 2)),
        lag=est.lag, delay=delay, mag=est.mag, papr=est.papr, phase=pc,
        wire=wire, wire_ref=wire_ref,
    )


def align_offline(
    cfg: PipelineConfig,
    sig_u8: jnp.ndarray,  # [T, N, L, 2] uint8
    ref_u8: jnp.ndarray,  # [T, L, 2] uint8
    smoothing: str = "global",
) -> OfflineResult:
    """Align a whole capture. Returns T-1 output blocks (block 0 seeds the
    overlap-save history, like the streaming step's first block)."""
    sp = get_spectral(cfg, 2 * cfg.block_len)
    if isinstance(sp, FusedSpectral):
        return _align_offline_fused_i8(cfg, sp, sig_u8, ref_u8, smoothing)

    sig = u8_to_c64(sig_u8)  # [T, N, L]
    ref = u8_to_c64(ref_u8)  # [T, L]

    # The backend assembles the streaming windows w[t] = blocks (t, t+1)
    # itself; w_ref is only needed here for the output/phase-reference
    # slices.
    w_ref = jnp.concatenate([ref[:-1], ref[1:]], axis=-1)  # [T-1, 2L]
    ctx = sp.prepare(sig, ref)

    lag, mag, papr = measure_blocks(cfg, sp, ctx)
    delay = smooth_delays(cfg, lag, mag, smoothing)
    delay = jnp.clip(delay, -cfg.max_delay, cfg.max_delay)
    aligned, out_ref, pc = apply_corrections(
        cfg, sp, ctx, w_ref, delay, mag, smoothing
    )
    return OfflineResult(
        aligned=aligned, ref=out_ref, lag=lag, delay=delay, mag=mag, papr=papr,
        phase=pc,
    )
