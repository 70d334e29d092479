"""Spectral backend selection: one interface over the XLA-FFT natural-order
path, the four-step matmul permuted path, and the u8-native fused engine,
so the pipeline code is written once (pipeline/step.py, pipeline/offline.py).

All backends implement the 3-op pipeline interface over STREAM BLOCKS
(the overlap-save window of output slot t is blocks (t, t+1)):

    ctx = sp.prepare(sig_blocks, ref_blocks)  # [T, N, L] / [T, L] complex
    est = sp.measure(ctx, method)             # LagEstimate over [T-1, N]
    y   = sp.correct(ctx, advance)            # aligned center half [T-1, N, L]

plus the lower-level fft/ifft/lag_estimate/apply_advance ops (used by
analysis code and the backends themselves). ``correct`` returns the
overlap-save center half ``y[..., W/4:3W/4]`` per window. The fused
backend adds the raw-byte pair ``measure_i8`` / ``apply_i8`` that the
'fused' step and offline engine run on.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from coherent_rtlsdr_tpu.kernels.fft4step import FFT4Step, supported_fft_len
from coherent_rtlsdr_tpu.kernels import permuted as perm
from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq, i8_iq_to_c64
from coherent_rtlsdr_tpu.ops.delay import apply_delay_phase_freq
from coherent_rtlsdr_tpu.ops.xcorr import (
    LagEstimate,
    lag_estimate_from_spectra,
    phase_zoom,
)

FFT_IMPLS = ("xla", "mxu", "fused", "auto")


def _vmap_leading(fn, ndim_core, *args):
    """vmap ``fn`` over any leading batch dims of args[0] beyond ndim_core."""
    extra = args[0].ndim - ndim_core
    f = fn
    for _ in range(extra):
        f = jax.vmap(f)
    return f(*args)


class _Ctx(NamedTuple):
    F_sig: jnp.ndarray   # [..., N, spectrum]
    F_ref: jnp.ndarray   # [..., spectrum]


class XlaSpectral:
    """Natural-order spectra via jnp.fft."""

    def __init__(self, fft_len: int):
        self.fft_len = fft_len

    def fft(self, x):
        return jnp.fft.fft(x, axis=-1)

    def ifft(self, S):
        return jnp.fft.ifft(S, axis=-1)

    def lag_estimate(self, S_sig, S_ref, method):
        return lag_estimate_from_spectra(S_sig, S_ref, method=method)

    def apply_advance(self, S, advance, phase):
        return apply_delay_phase_freq(S, advance, phase)

    # -- pipeline interface --------------------------------------------
    def prepare(self, sig_blocks, ref_blocks):
        w_sig = jnp.concatenate([sig_blocks[:-1], sig_blocks[1:]], axis=-1)
        w_ref = jnp.concatenate([ref_blocks[:-1], ref_blocks[1:]], axis=-1)
        return _Ctx(self.fft(w_sig), self.fft(w_ref))

    def measure(self, ctx, method):
        return _vmap_leading(
            lambda fs, fr: lag_estimate_from_spectra(fs, fr, method=method),
            2, ctx.F_sig, ctx.F_ref,
        )

    def correct(self, ctx, advance):
        W = self.fft_len
        y = self.ifft(self.apply_advance(
            ctx.F_sig, advance, jnp.ones((), jnp.complex64)))
        return y[..., W // 4: W // 4 + W // 2]


class MxuSpectral:
    """Permuted-layout spectra via the four-step matmul FFT."""

    def __init__(self, fft_len: int, precision: str = "bf16"):
        self._fft = FFT4Step(fft_len, precision=precision)
        self.fft_len = fft_len

    def fft(self, x):
        return self._fft.fft(x)

    def ifft(self, S):
        return self._fft.ifft(S)

    def lag_estimate(self, S_sig, S_ref, method):
        return perm.lag_estimate_permuted(self._fft, S_sig, S_ref, method=method)

    def apply_advance(self, S, advance, phase):
        # Broadcast over any leading block dims: advance [..., N] applies to
        # spectra [..., N, m, m].
        return perm.apply_delay_phase_permuted(self._fft, S, advance, phase)

    # -- pipeline interface --------------------------------------------
    def prepare(self, sig_blocks, ref_blocks):
        w_sig = jnp.concatenate([sig_blocks[:-1], sig_blocks[1:]], axis=-1)
        w_ref = jnp.concatenate([ref_blocks[:-1], ref_blocks[1:]], axis=-1)
        return _Ctx(self.fft(w_sig), self.fft(w_ref))

    def measure(self, ctx, method):
        return _vmap_leading(
            lambda fs, fr: perm.lag_estimate_permuted(
                self._fft, fs, fr, method=method),
            3, ctx.F_sig, ctx.F_ref,
        )

    def correct(self, ctx, advance):
        W = self.fft_len
        y = self.ifft(self.apply_advance(
            ctx.F_sig, advance, jnp.ones((), jnp.complex64)))
        return y[..., W // 4: W // 4 + W // 2]


class I8Measure(NamedTuple):
    """``FusedSpectral.measure_i8`` result, each ``[T-1, N]`` except spec."""

    lag: jnp.ndarray    # fractional lag (phase_zoom)
    z: jnp.ndarray      # c64 correlation value at that lag (Parseval)
    mag: jnp.ndarray    # |z| / sqrt(E_sig * E_ref)
    papr: jnp.ndarray   # |z|^2 / sum|G|^2
    spec: jnp.ndarray   # [T-1, N, W] c64 window spectra, reused by apply_i8


def _i8_windows(raw: jnp.ndarray) -> jnp.ndarray:
    """Signed int8 IQ blocks ``[T, ..., L, 2]`` (or flat ``[T, ..., 2L]``)
    -> overlap-save windows ``[T-1, ..., 2L]`` complex64 (window t = blocks
    (t, t+1)); the dequant fuses into the window assembly."""
    x = i8_iq_to_c64(raw.reshape(*raw.shape[:-1], -1, 2)
                     if raw.shape[-1] != 2 else raw)
    return jnp.concatenate([x[:-1], x[1:]], axis=-1)


class FusedSpectral(XlaSpectral):
    """The u8-native engine (fft_impl='fused'): signed int8 capture bytes
    in, int8 wire bytes out, with ONE window spectrum per channel shared by
    measurement and correction.

    ``measure_i8`` dequantizes, transforms the signal and reference windows
    and runs the IFFT-free phase_zoom estimator (ops/xcorr.py); it also
    returns the complex correlation value z, whose argument is the
    channel's phase-correction estimate, and the window spectra.
    ``apply_i8`` ramps those spectra by the applied advance and phase,
    inverse-transforms, keeps the overlap-save center half and requantizes
    to the int8 wire format (cpacketizer.cc:158-172 analog).

    The generic ``prepare/measure/correct`` interface is the XLA backend's
    with the lag estimator fixed to phase_zoom.
    """

    def measure(self, ctx, method):
        if method not in ("phase_zoom", "auto"):
            raise ValueError(
                "fft_impl='fused' measures lag with the phase_zoom "
                f"estimator; set lag_method='phase_zoom' (got '{method}')"
            )
        return super().measure(ctx, "phase_zoom")

    def measure_i8(self, raw: jnp.ndarray, ref_raw: jnp.ndarray) -> I8Measure:
        """raw ``[T, N, L, 2]`` int8 blocks; ref_raw ``[T, L, 2]`` int8
        (flat ``[.., 2L]`` accepted). Returns T-1 windows."""
        D = self.fft(_i8_windows(raw))         # [T-1, N, W]
        R = self.fft(_i8_windows(ref_raw))     # [T-1, W]
        lag, z, e_g = phase_zoom(D * jnp.conj(R)[:, None, :])
        e_sig = jnp.sum(jnp.real(D) ** 2 + jnp.imag(D) ** 2, axis=-1)
        e_ref = jnp.sum(jnp.real(R) ** 2 + jnp.imag(R) ** 2, axis=-1)
        zabs = jnp.abs(z)
        denom = jnp.sqrt(e_sig * e_ref[:, None])
        mag = zabs / jnp.where(denom > 0, denom, 1.0)
        papr = zabs * zabs / jnp.where(e_g > 0, e_g, 1.0)
        return I8Measure(lag=lag, z=z, mag=mag, papr=papr, spec=D)

    def apply_i8(self, spec: jnp.ndarray, advance: jnp.ndarray,
                 phase: jnp.ndarray) -> jnp.ndarray:
        """spec ``[T-1, N, W]`` from measure_i8; advance ``[T-1, N]`` f32;
        phase ``[T-1, N]`` unit complex. Returns the corrected overlap-save
        center half as FLAT interleaved int8 wire bytes ``[T-1, N, W]``
        (W = 2L bytes = L IQ samples)."""
        W = self.fft_len
        y = self.ifft(apply_delay_phase_freq(spec, advance, phase))
        wire = c64_to_i8_iq(y[..., W // 4: W // 4 + W // 2])
        return wire.reshape(*wire.shape[:-2], W)


def get_spectral(cfg, fft_len: int):
    """Pick the backend from PipelineConfig.fft_impl ('xla' | 'mxu' |
    'fused' | 'auto'). 'auto' is the XLA backend (cuFFT on the GPU)."""
    impl = getattr(cfg, "fft_impl", "xla")
    if impl not in FFT_IMPLS:
        raise ValueError(
            f"unknown fft_impl '{impl}'; expected one of {FFT_IMPLS}"
        )
    if impl in ("xla", "auto"):
        return XlaSpectral(fft_len)
    if not supported_fft_len(fft_len):
        raise ValueError(
            f"fft_impl='{impl}' needs a square fft_len in "
            f"{{4096, 16384, 65536}}, got {fft_len}"
        )
    if impl == "fused":
        return FusedSpectral(fft_len)
    return MxuSpectral(fft_len, precision=getattr(cfg, "mxu_precision", "bf16"))
