"""Fractional-delay correction ops.

The reference cannot correct timing numerically: it skews each dongle's
*hardware* resampler off-frequency for a computed dwell time so the stream
"eats" the lag (ccontrol.cc:78-123), then waits for re-estimation. Here the
stream is data, so correction is exact and immediate:

  * frequency-domain fractional advance (phase ramp on the block spectrum)
    with overlap-save windowing — the default path, which reuses the FFTs the
    lag estimator already needs;
  * a 4-tap cubic-Lagrange Farrow interpolator (time domain) — the structure
    prototyped in the reference's matlabclient/notes.m, useful for
    per-sample-varying delay (clock-skew tracking) and halo-exchange
    time-sharding where a short FIR tail is the halo.

Sign convention matches ops.xcorr: a channel measured at lag d (delayed by d)
is corrected by *advancing* it d samples.
"""

from typing import Tuple

import jax.numpy as jnp


def _integer_delay_ramp_phase(fft_len: int, d_int: jnp.ndarray) -> jnp.ndarray:
    """Exact phase fraction ``(k * d) mod W / W`` for integer delays.

    Computing ``f32(k/W) * d`` directly loses ~eps*|d| cycles of phase (at
    d ~ 2000 samples that is 1e-3 rad — enough to break sub-millisample
    alignment), so the modular reduction is done in exact int32 arithmetic.
    ``d`` is split into bytes so every product stays below 2^25 for
    W <= 2^17.
    """
    W = fft_len
    k = jnp.arange(W, dtype=jnp.int32)
    dm = jnp.mod(d_int.astype(jnp.int32), W)[..., None]  # [..., 1]
    d0 = dm % 256
    d1 = dm // 256
    r0 = (k * d0) % W
    r1 = (((k * 256) % W) * d1) % W
    return ((r0 + r1) % W).astype(jnp.float32) / W


def delay_ramp(fft_len: int, delay: jnp.ndarray, dtype=jnp.complex64) -> jnp.ndarray:
    """Spectrum multiplier implementing ``x[n] -> x[n - delay]``.

    ``delay`` may be batched ``[...]``; returns ``[..., fft_len]``. Uses signed
    FFT frequencies so fractional delays interpolate symmetrically (complex
    baseband IQ). The integer part of the delay is reduced with exact modular
    arithmetic; only the sub-sample part multiplies frequencies in f32, so
    phase error stays ~1e-7 cycles regardless of delay magnitude.
    """
    if fft_len & (fft_len - 1):
        raise ValueError("delay_ramp requires a power-of-two fft_len")
    d = jnp.asarray(delay, jnp.float32)
    d_int = jnp.floor(d)
    d_frac = (d - d_int)[..., None]  # in [0, 1)
    f = jnp.fft.fftfreq(fft_len).astype(jnp.float32)  # signed, exact dyadics
    phase = _integer_delay_ramp_phase(fft_len, d_int) + f * d_frac
    return jnp.exp(-2j * jnp.pi * phase).astype(dtype)


def apply_delay_phase_freq(
    F: jnp.ndarray, advance: jnp.ndarray, phase: jnp.ndarray
) -> jnp.ndarray:
    """Apply a fractional *advance* and a complex phase factor in frequency
    domain. F: ``[..., W]`` spectra; advance: ``[...]`` samples; phase:
    ``[...]`` unit-modulus complex (the reference's phasecorr factor,
    csdrdevice.cc:80-84)."""
    W = F.shape[-1]
    ramp = delay_ramp(W, -jnp.asarray(advance, jnp.float32), dtype=F.dtype)
    return F * ramp * jnp.asarray(phase)[..., None]


def overlap_save_advance(
    hist: jnp.ndarray,
    cur: jnp.ndarray,
    advance: jnp.ndarray,
    phase: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming fractional advance with overlap-save.

    hist, cur: ``[..., L]`` (previous and current block); advance: ``[...]``
    in samples, valid for ``|advance| <= L/2``; phase: ``[...]`` complex.

    Returns ``(new_hist, out)`` where ``out[n]`` is the corrected sample at
    absolute stream time ``t0 - L/2 + n`` (t0 = first sample of ``cur``):
    a fixed pipeline latency of L/2 samples buys a +/- L/2 correction range
    with overlap-save margins on both sides, replacing the reference's
    multi-block hardware slewing (ccontrol.cc:99-116) with a one-shot exact
    correction.
    """
    L = cur.shape[-1]
    w = jnp.concatenate([hist, cur], axis=-1)  # [..., 2L]
    F = jnp.fft.fft(w, axis=-1)
    y = jnp.fft.ifft(apply_delay_phase_freq(F, advance, phase), axis=-1)
    out = y[..., L // 2 : L // 2 + L]
    return cur, out.astype(w.dtype)


# --- Farrow cubic-Lagrange interpolator -----------------------------------

def _farrow_coeffs(mu: jnp.ndarray):
    """Cubic Lagrange basis at evaluation point ``mu`` in [0, 1) between taps
    x[n] and x[n+1], using taps x[n-1], x[n], x[n+1], x[n+2]."""
    m = jnp.asarray(mu, jnp.float32)
    c_m1 = -m * (m - 1.0) * (m - 2.0) / 6.0
    c_0 = (m + 1.0) * (m - 1.0) * (m - 2.0) / 2.0
    c_p1 = -(m + 1.0) * m * (m - 2.0) / 2.0
    c_p2 = (m + 1.0) * m * (m - 1.0) / 6.0
    return c_m1, c_0, c_p1, c_p2


def farrow_fractional_delay(x: jnp.ndarray, advance: jnp.ndarray) -> jnp.ndarray:
    """Evaluate ``x(n + advance)`` with a 4-tap cubic-Lagrange Farrow FIR.

    x: ``[..., T]``; advance: scalar, ``[...]`` (per-batch constant), or
    ``[..., T]`` / ``[T]`` (per-sample, for clock-skew tracking). Boundary
    samples wrap circularly, so callers must keep ``ceil(|advance|) + 2``
    samples of margin (this is exactly the halo a time-shard exchanges).
    """
    T = x.shape[-1]
    a = jnp.asarray(advance, jnp.float32)
    if a.ndim == x.ndim - 1 and a.ndim > 0:
        a = a[..., None]  # per-batch constant -> broadcast over time
    pos = jnp.arange(T, dtype=jnp.float32) + a          # [..., T] after bcast
    n0 = jnp.floor(pos)
    mu = pos - n0                                        # in [0, 1)
    n0 = n0.astype(jnp.int32)

    pos_b = jnp.broadcast_to(n0, x.shape)
    taps = []
    for k in (-1, 0, 1, 2):
        idx = (pos_b + k) % T
        taps.append(jnp.take_along_axis(x, idx, axis=-1))
    xm1, x0, xp1, xp2 = taps

    mu_b = jnp.broadcast_to(mu, x.shape)
    c_m1, c_0, c_p1, c_p2 = _farrow_coeffs(mu_b)
    return (
        xm1 * c_m1.astype(x.dtype)
        + x0 * c_0.astype(x.dtype)
        + xp1 * c_p1.astype(x.dtype)
        + xp2 * c_p2.astype(x.dtype)
    )
