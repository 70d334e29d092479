"""Four-step (Bailey) FFT as matmuls, with a transpose-free permuted
frequency layout.

For W = m*m (m = 64/128/256), the W-point DFT factors as

    A[n2, n1] = x[n1 + m*n2]            (plain row-major reshape)
    B         = F_m @ A                  (DFT over n2 — batched m x m matmul)
    C         = B * T,  T[k2, n1] = exp(-2*pi*i*k2*n1/W)
    D         = C @ F_m                  (DFT over n1)
    X[k2 + m*k1] = D[k2, k1]

The canonical algorithm transposes D to get natural frequency order; we
never do — every consumer (cross-spectrum products, delay ramps, band-summed
phase slope, energy sums) is algebraically re-indexed to the ``(k2, k1)``
layout instead (kernels/permuted.py), and the inverse transform maps the
permuted layout straight back to natural time order:

    C = D @ conj(F_m)/m;  B = C * conj(T);  A = conj(F_m)/m @ B;  x = A.flat

The transform runs as matrix products (the 'mxu' backend), which trade a
~28x larger FLOP count for matrix-unit throughput, and skipping both
transposes saves two full memory round-trips per transform. In bf16 (f32
accumulation) the roundoff is ~3e-3 relative — below the int8 wire
quantization step (1/127) and vanishing in the phase-slope estimator's
16K-bin averaging. 'f32' runs the products at full f32 precision
(``lax.Precision.HIGHEST``, never a reduced-precision TF32 or bf16 pass).
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def supported_fft_len(fft_len: int) -> bool:
    m = int(round(np.sqrt(fft_len)))
    return m * m == fft_len and m in (64, 128, 256)


def _dft_matrix(m: int) -> Tuple[np.ndarray, np.ndarray]:
    n = np.arange(m)
    w = np.exp(-2j * np.pi * np.outer(n, n) / m)  # float64 for exact tables
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def _twiddle(m: int) -> Tuple[np.ndarray, np.ndarray]:
    W = m * m
    k2 = np.arange(m)[:, None]
    n1 = np.arange(m)[None, :]
    t = np.exp(-2j * np.pi * (k2 * n1) / W)
    return t.real.astype(np.float32), t.imag.astype(np.float32)


class FFT4Step:
    """Stateless transform pair for one ``fft_len``; safe to build at trace
    time (tables become compile-time constants)."""

    def __init__(self, fft_len: int, precision: str = "bf16"):
        m = int(round(np.sqrt(fft_len)))
        if m * m != fft_len:
            raise ValueError(f"fft_len {fft_len} is not a square")
        self.fft_len = fft_len
        self.m = m
        if precision not in ("bf16", "f32"):
            raise ValueError(f"precision must be 'bf16' or 'f32', got {precision!r}")
        self.precision = precision
        fre, fim = _dft_matrix(m)
        tre, tim = _twiddle(m)
        self._F = (jnp.asarray(fre), jnp.asarray(fim))
        self._T = jnp.asarray(tre) + 1j * jnp.asarray(tim)

    # -- complex matmuls as 4 real matmuls -------------------------------

    def _mm_dtype(self):
        return jnp.bfloat16 if self.precision == "bf16" else jnp.float32

    def _mm_precision(self):
        # bf16 operands take the default (bf16 with f32 accumulation); f32
        # operands must not drop to TF32 or bf16 passes.
        if self.precision == "bf16":
            return jax.lax.Precision.DEFAULT
        return jax.lax.Precision.HIGHEST

    def _left(self, Fre, Fim, a: jnp.ndarray) -> jnp.ndarray:
        """(Fre + i Fim) @ a over the second-to-last axis of a."""
        d = self._mm_dtype()
        are = jnp.real(a).astype(d)
        aim = jnp.imag(a).astype(d)
        fre = Fre.astype(d)
        fim = Fim.astype(d)
        mm = partial(jnp.einsum, "kn,...nm->...km", precision=self._mm_precision(),
                     preferred_element_type=jnp.float32)
        bre = mm(fre, are) - mm(fim, aim)
        bim = mm(fre, aim) + mm(fim, are)
        return (bre + 1j * bim).astype(jnp.complex64)

    def _right(self, a: jnp.ndarray, Fre, Fim) -> jnp.ndarray:
        """a @ (Fre + i Fim) over the last axis of a."""
        d = self._mm_dtype()
        are = jnp.real(a).astype(d)
        aim = jnp.imag(a).astype(d)
        fre = Fre.astype(d)
        fim = Fim.astype(d)
        mm = partial(jnp.einsum, "...kn,nj->...kj", precision=self._mm_precision(),
                     preferred_element_type=jnp.float32)
        bre = mm(are, fre) - mm(aim, fim)
        bim = mm(are, fim) + mm(aim, fre)
        return (bre + 1j * bim).astype(jnp.complex64)

    # -- transforms ------------------------------------------------------

    def fft(self, x: jnp.ndarray) -> jnp.ndarray:
        """x ``[..., W]`` complex -> permuted spectrum ``[..., m(k2), m(k1)]``
        where natural bin index is ``k = k2 + m*k1``."""
        m = self.m
        A = x.reshape(*x.shape[:-1], m, m)  # [n2, n1]
        Fre, Fim = self._F
        B = self._left(Fre, Fim, A)
        C = B * self._T
        return self._right(C, Fre, Fim)

    def ifft(self, Xp: jnp.ndarray) -> jnp.ndarray:
        """Permuted spectrum ``[..., m, m]`` -> natural-order time ``[..., W]``."""
        m = self.m
        Fre, Fim = self._F
        inv = 1.0 / m
        C = self._right(Xp, Fre * inv, -Fim * inv)
        B = C * jnp.conj(self._T)
        A = self._left(Fre * inv, -Fim * inv, B)
        return A.reshape(*Xp.shape[:-2], m * m)

    # -- layout helpers --------------------------------------------------

    def freq_index_grid(self) -> jnp.ndarray:
        """int32 ``[m, m]``: natural bin index k = k2 + m*k1 at (k2, k1)."""
        m = self.m
        k2 = jnp.arange(m, dtype=jnp.int32)[:, None]
        k1 = jnp.arange(m, dtype=jnp.int32)[None, :]
        return k2 + m * k1

    def signed_freq_grid(self) -> jnp.ndarray:
        """f32 ``[m, m]``: signed frequency (cycles/sample) per position."""
        W = self.fft_len
        k = self.freq_index_grid()
        return jnp.where(k < W // 2, k, k - W).astype(jnp.float32) / W
