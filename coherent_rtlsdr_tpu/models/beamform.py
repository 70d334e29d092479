"""Beamforming / DOA spectra on the aligned receive matrix.

Covers (and extends) the reference's downstream consumers:
  * MUSIC pseudospectrum — beamformclient/heatmap2d.cpp:61-147 (SVD noise
    subspace + steering scan) and matlabclient/functions/pmusic.m
  * Bartlett (delay-and-sum) — the BASELINE.json "delay-and-sum heatmap"
  * MVDR/Capon — not in the reference; standard addition

Shapes: X [N, T] snapshots, R [N, N] covariance, A [G, N] steering matrix.
All dense linear algebra — batched matmuls + one eigh. The complex64
matmuls run at full f32 precision (``HIGHEST``): a reduced-precision pass
(TF32 or bf16) would perturb the noise subspace MUSIC projects onto.
"""

from typing import Optional

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def sample_covariance(X: jnp.ndarray, subtract_mean: bool = True) -> jnp.ndarray:
    """R = X X^H / T, optionally mean-subtracted per channel
    (heatmap2d.cpp:61-69 subtracts the row mean before the outer product)."""
    if subtract_mean:
        X = X - jnp.mean(X, axis=-1, keepdims=True)
    T = X.shape[-1]
    return _mm(X, jnp.conj(X).T) / T


def _noise_subspace(R: jnp.ndarray, n_sources: int) -> jnp.ndarray:
    """Smallest-(N - n_sources) eigenvectors of Hermitian R.

    eigh returns ascending eigenvalues, so the noise subspace is the leading
    columns (heatmap2d.cpp uses an SVD; eigh of the Hermitian covariance is
    the cheaper equivalent).
    """
    _, vecs = jnp.linalg.eigh(R)
    n = R.shape[-1]
    return vecs[:, : n - n_sources]  # [N, N - K]


def music_spectrum(
    R: jnp.ndarray, A: jnp.ndarray, n_sources: int
) -> jnp.ndarray:
    """MUSIC pseudospectrum P[g] = (a^H a) / ||E_n^H a||^2."""
    En = _noise_subspace(R, n_sources)          # [N, M]
    proj = _mm(A, jnp.conj(En))                 # [G, M]
    denom = jnp.sum(jnp.abs(proj) ** 2, axis=-1)
    num = jnp.sum(jnp.abs(A) ** 2, axis=-1)
    return num / jnp.maximum(denom, 1e-12)


def bartlett_spectrum(R: jnp.ndarray, A: jnp.ndarray) -> jnp.ndarray:
    """Delay-and-sum power: P[g] = a^H R a, normalized by ||a||^2."""
    # a^H R a as a row-wise quadratic form: (A @ R.T)[g, n] = (R a_g)[n].
    q = jnp.sum(jnp.conj(A) * _mm(A, R.T), axis=-1)
    norm = jnp.sum(jnp.abs(A) ** 2, axis=-1)
    return jnp.real(q) / jnp.maximum(norm, 1e-12)


def mvdr_spectrum(
    R: jnp.ndarray, A: jnp.ndarray, diag_load: float = 1e-3
) -> jnp.ndarray:
    """Capon/MVDR: P[g] = 1 / (a^H R^-1 a), with diagonal loading."""
    N = R.shape[-1]
    tr = jnp.real(jnp.trace(R)) / N
    Rl = R + diag_load * tr * jnp.eye(N, dtype=R.dtype)
    Rinv_A = jnp.linalg.solve(Rl, A.T)                    # columns R^-1 a_g
    q = jnp.real(jnp.sum(jnp.conj(A.T) * Rinv_A, axis=0))  # a^H R^-1 a
    return 1.0 / jnp.maximum(q, 1e-12)


def esprit_doa(R, n_sources: int, d: float = 0.5):
    """LS-ESPRIT for a uniform linear array — GRIDLESS DOA, beyond the
    reference's grid-scan estimators (pmusic.m / heatmap2d scan a fixed
    (u, v) grid; ESPRIT reads the angles straight out of the rotational
    invariance between the two N-1-element subarrays).

    ``d`` is the element spacing in wavelengths; steering convention
    a(theta)_n = exp(+j 2 pi d n sin(theta)) (models/geometry.py).
    Returns sorted DOAs in radians. Host-side numpy: the final [K, K]
    non-Hermitian eigenvalue problem runs host-side, and like the
    reference's MATLAB functions this runs client-side on snapshots.
    """
    import numpy as np

    R = np.asarray(R)
    if not 0 < n_sources < R.shape[-1]:
        raise ValueError(f"n_sources must be in (0, N={R.shape[-1]})")
    _, vecs = np.linalg.eigh(R)
    Es = vecs[:, -n_sources:]                     # signal subspace [N, K]
    Psi, *_ = np.linalg.lstsq(Es[:-1], Es[1:], rcond=None)
    phi = np.angle(np.linalg.eigvals(Psi))
    return np.sort(np.arcsin(np.clip(phi / (2 * np.pi * d), -1.0, 1.0)))


def root_music_doa(R, n_sources: int, d: float = 0.5):
    """root-MUSIC for a uniform linear array — the gridless form of the
    MUSIC spectrum: the noise-subspace projector's diagonal-sum polynomial
    is rooted and the K roots nearest (inside) the unit circle give the
    DOAs. Same conventions/returns as :func:`esprit_doa`; host-side numpy
    (np.roots runs host-side)."""
    import numpy as np

    R = np.asarray(R)
    N = R.shape[0]
    if not 0 < n_sources < N:
        raise ValueError(f"n_sources must be in (0, N={N})")
    _, vecs = np.linalg.eigh(R)
    En = vecs[:, : N - n_sources]
    C = _mm(En, En.conj().T)
    coeffs = np.array([np.trace(C, offset=k) for k in range(N - 1, -N, -1)])
    roots = np.roots(coeffs)
    roots = roots[np.abs(roots) < 1.0]
    pick = roots[np.argsort(1.0 - np.abs(roots))[:n_sources]]
    phi = np.angle(pick)
    return np.sort(np.arcsin(np.clip(phi / (2 * np.pi * d), -1.0, 1.0)))


def music_heatmap(
    X: jnp.ndarray,
    positions: jnp.ndarray,
    n_sources: int,
    n_points: int = 100,
    extent: float = 1.0,
) -> jnp.ndarray:
    """End-to-end heatmap2d equivalent: snapshots -> [n_points, n_points]
    MUSIC surface over the (u, v) grid."""
    from coherent_rtlsdr_tpu.models.geometry import steering_vectors, uv_grid

    uv, _ = uv_grid(n_points, extent)
    A = steering_vectors(positions, uv)
    R = sample_covariance(X)
    P = music_spectrum(R, A, n_sources)
    return P.reshape(n_points, n_points)
