"""Array geometries and steering vectors.

Conventions follow the reference's MATLAB analysis stack
(matlabclient/functions/pmusic.m, measurement_script.m): planar arrays in
units of wavelengths, direction cosines (u, v) = (sin az cos el-style
direction cosines) scanned over [-1, 1]^2 — the +-90 x +-90 degree grid of
pmusic.m:19-25 and heatmap2d.cpp:106-147.
"""

from typing import Tuple

import jax.numpy as jnp
import numpy as np


def ula_positions(n: int, spacing: float = 0.5) -> np.ndarray:
    """Uniform linear array on the x axis; spacing in wavelengths."""
    pos = np.zeros((n, 2), np.float32)
    pos[:, 0] = np.arange(n) * spacing
    return pos


def ura_positions(rows: int, cols: int, spacing: float = 0.5) -> np.ndarray:
    """Uniform rectangular array (e.g. the 7x3 URA of the published
    measurements, measurement_script.m:3-23); returns [rows*cols, 2]."""
    x, y = np.meshgrid(np.arange(cols), np.arange(rows))
    return np.stack(
        [x.ravel() * spacing, y.ravel() * spacing], axis=-1
    ).astype(np.float32)


def uv_grid(n_points: int = 100, extent: float = 1.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Direction-cosine scan grid: [G, 2] flattened (u, v) plus the 1-D axis
    (for plotting). G = n_points^2 — heatmap2d's 100x100 scan."""
    ax = jnp.linspace(-extent, extent, n_points)
    u, v = jnp.meshgrid(ax, ax, indexing="xy")
    return jnp.stack([u.ravel(), v.ravel()], axis=-1), ax


def steering_vectors(positions: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Far-field plane-wave steering matrix.

    positions: [N, 2] wavelengths; uv: [G, 2] direction cosines.
    Returns [G, N] complex64: a_g[n] = exp(+2*pi*i * p_n . uv_g)
    (heatmap2d.cpp:106-147 steering-vector scan).
    """
    phase = 2.0 * jnp.pi * jnp.matmul(
        uv, jnp.asarray(positions).T, precision="highest")  # [G, N]
    return jnp.exp(1j * phase).astype(jnp.complex64)


def nearfield_steering_vectors(
    positions: jnp.ndarray, xyz: jnp.ndarray
) -> jnp.ndarray:
    """Near-field (spherical wavefront) steering for source points ``xyz``
    [G, 3] in wavelengths (the VTC'21 near-field localization setting,
    README.md:48-50): exact per-element path delays."""
    p = jnp.asarray(positions)
    p3 = jnp.concatenate([p, jnp.zeros((p.shape[0], 1), p.dtype)], axis=-1)
    d = jnp.linalg.norm(xyz[:, None, :] - p3[None, :, :], axis=-1)  # [G, N]
    d = d - d[:, :1]  # relative to element 0
    return jnp.exp(-2j * jnp.pi * d).astype(jnp.complex64)
