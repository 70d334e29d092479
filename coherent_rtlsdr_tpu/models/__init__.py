"""Array-processing models: the downstream science the aligned receive
matrix feeds (reference: beamformclient/heatmap2d*.cpp MUSIC clients and
matlabclient/functions/pmusic.m + co-array processing).

All plain JAX: covariance, eigendecompositions, and steering-matrix
products are batched matmuls.
"""

from coherent_rtlsdr_tpu.models.geometry import (
    ula_positions,
    ura_positions,
    steering_vectors,
    uv_grid,
)
from coherent_rtlsdr_tpu.models.beamform import (
    sample_covariance,
    music_spectrum,
    bartlett_spectrum,
    mvdr_spectrum,
    music_heatmap,
    esprit_doa,
    root_music_doa,
)
from coherent_rtlsdr_tpu.models.coarray import (
    difference_coarray,
    augmented_covariance,
    coarray_music_spectrum,
    virtual_ura,
)

__all__ = [
    "ula_positions",
    "ura_positions",
    "steering_vectors",
    "uv_grid",
    "sample_covariance",
    "music_spectrum",
    "bartlett_spectrum",
    "mvdr_spectrum",
    "music_heatmap",
    "difference_coarray",
    "augmented_covariance",
    "coarray_music_spectrum",
    "virtual_ura",
]
