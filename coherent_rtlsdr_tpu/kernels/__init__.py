"""Spectral backends and the four-step matmul FFT.

``backend`` selects the pipeline's spectral engine (XLA FFT, four-step
matmul FFT, or the u8-native fused engine); ``fft4step`` reformulates the
2L-point FFT as two batched complex matmuls plus a twiddle (the classic
four-step/Bailey factorization), and ``permuted`` holds the companion ops
that consume its permuted-frequency layout directly.
"""

from coherent_rtlsdr_tpu.kernels.fft4step import (
    FFT4Step,
    supported_fft_len,
)

__all__ = ["FFT4Step", "supported_fft_len"]
