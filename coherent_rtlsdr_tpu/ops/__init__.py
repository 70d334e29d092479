"""Pure-JAX DSP ops: the definition of numerical behavior that every
spectral backend in ``coherent_rtlsdr_tpu.kernels`` is tested against."""

from coherent_rtlsdr_tpu.ops.convert import (
    u8_to_c64,
    u8_to_i8,
    c64_to_i8_iq,
    i8_iq_to_c64,
)
from coherent_rtlsdr_tpu.ops.xcorr import (
    xcorr_circular,
    lag_estimate,
    lag_estimate_batched,
    parabolic_peak_offset,
)
from coherent_rtlsdr_tpu.ops.delay import (
    delay_ramp,
    apply_delay_phase_freq,
    overlap_save_advance,
    farrow_fractional_delay,
)
from coherent_rtlsdr_tpu.ops.phase import (
    phase_correction_estimate,
    ema_complex,
)
from coherent_rtlsdr_tpu.ops.spectral import (
    rms,
    magsquared,
    crest_factor,
    papr,
    conj_dot,
)

__all__ = [
    "u8_to_c64",
    "u8_to_i8",
    "c64_to_i8_iq",
    "i8_iq_to_c64",
    "xcorr_circular",
    "lag_estimate",
    "lag_estimate_batched",
    "parabolic_peak_offset",
    "delay_ramp",
    "apply_delay_phase_freq",
    "overlap_save_advance",
    "farrow_fractional_delay",
    "phase_correction_estimate",
    "ema_complex",
    "rms",
    "magsquared",
    "crest_factor",
    "papr",
    "conj_dot",
]
