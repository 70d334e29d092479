"""coherent_rtlsdr_tpu — a phase-coherent multichannel SDR framework in JAX.

A JAX/XLA implementation of the capabilities of the reference
C++ system ``mlaaks/coherent-rtlsdr`` (surveyed in SURVEY.md): coherent
alignment of N software-defined-radio channels against a shared reference-noise
channel — batched-FFT cross-correlation lag estimation, fractional-delay and
phase correction, and publication of the aligned N x L complex receive matrix
on the reference's exact ZMQ wire format.

Design stance (not a port):
  * The reference's thread-per-device + mutex/condvar dataflow becomes a pure
    function ``step(state, block) -> (state, aligned, telemetry)`` jitted and
    sharded over a ``(channel, time)`` device mesh.
  * The reference's hardware-resampler feedback (ccontrol.cc) becomes a
    numerical fractional-delay correction (frequency-domain overlap-save /
    Farrow FIR) driven by the same tanh-damped control law.
  * The offline path is a three-phase parallel pipeline: measure (parallel over
    time x channel), smooth (associative scan — the EMA control loop is a
    linear recurrence), apply (parallel with overlap-save halo exchange).

Subpackages
-----------
ops        pure DSP ops (convert / xcorr / delay / phase / spectral)
kernels    spectral backends (XLA FFT, four-step matmul FFT, u8-native fused)
pipeline   block pipeline: state, step, control law, offline/streaming drivers
parallel   mesh construction, shard_map wrappers, halo exchange
signal     synthetic multichannel signal model (the hardware-free backend)
io         host edge: wire format, ZMQ pub/control, console grammar, config
models     array geometry + beamforming / DOA (MUSIC, Bartlett, MVDR)
utils      telemetry, profiling helpers
"""

__version__ = "0.1.0"

from coherent_rtlsdr_tpu import constants  # noqa: F401
