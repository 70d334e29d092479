"""int8/uint8 IQ <-> complex-float conversion.

Capability parity with the reference's cdsp conversion kernels (VOLK SIMD in
the reference; XLA-fused elementwise here):

  * ``u8_to_i8``      — cdsp::convtosigned  (src/cdsp.cc:21-34): XOR 0x80,
                        i.e. remove the RTL2832's 128 DC offset.
  * ``u8_to_c64``     — convtosigned + cdsp::convtofloat (src/cdsp.cc:36-44):
                        scale by 1/127 into complex float.
  * ``c64_to_i8_iq``  — cdsp::convto8bit (src/cdsp.cc:51-54) as used for
                        output requantization (src/cpacketizer.cc:158-172).

Wire layout: interleaved IQ bytes ``[..., L, 2]`` (I then Q), unsigned 8-bit
offset-binary as produced by librtlsdr.
"""

import jax.numpy as jnp

from coherent_rtlsdr_tpu.constants import IQ_SCALE


def c2f(x: jnp.ndarray) -> jnp.ndarray:
    """complex ``[...]`` -> float32 ``[..., 2]`` (re, im).

    The pipeline state and the packed outputs carry complex quantities as
    float pairs (dense real tensors); ``f2c``/``c2f`` at program edges are
    free (XLA fuses them).
    """
    return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1).astype(jnp.float32)


def f2c(x: jnp.ndarray) -> jnp.ndarray:
    """float32 ``[..., 2]`` -> complex64 ``[...]``."""
    return jnp.complex64(x[..., 0] + 1j * x[..., 1])


def u8_to_i8(raw_u8: jnp.ndarray) -> jnp.ndarray:
    """Offset-binary uint8 -> signed int8 (value - 128), bit-exact with the
    reference's in-place XOR 0x80 (cdsp.cc:21-34)."""
    return (raw_u8 ^ jnp.uint8(0x80)).astype(jnp.int8)


def u8_to_c64(raw_u8: jnp.ndarray, scale: float = IQ_SCALE) -> jnp.ndarray:
    """``[..., L, 2]`` uint8 interleaved IQ -> ``[..., L]`` complex64.

    value = (u8 - 128) * scale, default scale 1/127 (cdsp.cc:36-44).
    """
    f = raw_u8.astype(jnp.float32) - 128.0
    return jnp.complex64((f[..., 0] + 1j * f[..., 1]) * scale)


def i8_iq_to_c64(raw_i8: jnp.ndarray, scale: float = IQ_SCALE) -> jnp.ndarray:
    """``[..., L, 2]`` int8 interleaved IQ -> ``[..., L]`` complex64."""
    f = raw_i8.astype(jnp.float32)
    return jnp.complex64((f[..., 0] + 1j * f[..., 1]) * scale)


def c64_to_i8_iq(x: jnp.ndarray, scale: float = 1.0 / IQ_SCALE) -> jnp.ndarray:
    """``[..., L]`` complex64 -> ``[..., L, 2]`` int8 interleaved IQ.

    Inverse of :func:`u8_to_c64` up to rounding; matches the packetizer's
    float->int8 requantization of corrected samples (cpacketizer.cc:158-172)
    with round-to-nearest and saturation.
    """
    iq = jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1) * scale
    return jnp.clip(jnp.round(iq), -128.0, 127.0).astype(jnp.int8)
