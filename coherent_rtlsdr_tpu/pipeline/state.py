"""Pipeline state and output containers (all registered pytrees).

``PipelineState`` is the explicit, functional replacement for the state the
reference scatters across per-device objects and threads:

  reference (include/csdrdevice.h:42-195)            here
  -------------------------------------------       ---------------------------
  lagpoint{ts, lag, mag, PAPR}                      Telemetry.lag/mag/papr
  atomics synced/streaming/lagrequested/lagready    PipelineState.synced (+ gates
                                                    passed as step arguments)
  phasecorrection complex + EMA                     PipelineState.phase
  hardware resampler ppm offset (ccontrol)          PipelineState.delay (samples)
  sfloat half-buffers                               PipelineState.hist / ref_hist
  readcnt seqnums                                   PipelineState.block_idx (+
                                                    host-side seqnum tracking)
"""

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from coherent_rtlsdr_tpu import constants


def _pytree_node(cls):
    """Frozen dataclass registered as a pytree (every field a child), with
    a functional ``replace(**changes)``."""
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(dataclasses.dataclass(frozen=True)(cls))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration (hashable; closed over by jit)."""

    n_channels: int
    block_len: int = constants.DEFAULT_BLOCK_LEN
    fs: float = constants.DEFAULT_FS
    sync_threshold: float = constants.SYNC_THRESHOLD
    phase_alpha: float = constants.PHASE_EMA_ALPHA
    # Control law (see pipeline/control.py).
    ctrl_gain: float = constants.CTRL_FRAC_T
    ctrl_scale: float = constants.CTRL_SCALE
    # Max commanded advance; must stay within the overlap-save safe range.
    max_delay: Optional[float] = None
    # Fractional-lag estimator: "phase_slope" | "parabolic" | "integer".
    lag_method: str = "phase_slope"
    # Minimum correlation coefficient to accept a lag measurement.
    min_corr_mag: float = 0.1
    # Spectral backend (kernels/backend.py): "xla" (jnp.fft) | "mxu"
    # (four-step matmul FFT, kernels/fft4step.py) | "fused" (u8-native
    # engine, int8 wire out; requires lag_method="phase_zoom") | "auto"
    # (= "xla").
    fft_impl: str = "xla"
    # Four-step matmul precision: "bf16" (bf16 operands, f32 accumulation;
    # error below the int8 wire quantization step) | "f32" (full-precision
    # f32 matmuls).
    mxu_precision: str = "bf16"

    def __post_init__(self):
        if self.max_delay is None:
            object.__setattr__(self, "max_delay", self.block_len / 2.0 - 8.0)


@_pytree_node
class PipelineState:
    """Complex quantities are stored as float32 (re, im) pairs, so every
    leaf packs into the dense real tensors of ``pack_state``; ``f2c``/``c2f``
    convert at the edges of ``step()`` and XLA fuses them away."""

    delay: jnp.ndarray     # [N] f32 commanded advance (samples)
    phase: jnp.ndarray     # [N, 2] f32 unit-modulus correction factor (re, im)
    lag: jnp.ndarray       # [N] f32 last measured absolute lag
    mag: jnp.ndarray       # [N] f32 last correlation coefficient
    papr: jnp.ndarray      # [N] f32 last correlation PAPR
    synced: jnp.ndarray    # [N] bool
    hist: jnp.ndarray      # previous block (overlap-save): [N, L, 2] f32, or
                           # signed i8 capture bytes when fft_impl='fused'
    ref_hist: jnp.ndarray  # previous ref block: [L, 2] f32 (i8 when fused)
    block_idx: jnp.ndarray  # i32 scalar
    # In-pipeline seqnum-gap detection (the reference only detects drops
    # client-side via seqnums, README.md:42 / cpacketizer.cc:113,142):
    last_seq: jnp.ndarray  # [N] u32 last seen per-channel capture seqnum
    gaps: jnp.ndarray      # [N] i32 cumulative gap events (discontinuities)

    @property
    def phase_c(self) -> jnp.ndarray:
        """Complex view of ``phase`` (host/CPU analysis convenience)."""
        return self.phase[..., 0] + 1j * self.phase[..., 1]


@_pytree_node
class Telemetry:
    """Per-block measurement record — the union of the reference's lagpoint,
    the :5557 phase-factor debug stream, and the ``status`` table."""

    lag: jnp.ndarray      # [N] absolute measured lag (samples)
    residual: jnp.ndarray  # [N] lag remaining after the applied correction
    mag: jnp.ndarray      # [N]
    papr: jnp.ndarray     # [N]
    phase: jnp.ndarray    # [N, 2] f32 applied correction factor (re, im)
    synced: jnp.ndarray   # [N] bool
    rms: jnp.ndarray      # [N] block RMS (signal health, cf. cdsp::rms)
    gap: jnp.ndarray      # [N] bool seqnum discontinuity THIS block
    gaps: jnp.ndarray     # [N] i32 cumulative gap events

    @property
    def phase_c(self) -> jnp.ndarray:
        return self.phase[..., 0] + 1j * self.phase[..., 1]


# Column order of ``pack_telemetry`` (one [.., N, 10] f32 tensor).
TELEMETRY_COLS = (
    "lag", "residual", "mag", "papr", "rms",
    "phase_re", "phase_im", "synced", "gap", "gaps",
)


def pack_telemetry(t: Telemetry) -> jnp.ndarray:
    """Telemetry as ONE dense [.., N, 10] f32 tensor (TELEMETRY_COLS order).

    The server's publisher worker fetches telemetry every batch — one
    tensor means one transfer instead of nine. Bool leaves travel as
    0.0/1.0; ``gaps`` counts are exact in f32 up to 2^24.
    """
    return jnp.stack([
        t.lag, t.residual, t.mag, t.papr, t.rms,
        t.phase[..., 0], t.phase[..., 1],
        t.synced.astype(jnp.float32),
        t.gap.astype(jnp.float32),
        t.gaps.astype(jnp.float32),
    ], axis=-1)


# Packed-state layout across the jit boundary (pack_state / unpack_state).
# The streaming state crosses the boundary every dispatch in AND out;
# packing the 11 PipelineState leaves into THREE dense tensors means three
# buffers per direction instead of eleven, and XLA fuses the stack/slice
# glue into the neighboring ops.
PPACK_COLS = ("delay", "phase_re", "phase_im", "lag", "mag", "papr")
IPACK_COLS = ("synced", "last_seq", "gaps", "block_idx")


def pack_state(s: PipelineState):
    """PipelineState as THREE tensors (use inside jit; see pack_state_host
    for the eager edge):

      ppack [N, 6] f32  — PPACK_COLS
      ipack [N, 4] i32  — IPACK_COLS (last_seq bitcast u32->i32 lossless;
                          block_idx replicated down the column)
      hist  [N+1, ...]  — ref_hist row 0 + per-channel hist rows (the
                          capture frame layout, ref first)
    """
    ppack = jnp.stack(
        [s.delay, s.phase[..., 0], s.phase[..., 1], s.lag, s.mag, s.papr],
        axis=-1,
    )
    ipack = jnp.stack(
        [
            s.synced.astype(jnp.int32),
            jax.lax.bitcast_convert_type(s.last_seq, jnp.int32),
            s.gaps,
            jnp.broadcast_to(s.block_idx, s.gaps.shape),
        ],
        axis=-1,
    )
    hist = jnp.concatenate([s.ref_hist[None], s.hist], axis=0)
    return ppack, ipack, hist


def unpack_state(ppack, ipack, hist) -> PipelineState:
    """Inverse of :func:`pack_state` (exact: every leaf round-trips
    bit-identically)."""
    return PipelineState(
        delay=ppack[:, 0],
        phase=ppack[:, 1:3],
        lag=ppack[:, 3],
        mag=ppack[:, 4],
        papr=ppack[:, 5],
        synced=ipack[:, 0].astype(bool),
        last_seq=jax.lax.bitcast_convert_type(ipack[:, 1], jnp.uint32),
        gaps=ipack[:, 2],
        block_idx=ipack[0, 3],
        hist=hist[1:],
        ref_hist=hist[0],
    )


def pack_state_host(s: PipelineState):
    """Eager-edge pack: numpy on host, ONE upload per packed tensor (no
    per-leaf eager device ops)."""
    import numpy as np

    delay = np.asarray(s.delay, np.float32)
    phase = np.asarray(s.phase, np.float32)
    ppack = np.stack(
        [delay, phase[..., 0], phase[..., 1],
         np.asarray(s.lag, np.float32), np.asarray(s.mag, np.float32),
         np.asarray(s.papr, np.float32)],
        axis=-1,
    )
    n = delay.shape[0]
    ipack = np.stack(
        [
            np.asarray(s.synced).astype(np.int32),
            np.asarray(s.last_seq, np.uint32).view(np.int32),
            np.asarray(s.gaps, np.int32),
            np.full(n, int(np.asarray(s.block_idx)), np.int32),
        ],
        axis=-1,
    )
    hist = np.concatenate(
        [np.asarray(s.ref_hist)[None], np.asarray(s.hist)], axis=0
    )
    return jnp.asarray(ppack), jnp.asarray(ipack), jnp.asarray(hist)


def unpack_state_host(ppack, ipack, hist) -> PipelineState:
    """Eager-edge unpack: THREE device fetches, then numpy slicing. Leaves
    are returned as NUMPY arrays, not device arrays — the host touchpoints
    that consume this view (status table, checkpoint save, hot-plug remap,
    tests) read with np.asarray anyway, and re-uploading 11 leaves per
    console command would cost 11 needless transfers. pack_state_host
    accepts numpy leaves, so a replace()d view rides straight back into the
    packed carry."""
    import numpy as np

    pp = np.asarray(ppack)
    ip = np.asarray(ipack)
    hp = np.asarray(hist)
    return PipelineState(
        delay=pp[:, 0],
        phase=np.ascontiguousarray(pp[:, 1:3]),
        lag=pp[:, 3],
        mag=pp[:, 4],
        papr=pp[:, 5],
        synced=ip[:, 0].astype(bool),
        last_seq=np.ascontiguousarray(ip[:, 1]).view(np.uint32),
        gaps=np.ascontiguousarray(ip[:, 2]),
        block_idx=np.int32(ip[0, 3]),
        hist=hp[1:],
        ref_hist=hp[0],
    )


@_pytree_node
class BlockOutput:
    """``aligned``/``ref`` are complex64; the hot callers reduce them to the
    int8 wire format inside the jitted program (io/server.py, bench.py).

    The fused i8-native path (fft_impl='fused') additionally emits the int8
    wire frame directly (``wire``/``wire_ref``) as FLAT interleaved bytes —
    [N, 2L]/[2L], reshape host-side. Its ``aligned``/``ref`` are then
    reconstructions from the wire bytes (same fidelity the clients see)
    that XLA dead-code-eliminates when unused."""

    aligned: jnp.ndarray   # [N, L] c64 corrected signal channels
    ref: jnp.ndarray       # [L] c64 reference channel (same pipeline latency)
    telemetry: Telemetry
    wire: Optional[jnp.ndarray] = None       # [N, 2L] int8 wire bytes (flat)
    wire_ref: Optional[jnp.ndarray] = None   # [2L] int8 ref bytes (flat)


def init_state(cfg: PipelineConfig) -> PipelineState:
    N, L = cfg.n_channels, cfg.block_len
    phase0 = jnp.zeros((N, 2), jnp.float32).at[:, 0].set(1.0)
    # The fused path keeps the capture bytes after offset removal (u8 XOR
    # 0x80, i.e. signed int8 IQ); the others keep dequantized float pairs.
    hist_dtype = jnp.int8 if cfg.fft_impl == "fused" else jnp.float32
    hist = jnp.zeros((N, L, 2), hist_dtype)
    ref_hist = jnp.zeros((L, 2), hist_dtype)
    return PipelineState(
        delay=jnp.zeros((N,), jnp.float32),
        phase=phase0,
        lag=jnp.zeros((N,), jnp.float32),
        mag=jnp.zeros((N,), jnp.float32),
        papr=jnp.zeros((N,), jnp.float32),
        synced=jnp.zeros((N,), bool),
        hist=hist,
        ref_hist=ref_hist,
        block_idx=jnp.zeros((), jnp.int32),
        last_seq=jnp.zeros((N,), jnp.uint32),
        gaps=jnp.zeros((N,), jnp.int32),
    )
