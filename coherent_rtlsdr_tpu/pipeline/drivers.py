"""Block-stream drivers around ``step``.

* ``make_scan_runner``: K blocks per dispatch via ``lax.scan`` — the
  production streaming mode. One device round-trip per K blocks amortizes
  the per-dispatch cost at the cost of K blocks of latency (K=8 at
  2.048 Msps / L=8192 is 32 ms — far below the reference's seconds-long
  hardware sync transients, ccontrol.cc:99-116).
* ``run_capture``: convenience — scan a whole in-memory capture with
  streaming semantics (exact EMA/control dynamics, unlike the offline
  engine's parallel smoother).
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq
from coherent_rtlsdr_tpu.pipeline.state import (
    PipelineConfig,
    PipelineState,
    pack_state,
    pack_telemetry,
    unpack_state,
)
from coherent_rtlsdr_tpu.pipeline.step import step


def make_scan_runner(cfg: PipelineConfig, emit_wire: bool = True,
                     donate: bool = True, pack_telem: bool = False):
    """Returns jitted ``run(state, sig_u8 [K,N,L,2], ref_u8 [K,L,2], gate,
    seqs=None)`` -> ``(state, outputs)`` where outputs are stacked over K:
    int8 wire blocks (or raw aligned float pairs) + telemetry. ``seqs``
    ([K, N] uint32) enables in-pipeline gap detection (see step()).
    ``pack_telem`` emits telemetry as ONE [K, N, 10] f32 tensor
    (state.TELEMETRY_COLS) instead of the 9-leaf pytree — fewer output
    buffers per dispatch, one host fetch for the consumer."""

    def scan_fn(state, sigs, refs, gate, seqs=None):
        def body(s, blk):
            s2, out = step(cfg, s, blk[0], blk[1], gate, seq=blk[2])
            if emit_wire:
                if out.wire is not None:  # fused path emits int8 directly
                    payload = (out.wire, out.wire_ref)
                else:
                    payload = (c64_to_i8_iq(out.aligned), c64_to_i8_iq(out.ref))
            else:
                from coherent_rtlsdr_tpu.ops.convert import c2f

                payload = (c2f(out.aligned), c2f(out.ref))
            telem = (pack_telemetry(out.telemetry) if pack_telem
                     else out.telemetry)
            return s2, (payload, telem)

        if seqs is None:
            seqs = (state.last_seq[None, :]
                    + jnp.arange(1, sigs.shape[0] + 1, dtype=jnp.uint32)[:, None])
        state, (payloads, telem) = jax.lax.scan(body, state, (sigs, refs, seqs))
        return state, payloads, telem

    return jax.jit(scan_fn, donate_argnums=(0,) if donate else ())


def make_packed_scan_runner(cfg: PipelineConfig, donate: bool = True):
    """The scan runner with the STATE packed to three tensors across the
    jit boundary (state.pack_state): ``run(pstate, sigs [K,N,2L|K,N,L,2],
    refs, gate, seqs [K,N]) -> (pstate, (wire, wire_ref), telem [K,N,10])``
    where ``pstate = (ppack, ipack, hist)``.

    The production server carries the packed triple (three buffers per
    direction instead of eleven state leaves) and unpacks only at rare host
    touchpoints (status, checkpoint, hot-plug). Telemetry is always packed
    here. The scan body
    runs on the ordinary PipelineState — packing is boundary-only glue
    that XLA fuses away."""

    def run(pstate, sigs, refs, gate, seqs):
        state = unpack_state(*pstate)

        def body(s, blk):
            s2, out = step(cfg, s, blk[0], blk[1], gate, seq=blk[2])
            if out.wire is not None:
                payload = (out.wire, out.wire_ref)
            else:
                payload = (c64_to_i8_iq(out.aligned), c64_to_i8_iq(out.ref))
            return s2, (payload, pack_telemetry(out.telemetry))

        state, (payloads, telem) = jax.lax.scan(body, state, (sigs, refs, seqs))
        return pack_state(state), payloads, telem

    return jax.jit(run, donate_argnums=(0,) if donate else ())


def make_packed_step(cfg: PipelineConfig, donate: bool = True):
    """Single-block twin of :func:`make_packed_scan_runner`:
    ``run(pstate, sig, ref, gate, seq) -> (pstate, wire, wire_ref,
    telem [N, 10])`` — the latency-optimal dispatch with the minimum leaf
    count (3 state + 3 data in; 3 state + 3 out)."""

    def run(pstate, sig_u8, ref_u8, gate, seq):
        state = unpack_state(*pstate)
        state, out = step(cfg, state, sig_u8, ref_u8, gate, seq=seq)
        if out.wire is not None:
            wire, wire_ref = out.wire, out.wire_ref
        else:
            wire, wire_ref = c64_to_i8_iq(out.aligned), c64_to_i8_iq(out.ref)
        return pack_state(state), wire, wire_ref, pack_telemetry(out.telemetry)

    return jax.jit(run, donate_argnums=(0,) if donate else ())


def run_capture(
    cfg: PipelineConfig,
    state: PipelineState,
    sig_u8: jnp.ndarray,  # [T, N, L, 2]
    ref_u8: jnp.ndarray,  # [T, L, 2]
    gate: bool = True,
) -> Tuple[PipelineState, jnp.ndarray, jnp.ndarray, object]:
    """Streaming-exact processing of a whole capture in one program."""
    runner = make_scan_runner(cfg, emit_wire=True, donate=False)
    state, (wire_sig, wire_ref), telem = runner(
        state, sig_u8, ref_u8, jnp.array(gate)
    )
    return state, wire_sig, wire_ref, telem
