"""Scan-driver tests: the micro-batched streaming path must match the
one-block-per-call path exactly (same state trajectory, same wire bytes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq
from coherent_rtlsdr_tpu.pipeline import PipelineConfig, init_state, step
from coherent_rtlsdr_tpu.pipeline.drivers import make_scan_runner, run_capture
from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

L = 1024


def _cap(n=3, T=8, seed=0):
    truth = make_truth(n, seed=seed, max_delay=20.0, snr_db=30.0)
    cap = synth_capture(jax.random.PRNGKey(seed), truth, n_blocks=T, block_len=L)
    return truth, cap


class TestScanRunner:
    def test_matches_single_step_trajectory(self):
        truth, cap = _cap()
        cfg = PipelineConfig(n_channels=3, block_len=L)
        gate = jnp.array(True)

        state_a = init_state(cfg)
        wires = []
        jstep = jax.jit(lambda s, a, b: step(cfg, s, a, b, gate))
        for t in range(8):
            state_a, out = jstep(state_a, cap.sig_u8[t], cap.ref_u8[t])
            wires.append(np.asarray(c64_to_i8_iq(out.aligned)))

        state_b, wire_sig, wire_ref, telem = run_capture(
            cfg, init_state(cfg), cap.sig_u8, cap.ref_u8
        )
        np.testing.assert_allclose(
            np.asarray(state_a.delay), np.asarray(state_b.delay), atol=1e-5
        )
        # int8 wire bytes identical modulo +-1 LSB rounding at exact .5
        diff = np.abs(
            np.stack(wires).astype(np.int16) - np.asarray(wire_sig).astype(np.int16)
        )
        assert diff.max() <= 1

    def test_server_scan_depth_equivalence(self):
        """CoherentServer with scan_depth>1 publishes the same frames as the
        single-step server."""
        from tests.test_server import FakeControl, FakePublisher, _server

        srv1, pub1, _, _ = _server(n=3, seed=3)
        srv1.run(max_blocks=8)

        # rebuild identical source/server but with scan_depth=4
        from coherent_rtlsdr_tpu.io.server import CoherentServer
        from coherent_rtlsdr_tpu.signal.sources import SyntheticStreamSource

        truth = make_truth(3, seed=3, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=3)
        pub2, ctl2 = FakePublisher(), FakeControl()
        srv2 = CoherentServer(
            PipelineConfig(n_channels=3, block_len=L), src,
            publisher=pub2, control=ctl2, scan_depth=4,
        )
        srv2.run(max_blocks=8)

        assert len(pub1.frames) == len(pub2.frames) == 8
        for (iq1, s1, p1), (iq2, s2, p2) in zip(pub1.frames, pub2.frames):
            assert np.abs(iq1.astype(np.int16) - iq2.astype(np.int16)).max() <= 1
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_allclose(p1, p2, atol=1e-5)


class TestPackedState:
    """The packed-state jit boundary (state.pack_state: 11 leaves -> 3
    tensors, the production server's carry) must be numerically invisible."""

    def _trajectory_state(self, cfg, cap, T=4):
        state = init_state(cfg)
        gate = jnp.array(True)
        jstep = jax.jit(lambda s, a, b: step(cfg, s, a, b, gate))
        for t in range(T):
            state, _ = jstep(state, cap.sig_u8[t], cap.ref_u8[t])
        return state

    @pytest.mark.parametrize("impl", ["xla", "fused"])
    def test_pack_roundtrip_exact(self, impl):
        from coherent_rtlsdr_tpu.pipeline.state import (
            pack_state_host,
            unpack_state_host,
        )

        Lp = 2048 if impl == "fused" else L
        kw = (dict(fft_impl="fused", lag_method="phase_zoom")
              if impl == "fused" else {})
        cfg = PipelineConfig(n_channels=3, block_len=Lp, **kw)
        truth = make_truth(3, seed=11, max_delay=20.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(11), truth, n_blocks=4,
                            block_len=Lp)
        # seed a mid-stream state so every leaf is non-trivial (incl. a
        # large last_seq exercising the u32<->i32 bitcast)
        s = self._trajectory_state(cfg, cap)
        s = s.replace(last_seq=s.last_seq + jnp.uint32(0xC0000000))
        rt = unpack_state_host(*pack_state_host(s))
        for name in s.__dataclass_fields__:
            np.testing.assert_array_equal(
                np.asarray(getattr(rt, name)), np.asarray(getattr(s, name)),
                err_msg=name,
            )
            assert getattr(rt, name).dtype == getattr(s, name).dtype, name

    @pytest.mark.parametrize("impl", ["xla", "fused"])
    def test_packed_scan_matches_unpacked(self, impl):
        from coherent_rtlsdr_tpu.pipeline.drivers import (
            make_packed_scan_runner,
            make_packed_step,
            make_scan_runner,
        )
        from coherent_rtlsdr_tpu.pipeline.state import (
            pack_state_host,
            unpack_state_host,
        )

        Lp = 2048 if impl == "fused" else L
        kw = (dict(fft_impl="fused", lag_method="phase_zoom")
              if impl == "fused" else {})
        cfg = PipelineConfig(n_channels=3, block_len=Lp, **kw)
        truth = make_truth(3, seed=12, max_delay=20.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(12), truth, n_blocks=6,
                            block_len=Lp)
        sigs, refs = cap.sig_u8, cap.ref_u8
        if impl == "fused":
            sigs = jnp.asarray(np.asarray(sigs).reshape(6, 3, 2 * Lp))
            refs = jnp.asarray(np.asarray(refs).reshape(6, 2 * Lp))
        gate = jnp.array(True)
        seqs = jnp.broadcast_to(
            jnp.arange(1, 7, dtype=jnp.uint32)[:, None], (6, 3)
        )

        ref_run = make_scan_runner(cfg, emit_wire=True, donate=False,
                                   pack_telem=True)
        s_ref, (w_ref, wr_ref), t_ref = ref_run(
            init_state(cfg), sigs, refs, gate, seqs
        )

        prun = make_packed_scan_runner(cfg, donate=False)
        ps, (w_p, wr_p), t_p = prun(
            pack_state_host(init_state(cfg)), sigs, refs, gate, seqs
        )
        s_p = unpack_state_host(*ps)

        np.testing.assert_array_equal(np.asarray(w_p), np.asarray(w_ref))
        np.testing.assert_array_equal(np.asarray(wr_p), np.asarray(wr_ref))
        np.testing.assert_allclose(np.asarray(t_p), np.asarray(t_ref),
                                   atol=1e-6)
        for name in ("delay", "phase", "lag", "mag", "synced", "last_seq",
                     "gaps", "block_idx", "hist", "ref_hist"):
            np.testing.assert_allclose(
                np.asarray(getattr(s_p, name)),
                np.asarray(getattr(s_ref, name)), atol=1e-6, err_msg=name,
            )

        # the single-block packed step continues the same trajectory
        pstep = make_packed_step(cfg, donate=False)
        ps2, w1, wr1, t1 = pstep(ps, sigs[-1], refs[-1], gate, seqs[-1] + 1)
        assert np.asarray(w1).shape == np.asarray(w_ref)[0].shape
        assert int(np.asarray(unpack_state_host(*ps2).block_idx)) == 7

    def test_unpack_host_returns_numpy_leaves(self):
        """The host-edge unpack must NOT re-upload leaves to the device:
        console touchpoints (status, checkpoint) read the view with numpy
        and re-uploading 11 leaves per command would cost 11 needless
        transfers."""
        from coherent_rtlsdr_tpu.pipeline.state import (
            pack_state_host,
            unpack_state_host,
        )

        cfg = PipelineConfig(n_channels=3, block_len=L)
        s = unpack_state_host(*pack_state_host(init_state(cfg)))
        for name in s.__dataclass_fields__:
            leaf = getattr(s, name)
            assert isinstance(leaf, (np.ndarray, np.generic)), (
                name, type(leaf))


class TestPackedTelemetry:
    def test_pack_matches_pytree(self):
        import jax
        import jax.numpy as jnp

        from coherent_rtlsdr_tpu.pipeline import PipelineConfig, init_state, step
        from coherent_rtlsdr_tpu.pipeline.state import (
            TELEMETRY_COLS,
            pack_telemetry,
        )
        from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

        L = 1024
        truth = make_truth(3, seed=9, max_delay=10.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(9), truth, n_blocks=3,
                            block_len=L)
        cfg = PipelineConfig(n_channels=3, block_len=L)
        state = init_state(cfg)
        gate = jnp.array(True)
        for t in range(3):
            state, out = jax.jit(lambda s, a, b: step(cfg, s, a, b, gate))(
                state, cap.sig_u8[t], cap.ref_u8[t]
            )
        tp = np.asarray(pack_telemetry(out.telemetry))
        assert tp.shape == (3, len(TELEMETRY_COLS))
        t = out.telemetry
        expect = {
            "lag": t.lag, "residual": t.residual, "mag": t.mag,
            "papr": t.papr, "rms": t.rms,
            "phase_re": t.phase[:, 0], "phase_im": t.phase[:, 1],
            "synced": t.synced.astype(np.float32),
            "gap": t.gap.astype(np.float32),
            "gaps": t.gaps.astype(np.float32),
        }
        for j, name in enumerate(TELEMETRY_COLS):
            np.testing.assert_allclose(
                tp[:, j], np.asarray(expect[name]), rtol=1e-6, err_msg=name
            )

    def test_scan_runner_pack_telem(self):
        import jax.numpy as jnp

        from coherent_rtlsdr_tpu.pipeline import PipelineConfig, init_state
        from coherent_rtlsdr_tpu.pipeline.drivers import make_scan_runner
        from coherent_rtlsdr_tpu.pipeline.state import TELEMETRY_COLS

        L, N, K = 1024, 2, 4
        cfg = PipelineConfig(n_channels=N, block_len=L)
        rng = np.random.default_rng(1)
        sigs = jnp.asarray(rng.integers(0, 256, (K, N, L, 2), dtype=np.uint8))
        refs = jnp.asarray(rng.integers(0, 256, (K, L, 2), dtype=np.uint8))
        run = make_scan_runner(cfg, pack_telem=True, donate=False)
        _, (ws, wr), tp = run(init_state(cfg), sigs, refs, jnp.array(True))
        assert tp.shape == (K, N, len(TELEMETRY_COLS))
        assert np.isfinite(np.asarray(tp)).all()
