"""Sharding tests on the 8-virtual-device CPU mesh: the sharded engines must
match the unsharded ones (the collectives are an implementation detail, not a
numerical one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from coherent_rtlsdr_tpu.parallel import make_mesh, make_sharded_align, make_sharded_step
from coherent_rtlsdr_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS, auto_mesh_shape
from coherent_rtlsdr_tpu.pipeline import PipelineConfig, align_offline, init_state, step
from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

L = 1024


def _capture(n_channels=8, n_blocks=8, seed=0):
    truth = make_truth(n_channels, seed=seed, max_delay=30.0, snr_db=30.0)
    cap = synth_capture(
        jax.random.PRNGKey(seed), truth, n_blocks=n_blocks, block_len=L
    )
    return truth, cap


class TestMesh:
    def test_auto_mesh_shape(self):
        assert auto_mesh_shape(8, 24) == (1, 8)
        assert auto_mesh_shape(8, 21) == (8, 1)
        assert auto_mesh_shape(4, 8) == (1, 4)
        t, c = auto_mesh_shape(8)
        assert t * c == 8


class TestShardedAlign:
    def test_matches_unsharded(self):
        truth, cap = _capture(n_channels=8, n_blocks=8)
        cfg = PipelineConfig(n_channels=8, block_len=L)

        mesh = make_mesh(4, 2)
        fn = make_sharded_align(cfg, mesh)
        aligned_s, ref_s, delay_s, mag_s = jax.block_until_ready(
            fn(cap.sig_u8, cap.ref_u8)
        )

        res = align_offline(cfg, cap.sig_u8, cap.ref_u8, smoothing="global")

        # Sharded emits T blocks; block t>=1 corresponds to unsharded t-1.
        np.testing.assert_allclose(
            np.asarray(delay_s[1:]), np.asarray(res.delay), atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(aligned_s[1:]), np.asarray(res.aligned), atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(ref_s[1:]), np.asarray(res.ref), atol=1e-5
        )

    def test_recovers_truth(self):
        truth, cap = _capture(n_channels=4, n_blocks=8, seed=2)
        cfg = PipelineConfig(n_channels=4, block_len=L)
        mesh = make_mesh(2, 4)
        fn = make_sharded_align(cfg, mesh)
        aligned, ref, delay, mag = jax.block_until_ready(
            fn(cap.sig_u8, cap.ref_u8)
        )
        np.testing.assert_allclose(np.asarray(delay[-1]), truth.delays, atol=0.05)

    def test_rejects_ema(self):
        cfg = PipelineConfig(n_channels=4, block_len=L)
        with pytest.raises(NotImplementedError):
            make_sharded_align(cfg, make_mesh(2, 4), smoothing="ema")


class TestAutoShardedAlign:
    @pytest.mark.parametrize("smoothing", ["global", "ema"])
    def test_matches_unsharded_exactly(self, smoothing):
        """GSPMD partitioning must be numerically transparent — including
        the EMA associative scan across time shards."""
        from coherent_rtlsdr_tpu.parallel import make_auto_sharded_align

        L2 = 2048  # 2L = 4096 = 64^2 for the matmul-FFT backend
        truth = make_truth(8, seed=4, max_delay=30.0, snr_db=30.0)
        cap = synth_capture(
            jax.random.PRNGKey(4), truth, n_blocks=8, block_len=L2
        )
        # matmul-FFT backend: no FFT custom-call, fully GSPMD-partitionable
        cfg = PipelineConfig(
            n_channels=8, block_len=L2, fft_impl="mxu", mxu_precision="f32"
        )
        mesh = make_mesh(4, 2)
        run = make_auto_sharded_align(cfg, mesh, smoothing=smoothing)
        rs = run(cap.sig_u8, cap.ref_u8)
        ru = align_offline(cfg, cap.sig_u8, cap.ref_u8, smoothing=smoothing)
        np.testing.assert_allclose(
            np.asarray(rs.delay), np.asarray(ru.delay), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(rs.aligned), np.asarray(ru.aligned), atol=1e-3
        )


class TestChannelShardedAlign:
    def test_fused_matches_unsharded(self):
        """The fused i8 offline engine under channel-only shard_map (the
        multi-device throughput path)
        must match the unsharded engine: smoothing is channel-local, so the
        per-shard programs compute the same terms."""
        from coherent_rtlsdr_tpu.parallel import make_channel_sharded_align

        Lf = 2048  # fused needs a square fft_len (4096 = 64^2)
        N, T = 8, 4
        truth = make_truth(N, seed=3, max_delay=20.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(3), truth, n_blocks=T,
                            block_len=Lf)
        cfg = PipelineConfig(n_channels=N, block_len=Lf, fft_impl="fused",
                             lag_method="phase_zoom")
        sig = jnp.asarray(np.asarray(cap.sig_u8).reshape(T, N, 2 * Lf))
        ref = jnp.asarray(np.asarray(cap.ref_u8).reshape(T, 2 * Lf))

        res = jax.jit(
            lambda s, r: align_offline(cfg, s, r, smoothing="global")
        )(sig, ref)

        mesh = make_mesh(1, 8)
        run = make_channel_sharded_align(cfg, mesh)
        wire_s, delay_s, mag_s = run(sig, ref)

        np.testing.assert_allclose(np.asarray(delay_s), np.asarray(res.delay),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(mag_s), np.asarray(res.mag),
                                   atol=1e-5)
        diff = np.abs(np.asarray(wire_s, np.int32)
                      - np.asarray(res.wire, np.int32))
        assert diff.max() <= 1  # bf16 accumulation-order LSB at most

    def test_fused_time_sharded_matches_unsharded(self):
        """The raw-byte ppermute halo runner (the fused engine sharded over
        BOTH mesh axes) must match the
        unsharded fused engine — the halo'd shard-boundary windows and the
        psum-reduced smoothing are implementation details, not numerics."""
        from coherent_rtlsdr_tpu.parallel import make_fused_time_sharded_align

        Lf = 2048
        N, T = 8, 8
        truth = make_truth(N, seed=5, max_delay=20.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(5), truth, n_blocks=T,
                            block_len=Lf)
        cfg = PipelineConfig(n_channels=N, block_len=Lf, fft_impl="fused",
                             lag_method="phase_zoom")
        sig = jnp.asarray(np.asarray(cap.sig_u8).reshape(T, N, 2 * Lf))
        ref = jnp.asarray(np.asarray(cap.ref_u8).reshape(T, 2 * Lf))

        res = jax.jit(
            lambda s, r: align_offline(cfg, s, r, smoothing="global")
        )(sig, ref)

        mesh = make_mesh(4, 2)  # time AND channel shards
        run = make_fused_time_sharded_align(cfg, mesh)
        wire_s, wref_s, delay_s, mag_s = jax.block_until_ready(run(sig, ref))

        # Sharded emits T windows; window t>=1 is unsharded window t-1.
        np.testing.assert_allclose(
            np.asarray(delay_s[1:]), np.asarray(res.delay), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(mag_s[1:]), np.asarray(res.mag), atol=1e-5
        )
        diff = np.abs(np.asarray(wire_s[1:], np.int32)
                      - np.asarray(res.wire, np.int32))
        assert diff.max() <= 1  # psum/bf16 accumulation-order LSB at most
        np.testing.assert_array_equal(
            np.asarray(wref_s[1:]), np.asarray(res.wire_ref)
        )
        # the shard-boundary windows (t = T/4, 2T/4, 3T/4) must be REAL
        # measurements, not halo artifacts: recovered delays at truth
        np.testing.assert_allclose(
            np.asarray(delay_s[-1]), truth.delays, atol=0.1
        )

    def test_fused_time_sharded_time_only_mesh(self):
        """All eight devices on the TIME axis (channel unsharded) — the
        pure halo-chain configuration: every shard boundary exercises the
        ppermute, and the psum spans all eight shards."""
        from coherent_rtlsdr_tpu.parallel import make_fused_time_sharded_align

        Lf = 2048
        N, T = 3, 8
        truth = make_truth(N, seed=6, max_delay=20.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(6), truth, n_blocks=T,
                            block_len=Lf)
        cfg = PipelineConfig(n_channels=N, block_len=Lf, fft_impl="fused",
                             lag_method="phase_zoom")
        sig = jnp.asarray(np.asarray(cap.sig_u8).reshape(T, N, 2 * Lf))
        ref = jnp.asarray(np.asarray(cap.ref_u8).reshape(T, 2 * Lf))
        res = jax.jit(
            lambda s, r: align_offline(cfg, s, r, smoothing="global")
        )(sig, ref)
        run = make_fused_time_sharded_align(cfg, make_mesh(8, 1))
        wire_s, wref_s, delay_s, mag_s = jax.block_until_ready(run(sig, ref))
        np.testing.assert_allclose(
            np.asarray(delay_s[1:]), np.asarray(res.delay), atol=1e-4
        )
        diff = np.abs(np.asarray(wire_s[1:], np.int32)
                      - np.asarray(res.wire, np.int32))
        assert diff.max() <= 1

    def test_fused_time_sharded_rejects_wrong_backend(self):
        from coherent_rtlsdr_tpu.parallel import make_fused_time_sharded_align

        cfg = PipelineConfig(n_channels=4, block_len=L)
        with pytest.raises(ValueError):
            make_fused_time_sharded_align(cfg, make_mesh(2, 4))
        cfg_f = PipelineConfig(n_channels=4, block_len=2048,
                               fft_impl="fused", lag_method="phase_zoom")
        with pytest.raises(NotImplementedError):
            make_fused_time_sharded_align(cfg_f, make_mesh(2, 4),
                                          smoothing="ema")

    def test_xla_backend_works_too(self):
        from coherent_rtlsdr_tpu.parallel import make_channel_sharded_align
        from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq

        truth, cap = _capture(n_channels=8, n_blocks=4)
        cfg = PipelineConfig(n_channels=8, block_len=L)
        res = jax.jit(
            lambda s, r: align_offline(cfg, s, r, smoothing="global")
        )(cap.sig_u8, cap.ref_u8)
        mesh = make_mesh(1, 8)
        run = make_channel_sharded_align(cfg, mesh)
        wire_s, delay_s, mag_s = run(cap.sig_u8, cap.ref_u8)
        np.testing.assert_allclose(np.asarray(delay_s), np.asarray(res.delay),
                                   atol=1e-5)
        diff = np.abs(np.asarray(wire_s, np.int32)
                      - np.asarray(c64_to_i8_iq(res.aligned), np.int32))
        assert diff.max() <= 1  # f32 reduction-order LSB at the quantizer


class TestShardedStep:
    def test_matches_unsharded_step(self):
        truth, cap = _capture(n_channels=8, n_blocks=4, seed=1)
        cfg = PipelineConfig(n_channels=8, block_len=L)
        mesh = make_mesh(1, 4)
        gate = jnp.array(True)

        sfn = make_sharded_step(cfg, mesh, donate=False)
        from coherent_rtlsdr_tpu.parallel.sharded import state_partition_spec

        sspec = state_partition_spec()
        state_s = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            init_state(cfg),
            sspec,
        )
        state_u = init_state(cfg)

        for t in range(4):
            state_s, out_s = sfn(state_s, cap.sig_u8[t], cap.ref_u8[t], gate)
            state_u, out_u = step(cfg, state_u, cap.sig_u8[t], cap.ref_u8[t], gate)

        np.testing.assert_allclose(
            np.asarray(state_s.delay), np.asarray(state_u.delay), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(state_s.phase), np.asarray(state_u.phase), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(out_s.aligned), np.asarray(out_u.aligned), atol=1e-3
        )
