"""Spectral backend tests: the four-step matmul FFT's layout semantics vs
jnp.fft, backend selection, and pipeline equivalence between the 'xla',
'mxu' and 'fused' spectral backends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coherent_rtlsdr_tpu.kernels.fft4step import FFT4Step, supported_fft_len
from coherent_rtlsdr_tpu.kernels.permuted import (
    delay_ramp_permuted,
    lag_estimate_permuted,
)
from coherent_rtlsdr_tpu.ops.delay import delay_ramp
from coherent_rtlsdr_tpu.ops.xcorr import lag_estimate_from_spectra

W = 4096  # 64 x 64 — CPU-test-sized square length
M = 64


def _noise(key, shape):
    k1, k2 = jax.random.split(key)
    return (
        jax.random.normal(k1, shape, dtype=jnp.float32)
        + 1j * jax.random.normal(k2, shape, dtype=jnp.float32)
    ).astype(jnp.complex64)


def _to_permuted(X):
    """Natural-order spectrum [.., W] -> the four-step (k2, k1) layout."""
    m = M
    return jnp.swapaxes(X.reshape(*X.shape[:-1], m, m), -1, -2)


class TestFFT4Step:
    def test_supported_lengths(self):
        assert supported_fft_len(4096) and supported_fft_len(16384)
        assert supported_fft_len(65536)
        assert not supported_fft_len(8192)
        assert not supported_fft_len(1024)

    @pytest.mark.parametrize("precision,tol", [("f32", 2e-3), ("bf16", 3e-2)])
    def test_forward_matches_jnp_fft(self, precision, tol):
        fft = FFT4Step(W, precision=precision)
        x = _noise(jax.random.PRNGKey(0), (3, W))
        D = fft.fft(x)
        expect = _to_permuted(jnp.fft.fft(x, axis=-1))
        scale = float(jnp.max(jnp.abs(expect)))
        err = float(jnp.max(jnp.abs(D - expect))) / scale
        assert err < tol, err

    @pytest.mark.parametrize("precision,tol", [("f32", 1e-5), ("bf16", 2e-2)])
    def test_roundtrip(self, precision, tol):
        fft = FFT4Step(W, precision=precision)
        x = _noise(jax.random.PRNGKey(1), (2, W))
        y = fft.ifft(fft.fft(x))
        rms = float(jnp.sqrt(jnp.mean(jnp.abs(x) ** 2)))
        err = float(jnp.sqrt(jnp.mean(jnp.abs(y - x) ** 2))) / rms
        assert err < tol, err

    def test_freq_index_grid(self):
        fft = FFT4Step(W)
        k = np.asarray(fft.freq_index_grid())
        assert k[0, 0] == 0 and k[1, 0] == 1 and k[0, 1] == M
        assert k.max() == W - 1 and len(np.unique(k)) == W


class TestFFT4StepPrecision:
    """The 'f32' four-step runs its matmuls at full f32 precision: on a GPU
    the default f32 matmul may drop to TF32 (~3 decimal digits)."""

    def test_f32_highest_matches_jnp_fft(self):
        fft = FFT4Step(W, precision="f32")
        x = _noise(jax.random.PRNGKey(5), (2, W))
        D = fft.fft(x)
        expect = _to_permuted(jnp.fft.fft(x, axis=-1))
        scale = float(jnp.max(jnp.abs(expect)))
        err = float(jnp.max(jnp.abs(D - expect))) / scale
        assert err < 1e-5, err

    @pytest.mark.parametrize("precision,want", [
        ("f32", "HIGHEST"), ("bf16", "DEFAULT"),
    ])
    def test_einsum_precision_named(self, precision, want):
        fft = FFT4Step(W, precision=precision)
        x = _noise(jax.random.PRNGKey(6), (1, W))
        jaxpr = jax.make_jaxpr(lambda v: fft.ifft(fft.fft(v)))(x).jaxpr
        precs = [e.params["precision"] for e in jaxpr.eqns
                 if e.primitive.name == "dot_general"]
        assert len(precs) == 16, len(precs)  # 4 real matmuls x 2 stages x 2
        assert all(str(q) == want for pr in precs for q in pr), precs[0]

    def test_rejects_unknown_precision(self):
        with pytest.raises(ValueError, match="precision"):
            FFT4Step(W, precision="tf32")


class TestBackendSelection:
    @pytest.mark.parametrize("impl", ["pallas", "fftw", ""])
    def test_unknown_impl_rejected(self, impl):
        from coherent_rtlsdr_tpu.kernels.backend import get_spectral
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig

        cfg = PipelineConfig(n_channels=2, block_len=W // 2, fft_impl=impl)
        with pytest.raises(ValueError, match="unknown fft_impl"):
            get_spectral(cfg, W)

    @pytest.mark.parametrize("fft_len", [W, 8192])
    def test_auto_resolves_to_xla(self, fft_len):
        """'auto' is the XLA backend at every length, square or not."""
        from coherent_rtlsdr_tpu.kernels.backend import XlaSpectral, get_spectral
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig

        cfg = PipelineConfig(n_channels=2, block_len=fft_len // 2,
                             fft_impl="auto")
        assert type(get_spectral(cfg, fft_len)) is XlaSpectral

    @pytest.mark.parametrize("impl,cls", [
        ("xla", "XlaSpectral"), ("mxu", "MxuSpectral"),
        ("fused", "FusedSpectral"),
    ])
    def test_named_backends(self, impl, cls):
        from coherent_rtlsdr_tpu.kernels import backend
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig

        cfg = PipelineConfig(n_channels=2, block_len=W // 2, fft_impl=impl)
        assert type(backend.get_spectral(cfg, W)).__name__ == cls

    def test_square_length_still_required(self):
        from coherent_rtlsdr_tpu.kernels.backend import get_spectral
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig

        cfg = PipelineConfig(n_channels=2, block_len=4096, fft_impl="fused",
                             lag_method="phase_zoom")
        with pytest.raises(ValueError, match="square"):
            get_spectral(cfg, 8192)


class TestPermutedOps:
    def test_delay_ramp_matches_natural(self):
        fft = FFT4Step(W, precision="f32")
        for d in (0.0, 3.25, -117.5, 1000.0):
            rp = delay_ramp_permuted(fft, jnp.float32(d))
            rn = _to_permuted(delay_ramp(W, jnp.float32(d)))
            assert float(jnp.max(jnp.abs(rp - rn))) < 1e-4

    def test_lag_estimate_matches_natural(self):
        fft = FFT4Step(W, precision="f32")
        key = jax.random.PRNGKey(2)
        ref = _noise(key, (W,))
        lags = jnp.array([4.25, -33.7, 0.0])
        F_ref = jnp.fft.fft(ref)
        F_sig = F_ref[None, :] * delay_ramp(W, lags)
        est_n = lag_estimate_from_spectra(F_sig, F_ref)
        est_p = lag_estimate_permuted(fft, _to_permuted(F_sig), _to_permuted(F_ref))
        np.testing.assert_allclose(np.asarray(est_p.lag), np.asarray(est_n.lag), atol=2e-3)
        np.testing.assert_allclose(np.asarray(est_p.mag), np.asarray(est_n.mag), rtol=1e-3)
        np.testing.assert_allclose(
            np.asarray(est_p.papr), np.asarray(est_n.papr), rtol=1e-2
        )


class TestPipelineBackendEquivalence:
    L = 2048  # 2L = 4096 = 64^2

    def _run(self, fft_impl, precision="f32", n_blocks=10):
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig, init_state, step
        from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

        truth = make_truth(4, seed=0, max_delay=40.0, snr_db=30.0)
        cap = synth_capture(
            jax.random.PRNGKey(0), truth, n_blocks=n_blocks, block_len=self.L
        )
        cfg = PipelineConfig(
            n_channels=4, block_len=self.L, fft_impl=fft_impl,
            mxu_precision=precision,
        )
        state = init_state(cfg)
        gate = jnp.array(True)
        jstep = jax.jit(lambda s, a, b: step(cfg, s, a, b, gate))
        for t in range(n_blocks):
            state, out = jstep(state, cap.sig_u8[t], cap.ref_u8[t])
        return truth, state, out

    def test_step_mxu_f32_matches_truth(self):
        truth, state, out = self._run("mxu", "f32")
        np.testing.assert_allclose(np.asarray(state.delay), truth.delays, atol=0.02)
        assert bool(jnp.all(state.synced))

    def test_step_mxu_bf16_converges(self):
        truth, state, out = self._run("mxu", "bf16")
        np.testing.assert_allclose(np.asarray(state.delay), truth.delays, atol=0.1)
        assert bool(jnp.all(state.synced))
        # aligned output still coherent at the int8-wire level
        aligned = np.asarray(out.aligned)
        ref = np.asarray(out.ref)
        for ch in range(4):
            z = np.sum(aligned[ch] * np.conj(ref))
            rho = np.abs(z) / (np.linalg.norm(aligned[ch]) * np.linalg.norm(ref))
            assert rho > 0.95
            assert abs(np.degrees(np.angle(z))) < 3.0

    def test_offline_mxu_matches_xla(self):
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig, align_offline
        from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

        truth = make_truth(4, seed=1, max_delay=30.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(1), truth, n_blocks=8, block_len=self.L)
        cfg_x = PipelineConfig(n_channels=4, block_len=self.L, fft_impl="xla")
        cfg_m = PipelineConfig(
            n_channels=4, block_len=self.L, fft_impl="mxu", mxu_precision="f32"
        )
        rx = jax.jit(lambda s, r: align_offline(cfg_x, s, r))(cap.sig_u8, cap.ref_u8)
        rm = jax.jit(lambda s, r: align_offline(cfg_m, s, r))(cap.sig_u8, cap.ref_u8)
        np.testing.assert_allclose(
            np.asarray(rm.delay), np.asarray(rx.delay), atol=5e-3
        )
        err = np.abs(np.asarray(rm.aligned) - np.asarray(rx.aligned))
        rms = np.sqrt(np.mean(np.abs(np.asarray(rx.aligned)) ** 2))
        assert err.max() / rms < 0.05


class TestFusedKernels:
    """The u8-native fused engine (kernels/backend.FusedSpectral) vs the
    composed XLA path. The backend interface is stream blocks: window t =
    blocks (t, t+1)."""

    def _blocks(self, key, n_blocks=3, lags=(4.25, -33.7, 0.0)):
        """A continuous stream of n_blocks L-blocks; channels are exact
        circular fractional delays of the ref stream."""
        from coherent_rtlsdr_tpu.ops.delay import delay_ramp

        L = W // 2
        total = n_blocks * L
        ref = _noise(key, (total,))
        F_ref = jnp.fft.fft(ref)
        ramp = delay_ramp(total, jnp.array(lags, jnp.float32))
        sig = jnp.fft.ifft(F_ref[None, :] * ramp, axis=-1).astype(jnp.complex64)
        N = len(lags)
        return (
            sig.reshape(N, n_blocks, L).transpose(1, 0, 2),  # [T, N, L]
            ref.reshape(n_blocks, L),                        # [T, L]
        )

    def test_measure_matches_xla_phase_zoom(self):
        from coherent_rtlsdr_tpu.kernels.backend import FusedSpectral, XlaSpectral

        sig, ref = self._blocks(jax.random.PRNGKey(21), n_blocks=4)
        fused = FusedSpectral(W)
        xla = XlaSpectral(W)
        ef = fused.measure(fused.prepare(sig, ref), "phase_zoom")
        ex = xla.measure(xla.prepare(sig, ref), "phase_zoom")
        assert ef.lag.shape == (3, 3)
        np.testing.assert_allclose(
            np.asarray(ef.lag), np.asarray(ex.lag), atol=5e-3
        )
        np.testing.assert_allclose(
            np.asarray(ef.mag), np.asarray(ex.mag), rtol=3e-2
        )

    def test_papr_parseval_sane(self):
        """In-kernel Parseval PAPR: large for a clean delayed channel, and
        within a factor of the natural-order argmax-path PAPR."""
        from coherent_rtlsdr_tpu.kernels.backend import FusedSpectral, XlaSpectral

        sig, ref = self._blocks(jax.random.PRNGKey(25), n_blocks=2)
        fused = FusedSpectral(W)
        xla = XlaSpectral(W)
        ef = fused.measure(fused.prepare(sig, ref), "phase_zoom")
        ex = xla.measure(xla.prepare(sig, ref), "phase_slope")
        pf = np.asarray(ef.papr)
        px = np.asarray(ex.papr)
        assert (pf > 100.0).all(), pf
        np.testing.assert_allclose(pf, px, rtol=0.5)

    def test_correct_matches_xla_center_half(self):
        from coherent_rtlsdr_tpu.kernels.backend import FusedSpectral, XlaSpectral

        sig, ref = self._blocks(jax.random.PRNGKey(23), n_blocks=2)
        adv = jnp.array([[4.25, -33.7, 0.0]], jnp.float32)
        fused = FusedSpectral(W)
        xla = XlaSpectral(W)
        yf = fused.correct(fused.prepare(sig, ref), adv)
        yx = xla.correct(xla.prepare(sig, ref), adv)
        assert yf.shape == (1, 3, W // 2)
        rms = float(jnp.sqrt(jnp.mean(jnp.abs(yx) ** 2)))
        err = float(jnp.sqrt(jnp.mean(jnp.abs(yf - yx) ** 2))) / rms
        assert err < 2e-2, err

    def test_measure_rejects_other_methods(self):
        from coherent_rtlsdr_tpu.kernels.backend import FusedSpectral

        sig, ref = self._blocks(jax.random.PRNGKey(24), n_blocks=2)
        fused = FusedSpectral(W)
        with pytest.raises(ValueError):
            fused.measure(fused.prepare(sig, ref), "phase_slope")

    def test_step_fused_converges(self):
        """fft_impl='fused' end to end on a short synthetic capture."""
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig, init_state, step
        from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

        L = 2048
        truth = make_truth(3, seed=2, max_delay=30.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(3), truth, n_blocks=8, block_len=L)
        cfg = PipelineConfig(
            n_channels=3, block_len=L, fft_impl="fused", lag_method="phase_zoom"
        )
        state = init_state(cfg)
        gate = jnp.array(True)
        jstep = jax.jit(lambda s, a, b: step(cfg, s, a, b, gate))
        for t in range(8):
            state, out = jstep(state, cap.sig_u8[t], cap.ref_u8[t])
        np.testing.assert_allclose(np.asarray(state.delay), truth.delays, atol=0.1)
        assert bool(jnp.all(state.synced))

    def test_step_fused_u8_wire_matches_xla(self):
        """The u8-native fused streaming step (raw bytes in, int8 wire out,
        in-kernel dequant/phase/requant) must track the XLA reference step:
        same delays, coherent wire output, near-identical wire bytes."""
        from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq, i8_iq_to_c64
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig, init_state, step
        from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

        L = 2048
        truth = make_truth(3, seed=7, max_delay=25.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(7), truth, n_blocks=10, block_len=L)
        gate = jnp.array(True)
        outs = {}
        for impl, method in (("xla", "phase_zoom"), ("fused", "phase_zoom")):
            cfg = PipelineConfig(
                n_channels=3, block_len=L, fft_impl=impl, lag_method=method
            )
            state = init_state(cfg)
            jstep = jax.jit(lambda s, a, b, c=cfg: step(c, s, a, b, gate))
            for t in range(10):
                state, out = jstep(state, cap.sig_u8[t], cap.ref_u8[t])
            outs[impl] = (state, out)
        sx, ox = outs["xla"]
        sf, of = outs["fused"]
        np.testing.assert_allclose(
            np.asarray(sf.delay), np.asarray(sx.delay), atol=2e-2
        )
        assert bool(jnp.all(sf.synced))
        # wire frames agree to a couple of int8 LSB (the full-window-vs-
        # center-half phase estimator delta); fused wire is FLAT bytes
        # [N, 2L]
        assert of.wire is not None and of.wire.dtype == jnp.int8
        wx = np.asarray(c64_to_i8_iq(ox.aligned), np.int32)
        wf = np.asarray(of.wire, np.int32).reshape(wx.shape)
        assert np.mean(np.abs(wf - wx)) < 1.0
        assert np.percentile(np.abs(wf - wx), 99) <= 3
        # ref channel is a bit-exact raw passthrough
        np.testing.assert_array_equal(
            np.asarray(of.wire_ref).reshape(-1, 2),
            np.asarray(c64_to_i8_iq(ox.ref)),
        )
        # reconstructed aligned view is coherent with the ref
        a = np.asarray(of.aligned)
        r = np.asarray(of.ref)
        for ch in range(3):
            z = np.sum(a[ch] * np.conj(r))
            rho = np.abs(z) / (np.linalg.norm(a[ch]) * np.linalg.norm(r))
            assert rho > 0.93, rho
            assert abs(np.degrees(np.angle(z))) < 5.0

    def test_step_fused_u8_gap_policy(self):
        """Seqnum-gap handling must survive the fused fast path: gap bumps
        the counter, desyncs the channel, and freezes its phase."""
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig, init_state, step
        from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

        L = 2048
        truth = make_truth(3, seed=8, max_delay=10.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(8), truth, n_blocks=8, block_len=L)
        cfg = PipelineConfig(
            n_channels=3, block_len=L, fft_impl="fused", lag_method="phase_zoom"
        )
        state = init_state(cfg)
        gate = jnp.array(True)
        jstep = jax.jit(lambda s, a, b, q: step(cfg, s, a, b, gate, seq=q))
        seq = np.zeros(3, np.uint32)
        for t in range(8):
            seq = seq + 1
            if t == 5:
                seq[1] += 3  # dropped buffers on channel 1
            state, out = jstep(
                state, cap.sig_u8[t], cap.ref_u8[t], jnp.asarray(seq)
            )
            if t == 4:
                phase_before = np.asarray(state.phase)
            if t == 5:
                tele = out.telemetry
                assert bool(tele.gap[1]) and not bool(tele.gap[0])
                assert not bool(state.synced[1])
                np.testing.assert_array_equal(
                    np.asarray(state.phase)[1], phase_before[1]
                )
        gaps = np.asarray(state.gaps)
        assert gaps[1] == 1 and gaps[0] == 0 and gaps[2] == 0
        assert bool(state.synced[1])  # re-locked after the gap

    def test_offline_fused_matches_xla(self):
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig, align_offline
        from coherent_rtlsdr_tpu.signal import make_truth, synth_capture

        L = 2048
        truth = make_truth(4, seed=4, max_delay=30.0, snr_db=30.0)
        cap = synth_capture(jax.random.PRNGKey(4), truth, n_blocks=8, block_len=L)
        cfg_x = PipelineConfig(
            n_channels=4, block_len=L, fft_impl="xla", lag_method="phase_zoom"
        )
        cfg_f = PipelineConfig(
            n_channels=4, block_len=L, fft_impl="fused", lag_method="phase_zoom"
        )
        rx = jax.jit(lambda s, r: align_offline(cfg_x, s, r))(cap.sig_u8, cap.ref_u8)
        rf = jax.jit(lambda s, r: align_offline(cfg_f, s, r))(cap.sig_u8, cap.ref_u8)
        np.testing.assert_allclose(
            np.asarray(rf.delay), np.asarray(rx.delay), atol=2e-2
        )
        err = np.abs(np.asarray(rf.aligned) - np.asarray(rx.aligned))
        rms = np.sqrt(np.mean(np.abs(np.asarray(rx.aligned)) ** 2))
        assert err.max() / rms < 0.06

    def test_spec_handoff_matches_apply_i8(self):
        """measure_i8 + apply_i8 (one spectrum shared by measurement and
        correction, raw bytes in, wire bytes out) must reproduce the
        generic XLA backend on the same bytes: the phase_zoom estimate, and
        the corrected center half requantized to int8."""
        from coherent_rtlsdr_tpu.kernels.backend import FusedSpectral, XlaSpectral
        from coherent_rtlsdr_tpu.ops.convert import (
            c64_to_i8_iq,
            i8_iq_to_c64,
            u8_to_i8,
        )

        k = FusedSpectral(W)
        L = W // 2
        T, N = 4, 3
        rng = np.random.default_rng(11)
        raw = u8_to_i8(jnp.asarray(
            rng.integers(0, 256, (T, N, L, 2), dtype=np.uint8)))
        ref_raw = u8_to_i8(jnp.asarray(
            rng.integers(0, 256, (T, L, 2), dtype=np.uint8)))
        adv = jnp.asarray(rng.uniform(-20, 20, (T - 1, N)).astype(np.float32))
        ph = jnp.asarray(np.exp(1j * rng.uniform(-np.pi, np.pi, (T - 1, N)))
                         .astype(np.complex64))

        est = jax.jit(k.measure_i8)(raw, ref_raw)
        assert est.spec.shape == (T - 1, N, W)
        xla = XlaSpectral(W)
        ctx = xla.prepare(i8_iq_to_c64(raw), i8_iq_to_c64(ref_raw))
        ex = xla.measure(ctx, "phase_zoom")
        np.testing.assert_allclose(np.asarray(est.lag), np.asarray(ex.lag),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(est.mag), np.asarray(ex.mag),
                                   rtol=1e-4)
        np.testing.assert_allclose(np.asarray(est.papr), np.asarray(ex.papr),
                                   rtol=1e-4)

        wire = jax.jit(k.apply_i8)(est.spec, adv, ph)
        assert wire.shape == (T - 1, N, W) and wire.dtype == jnp.int8
        expect = c64_to_i8_iq(xla.correct(ctx, adv) * ph[..., None])
        diff = np.abs(np.asarray(wire, np.int32).reshape(expect.shape)
                      - np.asarray(expect, np.int32))
        # same f32 math in another order: a value sitting on a rounding
        # boundary may flip by one LSB, nothing more
        assert diff.max() <= 1
        assert (diff != 0).mean() < 1e-3
