"""Streaming-server tests with in-memory publisher/control (no sockets):
orchestration, checkpoint/resume, fault injection — the subsystems the
reference lacks or leaves manual (SURVEY.md §5)."""

import numpy as np
import pytest

from coherent_rtlsdr_tpu.io.refnoise import RefNoise
from coherent_rtlsdr_tpu.io.server import CoherentServer
from coherent_rtlsdr_tpu.io.streamio import detect_seqnum_gaps
from coherent_rtlsdr_tpu.pipeline import PipelineConfig
from coherent_rtlsdr_tpu.signal import make_truth
from coherent_rtlsdr_tpu.signal.sources import SyntheticStreamSource

L = 1024


class FakePublisher:
    def __init__(self):
        self.frames = []

    def publish(self, iq_i8, seqnums, phases=None):
        self.frames.append((np.array(iq_i8), np.array(seqnums),
                            None if phases is None else np.array(phases)))
        return iq_i8.size


class FakeControl:
    def __init__(self):
        self.queue = []

    def poll(self, handler, timeout_ms=0):
        n = 0
        while self.queue:
            handler(self.queue.pop(0))
            n += 1
        return n


def _server(n=3, state_path=None, drop_rate=0.0, seed=0):
    truth = make_truth(n, seed=seed, max_delay=20.0, snr_db=30.0)
    src = SyntheticStreamSource(
        truth, block_len=L, slab_blocks=8, seed=seed, drop_rate=drop_rate
    )
    cfg = PipelineConfig(n_channels=n, block_len=L)
    pub, ctl = FakePublisher(), FakeControl()
    srv = CoherentServer(
        cfg, src, publisher=pub, control=ctl, state_path=state_path
    )
    return srv, pub, ctl, truth


class TestServerLoop:
    def test_publishes_frames_with_ref_channel(self):
        srv, pub, _, truth = _server()
        srv.run(max_blocks=6)
        assert len(pub.frames) == 6
        iq, seqs, phases = pub.frames[-1]
        assert iq.shape == (4, L, 2) and iq.dtype == np.int8  # ref + 3 sig
        assert seqs.shape == (4,)
        assert phases is not None and phases.shape == (4,)
        assert phases[0] == 1.0 + 0j  # ref channel phase placeholder
        assert np.allclose(np.abs(phases[1:]), 1.0, atol=1e-5)

    def test_converges_and_status(self):
        srv, pub, _, truth = _server()
        srv.run(max_blocks=10)
        st = srv.status()
        assert "3 / 3 synchronized" in st
        np.testing.assert_allclose(
            np.asarray(srv.state.delay), truth.delays, atol=0.05
        )

    def test_console_commands_through_dispatcher(self):
        srv, pub, ctl, _ = _server()
        ctl.queue.append("request rd")
        srv.run(max_blocks=2)
        assert srv.refnoise_enabled is False
        ctl.queue.append("request re")
        ctl.queue.append("fcenter 868000000")
        srv.run(max_blocks=2)
        assert srv.refnoise_enabled is True
        assert srv.fcenter == 868000000
        ctl.queue.append("quit")
        n = srv.run(max_blocks=10)
        assert n <= 1  # quit processed after first block

    def test_resync_request_clears_sync(self):
        srv, pub, ctl, _ = _server()
        srv.run(max_blocks=8)
        assert bool(np.all(np.asarray(srv.state.synced)))
        srv.request_sync()
        srv.run(max_blocks=1)
        # resync flag clears sync then re-evaluates within the same block —
        # with good signal it re-syncs immediately, but delay survived:
        np.testing.assert_allclose(
            np.asarray(srv.state.delay), np.asarray(srv.state.lag), atol=0.5
        )


class TestCheckpointResume:
    def test_state_roundtrip(self, tmp_path):
        path = str(tmp_path / "calib.npz")
        srv, _, _, truth = _server(state_path=path)
        srv.run(max_blocks=8)  # saves at end of run
        delay0 = np.asarray(srv.state.delay).copy()

        srv2, _, _, _ = _server(state_path=path)
        np.testing.assert_allclose(np.asarray(srv2.state.delay), delay0)
        assert bool(np.all(np.asarray(srv2.state.synced)))
        # resumed server is immediately aligned (no re-acquisition)
        srv2.run(max_blocks=2)
        np.testing.assert_allclose(
            np.asarray(srv2.state.delay), truth.delays, atol=0.05
        )


class GapInjectSource:
    """Wraps a source and simulates one missed capture buffer on a chosen
    channel at a chosen block: the block's samples repeat and its seqnum
    skips — exactly the reference's documented stale-buffer failure
    (README.md:42)."""

    def __init__(self, inner, gap_at: int, channel: int):
        self._inner = inner
        self._gap_at = gap_at
        self._ch = channel
        self._blocks = 0
        self._offset = None
        self.refnoise_enabled = True

    def next_block(self):
        sig, ref, seqs = self._inner.next_block()
        if self._offset is None:
            self._offset = np.zeros_like(seqs)
        if self._blocks == self._gap_at:
            self._offset[self._ch] += 1  # one buffer skipped
        self._blocks += 1
        return sig, ref, seqs + self._offset


class TestGapDetection:
    """In-pipeline seqnum-gap detection + policy (SURVEY.md §5: the
    reference delegates drop detection to clients, README.md:42 /
    cpacketizer.cc:113,142; here the pipeline itself detects, desyncs and
    re-locks)."""

    def test_gap_desync_relock_cycle(self):
        truth = make_truth(3, seed=3, max_delay=20.0, snr_db=30.0)
        src = GapInjectSource(
            SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=3),
            gap_at=8, channel=1,
        )
        cfg = PipelineConfig(n_channels=3, block_len=L)
        srv = CoherentServer(
            cfg, src, publisher=FakePublisher(), control=FakeControl()
        )
        srv.run(max_blocks=8)
        assert bool(np.all(np.asarray(srv.state.synced)))
        assert int(np.asarray(srv.state.gaps).sum()) == 0

        srv.run(max_blocks=1)  # the gapped block
        assert not bool(np.asarray(srv.state.synced)[1])  # policy: desync
        assert bool(np.asarray(srv.state.synced)[0])
        assert int(np.asarray(srv.state.gaps)[1]) == 1
        assert int(np.asarray(srv.state.gaps)[0]) == 0

        srv.run(max_blocks=4)  # re-lock
        assert bool(np.all(np.asarray(srv.state.synced)))
        assert int(np.asarray(srv.state.gaps)[1]) == 1  # counted once

    def test_gap_counters_under_random_drops(self):
        srv, pub, _, _ = _server(drop_rate=0.3, seed=5)
        srv.run(max_blocks=12)
        assert int(np.asarray(srv.state.gaps).sum()) > 0

    def test_status_and_log_surface_gaps(self):
        srv, _, _, _ = _server(drop_rate=0.3, seed=5)
        srv.run(max_blocks=12)
        st = srv.status()
        assert "seqnum gaps:" in st and "seqnum gaps: 0" not in st
        assert "blocks/s" in st and "phase drift" in st
        log = srv.drain_log()
        assert "seqnum gap on channel" in log
        assert srv.drain_log() == ""  # drained

    def test_scan_mode_detects_gaps_too(self):
        truth = make_truth(3, seed=3, max_delay=20.0, snr_db=30.0)
        src = GapInjectSource(
            SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=3),
            gap_at=9, channel=2,
        )
        cfg = PipelineConfig(n_channels=3, block_len=L)
        srv = CoherentServer(
            cfg, src, publisher=FakePublisher(), control=FakeControl(),
            scan_depth=4,
        )
        srv.run(max_blocks=16)
        assert int(np.asarray(srv.state.gaps)[2]) == 1
        assert bool(np.all(np.asarray(srv.state.synced)))  # re-locked


class TestLocalConsole:
    def test_stdin_commands_dispatch_and_quit(self, capsys):
        import io

        srv, pub, _, _ = _server()
        srv.start_local_console(stream=io.StringIO("status\nquit\n"))
        import time

        time.sleep(0.2)  # let the reader thread enqueue
        n = srv.run(max_blocks=50)
        assert n <= 2  # quit processed at the first control poll
        out = capsys.readouterr().out
        assert "synchronized" in out  # status reply printed locally
        assert "bye" in out


class TestFaultInjection:
    def test_drop_rate_creates_seqnum_gaps(self):
        srv, pub, _, _ = _server(drop_rate=0.3, seed=5)
        srv.run(max_blocks=12)
        seqs = np.stack([f[1][1:] for f in pub.frames])  # signal channels
        gaps = detect_seqnum_gaps(seqs)
        assert gaps.sum() > 0  # drops visible to clients via seqnums

    def test_pipeline_survives_drops(self):
        srv, pub, _, truth = _server(drop_rate=0.15, seed=7)
        srv.run(max_blocks=16)
        # quality-gated control should still find the true delays
        np.testing.assert_allclose(
            np.asarray(srv.state.delay), truth.delays, atol=0.6
        )


class TestHotPlug:
    def test_add_channel_mid_run(self):
        """Console `add` while streaming: existing channels keep their
        calibration, the new one acquires — the reference lists add/del as
        "unworking features" (README.md:20); here they work."""
        srv, pub, ctl, truth = _server()
        srv.run(max_blocks=8)
        delay_before = np.asarray(srv.state.delay).copy()
        assert bool(np.all(np.asarray(srv.state.synced)))

        ctl.queue.append("add NEWCH")
        srv.run(max_blocks=1)  # command processed after this block
        assert srv.cfg.n_channels == 4
        srv.run(max_blocks=8)  # let the new channel acquire
        frame = pub.frames[-1]
        assert frame[0].shape[0] == 5  # ref + 4 signal channels
        np.testing.assert_allclose(
            np.asarray(srv.state.delay)[:3], delay_before, atol=0.05
        )
        assert bool(np.all(np.asarray(srv.state.synced)))

    def test_del_channel_mid_run(self):
        srv, pub, ctl, truth = _server()
        srv.run(max_blocks=8)
        ctl.queue.append("del SYN 1")
        srv.run(max_blocks=2)
        assert srv.cfg.n_channels == 2
        frame = pub.frames[-1]
        assert frame[0].shape[0] == 3  # ref + 2 remaining
        np.testing.assert_allclose(
            np.asarray(srv.state.delay),
            truth.delays[[0, 2]],
            atol=0.05,
        )

    def test_del_unknown_serial(self):
        srv, _, _, _ = _server()
        out = srv.del_channel("NOPE")
        assert "no such channel" in out
        assert srv.cfg.n_channels == 3

    def test_list_all_shows_serials(self):
        srv, _, _, _ = _server()
        out = srv.list_channels(all=True)
        assert "SYN 0" in out and "SYN 2" in out


class TestRefNoise:
    def test_simulation_mode(self):
        rn = RefNoise(device=None)
        assert rn.isenabled
        rn.set_state(False)
        assert not rn.isenabled
        rn.close()

    def test_char_protocol(self, tmp_path):
        """Host chars written to the device: 'x' enable, 'o' disable
        (crefnoise.h:30-38), 'F'/'f' fan (fw.c:311-333)."""
        dev = tmp_path / "ttyACM0"
        dev.write_bytes(b"")
        rn = RefNoise(device=str(dev), enable_on_open=True)
        rn.set_state(False)
        rn.set_fan(True)
        rn.set_fan(False)
        rn.close()
        assert dev.read_bytes() == b"xoFf"


class TestStreamContinuity:
    """The synthetic stream must be sample-continuous across generation-slab
    boundaries (signal/synth.py synth_stream_slab): a per-slab independent
    realization put a discontinuous seam under one overlap-save window per
    slab, costing ~|delay|/L correlation on every slab-boundary frame
    (measured end-to-end before the fix)."""

    def test_ref_blocks_deterministic_across_slabs(self):
        from coherent_rtlsdr_tpu.signal.synth import synth_stream_slab

        truth = make_truth(2, seed=7, max_delay=40.0, snr_db=30.0)
        _, ref_a = synth_stream_slab(7, truth, slab_idx=0, slab_blocks=4,
                                     block_len=1024)
        _, ref_b = synth_stream_slab(7, truth, slab_idx=1, slab_blocks=4,
                                     block_len=1024)
        _, ref_big = synth_stream_slab(7, truth, slab_idx=0, slab_blocks=8,
                                       block_len=1024)
        np.testing.assert_array_equal(np.asarray(ref_a), np.asarray(ref_big[:4]))
        np.testing.assert_array_equal(np.asarray(ref_b), np.asarray(ref_big[4:]))

    def test_signal_channels_continuous_at_seam(self):
        from coherent_rtlsdr_tpu.signal.synth import synth_stream_slab

        truth = make_truth(3, seed=8, max_delay=40.0, snr_db=60.0)
        sig_a, _ = synth_stream_slab(8, truth, 0, 4, block_len=1024)
        sig_b, _ = synth_stream_slab(8, truth, 1, 4, block_len=1024)
        sig_big, _ = synth_stream_slab(8, truth, 0, 8, block_len=1024)
        # Delay rendering windows differ, so compare at the int8-wire level:
        # >= 99.9% of samples within 1 count (receiver noise is regenerated
        # per slab size, hence the high-SNR truth).
        a = np.concatenate([np.asarray(sig_a), np.asarray(sig_b)]).astype(np.int16)
        b = np.asarray(sig_big).astype(np.int16)
        close = np.abs(a - b) <= 1
        assert close.mean() > 0.999, close.mean()

    def test_no_correlation_dip_at_slab_boundary(self):
        import jax
        import jax.numpy as jnp

        from coherent_rtlsdr_tpu.pipeline import init_state, step

        truth = make_truth(3, seed=5, max_delay=40.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=2048, slab_blocks=4, seed=5)
        cfg = PipelineConfig(n_channels=3, block_len=2048)
        state = init_state(cfg)
        gate = jnp.array(True)
        jstep = jax.jit(lambda s, a, b: step(cfg, s, a, b, gate))
        worst = 1.0
        for t in range(13):
            sig, ref, _ = src.next_block()
            state, out = jstep(state, jnp.asarray(sig), jnp.asarray(ref))
            if t >= 5:  # converged; windows at t=8,12 span slab seams
                a = np.asarray(out.aligned)
                r = np.asarray(out.ref)
                for ch in range(3):
                    z = abs(np.vdot(r, a[ch]))
                    rho = z / (np.linalg.norm(a[ch]) * np.linalg.norm(r))
                    worst = min(worst, rho)
        assert worst > 0.995, worst


class TestHotPlugPadded:
    """max_channels padding: console add/del reuse the compiled executable
    (no recompile stall — VERDICT weak #4) and calibration survives."""

    def _padded_server(self, n=3, max_channels=6, **kw):
        truth = make_truth(n, seed=0, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=0)
        cfg = PipelineConfig(n_channels=n, block_len=L)
        pub, ctl = FakePublisher(), FakeControl()
        srv = CoherentServer(
            cfg, src, publisher=pub, control=ctl,
            max_channels=max_channels, **kw,
        )
        return srv, pub, ctl, truth

    def test_add_del_no_recompile(self):
        srv, pub, ctl, truth = self._padded_server()
        assert srv.cfg.n_channels == 6  # jit width = max_channels
        assert srv.n_active == 3
        srv.run(max_blocks=8)
        builds = srv.n_jit_builds
        delay_before = np.asarray(srv.state.delay)[:3].copy()
        assert bool(np.all(np.asarray(srv.state.synced)[:3]))

        ctl.queue.append("add NEWCH")
        srv.run(max_blocks=9)
        assert srv.n_jit_builds == builds  # same executable, no rebuild
        assert srv.n_active == 4
        frame = pub.frames[-1]
        assert frame[0].shape[0] == 5  # ref + 4 ACTIVE channels only
        np.testing.assert_allclose(
            np.asarray(srv.state.delay)[:3], delay_before, atol=0.05
        )
        assert bool(np.all(np.asarray(srv.state.synced)[:4]))

        ctl.queue.append("del SYN 1")
        srv.run(max_blocks=2)
        assert srv.n_jit_builds == builds
        assert srv.n_active == 3
        assert pub.frames[-1][0].shape[0] == 4  # ref + 3
        # surviving channels: SYN 0, SYN 2 keep calibration; NEWCH acquired
        np.testing.assert_allclose(
            np.asarray(srv.state.delay)[:2], truth.delays[[0, 2]], atol=0.1
        )

    def test_no_phantom_gaps_on_pad_rows(self):
        srv, pub, ctl, _ = self._padded_server()
        srv.run(max_blocks=10)
        gaps = np.asarray(srv.state.gaps)
        assert gaps[: srv.n_active].sum() == 0
        assert "seqnum gaps: 0 total" in srv.status()

    def test_add_beyond_limit_refused(self):
        srv, _, _, _ = self._padded_server(n=3, max_channels=3)
        out = srv.add_channel("X")
        assert "limit" in out
        assert srv.n_active == 3

    def test_padded_scan_depth(self):
        """Padding works through the lax.scan micro-batch driver too."""
        srv, pub, ctl, truth = self._padded_server(scan_depth=4)
        srv.run(max_blocks=12)
        assert pub.frames[-1][0].shape[0] == 4  # ref + 3 active
        np.testing.assert_allclose(
            np.asarray(srv.state.delay)[:3], truth.delays, atol=0.1
        )
        assert bool(np.all(np.asarray(srv.state.synced)[:3]))


class TestPipelinedPublish:
    """The publisher-worker handoff (the reference's double-buffered
    packetizer, cpacketizer.cc:109-185): fetch+publish of batch k overlaps
    dispatch of batch k+1 — frame order, ref seqnums, and per-channel
    seqnums must survive the handoff in both scan and single-block modes."""

    def _run(self, scan_depth, n_blocks=24):
        truth = make_truth(3, seed=5, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=5)
        cfg = PipelineConfig(n_channels=3, block_len=L)
        pub, ctl = FakePublisher(), FakeControl()
        srv = CoherentServer(
            cfg, src, publisher=pub, control=ctl, scan_depth=scan_depth
        )
        n = srv.run(max_blocks=n_blocks)
        assert n == n_blocks
        return pub

    def _check_order(self, pub, n_blocks):
        assert len(pub.frames) == n_blocks
        ref_seqs = [int(seq[0]) for _, seq, _ in pub.frames]
        # ref-channel wire seqnum: contiguous 1..T in publish order
        assert ref_seqs == list(range(1, n_blocks + 1))
        for ch in range(1, 4):
            chs = [int(seq[ch]) for _, seq, _ in pub.frames]
            assert chs == list(range(1, n_blocks + 1)), (ch, chs)
        for iq, _, ph in pub.frames:
            assert iq.shape == (4, L, 2)
            assert ph is not None and ph[0] == 1.0 + 0j

    def test_scan_mode_ordering(self):
        self._check_order(self._run(scan_depth=8), 24)

    def test_single_block_ordering(self):
        self._check_order(self._run(scan_depth=1), 24)

    def test_publish_error_surfaces_in_run(self):
        class BoomPub(FakePublisher):
            def publish(self, *a, **k):
                if len(self.frames) >= 3:
                    raise RuntimeError("zmq send failed")
                return super().publish(*a, **k)

        truth = make_truth(2, seed=6, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=6)
        cfg = PipelineConfig(n_channels=2, block_len=L)
        srv = CoherentServer(
            cfg, src, publisher=BoomPub(), control=FakeControl(),
            scan_depth=2,
        )
        with pytest.raises(RuntimeError, match="zmq send failed"):
            srv.run(max_blocks=16)

    def test_crash_still_persists_calibration(self, tmp_path):
        """A mid-run failure must not cost the array its sync state: the
        checkpoint is written even when run() exits by exception."""
        import os

        class BoomPub(FakePublisher):
            def publish(self, *a, **k):
                if len(self.frames) >= 2:
                    raise RuntimeError("boom")
                return super().publish(*a, **k)

        path = str(tmp_path / "cal.npz")
        truth = make_truth(2, seed=8, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=8)
        cfg = PipelineConfig(n_channels=2, block_len=L)
        srv = CoherentServer(
            cfg, src, publisher=BoomPub(), control=FakeControl(),
            scan_depth=2, state_path=path,
        )
        with pytest.raises(RuntimeError, match="boom"):
            srv.run(max_blocks=12)
        assert os.path.exists(path)
        z = np.load(path)
        assert z["delay"].shape == (2,)

    def test_resume_after_run_keeps_ref_seq_contiguous(self):
        """base ref seq is re-derived from state.block_idx at each run()
        start (bench warmup + measure calls run() twice)."""
        truth = make_truth(2, seed=7, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=7)
        cfg = PipelineConfig(n_channels=2, block_len=L)
        pub = FakePublisher()
        srv = CoherentServer(
            cfg, src, publisher=pub, control=FakeControl(), scan_depth=4
        )
        assert srv.run(max_blocks=8) == 8
        assert srv.run(max_blocks=8) == 8
        ref_seqs = [int(seq[0]) for _, seq, _ in pub.frames]
        assert ref_seqs == list(range(1, 17))


class TestConsoleFuzz:
    """The remote control socket accepts arbitrary bytes from the network
    (the reference feeds them straight into its parser, console.cc:334-355).
    A hostile/buggy client must never crash the server or corrupt the
    stream."""

    def test_garbage_commands_mid_stream(self):
        import itertools
        import random

        rng = random.Random(42)
        truth = make_truth(2, seed=11, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=11)
        cfg = PipelineConfig(n_channels=2, block_len=L)
        pub, ctl = FakePublisher(), FakeControl()
        srv = CoherentServer(cfg, src, publisher=pub, control=ctl,
                             scan_depth=4)
        garbage = [
            "", " ", "\x00\xff\xfe", "fs", "fs banana", "fs -1e99",
            "fcenter 0", "fcenter 999999999999", "fcenter nan",
            "add", "del", "del NO_SUCH", "request", "request wat",
            "list all", "status", "phase", "log", "help",
            "fs 1024000", "request rd", "request re", "request sync",
            "request lag", "A" * 4096, "add \x01\x02", "nop nop nop",
        ]
        feed = itertools.cycle(garbage)

        class FuzzCtl:
            def poll(self, cb):
                for _ in range(rng.randint(0, 3)):
                    cb(next(feed))

        srv.control = FuzzCtl()
        n = srv.run(max_blocks=40)
        assert n == 40
        # stream integrity survived: contiguous ref seqnums, right shapes
        ref_seqs = [int(seq[0]) for _, seq, _ in pub.frames]
        assert ref_seqs == list(range(1, 41))
        for iq, _, _ in pub.frames:
            assert iq.shape == (3, L, 2)
        # fs is either untouched or a VALID accepted value — the bogus
        # `fs -1e99` / `fs nan` in the stream must never land
        assert srv.fs in (2.048e6, 1024000.0)


class TestSoakRegressions:
    """Bugs surfaced by a 12-minute live soak with mid-run console
    mutations."""

    def test_status_works_after_hot_add(self):
        """Telemetry history holds [N]-wide series; after an add the width
        changes and np.stack over mixed shapes crashed `status` (the
        command guard caught it live; here it must just work)."""
        truth = make_truth(2, seed=12, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8,
                                    seed=12)
        srv = CoherentServer(
            PipelineConfig(n_channels=2, block_len=L), src,
            publisher=FakePublisher(), control=FakeControl(),
            max_channels=4,
        )
        assert srv.run(max_blocks=6) == 6
        out = srv.dispatcher.dispatch("add SOAK_Y")
        assert "added" in out
        assert srv.run(max_blocks=6) == 6
        st = srv.dispatcher.dispatch("status")  # must not raise
        assert "synchronized" in st and "error" not in st

    def test_hot_plug_at_slab_seam(self):
        """add/del exactly when a synthetic slab is exhausted resumed with
        offset == slab size -> IndexError (crashed the soak server)."""
        truth = make_truth(2, seed=13, max_delay=20.0, snr_db=30.0)
        slab = 4
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=slab,
                                    seed=13)
        ref_blocks = []
        for _ in range(slab):  # consume EXACTLY one slab
            ref_blocks.append(src.next_block()[1])
        src.add_channel("SEAM_X")  # invalidate at the seam
        blk = src.next_block()  # crashed with IndexError before the fix
        assert blk[0].shape[0] == 3
        # ref timeline is continuous: an untouched source's block 5 matches
        src2 = SyntheticStreamSource(truth, block_len=L, slab_blocks=slab,
                                     seed=13)
        for _ in range(slab):
            src2.next_block()
        np.testing.assert_array_equal(blk[1], src2.next_block()[1])

    def test_telemetry_width_change_resets_series(self):
        """An old-width telemetry row recorded AFTER a resize (in-flight
        publisher batch) must not poison the history: record() resets a
        series on shape change, so status/drift always stack."""
        from coherent_rtlsdr_tpu.utils.telemetry import TelemetryRecorder

        t = TelemetryRecorder()
        for _ in range(4):
            t.record(phase=np.ones(3, np.complex64), lag=np.zeros(3))
        t.record(phase=np.ones(4, np.complex64), lag=np.zeros(4))  # resized
        t.record(phase=np.ones(3, np.complex64), lag=np.zeros(3))  # stale
        t.record(phase=np.ones(3, np.complex64), lag=np.zeros(3))
        h = t.history("phase")  # must not raise
        assert h.shape == (2, 3)
        assert np.isfinite(t.phase_drift_deg_rms())


class TestShardedServer:
    """Multi-device serving: the server's jits channel-sharded over a device
    mesh (parallel/sharded.py make_sharded_server_jits) — published frames
    match the unsharded server within int8 wire quantization."""

    def _frames(self, mesh, scan_depth, n=4, blocks=8):
        truth = make_truth(n, seed=21, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8,
                                    seed=21)
        cfg = PipelineConfig(n_channels=n, block_len=L)
        pub = FakePublisher()
        srv = CoherentServer(
            cfg, src, publisher=pub, control=FakeControl(),
            scan_depth=scan_depth, mesh=mesh,
        )
        assert srv.run(max_blocks=blocks) == blocks
        return pub.frames, srv

    def _compare(self, scan_depth):
        from coherent_rtlsdr_tpu.parallel import make_mesh

        ref, _ = self._frames(None, scan_depth)
        sh, srv = self._frames(make_mesh(1, 2), scan_depth)
        assert len(ref) == len(sh)
        for (iq_r, seq_r, ph_r), (iq_s, seq_s, ph_s) in zip(ref, sh):
            np.testing.assert_array_equal(seq_r, seq_s)
            # float micro-diffs across the shard boundary may flip one
            # int8 LSB of the requantized wire
            assert np.abs(iq_r.astype(np.int16)
                          - iq_s.astype(np.int16)).max() <= 1
            np.testing.assert_allclose(ph_r, ph_s, atol=1e-4)
        assert "4 / 4 synchronized" in srv.status()

    def test_matches_unsharded_single_block(self):
        self._compare(scan_depth=1)

    def test_matches_unsharded_scan(self):
        self._compare(scan_depth=4)

    def test_hot_plug_on_mesh_requires_padding(self):
        from coherent_rtlsdr_tpu.parallel import make_mesh

        _, srv = self._frames(make_mesh(1, 2), 1, blocks=2)
        out = srv.dispatcher.dispatch("add SH_X")
        assert "requires --max-channels" in out

    def test_padded_hot_plug_on_mesh(self):
        from coherent_rtlsdr_tpu.parallel import make_mesh

        truth = make_truth(2, seed=22, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8,
                                    seed=22)
        cfg = PipelineConfig(n_channels=2, block_len=L)
        pub = FakePublisher()
        srv = CoherentServer(
            cfg, src, publisher=pub, control=FakeControl(),
            mesh=make_mesh(1, 2), max_channels=4,
        )
        assert srv.run(max_blocks=4) == 4
        assert "added" in srv.dispatcher.dispatch("add SH_Y")
        assert srv.run(max_blocks=4) == 4
        assert srv.n_jit_builds == 1  # padded: same sharded executable
        iq, seq, _ = pub.frames[-1]
        assert iq.shape == (4, L, 2)  # ref + 3 active channels
        assert "3 / 3" in srv.status().splitlines()[0]

    def test_fused_backend_on_mesh(self):
        """--mesh with the fused i8 backend (the multi-device
        configuration): flat byte layout through the sharded jits."""
        from coherent_rtlsdr_tpu.parallel import make_mesh

        Lf = 2048  # the fused engine needs a square fft_len (2L = 4096 = 64^2)
        truth = make_truth(2, seed=23, max_delay=20.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=Lf, slab_blocks=4,
                                    seed=23)
        cfg = PipelineConfig(n_channels=2, block_len=Lf, fft_impl="fused",
                             lag_method="phase_zoom")
        pub = FakePublisher()
        srv = CoherentServer(
            cfg, src, publisher=pub, control=FakeControl(),
            mesh=make_mesh(1, 2), scan_depth=2,
        )
        assert srv.run(max_blocks=4) == 4
        iq, seq, ph = pub.frames[-1]
        assert iq.shape == (3, Lf, 2) and iq.dtype == np.int8
        assert np.abs(np.asarray(srv.state.delay) - truth.delays).max() < 0.5
