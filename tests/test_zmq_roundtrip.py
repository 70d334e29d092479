"""Loopback tests across the ZMQ edge: publisher -> wire -> ZmqSource (the
network-fed device), exercising the czmqsdr capability end to end."""

import time

import numpy as np
import pytest

zmq = pytest.importorskip("zmq")

from coherent_rtlsdr_tpu.io.zmq_edge import ControlServer, FramePublisher
from coherent_rtlsdr_tpu.signal.sources import ZmqSource

PORT = 18555
CTRL_PORT = 18556


class TestZmqLoopback:
    def test_publisher_to_zmq_source(self):
        pub = FramePublisher(
            data_addr=f"tcp://127.0.0.1:{PORT}",
            debug_addr=f"tcp://127.0.0.1:{PORT+2}",
        )
        src = ZmqSource(f"tcp://127.0.0.1:{PORT}", timeout_ms=5000)
        time.sleep(0.3)  # PUB/SUB join

        rng = np.random.default_rng(0)
        # frame: ref channel + 3 signal channels
        iq = rng.integers(-128, 128, (4, 64, 2)).astype(np.int8)
        seqs = np.array([9, 10, 11, 12], np.uint32)
        pub.publish(iq, seqs)

        blk = src.next_block()
        assert blk is not None
        sig_u8, ref_u8, seqnums = blk
        assert sig_u8.shape == (3, 64, 2) and sig_u8.dtype == np.uint8
        assert ref_u8.shape == (64, 2)
        np.testing.assert_array_equal(seqnums, [10, 11, 12])
        # u8 offset-binary round trip of the int8 wire payload
        np.testing.assert_array_equal(
            sig_u8.astype(np.int16) - 128, iq[1:].astype(np.int16)
        )
        np.testing.assert_array_equal(
            ref_u8.astype(np.int16) - 128, iq[0].astype(np.int16)
        )

        src.close()
        pub.close()

    def test_zmq_source_timeout_returns_none(self):
        src = ZmqSource(f"tcp://127.0.0.1:{PORT+4}", timeout_ms=100)
        assert src.next_block() is None
        src.close()

    def test_raw_mode_publisher_to_zmq_source(self):
        """-R raw (header-less) loopback: the reference can PRODUCE this
        stream (main.cc:105,148-150); here it is also CONSUMABLE with
        explicit geometry, with seqnums synthesized from the rx counter."""
        pub = FramePublisher(
            data_addr=f"tcp://127.0.0.1:{PORT+6}",
            debug_addr=f"tcp://127.0.0.1:{PORT+8}",
            header=False,
        )
        src = ZmqSource(
            f"tcp://127.0.0.1:{PORT+6}", timeout_ms=5000,
            header=False, n_channels=4, block_len=64,
        )
        time.sleep(0.3)

        rng = np.random.default_rng(1)
        for k in range(2):
            iq = rng.integers(-128, 128, (4, 64, 2)).astype(np.int8)
            pub.publish(iq, np.arange(4, dtype=np.uint32))
            blk = src.next_block()
            assert blk is not None
            sig_u8, ref_u8, seqnums = blk
            assert sig_u8.shape == (3, 64, 2)
            np.testing.assert_array_equal(seqnums, [k + 1] * 3)
            np.testing.assert_array_equal(
                sig_u8.astype(np.int16) - 128, iq[1:].astype(np.int16)
            )
        src.close()
        pub.close()

    def test_raw_mode_requires_geometry(self):
        with pytest.raises(ValueError):
            ZmqSource(f"tcp://127.0.0.1:{PORT+10}", header=False)

    def test_control_server_poll(self):
        ctl = ControlServer(f"tcp://127.0.0.1:{CTRL_PORT}")
        ctx = zmq.Context.instance()
        dealer = ctx.socket(zmq.DEALER)
        dealer.setsockopt(zmq.RCVTIMEO, 5000)
        dealer.connect(f"tcp://127.0.0.1:{CTRL_PORT}")
        time.sleep(0.2)

        got = []
        dealer.send_string("status")
        dealer.send_string("request lag")
        time.sleep(0.2)
        n = ctl.poll(lambda s: (got.append(s), "ok")[1], timeout_ms=2000)
        assert n == 2 and got == ["status", "request lag"]
        assert dealer.recv().decode() == "ok"
        ctl.close()
        dealer.close(0)

    def test_control_server_survives_handler_exception(self):
        """A crashing command handler must not propagate out of poll()
        (killing the block loop) — the client gets an error reply and the
        next command is processed normally."""
        port = CTRL_PORT + 7
        ctl = ControlServer(f"tcp://127.0.0.1:{port}")
        ctx = zmq.Context.instance()
        dealer = ctx.socket(zmq.DEALER)
        dealer.setsockopt(zmq.RCVTIMEO, 5000)
        dealer.connect(f"tcp://127.0.0.1:{port}")
        time.sleep(0.2)

        def handler(s):
            if s == "boom":
                raise RuntimeError("handler blew up")
            return "ok"

        dealer.send_string("boom")
        dealer.send_string("status")
        time.sleep(0.2)
        n = ctl.poll(handler, timeout_ms=2000)
        assert n == 2
        assert dealer.recv().decode() == "error: handler blew up"
        assert dealer.recv().decode() == "ok"
        ctl.close()
        dealer.close(0)


class TestCoherentClient:
    """CoherentClient (io/client.py) — the CZMQSDR.m/zmqsdr.c analog —
    against live server sockets."""

    def test_read_and_control_roundtrip(self):
        import threading

        from coherent_rtlsdr_tpu.io.client import CoherentClient
        from coherent_rtlsdr_tpu.io.server import CoherentServer
        from coherent_rtlsdr_tpu.io.zmq_edge import ControlServer, FramePublisher
        from coherent_rtlsdr_tpu.pipeline import PipelineConfig
        from coherent_rtlsdr_tpu.signal import make_truth
        from coherent_rtlsdr_tpu.signal.sources import SyntheticStreamSource

        base = 18750
        L = 1024
        truth = make_truth(2, seed=31, max_delay=10.0, snr_db=30.0)
        src = SyntheticStreamSource(truth, block_len=L, slab_blocks=8, seed=31)
        srv = CoherentServer(
            PipelineConfig(n_channels=2, block_len=L), src,
            publisher=FramePublisher(
                data_addr=f"tcp://127.0.0.1:{base}",
                debug_addr=f"tcp://127.0.0.1:{base + 2}",
            ),
            control=ControlServer(f"tcp://127.0.0.1:{base + 1}"),
        )
        cli = CoherentClient(
            data_addr=f"tcp://127.0.0.1:{base}",
            ctrl_addr=f"tcp://127.0.0.1:{base + 1}",
            debug_addr=f"tcp://127.0.0.1:{base + 2}",
            timeout_ms=2000,
        )
        th = threading.Thread(target=lambda: srv.run(max_blocks=60),
                              daemon=True)
        th.start()
        try:
            f = cli.read()
            assert f is not None
            assert f.x.shape == (3, L) and f.x.dtype == np.complex64
            assert np.abs(f.x).max() <= 127 / 128 + 1e-6  # 1/128 scale
            assert f.seqnums.shape == (3,)
            f2 = cli.read()
            assert f2.globalseqn == f.globalseqn + 1
            ph = None
            for _ in range(10):
                ph = cli.read_phases()
                if ph is not None:
                    break
            assert ph is not None and ph.shape == (3,) and ph[0] == 1.0 + 0j

            cli.center_frequency = 868e6
            cli.refnoise_enabled = False
            cli.refnoise_enabled = True
            cli.request_sync()
            st = cli.status()
            assert "synchronized" in st
            with pytest.raises(ValueError):
                cli.center_frequency = 1e6  # below CZMQSDR.m's 24 MHz floor
            assert cli.command("quit") == "bye"
        finally:
            srv.request_exit()
            th.join(timeout=60)
            cli.close()
        assert srv.fcenter == 868e6
        assert srv.refnoise_enabled is True


class TestClientFcCache:
    """The cached center_frequency must track the ARRAY, not the request
    (round-5 review finding): a failed retune reply or a TIMEOUT from a
    server known to reply leaves the cache unchanged; silence from a
    server that has never replied (the reference binary) counts as
    success."""

    def _client(self, port, timeout_ms=300):
        from coherent_rtlsdr_tpu.io.client import CoherentClient

        return CoherentClient(
            data_addr=f"tcp://127.0.0.1:{port}",
            ctrl_addr=f"tcp://127.0.0.1:{port + 1}",
            timeout_ms=timeout_ms,
        )

    def test_silent_server_counts_as_success(self):
        import zmq

        ctx = zmq.Context.instance()
        router = ctx.socket(zmq.ROUTER)  # binds, never replies (reference)
        router.bind("tcp://127.0.0.1:18770")
        cli = self._client(18769)
        try:
            cli.center_frequency = 868e6
            assert cli.center_frequency == 868e6
        finally:
            cli.close()
            router.close(0)

    def test_timeout_after_known_replies_leaves_cache(self):
        import threading

        import zmq

        ctx = zmq.Context.instance()
        router = ctx.socket(zmq.ROUTER)
        router.bind("tcp://127.0.0.1:18772")
        router.setsockopt(zmq.RCVTIMEO, 5000)
        replies = [b"fcenter set to 868000000"]  # reply once, then go mute

        def serve():
            while True:
                try:
                    ident, msg = router.recv_multipart()
                except zmq.Again:
                    return
                if replies:
                    router.send_multipart([ident, replies.pop()])

        th = threading.Thread(target=serve, daemon=True)
        th.start()
        cli = self._client(18771)
        try:
            cli.center_frequency = 868e6       # replied: cached
            assert cli.center_frequency == 868e6
            cli.center_frequency = 900e6       # times out: outcome unknown
            assert cli.center_frequency == 868e6
        finally:
            cli.close()
            # the serve thread owns the socket until its recv times out:
            # closing it under a blocked recv aborts inside libzmq
            th.join(timeout=10)
            assert not th.is_alive()
            router.close(0)

    def test_first_command_timeout_then_late_failed_invalidates_cache(self):
        """The first-ever command has no proof the server replies, so a
        timeout is (optimistically) cached — but when the late 'FAILED'
        verdict arrives with the next command's drain, the cache must go
        to unknown rather than keep lying (round-5 review finding)."""
        import threading

        import zmq

        ctx = zmq.Context.instance()
        router = ctx.socket(zmq.ROUTER)
        router.bind("tcp://127.0.0.1:18776")
        router.setsockopt(zmq.RCVTIMEO, 10000)
        first_delay = [6.5]  # longer than the client's 5 s ctl floor

        def serve():
            for reply in (b"fcenter retune FAILED (rc=-1)", b"ok"):
                try:
                    ident, msg = router.recv_multipart()
                except zmq.Again:
                    return
                time.sleep(first_delay.pop(0) if first_delay else 0.0)
                router.send_multipart([ident, reply])

        th = threading.Thread(target=serve, daemon=True)
        th.start()
        cli = self._client(18775, timeout_ms=1000)
        try:
            cli.center_frequency = 900e6   # times out; optimistically cached
            assert cli.center_frequency == 900e6
            cli.command("status")          # drains the late FAILED verdict
            assert cli.center_frequency is None  # cache now unknown
        finally:
            cli.close()
            router.close(0)
            th.join(timeout=20)

    def test_failed_reply_leaves_cache(self):
        import threading

        import zmq

        ctx = zmq.Context.instance()
        router = ctx.socket(zmq.ROUTER)
        router.bind("tcp://127.0.0.1:18774")
        router.setsockopt(zmq.RCVTIMEO, 5000)
        replies = [b"fcenter set to 868000000",
                   b"fcenter retune FAILED (rc=-1); tuning restored"]

        def serve():
            for _ in range(2):
                try:
                    ident, msg = router.recv_multipart()
                except zmq.Again:
                    return
                router.send_multipart([ident, replies.pop(0)])

        th = threading.Thread(target=serve, daemon=True)
        th.start()
        cli = self._client(18773)
        try:
            cli.center_frequency = 868e6
            assert cli.center_frequency == 868e6
            cli.center_frequency = 900e6       # server says FAILED
            assert cli.center_frequency == 868e6
        finally:
            cli.close()
            # the serve thread owns the socket until its recv times out:
            # closing it under a blocked recv aborts inside libzmq
            th.join(timeout=10)
            assert not th.is_alive()
            router.close(0)


class TestMalformedFrames:
    """A hostile/buggy peer on the DATA port must not stop a consumer:
    truncated or geometry-lying frames are skipped, valid ones still
    arrive (unpack_frame validates hdr0 geometry against the byte count)."""

    def _pub_feed(self, port, payloads, stop):
        import threading

        pub = zmq.Context.instance().socket(zmq.PUB)
        pub.bind(f"tcp://127.0.0.1:{port}")

        def feeder():
            while not stop.is_set():
                for p in payloads:
                    pub.send(p)
                time.sleep(0.01)

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        return pub, th

    def test_unpack_frame_validates_geometry(self):
        from coherent_rtlsdr_tpu.io.wire import pack_frame, unpack_frame

        with pytest.raises(ValueError, match="too short"):
            unpack_frame(b"\x01" * 10)
        # header claims N=200 channels but carries 2 channels of payload
        good = pack_frame(
            7, np.arange(2, dtype=np.uint32), np.zeros((2, 64, 2), np.int8)
        )
        bad = bytearray(good)
        bad[4:8] = (200).to_bytes(4, "little")
        with pytest.raises(ValueError, match="geometry"):
            unpack_frame(bytes(bad))

    def test_zmq_source_skips_garbage(self):
        import threading

        from coherent_rtlsdr_tpu.io.wire import pack_frame
        from coherent_rtlsdr_tpu.signal.sources import ZmqSource

        port = 18770
        good = pack_frame(
            1, np.arange(3, dtype=np.uint32), np.zeros((3, 64, 2), np.int8)
        )
        stop = threading.Event()
        pub, th = self._pub_feed(
            port, [b"", b"\xde\xad\xbe\xef" * 5, good[:30], good], stop
        )
        try:
            src = ZmqSource(f"tcp://127.0.0.1:{port}", timeout_ms=5000)
            blk = src.next_block()
            assert blk is not None
            sig, ref, seqs = blk
            assert sig.shape == (2, 64, 2) and ref.shape == (64, 2)
            assert src.malformed >= 1
            src.close()
        finally:
            stop.set()
            th.join()
            pub.close(0)

    def test_client_skips_garbage(self):
        import threading

        from coherent_rtlsdr_tpu.io.client import CoherentClient
        from coherent_rtlsdr_tpu.io.wire import pack_frame

        port = 18771
        good = pack_frame(
            9, np.arange(2, dtype=np.uint32), np.zeros((2, 32, 2), np.int8)
        )
        stop = threading.Event()
        pub, th = self._pub_feed(port, [b"junk", good], stop)
        try:
            cli = CoherentClient(
                data_addr=f"tcp://127.0.0.1:{port}",
                ctrl_addr=f"tcp://127.0.0.1:{port + 1}",
                timeout_ms=2000, max_retries=20,
            )
            f = cli.read()
            assert f is not None and f.x.shape == (2, 32)
            assert cli.malformed >= 1
            cli.close()
        finally:
            stop.set()
            th.join()
            pub.close(0)
