"""Block sources for the streaming server: the device-capture layer
(crtlsdr/cbuffer, SURVEY.md §3.2) abstracted to "give me the next block of
every channel".

Sources yield ``(sig_u8 [N, L, 2], ref_u8 [L, 2], seqnums [N] uint32)``.
Seqnums mirror the reference's per-buffer ``readcnt`` (common.h:114-122);
the fault-injection hooks simulate the documented stale-buffer/drop failure
mode (README.md:42) so gap handling is testable — a capability the reference
lacks entirely.
"""

from typing import Iterator, Optional, Tuple

import numpy as np

Block = Tuple[np.ndarray, np.ndarray, np.ndarray]


class SyntheticStreamSource:
    """Streaming wrapper over the synthetic signal model.

    Generates the capture lazily in slabs of ``slab_blocks`` on the accel
    device, then serves blocks from host memory. ``drop_rate`` injects
    per-channel block drops (the stale-buffer failure: a channel misses one
    8192-sample buffer while others advance — README.md:42); dropped blocks
    repeat the previous block's samples and skip a seqnum.
    """

    def __init__(
        self,
        truth,
        block_len: int = 8192,
        slab_blocks: int = 16,
        seed: int = 0,
        drop_rate: float = 0.0,
        refnoise_enabled: bool = True,
    ):
        import jax

        from coherent_rtlsdr_tpu.signal.synth import synth_capture

        self._truth = truth
        self._L = block_len
        self._slab = slab_blocks
        self._seed = seed
        self._drop_rate = drop_rate
        self._rng = np.random.default_rng(seed + 1)
        self._synth = synth_capture
        self._jax = jax
        self._slab_idx = 0
        self._blk_in_slab = 0
        self._resume = None
        self._sig = None
        self._ref = None
        self._seqnums = np.zeros(len(truth.delays), np.uint32)
        self._prev: Optional[Block] = None
        self.refnoise_enabled = refnoise_enabled
        self.serials = [f"SYN {i}" for i in range(len(truth.delays))]

    # -- hot-plug (console add/del parity; console.cc:225-270) ----------

    @property
    def n_channels(self) -> int:
        return len(self._truth.delays)

    def add_channel(self, serial: str) -> int:
        """Append a new synthetic channel (deterministic truth from the
        serial); returns its index in the rx matrix."""
        import dataclasses
        import zlib

        # crc32, not hash(): str hashes are salted per process
        h = np.random.default_rng(zlib.crc32(serial.encode()))
        t = self._truth
        self._truth = dataclasses.replace(
            t,
            delays=np.append(t.delays, h.uniform(-40, 40)).astype(np.float32),
            phases=np.append(t.phases, h.uniform(-np.pi, np.pi)).astype(np.float32),
            gains=np.append(t.gains, h.uniform(0.7, 1.0)).astype(np.float32),
            ppm=np.append(t.ppm, 0.0).astype(np.float32),
        )
        self.serials.append(serial)
        self._seqnums = np.append(self._seqnums, 0).astype(np.uint32)
        self._invalidate_slab()
        return len(self.serials) - 1

    def del_channel(self, serial: str) -> Optional[int]:
        """Remove a channel by serial; returns its former index or None."""
        import dataclasses

        if serial not in self.serials:
            return None
        i = self.serials.index(serial)
        t = self._truth
        keep = np.arange(len(t.delays)) != i
        self._truth = dataclasses.replace(
            t,
            delays=t.delays[keep],
            phases=t.phases[keep],
            gains=t.gains[keep],
            ppm=t.ppm[keep],
        )
        self.serials.pop(i)
        self._seqnums = self._seqnums[keep]
        self._invalidate_slab()
        return i

    def _invalidate_slab(self):
        """Drop the rendered slab but remember the stream position: the
        ref timeline is a pure function of (seed, block index), so the
        regenerated slab resumes sample-exact where the old one stopped —
        hot-plug (console add/del) never disturbs surviving channels."""
        if self._sig is not None:
            self._resume = (self._slab_idx - 1, self._blk_in_slab)
        self._sig = None
        self._prev = None

    def _fill_slab(self):
        # Generate on the host CPU: the source stands in for host-side
        # hardware capture, and the accelerator only ever sees the jitted
        # pipeline (one process owns the card). synth_stream_slab keeps
        # consecutive slabs
        # sample-exact continuous (overlap-save windows span slab seams).
        from coherent_rtlsdr_tpu.signal.synth import synth_stream_slab

        slab_idx, offset = self._slab_idx, 0
        if self._resume is not None:
            slab_idx, offset = self._resume
            self._resume = None
            while offset >= self._slab:  # invalidated exactly at a slab seam
                slab_idx += 1
                offset -= self._slab
        cpu = self._jax.devices("cpu")[0]
        with self._jax.default_device(cpu):
            sig_u8, ref_u8 = synth_stream_slab(
                self._seed, self._truth, slab_idx, self._slab, self._L
            )
            self._sig = np.asarray(sig_u8)
            self._ref = np.asarray(ref_u8)
        self._slab_idx = slab_idx + 1
        self._blk_in_slab = offset

    def next_block(self) -> Block:
        if self._sig is None or self._blk_in_slab >= self._slab:
            self._fill_slab()
        sig = self._sig[self._blk_in_slab]
        ref = self._ref[self._blk_in_slab]
        self._blk_in_slab += 1

        n = sig.shape[0]
        self._seqnums = self._seqnums + 1
        if self._drop_rate > 0.0 and self._prev is not None:
            dropped = self._rng.random(n) < self._drop_rate
            if dropped.any():
                sig = sig.copy()
                sig[dropped] = self._prev[0][dropped]
                self._seqnums = self._seqnums + dropped.astype(np.uint32)
        out = (sig, ref, self._seqnums.copy())
        self._prev = out
        return out


class ZmqSource:
    """Network-fed block source: subscribes to a reference-wire-format frame
    stream and re-serves it as capture blocks — the intent of the
    reference's empty ``czmqsdr`` stub (include/csdrdevice.h:270-272),
    realized. Lets one alignment server chain off another's output, or a
    remote host feed raw dongle captures to the pipeline host over the network.

    Channel 0 of the frame is the reference. With ``header=False`` the
    stream is the reference's raw ``-R`` mode (header-less frames,
    main.cc:105,148-150) and the geometry must be given explicitly; seqnums
    are then synthesized from the receive counter (raw mode has none on the
    wire). Returns None on receive timeout.
    """

    def __init__(
        self,
        address: str,
        timeout_ms: int = 30000,
        header: bool = True,
        n_channels: Optional[int] = None,
        block_len: Optional[int] = None,
    ):
        import zmq

        if not header and (n_channels is None or block_len is None):
            raise ValueError(
                "raw (header-less) streams need explicit n_channels/block_len "
                "(the -R wire carries no hdr0, main.cc:148-150)"
            )
        self._ctx = zmq.Context.instance()
        self._sub = self._ctx.socket(zmq.SUB)
        self._sub.setsockopt(zmq.SUBSCRIBE, b"")
        self._sub.setsockopt(zmq.RCVTIMEO, timeout_ms)
        self._sub.connect(address)
        self._header = header
        self._n = n_channels  # INCLUDING the reference channel
        self._L = block_len
        self._rx_count = np.uint32(0)
        self.refnoise_enabled = True

    def next_block(self) -> Optional[Block]:
        import zmq

        from coherent_rtlsdr_tpu.io.wire import unpack_frame

        while True:
            try:
                buf = self._sub.recv()
            except zmq.Again:
                return None
            try:
                f = unpack_frame(
                    buf, header=self._header, n_channels=self._n,
                    block_len=self._L,
                )
                break
            except ValueError:
                # malformed/truncated network frame: skip it — one bad
                # peer message must not stop a chained server (the loop
                # treats a None source result as end-of-stream)
                self.malformed = getattr(self, "malformed", 0) + 1
                continue
        u8 = (f.iq.astype(np.int16) + 128).astype(np.uint8)
        self._rx_count = np.uint32(self._rx_count + np.uint32(1))
        if self._header:
            seqs = f.seqnums[1:].astype(np.uint32)
        else:
            seqs = np.full(u8.shape[0] - 1, self._rx_count, np.uint32)
        return u8[1:], u8[0], seqs

    def close(self):
        self._sub.close(0)


class RingSource:
    """Blocks from the native C++ SPSC ring (coherent_rtlsdr_tpu.native).

    The production ingest path: a capture producer (C++ USB reader thread,
    file reader, or network receiver) pushes raw blocks into the ring; the
    pipeline pops them here. Block layout in the ring: ref block first,
    then N signal channels, uint8 interleaved IQ — one slot per time block.

    A per-channel ring (``n_seq > 1``, the rtlsdr capture path) carries one
    capture-order seqnum per channel — the reference's per-device ``readcnt``
    (src/crtlsdr.cc:181-188, cpacketizer.cc:142) — so a single dongle's FIFO
    drop gaps exactly that channel downstream. A frame-level ring (``n_seq
    == 1``: file replay / network ingest) replicates the slot seqnum across
    channels; a full ring then drops whole frames, which downstream sees as
    frame-level gaps, matching the reference's failure mode.
    """

    def __init__(self, ring, n_channels: int, block_len: int, timeout_ms: int = 5000):
        self._ring = ring
        self._n = n_channels
        self._L = block_len
        self._timeout = timeout_ms
        self.refnoise_enabled = True

    def next_block(self) -> Optional[Block]:
        if getattr(self._ring, "n_seq", 1) > 1:
            out = self._ring.pop_n(timeout_ms=self._timeout)
            if out is None:
                return None
            buf, seqs64, _ts = out
            n_cap = self._ring.n_seq  # capacity incl. ref (may exceed active)
            frame = buf.reshape(n_cap, self._L, 2)
            seqs = seqs64[1 : 1 + self._n].astype(np.uint32)
            return frame[1 : 1 + self._n], frame[0], seqs
        out = self._ring.pop(timeout_ms=self._timeout)
        if out is None:
            return None
        buf, seqnum, _ts = out
        frame = buf.reshape(self._n + 1, self._L, 2)
        seqs = np.full(self._n, seqnum, np.uint32)
        return frame[1:], frame[0], seqs

    def drain(self) -> int:
        """Discard every buffered block (stale channel layout after a
        hot add/del); returns how many were thrown away."""
        n = 0
        while self._ring.pop(timeout_ms=0) is not None:
            n += 1
        return n


class RtlSource(RingSource):
    """The real-hardware source: owns the :class:`NativeRtlCapture` handle
    and routes the console's runtime mutations to the dongles — the last
    link the reference wires in console.cc:156-270 (``fcenter``/``fs``
    retune every device, ``add``/``del`` hot-plug a running one).

    Construct via :meth:`start`, which creates the per-channel ring
    (capacity ``max_channels``), starts the barrier-released capture, and
    binds them. ``serials`` here are SIGNAL channels only (the console's
    rx-matrix rows); the reference dongle is ``ref_serial``.
    """

    def __init__(self, ring, capture, block_len: int, timeout_ms: int = 5000):
        super().__init__(
            ring, n_channels=len(capture.serials) - 1, block_len=block_len,
            timeout_ms=timeout_ms,
        )
        self.capture = capture

    @classmethod
    def start(
        cls,
        serials,
        block_len: int,
        ring_slots: int = 16,
        max_channels: Optional[int] = None,
        timeout_ms: int = 5000,
        **capture_kw,
    ) -> "RtlSource":
        from coherent_rtlsdr_tpu import native

        cap_n = (max_channels if max_channels is not None else len(serials) - 1) + 1
        if cap_n < len(serials):
            raise ValueError("max_channels below the starting channel count")
        ring = native.NativeBlockRing(
            ring_slots, cap_n * 2 * block_len, n_seq=cap_n
        )
        capture = native.NativeRtlCapture(
            ring, serials, block_len=block_len, **capture_kw
        )
        return cls(ring, capture, block_len, timeout_ms=timeout_ms)

    # -- console-facing surface (io/server.py duck-type) -----------------

    @property
    def serials(self):
        return self.capture.serials[1:]

    @serials.setter
    def serials(self, _v):  # the capture owns the truth; ignore assignments
        pass

    @property
    def ref_serial(self) -> str:
        return self.capture.serials[0]

    def set_fcenter(self, hz: float) -> int:
        return self.capture.set_fcenter(hz)

    def set_fs(self, hz: float) -> int:
        rc = self.capture.set_fs(hz)
        self.drain()  # FIFOs were flushed; buffered frames are stale-rate
        return rc

    def add_channel(self, serial: str, gain_db=None) -> int:
        """Hot-add a dongle as a new signal channel; returns its signal-row
        index. Raises RuntimeError when the open fails (bad serial, no slot)."""
        rc = self.capture.add(serial, gain_db=gain_db)
        if rc < 0:
            raise RuntimeError(f"add '{serial}' failed (rc={rc})")
        self._n = rc  # capture index rc == new signal count (ref is 0)
        self.drain()  # buffered frames predate the new channel layout
        return rc - 1

    def del_channel(self, serial: str) -> Optional[int]:
        if serial == self.ref_serial:
            return None  # the reference channel defines the timebase
        rc = self.capture.remove(serial)
        if rc < 0:
            return None
        self._n -= 1
        self.drain()  # buffered frames still carry the old row layout
        return rc - 1

    def stop(self):
        self.capture.stop()


class FileSource:
    """Replays a recorded capture (io/streamio.py), optionally looping."""

    def __init__(self, capture, loop: bool = False):
        self._cap = capture
        self._loop = loop
        self._t = 0

    def next_block(self) -> Optional[Block]:
        if self._t >= self._cap.n_blocks:
            if not self._loop:
                return None
            self._t = 0
        t = self._t
        self._t += 1
        return (
            self._cap.sig_u8[t],
            self._cap.ref_u8[t],
            self._cap.seqnums[t].astype(np.uint32),
        )
