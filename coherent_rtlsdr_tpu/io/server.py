"""The streaming server: source -> pipeline step -> ZMQ publish, with the
console/remote control plane — the whole of the reference's main()
orchestration (src/main.cc:162-317) and console (src/console.cc) as one
deterministic loop instead of nine threads.

Loop per block (cf. ccoherent::threadf, ccoherent.cc:245-294):
  1. pull next block from the source (device capture / file / synthetic)
  2. run the jitted step (measure + control + correct + phase)
  3. requantize on-device, fetch the int8 frame, publish on :5555/:5557
  4. drain the control socket; apply console commands

Calibration state persists across restarts (checkpoint/resume — absent in
the reference, SURVEY.md §5: "a restart requires full re-sync").
"""

import json
import logging
import os
import time
from typing import Optional

import numpy as np

from coherent_rtlsdr_tpu import constants
from coherent_rtlsdr_tpu.io.console import ConsoleDispatcher
from coherent_rtlsdr_tpu.pipeline.state import (
    TELEMETRY_COLS,
    PipelineConfig,
    PipelineState,
    pack_state_host,
    unpack_state_host,
)
from coherent_rtlsdr_tpu.utils.telemetry import TelemetryRecorder

logger = logging.getLogger("coherent_rtlsdr_tpu")

# packed-telemetry column index map (pipeline/state.TELEMETRY_COLS order)
_TCOL = {name: j for j, name in enumerate(TELEMETRY_COLS)}


class _LogRing(logging.Handler):
    """Captures the framework's log records into the console ``log``
    command's drain list — the analog of the reference's librtlsdr
    stderr-pipe capture (main.cc:63-70) drained by console.cc:422-427."""

    def __init__(self, lines: list, maxlen: int = 1000):
        super().__init__(level=logging.INFO)
        self._lines = lines
        self._maxlen = maxlen

    def emit(self, record: logging.LogRecord) -> None:
        self._lines.append(self.format(record))
        if len(self._lines) > self._maxlen:
            del self._lines[: len(self._lines) - self._maxlen]


def _make_publisher(data_addr: str, debug_addr: str, header: bool):
    """Prefer the native C++ packetizer/publisher (zero Python in the frame
    assembly + send path); fall back to the pyzmq implementation."""
    try:
        from coherent_rtlsdr_tpu import native

        if native.available():
            return native.NativePublisher(
                data_addr.replace("*", "0.0.0.0"), debug_addr.replace("*", "0.0.0.0"),
                header=header,
            )
    except Exception:
        pass
    from coherent_rtlsdr_tpu.io.zmq_edge import FramePublisher

    return FramePublisher(data_addr=data_addr, debug_addr=debug_addr, header=header)


class CoherentServer:
    def __init__(
        self,
        cfg: PipelineConfig,
        source,
        fcenter: float = constants.DEFAULT_FCENTER,
        data_addr: str = "tcp://*:5555",
        ctrl_addr: str = "tcp://*:5556",
        debug_addr: str = "tcp://*:5557",
        header: bool = True,
        refnoise_enabled: bool = True,
        state_path: Optional[str] = None,
        publisher=None,
        control=None,
        scan_depth: int = 1,
        max_channels: Optional[int] = None,
        mesh=None,
    ):
        import dataclasses

        import jax
        import jax.numpy as jnp

        from coherent_rtlsdr_tpu.ops.convert import c64_to_i8_iq
        from coherent_rtlsdr_tpu.pipeline import init_state, step

        self._jax = jax
        self._jnp = jnp
        # Hot-plug without recompile: when ``max_channels`` is set, the jit
        # processes a fixed-width [max_channels] state and console add/del
        # only move host-side rows — no new executable, no mid-stream compile
        # stall (the reference hot-plugs threads, console.cc:225-270; we
        # hot-plug rows). Inactive rows carry synthetic u8-zero blocks and
        # are sliced off every frame/status/telemetry view.
        self.n_active = cfg.n_channels
        self.max_channels = max_channels
        if max_channels is not None:
            if max_channels < cfg.n_channels:
                raise ValueError("max_channels < n_channels")
            cfg = dataclasses.replace(cfg, n_channels=max_channels)
        self.n_jit_builds = 0
        self._blocks_done = 0
        self.cfg = cfg
        self.source = source
        self.fs = cfg.fs
        self.fcenter = fcenter
        self.refnoise_enabled = refnoise_enabled
        self.state_path = state_path
        self._do_exit = False
        self._resync_requested = False
        self._log_lines = []
        self._log_handler = _LogRing(self._log_lines)
        self._log_handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        )
        logger.addHandler(self._log_handler)
        logger.setLevel(logging.INFO)
        self.telemetry = TelemetryRecorder()
        self._local_lines = None  # stdin queue when interactive (see run_interactive)
        # optional io.hwcontrol.HwDriftRelief (rtlsdr source): ticked per
        # loop iteration with the applied numerical delays
        self.hw_relief = None
        self._hw_relief_next = 0.0

        if publisher is None:
            publisher = _make_publisher(data_addr, debug_addr, header)
        if control is None:
            from coherent_rtlsdr_tpu.io.zmq_edge import ControlServer

            control = ControlServer(ctrl_addr)
        self.publisher = publisher
        self.control = control
        self.dispatcher = ConsoleDispatcher(self)

        self.scan_depth = int(scan_depth)
        # multi-device serving: a jax.sharding.Mesh with a `channel` axis
        # shards the per-channel DSP across devices (docs/SCALING.md);
        # everything else in the loop is unchanged
        self.mesh = mesh
        # fused impl: ship bytes FLAT ([N, 2L]), its wire layout
        self._flat = cfg.fft_impl == "fused"
        self._build_jits(cfg)
        self.state = init_state(cfg)
        if state_path and os.path.exists(state_path):
            self.restore_state(state_path)

    # ---- pipeline state storage -----------------------------------------
    # The unsharded hot loop carries the PACKED state triple (three tensors
    # instead of 11 leaves; pipeline/state.pack_state). `state` is
    # the PipelineState VIEW for the rare host touchpoints (status,
    # checkpoint, hot-plug, tests); reading it fetches the packed tensors,
    # assigning it repacks. The sharded (mesh) path carries the plain
    # PipelineState — its leaves need per-leaf partition specs.

    @property
    def state(self) -> PipelineState:
        if self._packed:
            return unpack_state_host(*self._st)
        return self._st

    @state.setter
    def state(self, s: PipelineState) -> None:
        if self._packed:
            self._st = pack_state_host(s)
        else:
            self._st = s

    def _delays_host(self) -> np.ndarray:
        """Applied per-channel delays, fetching ONLY the small packed
        tensor (the hw-relief tick runs at 4 Hz — never pull the hist
        planes for it)."""
        if self._packed:
            return np.asarray(self._st[0])[:, 0]
        return np.asarray(self._st.delay)

    def _block_idx_host(self) -> int:
        if self._packed:
            return int(np.asarray(self._st[1])[0, 3])
        return int(np.asarray(self._st.block_idx))

    def capture_stderr(self) -> None:
        """-q mode: redirect OS-level stderr (fd 2) into the console ``log``
        drain — the reference's redir_stderr (main.cc:63-70): native
        librtlsdr writes from capture threads land in the same ring the
        ``log`` command empties (console.cc:422-427). fd-level dup2, so C++
        producer threads are captured too, not just Python logging."""
        import threading

        r, w = os.pipe()
        self._stderr_saved = os.dup(2)
        os.dup2(w, 2)
        os.close(w)

        def drain():
            with os.fdopen(r, "r", errors="replace") as f:
                for line in f:
                    line = line.rstrip()
                    if line:
                        self._log_lines.append(line)
                        if len(self._log_lines) > 1000:
                            del self._log_lines[: len(self._log_lines) - 1000]

        threading.Thread(target=drain, daemon=True).start()

    def _build_jits(self, cfg: PipelineConfig) -> None:
        # Both jit families emit int8 wire blocks + telemetry packed into
        # ONE [.., N, 10] tensor (the worker fetches one array per batch).
        # The unsharded path additionally packs the carried STATE to three
        # tensors (pipeline/state.pack_state).
        self.cfg = cfg
        self.n_jit_builds += 1
        if self.mesh is not None:
            from coherent_rtlsdr_tpu.parallel.sharded import (
                make_sharded_server_jits,
            )

            self._packed = False
            self._step, self._scan = make_sharded_server_jits(
                cfg, self.mesh, scan_depth=self.scan_depth
            )
            return
        from coherent_rtlsdr_tpu.pipeline.drivers import (
            make_packed_scan_runner,
            make_packed_step,
        )

        self._packed = True
        self._step = make_packed_step(cfg, donate=True)
        self._scan = (
            make_packed_scan_runner(cfg, donate=True)
            if self.scan_depth > 1 else None
        )

    # ---- channel padding (hot-plug without recompile) --------------------

    def _padded(self, sig_u8: np.ndarray, seqs: np.ndarray):
        """Pad a source block up to the jit width. Inactive rows get u8-zero
        samples and contiguous synthetic seqnums (no phantom gaps)."""
        n_jit = self.cfg.n_channels
        n = sig_u8.shape[0]
        if n == n_jit:
            return sig_u8, seqs.astype(np.uint32)
        sp = np.full((n_jit,) + sig_u8.shape[1:], 128, np.uint8)
        sp[:n] = sig_u8
        sq = np.empty(n_jit, np.uint32)
        sq[:n] = seqs
        sq[n:] = np.uint32(self._blocks_done + 1)
        return sp, sq

    # ---- channel hot-plug (console add/del; console.cc:225-270) ---------

    def _resize_channels(self, row_map) -> None:
        """Re-map channel rows for a new channel set. ``row_map[i]`` is the
        old row feeding new row i, or -1 for a fresh (unsynced) channel.
        Surviving channels keep their calibration — no re-sync.

        With ``max_channels`` set the jit width never changes: rows are
        permuted host-side and the SAME compiled executable keeps running
        (no recompile stall; the reference's add/del spawns/kills threads,
        console.cc:225-270). Otherwise config/state/jits are rebuilt."""
        import dataclasses

        from coherent_rtlsdr_tpu.pipeline import init_state

        jnp = self._jnp
        old_state = self.state
        padded = self.max_channels is not None
        if padded:
            new_cfg = self.cfg  # fixed jit width
            full_map = list(row_map) + [-1] * (self.cfg.n_channels - len(row_map))
        else:
            new_cfg = dataclasses.replace(self.cfg, n_channels=len(row_map))
            full_map = list(row_map)
        new_state = init_state(new_cfg)
        updates = {}
        for name in (
            "delay", "phase", "lag", "mag", "papr", "synced", "hist",
            "last_seq", "gaps",
        ):
            old_leaf = np.asarray(getattr(old_state, name))
            new_leaf = np.asarray(getattr(new_state, name)).copy()
            for newi, oldi in enumerate(full_map):
                if 0 <= oldi < old_leaf.shape[0]:
                    new_leaf[newi] = old_leaf[oldi]
            updates[name] = jnp.asarray(new_leaf)
        self.state = new_state.replace(
            ref_hist=old_state.ref_hist,
            block_idx=old_state.block_idx,
            **updates,
        )
        self.n_active = len(row_map)
        # per-channel telemetry series change width across a resize; mixed
        # shapes cannot stack (status crashed on drift stats — r4 soak)
        self.telemetry.clear()
        if not padded:
            self._build_jits(new_cfg)

    # ---- calibration checkpoint / resume ---------------------------------

    def save_state(self, path: Optional[str] = None) -> None:
        """Persist calibration (delays, phases, sync) — restart without
        re-sync. (hist buffers are transient and reset to zero.)"""
        path = path or self.state_path
        if not path:
            return
        s = self.state
        np.savez(
            path,
            delay=np.asarray(s.delay),
            phase_iq=np.asarray(s.phase),  # [N, 2] float pairs
            synced=np.asarray(s.synced),
            block_idx=np.asarray(s.block_idx),
            fs=np.float64(self.fs),
            fcenter=np.float64(self.fcenter),
        )

    def restore_state(self, path: str) -> None:
        z = np.load(path)
        jnp = self._jnp
        self.state = self.state.replace(
            delay=jnp.asarray(z["delay"]),
            phase=jnp.asarray(z["phase_iq"].astype(np.float32)),
            synced=jnp.asarray(z["synced"]),
            block_idx=jnp.asarray(z["block_idx"]),
        )
        self.fs = float(z["fs"])
        self.fcenter = float(z["fcenter"])

    # ---- main loop -------------------------------------------------------

    def run(self, max_blocks: Optional[int] = None) -> int:
        """Returns the number of blocks published.

        With ``scan_depth > 1`` the loop gathers that many source blocks and
        runs them through one lax.scan dispatch (pipeline/drivers.py) —
        amortizing device round-trip latency.

        Publishing is PIPELINED: batch k's int8 outputs are fetched from
        the device and ZMQ-published by a worker thread while the main
        thread gathers/uploads/dispatches batch k+1 — the reference's
        double-buffered packetizer handoff (its DSP thread write()s one
        buffer while the publisher thread send()s the other,
        cpacketizer.cc:109-185). A single worker draining a FIFO queue
        preserves frame order; the queue bound caps device-resident output
        batches. On the way in, the upload of batch k+1 overlaps the
        worker's fetch of batch k (the two host<->device directions
        pipeline), which matters on every transport (PCIe included).
        """
        import queue as _queue
        import threading

        jnp = self._jnp
        # ref-channel wire seqnum base: blocks processed so far (the state's
        # block_idx, fetched ONCE — per-frame fetches would serialize the
        # pipeline on a device sync)
        base = self._block_idx_host()
        pubq: _queue.Queue = _queue.Queue(maxsize=2)
        pub_err = []
        published = [0]

        def pub_worker():
            while True:
                item = pubq.get()
                if item is None:
                    return
                try:
                    published[0] += self._publish_batch(**item)
                except Exception as e:
                    pub_err.append(e)
                    return

        worker = threading.Thread(
            target=pub_worker, name="publisher", daemon=True
        )
        worker.start()

        def qput(item) -> bool:
            # bounded put that can't deadlock against a worker that died
            # mid-publish (its error is re-raised after the loop)
            while not pub_err:
                try:
                    pubq.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        dispatched = 0
        gate_cache = (None, None)
        try:
            while not self._do_exit and not pub_err:
                if max_blocks is not None and dispatched >= max_blocks:
                    break

                if self._resync_requested:
                    self.state = self.state.replace(
                        synced=jnp.zeros_like(self.state.synced)
                    )
                    self._resync_requested = False

                # cache the gate scalar per value: a fresh jnp.array
                # per iteration is a per-batch host->device upload
                if gate_cache[0] != self.refnoise_enabled:
                    gate_cache = (self.refnoise_enabled,
                                  jnp.array(self.refnoise_enabled))
                gate = gate_cache[1]
                k = 1
                if self._scan is not None:
                    k = self.scan_depth
                    if max_blocks is not None:
                        k = min(k, max_blocks - dispatched)
                blocks = []
                for _ in range(k):
                    blk = self.source.next_block()
                    if blk is None:
                        break
                    blocks.append(blk)
                if not blocks:
                    break

                na = self.n_active
                n_jit = self.cfg.n_channels
                if self._scan is not None and len(blocks) > 1:
                    padded = [self._padded(b[0], b[2]) for b in blocks]
                    # synthetic seqnums for pad rows advance per block in the
                    # micro-batch so inactive rows never see phantom gaps
                    for i, (sp, sq) in enumerate(padded):
                        sq[na:] = np.uint32(self._blocks_done + i + 1)
                    sigs = np.stack([p[0] for p in padded])
                    refs = np.stack([b[1] for b in blocks])
                    if self._flat:
                        sigs = sigs.reshape(len(blocks), n_jit, -1)
                        refs = refs.reshape(len(blocks), -1)
                    sigs = jnp.asarray(sigs)
                    refs = jnp.asarray(refs)
                    seqs = jnp.asarray(np.stack([p[1] for p in padded]))
                    self._st, (wire_sigs, wire_refs), telem = self._scan(
                        self._st, sigs, refs, gate, seqs
                    )
                    if not qput(dict(
                        wire_sigs=wire_sigs, wire_refs=wire_refs, telem=telem,
                        seqnums=[b[2] for b in blocks], na=na, base=base,
                        n_jit=n_jit, L=self.cfg.block_len,
                    )):
                        break
                else:
                    enqueued = 0
                    for j, (sig_u8, ref_u8, seqnums) in enumerate(blocks):
                        sp, sq = self._padded(sig_u8, seqnums)
                        if self._flat:
                            sp = sp.reshape(n_jit, -1)
                            ref_u8 = np.asarray(ref_u8).reshape(-1)
                        self._st, wire_sig, wire_ref, telem = self._step(
                            self._st, jnp.asarray(sp), jnp.asarray(ref_u8),
                            gate, jnp.asarray(sq),
                        )
                        if not qput(dict(
                            wire_sigs=wire_sig, wire_refs=wire_ref,
                            telem=telem, seqnums=[seqnums], na=na,
                            base=base + j, n_jit=n_jit,
                            L=self.cfg.block_len,
                        )):
                            break
                        enqueued += 1
                    if enqueued < len(blocks):
                        # publisher died mid-batch: count only what was
                        # actually enqueued, then exit on pub_err
                        base += enqueued
                        dispatched += enqueued
                        self._blocks_done += enqueued
                        break
                base += len(blocks)
                dispatched += len(blocks)
                self._blocks_done += len(blocks)
                self._poll_control()
                if self.hw_relief is not None:
                    # fetching state.delay syncs on the dispatch in flight —
                    # rate-limit it (hardware relief acts on second scales)
                    now = time.monotonic()
                    if now >= self._hw_relief_next:
                        self._hw_relief_next = now + 0.25
                        self.hw_relief.tick(
                            self._delays_host()[: self.n_active]
                        )
        finally:
            if pub_err:
                pubq.queue.clear()  # worker is gone; nothing drains these
            pubq.put(None)
            worker.join()
            # cleanup runs even when the loop died (device error, source
            # exception): skewed dongles are restored and calibration is
            # persisted — a crash must not cost the array its sync state
            if self.hw_relief is not None:
                try:
                    self.hw_relief.stop()
                except Exception:
                    logger.exception("dongle restore failed on exit")
            if self.state_path:
                try:
                    self.save_state()
                except Exception:
                    logger.exception("calibration save failed on exit")
        if pub_err:
            raise pub_err[0]
        return published[0]

    def _publish_batch(
        self, wire_sigs, wire_refs, telem, seqnums, na, base, n_jit, L
    ) -> int:
        """Fetch one dispatched batch's int8 outputs and publish every
        frame (runs on the publisher worker thread). Frame layout: channel
        0 = reference (cpacketizer write order, ccoherent.cc:253); phases
        go out on the debug port. ``telem`` arrives as the packed
        [.., N, 10] tensor (state.TELEMETRY_COLS) — one fetch. Returns
        frames published."""
        T = len(seqnums)
        ws = np.asarray(wire_sigs).reshape(T, n_jit, L, 2)
        wr = np.asarray(wire_refs).reshape(T, L, 2)
        tp = np.asarray(telem, np.float32).reshape(T, n_jit, len(_TCOL))
        col = _TCOL
        for i, seq in enumerate(seqnums):
            frame = np.concatenate([wr[i][None], ws[i][:na]], axis=0)
            ref_seq = np.asarray([base + i + 1], np.uint32)
            all_seq = np.concatenate([ref_seq, seq.astype(np.uint32)])
            phases = np.concatenate([
                np.ones(1, np.complex64),
                (tp[i, :na, col["phase_re"]]
                 + 1j * tp[i, :na, col["phase_im"]]).astype(np.complex64),
            ])
            self.publisher.publish(frame, all_seq, phases)
            self._record_block(
                phases[1:], tp[i, :na, col["lag"]],
                tp[i, :na, col["residual"]], tp[i, :na, col["mag"]],
                tp[i, :na, col["gap"]] > 0, block_idx=base + i + 1,
            )
        return T

    def _record_block(self, phases, lag, residual, mag, gap,
                      block_idx: int = -1) -> None:
        """Per-block observability: telemetry ring + gap-event log lines.
        Runs on the publisher worker; must not touch self.state (a device
        fetch there would serialize the publish pipeline on the dispatch
        in flight)."""
        self.telemetry.record(phase=phases, lag=lag, residual=residual, mag=mag)
        if gap.any():
            chans = np.nonzero(gap)[0]
            logger.warning(
                "seqnum gap on channel(s) %s at block %d — desynced",
                ",".join(str(int(c)) for c in chans), block_idx,
            )

    def _poll_control(self) -> None:
        """Drain the remote control socket and, when interactive, the local
        stdin console (the reference runs both feeding one queue,
        console.cc:38-81,371-374)."""
        self.control.poll(self.dispatcher.dispatch)
        q = self._local_lines
        if q is not None:
            while True:
                try:
                    line = q.get_nowait()
                except Exception:
                    break
                try:
                    out = self.dispatcher.dispatch(line)
                except Exception as e:  # never kill the loop on a command
                    out = f"error: {e}"
                if out:
                    print(out, flush=True)

    # ---- console controller protocol ------------------------------------

    def get_fs(self):
        return self.fs

    def set_fs(self, v):
        """Retune the sample rate: rebuild the pipeline config (fs is a
        static config field), push the rate to the source (the reference
        retunes every dongle, console.cc:156-175), and force a full resync
        (console.cc:168). State (calibration) survives — only sync flags
        drop, exactly like the reference's behavior."""
        import dataclasses

        old_fs = self.fs
        if hasattr(self.source, "set_fs"):
            rc = self.source.set_fs(float(v))
            if rc is not None and rc != 0:
                # a dongle refused: put every healthy one back on the old
                # rate (mixed-rate arrays are incoherent) and keep config
                logger.warning(
                    "source fs change to %.0f failed (rc=%s); restoring %.0f",
                    float(v), rc, old_fs,
                )
                self.source.set_fs(old_fs)
                self.request_sync()
                return False
        self.fs = float(v)
        self.cfg = dataclasses.replace(self.cfg, fs=float(v))
        self._build_jits(self.cfg)
        self.request_sync()  # fs change forces resync (console.cc:168)
        return True

    def get_fcenter(self):
        return self.fcenter

    def set_fcenter(self, v):
        if hasattr(self.source, "set_fcenter"):
            rc = self.source.set_fcenter(v)
            if rc is not None and rc != 0:
                # a dongle refused: put every healthy one back on the old
                # tuning (a mixed-frequency array observes different
                # spectra = incoherent), mirroring set_fs
                logger.warning(
                    "source retune to %.0f failed (rc=%s); restoring %.0f",
                    float(v), rc, self.fcenter,
                )
                self.source.set_fcenter(self.fcenter)
                return False
        self.fcenter = v
        return True

    def status(self) -> str:
        s = self.state
        na = self.n_active
        synced = np.asarray(s.synced)[:na]
        lag = np.asarray(s.lag)[:na]
        mag = np.asarray(s.mag)[:na]
        gaps = np.asarray(s.gaps)[:na]
        lines = [f"{int(synced.sum())} / {len(synced)} synchronized"]
        lines.append(
            "Reference noise ENABLED."
            if self.refnoise_enabled
            else "Reference noise DISABLED."
        )
        # Live observability (absent in the reference, SURVEY.md §5): block
        # rate / latency from the rolling timer, cumulative seqnum gaps, and
        # the phasecorrectionplot.m drift metric as a number.
        t = self.telemetry
        bps = t.timer.blocks_per_s()
        if bps == bps:  # not NaN
            lines.append(
                f"blocks/s: {bps:.1f}  mean block latency: "
                f"{t.timer.mean_dt * 1e3:.2f} ms  "
                f"throughput: {bps * len(synced) * self.cfg.block_len / 1e6:.3g} Msamp/s"
            )
        drift = t.phase_drift_deg_rms()
        if drift == drift:
            lines.append(
                f"phase drift: {drift:.2f} deg RMS over "
                f"{t.n_recorded('phase')} blocks"
            )
        lines.append(f"seqnum gaps: {int(gaps.sum())} total")
        cap = getattr(self.source, "capture", None)
        if cap is not None:  # rtlsdr source: native capture health counters
            lines.append(
                f"capture: {'RUNNING' if cap.running else 'STOPPED'}  "
                f"frames {cap.pushed}  chan-drops {cap.dropped}  "
                f"stalls {cap.stalls}"
            )
        cells = [
            f"ch{i}:{lag[i]:+4.3f}:{mag[i]:4.3f}" for i in range(len(synced))
        ]
        for i in range(0, len(cells), 6):  # 6 devices per line (console.cc:327)
            lines.append("\t".join(cells[i : i + 6]))
        return "\n".join(lines)

    def list_channels(self, all=False) -> str:
        """`list` = capturing channels; `list all` adds the full USB dongle
        inventory when librtlsdr is loaded (console.cc:203-223 parity)."""
        n = self.n_active
        lines = [f"{n} signal channels + ref"]
        serials = getattr(self.source, "serials", None)
        if serials and all:
            lines[0] += ":"
            lines += [f"  ch{i + 1}: '{s}'" for i, s in enumerate(serials)]
        if all:
            try:
                from coherent_rtlsdr_tpu import native

                if native.available() and native.rtlsdr_available():
                    inv = native.rtlsdr_enumerate()
                    lines.append(f"USB inventory ({len(inv)} dongles):")
                    lines += [f"  #{i}: '{s}'" for i, s in enumerate(inv)]
            except Exception:
                pass
        return "\n".join(lines)

    def phase_table(self) -> str:
        ph = np.degrees(
            np.angle(np.asarray(self._fetch_phases_state())[: self.n_active])
        )
        return "\t".join(str(int(p)) for p in ph)

    def _fetch_phases_state(self):
        p = np.asarray(self.state.phase, np.float32)  # [N, 2]
        return (p[..., 0] + 1j * p[..., 1]).astype(np.complex64)

    def set_refnoise(self, v: bool):
        self.refnoise_enabled = bool(v)
        if hasattr(self.source, "refnoise_enabled"):
            self.source.refnoise_enabled = bool(v)

    def request_lag(self):
        """`request lag` is a no-op BY DESIGN here: every channel's lag is
        measured every block (unlike the reference's nfft-slot round-robin
        that this command forces, console.cc:281-284). Saying so in the
        reply keeps MATLAB clients from assuming the old semantics."""
        return (
            "lag is measured on every channel every block; nothing to force"
        )

    def request_sync(self):
        self._resync_requested = True

    def add_channel(self, serial: str) -> str:
        if not hasattr(self.source, "add_channel"):
            return "add not supported for this source"
        old_n = self.n_active
        if self.max_channels is not None and old_n + 1 > self.max_channels:
            return f"channel limit reached ({self.max_channels})"
        if self.mesh is not None and self.max_channels is None:
            return "add with a device mesh requires --max-channels"
        try:
            idx = self.source.add_channel(serial)
        except RuntimeError as e:  # hardware open failed (rtlsdr source)
            return str(e)
        self._resize_channels(list(range(old_n)) + [-1])
        return f"added '{serial}' as channel {idx + 1}"  # wire ch 0 = ref

    def del_channel(self, serial: str) -> str:
        if not hasattr(self.source, "del_channel"):
            return "del not supported for this source"
        if self.mesh is not None and self.max_channels is None:
            return "del with a device mesh requires --max-channels"
        old_n = self.n_active
        i = self.source.del_channel(serial)
        if i is None:
            return f"no such channel: '{serial}'"
        self._resize_channels([r for r in range(old_n) if r != i])
        return f"deleted '{serial}'"

    def drain_log(self) -> str:
        out = "\n".join(self._log_lines)
        del self._log_lines[:]  # keep the handler's list identity
        return out

    def start_local_console(self, stream=None) -> None:
        """Local interactive console: a stdin reader thread feeding the same
        dispatcher as the remote socket — the reference's ``localc`` readline
        loop (src/console.cc:38-57) next to ``remotec``. Commands are drained
        in the block loop (one queue, like console.cc:371-374)."""
        import queue
        import sys
        import threading

        stream = stream or sys.stdin
        q = queue.Queue()
        self._local_lines = q

        def reader():
            if stream is sys.stdin and sys.stdin.isatty():
                # the reference shell is a readline loop (console.cc:38-57):
                # importing readline gives input() line editing + history
                try:
                    import readline  # noqa: F401
                except ImportError:
                    pass
                while True:
                    try:
                        line = input("> ")
                    except EOFError:
                        return
                    q.put(line)
                    if line.strip() == "quit":
                        return
            else:
                for line in stream:
                    q.put(line.rstrip("\n"))
                    if line.strip() == "quit":
                        return

        t = threading.Thread(target=reader, daemon=True, name="local-console")
        t.start()

    def request_exit(self):
        """Signal-safe: leave the block loop after the current iteration
        (run() then restores dongles, saves state, returns normally) —
        the clean exit the reference documents as broken (README.md:20)."""
        self._do_exit = True

    def shutdown(self):
        self._do_exit = True
        logger.removeHandler(self._log_handler)
