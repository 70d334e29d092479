"""Soak client: long-run integrity drive against a live server (default
~12 min). Continuous gseq/alignment checks, periodic console traffic,
mid-run refnoise toggle, retune, hot add/del, and an fs change. Prints
SOAK-OK or the failure list. Pair with:
  python apps/coherent_server.py -n 4 -b 2048 --blocks 200000 \
      --scan-depth 8 --max-channels 6 -A "tcp://*:6555" \
      --ctrl-address "tcp://*:6556" --debug-address "tcp://*:6557"

CHAOS MODE: run the server with --drop-rate to inject per-channel capture
drops. Alignment-blip "errors" are then EXPECTED (a dropped block publishes
stale samples — the same physics as the reference's stale-buffer failure,
but detected/reported here); the invariants that must hold under chaos are
(a) the server stays up, (b) gseq stays contiguous (no gseq/timeout
entries in the error list), (c) sync repeatedly re-locks."""
import sys
import time

DURATION = 700  # seconds of soak (override: soak_client.py <seconds>)
if len(sys.argv) > 1:
    DURATION = float(sys.argv[1])
import numpy as np
import zmq

sys.path.insert(0, "/root/repo")
from coherent_rtlsdr_tpu.io.wire import unpack_frame, frame_to_matrix

DATA, CTRL = "tcp://127.0.0.1:6555", "tcp://127.0.0.1:6556"
ctx = zmq.Context.instance()
sub = ctx.socket(zmq.SUB)
sub.setsockopt(zmq.SUBSCRIBE, b"")
sub.setsockopt(zmq.RCVTIMEO, 900000)
sub.connect(DATA)
ctl = ctx.socket(zmq.DEALER)
ctl.setsockopt(zmq.RCVTIMEO, 60000)
ctl.connect(CTRL)

def cmd(s):
    ctl.send_string(s)
    return ctl.recv().decode()

print("waiting for first frame...", flush=True)
t0 = time.time()
f = unpack_frame(sub.recv())
print(f"first frame after {time.time()-t0:.1f}s N={f.iq.shape[0]}", flush=True)
sub.setsockopt(zmq.RCVTIMEO, 120000)

last_g = f.globalseqn
n = 1
t_run0 = time.time()
_f = DURATION / 700.0  # event schedule scales with the duration
events = [(120 * _f, "request rd"), (180 * _f, "request re"),
          (240 * _f, "fcenter 868000000"), (300 * _f, "add SOAK_X"),
          (420 * _f, "del SOAK_X"), (480 * _f, "fs 1024000")]
fired = set()
align_checks = 0
bad_streak = 0
errors = []
while time.time() - t_run0 < DURATION:
    try:
        f = unpack_frame(sub.recv())
    except zmq.Again:
        errors.append(f"receive timeout at n={n}")
        break
    n += 1
    if f.globalseqn != (last_g + 1) & 0xFFFFFFFF:
        errors.append(f"gseq jump {last_g} -> {f.globalseqn} at n={n}")
    last_g = f.globalseqn
    el = time.time() - t_run0
    for i, (t_ev, c) in enumerate(events):
        if el >= t_ev and i not in fired:
            fired.add(i)
            r = cmd(c)
            print(f"[{el:.0f}s n={n}] > {c} -> {r.splitlines()[0] if r else ''}",
                  flush=True)
    if n % 400 == 0:
        X = frame_to_matrix(f)
        ref = X[0]
        ok = True
        for ch in range(1, X.shape[0]):
            z = np.vdot(ref, X[ch])
            corr = abs(z) / (np.linalg.norm(X[ch]) * np.linalg.norm(ref) + 1e-12)
            if corr < 0.95:
                ok = False
        align_checks += 1
        # two CONSECUTIVE failed checks = a real misalignment (one bad
        # check is a just-added channel still locking) -> counts as error
        bad_streak = 0 if ok else bad_streak + 1
        if bad_streak >= 2:
            errors.append(f"alignment failed at n={n}")
        st = cmd("status").splitlines()[0]
        print(f"[{el:.0f}s] n={n} N={X.shape[0]} aligned={ok} {st}", flush=True)
print(cmd("status"), flush=True)
cmd("quit")
dur = time.time() - t_run0
print(f"frames={n} over {dur:.0f}s = {n/dur:.1f} f/s; "
      f"align_checks={align_checks}; errors={errors[:5]}", flush=True)
print("SOAK-OK" if not errors else f"SOAK-FAIL ({len(errors)} errors)", flush=True)
