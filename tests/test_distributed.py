"""Multi-process jax.distributed validation (SURVEY.md §4: multi-host tests
on CPU meshes): 2 processes x 4 virtual CPU devices run the
sharded offline align over one global (2, 4) mesh, so the psum/ppermute
collectives really cross the process boundary; each process asserts its
addressable shards against the single-process engine."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_dist_child.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_align():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_NUM_PROCESSES", None)
    procs = [
        subprocess.Popen(
            [sys.executable, CHILD, coordinator, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=REPO, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, out
        if "DIST-SKIP" in out:
            pytest.skip(out.strip().splitlines()[-1])
    for rc, out in outs:
        assert "DIST-OK" in out, out
