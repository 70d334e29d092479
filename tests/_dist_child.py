"""Child process for the multi-process jax.distributed test
(tests/test_distributed.py). Each of 2 processes owns 4 virtual CPU devices;
the (time=2, channel=4) mesh spans both, so the sharded align's psum /
ppermute collectives cross the process boundary for real (SURVEY.md §4:
multi-host tests on CPU meshes).

Prints DIST-OK on success, DIST-SKIP:<reason> when the environment cannot do
cross-process CPU collectives.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    coordinator, num_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    jax.config.update("jax_platforms", "cpu")

    from coherent_rtlsdr_tpu.parallel.distributed import global_mesh, init_multihost

    try:
        init_multihost(coordinator, num_procs, pid)
    except Exception as e:  # pragma: no cover - environment-dependent
        print(f"DIST-SKIP:initialize failed: {e}", flush=True)
        return 0

    if jax.device_count() != 8 or jax.local_device_count() != 4:
        print(
            f"DIST-SKIP:unexpected device counts {jax.device_count()}/"
            f"{jax.local_device_count()}",
            flush=True,
        )
        return 0

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coherent_rtlsdr_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS
    from coherent_rtlsdr_tpu.parallel.sharded import make_sharded_align
    from coherent_rtlsdr_tpu.pipeline import PipelineConfig, align_offline

    T, N, L = 4, 8, 256
    cfg = PipelineConfig(n_channels=N, block_len=L)
    rng = np.random.default_rng(0)  # same seed both processes -> same data
    sig = rng.integers(0, 256, (T, N, L, 2), dtype=np.uint8)
    ref = rng.integers(0, 256, (T, L, 2), dtype=np.uint8)

    mesh = global_mesh(2, 4)
    sig_sh = NamedSharding(mesh, P(TIME_AXIS, CHANNEL_AXIS, None, None))
    ref_sh = NamedSharding(mesh, P(TIME_AXIS, None, None))
    gsig = jax.make_array_from_callback(sig.shape, sig_sh, lambda i: sig[i])
    gref = jax.make_array_from_callback(ref.shape, ref_sh, lambda i: ref[i])

    align = make_sharded_align(cfg, mesh)
    try:
        aligned, out_ref, delay, mag = align(gsig, gref)
        jax.block_until_ready(delay)
    except Exception as e:  # pragma: no cover - collectives support varies
        print(f"DIST-SKIP:cross-process collectives unavailable: {e}", flush=True)
        return 0

    # Reference: the unsharded offline engine on the full data, locally.
    res = align_offline(cfg, jnp.asarray(sig), jnp.asarray(ref),
                        smoothing="global")
    # Sharded align emits T blocks (first seeded from a zero halo) vs T-1
    # from align_offline; delays are global constants — compare those, plus
    # the aligned payload on the common blocks, shard by addressable shard.
    exp_delay = np.asarray(res.delay)[0]  # [N] (global smoothing: constant)
    for sh in delay.addressable_shards:
        got = np.asarray(sh.data)
        want = np.broadcast_to(exp_delay, (T, N))[sh.index]
        np.testing.assert_allclose(got, want, atol=5e-3)

    exp_aligned = np.asarray(res.aligned)  # [T-1, N, L]
    for sh in aligned.addressable_shards:
        got = np.asarray(sh.data)
        # global block index range of this shard
        tsl = sh.index[0]
        t0 = tsl.start or 0
        for ti, tg in enumerate(range(t0, t0 + got.shape[0])):
            if tg == 0:
                continue  # zero-halo seed block not produced by align_offline
            want = exp_aligned[tg - 1][sh.index[1]]
            err = np.abs(got[ti] - want)
            rms = np.sqrt(np.mean(np.abs(want) ** 2))
            assert err.max() / rms < 0.05, (tg, err.max() / rms)

    print("DIST-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
