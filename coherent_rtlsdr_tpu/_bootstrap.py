"""Process-setup helpers shared by every entry point (apps, bench.py,
chip_smoke.py, tests). Importing this module does not import jax, so the
environment-level helpers can run before jax initializes a backend."""

import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def force_virtual_devices(n: int) -> None:
    """Make the CPU backend expose ``n`` virtual devices (for --mesh on
    --cpu). MUST run before jax initializes a backend — XLA reads the flag
    once. No-op when a device-count flag is already set."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={int(n)}"
        )


def setup_compile_cache() -> str:
    """The one compile-cache rule: ``$JAX_COMPILATION_CACHE_DIR`` when it
    is set, else ``<checkout>/.jax_cache`` (a fixed path: the cache key
    includes it, so a moving directory would never hit). Every executable
    is cached, however quick its compile. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
    if "jax" in sys.modules:  # jax read its config already: update it too
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs",
            float(os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]),
        )
        jax.config.update(
            "jax_persistent_cache_min_entry_size_bytes",
            int(os.environ["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"]),
        )
    return path


def report_backend(allow_cpu: bool) -> None:
    """Print the backend the program runs on, and exit non-zero when JAX
    found no accelerator unless the caller asked for the CPU (``--cpu``):
    a run meant for the GPU never falls back to the host silently."""
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"backend: platform={d.platform} device_kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    if d.platform == "cpu" and not allow_cpu:
        sys.exit("error: JAX found no accelerator (platform 'cpu'); pass "
                 "--cpu to run on the host CPU")
