"""Test configuration: force an 8-virtual-device CPU platform, so sharding
and collective tests run without accelerator hardware (SURVEY.md §4).

``jax_platforms`` is also updated after import, so the tests stay on the
CPU even where the environment selects another platform; the persistent
compile cache follows the one rule every entry point uses
(``_bootstrap.setup_compile_cache``).

The tests are hardware-free; the on-card checks of the main path at full
width run through ``python chip_smoke.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from coherent_rtlsdr_tpu._bootstrap import (  # noqa: E402
    force_virtual_devices,
    setup_compile_cache,
)

force_virtual_devices(8)
os.environ.setdefault("JAX_ENABLE_X64", "0")
setup_compile_cache()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()
