"""The pipeline containers are plain frozen dataclasses registered as
pytrees: flatten/unflatten, functional ``replace``, and a jit round trip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coherent_rtlsdr_tpu.pipeline import PipelineConfig, init_state
from coherent_rtlsdr_tpu.pipeline.state import (
    BlockOutput,
    PipelineState,
    Telemetry,
)


def _state(impl="xla"):
    kw = dict(fft_impl="fused", lag_method="phase_zoom") if impl == "fused" else {}
    return init_state(PipelineConfig(n_channels=3, block_len=2048, **kw))


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_flatten_unflatten_roundtrip(impl):
    s = _state(impl)
    leaves, treedef = jax.tree_util.tree_flatten(s)
    assert len(leaves) == len(dataclasses.fields(PipelineState)) == 11
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is PipelineState
    for f in dataclasses.fields(PipelineState):
        np.testing.assert_array_equal(np.asarray(getattr(back, f.name)),
                                      np.asarray(getattr(s, f.name)))
    # the fused path keeps signed capture bytes in the same [N, L, 2] shape
    assert s.hist.shape == (3, 2048, 2)
    assert s.hist.dtype == (jnp.int8 if impl == "fused" else jnp.float32)


def test_replace_is_functional_and_frozen():
    s = _state()
    s2 = s.replace(delay=s.delay + 1.5, synced=jnp.ones(3, bool))
    np.testing.assert_array_equal(np.asarray(s.delay), 0.0)
    np.testing.assert_array_equal(np.asarray(s2.delay), 1.5)
    assert bool(jnp.all(s2.synced)) and s2.hist is s.hist
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.delay = s2.delay


def test_jit_roundtrip_and_optional_leaves():
    s = _state()

    @jax.jit
    def bump(st):
        return st.replace(block_idx=st.block_idx + 1, delay=st.delay * 2 + 1)

    out = bump(bump(s))
    assert type(out) is PipelineState and int(out.block_idx) == 2
    np.testing.assert_array_equal(np.asarray(out.delay), 3.0)

    t = Telemetry(*(jnp.zeros(3) for _ in range(9)))
    # BlockOutput's wire/wire_ref default to None: no leaves, still a tree
    bo = BlockOutput(aligned=jnp.zeros((3, 4), jnp.complex64),
                     ref=jnp.zeros(4, jnp.complex64), telemetry=t)
    assert len(jax.tree_util.tree_leaves(bo)) == 2 + 9
    bo2 = jax.jit(lambda b: b.replace(ref=b.ref + 1))(bo)
    assert bo2.wire is None
    np.testing.assert_array_equal(np.asarray(bo2.ref), 1.0 + 0j)
