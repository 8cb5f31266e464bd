"""utils/metrics smoke tests."""

import jax.numpy as jnp

from fdtd2d.utils.metrics import Timer, throughput_gcells


def test_timer_and_throughput():
    with Timer(sync_on=jnp.ones(4)) as t:
        x = jnp.ones((64, 64)) * 2
    assert t.seconds >= 0

    calls = []

    def fn():
        calls.append(1)
        return jnp.sum(jnp.ones((32, 32)))

    g = throughput_gcells(32 * 32, 10, fn, repeats=2)
    assert g > 0 and len(calls) == 2
