"""Inverse-design workload: loss must decrease and respect bounds."""

import numpy as np
import pytest
import jax.numpy as jnp

from fdtd2d.apps.inverse_design import lowpass_problem, make_response_fn, optimize


@pytest.mark.slow
def test_lowpass_optimization_reduces_loss():
    problem = lowpass_problem(N=60, n_freqs=4)
    design, responses, history = optimize(problem, steps=10, lr=0.05,
                                          dtype=jnp.complex128)
    assert min(history) < history[0] * 0.97, f"loss did not decrease: {history}"
    assert float(jnp.min(design)) >= 1.0 and float(jnp.max(design)) <= 3.0
    assert responses.shape == (4,)
    assert np.all(np.isfinite(np.asarray(responses)))


def test_response_fn_is_differentiable_and_jitted():
    import jax

    problem = lowpass_problem(N=50, n_freqs=3)
    _, loss = make_response_fn(problem, dtype=jnp.complex128)
    rs, cs = problem.design_region
    d0 = jnp.ones((rs.stop - rs.start, cs.stop - cs.start))
    g = jax.grad(loss)(d0)
    assert g.shape == d0.shape
    assert float(jnp.max(jnp.abs(g))) > 0.0
