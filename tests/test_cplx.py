"""ops/cplx helper parity tests."""

import numpy as np
import jax.numpy as jnp

from fdtd2d.ops.cplx import (
    cdot, cnorm, cmatmul, to_device_complex, fetch_complex, czeros, cgather,
)


def _z(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_cdot_cnorm_match_numpy():
    a, b = _z(64), _z(64, 1)
    got = complex(cdot(jnp.asarray(a), jnp.asarray(b)))
    want = np.vdot(a, b)
    assert abs(got - want) / abs(want) < 1e-12
    assert abs(float(cnorm(jnp.asarray(a))) - np.linalg.norm(a)) < 1e-12
    # real inputs stay real
    r = jnp.arange(4.0)
    assert not jnp.iscomplexobj(cdot(r, r))


def test_cmatmul_matches_numpy():
    A, Bm = _z((12, 7)), _z((7, 9), seed=1)
    got = np.asarray(cmatmul(jnp.asarray(A), jnp.asarray(Bm)))
    np.testing.assert_allclose(got, A @ Bm, rtol=1e-12)
    # real x real path
    got_r = np.asarray(cmatmul(jnp.real(jnp.asarray(A)), jnp.real(jnp.asarray(Bm))))
    np.testing.assert_allclose(got_r, A.real @ Bm.real, rtol=1e-12)


def test_transfer_roundtrip_and_zeros_gather():
    x = _z((5, 6)).astype(np.complex64)
    d = to_device_complex(x, jnp.complex64)
    np.testing.assert_allclose(fetch_complex(d), x, rtol=1e-6)
    # real input promotes
    dr = to_device_complex(np.ones((3, 3)), jnp.complex64)
    assert jnp.iscomplexobj(dr)

    z = czeros((4, 4), jnp.complex128)
    assert z.dtype == jnp.complex128 and float(cnorm(z)) == 0.0

    a = jnp.asarray(_z((3, 4, 5)))
    i = jnp.asarray([[0, 2], [1, 0]])
    got = np.asarray(cgather(a, i, i, i))
    want = np.asarray(a)[np.asarray(i), np.asarray(i), np.asarray(i)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
