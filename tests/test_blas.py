"""BLAS-1 layer tests (reference src/vector.hpp:327-455 parity).

The single-device functions back every cycle-ops `dot`; the distributed
variants back the sharded dots (exercised throughout test_parallel /
test_grid2d) — here both are checked directly against NumPy.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pmg_dolfinx_jax.ops import blas


def test_single_device_blas():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((4, 5))
    v = rng.standard_normal((4, 5))
    assert np.isclose(float(blas.inner_product(jnp.asarray(u), jnp.asarray(v))),
                      (u * v).sum())
    assert np.isclose(float(blas.squared_norm(jnp.asarray(u))), (u * u).sum())
    assert np.isclose(float(blas.norm(jnp.asarray(u))), np.linalg.norm(u))
    assert np.isclose(float(blas.norm(jnp.asarray(u), "linf")),
                      np.abs(u).max())
    assert np.allclose(np.asarray(blas.axpy(2.5, jnp.asarray(u), jnp.asarray(v))),
                       2.5 * u + v)
    assert np.allclose(np.asarray(blas.scale(3.0, jnp.asarray(u))), 3.0 * u)
    assert np.allclose(np.asarray(blas.pointwise_mult(jnp.asarray(u), jnp.asarray(v))),
                       u * v)
    assert np.allclose(np.asarray(blas.transform(lambda a, b: a - 2 * b,
                                                 jnp.asarray(u), jnp.asarray(v))),
                       u - 2 * v)


def test_distributed_blas_matches_global():
    """Weighted psum dot/norm over a duplicated layout == global values
    (the MPI_Allreduce contract, vector.hpp:350,384)."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    rng = np.random.default_rng(1)
    u = rng.standard_normal((8, 6))
    v = rng.standard_normal((8, 6))
    w = np.ones((8, 6))

    def f(u_, v_, w_):
        return (blas.dist_inner_product(u_, v_, w_, "x"),
                blas.dist_norm(u_, w_, "x"),
                blas.dist_norm(u_, w_, "x", "linf"))

    fn = jax.jit(jax.shard_map(f, mesh=mesh,
                               in_specs=(P("x"), P("x"), P("x")),
                               out_specs=(P(), P(), P())))
    d, n2, ninf = fn(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w))
    assert np.isclose(float(d), (u * v).sum())
    assert np.isclose(float(n2), np.linalg.norm(u))
    assert np.isclose(float(ninf), np.abs(u).max())
