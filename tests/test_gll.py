"""Unit tests for the 1D GLL layer (replaces basix; SURVEY.md §7 step 1)."""

import numpy as np
import pytest

from pmg_dolfinx_jax.fem.gll import (
    derivative_matrix,
    gauss_legendre,
    gauss_lobatto,
    interpolation_matrix_1d,
    lagrange_tabulate,
)


@pytest.mark.parametrize("m", [2, 3, 4, 5, 6, 7, 8, 10, 12])
def test_gll_rule_exactness(m):
    x, w = gauss_lobatto(m)
    assert x[0] == 0.0 and x[-1] == 1.0
    assert np.all(np.diff(x) > 0)
    # Exact for degree <= 2m - 3 on [0, 1]: integral x^k = 1/(k+1)
    for k in range(max(2 * m - 2, 1)):
        quad = np.sum(w * x**k)
        exact = 1.0 / (k + 1)
        if k <= 2 * m - 3:
            assert abs(quad - exact) < 1e-13, (m, k)


@pytest.mark.parametrize("m", [1, 2, 5, 9])
def test_gauss_legendre_exactness(m):
    x, w = gauss_legendre(m)
    for k in range(2 * m):
        assert abs(np.sum(w * x**k) - 1.0 / (k + 1)) < 1e-13


@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 6, 7])
def test_lagrange_tabulate_interpolates(P):
    x, _ = gauss_lobatto(P + 1)
    pts = np.linspace(0, 1, 13)
    tab = lagrange_tabulate(x, pts, nderiv=1)
    # Partition of unity and exact reproduction of degree-P polynomials.
    assert np.allclose(tab[0].sum(axis=1), 1.0, atol=1e-12)
    for k in range(P + 1):
        vals = tab[0] @ x**k
        assert np.allclose(vals, pts**k, atol=1e-11)
        dervals = tab[1] @ x**k
        dexact = k * pts ** (k - 1) if k > 0 else np.zeros_like(pts)
        assert np.allclose(dervals, dexact, atol=1e-9)


@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 6, 7, 8])
def test_derivative_matrix(P):
    x, _ = gauss_lobatto(P + 1)
    D = derivative_matrix(P)
    # Rows sum to zero (derivative of the constant).
    assert np.allclose(D.sum(axis=1), 0.0, atol=1e-11)
    for k in range(P + 1):
        dexact = k * x ** (k - 1) if k > 0 else np.zeros_like(x)
        assert np.allclose(D @ x**k, dexact, atol=1e-9)


@pytest.mark.parametrize("pair", [(1, 2), (1, 3), (2, 4), (3, 6), (1, 6)])
def test_interpolation_matrix_1d(pair):
    Pc, Pf = pair
    M = interpolation_matrix_1d(Pc, Pf)
    xc, _ = gauss_lobatto(Pc + 1)
    xf, _ = gauss_lobatto(Pf + 1)
    for k in range(Pc + 1):
        assert np.allclose(M @ xc**k, xf**k, atol=1e-12)
