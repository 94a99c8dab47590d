"""Fast Diagonalization Method: a DIRECT solver in six matmuls.

For the constant-coefficient operator on an axis-aligned box the
Kronecker-sum structure (ops/kron.py) diagonalizes exactly: with the
per-axis generalized eigenproblem ``K v = lambda M v`` solved at setup
(dense, interior nodes only — Dirichlet planes are whole lattice planes,
so the interior is itself a tensor product), and ``V^T M V = I``,

    A^{-1} = (V (x) V (x) V)  diag(kappa (lx + ly + lz))^{-1}  (V^T)^{(x)3}

i.e. one exact solve = three forward + three backward per-axis dense
matmuls + a pointwise division — about 2x the cost of a single operator
apply. This is the classical spectral-element fast solver (Lynch, Rice &
Thomas 1964; the building block of NekBone/Nek5000 preconditioners — see
PAPERS.md), and it is the payoff of designing mesh/operator around the
tensor-product lattice: the reference's unstructured-general architecture
cannot express it.

Uses beyond the flagship constant-kappa problem: an FDM solve on a nearby
constant-coefficient operator is an excellent preconditioner for
variable-coefficient / mildly deformed problems (wrap in `fcg_solve`).

float32 solves carry ~1e-6 relative error from the matmul passes; pair
with `refine` (f64 residual + FDM correction) for machine-precision
solutions in 2-4 iterations.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.kron import axis_stiffness_mass


def _axis_eig(nc, P, h, ends=(True, True), robin=(0.0, 0.0)):
    """Free-node generalized eigenpairs of the 1D (K, M) pencil.

    ``ends`` are the per-end Dirichlet flags: flagged end nodes are
    trimmed (identity rows); an unflagged end is a natural-Neumann node
    and stays a free unknown (the assembled 1D matrices already carry
    the correct half-stencil rows there). ``robin`` adds the per-end
    Robin terms to K before the eigensolve (a Robin end is a free node
    with a modified stencil — the diagonalization absorbs it exactly;
    NOTE: the caller scales the eigenvalues by ``k_a``, so pass
    ``alpha/k_a``). Returns ``V[(Ni, Ni)]`` with ``V^T M V = I`` and
    eigenvalues ``lam[(Ni,)]``; Ni = nc*P + 1 - sum(ends).
    """
    K, m = axis_stiffness_mass(nc, P, h, robin=robin)
    lo = 1 if ends[0] else 0
    hi = -1 if ends[1] else None
    Ki = K[lo:hi, lo:hi]
    mi = m[lo:hi]
    s = 1.0 / np.sqrt(mi)
    T = (s[:, None] * Ki) * s[None, :]
    lam, Q = np.linalg.eigh((T + T.T) / 2.0)
    V = s[:, None] * Q
    return V, lam


_ALL_DIRICHLET_TRIMS = ((1, 1), (1, 1), (1, 1))


def fdm_solve(b, Vs, Vts, dinv, bc_marker, shape, precision="highest",
              trims=_ALL_DIRICHLET_TRIMS):
    """Direct solve ``u = A^{-1} b`` (jittable, shape-preserving).

    ``Vs``/``Vts`` are per-axis eigenvector matrices and transposes
    (free-node sizes), ``dinv`` the reciprocal eigenvalue-sum lattice,
    ``shape`` the full lattice shape, ``trims`` the per-axis (lo, hi)
    Dirichlet-plane trim counts (all-ones for the default 6-face
    Dirichlet marker; 0 at natural-Neumann faces). ``b`` may be flat or
    lattice-shaped; the output matches. bc rows return ``u[bc] = b[bc]``
    (identity rows, consistent with all operator backends).
    """
    b3 = b.reshape(shape)
    t = b3[tuple(slice(lo, n - hi) for n, (lo, hi) in zip(shape, trims))]
    Vx, Vy, Vz = Vs
    Vxt, Vyt, Vzt = Vts
    t = jnp.einsum("ax,xyz->ayz", Vxt, t, precision=precision)
    t = jnp.einsum("by,xyz->xbz", Vyt, t, precision=precision)
    t = jnp.einsum("cz,xyz->xyc", Vzt, t, precision=precision)
    t = t * dinv
    t = jnp.einsum("ax,xyz->ayz", Vx, t, precision=precision)
    t = jnp.einsum("by,xyz->xbz", Vy, t, precision=precision)
    t = jnp.einsum("cz,xyz->xyc", Vz, t, precision=precision)
    u = jnp.pad(t, tuple(trims)).reshape(jnp.shape(b))
    return jnp.where(bc_marker.reshape(jnp.shape(b)), b, u)


class FastDiagonalizationSolver:
    """Direct solver bundle for `BoxMesh` + constant kappa.

    ``solve(b)`` is exact (to working precision) in one application;
    ``refine(b, cycles)`` wraps it in f64 iterative refinement for
    machine-precision results (requires x64).
    """

    def __init__(self, mesh, P, kappa=2.0, dtype=jnp.float32,
                 precision="highest", sigma=0.0):
        """``sigma`` shifts the operator by the lumped mass
        (``A + sigma M``): in the per-axis generalized eigenbasis the
        mass is the identity, so the shift just adds to the eigenvalue
        sums — the direct solve stays six matmuls."""
        from ..fem.mesh import require_axis_aligned

        require_axis_aligned(mesh, "FastDiagonalizationSolver")
        self.mesh = mesh
        self.P = int(P)
        self.dtype = dtype
        self.shape = mesh.lattice_shape(self.P)
        faces = getattr(mesh, "dirichlet_faces", ((True, True),) * 3)
        self.trims = tuple(
            (int(lo), int(hi)) for lo, hi in faces
        )
        from ..fem.assembly import resolve_kappa_axes
        from ..ops.kron import robin_axis_ends

        # Per-axis kappa just scales each axis' generalized eigenvalues
        # (same V): grid-aligned anisotropic diffusion solved EXACTLY.
        kx, ky, kz = resolve_kappa_axes(mesh, kappa)
        Vs, Vts, lams = [], [], []
        for a, (nc_a, h_a, ends, k_a) in enumerate(
                zip(mesh.nc, mesh.h_cells, faces, (kx, ky, kz))):
            # Robin ends pre-divided by k_a: the eigenvalue sums below
            # multiply back by k_a, restoring the kappa-free alpha term —
            # the Robin family keeps the EXACT six-matmul direct solve.
            V, lam = _axis_eig(nc_a, self.P, h_a, ends=ends,
                               robin=robin_axis_ends(mesh, a, 1.0 / k_a))
            Vs.append(jnp.asarray(V, dtype=dtype))
            Vts.append(jnp.asarray(V.T.copy(), dtype=dtype))
            lams.append(lam)
        self.Vs, self.Vts = tuple(Vs), tuple(Vts)
        lx, ly, lz = lams
        d = (kx * lx[:, None, None] + ky * ly[None, :, None]
             + kz * lz[None, None, :]) + float(sigma)
        if d.size and float(d.min()) <= 1e-14 * max(1.0, float(d.max())):
            # All-Neumann with sigma=0: the constant mode makes the
            # operator singular — a direct inverse does not exist.
            raise ValueError(
                "FDM: singular operator (no Dirichlet face and sigma=0 "
                "leaves the constant nullspace); add a Dirichlet face or "
                "a positive sigma shift"
            )
        self.dinv = jnp.asarray(1.0 / d, dtype=dtype)
        self.bc_marker = jnp.asarray(mesh.boundary_dof_marker(self.P))
        self._solve = jax.jit(
            partial(fdm_solve, precision=precision, trims=self.trims),
            static_argnames=("shape",),
        )
        self._precision = precision
        self._kappa = (kx, ky, kz)
        self._sigma = float(sigma)

    def solve(self, b):
        b = jnp.asarray(b, dtype=self.dtype)
        return self._solve(b, self.Vs, self.Vts, self.dinv, self.bc_marker,
                           self.shape)

    def solve_many(self, B):
        """Batched direct solve over a leading RHS axis (one jitted
        vmap program: the RHS axis becomes a matmul batch dimension).
        A convenience/one-dispatch API; whether it raises throughput
        per RHS at large N is measured by tools/batched_bench.py."""
        if getattr(self, "_solve_many", None) is None:
            self._solve_many = jax.jit(jax.vmap(
                partial(fdm_solve, shape=self.shape,
                        precision=self._precision, trims=self.trims),
                in_axes=(0, None, None, None, None),
            ))
        B = jnp.asarray(B, dtype=self.dtype)
        return self._solve_many(B, self.Vs, self.Vts, self.dinv,
                                self.bc_marker)

    def refine(self, b, cycles=3):
        """f64 iterative refinement around the f32 direct solve."""
        from ..ops.kron import KronLaplacian

        if not jax.config.read("jax_enable_x64"):
            raise RuntimeError("refine requires jax_enable_x64")
        if getattr(self, "_op64", None) is None:
            # sigma must ride the f64 residual operator too, or the
            # refinement converges to the UNSHIFTED system (r3 review).
            self._op64 = KronLaplacian(self.mesh, self.P, kappa=self._kappa,
                                       dtype=jnp.float64, sigma=self._sigma)
        op64 = self._op64
        b64 = jnp.asarray(b, dtype=jnp.float64)
        u64 = jnp.zeros_like(b64)
        rnorms = []
        for _ in range(cycles):
            r64 = b64 - op64(u64)
            rnorms.append(float(jnp.linalg.norm(r64)))
            e = self.solve(jnp.asarray(r64, dtype=self.dtype))
            u64 = u64 + jnp.asarray(e, dtype=jnp.float64)
        return u64, rnorms
