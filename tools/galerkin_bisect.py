"""Bisect experiment (round 3): is the stationary V-cycle divergence
under rotated tensor anisotropy fixed by a Galerkin (I^T A I) coarse
operator chain, or by an exactly-integrated Q1 rediscretization?

MEASURED ANSWER (CPU, float64): NO — all three coarse
variants (GLL rediscretized / whole-chain Galerkin / exact Q1) diverge
identically on the three-level (1,3,6) rotated-100:1 cycle at
smoother_iters=2, and all converge at smoother_iters>=3 (cubic mesh;
4 on an elongated 3x7x10 box). The divergence lives at the HIGH-p
smoothing levels. Two-level (1,3) converges for all three variants —
and Galerkin p=3->1 EQUALS the exactly-integrated Q1 matrix there (the
p=3 GLL rule integrates Q1-gradient products exactly).

All f64 numpy/scipy, exact dense coarse solves, fourth-kind Chebyshev
smoothing (the production cycle's smoother). Run from the repo root:
`python tools/galerkin_bisect.py`.
"""

import os
import sys

import numpy as np
import scipy.linalg
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pmg_dolfinx_jax.fem.assembly import assemble_rhs, assemble_stiffness
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.models.poisson import f_rhs
from pmg_dolfinx_jax.ops.lattice import axis_interpolation_matrix

from tests.test_vcycle_twin import (_np_cheb4, _np_lanczos_lmax,
                                    _np_recorded_cg)

SMOOTHER_ITERS = 2


def rotated_tensor(ratio=100.0, axis=(1.0, 1.0, 0.3), angle=0.9):
    """diag(1,1,ratio) rotated by `angle` around `axis`."""
    a = np.asarray(axis) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = scipy.linalg.expm(angle * K)
    return R @ np.diag([1.0, 1.0, ratio]) @ R.T


def exact_q1_element(h, kt):
    """Exactly integrated (2x2x2 Gauss) Q1 stiffness on a box cell of
    size h=(hx,hy,hz) with constant tensor kappa kt."""
    g = np.array([-1.0, 1.0]) / np.sqrt(3.0)  # on [-1,1]
    # trilinear basis on [-1,1]^3, vertex order (i,j,k) lex with x slowest
    # to match mesh.dofmap(1) ordering? We'll use x-slowest (i*4+j*2+k)... we
    # must match the mesh's local dof ordering. BoxMesh dofmap(P) local
    # ordering: lexicographic (x,y,z) with z fastest (lattice order).
    verts = [(i, j, k) for i in range(2) for j in range(2) for k in range(2)]
    J = np.diag(np.asarray(h) / 2.0)
    detJ = np.prod(h) / 8.0
    Jinv = np.linalg.inv(J)
    A = np.zeros((8, 8))
    for gx in g:
        for gy in g:
            for gz in g:
                # basis gradients wrt reference coords
                grads = []
                for (i, j, k) in verts:
                    sx = (1 + (2 * i - 1) * gx) / 2
                    sy = (1 + (2 * j - 1) * gy) / 2
                    sz = (1 + (2 * k - 1) * gz) / 2
                    dx = (2 * i - 1) / 2 * sy * sz
                    dy = sx * (2 * j - 1) / 2 * sz
                    dz = sx * sy * (2 * k - 1) / 2
                    grads.append([dx, dy, dz])
                Gr = np.array(grads) @ Jinv  # physical gradients, (8,3)
                A += detJ * Gr @ kt @ Gr.T
    return A


def assemble_q1_exact(mesh, kt):
    dofmap = mesh.dofmap(1)
    ncells, nld = dofmap.shape
    assert nld == 8
    h = (1.0 / np.asarray(mesh.nc))
    Ae = exact_q1_element(h, kt)
    rows = np.repeat(dofmap, nld, axis=1).ravel()
    cols = np.tile(dofmap, (1, nld)).ravel()
    vals = np.broadcast_to(Ae, (ncells, nld, nld)).ravel()
    ndofs = mesh.num_dofs(1)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(ndofs, ndofs)).tocsr()
    marker = mesh.boundary_dof_marker(1)
    keep = sp.diags((~marker).astype(np.float64))
    return (keep @ A @ keep + sp.diags(marker.astype(np.float64))).tocsr()


class TwinPMG:
    def __init__(self, mesh, degrees, kappa, coarse_kind="gll"):
        self.degrees = degrees
        self.A, self.Minv, self.lmax, self.bc = [], [], [], []
        for P in degrees:
            A = assemble_stiffness(mesh, P, kappa=kappa).tocsr()
            self.A.append(A)
            self.bc.append(np.asarray(mesh.boundary_dof_marker(P)))
        self.I3 = []
        for i in range(len(degrees) - 1):
            Pc, Pf = degrees[i], degrees[i + 1]
            Ix, Iy, Iz = (
                sp.csr_matrix(axis_interpolation_matrix(nc_a, Pc, Pf))
                for nc_a in mesh.nc)
            self.I3.append(sp.kron(Ix, sp.kron(Iy, Iz)).tocsr())
        if coarse_kind == "galerkin":
            # Galerkin down the whole chain: A_{i-1} = I^T A_i I, bc fixed
            for i in range(len(degrees) - 1, 0, -1):
                Ac = (self.I3[i - 1].T @ self.A[i] @ self.I3[i - 1]).tocsr()
                m = self.bc[i - 1]
                keep = sp.diags((~m).astype(np.float64))
                self.A[i - 1] = (keep @ Ac @ keep
                                 + sp.diags(m.astype(np.float64))).tocsr()
        elif coarse_kind == "exact_q1":
            assert degrees[0] == 1
            self.A[0] = assemble_q1_exact(mesh, kappa)
        elif coarse_kind != "gll":
            raise ValueError(coarse_kind)
        for A in self.A:
            Minv = 1.0 / A.diagonal()
            a, b = _np_recorded_cg(A, Minv, np.ones(A.shape[0]))
            self.Minv.append(Minv)
            self.lmax.append(1.1 * _np_lanczos_lmax(a, b))
        self.A0_dense = np.linalg.inv(self.A[0].toarray())

    def v_cycle(self, b, u):
        L = len(self.degrees)
        us, bs = [None] * L, [None] * L
        us[L - 1], bs[L - 1] = u, b
        for i in range(L - 1, 0, -1):
            if i < L - 1:
                us[i] = np.zeros(self.A[i].shape[0])
            us[i] = _np_cheb4(self.A[i], self.Minv[i], bs[i], us[i],
                              self.lmax[i], SMOOTHER_ITERS)
            r = bs[i] - self.A[i] @ us[i]
            bs[i - 1] = self.I3[i - 1].T @ r
        b0 = np.where(self.bc[0], 0.0, bs[0])
        us[0] = self.A0_dense @ b0
        for i in range(L - 1):
            us[i + 1] = us[i + 1] + self.I3[i] @ us[i]
            us[i + 1] = _np_cheb4(self.A[i + 1], self.Minv[i + 1], bs[i + 1],
                                  us[i + 1], self.lmax[i + 1], SMOOTHER_ITERS)
        return us[L - 1]

    def solve(self, b, num_cycles):
        u = np.zeros_like(b)
        rn = []
        for _ in range(num_cycles):
            u = self.v_cycle(b, u)
            rn.append(np.linalg.norm(b - self.A[-1] @ u))
        return u, np.array(rn)


def run(nc, degrees, kappa, label):
    mesh = BoxMesh(nc)
    b = np.asarray(assemble_rhs(mesh, degrees[-1], f_rhs(1.0)))
    print(f"== {label}: nc={nc} degrees={degrees}")
    for kind in ("gll", "galerkin", "exact_q1"):
        try:
            twin = TwinPMG(mesh, degrees, kappa, coarse_kind=kind)
            _, rn = twin.solve(b, num_cycles=12)
            rel = rn / rn[0]
            print(f"  {kind:9s}: rel residuals {rel[0]:.2e} {rel[2]:.2e} "
                  f"{rel[5]:.2e} {rel[8]:.2e} {rel[11]:.2e}"
                  f"  {'DIVERGED' if rel[-1] > 1 else 'converging'}")
        except Exception as e:
            print(f"  {kind:9s}: ERROR {e}")


if __name__ == "__main__":
    K = rotated_tensor(100.0)
    print("kappa eigs:", np.linalg.eigvalsh(K))
    run((6, 6, 6), (1, 3), K, "rot100 two-level")
    run((6, 6, 6), (1, 3, 6), K, "rot100 three-level")
    run((6, 6, 6), (1, 3), np.diag([1.0, 1.0, 100.0]), "diag100 two-level")
