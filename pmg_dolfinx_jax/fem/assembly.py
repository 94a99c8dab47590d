"""NumPy golden models: dense/sparse assembly, RHS, error norms.

This module is the framework's correctness oracle, playing the role the
assembled-matrix path plays in the reference:

- element/global stiffness assembly —> the CSR `MatrixOperator` the
  reference compares its matrix-free operator against
  (`mat_free --mat_comp`, examples/mat_free/main.cpp:270-289),
- the host geometry math of src/precompute.hpp (exercised indirectly: the
  jnp `geometry_factors` is tested against `element_stiffness` products),
- RHS assembly + boundary conditions (examples/pmg/main.cpp:289-296),
- L2 error against a manufactured solution (python_tests/pmg.py:284-289).

Everything here is setup/test-time NumPy (float64); none of it runs in the
solve path.
"""

import numpy as np
import scipy.sparse as sp

from .geometry import geometry_factors, quadrature_weights_3d, tabulate_geometry_dphi
from .gll import derivative_matrix, gauss_legendre, gauss_lobatto, lagrange_tabulate
from .mesh import BoxMesh


def geometry_factors_np(mesh: BoxMesh, P: int,
                        kappa=None) -> tuple[np.ndarray, np.ndarray]:
    """G and detJ for all cells, pure-NumPy float64 (oracle path).

    ``kappa`` (optional): per-cell scalar or 3x3-tensor field folded into
    G (see `fem.geometry.geometry_factors`)."""
    G, detJ = geometry_factors(
        mesh.geometry_x,
        mesh.geometry_dofmap,
        tabulate_geometry_dphi(P),
        quadrature_weights_3d(P),
        xp=np,
        kappa=kappa,
    )
    return np.asarray(G), np.asarray(detJ)


def gradient_tables(P: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """3D basis gradient tables ``B_d[(nq, ndofs)]`` at the GLL points.

    With collocated GLL quadrature the 1D value table is the identity, so
    ``Bx = D (x) I (x) I`` etc. (the structure the sum-factorized kernel
    exploits, reference src/laplacian.hpp:195-218).
    """
    n = P + 1
    D = derivative_matrix(P)
    I = np.eye(n)
    Bx = np.einsum("qi,rj,sk->qrsijk", D, I, I).reshape(n**3, n**3)
    By = np.einsum("qi,rj,sk->qrsijk", I, D, I).reshape(n**3, n**3)
    Bz = np.einsum("qi,rj,sk->qrsijk", I, I, D).reshape(n**3, n**3)
    return Bx, By, Bz


def element_stiffness(G_cell: np.ndarray, P: int, coeff: float = 1.0) -> np.ndarray:
    """Dense element stiffness ``A^e[(ndofs, ndofs)]`` from the G factors.

    ``A^e = coeff * sum_{a,b} B_a^T diag(G_ab) B_b`` — the bilinear form
    ``integral kappa grad(u) . grad(v)`` evaluated with the collocated rule.
    """
    B = gradient_tables(P)
    idx = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]
    A = np.zeros((B[0].shape[1], B[0].shape[1]))
    for a in range(3):
        for b in range(3):
            A += B[a].T @ (G_cell[:, idx[a][b], None] * B[b])
    return coeff * A


def assemble_stiffness(
    mesh: BoxMesh, P: int, kappa=1.0, bc: bool = True
) -> sp.csr_matrix:
    """Assemble the global stiffness matrix (scipy CSR).

    With ``bc=True``, Dirichlet rows and columns are zeroed and the diagonal
    set to 1 — matching both dolfinx's assembled-with-bc matrix and the
    matrix-free kernel's semantics (zero bc dofs on gather, ``y[bc]=x[bc]``
    on scatter; reference src/laplacian.hpp:182-189, 272-277).
    """
    kc, kt, _ = resolve_kappa_split(mesh, kappa)
    G, _ = geometry_factors_np(mesh, P, kappa=kt)
    dofmap = mesh.dofmap(P)
    ndofs = mesh.num_dofs(P)
    ncells, nld = dofmap.shape
    rows = np.repeat(dofmap, nld, axis=1).ravel()
    cols = np.tile(dofmap, (1, nld)).ravel()
    vals = np.empty((ncells, nld, nld))
    for c in range(ncells):
        vals[c] = element_stiffness(G[c], P, kc[c])
    A = sp.coo_matrix((vals.ravel(), (rows, cols)), shape=(ndofs, ndofs)).tocsr()
    if getattr(mesh, "has_robin", False):
        # Robin boundary mass (diagonal under GLL collocation) is part
        # of the bilinear form — include it in the raw operator too.
        A = A + sp.diags(robin_mass_np(mesh, P, bc_zero=False))
    if bc:
        marker = mesh.boundary_dof_marker(P)
        keep = sp.diags((~marker).astype(np.float64))
        A = keep @ A @ keep + sp.diags(marker.astype(np.float64))
    return A.tocsr()


def _face_surface_quadrature(mesh: BoxMesh, P: int, axis: int, side: int):
    """Collocated GLL surface rule on one boundary face of the mesh.

    Returns ``(dofs, wts, pts)``: global dof ids ``(nfc, n, n)`` of the
    face nodes of every boundary-layer cell, the surface quadrature
    weights ``w_j w_k |t_u x t_v|`` at those nodes (Q1 face metric —
    exact for the trilinear geometry of both `BoxMesh` and
    `PerturbedBoxMesh`), and the physical node coordinates
    ``(nfc, n, n, 3)``. Shared-edge nodes appear once per adjacent cell;
    scatter-add with ``np.add.at`` to assemble (the surface analogue of
    `lumped_mass_np`).
    """
    n = P + 1
    xg, w1 = gauss_lobatto(n)
    nx, ny, nz = mesh.nc
    # Boundary-layer cells and their face corners (Q1 bilinear face map).
    corners = mesh.geometry_x[mesh.geometry_dofmap].reshape(
        nx, ny, nz, 2, 2, 2, 3
    )
    csl = [slice(None)] * 3
    csl[axis] = 0 if side == 0 else -1
    fsl = [slice(None)] * 3
    fsl[axis] = 0 if side == 0 else 1
    # (nfc, 2, 2, 3) with axes (u_corner, v_corner) = the two in-face axes.
    C = corners[tuple(csl) + tuple(fsl)].reshape(-1, 2, 2, 3)
    phi = np.stack([1.0 - xg, xg], axis=1)  # (n, 2)
    # Tangents of the bilinear face map X(u, v) = sum_ab phi_a(u)
    # phi_b(v) C[a, b]: d/du depends on v only, d/dv on u only.
    Xu = np.einsum("kb,cbD->ckD", phi, C[:, 1] - C[:, 0])  # at v = xg_k
    Xv = np.einsum("ja,caD->cjD", phi, C[:, :, 1] - C[:, :, 0])  # at u = xg_j
    # Broadcast to the (n_u, n_v) grid: Xu varies with v only, Xv with u.
    Tu = np.broadcast_to(Xu[:, None, :, :], (C.shape[0], n, n, 3))
    Tv = np.broadcast_to(Xv[:, :, None, :], (C.shape[0], n, n, 3))
    nrm = np.cross(Tu, Tv)
    dS = np.sqrt((nrm**2).sum(axis=-1))  # (nfc, n, n)
    wts = w1[None, :, None] * w1[None, None, :] * dS
    # Face dofs: boundary cell layer, face-local slice of the dofmap.
    dm = mesh.dofmap(P).reshape(nx, ny, nz, n, n, n)
    dsl = [slice(None)] * 3
    dsl[axis] = 0 if side == 0 else -1
    lsl = [slice(None)] * 3
    lsl[axis] = 0 if side == 0 else -1
    dofs = dm[tuple(dsl) + tuple(lsl)].reshape(-1, n, n)
    pts = mesh.dof_coords(P)[dofs]  # (nfc, n, n, 3)
    return dofs, wts, pts


def robin_mass_np(mesh: BoxMesh, P: int, bc_zero: bool = True) -> np.ndarray:
    """Diagonal Robin boundary mass ``b[(ndofs,)]`` (float64, host).

    ``b_i = sum_{Robin faces F ∋ i} alpha_F w_i^F`` with the collocated
    GLL surface rule — the boundary term ``integral_Gamma alpha u v ds``
    of the Robin condition ``kappa du/dn + alpha u = g``
    (`BoxMesh(robin=...)`). Diagonal because GLL collocation lumps the
    surface mass exactly (same mechanism as `lumped_mass_np`). On an
    axis-aligned box it equals the per-axis Kronecker end-point form
    ``alpha e_end e_end^T (x) M (x) M`` (verified in tests), which is how
    the kron/FDM family carries it. With ``bc_zero=True`` entries on
    Dirichlet-marked dofs (Robin-face edges meeting a Dirichlet face)
    are zeroed — those rows are identity rows everywhere.
    """
    b = np.zeros(mesh.num_dofs(P))
    for axis in range(3):
        for side in range(2):
            alpha = float(mesh.robin_alpha[axis, side])
            if alpha == 0.0:
                continue
            dofs, wts, _ = _face_surface_quadrature(mesh, P, axis, side)
            np.add.at(b, dofs.ravel(), alpha * wts.ravel())
    if bc_zero:
        b[mesh.boundary_dof_marker(P)] = 0.0
    return b


def robin_rhs_np(mesh: BoxMesh, P: int, g) -> np.ndarray:
    """Robin data contribution ``integral_Gamma g v ds`` to the load
    vector (float64, host). ``g`` is a callable over points
    ``x[(3, npts)]`` applied on every Robin face, or a dict keyed by
    ``(axis, side)`` of callables/scalars for per-face data. Dirichlet-
    marked entries are zeroed (identity rows). Add to `assemble_rhs`'s
    volume term."""
    b = np.zeros(mesh.num_dofs(P))
    for axis in range(3):
        for side in range(2):
            if float(mesh.robin_alpha[axis, side]) == 0.0:
                continue
            gf = g.get((axis, side), 0.0) if isinstance(g, dict) else g
            dofs, wts, pts = _face_surface_quadrature(mesh, P, axis, side)
            gv = (gf(pts.reshape(-1, 3).T).reshape(wts.shape)
                  if callable(gf) else float(gf))
            np.add.at(b, dofs.ravel(), (gv * wts).ravel())
    b[mesh.boundary_dof_marker(P)] = 0.0
    return b


def assemble_rhs(mesh: BoxMesh, P: int, f, bc: bool = True) -> np.ndarray:
    """Assemble ``b_i = integral f phi_i dx`` with the collocated GLL rule.

    With collocation the local load vector is diagonal:
    ``b_local[q] = w_q detJ_q f(x_q)``. With ``bc=True`` Dirichlet entries
    are zeroed afterwards (homogeneous ``set_bc``, reference
    examples/pmg/main.cpp:293-295 — `apply_lifting` is a no-op for g=0).
    """
    _, detJ = geometry_factors_np(mesh, P)
    w = quadrature_weights_3d(P)
    dofmap = mesh.dofmap(P)
    coords = mesh.dof_coords(P)[dofmap]  # (ncells, nld, 3)
    fvals = f(coords.reshape(-1, 3).T).reshape(dofmap.shape)
    b_local = w[None, :] * detJ * fvals
    b = np.zeros(mesh.num_dofs(P))
    np.add.at(b, dofmap.ravel(), b_local.ravel())
    if bc:
        b[mesh.boundary_dof_marker(P)] = 0.0
    return b


def resolve_sigma(sigma):
    """Split the reaction coefficient into ``(ops_scalar, field)``.

    A scalar passes through (``field=None``). A CALLABLE ``sigma(x)``
    (pointwise reaction field, evaluated at dof coordinates) returns
    ``(1.0, sigma)``: the field is baked into every level's ``m3``
    lumped-mass vector by `shifted_mass_np`, so the apply's
    ``ops_sigma * m3 * x`` term needs no changes anywhere — general
    backends only (the Kronecker/FDM paths need a separable shift).
    """
    if callable(sigma):
        return 1.0, sigma
    return float(sigma), None


def shifted_mass_np(mesh: BoxMesh, P: int, sigma_field=None,
                    bc_zero: bool = True) -> np.ndarray:
    """GLL-lumped mass, optionally scaled pointwise by the reaction
    field — the baked ``m3`` vector of the variable-sigma family."""
    m = lumped_mass_np(mesh, P, bc_zero=bc_zero)
    if sigma_field is not None:
        m = m * np.asarray(sigma_field(mesh.dof_coords(P).T), np.float64)
    return m


def ops_shift_scalar(mesh: BoxMesh, sigma, kron_family: bool = False):
    """The cycle-ops pointwise-shift scalar for a level on ``mesh`` —
    the SINGLE source of the scalar/m3 pairing policy (the m3 side is
    `general_shift_np`, whose returned scalar matches this).

    Robin faces on the GENERAL backends force the scalar to 1.0: the
    boundary mass and ``sigma * mass`` are baked together into the
    level's ``m3`` vector, so the apply's fused multiply-add carries
    both terms. The kron family instead carries Robin as per-axis 1D
    stiffness END updates (ops/kron.py), so its scalar stays the plain
    sigma. Every hierarchy class consumes this helper; hand-encoding
    the rule risks an operator that silently gains/loses the Robin or
    sigma term on one layout.
    """
    if getattr(mesh, "has_robin", False) and not kron_family:
        return 1.0
    return float(sigma)


def general_shift_np(mesh: BoxMesh, P: int, sigma, sigma_field=None):
    """``(ops_sigma, m3)`` — the pointwise shift of a GENERAL-backend
    level (lattice/dofmap applies add ``ops_sigma * m3 *
    u`` pointwise; the Jacobi diagonal adds the same term).

    Without Robin faces this is the plain sigma mechanism: the scalar
    rides the cycle-ops closure and ``m3`` is the (field-folded) lumped
    mass (``None`` when sigma is 0 — no pointwise pass at all). With
    Robin faces the GLL-diagonal boundary mass (`robin_mass_np`) is baked
    INTO ``m3`` together with ``sigma * mass`` and the scalar is forced
    to 1.0 — one fused multiply-add carries both terms. Every consumer
    (single-device, slab, grid, h-MG levels) shares this policy so
    sharded trajectories stay bit-identical to the single-device ones.
    """
    sigma = float(sigma)
    scalar = ops_shift_scalar(mesh, sigma)
    if not getattr(mesh, "has_robin", False):
        return scalar, (shifted_mass_np(mesh, P, sigma_field)
                        if sigma else None)
    m3 = robin_mass_np(mesh, P)
    if sigma:
        m3 = m3 + sigma * shifted_mass_np(mesh, P, sigma_field)
    return scalar, m3


def lifted_rhs(mesh: BoxMesh, P: int, kappa, f, g):
    """Inhomogeneous Dirichlet data ``u = g`` on the flagged faces:
    classic lifting. Returns ``(b_hom, u_g)`` — solve the homogeneous
    system ``A w = b_hom`` with any solver in the stack, then
    ``u = w + u_g``.

    ``u_g`` is ``g`` evaluated at the Dirichlet dofs, zero elsewhere;
    ``b_hom = b_raw - A_raw u_g`` with its Dirichlet rows zeroed — the
    reference's `apply_lifting` + `set_bc` step (examples/pmg/
    main.cpp:289-301, a no-op there because its g is 0; nonzero data is
    beyond-reference coverage). Host NumPy/scipy setup path (one raw
    assembled matvec), like the reference's host-side rhs assembly.
    The sigma (lumped-mass) shift needs NO extra term here: the lumped
    M is diagonal, so ``M u_g`` is supported on the Dirichlet rows the
    lifting zeroes anyway.
    """
    bc = np.asarray(mesh.boundary_dof_marker(P))
    u_g = np.zeros(mesh.num_dofs(P))
    coords = mesh.dof_coords(P)
    u_g[bc] = np.asarray(g(coords[bc].T), dtype=np.float64)
    b = assemble_rhs(mesh, P, f, bc=False)
    A = assemble_stiffness(mesh, P, kappa=kappa, bc=False)
    b = b - A @ u_g
    b[bc] = 0.0
    return b, u_g


def lumped_mass_np(mesh: BoxMesh, P: int, bc_zero: bool = False) -> np.ndarray:
    """GLL-lumped mass vector ``m[(ndofs,)]`` on ANY hex mesh (float64).

    With collocated GLL quadrature the consistent mass matrix is exactly
    diagonal: ``m_i = sum_{cells ∋ i} w_q detJ(c, q)`` at the node's
    collocation point. On an axis-aligned `BoxMesh` this reduces to the
    tensor product of the 1D lumped masses (``ops.kron.axis_stiffness_mass``
    — verified in tests); on curved / perturbed meshes it is the general
    lumped mass the shifted (reaction-diffusion) family needs. With
    ``bc_zero=True`` Dirichlet entries are zeroed (the shift never touches
    identity bc rows).
    """
    _, detJ = geometry_factors_np(mesh, P)
    w = quadrature_weights_3d(P)
    vals = w[None, :] * detJ
    m = np.zeros(mesh.num_dofs(P))
    np.add.at(m, mesh.dofmap(P).ravel(), vals.ravel())
    if bc_zero:
        m[mesh.boundary_dof_marker(P)] = 0.0
    return m


def resolve_kappa(mesh: BoxMesh, kappa):
    """Resolve a coefficient spec to ``(kappa_cells, is_constant)``.

    ``kappa`` may be a scalar, an ``(ncells,)`` array (a DG-0 field in
    dofmap cell order), a SYMMETRIC ``(3, 3)`` / per-cell
    ``(ncells, 3, 3)`` diffusion TENSOR (full anisotropic
    ``-div(kappa grad u)``; resolved to ``(ncells, 3, 3)`` and folded
    into the geometry factors by `geometry_factors(kappa=...)` — beyond
    the reference's scalar coefficient), or a callable over points
    ``x[(3, npts)]`` sampled at cell centroids returning either
    ``(npts,)`` scalars or ``(npts, 3, 3)`` tensors. This is the
    Counterpart of the reference interpolating a coefficient
    Function into DG-0 and passing it per cell through the stiffness
    kernel (src/laplacian.hpp:220-241, examples/pmg/main.cpp:253-257).
    ``is_constant`` is only ever True for the scalar-constant case.
    """
    if (isinstance(kappa, (tuple, list)) and len(kappa) == 3
            and all(np.ndim(k) == 0 for k in kappa)):
        # Per-axis spec (kx, ky, kz) — sugar for the diagonal tensor
        # (kron family extracts the axes back via resolve_kappa_axes;
        # general backends fold the diagonal into G).
        kappa = np.diag([float(k) for k in kappa])
    if callable(kappa):
        vals = np.asarray(
            kappa(mesh.cell_centroids().T), dtype=np.float64
        )
        if vals.ndim >= 2 and vals.shape[-2:] == (3, 3):
            kappa = vals.reshape(-1, 3, 3)  # tensor field: fall through
        else:
            vals = vals.reshape(-1)
            if vals.shape != (mesh.ncells,):
                raise ValueError(
                    f"kappa callable returned shape {vals.shape}, "
                    f"expected ({mesh.ncells},)"
                )
            return vals, bool(np.all(vals == vals[0]))
    arr = np.asarray(kappa, dtype=np.float64)
    if arr.ndim == 0:
        return np.full(mesh.ncells, float(arr)), True
    if arr.shape[-2:] == (3, 3) and arr.ndim in (2, 3):
        if arr.ndim == 3 and arr.shape[0] != mesh.ncells:
            raise ValueError(
                f"per-cell tensor kappa has shape {arr.shape}, expected "
                f"({mesh.ncells}, 3, 3)"
            )
        arr = np.broadcast_to(arr, (mesh.ncells, 3, 3)).copy()
        if not np.allclose(arr, np.swapaxes(arr, -1, -2)):
            raise ValueError("tensor kappa must be symmetric")
        return arr, False
    if arr.shape != (mesh.ncells,):
        raise ValueError(
            f"per-cell kappa has shape {arr.shape}, expected ({mesh.ncells},)"
            " — or (3, 3) / (ncells, 3, 3) for a diffusion tensor"
        )
    return arr.copy(), bool(np.all(arr == arr[0]))


def resolve_kappa_split(mesh: BoxMesh, kappa):
    """`resolve_kappa`, split for the geometry fold: returns
    ``(kappa_scalar, kappa_tensor, is_constant)`` where exactly one of
    the first two carries the coefficient — ``kappa_scalar`` is always a
    usable ``(ncells,)`` array (all-ones when the coefficient is a
    tensor, for consumers that need a per-cell scalar such as the
    dofmap-path ``coeff``), and ``kappa_tensor`` is ``None`` or the
    ``(ncells, 3, 3)`` field to pass to `geometry_factors(kappa=...)`.
    Pair with `scale_G` so the scalar path keeps its historical
    post-multiply (bit-identical) while the tensor path skips the
    (large, pointless) multiply by ones."""
    kc, const = resolve_kappa(mesh, kappa)
    if kc.ndim == 3:
        return np.ones(mesh.ncells), kc, False
    return kc, None, const


def resolve_kappa_axes(mesh: BoxMesh, kappa, split=None):
    """Resolve a KRON-FAMILY coefficient to per-axis scalars
    ``(kx, ky, kz)``.

    The Kronecker-sum factorization ``kx K(x)M(x)M + ky M(x)K(x)M + kz
    M(x)M(x)K`` survives any coefficient expressible as a CONSTANT
    DIAGONAL tensor — grid-aligned anisotropic diffusion rides the full
    Kronecker paths and the EXACT FDM direct solver (per-axis
    generalized eigenvalues just scale: ``d = kx lx + ky ly + kz lz``),
    where the general backends need a Krylov loop. Accepts a scalar
    (``(k, k, k)``), a length-3 sequence, or a constant diagonal
    ``(3, 3)`` / ``(ncells, 3, 3)`` tensor; raises ValueError for
    per-cell, off-diagonal, or otherwise non-separable coefficients
    (use the lattice/dofmap backends for those).
    """
    if (isinstance(kappa, (tuple, list)) and len(kappa) == 3
            and all(np.ndim(k) == 0 for k in kappa)):
        return tuple(float(k) for k in kappa)
    kc, kt, const = split if split is not None else resolve_kappa_split(
        mesh, kappa)
    if kt is None:
        if not const:
            raise ValueError(
                "the Kronecker-sum factorization needs a constant (or "
                "constant per-axis / diagonal-tensor) kappa; got a "
                "per-cell field — use operator='lattice' or 'dofmap'"
            )
        k = float(kc[0])
        return (k, k, k)
    if not np.allclose(kt, kt[0]):
        raise ValueError(
            "the Kronecker-sum factorization needs a CONSTANT diagonal "
            "tensor kappa; got a per-cell tensor field — use "
            "operator='lattice' or 'dofmap'"
        )
    K0 = kt[0]
    if not np.allclose(K0, np.diag(np.diag(K0))):
        raise ValueError(
            "the Kronecker-sum factorization needs a constant DIAGONAL "
            "tensor kappa (it cannot express cross-derivative terms); "
            f"got off-diagonal entries {K0.tolist()} — use "
            "operator='lattice' or 'dofmap'"
        )
    return tuple(float(v) for v in np.diag(K0))


def scale_G(G_cells, kappa_scalar, kappa_tensor):
    """Apply the scalar DG-0 coefficient to the geometry factors —
    identity when the coefficient was a tensor (already folded into
    ``G_cells`` by `geometry_factors(kappa=kappa_tensor)`)."""
    if kappa_tensor is not None:
        return G_cells
    return G_cells * kappa_scalar[:, None, None]


def stiffness_diagonal_np(mesh: BoxMesh, P: int, kappa=1.0) -> np.ndarray:
    """Operator diagonal in NumPy float64 (host, setup-time).

    Same formula as ops.laplacian.laplacian_diagonal; used by the
    distributed builder so the exact global diagonal never needs a
    device-wide scatter. ``kappa`` may be scalar or per-cell. BC rows
    get 1.
    """
    from .gll import derivative_matrix

    kc, kt, _ = resolve_kappa_split(mesh, kappa)
    G, _ = geometry_factors_np(mesh, P, kappa=kt)
    kappa = kc[:, None, None, None]
    n = P + 1
    g = G.reshape(mesh.ncells, n, n, n, 6)
    D = derivative_matrix(P)
    D2 = D * D
    d = np.diagonal(D)
    diag = (
        np.einsum("mi,cmjk->cijk", D2, g[..., 0])
        + np.einsum("mj,cimk->cijk", D2, g[..., 3])
        + np.einsum("mk,cijm->cijk", D2, g[..., 5])
        + 2.0
        * (
            d[:, None, None] * d[None, :, None] * g[..., 1]
            + d[:, None, None] * d[None, None, :] * g[..., 2]
            + d[None, :, None] * d[None, None, :] * g[..., 4]
        )
    ) * kappa
    out = np.zeros(mesh.num_dofs(P))
    np.add.at(out, mesh.dofmap(P).ravel(), diag.ravel())
    out[mesh.boundary_dof_marker(P)] = 1.0
    return out


def l2_error_collocated(mesh: BoxMesh, P: int, u_h: np.ndarray,
                        u_exact) -> float:
    """L2 error with the collocated GLL rule — valid on ANY mesh
    (general hexes included): err^2 = sum_cq w_q detJ_cq (u_h - u_e)^2
    at the physical dof points. Less accurate than `l2_error`'s
    Gauss-Legendre rule but geometry-general."""
    _, detJ = geometry_factors_np(mesh, P)
    w = quadrature_weights_3d(P)
    dofmap = mesh.dofmap(P)
    coords = mesh.dof_coords(P)[dofmap]  # (ncells, nld, 3)
    ue = u_exact(coords.reshape(-1, 3).T).reshape(dofmap.shape)
    diff = np.asarray(u_h)[dofmap] - ue
    return float(np.sqrt(np.sum(w[None, :] * detJ * diff**2)))


def l2_error(mesh: BoxMesh, P: int, u_h: np.ndarray, u_exact, nq: int | None = None) -> float:
    """Accurate L2 norm of ``u_h - u_exact`` via Gauss-Legendre quadrature.

    Counterpart of `norm_L2` in python_tests/pmg.py:41-45 (which uses the
    full-accuracy default measure, not the collocated GLL rule).
    """
    nq = nq or P + 3
    xq, wq = gauss_legendre(nq)
    xg, _ = gauss_lobatto(P + 1)
    phi1 = lagrange_tabulate(xg, xq, 0)[0]  # (nq, P+1)
    n = P + 1
    u_cells = u_h[mesh.dofmap(P)].reshape(mesh.nc + (n, n, n))
    uq = np.einsum("qi,rj,sk,cdeijk->cdeqrs", phi1, phi1, phi1, u_cells)
    # Quadrature-point physical coordinates (affine axis-aligned cells;
    # per-cell sizes — graded meshes supported).
    hx, hy, hz = mesh.h_cells
    X = mesh.axis_nodes(0)[:-1, None] + xq[None, :] * hx[:, None]
    Y = mesh.axis_nodes(1)[:-1, None] + xq[None, :] * hy[:, None]
    Z = mesh.axis_nodes(2)[:-1, None] + xq[None, :] * hz[:, None]
    pts = np.stack(
        np.broadcast_arrays(
            X[:, None, None, :, None, None],
            Y[None, :, None, None, :, None],
            Z[None, None, :, None, None, :],
        ),
        axis=0,
    )
    ue = u_exact(pts.reshape(3, -1)).reshape(uq.shape)
    w3 = np.einsum("q,r,s->qrs", wq, wq, wq)
    detJ = np.einsum("c,d,e->cde", hx, hy, hz)
    err2 = np.sum((uq - ue) ** 2 * w3[None, None, None]
                  * detJ[:, :, :, None, None, None])
    return float(np.sqrt(err2))
