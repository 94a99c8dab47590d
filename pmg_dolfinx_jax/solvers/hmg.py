"""Geometric h-multigrid on the structured lattice: the AMG replacement.

The reference's optional coarse-grid solver is hypre BoomerAMG behind a
PETSc KSP (src/amg.hpp, used at the p=1 level when `--amg` is passed).
Algebraic MG exists because unstructured meshes have no natural coarse
grids — but this framework's meshes are structured boxes, so *geometric*
h-coarsening (factor 2 per level, closed-form transfer operators) does the
same job with none of the setup machinery, and every level rides the same
Kronecker-sum operator as the rest of the framework.

Built as data for the SAME generic `v_cycle` used by the p-hierarchy
(solvers/pmg.py): levels differ by mesh spacing instead of polynomial
degree; transfers are per-axis 1D nodal interpolation matrices between
nested lattices (restriction = plain transpose, as for p-transfer);
smoothers are the same calibrated fourth-kind Chebyshev.

Used via ``PMGHierarchy(..., coarse='hmg')``: the p-multigrid coarse
(p=1) problem is approximately solved by a fixed number of nested h-MG
V-cycles, with a dense Cholesky (or Chebyshev) bottom solve on the
coarsest lattice. The composition p-MG over h-MG is the classic
"p-multigrid with h-multigrid coarse solve" that the reference emulates
with AMG.
"""

import jax.numpy as jnp
import numpy as np

from ..fem.gll import gauss_lobatto, lagrange_tabulate
from ..ops.blas import inner_product
from ..fem.mesh import BoxMesh
from .line import line_block_inverses, line_precond_apply, parse_line_smoother


def axis_h_interpolation(nc_coarse: int, P: int = 1, factor: int = 2,
                         dtype=np.float64, h_fine=None):
    """1D nodal interpolation from an ``nc_coarse``-cell lattice to the
    ``factor``-refined ``factor * nc_coarse``-cell lattice at degree P.

    ``I[f, c] = l_c^{coarse}(x_f^{fine})``; each coarse cell contains
    ``factor`` fine cells. Uniform spacing (``h_fine=None``): their
    nodes sit at ``(k + xg)/factor`` in the coarse cell's reference
    coordinates (one shared block per k). GRADED spacing: pass the fine
    level's per-cell widths ``h_fine[(factor * nc_coarse,)]`` — each
    coarse cell's children occupy their actual width fractions, so the
    blocks differ per coarse cell (coarse corner nodes remain an exact
    subset of the fine corners: coarsening merges cells).
    """
    xg, _ = gauss_lobatto(P + 1)
    Nf, Nc = factor * nc_coarse * P + 1, nc_coarse * P + 1
    I = np.zeros((Nf, Nc), dtype=dtype)
    if h_fine is None:
        blocks = [
            lagrange_tabulate(xg, (k + xg) / factor, 0)[0]  # (P+1, P+1)
            for k in range(factor)
        ]
    else:
        h_fine = np.asarray(h_fine, dtype=np.float64)
        if h_fine.shape != (factor * nc_coarse,):
            raise ValueError(
                f"h_fine must hold one width per FINE cell "
                f"({factor * nc_coarse},), got {h_fine.shape}")
    for c in range(nc_coarse):
        cols = slice(c * P, c * P + P + 1)
        if h_fine is not None:
            w = h_fine[factor * c:factor * (c + 1)]
            offs = np.concatenate(([0.0], np.cumsum(w)))
            W = offs[-1]
        for k in range(factor):
            fcell = factor * c + k
            rows = slice(fcell * P, fcell * P + P + 1)
            if h_fine is None:
                I[rows, cols] = blocks[k]
            else:
                pts = (offs[k] + xg * w[k]) / W
                I[rows, cols] = lagrange_tabulate(xg, pts, 0)[0]
    return I


def local_axis_h_interpolation(nc_c_local, P, factor, n_shards,
                               h_fine=None, dtype=np.float64):
    """LOCAL per-shard 1D h-transfer for the distributed hierarchies:
    ``(I, stacked)``.

    ``stacked=False``: one shard-invariant ``(Nf_l, Nc_l)`` block
    (uniform axis, or an unsharded axis carrying the full graded
    transfer directly). ``stacked=True``: per-shard ROW-STACKED blocks
    ``(S * Nf_l, Nc_l)`` (shard along rows, spec ``P(axis)`` — each
    shard reads its own block inside shard_map) — a SHARDED GRADED
    axis, where every shard's children sit at different width
    fractions. The same mechanism `ops.kron.local_axis_K` uses for
    per-shard stiffness blocks; the einsum transfer applies are
    unchanged (only the matrix VALUES differ per shard).
    """
    if h_fine is None:
        return axis_h_interpolation(nc_c_local, P, factor=factor,
                                    dtype=dtype), False
    h_fine = np.asarray(h_fine, dtype=np.float64)
    if n_shards == 1:
        return axis_h_interpolation(nc_c_local, P, factor=factor,
                                    dtype=dtype, h_fine=h_fine), False
    nfl = nc_c_local * factor
    blocks = [
        axis_h_interpolation(nc_c_local, P, factor=factor, dtype=dtype,
                             h_fine=h_fine[s * nfl:(s + 1) * nfl])
        for s in range(n_shards)
    ]
    return np.vstack(blocks), True


def coarsen_spacing(h_cells, nc_fine, nc_coarse):
    """Per-axis ABSOLUTE cell sizes of the ``nc_coarse`` mesh whose
    cells merge consecutive fine cells (``nc_fine[a] // nc_coarse[a]``
    each) — the grading-preserving h-coarsening rule: coarse corners
    stay an exact subset of the fine corners. Returns a `BoxMesh`
    ``spacing`` tuple (normalization is idempotent on absolute sizes)."""
    out = []
    for hc, nf, ncs in zip(h_cells, nc_fine, nc_coarse):
        f = nf // ncs
        out.append(np.asarray(hc, np.float64).reshape(ncs, f).sum(axis=1))
    return tuple(out)


def coarsenable_levels(nc, min_cells=2, max_levels=10, divisors=(1, 1, 1)):
    """Mesh sizes [finest, ..., coarsest], coarsening by factor 2 (or 3
    when 2 does not divide) while all axes stay above ``min_cells``.

    ``divisors`` constrains every level's cell counts to remain
    divisible per axis — the shard-alignment condition for the
    distributed (non-gathered) h-hierarchy, where each level must split
    into the same per-shard slabs (cells per shard stay integral)."""
    out = [tuple(nc)]
    cur = tuple(nc)
    while len(out) < max_levels:
        nxt = None
        for f in (2, 3):
            if all(c % f == 0 and c // f >= min_cells
                   and (c // f) % d == 0
                   for c, d in zip(cur, divisors)):
                nxt = tuple(c // f for c in cur)
                break
        if nxt is None:
            break
        cur = nxt
        out.append(cur)
    return out


def semicoarsen_sizes(nc, axes, min_cells=2, max_levels=10):
    """Mesh sizes [finest, ..., coarsest] coarsening ONLY the given
    ``axes`` (factor 2/3) until they bottom out, then all axes —
    SEMI-COARSENING, the geometric analogue of AMG's
    strength-of-connection coarsening for anisotropic problems
    (hypre BoomerAMG, the reference's src/amg.hpp coarse solver, does
    this algebraically): coarsen the strongly-coupled directions first
    so point smoothers stay effective on every level. Feed the result
    to ``coarse_cfg['sizes']`` / the ``sizes=`` builder argument.
    """
    out = [tuple(nc)]
    cur = tuple(nc)
    axes = tuple(axes)
    while len(out) < max_levels:
        nxt = None
        for f in (2, 3):
            cand = tuple(c // f if a in axes and c % f == 0
                         and c // f >= min_cells else c
                         for a, c in enumerate(cur))
            if cand != cur:
                nxt = cand
                break
        if nxt is None:
            # Strong axes bottomed out. Coarsening only the REMAINING
            # axes would re-grow the effective grid anisotropy the semi
            # levels just removed (couplings scale as k_a/h_a^2), so
            # continue only with RATIO-PRESERVING full coarsening —
            # every axis must divide — else stop.
            rest = coarsenable_levels(cur, min_cells=min_cells,
                                      max_levels=max_levels - len(out) + 1)
            out.extend(rest[1:])
            break
        cur = nxt
        out.append(cur)
    return out


def axis_coupling(mesh, kappa):
    """Per-axis effective coupling ``c_a = mean(kappa_aa) / h_a^2`` — the
    scale on which point smoothers act (large c_a = strong direction).
    Sources of anisotropy both count: a tensor coefficient's diagonal AND
    stretched cells (h_a from the mesh extent / cell counts). Shared by
    `semicoarsen_axes` and the line-smoother auto axis
    (solvers/line.py)."""
    from ..fem.assembly import resolve_kappa_split

    kc, kt, _ = resolve_kappa_split(mesh, kappa)
    if kt is not None:
        kaa = np.diagonal(kt.mean(axis=0))
    else:
        kaa = np.full(3, float(np.mean(kc)))
    # Mean spacing per axis: on a graded mesh this is the aggregate
    # coupling heuristic (per-cell anisotropy varies along the axis).
    h_eff = np.array([float(hc.mean()) for hc in mesh.h_cells])
    return kaa / h_eff ** 2


def semicoarsen_axes(mesh, kappa, threshold=4.0):
    """Detect the strongly-coupled axes for `semicoarsen_sizes` (the
    h-MG hierarchy should coarsen them first). Returns the axes whose
    `axis_coupling` exceeds ``threshold`` times the weakest — empty when
    the problem is (near-)isotropic, which `semicoarsen_sizes` treats as
    plain full coarsening."""
    c = axis_coupling(mesh, kappa)
    return tuple(a for a in range(3) if c[a] > threshold * c.min())


def validate_hmg_sizes(nc, sizes):
    """Fail fast on a malformed user hierarchy (``coarse_cfg['sizes']``):
    finest-first, sizes[0] == the mesh's nc, and every consecutive pair
    NESTED (each finer count an integer per-axis multiple of the next
    coarser — the condition `axis_h_interpolation` and
    `coarsen_cell_field` assume; violations otherwise surface as cryptic
    reshape/shape errors deep in setup or at cycle trace time)."""
    sizes = [tuple(int(c) for c in s) for s in sizes]
    for lvl in sizes:
        if len(lvl) != 3:
            raise ValueError(
                f"hmg sizes levels must be (ncx, ncy, ncz) triples, got "
                f"{lvl}"
            )
    if len(sizes) < 2:
        raise ValueError(f"hmg sizes needs >= 2 levels, got {sizes}")
    if sizes[0] != tuple(nc):
        raise ValueError(
            f"hmg sizes must start at the mesh's cell counts {tuple(nc)} "
            f"(finest first), got sizes[0]={sizes[0]}"
        )
    for lf, lc in zip(sizes, sizes[1:]):
        if any(c < 1 or f % c or f // c < 1 for f, c in zip(lf, lc)):
            raise ValueError(
                f"hmg sizes must be per-axis nested (finer divisible by "
                f"coarser): {lf} -> {lc}"
            )
        if lf == lc:
            raise ValueError(f"hmg sizes contains a repeated level {lf}")
    return sizes


def build_hmg(mesh, P, kappa, dtype, smoother_iters=2, min_cells=2,
              max_levels=10, precision="highest",
              calibration_iters=20, bottom="direct", sigma=0.0,
              sizes=None, smoother="cheb"):
    """Construct (levels, data, bottom) for the generic `v_cycle`.

    Levels are ordered coarse->fine like the p-hierarchy. Smoother
    calibration reuses the recorded-CG/Lanczos machinery per level.
    Returns the static Level tuple, the array pytree (levels/transfer and
    optionally the dense bottom factor), and the bottom-solve mode.
    ``sigma`` rediscretizes the shifted operator ``A + sigma M`` on every
    h-level (the shift uses each level's OWN lumped mass — the natural
    geometric-MG hierarchy for the reaction-diffusion family).
    ``smoother`` picks the per-level Chebyshev preconditioner: 'cheb'
    (point Jacobi, default) or 'line'/'line-x|y|z' (line relaxation
    along the strongly-coupled axis, solvers/line.py — the anisotropy
    remedy that keeps plain isotropic coarsening effective).
    """
    import jax

    from ..ops.kron import axis_stiffness_mass, kron_diagonal, robin_axis_ends
    from .cg import cg_solve
    from .pmg import (
        DEFAULT_CALIBRATION_RTOL,
        EIG_RANGE_FACTORS,
        Level,
        kron_cycle_ops,
    )
    from .tridiag import lanczos_eigenvalue_estimates

    from ..fem.assembly import resolve_kappa_axes

    kax = resolve_kappa_axes(mesh, kappa)  # scalar / per-axis / diag tensor
    if sizes is None:
        sizes = coarsenable_levels(mesh.nc, min_cells=min_cells,
                                   max_levels=max_levels)
    else:
        sizes = validate_hmg_sizes(mesh.nc, sizes)
    sizes = list(sizes)[::-1]  # coarse->fine
    robin = mesh.robin_alpha if getattr(mesh, "has_robin", False) else None
    # A GRADED fine mesh coarsens by MERGING cells (coarsen_spacing):
    # coarse corners stay an exact subset of the fine corners, so the
    # nodal transfers below interpolate between nested node sets.
    meshes = [BoxMesh(nc, extent=mesh.extent,
                      dirichlet_faces=mesh.dirichlet_faces, robin=robin,
                      spacing=(coarsen_spacing(mesh.h_cells, mesh.nc, nc)
                               if mesh.is_graded else None))
              for nc in sizes]
    ops = kron_cycle_ops(precision, sigma=sigma)
    # Scalar kappa keeps the historical scalar form (bit-identical
    # assembled blocks/bottom factor); true per-axis goes diagonal-tensor.
    kassemble = (float(kax[0]) if kax[0] == kax[1] == kax[2]
                 else np.diag(kax))
    schwarz = smoother == "schwarz"
    line_axis = (None if schwarz
                 else parse_line_smoother(smoother, mesh, np.diag(kax)))

    levels, level_data = [], []
    for m in meshes:
        lv = {}
        if line_axis is not None:
            lv["line_inv"] = jnp.asarray(
                line_block_inverses(m, P, kassemble, line_axis, sigma=sigma),
                dtype=dtype,
            )
        elif schwarz:
            from .schwarz import build_schwarz

            lv["schwarz"] = build_schwarz(m, P, kassemble, dtype,
                                          sigma=sigma)
        for a, (name, nc_a, h_a, k_a) in enumerate(
                zip("xyz", m.nc, m.h_cells, kax)):
            # Robin end terms are kappa-free and h-independent: the SAME
            # alpha end update rediscretizes on every coarsened level
            # (pre-divided by k_a, restored by the multiply below).
            K, mass = axis_stiffness_mass(
                nc_a, P, h_a, robin=robin_axis_ends(m, a, 1.0 / k_a))
            lv["K" + name] = jnp.asarray(k_a * K, dtype=dtype)
            lv["m" + name] = jnp.asarray(mass, dtype=dtype)
        bc = jnp.asarray(m.boundary_dof_marker(P))
        diag = kron_diagonal(
            (lv["Kx"], lv["Ky"], lv["Kz"]), (lv["mx"], lv["my"], lv["mz"]),
            bc, sigma=sigma,
        )
        # Lattice-shaped markers/diagonal: kron cycle vectors are 3D.
        lv["bc_marker"] = bc.reshape(m.lattice_shape(P))
        lv["diag_inv"] = (1.0 / diag).reshape(m.lattice_shape(P))
        level = Level(P=P, ndofs=m.num_dofs(P), smoother_iters=smoother_iters,
                      shape=m.lattice_shape(P),
                      line_axis=line_axis if line_axis is not None else 2)

        def _calib(lv_, b_, x0_, _level=level):
            A = lambda x: ops["apply"](lv_, x, _level)
            # Calibrate lmax for the SAME preconditioned operator the
            # smoother will iterate on (M^-1 A: line / schwarz / Jacobi).
            pre = None
            if line_axis is not None:
                pre = lambda r: line_precond_apply(
                    lv_["line_inv"], r, _level.shape, line_axis)
            elif schwarz:
                from .schwarz import schwarz_precond_apply

                pre = lambda r: schwarz_precond_apply(
                    lv_["schwarz"], r, _level.shape, _level.P)
            return cg_solve(
                A, b_, x0_, lv_["diag_inv"],
                rtol=DEFAULT_CALIBRATION_RTOL, maxiter=calibration_iters,
                record=True, dot=inner_product, precond=pre,
            )

        _, info = jax.jit(_calib)(
            lv,
            jnp.ones(level.shape, dtype=dtype),
            jnp.zeros(level.shape, dtype=dtype),
        )
        try:
            eigs = lanczos_eigenvalue_estimates(
                info["alphas"], info["betas"], info["stored"]
            )
            lmax = float(eigs[-1])
        except ValueError:
            # Near-trivial level (CG converged in < 2 iterations): the
            # Jacobi-preconditioned spectrum is within (0, 2]; use the
            # safe upper bound.
            lmax = 2.0
        lv["lmax"] = jnp.asarray(EIG_RANGE_FACTORS[1] * lmax, dtype=dtype)
        levels.append(level)
        level_data.append(lv)

    transfer = []
    for i in range(len(meshes) - 1):
        mc, mf = meshes[i], meshes[i + 1]
        tr = {
            "I" + name: jnp.asarray(
                axis_h_interpolation(
                    nc_c, P, factor=nc_f // nc_c,
                    h_fine=mf.h_cells[a] if mf.is_graded else None),
                dtype=dtype,
            )
            for a, (name, nc_c, nc_f) in enumerate(
                zip("xyz", mc.nc, mf.nc))
        }
        transfer.append(tr)

    data = dict(levels=tuple(level_data), transfer=tuple(transfer))
    if bottom not in ("direct", "cg", "smoother"):
        # 'fdm' bottoms exist on the DISTRIBUTED builders only
        # (build_hmg_dist / build_hmg_grid, coarse_cfg['bottom']='fdm'
        # with dist=True) — here the gathered direct solve is already
        # exact and cheaper to set up.
        raise ValueError(
            f"build_hmg: unsupported bottom '{bottom}' "
            "(choose from direct, cg, smoother)"
        )
    if bottom == "direct" and meshes[0].num_dofs(P) > 4096:
        # A dense factor at this size would dwarf the cycle; fall back to
        # a Krylov bottom solve (the coarse-grid role hypre's own nested
        # hierarchy plays in the reference).
        bottom = "cg"
    if bottom == "direct":
        from ..fem.assembly import assemble_stiffness, lumped_mass_np

        A0 = assemble_stiffness(meshes[0], P, kappa=kassemble).toarray()
        if sigma:
            A0[np.diag_indices_from(A0)] += sigma * lumped_mass_np(
                meshes[0], P, bc_zero=True
            )
        data["coarse_chol"] = jnp.asarray(np.linalg.cholesky(A0), dtype=dtype)
    return tuple(levels), data, bottom


def coarsen_cell_field(vals, nc_fine, nc_coarse, h_cells=None):
    """Volume-average a per-cell DG-0 field onto a coarser cell grid
    (each coarse cell averages its ``f^3`` children). On uniform meshes
    the plain mean IS the volume average; pass the fine mesh's
    ``h_cells`` for a GRADED mesh so children are weighted by their
    actual volumes."""
    fx, fy, fz = (nf // nc for nf, nc in zip(nc_fine, nc_coarse))
    vals = np.asarray(vals)
    tail = vals.shape[1:]  # () for scalars, (3, 3) for tensor kappa
    v = vals.reshape(nc_fine + tail)
    v = v.reshape((nc_coarse[0], fx, nc_coarse[1], fy, nc_coarse[2], fz)
                  + tail)
    if h_cells is None:
        return v.mean(axis=(1, 3, 5)).reshape((-1,) + tail)
    hx, hy, hz = (np.asarray(h, np.float64) for h in h_cells)
    w = (hx.reshape(nc_coarse[0], fx)[:, :, None, None, None, None]
         * hy.reshape(nc_coarse[1], fy)[None, None, :, :, None, None]
         * hz.reshape(nc_coarse[2], fz)[None, None, None, None, :, :])
    w = w / w.sum(axis=(1, 3, 5), keepdims=True)
    w = w.reshape(w.shape + (1,) * len(tail))
    return (v * w).sum(axis=(1, 3, 5)).reshape((-1,) + tail)


def build_hmg_general(mesh, P, kappa, dtype, smoother_iters=2, min_cells=2,
                      max_levels=10, precision="highest",
                      calibration_iters=20, bottom="direct", sigma=0.0,
                      sizes=None, smoother="cheb", sigma_field=None):
    """Geometric h-multigrid for the GENERAL model family: curved
    (perturbed) hexes and variable DG-0 coefficients — the scalable
    coarse solver the reference gets from hypre BoomerAMG
    (src/amg.hpp:11-119) on meshes where the constant-coefficient
    box-only `build_hmg` refuses.

    Levels rediscretize the lattice-backend operator on factor-2(3)
    coarsened meshes of the SAME class: `PerturbedBoxMesh` evaluates its
    smooth warp at the coarse corner lattice, which is an exact subset of
    the fine corners — geometry factors are recomputed per level, so
    every level solves the true curved operator on its own mesh.
    Variable DG-0 kappa is volume-averaged onto each level's cells; the
    lumped-mass sigma shift rediscretizes per level. Transfers are the
    per-axis nodal h-interpolation matrices in REFERENCE coordinates
    (`axis_h_interpolation`) — on curved cells this is the standard
    reference-space transfer of geometric MG (inexact interpolation of
    the physical map, asymptotically harmless and tested against the
    direct coarse solve).
    """
    import jax

    from ..fem.assembly import (
        lumped_mass_np,
        resolve_kappa,
        scale_G,
        stiffness_diagonal_np,
    )
    from ..fem.geometry import (
        geometry_factors,
        quadrature_weights_3d,
        tabulate_geometry_dphi,
    )
    from ..fem.mesh import BoxMesh, PerturbedBoxMesh
    from ..ops.lattice import axis_matrices, geometry_to_qlattice
    from .cg import cg_solve
    from .pmg import (
        DEFAULT_CALIBRATION_RTOL,
        EIG_RANGE_FACTORS,
        Level,
        lattice_cycle_ops,
    )
    from .tridiag import lanczos_eigenvalue_estimates

    if sizes is None:
        sizes = coarsenable_levels(mesh.nc, min_cells=min_cells,
                                   max_levels=max_levels)
    else:
        sizes = validate_hmg_sizes(mesh.nc, sizes)
    sizes = list(sizes)[::-1]  # coarse->fine
    robin = mesh.robin_alpha if getattr(mesh, "has_robin", False) else None
    # Graded fine meshes coarsen by merging cells (grading-preserving;
    # the warp then evaluates at the SAME corner positions on every
    # level — coarse corners stay an exact subset of the fine ones).
    def _sp(nc):
        return (coarsen_spacing(mesh.h_cells, mesh.nc, nc)
                if mesh.is_graded else None)

    if isinstance(mesh, PerturbedBoxMesh):
        meshes = [PerturbedBoxMesh(nc, extent=mesh.extent, warp=mesh._warp,
                                   dirichlet_faces=mesh.dirichlet_faces,
                                   robin=robin, spacing=_sp(nc))
                  for nc in sizes]
    else:
        meshes = [BoxMesh(nc, extent=mesh.extent,
                          dirichlet_faces=mesh.dirichlet_faces, robin=robin,
                          spacing=_sp(nc))
                  for nc in sizes]
    kappa_fine, _ = resolve_kappa(mesh, kappa)
    # Robin rides the baked pointwise-shift path (rediscretized per
    # h-level, like a sigma field); shared scalar policy:
    # fem.assembly.ops_shift_scalar.
    from ..fem.assembly import ops_shift_scalar

    ops_sigma = ops_shift_scalar(mesh, sigma)
    ops = lattice_cycle_ops(precision, sigma=ops_sigma)
    schwarz = smoother == "schwarz"
    line_axis = (None if schwarz
                 else parse_line_smoother(smoother, mesh, kappa))

    levels, level_data = [], []
    for m in meshes:
        if callable(kappa):
            kc, _ = resolve_kappa(m, kappa)
        else:
            kc = coarsen_cell_field(kappa_fine, mesh.nc, m.nc,
                                    h_cells=(mesh.h_cells if mesh.is_graded
                                             else None))
        kfold = kc if kc.ndim == 3 else None  # tensor: fold into G
        G_cells, _ = geometry_factors(
            m.geometry_x, m.geometry_dofmap,
            tabulate_geometry_dphi(P), quadrature_weights_3d(P), xp=np,
            kappa=kfold,
        )
        lv = dict(
            G=jnp.asarray(
                geometry_to_qlattice(scale_G(G_cells, kc, kfold), m.nc, P),
                dtype=dtype,
            ),
            bc_marker=jnp.asarray(m.boundary_dof_marker(P)),
        )
        for name, nc_a in zip("xyz", m.nc):
            E, Dg = axis_matrices(nc_a, P)
            lv["E" + name] = jnp.asarray(E, dtype=dtype)
            lv["D" + name] = jnp.asarray(Dg, dtype=dtype)
        diag = stiffness_diagonal_np(m, P, kc)
        if ops_sigma:
            # A sigma FIELD (sigma_field) is baked into m3, re-evaluated
            # at THIS level's dof coordinates (rediscretized shift);
            # Robin boundary mass bakes the same way (robin_mass_np on
            # THIS level's faces) — shared policy: general_shift_np.
            from ..fem.assembly import general_shift_np

            m3 = general_shift_np(m, P, sigma, sigma_field)[1]
            lv["m3"] = jnp.asarray(m3, dtype=dtype)
            diag = diag + ops_sigma * m3
        lv["diag_inv"] = jnp.asarray(1.0 / diag, dtype=dtype)
        if line_axis is not None:
            lv["line_inv"] = jnp.asarray(
                line_block_inverses(m, P, kc, line_axis, sigma=sigma),
                dtype=dtype,
            )
        elif schwarz:
            from .schwarz import build_schwarz

            # Separable approximation on the general family: per-cell
            # (volume-averaged) coefficients, nominal box geometry.
            lv["schwarz"] = build_schwarz(m, P, kc, dtype, sigma=sigma)
        level = Level(P=P, ndofs=m.num_dofs(P),
                      smoother_iters=smoother_iters,
                      shape=m.lattice_shape(P),
                      line_axis=line_axis if line_axis is not None else 2)

        def _calib(lv_, b_, x0_, _level=level):
            A = lambda x: ops["apply"](lv_, x, _level)
            # Same preconditioned operator the smoother iterates on.
            pre = None
            if line_axis is not None:
                pre = lambda r: line_precond_apply(
                    lv_["line_inv"], r, _level.shape, line_axis)
            elif schwarz:
                from .schwarz import schwarz_precond_apply

                pre = lambda r: schwarz_precond_apply(
                    lv_["schwarz"], r, _level.shape, _level.P)
            return cg_solve(
                A, b_, x0_, lv_["diag_inv"],
                rtol=DEFAULT_CALIBRATION_RTOL, maxiter=calibration_iters,
                record=True, dot=inner_product, precond=pre,
            )

        _, info = jax.jit(_calib)(
            lv,
            jnp.ones(level.ndofs, dtype=dtype),
            jnp.zeros(level.ndofs, dtype=dtype),
        )
        try:
            eigs = lanczos_eigenvalue_estimates(
                info["alphas"], info["betas"], info["stored"]
            )
            lmax = float(eigs[-1])
        except ValueError:
            lmax = 2.0  # near-trivial level (see build_hmg)
        lv["lmax"] = jnp.asarray(EIG_RANGE_FACTORS[1] * lmax, dtype=dtype)
        levels.append(level)
        level_data.append(lv)

    transfer = []
    for i in range(len(meshes) - 1):
        mc, mf = meshes[i], meshes[i + 1]
        tr = {
            "I" + name: jnp.asarray(
                axis_h_interpolation(
                    nc_c, P, factor=nc_f // nc_c,
                    h_fine=mf.h_cells[a] if mf.is_graded else None),
                dtype=dtype,
            )
            for a, (name, nc_c, nc_f) in enumerate(
                zip("xyz", mc.nc, mf.nc))
        }
        transfer.append(tr)

    data = dict(levels=tuple(level_data), transfer=tuple(transfer))
    if bottom not in ("direct", "cg", "smoother"):
        raise ValueError(
            f"build_hmg_general: unsupported bottom '{bottom}' "
            "(choose from direct, cg, smoother; 'fdm' is "
            "constant-coefficient only — kron hierarchies)"
        )
    if bottom == "direct" and meshes[0].num_dofs(P) > 4096:
        bottom = "cg"
    if bottom == "direct":
        from ..fem.assembly import assemble_stiffness

        if callable(kappa):
            kc0, _ = resolve_kappa(meshes[0], kappa)
        else:
            kc0 = coarsen_cell_field(kappa_fine, mesh.nc, meshes[0].nc,
                                     h_cells=(mesh.h_cells if mesh.is_graded
                                              else None))
        A0 = assemble_stiffness(meshes[0], P, kappa=kc0).toarray()
        if sigma:
            from ..fem.assembly import shifted_mass_np

            A0[np.diag_indices_from(A0)] += sigma * shifted_mass_np(
                meshes[0], P, sigma_field
            )
        data["coarse_chol"] = jnp.asarray(np.linalg.cholesky(A0),
                                          dtype=dtype)
    return tuple(levels), data, bottom, ops
