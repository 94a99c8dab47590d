"""The p-multigrid V-cycle preconditioner.

JAX redesign of `acc::MultigridPreconditioner` (reference
src/pmg.hpp:16-185) plus the hierarchy setup logic of the pmg driver
(examples/pmg/main.cpp:303-355). The reference composes device objects and
launches dozens of kernels + MPI calls per cycle; here the whole V-cycle —
smoothers, residuals, transfers, coarse solve — is a single jitted program
over a pytree of per-level arrays. XLA sees the entire cycle and fuses
across stages; under `shard_map` the same function runs SPMD with psum
reductions.

Cycle structure (matches pmg.hpp:56-155 operation-for-operation):

    u[top] = u_in, b[top] = b_in, u[i < top] = 0
    DOWN  for i = top..1:
        pre-smooth  u[i] <- Chebyshev4(A_i, b[i], u[i])
        residual    r = b[i] - A_i u[i]
        restrict    b[i-1] = I_i^T (r / mult)
    COARSE:
        b[0] *= (1 - bc_marker)                    [pmg.hpp:100-103]
        u[0] = coarse_solve(b[0])   (level-0 smoother if no coarse solver,
                                     pmg.hpp:106-109; CG or dense Cholesky
                                     replace the hypre AMG path)
    UP    for i = 0..top-1:
        prolong     du = I_i u[i];  u[i+1] += du
        post-smooth u[i+1] <- Chebyshev4(A_{i+1}, b[i+1], u[i+1])

Smoother calibration follows examples/pmg/main.cpp:303-330: 20 recorded
Jacobi-CG iterations on ``A x = 1``, Lanczos eigenvalue estimates, then
``eig_range = (0.1, 1.1) * lambda_max`` and 2 Chebyshev iterations.
"""

from dataclasses import dataclass
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.assembly import ops_shift_scalar, resolve_kappa_split, scale_G
from ..fem.geometry import (
    geometry_factors,
    quadrature_weights_3d,
    tabulate_geometry_dphi,
)
from ..fem.gll import derivative_matrix, interpolation_matrix_1d
from ..ops.blas import inner_product
from ..ops.interpolate import prolongate, restrict
from ..ops.laplacian import laplacian_apply, laplacian_diagonal
from .cg import cg_solve
from .chebyshev import chebyshev4_solve
from .tridiag import lanczos_eigenvalue_estimates

DEFAULT_SMOOTHER_ITERS = 2
DEFAULT_CALIBRATION_ITERS = 20
DEFAULT_CALIBRATION_RTOL = 1e-6
EIG_RANGE_FACTORS = (0.1, 1.1)  # examples/pmg/main.cpp:327


def warn_high_precision_stationary(precision):
    """Runtime guard shared by every stationary-solve entry point
    (PMGHierarchy / DistPMG / GridPMG). On an H100, f32 matmuls at
    precision 'high' or 'default' run in TF32: `chip_smoke.py` measured
    a 1.7e-4 (kron) / 2.3e-4 (lattice) relative operator error against
    the f64 reference at 2.05M dofs, p=6, and 16 stationary V-cycles at
    'high' DIVERGED (relative residual 1.3e3, vs 2.2e-4 at 'highest').
    The smoother reinjects the perturbed operator on every sweep; the
    FCG / refined outer loops recompute the true residual instead. The
    float64 path ignores ``precision``. Measured at 2.05M dofs; nothing
    suggests a size below which it is safe."""
    if precision in ("high", "default"):
        import warnings

        warnings.warn(
            f"stationary V-cycle iteration with precision={precision!r} "
            "(TF32 matmuls on GPUs with tensor cores) diverged in "
            "measurement (H100, 2.05M dofs); use solve_pcg / "
            "solve_refined, which recompute the outer residual "
            "exactly, or precision='highest'",
            stacklevel=3,
        )


def warn_tensor_stationary(kappa_fold, kappa_axes=None, operator="",
                           line=False):
    """Runtime guard shared by every stationary-solve entry point:
    with a strongly anisotropic tensor kappa the STATIONARY V-cycle
    iteration can diverge — measured: rotated 100:1 anisotropy, three
    levels (1,3,6), diverges with the default 2 Chebyshev iterations
    while FCG(V) converges in 10 iterations with discretization-level
    L2 error. Three measured remedies (tests/test_tensor_kappa.py,
    tests/test_line.py):

    - Raising ``smoother_iters`` restores contraction; the threshold
      is problem-dependent (3 on the cubic 6x6x6 mesh, 4 on an
      elongated 3x7x10 box whose cell aspect ratios compound the
      tensor anisotropy). The divergence lives at the HIGH-p levels:
      the default 2 point-Jacobi-Chebyshev sweeps leave too much
      strongly-coupled error for the p-coarse correction.
    - coarse-OPERATOR quality is NOT the issue: a true Galerkin
      (I^T A I, whole chain) and an exactly-integrated Q1 coarse both
      diverge identically to the GLL rediscretization at
      smoother_iters=2 (two-level (1,3) cycles converge for all three
      — the p=3 GLL rule already integrates Q1 gradients exactly, so
      Galerkin == exact Q1 there).
    - ``smoother='line'`` (line relaxation along the dominant axis,
      solvers/line.py) restores stationary contraction at the default
      smoother_iters AND cuts FCG counts (diag(1,1,64): 80+ -> 7
      iterations); moderate sizes only (dense per-line blocks).

    The Krylov outer loop (solve_pcg) remains the robust default.
    Diagonal tensors on the KRON family are exempt (the per-axis
    Kronecker structure is exact at every level; verified convergent
    with the fdm coarse), as are hierarchies already running the line
    smoother (``line=True`` — the remedy this warning recommends)."""
    if line:
        return  # line or schwarz smoother active — the remedies themselves
    if kappa_axes is not None and operator == "kron":
        return
    if kappa_fold is not None:
        import warnings

        warnings.warn(
            "stationary V-cycle iteration with a tensor (anisotropic) "
            "kappa can diverge for strong off-axis anisotropy; prefer "
            "solve_pcg, which is robust (measured: rotated 100:1 "
            "anisotropy, FCG(V) 10 iterations), or raise "
            "smoother_iters (3-4 measured to restore stationary "
            "contraction, threshold problem-dependent) or use "
            "smoother='line' at moderate sizes; a better coarse "
            "operator does not help — the divergence lives at the "
            "high-p smoothing levels",
            stacklevel=3,
        )


def pcast_varying(v, axes):
    """Idempotent `jax.lax.pcast(..., to="varying")`: promotes only the
    mesh axes the value does not already vary over (pcast itself rejects
    already-varying inputs). Identity outside shard_map."""
    try:
        cur = jax.typeof(v).vma
    except Exception:
        cur = ()
    missing = tuple(a for a in axes if a not in cur)
    return jax.lax.pcast(v, missing, to="varying") if missing else v


@dataclass(frozen=True)
class Level:
    """Static metadata for one p-level (arrays live in the data pytree).

    ``ndofs`` is the (shard-)local vector length; ``shape`` the local
    lattice shape (used by the distributed halo exchange; None on a single
    device).
    """

    P: int
    ndofs: int
    smoother_iters: int = DEFAULT_SMOOTHER_ITERS
    shape: tuple | None = None
    # Static DSS layout sizes (`ops.unstructured.DSSMeta`) when the
    # level runs the unstructured row-gather backend; None otherwise.
    dss: object = None
    # Line-relaxation axis when the level's data carries "line_inv"
    # blocks (solvers/line.py); ignored for point-Jacobi levels.
    line_axis: int = 2


def _level_operator(lv, sigma=0.0):
    """Bind a level's arrays into an ``x -> A x`` callable (trace-safe).

    ``sigma`` adds the GLL-lumped mass shift ``sigma * m3 * x`` (``m3``
    is the bc-zeroed lumped mass in the level data — pointwise, so bc
    identity rows are untouched)."""
    if not sigma:
        return lambda x: laplacian_apply(
            x, lv["dofmap"], lv["G"], lv["coeff"], lv["D"], lv["bc_marker"]
        )

    def apply(x):
        from ..ops.laplacian import laplacian_scatter_raw

        y = laplacian_scatter_raw(
            x, lv["dofmap"], lv["G"], lv["coeff"], lv["D"], lv["bc_marker"]
        )
        y = y + sigma * lv["m3"] * x
        return jnp.where(lv["bc_marker"], x, y)

    return apply


def _generic_calibration(lv, b, x0, *, ops, level, maxiter):
    A = lambda x: ops["apply"](lv, x, level)
    # Calibrate lmax for the SAME preconditioned operator the smoother
    # will iterate on: M_line^-1 A when the level carries line-relaxation
    # blocks (solvers/line.py), D^-1 A otherwise.
    pre = None
    if "line_inv" in lv:
        from .line import line_precond_apply

        pre = lambda r: line_precond_apply(
            lv["line_inv"], r, level.shape, level.line_axis)
    elif "schwarz" in lv:
        if level.dss is not None:
            from .schwarz_dss import dss_schwarz_apply

            xde = ops.get("dss_exchange")
            pre = lambda r: dss_schwarz_apply(
                lv["schwarz"], r, lv, level.dss,
                exchange=(None if xde is None
                          else lambda y: xde(y, lv, level.dss)))
        else:
            from .schwarz import schwarz_precond_apply

            pre = lambda r: schwarz_precond_apply(
                lv["schwarz"], r, level.shape, level.P,
                exchange=ops.get("exchange"))
    return cg_solve(
        A, b, x0, lv["diag_inv"],
        rtol=DEFAULT_CALIBRATION_RTOL, maxiter=maxiter, record=True,
        dot=lambda u, v: ops["dot"](u, v, lv),
        precond=pre,
    )


def default_cycle_ops(sigma=0.0):
    """Single-device implementations of the pluggable V-cycle primitives.

    The distributed layer (`parallel.dist`) swaps these for shard-local
    versions with halo partial-sum exchanges and psum inner products —
    the V-cycle logic itself is identical in both worlds (the analogue of
    the reference templating its PMG over Vector/Operator types,
    pmg.hpp:14-15).
    """
    return dict(
        apply=lambda lv, x, level: _level_operator(lv, sigma=sigma)(x),
        restrict=lambda tr, r, level_c, level_f: restrict(
            r, tr["dofmap_c"], tr["dofmap_f"], tr["M1"], tr["mult_f"],
            level_c.ndofs,
        ),
        prolong=lambda tr, u, level_c, level_f: prolongate(
            u, tr["dofmap_c"], tr["dofmap_f"], tr["M1"], level_f.ndofs
        ),
        dot=lambda u, v, lv: inner_product(u, v),
        # Marks freshly created arrays as device-varying under shard_map
        # (vma tracking); identity on a single device.
        pvary=lambda v: v,
    )


def csr_cycle_ops():
    """V-cycle primitives whose operator applies are ASSEMBLED sparse
    matvecs (BCOO `ops.csr.MatrixOperator` matrices in the level data) —
    the reference's CSR fine-operator path: its PMG solve is templated
    over the operator type and runs on `acc::MatrixOperator` exactly as
    on the matrix-free kernel (examples/pmg/main.cpp:40-43,
    src/csr.hpp:221-269). Dirichlet rows/columns are eliminated with
    unit diagonal AT ASSEMBLY, and any sigma/Robin pointwise shift is
    baked into the matrix diagonal, so ``A @ x`` alone reproduces the
    matrix-free bc/shift semantics. Transfers/dot are the dofmap-family
    primitives (the two backends share level transfer data).

    This backend exists for reference parity, oracles, and small
    problems; the matrix-free backends are the production paths
    (`ops/csr.py` module docstring).
    """
    ops = default_cycle_ops()
    ops["apply"] = lambda lv, x, level: lv["A"] @ x
    return ops


def dss_cycle_ops(precision="highest", sigma=0.0):
    """V-cycle primitives for UNSTRUCTURED hex topology backed by the
    row-gather DSS operator (`ops.unstructured`) — the fast path the
    reference gets from its topology-agnostic GPU kernel
    (src/laplacian.hpp:143-278). Operator applies AND p-transfers run
    the entity-blocked row-gather machinery; no element gathers or
    scatters anywhere in the cycle. ``sigma`` adds the
    GLL-lumped mass shift via the bc-zeroed ``m3`` level vector, like
    the general backends."""
    from ..ops.unstructured import (
        dss_laplacian_apply,
        dss_prolongate,
        dss_restrict,
    )

    def apply_op(lv, x, level):
        return dss_laplacian_apply(x, lv, level.dss, precision=precision,
                                   sigma=sigma)

    tprec = "highest"  # transfers are cheap; keep them exact
    return dict(
        apply=apply_op,
        restrict=lambda tr, r, level_c, level_f: dss_restrict(
            r, tr["M1"], tr["tf"], level_f.dss, tr["tc"], level_c.dss,
            tr["inv_mult_f"], precision=tprec,
        ),
        prolong=lambda tr, u, level_c, level_f: dss_prolongate(
            u, tr["M1"], tr["tc"], level_c.dss, tr["tf"], level_f.dss,
            precision=tprec,
        ),
        dot=lambda u, v, lv: inner_product(u, v),
        pvary=lambda v: v,
    )


def kron_cycle_ops(precision="highest", sigma=0.0):
    """V-cycle primitives backed by the Kronecker-sum operator
    (`ops.kron`) — 3 banded matmuls per apply; the production path for
    axis-aligned box meshes. Transfers use the lattice per-axis matmuls.

    LATTICE-SHAPED vectors: all primitives carry ``(NX, NY, NZ)`` arrays
    (the ``zeros`` hook creates them; ``bc_marker``/``diag_inv`` in the
    level data are lattice-shaped too)."""
    from ..ops.kron import kron_laplacian_apply
    from ..ops.lattice import lattice_prolongate, lattice_restrict

    def apply_op(lv, x, level):
        return kron_laplacian_apply(
            x, (lv["Kx"], lv["Ky"], lv["Kz"]), (lv["mx"], lv["my"], lv["mz"]),
            lv["bc_marker"], precision=precision, sigma=sigma,
        )

    return dict(
        apply=apply_op,
        restrict=lambda tr, r, level_c, level_f: lattice_restrict(
            r, (tr["Ix"], tr["Iy"], tr["Iz"]), level_f.shape, precision
        ),
        prolong=lambda tr, u, level_c, level_f: lattice_prolongate(
            u, (tr["Ix"], tr["Iy"], tr["Iz"]), level_c.shape, precision
        ),
        dot=lambda u, v, lv: inner_product(u, v),
        pvary=lambda v: v,
        zeros=lambda level, dtype: jnp.zeros(level.shape, dtype=dtype),
    )


def lattice_cycle_ops(precision="highest", sigma=0.0):
    """V-cycle primitives backed by the lattice fast path
    (`ops.lattice`): banded per-axis matmuls for the operator AND the
    inter-degree transfers — no indexed gathers anywhere in the cycle.
    ``sigma`` adds the GLL-lumped mass shift (general meshes: the lumped
    mass is the scatter-added ``w detJ``, `fem.assembly.lumped_mass_np`,
    carried bc-zeroed as ``m3`` in the level data)."""
    from ..ops.lattice import (
        lattice_laplacian_apply,
        lattice_prolongate,
        lattice_restrict,
    )

    def apply_op(lv, x, level):
        mats = {k: lv[k] for k in ("Ex", "Dx", "Ey", "Dy", "Ez", "Dz")}
        y = lattice_laplacian_apply(
            x, mats, lv["G"], lv["bc_marker"], precision=precision,
            apply_bc=False,
        )
        if sigma:
            y = y + sigma * lv["m3"] * x
        return jnp.where(lv["bc_marker"], x, y)

    return dict(
        apply=apply_op,
        restrict=lambda tr, r, level_c, level_f: lattice_restrict(
            r, (tr["Ix"], tr["Iy"], tr["Iz"]), level_f.shape, precision
        ),
        prolong=lambda tr, u, level_c, level_f: lattice_prolongate(
            u, (tr["Ix"], tr["Iy"], tr["Iz"]), level_c.shape, precision
        ),
        dot=lambda u, v, lv: inner_product(u, v),
        pvary=lambda v: v,
    )


def v_cycle(data, b_in, u_in, *, levels, coarse="smoother", coarse_cfg=None,
            ops=None, diagnostics=False):
    """One V-cycle ``u_out = PMG(b_in, u_in)`` (pure, jittable).

    ``data`` is the pytree built by `PMGHierarchy`: per-level operator
    arrays + ``diag_inv``/``lmax``, inter-level transfer arrays, and the
    optional dense coarse factor. ``levels`` (tuple of `Level`) and
    ``coarse`` (one of 'smoother' | 'cg' | 'direct') are static. ``ops``
    supplies the apply/transfer/dot primitives (see `default_cycle_ops`).
    ``coarse_cfg['gamma']`` selects the cycle index: 1 = V-cycle
    (default), 2 = W-cycle (see the mu-cycle branch below).
    """
    L = len(levels)
    coarse_cfg = coarse_cfg or {}
    ops = ops or default_cycle_ops()
    lvs = data["levels"]
    us = [None] * L
    bs = [None] * L
    us[L - 1] = u_in
    bs[L - 1] = b_in
    diag = {"pre": [], "post": []} if diagnostics else None
    dot = ops["dot"]
    fresh = ops.get("pvary", lambda v: v)
    zeros = ops.get("zeros",
                    lambda level, dtype: jnp.zeros(level.ndofs, dtype=dtype))
    # Smoother hook: backends may fuse the Chebyshev update into their
    # operator kernels (ops['smooth']); the default composes the generic
    # fourth-kind recurrence over ops['apply'], with the preconditioner
    # picked per level: point Jacobi, or line relaxation when the level
    # carries "line_inv" blocks (solvers/line.py; the dict-key check is
    # pytree-static under jit).
    def _default_smooth(lv, b, x, level):
        if "line_inv" in lv:
            from .line import line_precond_apply

            minv = lambda r: line_precond_apply(
                lv["line_inv"], r, level.shape, level.line_axis)
        elif "schwarz" in lv:
            if level.dss is not None:
                from .schwarz_dss import dss_schwarz_apply

                xde = ops.get("dss_exchange")
                minv = lambda r: dss_schwarz_apply(
                    lv["schwarz"], r, lv, level.dss,
                    exchange=(None if xde is None
                              else lambda y: xde(y, lv, level.dss)))
            else:
                from .schwarz import schwarz_precond_apply

                minv = lambda r: schwarz_precond_apply(
                    lv["schwarz"], r, level.shape, level.P,
                    exchange=ops.get("exchange"))
        else:
            minv = lv["diag_inv"]
        return chebyshev4_solve(
            lambda t: ops["apply"](lv, t, level), b, x,
            minv, lv["lmax"], level.smoother_iters,
        )

    smooth = ops.get("smooth", _default_smooth)
    residual = ops.get(
        "residual",
        lambda lv, b, u, level: b - ops["apply"](lv, u, level),
    )

    # W-cycle (mu-cycle, gamma=2): visit the coarse sub-hierarchy
    # ``gamma`` times per level instead of once — beyond the reference's
    # V-only driver (src/pmg.hpp:56-155). Configured via
    # ``coarse_cfg['gamma']`` so every composition site (PMGHierarchy /
    # DistPMG / GridPMG solve / solve_pcg / solve_refined / FMG) gets it
    # without signature changes. Recursion bottoms out at the standard
    # two-level cycle (one coarse solve per visit); gamma=1 is exactly
    # the V-cycle below. Traced inline: 2^(L-2) coarse visits per cycle.
    gamma = coarse_cfg.get("gamma", 1)
    if gamma > 1 and L > 2:
        if diagnostics:
            raise NotImplementedError(
                "per-level diagnostics are V-cycle only (gamma=1)")
        top = L - 1
        u = smooth(lvs[top], b_in, u_in, levels[top])
        r = residual(lvs[top], b_in, u, levels[top])
        b_c = ops["restrict"](
            data["transfer"][top - 1], r, levels[top - 1], levels[top]
        )
        sub = dict(data, levels=lvs[:top], transfer=data["transfer"][:top - 1])
        u_c = fresh(zeros(levels[top - 1], b_in.dtype))
        for _ in range(gamma):
            u_c = v_cycle(sub, b_c, u_c, levels=levels[:top], coarse=coarse,
                          coarse_cfg=coarse_cfg, ops=ops)
        du = ops["prolong"](
            data["transfer"][top - 1], u_c, levels[top - 1], levels[top]
        )
        return smooth(lvs[top], b_in, u + du, levels[top])

    # Down sweep: pre-smooth and restrict.
    for i in range(L - 1, 0, -1):
        if i < L - 1:
            us[i] = fresh(zeros(levels[i], b_in.dtype))
        us[i] = smooth(lvs[i], bs[i], us[i], levels[i])
        r = residual(lvs[i], bs[i], us[i], levels[i])
        if diagnostics:
            diag["pre"].append(jnp.sqrt(dot(r, r, lvs[i])))
        bs[i - 1] = ops["restrict"](
            data["transfer"][i - 1], r, levels[i - 1], levels[i]
        )

    # Coarse level: mask Dirichlet rows of the restricted rhs, then solve.
    # The direct / fdm / hmg coarse solvers operate on the GLOBAL coarse
    # problem: under shard_map the caller supplies 'coarse_gather' /
    # 'coarse_slice' hooks (gather the small coarse rhs, solve redundantly
    # on every shard, slice the local planes back — the
    # analogue of the reference coarse solve working under any rank
    # layout, src/amg.hpp:67-113). On one device both are identities.
    bc0 = lvs[0]["bc_marker"]
    b0 = jnp.where(bc0, jnp.zeros_like(bs[0]), bs[0])
    A0 = lambda x: ops["apply"](lvs[0], x, levels[0])
    u0 = fresh(zeros(levels[0], b_in.dtype))
    gather = ops.get("coarse_gather", lambda v: v)
    unslice = ops.get("coarse_slice", lambda v: v)
    if coarse == "smoother":
        u0 = smooth(lvs[0], b0, u0, levels[0])
    elif coarse == "cg":
        u0, _ = cg_solve(
            A0, b0, u0, lvs[0]["diag_inv"],
            rtol=coarse_cfg.get("rtol", 1e-8),
            maxiter=coarse_cfg.get("maxiter", 60),  # KSP cap, src/amg.hpp:39-40
            dot=lambda u, v: dot(u, v, lvs[0]),
        )
    elif coarse == "direct":
        # Dense Cholesky solve (the python mirror's LU coarse path,
        # python_tests/pmg.py:140-141). Factor precomputed at setup. The
        # triangular solves need a flat vector; the coarse level is small
        # so the flat<->lattice relayouts are negligible here.
        chol = data["coarse_chol"]
        b0g = gather(b0)
        y = jax.scipy.linalg.solve_triangular(
            chol, b0g.reshape(-1), lower=True
        )
        u0g = jax.scipy.linalg.solve_triangular(chol.T, y, lower=False)
        u0 = unslice(u0g.reshape(jnp.shape(b0g)))
    elif coarse == "fdm":
        # Exact fast-diagonalization coarse solve (solvers/fdm.py): six
        # small per-axis matmuls — both cheaper and more accurate than
        # any iterative coarse option on constant-coefficient boxes.
        fd = data["fdm"]
        if "fdm_dist" in ops:
            # Distributed form (parallel/fdm_dist.py): pencil
            # all_to_all transposes on the sharded axes — never
            # gathers, O(N0/n) memory per shard.
            u0 = ops["fdm_dist"](fd, b0)
        else:
            from .fdm import fdm_solve

            b0g = gather(b0)
            u0g = fdm_solve(
                b0g, (fd["Vx"], fd["Vy"], fd["Vz"]),
                (fd["Vxt"], fd["Vyt"], fd["Vzt"]), fd["dinv"],
                fd["bc_global"], coarse_cfg["fdm_shape"],
                trims=coarse_cfg.get("fdm_trims", ((1, 1),) * 3),
            )
            u0 = unslice(u0g)
    elif coarse == "hmg":
        # Nested geometric h-multigrid V-cycles (the AMG replacement,
        # solvers/hmg.py) — recursion of this same function over the
        # h-hierarchy, traced inline into one program. Distributed: the
        # gathered global problem is solved redundantly with the
        # single-device hmg ops (whose 'pvary' must match the caller's
        # SPMD context). KNOWN SCALING LIMIT: every shard gathers and
        # solves the FULL p=1 problem — fine while the coarse level is
        # O(1%) of the fine dofs (p>=3 hierarchies; e.g. 60k coarse dofs
        # at 16.2M fine), a wall for 3-level p-hierarchies at 100M+ dofs
        # where the coarse solve itself should be shard_map'd over the
        # h-levels instead of gathered.
        hmg_ops = coarse_cfg.get("hmg_ops", ops)
        hmg_levels = coarse_cfg["hmg_levels"]
        if coarse_cfg.get("hmg_dist"):
            # Non-gathered h-hierarchy (parallel.dist.build_hmg_dist):
            # the p-coarse rhs is already in the h-hierarchy's finest
            # local layout; only the bottom solve gathers, via the
            # coarse hooks carried in hmg_ops itself.
            gather = unslice = lambda v: v
        hfresh = hmg_ops.get("pvary", lambda v: v)
        hzeros = hmg_ops.get(
            "zeros", lambda level, dtype: jnp.zeros(level.ndofs, dtype=dtype)
        )
        u0g = hfresh(hzeros(hmg_levels[-1], b_in.dtype))
        # pvary the gathered rhs too (the nested smoother loop carries must
        # have a consistent device-varying type under shard_map) and
        # conform it to the hmg ops' vector layout (lattice vs flat).
        b0g_raw = gather(b0)
        b0g = hfresh(b0g_raw).reshape(jnp.shape(u0g))
        for _ in range(coarse_cfg.get("cycles", 2)):
            u0g = v_cycle(
                data["hmg"], b0g, u0g,
                levels=hmg_levels,
                coarse=coarse_cfg.get("hmg_bottom", "direct"),
                # 'hmg_gamma' runs the nested h-hierarchy as W-cycles
                # (pays on anisotropic problems where the h-levels' point
                # smoothers are weak; see semicoarsen_sizes).
                coarse_cfg={"gamma": coarse_cfg.get("hmg_gamma", 1)},
                ops=hmg_ops,
            )
        u0 = unslice(u0g.reshape(jnp.shape(b0g_raw)))
    elif coarse == "amg":
        # Smoothed-aggregation AMG cycles on the p-coarse problem
        # (solvers/amg.py) — the topology-agnostic multilevel coarse
        # (the reference's BoomerAMG role, src/amg.hpp:33-47): works on
        # unstructured meshes where the geometric 'hmg' family refuses.
        # Level 0 stays matrix-free through this hierarchy's own
        # apply/smoother; deeper levels are small assembled BCOO/dense.
        # Flat-vector boundary: the aggregate segment ops need 1D
        # carriers, so lattice-shaped backends reshape at this seam
        # (the coarse level is small — negligible relayout).
        from .amg import amg_cycle

        b0f = b0.reshape(-1)
        shape0 = jnp.shape(b0)
        apply0f = lambda xf: ops["apply"](
            lvs[0], xf.reshape(shape0), levels[0]).reshape(-1)
        smooth0f = lambda lv, bb, xx, level: smooth(
            lv, bb.reshape(shape0), xx.reshape(shape0), level).reshape(-1)
        u0f = fresh(zeros(levels[0], b_in.dtype)).reshape(-1)
        for _ in range(coarse_cfg.get("cycles", 2)):
            u0f = amg_cycle(data["amg"], b0f, u0f,
                            coarse_cfg["amg_meta"], lvs[0], levels[0],
                            smooth0f, apply0f)
        u0 = u0f.reshape(shape0)
    else:
        raise ValueError(f"unknown coarse solver '{coarse}'")
    us[0] = u0

    # Up sweep: prolong, correct, post-smooth.
    for i in range(L - 1):
        du = ops["prolong"](data["transfer"][i], us[i], levels[i], levels[i + 1])
        us[i + 1] = us[i + 1] + du
        us[i + 1] = smooth(lvs[i + 1], bs[i + 1], us[i + 1], levels[i + 1])
        if diagnostics:
            A = lambda x, _i=i + 1: ops["apply"](lvs[_i], x, levels[_i])
            r = bs[i + 1] - A(us[i + 1])
            diag["post"].append(jnp.sqrt(dot(r, r, lvs[i + 1])))

    if diagnostics:
        return us[L - 1], diag
    return us[L - 1]


def fmg_initial_guess(data, b_in, *, levels, coarse="smoother",
                      coarse_cfg=None, ops=None):
    """Full-multigrid (nested-iteration) initial guess — beyond the
    reference's stationary-from-zero driver (examples/pmg/main.cpp:362).

    Restrict the RHS down the p-hierarchy, then work upward from the
    coarsest level: at each level prolong the current solution and run
    one V-cycle of the TRUNCATED hierarchy (coarsest..i). Costs about
    one fine V-cycle plus strictly cheaper coarse ones, and starts the
    outer iteration 1-2 orders of magnitude closer — saving ~2-4 cycles
    of the stationary iteration (measured in tests/test_fmg.py).

    Generic over the same ops dicts as `v_cycle` (the restricted rhs'
    Dirichlet rows are masked to the homogeneous value; the finest-level
    rhs is used as given, like the V-cycle itself).
    """
    L = len(levels)
    ops = ops or default_cycle_ops()
    lvs = data["levels"]
    fresh = ops.get("pvary", lambda v: v)
    zeros = ops.get("zeros",
                    lambda level, dtype: jnp.zeros(level.ndofs, dtype=dtype))
    bs = [None] * L
    bs[L - 1] = b_in
    for i in range(L - 1, 0, -1):
        r = ops["restrict"](data["transfer"][i - 1], bs[i],
                            levels[i - 1], levels[i])
        bc = lvs[i - 1]["bc_marker"]
        bs[i - 1] = jnp.where(bc, jnp.zeros_like(r), r)
    u = None
    for i in range(L):
        if i:
            u = ops["prolong"](data["transfer"][i - 1], u,
                               levels[i - 1], levels[i])
        else:
            u = fresh(zeros(levels[0], b_in.dtype))
        # One V-cycle of the truncated hierarchy (a 1-level "cycle" at
        # i=0 is exactly the coarse solve on the bc-masked rhs).
        data_i = dict(data, levels=lvs[: i + 1],
                      transfer=data["transfer"][:i])
        u = v_cycle(data_i, bs[i], u, levels=levels[: i + 1],
                    coarse=coarse, coarse_cfg=coarse_cfg, ops=ops)
    return u


class PMGHierarchy:
    """Build and run the full p-multigrid stack on one device.

    Plays the role of the reference pmg driver's setup phase
    (examples/pmg/main.cpp:80-355): per-level operators and Jacobi
    diagonals, CG/Lanczos smoother calibration, transfer operators, and
    the composed V-cycle — exposed as jitted ``v_cycle`` / ``solve``.
    """

    @property
    def ops(self):
        """The cycle-ops dict (apply/restrict/prolong/dot) — the public
        handle for composing ``v_cycle``/``cg_solve`` with this hierarchy's
        operator backend."""
        return self._ops

    def __init__(self, mesh, degrees=(1, 3), kappa=2.0, dtype=jnp.float64,
                 smoother_iters=DEFAULT_SMOOTHER_ITERS, coarse="smoother",
                 coarse_cfg=None,
                 calibration_iters=DEFAULT_CALIBRATION_ITERS,
                 operator="dofmap", precision="highest", sigma=0.0,
                 smoother="cheb"):
        """``operator`` selects the kernel backend: 'dofmap' (general,
        oracle-parity path), 'lattice' (banded-matmul path, general
        hexes), 'kron' (Kronecker-sum path, axis-aligned meshes — the
        production choice), 'dss' (unstructured hex topology), or 'csr'
        (ASSEMBLED BCOO sparse matvec — the reference's
        `acc::MatrixOperator` fine-operator path,
        examples/pmg/main.cpp:40-43; parity/oracle use). ``precision``
        applies to the float32 matmuls ('highest' = true f32; 'high' and
        'default' run in TF32 on tensor-core GPUs).

        ``kappa`` may be a scalar, a per-cell ``(ncells,)`` DG-0 array, a
        SYMMETRIC 3x3 diffusion tensor — constant ``(3, 3)`` or per-cell
        ``(ncells, 3, 3)``, folded into the geometry factors (full
        anisotropic diffusion, beyond the reference) — or a callable over
        points ``x[(3, npts)]`` sampled at cell centroids returning
        scalars or tensors (reference src/laplacian.hpp:220-241). A
        non-constant / tensor coefficient requires a general backend
        ('lattice' or 'dofmap' — the Kronecker sum
        cannot express it) and a coarse solver in {'cg', 'smoother',
        'direct', 'hmg'} ('fdm' is constant-coefficient only; 'hmg'
        rediscretizes per h-level with volume-averaged coefficients —
        see also `solvers.hmg.semicoarsen_sizes` +
        ``coarse_cfg['sizes']`` for strongly anisotropic tensors, and
        prefer `solve_pcg` there: the stationary iteration can diverge,
        `warn_tensor_stationary`).
        """
        from ..fem.mesh import require_axis_aligned

        from ..fem.assembly import resolve_sigma

        # A callable sigma(x) (variable reaction coefficient) is baked
        # into every level's m3 vector with the ops-level scalar set to
        # 1.0 — general backends only (see fem.assembly.resolve_sigma).
        self.sigma, self._sigma_field = resolve_sigma(sigma)
        if self._sigma_field is not None:
            if operator == "kron":
                raise ValueError(
                    "a sigma FIELD (callable) requires a general backend "
                    "('lattice', 'dofmap') — the "
                    "Kronecker paths carry only a separable scalar shift"
                )
            if coarse == "fdm":
                raise ValueError(
                    "coarse='fdm' supports a scalar sigma only (the "
                    "shift must stay a pure eigenvalue offset); use "
                    "'hmg', 'cg', 'direct' or 'smoother'"
                )
            if smoother != "cheb" or (coarse_cfg or {}).get(
                    "smoother", "cheb") != "cheb":
                raise ValueError(
                    "line/schwarz smoothers support a scalar sigma only "
                    "(their block builders fold a uniform shift); use "
                    "smoother='cheb' with a sigma field"
                )
        self._robin = bool(getattr(mesh, "has_robin", False))
        if (not any(any(f) for f in getattr(mesh, "dirichlet_faces",
                                            ((True, True),) * 3))
                and self.sigma == 0.0 and not self._robin):
            raise ValueError(
                "pure-Neumann problem (no Dirichlet face) with sigma=0 is "
                "singular (constant nullspace); add a Dirichlet face, a "
                "positive sigma shift, or a Robin face"
            )
        # Smoother preconditioner for every p-level: point Jacobi
        # ('cheb', default) or LINE relaxation along the strongly-coupled
        # axis ('line' auto / 'line-x|y|z' explicit, solvers/line.py) —
        # the anisotropy remedy for tensor kappa / stretched cells
        # (measured: diag(1,1,64) FCG 80+ -> 7 iters; the rotated-100:1
        # stationary divergence at smoother_iters=2 turns contracting).
        from .line import line_block_inverses, parse_line_smoother

        # 'schwarz' = cell-wise FDM Schwarz (solvers/schwarz.py): the
        # O(ndofs)-memory robust smoother that runs at ANY size (the
        # line blocks' production-scale sibling).
        self._schwarz = smoother == "schwarz"
        self._line_axis = (None if self._schwarz
                           else parse_line_smoother(smoother, mesh, kappa))
        kron_family = operator == "kron"
        # Robin on the general backends rides the baked pointwise shift
        # (boundary mass folded into m3); shared scalar policy:
        # fem.assembly.ops_shift_scalar.
        self._ops_sigma = ops_shift_scalar(mesh, self.sigma, kron_family)
        if kron_family:
            require_axis_aligned(mesh, f"operator='{operator}'")
        if coarse == "fdm":
            require_axis_aligned(mesh, "coarse='fdm'")
        self.mesh = mesh
        self.degrees = tuple(int(p) for p in degrees)
        self._kappa_raw = kappa
        self._kc, self._kappa_fold, kappa_const = resolve_kappa_split(
            mesh, kappa)
        # _kappa_fold: (ncells, 3, 3) anisotropic tensor to fold into the
        # geometry factors (or None); _kc: the per-cell scalar field
        # (all-ones when the coefficient is a tensor). scale_G applies
        # _kc to big geometry arrays only when it carries the
        # coefficient (the scalar path keeps its historical post-
        # multiply — bit-identical trajectories).
        self.kappa_cells = (self._kappa_fold if self._kappa_fold is not None
                            else self._kc)
        self.kappa = float(self._kc[0]) if kappa_const else None
        # Per-axis kron-family coefficient (kx, ky, kz): set whenever the
        # coefficient is a constant scalar / per-axis / DIAGONAL tensor —
        # grid-aligned anisotropy stays on the Kronecker-sum paths
        # (incl. the EXACT FDM direct coarse/solve). None otherwise.
        from ..fem.assembly import resolve_kappa_axes

        try:
            self.kappa_axes = resolve_kappa_axes(
                mesh, kappa,
                split=(self._kc, self._kappa_fold, kappa_const))
        except ValueError:
            if kron_family:
                raise  # resolver message names lattice/dofmap alternatives
            self.kappa_axes = None
        if self.kappa_axes is None and coarse == "fdm":
            raise ValueError(
                "coarse='fdm' is constant-coefficient (scalar, per-axis "
                "or diagonal-tensor) only; use 'hmg', 'cg', 'smoother' "
                "or 'direct' with variable kappa (or FDM as an outer FCG "
                "preconditioner, solvers/fdm.py)"
            )
        self.dtype = dtype
        self.coarse = coarse
        self.coarse_cfg = dict(coarse_cfg or {})
        self.operator_kind = operator
        self.precision = precision
        self.eigs = []
        if operator == "lattice":
            self._ops = lattice_cycle_ops(precision, sigma=self._ops_sigma)
        elif operator == "kron":
            self._ops = kron_cycle_ops(precision, sigma=self.sigma)
        elif operator == "dofmap":
            self._ops = default_cycle_ops(sigma=self._ops_sigma)
        elif operator == "dss":
            if not hasattr(mesh, "dss_layout"):
                raise ValueError(
                    "operator='dss' needs a mesh with a DSS entity "
                    "layout (UnstructuredHexMesh); box meshes should "
                    "use the faster 'kron'/'lattice' families — or wrap "
                    "the box as UnstructuredHexMesh(geometry_x, "
                    "geometry_dofmap) to force the unstructured path"
                )
            self._ops = dss_cycle_ops(precision, sigma=self._ops_sigma)
        elif operator == "csr":
            self._ops = csr_cycle_ops()
        else:
            raise ValueError(
                f"unknown operator backend {operator!r}; expected 'kron', "
                "'lattice', 'dofmap', 'dss' or 'csr'"
            )
        ops = self._ops

        from ..ops.lattice import (
            axis_interpolation_matrix,
            axis_matrices,
            geometry_to_qlattice,
        )

        level_data = []
        levels = []
        for P in self.degrees:
            # Geometry factors in float64 on host, cast to working dtype
            # (not needed by the kron backends, which are fully 1D-factored,
            # nor by csr, which assembles on host via fem/assembly.py).
            if not kron_family and operator != "csr":
                G_cells, _ = geometry_factors(
                    mesh.geometry_x,
                    mesh.geometry_dofmap,
                    tabulate_geometry_dphi(P),
                    quadrature_weights_3d(P),
                    xp=np,
                    kappa=self._kappa_fold,
                )
            bc = jnp.asarray(mesh.boundary_dof_marker(P))
            ndofs = mesh.num_dofs(P)
            if kron_family:
                from ..ops.kron import axis_stiffness_mass, robin_axis_ends

                lv = {}
                for a, (name, nc_a, h_a, k_a) in enumerate(
                        zip("xyz", mesh.nc, mesh.h_cells, self.kappa_axes)):
                    # Robin ends pre-divided by k_a: the kappa multiply
                    # below restores the kappa-free alpha end terms.
                    K, m = axis_stiffness_mass(
                        nc_a, P, h_a,
                        robin=robin_axis_ends(mesh, a, 1.0 / k_a))
                    lv["K" + name] = jnp.asarray(k_a * K, dtype=dtype)
                    lv["m" + name] = jnp.asarray(m, dtype=dtype)
                # Lattice-shaped markers: the kron cycle carries
                # lattice-shaped vectors end-to-end (see kron_cycle_ops).
                lv["bc_marker"] = bc.reshape(mesh.lattice_shape(P))
                level = Level(P=P, ndofs=ndofs, smoother_iters=smoother_iters,
                              shape=mesh.lattice_shape(P))
            elif operator == "lattice":
                lv = {}
                for name, nc_a in zip("xyz", mesh.nc):
                    E, Dg = axis_matrices(nc_a, P)
                    lv["E" + name] = jnp.asarray(E, dtype=dtype)
                    lv["D" + name] = jnp.asarray(Dg, dtype=dtype)
                lv["G"] = jnp.asarray(
                    geometry_to_qlattice(
                        scale_G(G_cells, self._kc, self._kappa_fold),
                        mesh.nc, P,
                    ),
                    dtype=dtype,
                )
                lv["bc_marker"] = bc
                level = Level(P=P, ndofs=ndofs, smoother_iters=smoother_iters,
                              shape=mesh.lattice_shape(P))
            elif operator == "csr":
                from ..ops.csr import MatrixOperator

                mo = MatrixOperator(
                    mesh, P, kappa=self.kappa_cells, dtype=dtype,
                    shift_diag=(self._ops_sigma * self._baked_m3_np(mesh, P)
                                if self._ops_sigma else None),
                )
                lv = dict(A=mo._A, bc_marker=bc)
                diag = mo.diag
                level = Level(P=P, ndofs=ndofs, smoother_iters=smoother_iters)
            elif operator == "dss":
                from ..ops.unstructured import dss_device_tables, dss_meta

                # Same G/coeff split as the dofmap branch: a tensor
                # kappa is already folded into G_cells (geometry_factors
                # kappa=) with _kc all-ones; a scalar/DG-0 kappa rides
                # the per-cell coeff multiplier in the cell kernel.
                layout = mesh.dss_layout(P)
                lv = dict(
                    dss_device_tables(layout, dtype=dtype),
                    G=jnp.asarray(G_cells, dtype=dtype),
                    coeff=jnp.asarray(self._kc, dtype=dtype),
                    D=jnp.asarray(derivative_matrix(P), dtype=dtype),
                    bc_marker=bc,
                )
                level = Level(P=P, ndofs=ndofs, smoother_iters=smoother_iters,
                              dss=dss_meta(layout))
            else:
                lv = dict(
                    dofmap=jnp.asarray(mesh.dofmap(P)),
                    G=jnp.asarray(G_cells, dtype=dtype),
                    coeff=jnp.asarray(self._kc, dtype=dtype),
                    D=jnp.asarray(derivative_matrix(P), dtype=dtype),
                    bc_marker=bc,
                )
                level = Level(P=P, ndofs=ndofs, smoother_iters=smoother_iters)
            if kron_family:
                # Closed-form Kronecker diagonal (exact, no scatter).
                from ..ops.kron import kron_diagonal

                diag = kron_diagonal(
                    (lv["Kx"], lv["Ky"], lv["Kz"]),
                    (lv["mx"], lv["my"], lv["mz"]),
                    bc,
                    sigma=self.sigma,
                )
            elif operator != "csr":  # csr: assembled diagonal, set above
                # Diagonal via the (exact) dofmap formulation.
                diag = jax.jit(laplacian_diagonal, static_argnums=(5,))(
                    jnp.asarray(mesh.dofmap(P)),
                    jnp.asarray(G_cells, dtype=dtype),
                    jnp.asarray(self._kc, dtype=dtype),
                    jnp.asarray(derivative_matrix(P), dtype=dtype),
                    bc,
                    ndofs,
                )
                if self._ops_sigma:
                    # General lumped-mass shift (curved hexes / DG-0
                    # kappa): bc-zeroed mass vector added pointwise in the
                    # apply (cycle-ops sigma) and to the Jacobi diagonal.
                    # A sigma FIELD is baked into m3 (self.sigma is 1.0);
                    # Robin faces bake their boundary mass the same way
                    # (self._ops_sigma is 1.0, _baked_m3_np).
                    m3 = self._baked_m3_np(mesh, P)
                    lv["m3"] = jnp.asarray(m3, dtype=dtype)
                    diag = diag + self._ops_sigma * lv["m3"]
            lv["diag_inv"] = 1.0 / diag
            if kron_family:
                lv["diag_inv"] = lv["diag_inv"].reshape(level.shape)
            if self._line_axis is not None:
                # Dense within-line block inverses of the assembled
                # (bc-applied, sigma-shifted) operator; applied as one
                # batched matvec per smoother sweep (solvers/line.py).
                lv["line_inv"] = jnp.asarray(
                    line_block_inverses(mesh, P, kappa, self._line_axis,
                                        sigma=self.sigma),
                    dtype=dtype,
                )
                level = dataclasses.replace(
                    level, line_axis=self._line_axis,
                    shape=mesh.lattice_shape(P))
            elif self._schwarz:
                if operator == "dss":
                    # Unstructured topology: per-cell separable blocks
                    # from each cell's own edge geometry, applied via
                    # the DSS gather/scatter (solvers/schwarz_dss.py).
                    from .schwarz_dss import build_schwarz_dss

                    lv["schwarz"] = build_schwarz_dss(
                        mesh, P, kappa, dtype, sigma=self.sigma)
                else:
                    from .schwarz import build_schwarz

                    lv["schwarz"] = build_schwarz(mesh, P, kappa, dtype,
                                                  sigma=self.sigma)
                    level = dataclasses.replace(
                        level, shape=mesh.lattice_shape(P))
            vshape = level.shape if kron_family else (ndofs,)
            # Smoother calibration: 20 recorded CG iterations on A x = 1,
            # Lanczos estimate, lmax inflated by 1.1 (main.cpp:303-330).
            # Jitted with the level pytree as an argument (never closed
            # over) so the operator arrays stay runtime buffers.
            calib = jax.jit(
                partial(
                    _generic_calibration,
                    ops=ops,
                    level=level,
                    maxiter=calibration_iters,
                )
            )
            _, info = calib(
                lv,
                jnp.ones(vshape, dtype=dtype),
                jnp.zeros(vshape, dtype=dtype),
            )
            eigs = lanczos_eigenvalue_estimates(
                info["alphas"], info["betas"], info["stored"]
            )
            self.eigs.append(eigs)
            lv["lmax"] = jnp.asarray(EIG_RANGE_FACTORS[1] * eigs[-1], dtype=dtype)
            level_data.append(lv)
            levels.append(level)

        transfer = []
        for i in range(len(self.degrees) - 1):
            Pc, Pf = self.degrees[i], self.degrees[i + 1]
            if operator in ("lattice", "kron"):
                tr = {
                    "I" + name: jnp.asarray(
                        axis_interpolation_matrix(nc_a, Pc, Pf), dtype=dtype
                    )
                    for name, nc_a in zip("xyz", mesh.nc)
                }
            elif operator == "dss":
                # The DSS transfers reuse the two levels' row-gather
                # tables (shared pytree leaves, no copies).
                tr = dict(
                    M1=jnp.asarray(interpolation_matrix_1d(Pc, Pf),
                                   dtype=dtype),
                    tc=level_data[i],
                    tf=level_data[i + 1],
                    inv_mult_f=jnp.asarray(
                        1.0 / mesh.dof_multiplicity(Pf), dtype=dtype),
                )
            else:
                tr = dict(
                    M1=jnp.asarray(interpolation_matrix_1d(Pc, Pf), dtype=dtype),
                    dofmap_c=jnp.asarray(mesh.dofmap(Pc)),
                    dofmap_f=jnp.asarray(mesh.dofmap(Pf)),
                    mult_f=jnp.asarray(mesh.dof_multiplicity(Pf), dtype=dtype),
                )
            transfer.append(tr)

        self.data = dict(levels=tuple(level_data), transfer=tuple(transfer))
        self.levels = tuple(levels)

        if coarse == "direct":
            from ..fem.assembly import assemble_stiffness

            A0 = assemble_stiffness(
                mesh, self.degrees[0], kappa=self.kappa_cells
            ).toarray()
            if self.sigma:
                from ..fem.assembly import shifted_mass_np

                A0[np.diag_indices_from(A0)] += self.sigma * shifted_mass_np(
                    mesh, self.degrees[0], self._sigma_field
                )
            chol = np.linalg.cholesky(A0)
            self.data["coarse_chol"] = jnp.asarray(chol, dtype=dtype)
        elif coarse == "fdm":
            from .fdm import FastDiagonalizationSolver

            fd = FastDiagonalizationSolver(
                mesh, self.degrees[0], kappa=self.kappa_axes,
                dtype=dtype, precision=precision, sigma=self.sigma,
            )
            self.data["fdm"] = dict(
                Vx=fd.Vs[0], Vy=fd.Vs[1], Vz=fd.Vs[2],
                Vxt=fd.Vts[0], Vyt=fd.Vts[1], Vzt=fd.Vts[2],
                dinv=fd.dinv, bc_global=fd.bc_marker,
            )
            self.coarse_cfg["fdm_shape"] = mesh.lattice_shape(self.degrees[0])
            self.coarse_cfg["fdm_trims"] = fd.trims
        elif coarse == "amg":
            import scipy.sparse as sp_

            from ..fem.assembly import assemble_stiffness, shifted_mass_np
            from .amg import DENSE_CAP, build_amg

            A0 = assemble_stiffness(
                mesh, self.degrees[0], kappa=self.kappa_cells).tocsr()
            if self.sigma:
                A0 = (A0 + sp_.diags(self.sigma * shifted_mass_np(
                    mesh, self.degrees[0], self._sigma_field))).tocsr()
            amg_data, amg_meta = build_amg(
                A0, mesh.boundary_dof_marker(self.degrees[0]), dtype,
                theta=self.coarse_cfg.get("theta", 0.0),
                dense_cap=self.coarse_cfg.get("dense_cap", DENSE_CAP),
                smoother_iters=smoother_iters,
                psmooth=self.coarse_cfg.get("psmooth", 2),
                nu=self.coarse_cfg.get("nu", 2),
            )
            self.data["amg"] = amg_data
            self.coarse_cfg["amg_meta"] = amg_meta
            # 3 cycles ~= exact coarse (measured: L-shape p=(1,3) FCG 6
            # vs direct 5, flat n=6->9; 2 cycles costs +2 iterations) —
            # same default as the hmg coarse.
            self.coarse_cfg.setdefault("cycles", 3)
        elif coarse == "hmg":
            if (getattr(mesh, "is_axis_aligned", True)
                    and self.kappa_axes is not None
                    and self._sigma_field is None):
                from .hmg import build_hmg

                hmg_levels, hmg_data, hmg_bottom = build_hmg(
                    mesh, self.degrees[0], self.kappa_axes, dtype,
                    smoother_iters=smoother_iters, precision=precision,
                    bottom=self.coarse_cfg.get("bottom", "direct"),
                    min_cells=self.coarse_cfg.get("min_cells", 2),
                    sigma=self.sigma,
                    sizes=self.coarse_cfg.get("sizes"),
                    smoother=self.coarse_cfg.get("smoother", "cheb"),
                )
                hmg_ops = kron_cycle_ops(precision, sigma=self.sigma)
            else:
                # General family (curved hexes / variable DG-0 kappa):
                # rediscretized lattice h-hierarchy — the scalable
                # replacement for the reference's BoomerAMG coarse solve
                # on meshes where the kron h-MG refuses.
                from .hmg import build_hmg_general

                hmg_levels, hmg_data, hmg_bottom, hmg_ops = (
                    build_hmg_general(
                        mesh, self.degrees[0], self._kappa_raw, dtype,
                        smoother_iters=smoother_iters, precision=precision,
                        bottom=self.coarse_cfg.get("bottom", "direct"),
                        min_cells=self.coarse_cfg.get("min_cells", 2),
                        sigma=self.sigma,
                        sigma_field=self._sigma_field,
                        sizes=self.coarse_cfg.get("sizes"),
                        smoother=self.coarse_cfg.get("smoother", "cheb"),
                    )
                )
            self.data["hmg"] = hmg_data
            self.coarse_cfg.update(
                hmg_levels=hmg_levels,
                hmg_ops=hmg_ops,
                hmg_bottom=hmg_bottom,
                cycles=self.coarse_cfg.get("cycles", 3),
            )

        self._vcycle = jax.jit(
            partial(
                v_cycle,
                levels=self.levels,
                coarse=self.coarse,
                coarse_cfg=self.coarse_cfg,
                ops=ops,
            )
        )
        self._vcycle_diag = jax.jit(
            partial(
                v_cycle,
                levels=self.levels,
                coarse=self.coarse,
                coarse_cfg=self.coarse_cfg,
                ops=ops,
                diagnostics=True,
            )
        )
    # -- public API ----------------------------------------------------
    #
    # Public vectors are FLAT (the reference's acc::Vector contract);
    # the kron backend works on lattice-shaped arrays internally, so the
    # boundary methods reshape once per call — never inside hot loops.

    def _baked_m3_np(self, m, P):
        """Pointwise shift vector (float64, host) for a general-backend
        level: the plain (field-folded) lumped mass when no Robin faces
        exist (the cycle-ops scalar carries sigma), else the fully baked
        ``sigma * m3 + robin boundary mass`` applied with scalar 1.0
        (`fem.assembly.general_shift_np` — shared with the distributed
        builders)."""
        from ..fem.assembly import general_shift_np

        return general_shift_np(m, P, self.sigma, self._sigma_field)[1]

    def _to_work(self, v, level=-1):
        if self.operator_kind == "kron":
            return v.reshape(self.levels[level].shape)
        return v

    def _from_work(self, v):
        if self.operator_kind == "kron":
            return v.reshape(-1)
        return v

    def apply(self, b, u, diagnostics=False):
        """One V-cycle from iterate ``u`` (the reference pmg.apply)."""
        b = self._to_work(jnp.asarray(b, dtype=self.dtype))
        u = self._to_work(jnp.asarray(u, dtype=self.dtype))
        if diagnostics:
            u, diag = self._vcycle_diag(self.data, b, u)
            return self._from_work(u), diag
        return self._from_work(self._vcycle(self.data, b, u))

    def operator(self, level=-1):
        """The fine-level (or chosen-level) operator as ``x -> A x``
        (flat public contract)."""
        lv = self.data["levels"][level]
        lvl = self.levels[level]
        ops = self._ops
        fn = jax.jit(
            partial(
                lambda l, x, *, _ops, _level: _ops["apply"](l, x, _level),
                _ops=ops,
                _level=lvl,
            )
        )
        return lambda x: self._from_work(fn(lv, self._to_work(x, level)))

    def _fmg_guess(self, bw):
        """Jitted FMG initial guess on the working-layout rhs."""
        if getattr(self, "_fmg_fn", None) is None:
            self._fmg_fn = jax.jit(partial(
                fmg_initial_guess, levels=self.levels, coarse=self.coarse,
                coarse_cfg=self.coarse_cfg, ops=self._ops,
            ))
        return self._fmg_fn(self.data, bw)

    def solve_pcg(self, b, rtol=1e-8, maxiter=50, fmg=False):
        """V-cycle-preconditioned flexible CG (beyond-reference mode).

        The reference drives its PMG as a stationary iteration; wrapping
        the same V-cycle in flexible CG (Polak-Ribiere beta, robust to the
        inexact coarse Krylov solve inside the cycle) roughly halves the
        number of cycles to a given tolerance. Whole solve is one jitted
        while_loop. ``fmg=True`` starts from the full-multigrid guess
        (`fmg_initial_guess`) instead of zero. Returns ``(u, niter)``.
        """
        from .cg import fcg_solve

        if getattr(self, "_pcg", None) is None:
            ops = self._ops
            fine = self.levels[-1]
            vc = partial(
                v_cycle, levels=self.levels, coarse=self.coarse,
                coarse_cfg=self.coarse_cfg, ops=ops,
            )

            def _run(data, b, u0, rtol_, maxiter_):
                A = lambda x: ops["apply"](data["levels"][-1], x, fine)
                M = lambda r: vc(data, r, jnp.zeros_like(r))
                return fcg_solve(A, b, u0, M,
                                 rtol=rtol_, maxiter=maxiter_,
                                 dot=lambda u_, v_: ops["dot"](
                                     u_, v_, data["levels"][-1]),
                                 )

            self._pcg = jax.jit(_run, static_argnums=(3, 4))
        b = self._to_work(jnp.asarray(b, dtype=self.dtype))
        u0 = self._fmg_guess(b) if fmg else jnp.zeros_like(b)
        u, info = self._pcg(self.data, b, u0, float(rtol), int(maxiter))
        return self._from_work(u), int(info["niter"])

    def solve_refined(self, b, num_cycles=15, rtol=0.0, residuals=True,
                      u0=None, fmg=False):
        """Mixed-precision iterative refinement: float64 outer residual,
        working-dtype (f32) V-cycle as the error smoother.

        The reference achieves deep convergence by running everything in
        double (examples/pmg/main.cpp:30). Only the *residual* needs
        f64, and f64 throughput is a fraction of f32 on most
        accelerators (half on an H100's CUDA cores, and no f64 tensor
        path for the TF32 modes): a stationary
        f32 V-cycle stalls at ~1e-4 relative residual (cancellation noise
        of ``b - A u`` in f32), while refinement

            r64 = b64 - A64 u64 ;  e = Vcycle_f32(r, 0) ;  u64 += e

        converges to f64-grade accuracy at f32 V-cycle speed — the f64
        work per cycle is a single fine-level apply + axpys: the
        Kronecker form (3 matmuls) on axis-aligned constant-coefficient
        problems, the f64 lattice apply otherwise (general hexes,
        variable DG-0 kappa). Requires ``jax_enable_x64``.
        """
        warn_tensor_stationary(self._kappa_fold, self.kappa_axes,
                               self.operator_kind,
                               line=(self._line_axis is not None
                                     or getattr(self, "_schwarz", False)))
        if not jax.config.read("jax_enable_x64"):
            raise RuntimeError("solve_refined requires jax_enable_x64")
        fine = self.levels[-1]
        Pf = self.degrees[-1]
        use_kron64 = (getattr(self.mesh, "is_axis_aligned", True)
                      and self.kappa_axes is not None
                      # a sigma field needs the m3-baked lattice path
                      # (the kron f64 apply shifts by a scalar only)
                      and self._sigma_field is None)
        if getattr(self, "_res64", None) is None:
            if use_kron64:
                from ..ops.kron import KronLaplacian

                op64 = KronLaplacian(
                    self.mesh, Pf, kappa=self.kappa_axes,
                    dtype=jnp.float64, precision="highest",
                    sigma=self.sigma,
                )
                self._res64 = dict(
                    Ks=op64.Ks, ms=op64.ms,
                    bc=op64.bc_marker.reshape(fine.shape),
                )
                self._b64shape = fine.shape
            else:
                from ..ops.lattice import (
                    axis_matrices,
                    geometry_to_qlattice,
                )

                G_cells, _ = geometry_factors(
                    self.mesh.geometry_x,
                    self.mesh.geometry_dofmap,
                    tabulate_geometry_dphi(Pf),
                    quadrature_weights_3d(Pf),
                    xp=np,
                    kappa=self._kappa_fold,
                )
                mats64 = {}
                for name, nc_a in zip("xyz", self.mesh.nc):
                    E, Dg = axis_matrices(nc_a, Pf)
                    mats64["E" + name] = jnp.asarray(E, jnp.float64)
                    mats64["D" + name] = jnp.asarray(Dg, jnp.float64)
                self._res64 = dict(
                    mats=mats64,
                    G=jnp.asarray(
                        geometry_to_qlattice(
                            scale_G(G_cells, self._kc, self._kappa_fold),
                            self.mesh.nc, Pf,
                        ),
                        jnp.float64,
                    ),
                    bc=jnp.asarray(self.mesh.boundary_dof_marker(Pf)),
                )
                if self._ops_sigma:
                    self._res64["m3"] = jnp.asarray(
                        self._baked_m3_np(self.mesh, Pf), jnp.float64,
                    )
                self._b64shape = (-1,)
        if getattr(self, "_refine_step", None) is None:
            work_dtype = self.dtype
            wz = (self._ops.get("zeros")
                  or (lambda level, dtype: jnp.zeros(level.ndofs, dtype)))

            wshape = (fine.shape
                      if self.operator_kind == "kron"
                      else (-1,))

            def _step(u64, b64, res64, data):
                if use_kron64:
                    from ..ops.kron import kron_laplacian_apply

                    r64 = b64 - kron_laplacian_apply(
                        u64, res64["Ks"], res64["ms"], res64["bc"],
                        precision="highest", sigma=self.sigma,
                    )
                else:
                    from ..ops.lattice import lattice_laplacian_apply

                    Au = lattice_laplacian_apply(
                        u64, res64["mats"], res64["G"], res64["bc"],
                        precision="highest",
                        apply_bc=not self._ops_sigma,
                    )
                    if self._ops_sigma:
                        Au = Au + self._ops_sigma * res64["m3"] * u64
                        Au = jnp.where(res64["bc"], u64, Au)
                    r64 = b64 - Au
                e = v_cycle(
                    data,
                    jnp.asarray(r64, dtype=work_dtype).reshape(wshape),
                    wz(fine, work_dtype),
                    levels=self.levels, coarse=self.coarse,
                    coarse_cfg=self.coarse_cfg, ops=self._ops,
                )
                e = e.reshape(jnp.shape(u64))
                return u64 + jnp.asarray(e, dtype=jnp.float64), jnp.linalg.norm(r64)

            self._refine_step = jax.jit(_step)

        # f64 state shares the work layout (lattice-shaped for the kron
        # backends — the f64 apply pays the same relayout costs as f32).
        # ``u0`` resumes refinement from a checkpointed iterate
        # (utils.checkpoint).
        b64 = jnp.asarray(b, dtype=jnp.float64).reshape(self._b64shape)
        if u0 is not None:
            u64 = jnp.asarray(u0, dtype=jnp.float64).reshape(b64.shape)
        elif fmg:
            # Working-dtype FMG guess (the f64 outer loop immediately
            # recomputes the true residual, so the guess precision is
            # irrelevant — only its distance to the solution matters).
            uw = self._fmg_guess(self._to_work(jnp.asarray(b, self.dtype)))
            u64 = jnp.asarray(uw, dtype=jnp.float64).reshape(b64.shape)
        else:
            u64 = jnp.zeros_like(b64)
        r0 = float(jnp.linalg.norm(b64))
        rnorms = []
        for _ in range(num_cycles):
            u64, rn = self._refine_step(u64, b64, self._res64, self.data)
            rn = float(rn)
            if residuals:
                rnorms.append(rn)
            if rtol and rn < rtol * r0:
                break
        return u64.reshape(-1), rnorms

    def solve_many(self, B, num_cycles=10):
        """Batched stationary solve over a leading RHS axis.

        ``B`` is ``(nrhs, ndofs)``; returns ``(U, rnorms)`` with ``U`` of
        the same shape and ``rnorms`` ``(nrhs, num_cycles)``. The whole
        batch runs as ONE jitted program (`jax.vmap` of the single-RHS
        scan): the RHS axis becomes an extra contraction batch dimension
        — the multiple-load-case / implicit-multi-field production
        pattern, beyond the reference (one RHS per run,
        examples/pmg/main.cpp): one program + one dispatch for the whole
        batch (`tools/batched_bench.py` times it per RHS).
        """
        warn_high_precision_stationary(self.precision)
        warn_tensor_stationary(self._kappa_fold, self.kappa_axes,
                               self.operator_kind,
                               line=(self._line_axis is not None
                                     or getattr(self, "_schwarz", False)))
        B = jnp.asarray(B, dtype=self.dtype)
        nrhs = B.shape[0]
        Bw = B.reshape((nrhs,) + tuple(self._to_work(B[0]).shape))
        if getattr(self, "_solve_many_scan", None) is None:
            vc = partial(
                v_cycle, levels=self.levels, coarse=self.coarse,
                coarse_cfg=self.coarse_cfg, ops=self._ops,
            )
            ops = self._ops
            fine = self.levels[-1]

            def _run1(data, b, u, num_cycles):
                def body(uc, _):
                    uc = vc(data, b, uc)
                    r = b - ops["apply"](data["levels"][-1], uc, fine)
                    return uc, jnp.sqrt(ops["dot"](r, r, data["levels"][-1]))

                return jax.lax.scan(body, u, None, length=num_cycles)

            self._solve_many_scan = jax.jit(
                jax.vmap(_run1, in_axes=(None, 0, 0, None)),
                static_argnums=(3,),
            )
        U, rnorms = self._solve_many_scan(self.data, Bw,
                                          jnp.zeros_like(Bw), num_cycles)
        return U.reshape(B.shape), np.asarray(rnorms)

    def _pcg_many_fn(self):
        """The cached jitted batched-FCG program
        ``(data, Bw, U0w, rtol, maxiter) -> (Uw, info)`` — trace-safe
        (no host conversions), for callers embedding the batched solve
        inside an outer traced loop (e.g. `solvers.eig`)."""
        from .cg import fcg_solve

        if getattr(self, "_pcg_many", None) is None:
            ops = self._ops
            fine = self.levels[-1]
            vc = partial(
                v_cycle, levels=self.levels, coarse=self.coarse,
                coarse_cfg=self.coarse_cfg, ops=ops,
            )

            def _run1(data, b, u0, rtol_, maxiter_):
                A = lambda x: ops["apply"](data["levels"][-1], x, fine)
                M = lambda r: vc(data, r, jnp.zeros_like(r))
                return fcg_solve(A, b, u0, M,
                                 rtol=rtol_, maxiter=maxiter_,
                                 dot=lambda u_, v_: ops["dot"](
                                     u_, v_, data["levels"][-1]),
                                 )

            self._pcg_many = jax.jit(
                jax.vmap(_run1, in_axes=(None, 0, 0, None, None)),
                static_argnums=(3, 4),
            )
        return self._pcg_many

    def solve_pcg_many(self, B, rtol=1e-8, maxiter=50):
        """Batched V-cycle-preconditioned FCG (`solve_pcg` over a leading
        RHS axis, one jitted program). Returns ``(U, niters)`` with
        per-RHS iteration counts — `lax.while_loop` batching freezes
        converged columns, so each column's trajectory and count are
        exactly its single-RHS ones."""
        fn = self._pcg_many_fn()
        B = jnp.asarray(B, dtype=self.dtype)
        nrhs = B.shape[0]
        Bw = B.reshape((nrhs,) + tuple(self._to_work(B[0]).shape))
        U, info = fn(self.data, Bw, jnp.zeros_like(Bw),
                     float(rtol), int(maxiter))
        return U.reshape(B.shape), np.asarray(info["niter"])

    def solve(self, b, num_cycles=10, u0=None, residuals=True, fmg=False):
        """Stationary V-cycle iteration (the reference driver loop,
        examples/pmg/main.cpp:362-367). Returns (u, residual_norms).

        ``fmg=True`` (and no explicit ``u0``) starts from the
        full-multigrid guess instead of zero — typically saves 2-4
        cycles for ~1 extra cycle of setup cost.

        The whole iteration runs on device as ONE jitted `lax.scan` with
        residual norms collected device-side — a single host readback at
        the end (no per-cycle host sync)."""
        warn_high_precision_stationary(self.precision)
        warn_tensor_stationary(self._kappa_fold, self.kappa_axes,
                               self.operator_kind,
                               line=(self._line_axis is not None
                                     or getattr(self, "_schwarz", False)))
        b = self._to_work(jnp.asarray(b, dtype=self.dtype))
        if u0 is None:
            u = self._fmg_guess(b) if fmg else jnp.zeros_like(b)
        else:
            u = self._to_work(jnp.asarray(u0, dtype=self.dtype))
        if getattr(self, "_solve_scan", None) is None:
            vc = partial(
                v_cycle, levels=self.levels, coarse=self.coarse,
                coarse_cfg=self.coarse_cfg, ops=self._ops,
            )
            ops = self._ops
            fine = self.levels[-1]

            def _run(data, b, u, num_cycles):
                def body(uc, _):
                    uc = vc(data, b, uc)
                    r = b - ops["apply"](data["levels"][-1], uc, fine)
                    return uc, jnp.sqrt(ops["dot"](r, r, data["levels"][-1]))

                return jax.lax.scan(body, u, None, length=num_cycles)

            self._solve_scan = jax.jit(_run, static_argnums=(3,))
        u, rnorms = self._solve_scan(self.data, b, u, num_cycles)
        u = self._from_work(u)
        if not residuals:
            return u, []
        return u, [float(r) for r in np.asarray(rnorms)]
