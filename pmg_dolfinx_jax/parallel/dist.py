"""Distributed PMG: the full solver stack under `shard_map`.

The reference's distributed runtime (SURVEY.md §2.4) is MPI ranks with
GPU-aware p2p scatterers (`acc::Vector::scatter_fwd/rev`, src/vector.hpp)
+ `MPI_Allreduce` dots, overlapped with compute via the lcells/bcells
split. This design collapses all of it into one SPMD program:

- vectors live in the duplicated-slab layout of `SlabPartition`, sharded
  over a 1D device mesh axis ``"x"``;
- cell compute is shard-local (the slab's cells, with a replicated local
  dofmap) — no indexed cross-shard access ever happens;
- after every cell scatter, interface-plane *partial sums* are exchanged
  with both neighbours via non-wrapping `jax.lax.ppermute` and added —
  one collective pair per operator apply (reverse+forward scatter of the
  reference in a single step, since both copies end up complete);
- inner products are ownership-masked local dots + `jax.lax.psum`.

The entire V-cycle (smoothers, transfers, coarse CG) runs inside ONE
`shard_map` region per application, so XLA sees all collectives and can
overlap them with cell compute (async collective permute), replacing the
reference's hand-scheduled comm/compute overlap streams.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fem.geometry import (
    geometry_factors,
    quadrature_weights_3d,
    tabulate_geometry_dphi,
)
from ..fem.gll import derivative_matrix, interpolation_matrix_1d
from ..fem.assembly import ops_shift_scalar, resolve_kappa_split, scale_G
from ..ops.blas import dist_inner_product
from ..ops.interpolate import prolongate, restrict
from ..ops.laplacian import laplacian_scatter_raw
from ..solvers.cg import cg_solve
from ..solvers.pmg import (
    fmg_initial_guess,
    DEFAULT_CALIBRATION_ITERS,
    DEFAULT_CALIBRATION_RTOL,
    DEFAULT_SMOOTHER_ITERS,
    EIG_RANGE_FACTORS,
    Level,
    pcast_varying,
    v_cycle,
)
from ..solvers.tridiag import lanczos_eigenvalue_estimates
from .multihost import fetch_global, put_global
from .partition import SlabPartition, duplicate_planes

AXIS = "x"


def _shifted_diag_np(mesh, Pdeg, kappa_cells, sigma, sigma_field=None):
    """Global operator diagonal incl. the optional lumped-mass shift
    (general meshes: the GLL-lumped mass, `fem.assembly.lumped_mass_np`;
    reduces to the tensor-product axis masses on axis-aligned boxes).
    A sigma FIELD is baked into the mass (`shifted_mass_np`); Robin
    faces add their (GLL-diagonal) boundary mass (`robin_mass_np`)."""
    from ..fem.assembly import (robin_mass_np, shifted_mass_np,
                                stiffness_diagonal_np)

    d = stiffness_diagonal_np(mesh, Pdeg, kappa_cells)
    if sigma:
        d = d + sigma * shifted_mass_np(mesh, Pdeg, sigma_field)
    if getattr(mesh, "has_robin", False):
        d = d + robin_mass_np(mesh, Pdeg)
    return d


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """1D device mesh over the first ``n_devices`` available devices."""
    devices = devices if devices is not None else jax.devices()[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def _exchange_partials(lat, n_shards):
    """Reconcile interface-plane partial sums with both neighbours.

    ``lat`` is the shard-local lattice ``(planes, NY, NZ)``. Shard ``d``'s
    last plane and shard ``d+1``'s first plane are copies of the same
    global plane, each holding the partial sum from its own cells; after
    the exchange both hold the full sum. Non-wrapping ppermute delivers
    zeros at the chain ends (exactly the no-neighbour case).
    """
    if n_shards == 1:
        return lat
    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]
    from_left = jax.lax.ppermute(lat[-1], AXIS, fwd)
    from_right = jax.lax.ppermute(lat[0], AXIS, bwd)
    return lat.at[0].add(from_left).at[-1].add(from_right)


def dist_cycle_ops(n_shards, sigma=0.0):
    """Pluggable V-cycle primitives for the sharded world (see
    `solvers.pmg.default_cycle_ops` for the single-device originals).
    ``sigma`` adds the lumped-mass shift AFTER the partial-sum exchange
    (``m3`` holds the full global mass in the duplicated layout, so the
    pointwise term is already consistent on interface planes)."""

    def apply_op(lv, x, level):
        raw = laplacian_scatter_raw(
            x, lv["dofmap"], lv["G"], lv["coeff"], lv["D"], lv["bc_marker"]
        )
        lat = _exchange_partials(raw.reshape(level.shape), n_shards)
        y = lat.reshape(-1)
        if sigma:
            y = y + sigma * lv["m3"] * x
        return jnp.where(lv["bc_marker"], x, y)

    def restrict_op(tr, r, level_c, level_f):
        raw = restrict(
            r, tr["dofmap_c"], tr["dofmap_f"], tr["M1"], tr["mult_f"],
            level_c.ndofs,
        )
        lat = _exchange_partials(raw.reshape(level_c.shape), n_shards)
        return lat.reshape(-1)

    def prolong_op(tr, u, level_c, level_f):
        # Interface planes are written identically by both neighbouring
        # shards (same coarse data) — consistent without communication.
        return prolongate(
            u, tr["dofmap_c"], tr["dofmap_f"], tr["M1"], level_f.ndofs
        )

    def dot(u, v, lv):
        return dist_inner_product(u, v, lv["weights"], AXIS)

    def pvary(v):
        return pcast_varying(v, (AXIS,))

    return dict(
        apply=apply_op, restrict=restrict_op, prolong=prolong_op, dot=dot,
        pvary=pvary,
        exchange=lambda lat: _exchange_partials(lat, n_shards),
    )


def build_hmg_dist(mesh, n_shards, P0, kappa, dtype, smoother_iters=2,
                   precision="highest", bottom="direct", min_cells=2,
                   sigma=0.0, divisors=None, sizes=None, smoother="cheb"):
    """Distributed (non-gathered) geometric h-multigrid coarse hierarchy.

    The gathered hmg coarse solves the FULL p=1 problem redundantly on
    every shard — fine at today's coarse sizes, a wall for 3-level
    p-hierarchies at 100M+ dofs (solvers/pmg.py coarse='hmg' note).
    This builder keeps every h-level in the duplicated-plane slab
    layout: coarsening is shard-aligned (each level's x-cells stay
    divisible by ``n_shards``, `coarsenable_levels(divisors=...)`), so
    per-level applies ride `dist_kron_cycle_ops` (ppermute partial-sum
    exchange) and inter-level transfers are the LOCAL blocks of the
    global per-axis h-interpolation — fine interface planes are
    ownership-weighted and coarse interface partials reconciled by the
    same exchange as the p-transfers (`dist_kron_cycle_ops.restrict_op`).
    Only the bottom solve gathers, at the much smaller coarsest level.

    Smoother calibration (per-level lmax), diagonals and the bottom
    factor come from a single global `build_hmg` pass over the SAME
    level sizes (the distributed operator is numerically identical, so
    the Lanczos estimates transfer; the global coarse hierarchy is tiny
    relative to the fine problem). Replaces the reference's distributed
    BoomerAMG coarse solve (src/amg.hpp:11-119) for shard counts where
    redundant-global solving stops scaling.

    Returns ``(levels, data, specs, bottom_mode, gather, unslice,
    bottom_solve)``: the `v_cycle`-shaped data pytree with per-leaf
    PartitionSpecs, the coarsest-level gather/slice hooks for the
    gathered bottom solves, and — for ``bottom='fdm'`` — the
    distributed-FDM bottom hook (``hmg_ops['fdm_dist']``), which makes
    the hierarchy fully gather-free.
    """
    from ..fem.mesh import BoxMesh
    from ..ops.kron import axis_stiffness_mass
    from ..solvers.hmg import (
        build_hmg,
        coarsen_spacing,
        coarsenable_levels,
        local_axis_h_interpolation,
    )

    from ..fem.assembly import resolve_kappa_axes
    from ..solvers.line import parse_line_smoother

    kax = resolve_kappa_axes(mesh, kappa)  # scalar / per-axis / diag tensor
    # Line-relaxation smoother on the distributed h-levels: the global
    # `build_hmg` pass computes the blocks (and line-preconditioned
    # lmax); each level's blocks are re-laid-out into the
    # duplicated-plane slab layout below (lines along y/z are
    # shard-local, zero extra communication).
    schwarz = smoother == "schwarz"
    line_axis = (None if schwarz
                 else parse_line_smoother(smoother, mesh, np.diag(kax),
                                          allowed=(1, 2)))
    if line_axis == 0:
        raise ValueError(
            "distributed (dist=True) h-MG line smoother cannot relax "
            "along x — the slab axis; use 'line-y'/'line-z'"
        )
    # ``divisors`` (coarse_cfg['divisors']) pins the alignment constraint
    # across shard counts (the hierarchy depth depends on it), keeping
    # scaling-sweep trajectories rank-count-invariant; must be a
    # per-axis multiple of the actual layout.
    div = tuple(divisors) if divisors is not None else (n_shards, 1, 1)
    if div[0] % n_shards:
        raise ValueError(
            f"divisors[0]={div[0]} must be a multiple of "
            f"n_shards={n_shards}"
        )
    if sizes is not None:
        # User hierarchy (coarse_cfg['sizes'], e.g. semicoarsen_sizes):
        # nesting-validated and every level x-shard-aligned.
        from ..solvers.hmg import validate_hmg_sizes

        sizes = validate_hmg_sizes(mesh.nc, sizes)
        for lvl in sizes:
            if any(c % d for c, d in zip(lvl, div)):
                raise ValueError(
                    f"coarse_cfg['sizes'] level {lvl} is not divisible "
                    f"by divisors={div}; every h-level must split into "
                    "the same per-shard slabs for the distributed "
                    "(dist=True) hierarchy"
                )
    else:
        sizes = coarsenable_levels(mesh.nc, min_cells=min_cells,
                                   divisors=div)
    if len(sizes) < 2:
        raise ValueError(
            f"mesh nc={mesh.nc} is not h-coarsenable with x-cells "
            f"divisible by n_shards={n_shards} (divisors={div}); use the "
            "gathered hmg coarse (coarse_cfg without dist=True) or a "
            "coarser-friendly mesh size"
        )
    g_levels, g_data, g_bottom = build_hmg(
        mesh, P0, kappa, dtype, smoother_iters=smoother_iters,
        precision=precision,
        # 'fdm' bottoms are dist-only (attached below); the global
        # calibration pass never runs a bottom solve.
        bottom=("smoother" if bottom == "fdm" else bottom),
        min_cells=min_cells,
        sigma=sigma, sizes=sizes, smoother=smoother,
    )
    sizes_cf = sizes[::-1]  # coarse -> fine, matching g_data["levels"]
    # Robin alphas are resolution-independent boundary data: the
    # coarsened levels carry the same face flags (rediscretized end
    # updates per h-level, matching the gathered build_hmg).
    robin = (mesh.robin_alpha if getattr(mesh, "has_robin", False)
             else None)
    # Graded meshes coarsen by MERGING cells (matching the global
    # build_hmg pass above — identical level meshes and blocks).
    meshes = [BoxMesh(nc, extent=mesh.extent,
                      dirichlet_faces=mesh.dirichlet_faces, robin=robin,
                      spacing=(coarsen_spacing(mesh.h_cells, mesh.nc, nc)
                               if mesh.is_graded else None))
              for nc in sizes_cf]
    parts = [SlabPartition(m, n_shards) for m in meshes]

    levels, level_data, level_specs = [], [], []
    for m, p_l, g_lv in zip(meshes, parts, g_data["levels"]):
        from ..ops.kron import local_axis_K, robin_axis_ends

        Kxf, x_stacked = local_axis_K(m, 0, p_l.cells_per_shard_x, P0,
                                      kax[0], n_shards)
        Ky, my = axis_stiffness_mass(
            m.nc[1], P0, m.h_cells[1], robin=robin_axis_ends(m, 1, 1.0 / kax[1]))
        Kz, mz = axis_stiffness_mass(
            m.nc[2], P0, m.h_cells[2], robin=robin_axis_ends(m, 2, 1.0 / kax[2]))
        _, mx_g = axis_stiffness_mass(m.nc[0], P0, m.h_cells[0])
        npl = p_l.local_planes(P0)
        mx_dup = duplicate_planes(mx_g, npl, n_shards)
        lv = dict(
            Kx=jnp.asarray(Kxf, dtype=dtype),
            Ky=jnp.asarray(kax[1] * Ky, dtype=dtype),
            Kz=jnp.asarray(kax[2] * Kz, dtype=dtype),
            mx=jnp.asarray(mx_dup, dtype=dtype),
            my=jnp.asarray(my, dtype=dtype),
            mz=jnp.asarray(mz, dtype=dtype),
            bc_marker=jnp.asarray(
                p_l.to_dist(P0, m.boundary_dof_marker(P0)) > 0.5
            ),
            diag_inv=jnp.asarray(
                p_l.to_dist(P0, np.asarray(g_lv["diag_inv"]).reshape(-1)),
                dtype=dtype,
            ),
            weights=jnp.asarray(p_l.ownership_weights(P0), dtype=dtype),
            lmax=g_lv["lmax"],
        )
        spec = dict(Kx=P(AXIS) if x_stacked else P(),
                    Ky=P(), Kz=P(), mx=P(AXIS), my=P(), mz=P(),
                    bc_marker=P(AXIS), diag_inv=P(AXIS), weights=P(AXIS),
                    lmax=P())
        if line_axis is not None:
            from ..solvers.line import shard_line_blocks

            # x is the leading lead axis (line axis is y or z): only it
            # gets the duplicated-plane layout.
            lv["line_inv"] = jnp.asarray(
                shard_line_blocks(g_lv["line_inv"], m.lattice_shape(P0),
                                  line_axis, [p_l.axis_starts(P0), None]),
                dtype=dtype)
            spec["line_inv"] = P(AXIS)
        if schwarz:
            # Global build_hmg pass already built this level's Schwarz
            # data (and the schwarz-preconditioned lmax); re-lay the
            # lattice-shaped w/bc into the duplicated-plane slab layout,
            # Vx/ginv slice cell-contiguously (x-cells stay divisible by
            # n_shards at every h-level by the alignment constraint).
            from ..solvers.schwarz import shard_dense_axis

            g_sw = g_lv["schwarz"]
            lv["schwarz"] = dict(
                Ux=jnp.asarray(
                    shard_dense_axis(g_sw["Ux"], P0,
                                     *p_l.axis_starts(P0)),
                    dtype=dtype),
                Uy=g_sw["Uy"], Uz=g_sw["Uz"],
                ginv=g_sw["ginv"],
                bc=jnp.asarray(p_l.to_dist(
                    P0, np.asarray(g_sw["bc"], np.float64)) > 0.5),
            )
            spec["schwarz"] = dict(Ux=P(AXIS), Uy=P(), Uz=P(),
                                   ginv=P(AXIS), bc=P(AXIS))
        levels.append(Level(P=P0, ndofs=p_l.local_ndofs(P0),
                            smoother_iters=smoother_iters,
                            shape=p_l.local_shape(P0),
                            line_axis=(line_axis if line_axis is not None
                                       else 2)))
        level_data.append(lv)
        level_specs.append(spec)

    transfer, transfer_specs = [], []
    for i in range(len(meshes) - 1):
        mc, mf = meshes[i], meshes[i + 1]
        pc, pf = parts[i], parts[i + 1]
        # Sharded GRADED x: per-shard row-stacked transfer blocks
        # (spec P(AXIS)), the local_axis_K mechanism for transfers.
        def _hf(a):
            return mf.h_cells[a] if mf.is_graded else None

        Ix, x_stacked = local_axis_h_interpolation(
            pc.cells_per_shard_x, P0, mf.nc[0] // mc.nc[0], n_shards,
            h_fine=_hf(0))
        Iy, _ = local_axis_h_interpolation(
            mc.nc[1], P0, mf.nc[1] // mc.nc[1], 1, h_fine=_hf(1))
        Iz, _ = local_axis_h_interpolation(
            mc.nc[2], P0, mf.nc[2] // mc.nc[2], 1, h_fine=_hf(2))
        tr = dict(
            Ix=jnp.asarray(Ix, dtype=dtype),
            Iy=jnp.asarray(Iy, dtype=dtype),
            Iz=jnp.asarray(Iz, dtype=dtype),
            weights_f=jnp.asarray(pf.ownership_weights(P0), dtype=dtype),
        )
        transfer.append(tr)
        transfer_specs.append(dict(Ix=P(AXIS) if x_stacked else P(),
                                   Iy=P(), Iz=P(),
                                   weights_f=P(AXIS)))

    data = dict(levels=tuple(level_data), transfer=tuple(transfer))
    specs = dict(levels=tuple(level_specs), transfer=tuple(transfer_specs))
    if "coarse_chol" in g_data:
        data["coarse_chol"] = g_data["coarse_chol"]
        specs["coarse_chol"] = P()
    bottom_solve = None
    if bottom == "fdm":
        # Distributed-FDM bottom (parallel/fdm_dist.py): the hierarchy
        # becomes FULLY gather-free — the coarsest h-level is solved
        # exactly via pencil all_to_all transposes instead of the
        # gathered redundant solve below.
        from .fdm_dist import make_fdm_dist

        fd_data, fd_spec, bottom_solve = make_fdm_dist(
            meshes[0], P0, parts[0],
            ((AXIS, n_shards) if n_shards > 1 else None, None, None),
            P(AXIS), kappa, dtype, precision=precision, sigma=sigma,
        )
        data["fdm"], specs["fdm"] = fd_data, fd_spec
        g_bottom = "fdm"

    # Bottom-solve gather/slice at the coarsest h-level.
    p0 = parts[0]
    npl0, NY0, NZ0 = p0.local_shape(P0)
    NXg = meshes[0].lattice_shape(P0)[0]

    def hmg_gather(b_local):
        lat = b_local.reshape(npl0, NY0, NZ0)
        allg = jax.lax.all_gather(lat, AXIS)
        pieces = [allg[s, :-1] for s in range(n_shards - 1)] + [allg[-1]]
        out = jnp.concatenate(pieces, axis=0)
        return out if b_local.ndim == 3 else out.reshape(-1)

    def hmg_slice(ug):
        lat = ug.reshape(NXg, NY0, NZ0)
        s = jax.lax.axis_index(AXIS)
        loc = jax.lax.dynamic_slice_in_dim(lat, s * (npl0 - 1), npl0,
                                           axis=0)
        return loc if ug.ndim == 3 else loc.reshape(-1)

    return (tuple(levels), data, specs, g_bottom, hmg_gather, hmg_slice,
            bottom_solve)


def dist_kron_cycle_ops(n_shards, precision="highest", sigma=0.0):
    """Sharded Kronecker-sum backend: 3 banded matmuls per apply, with the
    interface partial-sum exchange applied to the (only shard-partial)
    x-stiffness term via the `exchange` hook.

    Comm/compute overlap: the exchange depends only on the K_x term, and
    the K_y/K_z terms are data-independent of it, so XLA's latency-hiding
    scheduler can run the ppermute pair concurrently with two of the
    three matmuls — the compiler-scheduled analogue of the reference's
    hand-written lcells/bcells overlap (scatter_fwd_begin -> interior
    kernel -> scatter_fwd_end -> boundary kernel, laplacian.hpp:378-455).
    """
    from ..ops.kron import kron_laplacian_apply
    from ..ops.lattice import lattice_prolongate, lattice_restrict

    # LATTICE-SHAPED vectors (3D local blocks) end-to-end, matching the
    # single-device kron ops (see solvers.pmg.kron_cycle_ops).

    def apply_op(lv, x, level):
        y = kron_laplacian_apply(
            x, (lv["Kx"], lv["Ky"], lv["Kz"]), (lv["mx"], lv["my"], lv["mz"]),
            lv["bc_marker"], precision=precision, apply_bc=False,
            exchange=lambda t1: _exchange_partials(t1, n_shards),
            sigma=sigma,
        )
        return jnp.where(lv["bc_marker"], x, y)

    def restrict_op(tr, r, level_c, level_f):
        raw = lattice_restrict(
            r * tr["weights_f"], (tr["Ix"], tr["Iy"], tr["Iz"]),
            level_f.shape, precision,
        )
        return _exchange_partials(raw, n_shards)

    def prolong_op(tr, u, level_c, level_f):
        return lattice_prolongate(
            u, (tr["Ix"], tr["Iy"], tr["Iz"]), level_c.shape, precision
        )

    def dot(u, v, lv):
        return dist_inner_product(u, v, lv["weights"], AXIS)

    def pvary(v):
        return pcast_varying(v, (AXIS,))

    return dict(
        apply=apply_op, restrict=restrict_op, prolong=prolong_op, dot=dot,
        pvary=pvary,
        zeros=lambda level, dtype: jnp.zeros(level.shape, dtype=dtype),
        exchange=lambda lat: _exchange_partials(lat, n_shards),
    )


def dist_lattice_cycle_ops(n_shards, precision="highest", sigma=0.0):
    """Sharded V-cycle primitives over the lattice fast path.

    Shard-local banded matmuls (local x-axis matrices over the slab's
    cells, global y/z matrices) + the same interface-plane partial-sum
    exchange. Restriction zeroes the duplicated fine ghost plane via the
    ownership weights before the local transposed matmuls, so every fine
    dof contributes exactly once globally.
    """
    from ..ops.lattice import (
        lattice_laplacian_apply,
        lattice_prolongate,
        lattice_restrict,
    )

    def apply_op(lv, x, level):
        mats = {k: lv[k] for k in ("Ex", "Dx", "Ey", "Dy", "Ez", "Dz")}
        raw = lattice_laplacian_apply(
            x, mats, lv["G"], lv["bc_marker"], precision=precision,
            apply_bc=False,
        )
        lat = _exchange_partials(raw.reshape(level.shape), n_shards)
        y = lat.reshape(-1)
        if sigma:
            # Global duplicated-layout lumped mass: pointwise-consistent
            # on interface planes, added after the exchange.
            y = y + sigma * lv["m3"] * x
        return jnp.where(lv["bc_marker"], x, y)

    def restrict_op(tr, r, level_c, level_f):
        raw = lattice_restrict(
            r * tr["weights_f"], (tr["Ix"], tr["Iy"], tr["Iz"]),
            level_f.shape, precision,
        )
        lat = _exchange_partials(raw.reshape(level_c.shape), n_shards)
        return lat.reshape(-1)

    def prolong_op(tr, u, level_c, level_f):
        # Consistent coarse input -> consistent fine output, no comm.
        return lattice_prolongate(
            u, (tr["Ix"], tr["Iy"], tr["Iz"]), level_c.shape, precision
        )

    def dot(u, v, lv):
        return dist_inner_product(u, v, lv["weights"], AXIS)

    def pvary(v):
        return pcast_varying(v, (AXIS,))

    return dict(
        apply=apply_op, restrict=restrict_op, prolong=prolong_op, dot=dot,
        pvary=pvary,
        exchange=lambda lat: _exchange_partials(lat, n_shards),
    )


class DistPMG:
    """Multi-device p-multigrid on a slab-partitioned box mesh.

    Counterpart of the whole reference multi-rank pmg driver: partitions
    the mesh, places per-level operator data across the device mesh,
    calibrates smoothers with a *distributed* recorded-CG run, and exposes
    jitted sharded ``v_cycle`` / ``solve`` / ``operator``.
    """

    def __init__(self, mesh, n_devices=None, degrees=(1, 3), kappa=2.0,
                 dtype=jnp.float64, smoother_iters=DEFAULT_SMOOTHER_ITERS,
                 coarse="cg", coarse_cfg=None, devices=None,
                 calibration_iters=DEFAULT_CALIBRATION_ITERS,
                 operator="dofmap", precision="highest", sigma=0.0,
                 smoother="cheb"):
        from ..fem.assembly import stiffness_diagonal_np
        from ..ops.lattice import (
            axis_interpolation_matrix,
            axis_matrices,
            geometry_to_qlattice,
        )

        n_devices = n_devices or len(jax.devices())
        self.jmesh = make_mesh(n_devices, devices)
        self.n_shards = n_devices
        self.part = SlabPartition(mesh, n_devices)
        self.mesh = mesh
        self.degrees = tuple(int(p) for p in degrees)
        from ..fem.mesh import require_axis_aligned

        from ..fem.assembly import resolve_sigma

        self.sigma, self._sigma_field = resolve_sigma(sigma)
        if self._sigma_field is not None:
            if operator == "kron":
                raise ValueError(
                    "a sigma FIELD (callable) requires a general backend "
                    "— the Kronecker paths carry only a separable scalar "
                    "shift"
                )
            if coarse == "fdm" or (coarse_cfg or {}).get("dist"):
                raise ValueError(
                    "a sigma FIELD supports the gathered coarse solvers "
                    "(cg/smoother/direct/hmg) only"
                )
            if smoother != "cheb" or (coarse_cfg or {}).get(
                    "smoother", "cheb") != "cheb":
                raise ValueError(
                    "line/schwarz smoothers support a scalar sigma only"
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
        # p-level LINE-relaxation smoother (solvers/line.py): lines along
        # y or z are shard-local on the x-slab layout, so the batched
        # block matvec needs no communication; the block inverses are
        # built globally and sharded in the duplicated-plane layout
        # (both owners of an interface plane hold identical blocks, so
        # the "duplicates equal" invariant is preserved).
        from ..solvers.line import line_block_inverses, parse_line_smoother

        # 'schwarz' = cell-wise FDM Schwarz (solvers/schwarz.py): the
        # blocks are cell-local, so only the overlap-add touches shard
        # interfaces — reconciled by the same partial-sum ppermute as
        # the operator applies (ops['exchange'] inside the smoother).
        self._schwarz = smoother == "schwarz"
        self._line_axis = (None if self._schwarz
                           else parse_line_smoother(smoother, mesh, kappa,
                                                    allowed=(1, 2)))
        if self._line_axis == 0:
            raise ValueError(
                "DistPMG smoother='line' cannot relax along x — the "
                "sharded axis (lines would span shards); use 'line-y'/"
                "'line-z', or GridPMG with an x-unsharded layout"
            )
        if operator not in ("kron", "lattice", "dofmap"):
            raise ValueError(
                f"DistPMG: unknown operator backend {operator!r} (choose "
                "'kron', 'lattice' or 'dofmap')"
            )
        kron_family = operator == "kron"
        # Robin on the general backends rides the baked pointwise shift
        # (boundary mass folded into m3); shared scalar policy:
        # fem.assembly.ops_shift_scalar.
        self._ops_sigma = ops_shift_scalar(mesh, self.sigma, kron_family)
        if kron_family:
            require_axis_aligned(mesh, f"DistPMG operator='{operator}'")
        if coarse == "fdm":
            require_axis_aligned(mesh, "coarse='fdm'")
        self._kappa_raw = kappa
        self._kc, self._kappa_fold, _kconst = resolve_kappa_split(
            mesh, kappa)
        # See PMGHierarchy: tensor kappa folds into G via _kappa_fold;
        # _kc is the per-cell scalar (ones for tensors), applied to big
        # geometry arrays only through scale_G.
        self.kappa_cells = (self._kappa_fold if self._kappa_fold is not None
                            else self._kc)
        self.kappa = float(self._kc[0]) if _kconst else None
        # Per-axis coefficient (kx, ky, kz): constant scalar / per-axis /
        # diagonal tensor — the forms the Kronecker-sum paths (and the
        # exact FDM coarse) can express. See fem.assembly.resolve_kappa_axes.
        from ..fem.assembly import resolve_kappa_axes

        try:
            self.kappa_axes = resolve_kappa_axes(
                mesh, kappa,
                split=(self._kc, self._kappa_fold, _kconst))
        except ValueError:
            if kron_family:
                raise
            self.kappa_axes = None
        if self.kappa_axes is None and coarse == "fdm":
            raise ValueError(
                "DistPMG: coarse='fdm' is constant-coefficient (scalar, "
                "per-axis or diagonal-tensor) only; use 'hmg', 'cg', "
                "'smoother' or 'direct'"
            )
        self.dtype = dtype
        self.precision = precision
        self.coarse = coarse
        self.coarse_cfg = dict(coarse_cfg or {})
        self.operator_kind = operator
        self.eigs = []

        part = self.part
        kax = self.kappa_axes  # per-axis kron coefficient (None = general)
        level_data, level_specs, levels = [], [], []
        for Pdeg in self.degrees:
            # Geometry factors computed on host (float64); cells are
            # slab-contiguous in x, so per-cell and quadrature-lattice
            # layouts both shard along axis 0.
            G_cells, _ = geometry_factors(
                mesh.geometry_x,
                mesh.geometry_dofmap,
                tabulate_geometry_dphi(Pdeg),
                quadrature_weights_3d(Pdeg),
                xp=np,
                kappa=self._kappa_fold,
            )
            # kron backends carry lattice-shaped (3D) vectors; the general
            # backends keep the flat contract of the dofmap/E-matrix ops.
            conform = ((lambda a: a) if kron_family
                       else (lambda a: a.reshape(-1)))
            common = dict(
                bc_marker=jnp.asarray(
                    conform(part.to_dist(Pdeg, mesh.boundary_dof_marker(Pdeg)))
                    > 0.5
                ),
                weights=jnp.asarray(
                    conform(part.ownership_weights(Pdeg)), dtype=dtype
                ),
                diag_inv=jnp.asarray(
                    conform(part.to_dist(
                        Pdeg,
                        1.0 / _shifted_diag_np(
                            mesh, Pdeg, self.kappa_cells, self.sigma,
                            sigma_field=self._sigma_field),
                    )),
                    dtype=dtype,
                ),
            )
            common_spec = dict(bc_marker=P(AXIS), weights=P(AXIS),
                               diag_inv=P(AXIS))
            if self._line_axis is not None:
                from ..solvers.line import shard_line_blocks

                # Global within-line block inverses -> duplicated-plane
                # slab layout (x is the leading lead axis; the line axis
                # is y or z).
                common["line_inv"] = jnp.asarray(
                    shard_line_blocks(
                        line_block_inverses(mesh, Pdeg, self._kappa_raw,
                                            self._line_axis,
                                            sigma=self.sigma),
                        mesh.lattice_shape(Pdeg), self._line_axis,
                        [part.axis_starts(Pdeg), None],
                    ),
                    dtype=dtype,
                )
                common_spec["line_inv"] = P(AXIS)
            if self._schwarz:
                from ..solvers.schwarz import (build_schwarz_np,
                                               shard_dense_axis)

                # Global host build, then the slab layout: ginv is
                # cell-contiguous along x (the PartitionSpec slices
                # it — nx % n_shards == 0 by SlabPartition), bc is
                # dof-lattice-shaped and gets duplicated interface
                # planes like every other lattice-shaped level array.
                # The dense-form Ux re-lays as row-stacked per-shard
                # diagonal blocks (local nodes incl. duplicated planes
                # -> local cells); Uy/Uz are replicated whole.
                swg = build_schwarz_np(mesh, Pdeg, self._kappa_raw,
                                       sigma=self.sigma)
                common["schwarz"] = dict(
                    {k: jnp.asarray(swg[k], dtype=dtype)
                     for k in ("Uy", "Uz", "ginv")},
                    Ux=jnp.asarray(
                        shard_dense_axis(swg["Ux"], Pdeg,
                                         *part.axis_starts(Pdeg)),
                        dtype=dtype),
                    bc=jnp.asarray(part.to_dist(
                        Pdeg, np.asarray(swg["bc"], np.float64)) > 0.5),
                )
                common_spec["schwarz"] = dict(
                    ginv=P(AXIS), Ux=P(AXIS), Uy=P(), Uz=P(), bc=P(AXIS),
                )
            if self._ops_sigma and not kron_family:
                # Pointwise shift vector: sigma * (field-folded) mass,
                # with any Robin boundary mass baked in (shared policy
                # fem.assembly.general_shift_np, ops scalar then 1.0).
                from ..fem.assembly import general_shift_np

                common["m3"] = jnp.asarray(
                    conform(part.to_dist(
                        Pdeg, general_shift_np(mesh, Pdeg, self.sigma,
                                               self._sigma_field)[1]
                    )),
                    dtype=dtype,
                )
                common_spec["m3"] = P(AXIS)
            if kron_family:
                from ..ops.kron import (axis_stiffness_mass, local_axis_K,
                                        robin_axis_ends)

                lv = dict(common)
                spec = dict(common_spec)
                # Local x-axis stiffness (partial sums at interfaces are
                # reconciled by the exchange); global y/z matrices. Robin
                # ends fold into the global y/z matrices directly (the
                # 1/k_a pre-divide keeps alpha kappa-free after the fold)
                # and into a per-shard ROW-STACKED x matrix when the
                # sharded x axis carries Robin faces (spec P(AXIS) — each
                # shard sees its own block, only the global-end shards
                # differ).
                Kxf, x_stacked = local_axis_K(
                    mesh, 0, part.cells_per_shard_x, Pdeg, kax[0],
                    part.n_shards,
                )
                Ky, my = axis_stiffness_mass(
                    mesh.nc[1], Pdeg, mesh.h_cells[1],
                    robin=robin_axis_ends(mesh, 1, 1.0 / kax[1]))
                Kz, mz = axis_stiffness_mass(
                    mesh.nc[2], Pdeg, mesh.h_cells[2],
                    robin=robin_axis_ends(mesh, 2, 1.0 / kax[2]))
                _, mx_g = axis_stiffness_mass(mesh.nc[0], Pdeg, mesh.h_cells[0])
                # Global x-mass in the duplicated-plane layout, sharded.
                npl = part.local_planes(Pdeg)
                mx_dup = duplicate_planes(mx_g, npl, part.n_shards)
                Kx_shards = (Kxf.reshape(part.n_shards, npl, npl)
                             if x_stacked
                             else np.broadcast_to(
                                 Kxf, (part.n_shards, npl, npl)))
                lv.update(
                    Kx=jnp.asarray(Kxf, dtype=dtype),
                    Ky=jnp.asarray(kax[1] * Ky, dtype=dtype),
                    Kz=jnp.asarray(kax[2] * Kz, dtype=dtype),
                    mx=jnp.asarray(mx_dup, dtype=dtype),
                    my=jnp.asarray(my, dtype=dtype),
                    mz=jnp.asarray(mz, dtype=dtype),
                )
                spec.update(Kx=P(AXIS) if x_stacked else P(),
                            Ky=P(), Kz=P(),
                            mx=P(AXIS), my=P(), mz=P())
            elif operator == "lattice":
                lv = dict(common)
                spec = dict(common_spec)
                lv["G"] = jnp.asarray(
                    geometry_to_qlattice(
                        scale_G(G_cells, self._kc, self._kappa_fold),
                        mesh.nc, Pdeg,
                    ),
                    dtype=dtype,
                )
                spec["G"] = P(AXIS)
                for name, nc_a in (
                    ("x", part.cells_per_shard_x),
                    ("y", mesh.nc[1]),
                    ("z", mesh.nc[2]),
                ):
                    E, Dg = axis_matrices(nc_a, Pdeg)
                    lv["E" + name] = jnp.asarray(E, dtype=dtype)
                    lv["D" + name] = jnp.asarray(Dg, dtype=dtype)
                    spec["E" + name] = P()
                    spec["D" + name] = P()
            else:
                lv = dict(common)
                spec = dict(common_spec)
                lv.update(
                    dofmap=jnp.asarray(part.local_dofmap(Pdeg)),
                    G=jnp.asarray(G_cells, dtype=dtype),
                    coeff=jnp.asarray(self._kc, dtype=dtype),
                    D=jnp.asarray(derivative_matrix(Pdeg), dtype=dtype),
                )
                spec.update(dofmap=P(), G=P(AXIS), coeff=P(AXIS), D=P())
            level = Level(
                P=Pdeg,
                ndofs=part.local_ndofs(Pdeg),
                smoother_iters=smoother_iters,
                shape=part.local_shape(Pdeg),
                line_axis=(self._line_axis
                           if self._line_axis is not None else 2),
            )
            level_data.append(lv)
            level_specs.append(spec)
            levels.append(level)

        self.levels = tuple(levels)
        if operator == "kron":
            ops = dist_kron_cycle_ops(self.n_shards, precision,
                                      sigma=self.sigma)
        elif operator == "lattice":
            ops = dist_lattice_cycle_ops(self.n_shards, precision,
                                         sigma=self._ops_sigma)
        else:
            ops = dist_cycle_ops(self.n_shards, sigma=self._ops_sigma)

        if coarse not in ("cg", "smoother", "fdm", "direct", "hmg"):
            raise ValueError(
                f"DistPMG: unsupported coarse solver '{coarse}' "
                "(choose from cg, smoother, fdm, direct, hmg)"
            )

        self._coarse_data = None
        self._coarse_spec = None
        if coarse in ("fdm", "direct", "hmg"):
            # Global-coarse solvers: gather the (small) coarse rhs, solve
            # redundantly on every shard, slice the local planes back —
            # the analogue of the reference coarse solve running under
            # any rank layout (src/amg.hpp:67-113).
            P0 = self.degrees[0]
            npl0, NY0, NZ0 = part.local_shape(P0)
            NXg = mesh.lattice_shape(P0)[0]
            n_sh = self.n_shards

            # Shape-preserving hooks: lattice-shaped in -> lattice-shaped
            # out (kron), flat in -> flat out (general backends).
            def coarse_gather(b0_local):
                lat = b0_local.reshape(npl0, NY0, NZ0)
                allg = jax.lax.all_gather(lat, AXIS)  # (n_sh, npl, NY, NZ)
                parts = [allg[s, :-1] for s in range(n_sh - 1)] + [allg[-1]]
                out = jnp.concatenate(parts, axis=0)
                return out if b0_local.ndim == 3 else out.reshape(-1)

            def coarse_slice(ug):
                lat = ug.reshape(NXg, NY0, NZ0)
                s = jax.lax.axis_index(AXIS)
                loc = jax.lax.dynamic_slice_in_dim(
                    lat, s * (npl0 - 1), npl0, axis=0
                )
                return loc if ug.ndim == 3 else loc.reshape(-1)

            ops = dict(ops, coarse_gather=coarse_gather,
                       coarse_slice=coarse_slice)

            if coarse == "fdm" and self.coarse_cfg.get("dist"):
                # Non-gathered form: pencil all_to_all transposes on the
                # sharded x axis (parallel/fdm_dist.py) — the hooks above
                # go unused on this branch.
                from .fdm_dist import make_fdm_dist

                fd_data, fd_spec, fd_solve = make_fdm_dist(
                    mesh, P0, part,
                    ((AXIS, n_sh) if n_sh > 1 else None, None, None),
                    P(AXIS), self.kappa_axes, dtype,
                    precision=precision, sigma=self.sigma,
                )
                self._coarse_data = ("fdm", fd_data)
                self._coarse_spec = fd_spec
                ops = dict(ops, fdm_dist=fd_solve)
            elif coarse == "fdm":
                from ..solvers.fdm import FastDiagonalizationSolver

                fd = FastDiagonalizationSolver(
                    mesh, P0, kappa=self.kappa_axes, dtype=dtype,
                    precision=precision, sigma=self.sigma,
                )
                self._coarse_data = ("fdm", dict(
                    Vx=fd.Vs[0], Vy=fd.Vs[1], Vz=fd.Vs[2],
                    Vxt=fd.Vts[0], Vyt=fd.Vts[1], Vzt=fd.Vts[2],
                    dinv=fd.dinv, bc_global=fd.bc_marker,
                ))
                self.coarse_cfg["fdm_shape"] = mesh.lattice_shape(P0)
                self.coarse_cfg["fdm_trims"] = fd.trims
            elif coarse == "direct":
                from ..fem.assembly import assemble_stiffness

                A0 = assemble_stiffness(
                    mesh, P0, kappa=self.kappa_cells
                ).toarray()
                if self.sigma:
                    # Shifted coarse operator A0 + sigma*M (lumped mass,
                    # bc rows zeroed; a sigma FIELD is baked in) — must
                    # match the sharded apply or the coarse correction
                    # solves the wrong operator.
                    from ..fem.assembly import shifted_mass_np

                    A0[np.diag_indices_from(A0)] += (
                        self.sigma * shifted_mass_np(mesh, P0,
                                                     self._sigma_field)
                    )
                self._coarse_data = (
                    "coarse_chol",
                    jnp.asarray(np.linalg.cholesky(A0), dtype=dtype),
                )
            elif self.coarse_cfg.get("dist"):
                # Non-gathered h-MG coarse: every h-level stays in the
                # slab layout (see `build_hmg_dist`); only the coarsest
                # bottom solve gathers. Constant-kappa boxes only (the
                # kron h-hierarchy).
                if not (getattr(mesh, "is_axis_aligned", True)
                        and self.kappa_axes is not None):
                    raise ValueError(
                        "DistPMG coarse_cfg dist=True (distributed hmg) "
                        "requires a constant-kappa axis-aligned BoxMesh; "
                        "for the general family use the gathered hmg "
                        "coarse here, or GridPMG(shards=(n, 1, 1), "
                        "coarse='hmg', coarse_cfg=dict(dist=True)) — "
                        "the multi-axis build_hmg_grid_general covers "
                        "the 1D-slab layout"
                    )
                (hmg_levels, hmg_data, hmg_specs, hmg_bottom,
                 hmg_gather, hmg_slice, hmg_bottom_solve) = build_hmg_dist(
                    mesh, self.n_shards, P0, self.kappa_axes, dtype,
                    smoother_iters=smoother_iters, precision=precision,
                    bottom=self.coarse_cfg.get("bottom", "direct"),
                    min_cells=self.coarse_cfg.get("min_cells", 2),
                    sigma=self.sigma,
                    divisors=self.coarse_cfg.get("divisors"),
                    sizes=self.coarse_cfg.get("sizes"),
                    smoother=self.coarse_cfg.get("smoother", "cheb"),
                )
                hmg_ops = dict(
                    dist_kron_cycle_ops(self.n_shards, precision,
                                        sigma=self.sigma),
                    coarse_gather=hmg_gather,
                    coarse_slice=hmg_slice,
                )
                if hmg_bottom_solve is not None:
                    # bottom='fdm': gather-free exact bottom solve.
                    hmg_ops["fdm_dist"] = hmg_bottom_solve
                self.coarse_cfg.update(
                    hmg_levels=hmg_levels, hmg_ops=hmg_ops,
                    hmg_bottom=hmg_bottom, hmg_dist=True,
                    cycles=self.coarse_cfg.get("cycles", 3),
                )
                self._coarse_data = ("hmg", hmg_data)
                self._coarse_spec = hmg_specs
            else:  # hmg (gathered, solved redundantly per shard)
                # Constant-kappa boxes ride the kron h-hierarchy; the
                # general family (curved hexes / DG-0 kappa) the
                # rediscretized lattice one (solvers.hmg.build_hmg_general).
                if (getattr(mesh, "is_axis_aligned", True)
                        and self.kappa_axes is not None
                        and self._sigma_field is None):
                    from ..solvers.hmg import build_hmg
                    from ..solvers.pmg import kron_cycle_ops

                    hmg_levels, hmg_data, hmg_bottom = build_hmg(
                        mesh, P0, self.kappa_axes, dtype,
                        smoother_iters=smoother_iters, precision=precision,
                        bottom=self.coarse_cfg.get("bottom", "direct"),
                        min_cells=self.coarse_cfg.get("min_cells", 2),
                        sigma=self.sigma,
                        sizes=self.coarse_cfg.get("sizes"),
                        smoother=self.coarse_cfg.get("smoother", "cheb"),
                    )
                    hmg_core = kron_cycle_ops(precision, sigma=self.sigma)
                else:
                    from ..solvers.hmg import build_hmg_general

                    hmg_levels, hmg_data, hmg_bottom, hmg_core = (
                        build_hmg_general(
                            mesh, P0, self._kappa_raw, dtype,
                            smoother_iters=smoother_iters,
                            precision=precision,
                            bottom=self.coarse_cfg.get("bottom", "direct"),
                            min_cells=self.coarse_cfg.get("min_cells", 2),
                            sigma=self.sigma,
                            sigma_field=self._sigma_field,
                            sizes=self.coarse_cfg.get("sizes"),
                            smoother=self.coarse_cfg.get(
                                "smoother", "cheb"),
                        )
                    )
                hmg_ops = dict(
                    hmg_core,
                    pvary=lambda v: pcast_varying(v, (AXIS,)),
                )
                self.coarse_cfg.update(
                    hmg_levels=hmg_levels, hmg_ops=hmg_ops,
                    hmg_bottom=hmg_bottom,
                    cycles=self.coarse_cfg.get("cycles", 3),
                )
                self._coarse_data = ("hmg", hmg_data)
        self._ops = ops

        # Place data, then run the smoother calibration *distributed*.
        with self.jmesh:
            for lv, spec, level in zip(level_data, level_specs, levels):
                for k in lv:
                    if isinstance(lv[k], dict):  # nested (e.g. kb_mats)
                        lv[k] = {
                            kk: put_global(
                                vv, NamedSharding(self.jmesh, spec[k][kk])
                            )
                            for kk, vv in lv[k].items()
                        }
                    else:
                        lv[k] = put_global(
                            lv[k], NamedSharding(self.jmesh, spec[k])
                        )

                # Distributed smoother calibration: recorded Jacobi-CG on
                # A x = 1 (the reference per-level calibration,
                # examples/pmg/main.cpp:303-330, with psum reductions).
                def _calib(lv_, b_, x0_):
                    A = lambda x: ops["apply"](lv_, x, level)
                    # Same preconditioned operator the smoother iterates
                    # on (shard-local line blocks, exchange-reconciled
                    # Schwarz cell blocks, or point Jacobi).
                    pre = None
                    if "line_inv" in lv_:
                        from ..solvers.line import line_precond_apply

                        pre = lambda r: line_precond_apply(
                            lv_["line_inv"], r, level.shape,
                            level.line_axis)
                    elif "schwarz" in lv_:
                        from ..solvers.schwarz import schwarz_precond_apply

                        pre = lambda r: schwarz_precond_apply(
                            lv_["schwarz"], r, level.shape, level.P,
                            exchange=ops.get("exchange"))
                    return cg_solve(
                        A, b_, x0_, lv_["diag_inv"],
                        rtol=DEFAULT_CALIBRATION_RTOL,
                        maxiter=calibration_iters,
                        record=True,
                        dot=lambda u, v: ops["dot"](u, v, lv_),
                        precond=pre,
                    )
                calib_fn = jax.jit(
                    jax.shard_map(
                        _calib,
                        mesh=self.jmesh,
                        in_specs=(spec, P(AXIS), P(AXIS)),
                        out_specs=(P(AXIS), dict(
                            niter=P(), rnorm=P(), rnorm0=P(),
                            alphas=P(), betas=P(), residuals=P(), stored=P(),
                        )),
                    )
                )
                if kron_family:
                    vshape = (level.shape[0] * self.n_shards,) + level.shape[1:]
                else:
                    vshape = (level.ndofs * self.n_shards,)
                vsh = NamedSharding(self.jmesh, P(AXIS))
                _, info = calib_fn(
                    lv,
                    put_global(np.ones(vshape, dtype=dtype), vsh),
                    put_global(np.zeros(vshape, dtype=dtype), vsh),
                )
                eigs = lanczos_eigenvalue_estimates(
                    info["alphas"], info["betas"], info["stored"]
                )
                self.eigs.append(eigs)
                lv["lmax"] = put_global(
                    jnp.asarray(EIG_RANGE_FACTORS[1] * eigs[-1], dtype=dtype),
                    NamedSharding(self.jmesh, P()),
                )
                spec["lmax"] = P()

        transfer, transfer_specs = [], []
        for i in range(len(self.degrees) - 1):
            Pc, Pf = self.degrees[i], self.degrees[i + 1]
            if operator in ("lattice", "kron"):
                tr = dict(
                    Ix=jnp.asarray(
                        axis_interpolation_matrix(part.cells_per_shard_x, Pc, Pf),
                        dtype=dtype,
                    ),
                    Iy=jnp.asarray(
                        axis_interpolation_matrix(mesh.nc[1], Pc, Pf), dtype=dtype
                    ),
                    Iz=jnp.asarray(
                        axis_interpolation_matrix(mesh.nc[2], Pc, Pf), dtype=dtype
                    ),
                    weights_f=jnp.asarray(
                        (part.ownership_weights(Pf) if kron_family
                         else part.ownership_weights(Pf).reshape(-1)),
                        dtype=dtype,
                    ),
                )
                spec = dict(Ix=P(), Iy=P(), Iz=P(), weights_f=P(AXIS))
            else:
                tr = dict(
                    M1=jnp.asarray(interpolation_matrix_1d(Pc, Pf), dtype=dtype),
                    dofmap_c=jnp.asarray(part.local_dofmap(Pc)),
                    dofmap_f=jnp.asarray(part.local_dofmap(Pf)),
                    mult_f=jnp.asarray(
                        part.to_dist(Pf, mesh.dof_multiplicity(Pf)).reshape(-1),
                        dtype=dtype,
                    ),
                )
                spec = dict(M1=P(), dofmap_c=P(), dofmap_f=P(), mult_f=P(AXIS))
            with self.jmesh:
                for k in tr:
                    tr[k] = put_global(tr[k], NamedSharding(self.jmesh, spec[k]))
            transfer.append(tr)
            transfer_specs.append(spec)

        self.data = dict(levels=tuple(level_data), transfer=tuple(transfer))
        self.data_specs = dict(
            levels=tuple(level_specs), transfer=tuple(transfer_specs)
        )
        if self._coarse_data is not None:
            key, cdata = self._coarse_data
            spec_tree = getattr(self, "_coarse_spec", None)
            if spec_tree is None:  # gathered coarse: fully replicated
                spec_tree = jax.tree.map(lambda _: P(), cdata)
            cdata = jax.tree.map(
                lambda a, s: put_global(a, NamedSharding(self.jmesh, s)),
                cdata, spec_tree,
            )
            self.data[key] = cdata
            self.data_specs[key] = spec_tree

        self._vcycle = jax.jit(
            jax.shard_map(
                partial(
                    v_cycle,
                    levels=self.levels,
                    coarse=self.coarse,
                    coarse_cfg=self.coarse_cfg,
                    ops=self._ops,
                ),
                mesh=self.jmesh,
                in_specs=(self.data_specs, P(AXIS), P(AXIS)),
                out_specs=P(AXIS),
            )
        )

        fine = self.levels[-1]
        fine_spec = self.data_specs["levels"][-1]

        def _residual_norm(lv, b, u):
            A = lambda x: ops["apply"](lv, x, fine)
            r = b - A(u)
            return jnp.sqrt(ops["dot"](r, r, lv))

        self._rnorm = jax.jit(
            jax.shard_map(
                _residual_norm,
                mesh=self.jmesh,
                in_specs=(fine_spec, P(AXIS), P(AXIS)),
                out_specs=P(),
            )
        )
        self._fine_apply = jax.jit(
            jax.shard_map(
                lambda lv, x: ops["apply"](lv, x, fine),
                mesh=self.jmesh,
                in_specs=(fine_spec, P(AXIS)),
                out_specs=P(AXIS),
            )
        )

    # -- vector layout helpers -----------------------------------------

    def to_dist(self, u, level=-1):
        Pdeg = self.degrees[level]
        ud = self.part.to_dist(Pdeg, np.asarray(u))
        if self.operator_kind != "kron":
            ud = ud.reshape(-1)  # general backends keep the flat contract
        return put_global(
            np.asarray(ud, dtype=self.dtype),
            NamedSharding(self.jmesh, P(AXIS)),
        )

    def from_dist(self, ud, level=-1):
        return self.part.from_dist(self.degrees[level], fetch_global(ud))

    # -- solver API ----------------------------------------------------

    def apply(self, b_dist, u_dist):
        """One sharded V-cycle."""
        return self._vcycle(self.data, b_dist, u_dist)

    def operator(self):
        """Fine-level distributed operator ``x_dist -> (A x)_dist``."""
        lv = self.data["levels"][-1]
        return lambda x: self._fine_apply(lv, x)

    def residual_norm(self, b_dist, u_dist):
        return float(self._rnorm(self.data["levels"][-1], b_dist, u_dist))

    def solve_pcg(self, b, rtol=1e-8, maxiter=50, fmg=False):
        """Sharded V-cycle-preconditioned flexible CG — one jitted
        shard_map'd while_loop (see `PMGHierarchy.solve_pcg`); ``fmg``
        starts from the sharded full-multigrid guess.
        Returns ``(u, niter)``."""
        from ..solvers.cg import fcg_solve

        if not hasattr(self, "_pcg_cache"):
            self._pcg_cache = {}
        key = (float(rtol), int(maxiter))
        if key not in self._pcg_cache:
            ops = self._ops
            fine = self.levels[-1]

            def _run(data, bd, u0, _rtol=key[0], _maxiter=key[1]):
                lvf = data["levels"][-1]
                A = lambda x: ops["apply"](lvf, x, fine)
                M = lambda r: v_cycle(
                    data, r, ops["pvary"](jnp.zeros_like(r)),
                    levels=self.levels, coarse=self.coarse,
                    coarse_cfg=self.coarse_cfg, ops=ops,
                )
                return fcg_solve(
                    A, bd, u0, M,
                    rtol=_rtol, maxiter=_maxiter,
                    dot=lambda u_, v_: ops["dot"](u_, v_, lvf),
                )

            self._pcg_cache[key] = jax.jit(
                jax.shard_map(
                    _run, mesh=self.jmesh,
                    in_specs=(self.data_specs, P(AXIS), P(AXIS)),
                    out_specs=(P(AXIS),
                               dict(niter=P(), rnorm=P(), rnorm0=P())),
                )
            )
        bd = self.to_dist(b)
        u0d = self._fmg_guess_dist(bd) if fmg else jnp.zeros_like(bd)
        u, info = self._pcg_cache[key](self.data, bd, u0d)
        return self.from_dist(u), int(info["niter"])

    def solve_refined(self, b, num_cycles=15, rtol=0.0, residuals=True,
                      u0=None, fmg=False):
        """Sharded mixed-precision iterative refinement (see the
        single-device `PMGHierarchy.solve_refined`): f64 residual via a
        sharded fine-level apply (Kronecker on axis-aligned
        constant-coefficient problems, lattice otherwise — general hexes
        and variable DG-0 kappa), f32 sharded V-cycle as error smoother.
        ``fmg`` seeds the loop with the sharded working-dtype FMG guess.
        Requires jax_enable_x64."""
        from ..solvers.pmg import warn_tensor_stationary

        warn_tensor_stationary(self._kappa_fold, self.kappa_axes,
                               self.operator_kind,
                               line=(self._line_axis is not None
                                     or self._schwarz))
        from ..ops.kron import axis_stiffness_mass, kron_laplacian_apply

        if not jax.config.read("jax_enable_x64"):
            raise RuntimeError("solve_refined requires jax_enable_x64")
        part, mesh = self.part, self.mesh
        fine = self.levels[-1]
        Pdeg = self.degrees[-1]
        use_kron64 = (getattr(mesh, "is_axis_aligned", True)
                      and self.kappa_axes is not None
                      # a sigma field needs the m3-baked lattice path
                      and self._sigma_field is None)
        kax = self.kappa_axes
        if getattr(self, "_refine_step", None) is None:
            # f64 state shares the work layout of the f32 cycle: 3D for
            # the kron backends, flat for the general backends.
            conform = ((lambda a: a)
                       if self.operator_kind == "kron"
                       else (lambda a: a.reshape(-1)))
            common = dict(
                bc_marker=jnp.asarray(
                    conform(part.to_dist(Pdeg, mesh.boundary_dof_marker(Pdeg)))
                    > 0.5
                ),
                weights=jnp.asarray(
                    conform(part.ownership_weights(Pdeg)), dtype=jnp.float64
                ),
            )
            common_spec = dict(bc_marker=P(AXIS), weights=P(AXIS))
            if use_kron64:
                from ..ops.kron import local_axis_K, robin_axis_ends

                Kxf, x_stacked = local_axis_K(
                    mesh, 0, part.cells_per_shard_x, Pdeg, kax[0],
                    part.n_shards,
                )
                Ky, my = axis_stiffness_mass(
                    mesh.nc[1], Pdeg, mesh.h_cells[1],
                    robin=robin_axis_ends(mesh, 1, 1.0 / kax[1]))
                Kz, mz = axis_stiffness_mass(
                    mesh.nc[2], Pdeg, mesh.h_cells[2],
                    robin=robin_axis_ends(mesh, 2, 1.0 / kax[2]))
                _, mx_g = axis_stiffness_mass(mesh.nc[0], Pdeg, mesh.h_cells[0])
                npl = part.local_planes(Pdeg)
                mx_dup = duplicate_planes(mx_g, npl, part.n_shards)
                lv64 = dict(
                    common,
                    Kx=jnp.asarray(Kxf, dtype=jnp.float64),
                    Ky=jnp.asarray(kax[1] * Ky, dtype=jnp.float64),
                    Kz=jnp.asarray(kax[2] * Kz, dtype=jnp.float64),
                    mx=jnp.asarray(mx_dup, dtype=jnp.float64),
                    my=jnp.asarray(my, dtype=jnp.float64),
                    mz=jnp.asarray(mz, dtype=jnp.float64),
                )
                lv64_spec = dict(common_spec,
                                 Kx=P(AXIS) if x_stacked else P(),
                                 Ky=P(), Kz=P(),
                                 mx=P(AXIS), my=P(), mz=P())
            else:
                from ..ops.lattice import (
                    axis_matrices,
                    geometry_to_qlattice,
                )

                G_cells, _ = geometry_factors(
                    mesh.geometry_x,
                    mesh.geometry_dofmap,
                    tabulate_geometry_dphi(Pdeg),
                    quadrature_weights_3d(Pdeg),
                    xp=np,
                    kappa=self._kappa_fold,
                )
                lv64 = dict(
                    common,
                    G=jnp.asarray(
                        geometry_to_qlattice(
                            scale_G(G_cells, self._kc, self._kappa_fold),
                            mesh.nc, Pdeg,
                        ),
                        dtype=jnp.float64,
                    ),
                )
                lv64_spec = dict(common_spec, G=P(AXIS))
                if self._ops_sigma:
                    from ..fem.assembly import general_shift_np

                    m3d = part.to_dist(
                        Pdeg, general_shift_np(mesh, Pdeg, self.sigma,
                                               self._sigma_field)[1]
                    )
                    if self.operator_kind != "kron":
                        m3d = m3d.reshape(-1)
                    lv64["m3"] = jnp.asarray(m3d, dtype=jnp.float64)
                    lv64_spec["m3"] = P(AXIS)
                for name, nc_a in (("x", part.cells_per_shard_x),
                                   ("y", mesh.nc[1]), ("z", mesh.nc[2])):
                    E, Dg = axis_matrices(nc_a, Pdeg)
                    lv64["E" + name] = jnp.asarray(E, jnp.float64)
                    lv64["D" + name] = jnp.asarray(Dg, jnp.float64)
                    lv64_spec["E" + name] = P()
                    lv64_spec["D" + name] = P()
            with self.jmesh:
                for k in lv64:
                    lv64[k] = put_global(
                        lv64[k], NamedSharding(self.jmesh, lv64_spec[k])
                    )
            self._lv64 = lv64
            n_sh = self.n_shards
            ops = self._ops
            work_dtype = self.dtype
            levels = self.levels
            coarse, coarse_cfg = self.coarse, self.coarse_cfg

            def _step(lv64_, data, b64, u64):
                if use_kron64:
                    raw = kron_laplacian_apply(
                        u64, (lv64_["Kx"], lv64_["Ky"], lv64_["Kz"]),
                        (lv64_["mx"], lv64_["my"], lv64_["mz"]),
                        lv64_["bc_marker"], precision="highest",
                        apply_bc=False,
                        exchange=lambda t1: _exchange_partials(t1, n_sh),
                        sigma=self.sigma,
                    )
                    Au = jnp.where(lv64_["bc_marker"], u64, raw)
                else:
                    from ..ops.lattice import lattice_laplacian_apply

                    mats = {k: lv64_[k]
                            for k in ("Ex", "Dx", "Ey", "Dy", "Ez", "Dz")}
                    raw = lattice_laplacian_apply(
                        u64, mats, lv64_["G"], lv64_["bc_marker"],
                        precision="highest", apply_bc=False,
                    )
                    lat = _exchange_partials(raw.reshape(fine.shape), n_sh)
                    y64 = lat.reshape(jnp.shape(u64))
                    if self._ops_sigma:
                        y64 = y64 + self._ops_sigma * lv64_["m3"] * u64
                    Au = jnp.where(lv64_["bc_marker"], u64, y64)
                r64 = b64 - Au
                rn = jnp.sqrt(
                    jax.lax.psum(jnp.sum(r64 * r64 * lv64_["weights"]), AXIS)
                )
                wz = ops.get(
                    "zeros",
                    lambda level, dt: jnp.zeros(level.ndofs, dtype=dt),
                )
                e = v_cycle(
                    data,
                    jnp.asarray(r64, dtype=work_dtype),
                    ops["pvary"](wz(fine, work_dtype)),
                    levels=levels, coarse=coarse, coarse_cfg=coarse_cfg,
                    ops=ops,
                )
                return u64 + jnp.asarray(e, dtype=jnp.float64), rn

            self._refine_step = jax.jit(
                jax.shard_map(
                    _step,
                    mesh=self.jmesh,
                    in_specs=(lv64_spec, self.data_specs, P(AXIS), P(AXIS)),
                    out_specs=(P(AXIS), P()),
                )
            )

        bd = self.part.to_dist(Pdeg, np.asarray(b, dtype=np.float64))
        if self.operator_kind != "kron":
            bd = bd.reshape(-1)
        b64 = put_global(
            np.asarray(bd, dtype=np.float64),
            NamedSharding(self.jmesh, P(AXIS)),
        )
        if u0 is not None:
            u0d = self.part.to_dist(Pdeg, np.asarray(u0))
            if self.operator_kind != "kron":
                u0d = u0d.reshape(-1)
            u64 = put_global(
                np.asarray(u0d, dtype=np.float64),
                NamedSharding(self.jmesh, P(AXIS)),
            )
        elif fmg:
            # Working-dtype sharded FMG guess, promoted to f64 (the f64
            # outer loop recomputes the true residual immediately).
            uw = self._fmg_guess_dist(jnp.asarray(b64, dtype=self.dtype))
            u64 = jnp.asarray(uw, dtype=jnp.float64)
        else:
            u64 = jnp.zeros_like(b64)
        r0 = float(np.linalg.norm(np.asarray(b, dtype=np.float64)))
        rnorms = []
        for _ in range(num_cycles):
            u64, rn = self._refine_step(self._lv64, self.data, b64, u64)
            rn = float(rn)
            if residuals:
                rnorms.append(rn)
            if rtol and rn < rtol * r0:
                break
        return self.from_dist(u64), rnorms

    def _fmg_guess_dist(self, bd):
        """Cached jitted shard_map'd FMG guess on a distributed rhs —
        one small program shared by solve / solve_pcg / solve_refined
        (baking the sweep into each whole-solve scan would re-compile
        the full program per fmg toggle; at 16M dofs a whole-solve
        remote compile is minutes)."""
        if getattr(self, "_fmg_prog", None) is None:
            ops = self._ops

            def _g(data, bd_):
                return fmg_initial_guess(
                    data, bd_, levels=self.levels, coarse=self.coarse,
                    coarse_cfg=self.coarse_cfg, ops=ops,
                )

            self._fmg_prog = jax.jit(
                jax.shard_map(
                    _g, mesh=self.jmesh,
                    in_specs=(self.data_specs, P(AXIS)),
                    out_specs=P(AXIS),
                )
            )
        return self._fmg_prog(self.data, bd)

    def solve(self, b, num_cycles=10, residuals=True, u0=None, fmg=False):
        """Stationary V-cycle iteration on a *global* rhs; returns the
        global solution vector and the residual-norm history.

        ``fmg=True`` (with no explicit ``u0``) starts from the sharded
        full-multigrid guess (`solvers.pmg.fmg_initial_guess` — generic
        over the dist cycle ops, so the nested-iteration sweep rides the
        same exchanges as the V-cycle).

        Runs the whole iteration as one jitted sharded `lax.scan` with
        device-side residual norms — a single host sync at the end."""
        from ..solvers.pmg import (
            warn_high_precision_stationary,
            warn_tensor_stationary,
        )

        warn_high_precision_stationary(self.precision)
        warn_tensor_stationary(self._kappa_fold, self.kappa_axes,
                               self.operator_kind,
                               line=(self._line_axis is not None
                                     or self._schwarz))
        if not hasattr(self, "_solve_scans"):
            self._solve_scans = {}
        if num_cycles not in self._solve_scans:
            ops = self._ops
            fine = self.levels[-1]
            vc = partial(
                v_cycle, levels=self.levels, coarse=self.coarse,
                coarse_cfg=self.coarse_cfg, ops=ops,
            )

            def _run(data, bd, ud, _n=num_cycles):
                def body(uc, _):
                    uc = vc(data, bd, uc)
                    lvf = data["levels"][-1]
                    r = bd - ops["apply"](lvf, uc, fine)
                    return uc, jnp.sqrt(ops["dot"](r, r, lvf))

                return jax.lax.scan(body, ud, None, length=_n)

            self._solve_scans[num_cycles] = jax.jit(
                jax.shard_map(
                    _run,
                    mesh=self.jmesh,
                    in_specs=(self.data_specs, P(AXIS), P(AXIS)),
                    out_specs=(P(AXIS), P()),
                )
            )
        bd = self.to_dist(b)
        # ``u0`` resumes from a checkpointed iterate (utils.checkpoint).
        if u0 is not None:
            ud = self.to_dist(u0)
        elif fmg:
            ud = self._fmg_guess_dist(bd)
        else:
            ud = jnp.zeros_like(bd)
        ud, rnorms = self._solve_scans[num_cycles](self.data, bd, ud)
        out = self.from_dist(ud)
        if not residuals:
            return out, []
        return out, [float(r) for r in np.asarray(rnorms)]
