"""2D/3D device-mesh domain decomposition (kron + lattice backends).

The 1D slab partition (`parallel/dist.py`) caps the shard count at the
number of x-cells; production pods want 2D/3D meshes. The Kronecker-sum
operator makes the multi-axis extension clean:

- the lattice is split into ``(sx, sy, sz)`` boxes (any factor may be 1),
  duplicating interface planes along every sharded axis (corner/edge
  lines are duplicated multiplicatively; ownership weights are the
  product of the per-axis masks, so reductions stay exact);
- the three operator terms are axis-separable: the K_a term is
  shard-partial only across a-interfaces — so ONE ppermute pair per
  sharded axis, applied to its own term, reconciles everything. NO
  corner/diagonal communication exists at all (an MPI halo exchange on a
  3D decomposition needs 26-neighbour messages);
- transfers: input weighted by the product ownership mask, local per-axis
  transposed matmuls, then one exchange per sharded axis (linear and
  axiswise-independent — edges/corners receive all and end complete).

Every operator backend rides the same per-axis exchange machinery:
'kron' (axis-aligned, the production path), 'lattice' (general
non-affine hexes and variable DG-0 coefficients), and the fully general
'dofmap' oracle (box-blocked per-cell arrays + local box dofmaps) — the
complete backend x decomposition matrix.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fem.mesh import BoxMesh
from ..fem.assembly import ops_shift_scalar, resolve_kappa_split, scale_G
from ..ops.blas import dist_inner_product
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
from .partition import duplicate_planes

AXES = ("x", "y", "z")


def _norm_shards(shards):
    s = tuple(int(v) for v in shards)
    return s + (1,) * (3 - len(s))


class GridPartition:
    """Static multi-axis box partition with duplicated interface planes."""

    def __init__(self, mesh: BoxMesh, shards=(2, 2)):
        self.mesh = mesh
        self.shards = _norm_shards(shards)
        for a, (nc_a, s_a) in enumerate(zip(mesh.nc, self.shards)):
            if nc_a % s_a:
                raise ValueError(f"nc[{a}]={nc_a} must divide shards {self.shards}")
        self.cells_per_shard = tuple(
            nc_a // s_a for nc_a, s_a in zip(mesh.nc, self.shards)
        )

    def local_shape(self, Pdeg):
        return tuple(c * Pdeg + 1 for c in self.cells_per_shard)

    def local_ndofs(self, Pdeg):
        a, b, c = self.local_shape(Pdeg)
        return a * b * c

    def _axis_starts(self, Pdeg, a):
        npl = self.cells_per_shard[a] * Pdeg + 1
        return [s * (npl - 1) for s in range(self.shards[a])], npl

    def to_dist(self, Pdeg, u):
        """Global flat vector -> duplicated layout
        ``(sx*nplx, sy*nply, sz*nplz)`` (shardable with P('x','y','z'))."""
        lat = np.asarray(u).reshape(self.mesh.lattice_shape(Pdeg))
        for a in range(3):
            starts, npl = self._axis_starts(Pdeg, a)
            lat = np.concatenate(
                [np.take(lat, range(x0, x0 + npl), axis=a) for x0 in starts],
                axis=a,
            )
        return lat

    def from_dist(self, Pdeg, ud):
        NX, NY, NZ = self.mesh.lattice_shape(Pdeg)
        sx, sy, sz = self.shards
        nplx, nply, nplz = self.local_shape(Pdeg)
        ud = np.asarray(ud).reshape(sx, nplx, sy, nply, sz, nplz)
        out = np.zeros((NX, NY, NZ), dtype=ud.dtype)
        xs, _ = self._axis_starts(Pdeg, 0)
        ys, _ = self._axis_starts(Pdeg, 1)
        zs, _ = self._axis_starts(Pdeg, 2)
        for i, x0 in enumerate(xs):
            for j, y0 in enumerate(ys):
                for k, z0 in enumerate(zs):
                    out[x0:x0 + nplx, y0:y0 + nply, z0:z0 + nplz] = ud[i, :, j, :, k]
        return out.reshape(-1)

    def ownership_weights(self, Pdeg):
        """Product of per-axis ownership masks (counts every dof once)."""
        ws = []
        for a in range(3):
            npl = self.cells_per_shard[a] * Pdeg + 1
            w = np.ones((self.shards[a], npl))
            w[:-1, -1] = 0.0
            ws.append(w.reshape(-1))
        return np.einsum("a,b,c->abc", *ws)


def _exchange_axis(lat, n_shards, axis_name, dim):
    """Partial-sum reconciliation of duplicated planes along lattice dim
    ``dim`` sharded over mesh axis ``axis_name``."""
    if n_shards == 1:
        return lat
    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]
    first = jax.lax.index_in_dim(lat, 0, axis=dim, keepdims=False)
    last = jax.lax.index_in_dim(lat, lat.shape[dim] - 1, axis=dim, keepdims=False)
    from_left = jax.lax.ppermute(last, axis_name, fwd)
    from_right = jax.lax.ppermute(first, axis_name, bwd)
    idx_first = (slice(None),) * dim + (0,)
    idx_last = (slice(None),) * dim + (lat.shape[dim] - 1,)
    return lat.at[idx_first].add(from_left).at[idx_last].add(from_right)


def grid_dofmap_cycle_ops(shards, sigma=0.0):
    """Grid V-cycle primitives over the fully general dofmap oracle
    (gather -> per-cell sum-factorized apply -> scatter-add,
    `ops.laplacian`). Per-cell arrays are box-blocked host-side
    (``(ncx, ncy, ncz, ...)`` sharded over the device grid) and the
    scatter targets each shard's LOCAL box dofmap; cell contributions
    land entirely inside the local duplicated-plane lattice, so the same
    sequential per-axis exchanges reconcile the interface partials.
    Completes the backend x decomposition matrix — previously the oracle
    ran only single-device and on the 1D slab."""
    from ..ops.laplacian import laplacian_scatter_raw

    shards = _norm_shards(shards)

    def apply_op(lv, x, level):
        raw = laplacian_scatter_raw(
            x.reshape(-1), lv["dofmap"],
            lv["G"].reshape(-1, *lv["G"].shape[3:]),
            lv["coeff"].reshape(-1), lv["D"],
            lv["bc_marker"].reshape(-1),
        )
        y = raw.reshape(level.shape)
        for a in range(3):
            y = _exchange_axis(y, shards[a], AXES[a], a)
        if sigma:
            y = y + sigma * lv["m3"] * x
        return jnp.where(lv["bc_marker"], x, y)

    return dict(_grid_common_ops(shards, "highest"), apply=apply_op)


def grid_coarse_hooks(part, P0):
    """Gather/slice hooks for global coarse solvers on the box partition.

    ``coarse_gather``: local flat coarse vector -> the full global coarse
    vector (replicated on every shard), via one all_gather per sharded
    axis with the duplicated interface planes stripped. ``coarse_slice``:
    the inverse, one dynamic_slice per sharded axis. The multi-axis
    generalization of the 1D slab pattern in `parallel.dist`.
    """
    shards = part.shards
    npls = part.local_shape(P0)
    glob = part.mesh.lattice_shape(P0)

    def coarse_gather(b0_local):
        lat = b0_local.reshape(npls)
        for a in range(3):
            if shards[a] == 1:
                continue
            allg = jax.lax.all_gather(lat, AXES[a])  # (s, *lat.shape)
            parts = [
                jax.lax.index_in_dim(allg, s, axis=0, keepdims=False)
                for s in range(shards[a])
            ]
            parts = [
                jax.lax.slice_in_dim(p, 0, p.shape[a] - 1, axis=a)
                for p in parts[:-1]
            ] + [parts[-1]]
            lat = jnp.concatenate(parts, axis=a)
        return lat if b0_local.ndim == 3 else lat.reshape(-1)

    def coarse_slice(ug):
        lat = ug.reshape(glob)
        for a in range(3):
            if shards[a] == 1:
                continue
            idx = jax.lax.axis_index(AXES[a])
            lat = jax.lax.dynamic_slice_in_dim(
                lat, idx * (npls[a] - 1), npls[a], axis=a
            )
        return lat if ug.ndim == 3 else lat.reshape(-1)

    return coarse_gather, coarse_slice


def _grid_common_ops(shards, precision):
    """The backend-independent V-cycle primitives on the box partition:
    transfers (ownership-weighted restriction with one exchange per
    sharded axis; comm-free prolongation), ownership-weighted psum dots,
    and vma bookkeeping. Operator backends add their own ``apply``."""
    from ..ops.lattice import lattice_prolongate, lattice_restrict

    def restrict_op(tr, r, level_c, level_f):
        lat = lattice_restrict(
            r * tr["weights_f"], (tr["Ix"], tr["Iy"], tr["Iz"]),
            level_f.shape, precision,
        )
        for a in range(3):
            lat = _exchange_axis(lat, shards[a], AXES[a], a)
        return lat

    def prolong_op(tr, u, level_c, level_f):
        return lattice_prolongate(
            u, (tr["Ix"], tr["Iy"], tr["Iz"]), level_c.shape, precision
        )

    def dot(u, v, lv):
        # psum over ALL mesh axes (size-1 axes are free) so results are
        # replicated w.r.t. every axis — keeps vma tracking consistent.
        return dist_inner_product(u, v, lv["weights"], AXES)

    def exchange(lat):
        # Interface partial-sum reconciliation over every sharded axis
        # (the generic hook smoothers use, e.g. the Schwarz cell fold).
        for a in range(3):
            lat = _exchange_axis(lat, shards[a], AXES[a], a)
        return lat

    return dict(
        restrict=restrict_op, prolong=prolong_op, dot=dot,
        pvary=lambda v: pcast_varying(v, AXES),
        zeros=lambda level, dtype: jnp.zeros(level.shape, dtype=dtype),
        exchange=exchange,
    )


def grid_kron_cycle_ops(shards, precision="highest", sigma=0.0):
    """V-cycle primitives on the multi-axis box partition (kron backend).

    LATTICE-SHAPED local vectors end-to-end (see
    `solvers.pmg.kron_cycle_ops`). Uses the same symmetrized scaling as the
    single-device kron apply: ``A = S (Kt_x ⊕ Kt_y ⊕ Kt_z) S`` — each
    ``Kt_a`` term is shard-partial only across a-interfaces, so one
    exchange per sharded axis reconciles everything, exactly as for the
    mass-weighted form (the s3 scaling is pointwise and consistent on
    duplicated planes)."""
    shards = _norm_shards(shards)

    def apply_op(lv, x, level):
        mx, my, mz = lv["mx"], lv["my"], lv["mz"]
        sx, sy, sz = jnp.sqrt(mx), jnp.sqrt(my), jnp.sqrt(mz)
        Ktx = lv["Kx"] / sx[:, None] / sx[None, :]
        Kty = lv["Ky"] / sy[:, None] / sy[None, :]
        Ktz = lv["Kz"] / sz[:, None] / sz[None, :]
        s3 = sx[:, None, None] * sy[None, :, None] * sz[None, None, :]
        w = jnp.where(lv["bc_marker"], jnp.zeros_like(x), x) * s3
        t1 = _exchange_axis(
            jnp.einsum("ax,xyz->ayz", Ktx, w, precision=precision),
            shards[0], AXES[0], 0,
        )
        t2 = _exchange_axis(
            jnp.einsum("by,xyz->xbz", Kty, w, precision=precision),
            shards[1], AXES[1], 1,
        )
        t3 = _exchange_axis(
            jnp.einsum("cz,xyz->xyc", Ktz, w, precision=precision),
            shards[2], AXES[2], 2,
        )
        t = t1 + t2 + t3
        if sigma:
            # Lumped-mass shift (see ops.kron.kron_laplacian_apply):
            # sigma*w*s3 == sigma*M*mask(x), consistent on duplicated
            # planes (pointwise), so no extra exchange is needed.
            t = t + sigma * w
        y = t * s3
        return jnp.where(lv["bc_marker"], x, y)

    return dict(_grid_common_ops(shards, precision), apply=apply_op)


def grid_lattice_cycle_ops(shards, precision="highest", sigma=0.0):
    """V-cycle primitives on the multi-axis box partition — lattice
    backend: general (non-affine) hexes and variable DG-0 coefficients on
    2D/3D device grids.

    The lattice apply's cell-local contractions produce partial sums only
    on the duplicated interface planes, and — even though a general G
    couples the axes at each quadrature point — every cell's contribution
    lands on exactly one shard per axis, so sequential per-axis exchanges
    reconcile edges/corners completely (after the x-exchange both x-copies
    agree; the y-exchange then adds y-neighbors that are already x-summed,
    etc. — same argument as the transfers). The multi-axis generalization
    of `parallel.dist.dist_lattice_cycle_ops`; reference analogue: the
    MatFreeLaplacian running under any MPI rank layout
    (src/laplacian.hpp:378-455)."""
    from ..ops.lattice import lattice_laplacian_apply

    shards = _norm_shards(shards)

    def apply_op(lv, x, level):
        mats = {k: lv[k] for k in ("Ex", "Dx", "Ey", "Dy", "Ez", "Dz")}
        y = lattice_laplacian_apply(
            x, mats, lv["G"], lv["bc_marker"], precision=precision,
            apply_bc=False,
        )
        for a in range(3):
            y = _exchange_axis(y, shards[a], AXES[a], a)
        if sigma:
            # Lumped-mass shift (duplicated-layout global mass m3,
            # bc-zeroed): pointwise-consistent, added after the exchanges.
            y = y + sigma * lv["m3"] * x
        return jnp.where(lv["bc_marker"], x, y)

    return dict(_grid_common_ops(shards, precision), apply=apply_op)


def _hmg_grid_scaffold(mesh, shards, P0, dtype, smoother_iters,
                       min_cells, divisors, global_build, make_mesh,
                       fill_level, sizes=None, line_axis=None,
                       bottom_fdm=None):
    """Shared frame of `build_hmg_grid` / `build_hmg_grid_general`:
    divisors validation, shard-aligned level sizing, the global
    calibration pass, per-level base data (bc/diag/weights/lmax), the
    per-axis h-transfer loop, and the bottom-solve hook wiring. The
    backend-specific operator arrays come from ``fill_level(lv, spec, m,
    p_l, g_lv)``; the global hierarchy from ``global_build(sizes) ->
    (g_data, g_bottom)``. ``bottom_fdm`` (kron builder, bottom='fdm'):
    kwargs dict for a distributed-FDM bottom at the coarsest h-level —
    the hierarchy then never gathers (parallel/fdm_dist.py)."""
    from ..solvers.hmg import (coarsenable_levels,
                               local_axis_h_interpolation)

    shards = _norm_shards(shards)
    # The h-hierarchy DEPTH depends on the alignment constraint, so two
    # shard layouts can get different hierarchies (and slightly
    # different trajectories). ``divisors`` (coarse_cfg['divisors'])
    # pins one constraint across layouts — e.g. the largest layout of a
    # scaling sweep — so trajectories stay layout-invariant.
    div = _norm_shards(divisors) if divisors is not None else shards
    for a, (d, s) in enumerate(zip(div, shards)):
        if d % s:
            raise ValueError(
                f"divisors[{a}]={d} must be a multiple of shards[{a}]={s} "
                "(levels divisible by the override stay shard-aligned)"
            )
    if sizes is not None:
        # User hierarchy (e.g. hmg.semicoarsen_sizes via
        # coarse_cfg['sizes']): nesting-validated, and EVERY level must
        # stay shard-aligned so the duplicated-plane layout exists.
        from ..solvers.hmg import validate_hmg_sizes

        sizes = validate_hmg_sizes(mesh.nc, sizes)
        for lvl in sizes:
            if any(c % d for c, d in zip(lvl, div)):
                raise ValueError(
                    f"coarse_cfg['sizes'] level {lvl} is not divisible "
                    f"by the shard grid (divisors={div}); every h-level "
                    "must split into the same per-shard slabs for the "
                    "distributed (dist=True) hierarchy"
                )
    else:
        sizes = coarsenable_levels(mesh.nc, min_cells=min_cells,
                                   divisors=div)
    if len(sizes) < 2:
        raise ValueError(
            f"mesh nc={mesh.nc} is not h-coarsenable with cells "
            f"divisible by shards={shards} (divisors={div}); use the "
            "gathered hmg coarse (coarse_cfg without dist=True) or a "
            "shard-friendlier mesh"
        )
    if line_axis is not None and shards[line_axis] != 1:
        raise ValueError(
            f"distributed (dist=True) h-MG line smoother along "
            f"{'xyz'[line_axis]} needs shards[{line_axis}]==1 (lines "
            f"must not span shards); got shards={shards}"
        )
    g_data, g_bottom = global_build(sizes)
    sizes_cf = sizes[::-1]  # coarse -> fine, matching g_data["levels"]
    meshes = [make_mesh(nc) for nc in sizes_cf]
    parts = [GridPartition(m, shards) for m in meshes]
    PSHARD = P(*AXES)

    levels, level_data, level_specs = [], [], []
    for m, p_l, g_lv in zip(meshes, parts, g_data["levels"]):
        lv = dict(
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
        spec = dict(bc_marker=PSHARD, diag_inv=PSHARD, weights=PSHARD,
                    lmax=P())
        if line_axis is not None:
            from ..solvers.line import shard_line_blocks

            # Per-axis duplicated-plane layout on both lead (non-line)
            # axes, matching GridPartition.to_dist.
            others = [a for a in range(3) if a != line_axis]
            lv["line_inv"] = jnp.asarray(
                shard_line_blocks(g_lv["line_inv"], m.lattice_shape(P0),
                                  line_axis,
                                  [p_l._axis_starts(P0, a)
                                   for a in others]),
                dtype=dtype)
            spec["line_inv"] = P(AXES[others[0]], AXES[others[1]])
        if "schwarz" in g_lv:
            # Global build already computed this level's Schwarz data
            # (and the schwarz-preconditioned lmax); V_a/ginv slice
            # cell-contiguously per axis, lattice-shaped w/bc ride the
            # per-axis duplicated-plane layout.
            from ..solvers.schwarz import shard_dense_axis

            g_sw = g_lv["schwarz"]
            lv["schwarz"] = dict(
                ginv=g_sw["ginv"],
                bc=jnp.asarray(p_l.to_dist(
                    P0, np.asarray(g_sw["bc"], np.float64)) > 0.5),
                **{
                    k: jnp.asarray(
                        shard_dense_axis(g_sw[k], P0,
                                         *p_l._axis_starts(P0, a)),
                        dtype=dtype)
                    for a, k in enumerate(("Ux", "Uy", "Uz"))
                },
            )
            spec["schwarz"] = dict(
                Ux=P(AXES[0]), Uy=P(AXES[1]), Uz=P(AXES[2]),
                ginv=PSHARD, bc=PSHARD,
            )
        fill_level(lv, spec, m, p_l, g_lv)
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
        tr, tspec = {}, {}
        for a, name in enumerate("xyz"):
            # Sharded GRADED axes get per-shard ROW-STACKED transfer
            # blocks (spec P(axis)) — the local_axis_K mechanism.
            I_a, stacked = local_axis_h_interpolation(
                pc.cells_per_shard[a], P0, mf.nc[a] // mc.nc[a],
                shards[a],
                h_fine=mf.h_cells[a] if mf.is_graded else None)
            tr["I" + name] = jnp.asarray(I_a, dtype=dtype)
            tspec["I" + name] = P(AXES[a]) if stacked else P()
        tr["weights_f"] = jnp.asarray(pf.ownership_weights(P0),
                                      dtype=dtype)
        tspec["weights_f"] = PSHARD
        transfer.append(tr)
        transfer_specs.append(tspec)

    data = dict(levels=tuple(level_data), transfer=tuple(transfer))
    specs = dict(levels=tuple(level_specs), transfer=tuple(transfer_specs))
    if "coarse_chol" in g_data:
        data["coarse_chol"] = g_data["coarse_chol"]
        specs["coarse_chol"] = P()
    bottom_solve = None
    if bottom_fdm is not None:
        # Distributed-FDM bottom: exact direct solve at the coarsest
        # h-level via per-axis pencil transposes — no gather anywhere
        # in the hierarchy.
        from .fdm_dist import make_fdm_dist

        fd_data, fd_spec, bottom_solve = make_fdm_dist(
            meshes[0], P0, parts[0],
            tuple(
                (AXES[a], shards[a]) if shards[a] > 1 else None
                for a in range(3)
            ),
            PSHARD, dtype=dtype, **bottom_fdm,
        )
        data["fdm"], specs["fdm"] = fd_data, fd_spec
        g_bottom = "fdm"

    hmg_gather, hmg_slice = grid_coarse_hooks(parts[0], P0)
    return (tuple(levels), data, specs, g_bottom, hmg_gather, hmg_slice,
            bottom_solve)


def build_hmg_grid(mesh, shards, P0, kappa, dtype, smoother_iters=2,
                   precision="highest", bottom="direct", min_cells=2,
                   sigma=0.0, divisors=None, sizes=None, smoother="cheb"):
    """Distributed (non-gathered) h-MG coarse hierarchy on the 2D/3D box
    partition — the multi-axis generalization of
    `parallel.dist.build_hmg_dist`.

    Coarsening is shard-aligned on EVERY sharded axis (each h-level's
    cell counts stay divisible by ``shards``,
    `coarsenable_levels(divisors=shards)`), so every h-level keeps the
    per-axis duplicated-plane layout: level applies ride
    `grid_kron_cycle_ops` (one ppermute pair per sharded axis),
    inter-level transfers are the LOCAL blocks of the global per-axis
    h-interpolation (ownership-weighted fine input, per-axis exchange of
    the coarse partials — the `_grid_common_ops` machinery verbatim),
    and only the bottom solve gathers, at the much smaller coarsest
    level (`grid_coarse_hooks`). Smoother calibration (per-level lmax),
    diagonals and the bottom factor come from one global `build_hmg`
    pass over the SAME level sizes — the distributed operator is
    numerically identical, so the Lanczos estimates transfer. Replaces
    the reference's distributed BoomerAMG coarse (src/amg.hpp:11-119)
    under multi-axis rank layouts where redundant-global solving stops
    scaling.

    Returns ``(levels, data, specs, bottom_mode, gather, unslice,
    bottom_solve)`` — see `parallel.dist.build_hmg_dist`.
    """
    from ..fem.assembly import resolve_kappa_axes
    from ..ops.kron import axis_stiffness_mass
    from ..solvers.hmg import build_hmg

    from ..solvers.line import parse_line_smoother

    kax = resolve_kappa_axes(mesh, kappa)  # scalar / per-axis / diag tensor
    line_axis = (None if smoother == "schwarz" else parse_line_smoother(
        smoother, mesh, np.diag(kax),
        allowed=tuple(a for a, sh in enumerate(_norm_shards(shards))
                      if sh == 1)))

    def global_build(sizes):
        _, g_data, g_bottom = build_hmg(
            mesh, P0, kappa, dtype, smoother_iters=smoother_iters,
            precision=precision,
            # 'fdm' bottoms are dist-only (scaffold attaches them); the
            # global calibration pass never runs a bottom solve.
            bottom=("smoother" if bottom == "fdm" else bottom),
            min_cells=min_cells,
            sigma=sigma, sizes=sizes, smoother=smoother,
        )
        return g_data, g_bottom

    def fill_level(lv, spec, m, p_l, g_lv):
        from ..ops.kron import local_axis_K

        npls = p_l.local_shape(P0)
        for a, name in enumerate("xyz"):
            # Local per-shard stiffness (interface partials reconciled by
            # the exchange); global axis mass in the duplicated layout.
            # Robin ends rediscretize per h-level (row-stacked per shard
            # on a sharded axis — only the global-end shards differ).
            Kl, stacked = local_axis_K(m, a, p_l.cells_per_shard[a], P0,
                                       kax[a], p_l.shards[a])
            _, mg = axis_stiffness_mass(m.nc[a], P0, m.h_cells[a])
            lv["K" + name] = jnp.asarray(Kl, dtype=dtype)
            lv["m" + name] = jnp.asarray(
                duplicate_planes(mg, npls[a], p_l.shards[a]), dtype=dtype
            )
            spec["K" + name] = P(AXES[a]) if stacked else P()
            spec["m" + name] = P(AXES[a])

    # Robin alphas are resolution-independent boundary data: coarsened
    # levels carry the same face flags (rediscretized end updates per
    # h-level, matching the gathered build_hmg).
    robin = (mesh.robin_alpha if getattr(mesh, "has_robin", False)
             else None)
    from ..solvers.hmg import coarsen_spacing

    return _hmg_grid_scaffold(
        mesh, shards, P0, dtype, smoother_iters, min_cells, divisors,
        global_build,
        lambda nc: BoxMesh(nc, extent=mesh.extent,
                           dirichlet_faces=mesh.dirichlet_faces,
                           robin=robin,
                           spacing=(coarsen_spacing(mesh.h_cells,
                                                    mesh.nc, nc)
                                    if mesh.is_graded else None)),
        fill_level, sizes=sizes, line_axis=line_axis,
        bottom_fdm=(dict(kappa=kappa, precision=precision, sigma=sigma)
                    if bottom == "fdm" else None),
    )


def build_hmg_grid_general(mesh, shards, P0, kappa, dtype,
                           smoother_iters=2, precision="highest",
                           bottom="direct", min_cells=2, sigma=0.0,
                           divisors=None, sizes=None, smoother="cheb",
                           sigma_field=None):
    """Distributed h-MG coarse for the GENERAL family (curved hexes /
    DG-0 kappa) on the 2D/3D box partition — the lattice-backend twin
    of `build_hmg_grid`, rediscretizing the curved operator per h-level
    like `solvers.hmg.build_hmg_general`.

    Every h-level keeps the multi-axis duplicated-plane layout: the
    level's quadrature-lattice geometry (recomputed on its own
    coarsened mesh, kappa volume-averaged) partitions exactly along the
    device grid (cell-local quadrature points), applies ride
    `grid_lattice_cycle_ops`, transfers are the local per-axis
    reference-space h-interpolation blocks, and only the coarsest
    bottom solve gathers. Calibration (per-level lmax), diagonals and
    the bottom factor come from one global `build_hmg_general` pass
    over the SAME level sizes. Completes the reference's distributed
    BoomerAMG replacement (src/amg.hpp:11-119) for the meshes where the
    constant-kappa kron hierarchy refuses.

    Returns ``(levels, data, specs, bottom_mode, gather, unslice,
    bottom_solve)`` — see `parallel.dist.build_hmg_dist`.
    """
    from ..fem.assembly import lumped_mass_np
    from ..fem.mesh import PerturbedBoxMesh
    from ..ops.lattice import axis_matrices
    from ..solvers.hmg import build_hmg_general

    from ..solvers.line import parse_line_smoother

    line_axis = (None if smoother == "schwarz" else parse_line_smoother(
        smoother, mesh, kappa,
        allowed=tuple(a for a, sh in enumerate(_norm_shards(shards))
                      if sh == 1)))

    def global_build(sizes):
        _, g_data, g_bottom, _core = build_hmg_general(
            mesh, P0, kappa, dtype, smoother_iters=smoother_iters,
            precision=precision, bottom=bottom, min_cells=min_cells,
            sigma=sigma, sigma_field=sigma_field, sizes=sizes,
            smoother=smoother,
        )
        return g_data, g_bottom

    robin = (mesh.robin_alpha if getattr(mesh, "has_robin", False)
             else None)
    from ..solvers.hmg import coarsen_spacing

    def _spc(nc):
        return (coarsen_spacing(mesh.h_cells, mesh.nc, nc)
                if mesh.is_graded else None)

    if isinstance(mesh, PerturbedBoxMesh):
        make_mesh = lambda nc: PerturbedBoxMesh(
            nc, extent=mesh.extent, warp=mesh._warp,
            dirichlet_faces=mesh.dirichlet_faces, robin=robin,
            spacing=_spc(nc))
    else:
        make_mesh = lambda nc: BoxMesh(
            nc, extent=mesh.extent,
            dirichlet_faces=mesh.dirichlet_faces, robin=robin,
            spacing=_spc(nc))
    PSHARD = P(*AXES)

    def fill_level(lv, spec, m, p_l, g_lv):
        # The global q-lattice geometry (kappa folded in) and the
        # per-level lumped mass are exactly what build_hmg_general
        # already computed — reuse instead of recomputing the host-side
        # geometry pipeline (it dominates setup at the finest h-level,
        # the FULL p=1 mesh); the PSHARD spec partitions the global
        # array at placement. With Robin faces the boundary mass is
        # baked into the global pass's m3 (ops scalar 1.0 —
        # `general_shift_np`), re-evaluated on THIS level's faces.
        lv["G"] = g_lv["G"]
        spec["G"] = PSHARD
        if sigma or robin is not None:
            m3_np = (np.asarray(g_lv["m3"]) if "m3" in g_lv
                     else lumped_mass_np(m, P0, bc_zero=True))
            lv["m3"] = jnp.asarray(p_l.to_dist(P0, m3_np), dtype=dtype)
            spec["m3"] = PSHARD
        for a, name in enumerate("xyz"):
            E, Dg = axis_matrices(p_l.cells_per_shard[a], P0)
            lv["E" + name] = jnp.asarray(E, dtype=dtype)
            lv["D" + name] = jnp.asarray(Dg, dtype=dtype)
            spec["E" + name] = P()
            spec["D" + name] = P()

    return _hmg_grid_scaffold(
        mesh, shards, P0, dtype, smoother_iters, min_cells, divisors,
        global_build, make_mesh, fill_level, sizes=sizes,
        line_axis=line_axis,
    )


class GridPMG:
    """p-multigrid over a 2D/3D device mesh.

    The multi-axis generalization of `DistPMG`: per-axis duplicated-plane
    invariants, axis-separable exchanges, everything inside one shard_map.
    Operator backends: 'kron' (axis-aligned boxes, constant kappa — the
    production path) and 'lattice' (general hexes + variable DG-0 kappa).
    Coarse solvers: 'cg' (default), 'smoother', or the global gathered
    modes 'fdm' / 'direct' / 'hmg' (gather -> redundant solve -> slice;
    fdm/hmg are constant-coefficient box-only, 'direct' is general).
    ``coarse='hmg', coarse_cfg=dict(dist=True)`` keeps every h-level in
    the multi-axis duplicated-plane layout instead (`build_hmg_grid`) —
    only the coarsest bottom solve gathers.
    """

    def __init__(self, mesh, shards=(2, 2), degrees=(1, 3), kappa=2.0,
                 dtype=jnp.float64, smoother_iters=DEFAULT_SMOOTHER_ITERS,
                 coarse="cg", coarse_cfg=None, devices=None,
                 calibration_iters=DEFAULT_CALIBRATION_ITERS,
                 operator="kron", precision="highest", sigma=0.0,
                 smoother="cheb"):
        from ..ops.lattice import axis_interpolation_matrix

        self.part = GridPartition(mesh, shards)
        shards = self.part.shards
        n_dev = shards[0] * shards[1] * shards[2]
        devices = devices if devices is not None else jax.devices()[:n_dev]
        self.jmesh = Mesh(np.array(devices).reshape(shards), AXES)
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
            if coarse == "fdm":
                raise ValueError(
                    "a sigma FIELD supports cg/smoother/direct/hmg "
                    "coarse solvers only"
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
        # p-level LINE-relaxation smoother (solvers/line.py): the line
        # axis must be UNSHARDED (lines stay within one shard); the
        # block inverses are built globally and laid out with the same
        # per-axis duplicated planes as the vectors, so duplicated lines
        # hold identical blocks ("duplicates equal" preserved).
        from ..solvers.line import parse_line_smoother

        # 'schwarz' = cell-wise FDM Schwarz (solvers/schwarz.py): the
        # blocks are cell-local, so only the overlap-add touches shard
        # interfaces — reconciled by one partial-sum ppermute pair per
        # sharded axis (ops['exchange'] inside the smoother). Any axis
        # layout works — cells never span shards.
        self._schwarz = smoother == "schwarz"
        self._line_axis = (None if self._schwarz else parse_line_smoother(
            smoother, mesh, kappa,
            allowed=tuple(a for a in range(3) if shards[a] == 1)))
        if self._line_axis is not None and shards[self._line_axis] != 1:
            raise ValueError(
                f"GridPMG smoother='line' along {'xyz'[self._line_axis]} "
                f"needs shards[{self._line_axis}]==1 (lines must not span "
                f"shards); got shards={shards} — pick an explicit "
                "'line-x|y|z' along an unsharded axis or re-layout"
            )
        if operator not in ("kron", "lattice", "dofmap"):
            raise ValueError(
                f"GridPMG: unknown operator backend {operator!r} "
                "(choose 'kron', 'lattice' or 'dofmap')"
            )
        if operator == "kron":
            require_axis_aligned(mesh, f"GridPMG operator='{operator}'")
        self._kappa_raw = kappa
        self._kc, self._kappa_fold, _kconst = resolve_kappa_split(
            mesh, kappa)
        # See PMGHierarchy: tensor kappa folds into G via _kappa_fold;
        # _kc is the per-cell scalar (ones for tensors), applied to big
        # geometry arrays only through scale_G.
        self.kappa_cells = (self._kappa_fold if self._kappa_fold is not None
                            else self._kc)
        self.kappa = float(self._kc[0]) if _kconst else None
        # Per-axis coefficient — see DistPMG / fem.assembly.resolve_kappa_axes.
        from ..fem.assembly import resolve_kappa_axes

        try:
            self.kappa_axes = resolve_kappa_axes(
                mesh, kappa,
                split=(self._kc, self._kappa_fold, _kconst))
        except ValueError:
            if operator == "kron":
                raise
            self.kappa_axes = None
        if coarse == "fdm":
            require_axis_aligned(mesh, "GridPMG coarse='fdm'")
            if self.kappa_axes is None:
                raise ValueError(
                    "GridPMG: coarse='fdm' is constant-coefficient "
                    "(scalar, per-axis or diagonal-tensor) only; use "
                    "'hmg', 'cg', 'smoother' or 'direct'"
                )
        self.dtype = dtype
        self.precision = precision
        self.coarse = coarse
        self.coarse_cfg = dict(coarse_cfg or {})
        self.operator_kind = operator
        self.eigs = []
        part = self.part
        # Robin on the general backends rides the baked pointwise shift
        # (boundary mass folded into m3); shared scalar policy:
        # fem.assembly.ops_shift_scalar.
        self._ops_sigma = ops_shift_scalar(
            mesh, self.sigma, operator == "kron")
        if operator == "lattice":
            ops = grid_lattice_cycle_ops(shards, precision,
                                         sigma=self._ops_sigma)
        elif operator == "dofmap":
            ops = grid_dofmap_cycle_ops(shards, sigma=self._ops_sigma)
        else:
            ops = grid_kron_cycle_ops(shards, precision, sigma=self.sigma)

        if coarse not in ("cg", "smoother", "fdm", "direct", "hmg"):
            raise ValueError(
                f"GridPMG: unsupported coarse solver '{coarse}' "
                "(choose from cg, smoother, fdm, direct, hmg)"
            )
        self._coarse_data = None
        self._coarse_spec = None
        if coarse in ("fdm", "direct", "hmg"):
            P0 = self.degrees[0]
            coarse_gather, coarse_slice = grid_coarse_hooks(part, P0)
            ops = dict(ops, coarse_gather=coarse_gather,
                       coarse_slice=coarse_slice)
            if coarse == "fdm" and self.coarse_cfg.get("dist"):
                # Non-gathered form: pencil all_to_all transposes per
                # sharded axis (parallel/fdm_dist.py) — the hooks above
                # go unused on this branch.
                from .fdm_dist import make_fdm_dist

                fd_data, fd_spec, fd_solve = make_fdm_dist(
                    mesh, P0, part,
                    tuple(
                        (AXES[a], shards[a]) if shards[a] > 1 else None
                        for a in range(3)
                    ),
                    P(*AXES), self.kappa_axes, dtype,
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
                # multi-axis duplicated-plane layout; only the coarsest
                # bottom solve gathers. Constant-kappa boxes ride the
                # kron h-hierarchy (`build_hmg_grid`); the general
                # family (curved hexes / DG-0 kappa) the rediscretized
                # lattice one (`build_hmg_grid_general`).
                kw = dict(
                    smoother_iters=smoother_iters, precision=precision,
                    bottom=self.coarse_cfg.get("bottom", "direct"),
                    min_cells=self.coarse_cfg.get("min_cells", 2),
                    sigma=self.sigma,
                    divisors=self.coarse_cfg.get("divisors"),
                    sizes=self.coarse_cfg.get("sizes"),
                    smoother=self.coarse_cfg.get("smoother", "cheb"),
                )
                if (getattr(mesh, "is_axis_aligned", True)
                        and self.kappa_axes is not None
                        and self._sigma_field is None):
                    (hmg_levels, hmg_data, hmg_specs, hmg_bottom,
                     hmg_gather, hmg_slice,
                     hmg_bottom_solve) = build_hmg_grid(
                        mesh, shards, P0, self.kappa_axes, dtype, **kw)
                    hmg_core = grid_kron_cycle_ops(shards, precision,
                                                   sigma=self.sigma)
                else:
                    (hmg_levels, hmg_data, hmg_specs, hmg_bottom,
                     hmg_gather, hmg_slice,
                     hmg_bottom_solve) = build_hmg_grid_general(
                        mesh, shards, P0, self._kappa_raw, dtype,
                        sigma_field=self._sigma_field, **kw)
                    hmg_core = grid_lattice_cycle_ops(
                        shards, precision,
                        sigma=ops_shift_scalar(mesh, self.sigma))
                hmg_ops = dict(
                    hmg_core,
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
            else:  # hmg
                # Gathered redundant h-MG coarse solve: kron h-hierarchy
                # on constant-kappa boxes, rediscretized lattice
                # h-hierarchy for the general family (curved hexes /
                # DG-0 kappa) — the scalable BoomerAMG replacement.
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
                    pvary=lambda v: pcast_varying(v, AXES),
                )
                self.coarse_cfg.update(
                    hmg_levels=hmg_levels, hmg_ops=hmg_ops,
                    hmg_bottom=hmg_bottom,
                    cycles=self.coarse_cfg.get("cycles", 3),
                )
                self._coarse_data = ("hmg", hmg_data)

        self._ops = ops
        PSHARD = P(*AXES)

        level_data, level_specs, levels = [], [], []
        with self.jmesh:
            for Pdeg in self.degrees:
                lv, spec = self._build_level(Pdeg, dtype)
                level = Level(P=Pdeg, ndofs=part.local_ndofs(Pdeg),
                              smoother_iters=smoother_iters,
                              shape=part.local_shape(Pdeg),
                              line_axis=(self._line_axis
                                         if self._line_axis is not None
                                         else 2))
                level_data.append(lv)
                level_specs.append(spec)
                levels.append(level)

            self.levels = tuple(levels)
            for lv, spec, level in zip(level_data, level_specs, levels):
                for k in lv:
                    if isinstance(lv[k], dict):  # nested (e.g. lb_mats)
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

                def _calib(lv_, b_, x0_, _level=level):
                    A = lambda x: ops["apply"](lv_, x, _level)
                    # Same preconditioned operator the smoother iterates
                    # on (shard-local line blocks, exchange-reconciled
                    # Schwarz cell blocks, or point Jacobi).
                    pre = None
                    if "line_inv" in lv_:
                        from ..solvers.line import line_precond_apply

                        pre = lambda r: line_precond_apply(
                            lv_["line_inv"], r, _level.shape,
                            _level.line_axis)
                    elif "schwarz" in lv_:
                        from ..solvers.schwarz import schwarz_precond_apply

                        pre = lambda r: schwarz_precond_apply(
                            lv_["schwarz"], r, _level.shape, _level.P,
                            exchange=ops.get("exchange"))
                    _, info = cg_solve(
                        A, b_, x0_, lv_["diag_inv"],
                        rtol=DEFAULT_CALIBRATION_RTOL,
                        maxiter=calibration_iters, record=True,
                        dot=lambda u, v: ops["dot"](u, v, lv_),
                        precond=pre,
                    )
                    return info  # scalars only (replicated via psum dots)

                calib_fn = jax.jit(
                    jax.shard_map(
                        _calib, mesh=self.jmesh,
                        in_specs=(spec, PSHARD, PSHARD),
                        out_specs=dict(
                            niter=P(), rnorm=P(), rnorm0=P(), alphas=P(),
                            betas=P(), residuals=P(), stored=P(),
                        ),
                    )
                )
                shape3 = tuple(s * n for s, n in zip(shards, level.shape))
                vsh = NamedSharding(self.jmesh, PSHARD)
                info = calib_fn(
                    lv,
                    put_global(np.ones(shape3, dtype=dtype), vsh),
                    put_global(np.zeros(shape3, dtype=dtype), vsh),
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
                tr = dict(
                    Ix=jnp.asarray(
                        axis_interpolation_matrix(part.cells_per_shard[0], Pc, Pf),
                        dtype=dtype,
                    ),
                    Iy=jnp.asarray(
                        axis_interpolation_matrix(part.cells_per_shard[1], Pc, Pf),
                        dtype=dtype,
                    ),
                    Iz=jnp.asarray(
                        axis_interpolation_matrix(part.cells_per_shard[2], Pc, Pf),
                        dtype=dtype,
                    ),
                    weights_f=jnp.asarray(
                        part.ownership_weights(Pf), dtype=dtype
                    ),
                )
                spec = dict(Ix=P(), Iy=P(), Iz=P(), weights_f=PSHARD)
                for k in tr:
                    tr[k] = put_global(tr[k], NamedSharding(self.jmesh, spec[k]))
                transfer.append(tr)
                transfer_specs.append(spec)

        self.data = dict(levels=tuple(level_data), transfer=tuple(transfer))
        self.data_specs = dict(levels=tuple(level_specs),
                               transfer=tuple(transfer_specs))
        if self._coarse_data is not None:
            key, cdata = self._coarse_data
            spec_tree = self._coarse_spec
            if spec_tree is None:  # gathered coarse: fully replicated
                spec_tree = jax.tree.map(lambda _: P(), cdata)
            cdata = jax.tree.map(
                lambda a, s: put_global(a, NamedSharding(self.jmesh, s)),
                cdata, spec_tree,
            )
            self.data[key] = cdata
            self.data_specs[key] = spec_tree

        # Vectors are lattice-shaped (3D local blocks) everywhere: at the
        # shard_map boundary AND inside the cycle — one layout contract.
        def _cycle(data, b3, u3):
            return v_cycle(
                data, b3, u3,
                levels=self.levels, coarse=self.coarse,
                coarse_cfg=self.coarse_cfg, ops=ops,
            )

        self._vcycle = jax.jit(
            jax.shard_map(
                _cycle, mesh=self.jmesh,
                in_specs=(self.data_specs, PSHARD, PSHARD),
                out_specs=PSHARD,
            )
        )

        fine = self.levels[-1]

        def _rn(lv, b3, u3):
            r = b3 - ops["apply"](lv, u3, fine)
            return jnp.sqrt(ops["dot"](r, r, lv))

        self._rnorm = jax.jit(
            jax.shard_map(
                _rn, mesh=self.jmesh,
                in_specs=(self.data_specs["levels"][-1], PSHARD, PSHARD),
                out_specs=P(),
            )
        )

    def _global_diag_np(self, Pdeg):
        """Global operator diagonal (host). The kron backend takes the
        closed Kronecker form from the 1D factors — the same diagonal as
        the single-device kron hierarchy, without a cell loop; the other
        backends sum the cell diagonals (`dist._shifted_diag_np`)."""
        mesh = self.mesh
        if self.operator_kind != "kron":
            from .dist import _shifted_diag_np

            return _shifted_diag_np(mesh, Pdeg, self.kappa_cells,
                                    self.sigma,
                                    sigma_field=self._sigma_field)
        from ..ops.kron import (axis_stiffness_mass, kron_diagonal,
                                robin_axis_ends)

        Ks, ms = [], []
        for a, (nc_a, h_a, k_a) in enumerate(
                zip(mesh.nc, mesh.h_cells, self.kappa_axes)):
            K, m = axis_stiffness_mass(
                nc_a, Pdeg, h_a, robin=robin_axis_ends(mesh, a, 1.0 / k_a))
            Ks.append(k_a * K)
            ms.append(m)
        return np.asarray(kron_diagonal(
            Ks, ms, mesh.boundary_dof_marker(Pdeg), sigma=self.sigma))

    def _build_level(self, Pdeg, dtype, include_diag=True):
        """Host-built per-level operator arrays + shard_map specs for the
        configured backend (sharded afterwards via `put_global`). Also
        used by `solve_refined` to build the float64 fine-level operator.
        """
        from ..fem.assembly import stiffness_diagonal_np
        from ..ops.kron import axis_stiffness_mass

        backend = self.operator_kind
        kax = self.kappa_axes  # per-axis kron coefficient (None = general)
        part, mesh = self.part, self.mesh
        shards = part.shards
        PSHARD = P(*AXES)
        lv = dict(
            bc_marker=jnp.asarray(
                part.to_dist(Pdeg, mesh.boundary_dof_marker(Pdeg)) > 0.5
            ),
            weights=jnp.asarray(part.ownership_weights(Pdeg), dtype=dtype),
        )
        spec = dict(bc_marker=PSHARD, weights=PSHARD)
        if include_diag:
            lv["diag_inv"] = jnp.asarray(
                part.to_dist(Pdeg, 1.0 / self._global_diag_np(Pdeg)),
                dtype=dtype,
            )
            spec["diag_inv"] = PSHARD
        if include_diag and self._line_axis is not None:
            from ..solvers.line import line_block_inverses, shard_line_blocks

            axis = self._line_axis
            others = [a for a in range(3) if a != axis]
            lv["line_inv"] = jnp.asarray(
                shard_line_blocks(
                    line_block_inverses(mesh, Pdeg, self._kappa_raw,
                                        axis, sigma=self.sigma),
                    mesh.lattice_shape(Pdeg), axis,
                    [part._axis_starts(Pdeg, a) for a in others],
                ),
                dtype=dtype)
            spec["line_inv"] = P(AXES[others[0]], AXES[others[1]])
        if include_diag and getattr(self, "_schwarz", False):
            from ..solvers.schwarz import build_schwarz_np, shard_dense_axis

            # Global host build, then the grid layout: ginv is
            # cell-contiguous along every axis (PartitionSpecs slice
            # it — nc[a] % shards[a] == 0 by GridPartition), bc is
            # dof-lattice-shaped and rides the per-axis duplicated-plane
            # layout like every other lattice-shaped level array. The
            # dense-form U_a re-lay as row-stacked per-shard diagonal
            # blocks along their own axis (local nodes incl. duplicated
            # planes -> local cells).
            swg = build_schwarz_np(mesh, Pdeg, self._kappa_raw,
                                   sigma=self.sigma)
            lv["schwarz"] = dict(
                ginv=jnp.asarray(swg["ginv"], dtype=dtype),
                bc=jnp.asarray(part.to_dist(
                    Pdeg, np.asarray(swg["bc"], np.float64)) > 0.5),
                **{
                    k: jnp.asarray(
                        shard_dense_axis(swg[k], Pdeg,
                                         *part._axis_starts(Pdeg, a)),
                        dtype=dtype)
                    for a, k in enumerate(("Ux", "Uy", "Uz"))
                },
            )
            spec["schwarz"] = dict(
                Ux=P(AXES[0]), Uy=P(AXES[1]), Uz=P(AXES[2]),
                ginv=PSHARD, bc=PSHARD,
            )
        if self._ops_sigma and backend != "kron":
            # Pointwise shift vector: sigma * (field-folded) mass, with
            # any Robin boundary mass baked in (shared policy
            # fem.assembly.general_shift_np, ops scalar then 1.0).
            from ..fem.assembly import general_shift_np

            lv["m3"] = jnp.asarray(
                part.to_dist(Pdeg, general_shift_np(
                    mesh, Pdeg, self.sigma, self._sigma_field)[1]),
                dtype=dtype,
            )
            spec["m3"] = PSHARD
        if backend == "kron":
            from ..ops.kron import local_axis_K

            npls = part.local_shape(Pdeg)
            for a, name in enumerate("xyz"):
                # Local per-shard stiffness (interface partials reconciled
                # by the exchange); global mass in the duplicated layout.
                # Robin end updates: per-shard row-stacked local matrix
                # on a sharded axis (spec P(axis) — each shard sees its
                # own block), plain end fold otherwise.
                Kl, stacked = local_axis_K(
                    mesh, a, part.cells_per_shard[a], Pdeg, kax[a],
                    shards[a],
                )
                _, mg = axis_stiffness_mass(mesh.nc[a], Pdeg, mesh.h_cells[a])
                npl = npls[a]
                m_dup = duplicate_planes(mg, npl, shards[a])
                lv["K" + name] = jnp.asarray(Kl, dtype=dtype)
                lv["m" + name] = jnp.asarray(m_dup, dtype=dtype)
                spec["K" + name] = P(AXES[a]) if stacked else P()
                spec["m" + name] = P(AXES[a])
        elif backend == "dofmap":
            from ..fem.geometry import (
                geometry_factors,
                quadrature_weights_3d,
                tabulate_geometry_dphi,
            )
            from ..fem.gll import derivative_matrix
            from ..fem.mesh import BoxMesh as _Box

            # Per-cell arrays box-blocked: the 1D cell order is
            # (cx slowest, cz fastest), so (ncells, ...) reshapes to
            # (ncx, ncy, ncz, ...) and shards over the device grid.
            # The scatter target is the shard's LOCAL box dofmap
            # (topology only — geometry enters via G).
            G_cells, _ = geometry_factors(
                mesh.geometry_x,
                mesh.geometry_dofmap,
                tabulate_geometry_dphi(Pdeg),
                quadrature_weights_3d(Pdeg),
                xp=np,
                kappa=self._kappa_fold,
            )
            nq = G_cells.shape[1]
            lv["G"] = jnp.asarray(
                G_cells.reshape(*mesh.nc, nq, 6), dtype=dtype
            )
            lv["coeff"] = jnp.asarray(
                self._kc.reshape(*mesh.nc), dtype=dtype
            )
            lv["dofmap"] = jnp.asarray(
                _Box(part.cells_per_shard).dofmap(Pdeg)
            )
            lv["D"] = jnp.asarray(derivative_matrix(Pdeg), dtype=dtype)
            spec.update(G=P(*AXES), coeff=P(*AXES), dofmap=P(), D=P())
        else:  # lattice
            from ..fem.geometry import (
                geometry_factors,
                quadrature_weights_3d,
                tabulate_geometry_dphi,
            )
            from ..ops.lattice import axis_matrices, geometry_to_qlattice

            # Quadrature-lattice geometry: cell-local points, so the
            # global (Qx, Qy, Qz, 6) array partitions exactly along the
            # device grid (Q_a = nc_a*(P+1) divides by shards[a]).
            G_cells, _ = geometry_factors(
                mesh.geometry_x,
                mesh.geometry_dofmap,
                tabulate_geometry_dphi(Pdeg),
                quadrature_weights_3d(Pdeg),
                xp=np,
                kappa=self._kappa_fold,
            )
            Gq = geometry_to_qlattice(
                scale_G(G_cells, self._kc, self._kappa_fold), mesh.nc, Pdeg
            )
            lv["G"] = jnp.asarray(Gq, dtype=dtype)
            spec["G"] = PSHARD
            for a, name in enumerate("xyz"):
                E, Dg = axis_matrices(part.cells_per_shard[a], Pdeg)
                lv["E" + name] = jnp.asarray(E, dtype=dtype)
                lv["D" + name] = jnp.asarray(Dg, dtype=dtype)
                spec["E" + name] = P()
                spec["D" + name] = P()
        return lv, spec

    # -- API -------------------------------------------------------------

    def to_dist(self, u, level=-1):
        Pdeg = self.degrees[level]
        return put_global(
            np.asarray(self.part.to_dist(Pdeg, np.asarray(u)),
                       dtype=self.dtype),
            NamedSharding(self.jmesh, P(*AXES)),
        )

    def from_dist(self, ud, level=-1):
        return self.part.from_dist(self.degrees[level], fetch_global(ud))

    def _fmg_guess_dist(self, bd):
        """Cached jitted shard_map'd FMG guess on a distributed rhs —
        one small program shared by solve / solve_pcg / solve_refined
        (see `DistPMG._fmg_guess_dist`)."""
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
                    in_specs=(self.data_specs, P(*AXES)),
                    out_specs=P(*AXES),
                )
            )
        return self._fmg_prog(self.data, bd)

    def solve(self, b, num_cycles=10, residuals=True, u0=None, fmg=False):
        """Stationary V-cycle iteration as one jitted sharded `lax.scan`
        (device-side residual norms, single host sync at the end).
        ``fmg=True`` starts from the sharded full-multigrid guess."""
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

            def _run(data, bd, ud, _n=num_cycles):
                def body(uc, _):
                    u = v_cycle(
                        data, bd, uc,
                        levels=self.levels, coarse=self.coarse,
                        coarse_cfg=self.coarse_cfg, ops=ops,
                    )
                    lvf = data["levels"][-1]
                    r = bd - ops["apply"](lvf, u, fine)
                    return u, jnp.sqrt(ops["dot"](r, r, lvf))

                return jax.lax.scan(body, ud, None, length=_n)

            self._solve_scans[num_cycles] = jax.jit(
                jax.shard_map(
                    _run, mesh=self.jmesh,
                    in_specs=(self.data_specs, P(*AXES), P(*AXES)),
                    out_specs=(P(*AXES), P()),
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

    def solve_pcg(self, b, rtol=1e-8, maxiter=50, fmg=False):
        """Sharded V-cycle-preconditioned flexible CG over the device
        grid — one jitted shard_map'd while_loop (see
        `PMGHierarchy.solve_pcg`); ``fmg`` starts from the sharded
        full-multigrid guess. Returns ``(u, niter)``."""
        from ..solvers.cg import fcg_solve

        if not hasattr(self, "_pcg_cache"):
            self._pcg_cache = {}
        key = (float(rtol), int(maxiter))
        if key not in self._pcg_cache:
            ops = self._ops
            fine = self.levels[-1]

            def _run(data, b3, u0, _rtol=key[0], _maxiter=key[1]):
                lvf = data["levels"][-1]
                A = lambda x: ops["apply"](lvf, x, fine)
                M = lambda r: v_cycle(
                    data, r, ops["pvary"](jnp.zeros_like(r)),
                    levels=self.levels, coarse=self.coarse,
                    coarse_cfg=self.coarse_cfg, ops=ops,
                )
                return fcg_solve(
                    A, b3, u0, M,
                    rtol=_rtol, maxiter=_maxiter,
                    dot=lambda u_, v_: ops["dot"](u_, v_, lvf),
                )

            self._pcg_cache[key] = jax.jit(
                jax.shard_map(
                    _run, mesh=self.jmesh,
                    in_specs=(self.data_specs, P(*AXES), P(*AXES)),
                    out_specs=(P(*AXES),
                               dict(niter=P(), rnorm=P(), rnorm0=P())),
                )
            )
        bd = self.to_dist(b)
        u0d = self._fmg_guess_dist(bd) if fmg else jnp.zeros_like(bd)
        u, info = self._pcg_cache[key](self.data, bd, u0d)
        return self.from_dist(u), int(info["niter"])

    def solve_refined(self, b, num_cycles=15, rtol=0.0, residuals=True,
                      u0=None, fmg=False):
        """Sharded mixed-precision iterative refinement over the device
        grid: f64 residual via the sharded fine-level apply, working-dtype
        V-cycle as error smoother (see `PMGHierarchy.solve_refined`);
        ``fmg`` seeds the loop with the sharded working-dtype FMG guess.
        Requires jax_enable_x64. Works for both operator backends."""
        from ..solvers.pmg import warn_tensor_stationary

        warn_tensor_stationary(self._kappa_fold, self.kappa_axes,
                               self.operator_kind,
                               line=(self._line_axis is not None
                                     or self._schwarz))
        if not jax.config.read("jax_enable_x64"):
            raise RuntimeError("solve_refined requires jax_enable_x64")
        part = self.part
        shards = part.shards
        fine = self.levels[-1]
        Pdeg = self.degrees[-1]
        if getattr(self, "_refine_step", None) is None:
            lv64, lv64_spec = self._build_level(
                Pdeg, jnp.float64, include_diag=False,
            )
            for k in lv64:
                lv64[k] = put_global(
                    lv64[k], NamedSharding(self.jmesh, lv64_spec[k])
                )
            self._lv64 = lv64
            ops = self._ops
            if self.operator_kind == "kron":
                ops64 = grid_kron_cycle_ops(shards, "highest",
                                            sigma=self.sigma)
            elif self.operator_kind == "dofmap":
                ops64 = grid_dofmap_cycle_ops(shards,
                                              sigma=self._ops_sigma)
            else:
                ops64 = grid_lattice_cycle_ops(shards, "highest",
                                               sigma=self._ops_sigma)
            apply64 = ops64["apply"]
            work_dtype = self.dtype
            levels, coarse, coarse_cfg = (self.levels, self.coarse,
                                          self.coarse_cfg)

            def _step(lv64_, data, b64, u64):
                r64 = b64 - apply64(lv64_, u64, fine)
                rn = jnp.sqrt(
                    jax.lax.psum(jnp.sum(r64 * r64 * lv64_["weights"]), AXES)
                )
                e = v_cycle(
                    data,
                    jnp.asarray(r64, dtype=work_dtype),
                    ops["pvary"](jnp.zeros(fine.shape, dtype=work_dtype)),
                    levels=levels, coarse=coarse, coarse_cfg=coarse_cfg,
                    ops=ops,
                )
                u64n = u64 + jnp.asarray(e, dtype=jnp.float64)
                return u64n, rn

            self._refine_step = jax.jit(
                jax.shard_map(
                    _step, mesh=self.jmesh,
                    in_specs=(lv64_spec, self.data_specs,
                              P(*AXES), P(*AXES)),
                    out_specs=(P(*AXES), P()),
                )
            )

        bd = part.to_dist(Pdeg, np.asarray(b, dtype=np.float64))
        b64 = put_global(
            np.asarray(bd, dtype=np.float64),
            NamedSharding(self.jmesh, P(*AXES)),
        )
        if u0 is not None:
            u64 = put_global(
                np.asarray(part.to_dist(Pdeg, np.asarray(u0)),
                           dtype=np.float64),
                NamedSharding(self.jmesh, P(*AXES)),
            )
        elif fmg:
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
