"""Fast matrix-free Laplacian on UNSTRUCTURED hex topology: the DSS path.

Redesign of the reference hot kernel's topology-agnostic gather ->
per-cell sum-factorized apply -> atomicAdd scatter
(src/laplacian.hpp:143-278, gather :182-189, scatter :272-277). The
literal form (``x[dofmap]`` / ``.at[dofmap].add``) is `ops.laplacian`;
this module reformulates the whole assembly exchange as *direct
stiffness summation over mesh entities* with row-shaped transfers only
(no element gathers or scatter-adds; whether that pays on a GPU, where
gathers and atomic adds are native, is ROADMAP S4):

- The dof vector is stored entity-blocked (`fem.unstructured._build_dss`):
  ``[cell interiors | face interiors | edge interiors | vertices]``.
- Cell-interior dofs (~58% of cell-local values at p=6) move by pure
  reshape — zero indexed ops.
- Face/edge interiors move as (nF, m^2)/(nE, m) ROW gathers, padded to
  >=8 lanes; relative orientation of a shared face is one of the 8
  dihedral transforms, applied vectorized as a select over the 8
  statically-transformed variants (no per-element indexing).
- Vertices move as width-8 REPLICATED rows (row gathers of width 1
  degenerate to element gathers).
- The scatter-add direction needs no scatter at all: each entity SUMS
  its (<= 2 faces / Ke edges / Kv verts) sharers' contribution rows by
  K more row gathers from the per-cell contribution array (owner-first
  source tables, zero-row padded).

The per-cell contraction between the two exchanges is the same
cell-batched sum-factorized kernel as `ops.laplacian.laplacian_apply_cells`
with explicit matmul precision control. Everything is static-shape
XLA.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..fem.unstructured import _EDGES, _FACES


class DSSMeta(NamedTuple):
    """Static (hashable) sizes of a DSS layout — carried on `Level.dss`
    so jitted cycle programs can specialize on them."""

    nc: int
    P: int
    m: int
    n_int: int
    nF: int
    nE: int
    nV: int
    Wf: int   # face row width, m^2 padded to a multiple of 8 (>= 8)
    We: int   # edge row width, m padded likewise
    # Sorted-slice orientation (single-device tables, m > 1): per-
    # variant row counts ((gather-face 8), (scatter-face 8),
    # (gather-edge 2), (scatter-edge 2)) — static slice bounds for the
    # per-variant contiguous transforms. None selects the bit-plane
    # masked form (the distributed tables, whose per-shard counts
    # cannot be static under one shard_map program).
    vslices: tuple | None = None


def _padw(w):
    return max(8, -(-w // 8) * 8)


def dss_meta(layout) -> DSSMeta:
    m = layout["m"]
    vsl = None
    if m > 1:
        vsl = tuple(
            tuple(int(c) for c in np.bincount(layout[k].ravel(),
                                              minlength=nv))
            for k, nv in (("face_var", 8), ("face_inv", 8),
                          ("edge_var", 2), ("edge_inv", 2)))
    return DSSMeta(
        nc=layout["nc"], P=layout["P"], m=m, n_int=layout["n_int"],
        nF=layout["nF"], nE=layout["nE"], nV=layout["nV"],
        Wf=_padw(m * m), We=_padw(m), vslices=vsl,
    )


# Bit decomposition of the 8 dihedral variants: VAR2D[v](M) =
# rev_rows^r1( rev_cols^r2( transpose^t(M) ) ) with (t, r1, r2) below,
# applied as three masked passes (`_apply_var2d`).
_VAR_BITS = np.array(
    [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
     (0, 1, 1), (1, 1, 0), (1, 0, 1), (1, 1, 1)], dtype=bool)


def perm_matrix(layout, dtype):
    """One-hot (n^3, n^3) block-order -> lattice-order column
    permutation matrix ``pmat[l, b] = 1 iff perm_lat[b] == l``. Applied
    as a matmul it is EXACT at precision='highest' in every dtype
    (each output is one input times 1.0; the bf16 3-way split of an f32
    reconstructs exactly)."""
    perm = layout["perm_lat"]
    n3 = len(perm)
    M = np.zeros((n3, n3), dtype=np.float64)
    M[perm, np.arange(n3)] = 1.0
    return jnp.asarray(M, dtype=dtype)


def _sorted_side(var_flat, id_flat=None, src=None, pad=None):
    """Variant-sort tables for one exchange side: stable order by
    variant (contiguous per-variant slices for the static transforms),
    the unsort permutation (gather side) or the remapped source table
    (scatter side: entity sums index the SORTED contribution array
    directly — no unsort needed)."""
    order = np.argsort(var_flat, kind="stable")
    out = {"order": order.astype(np.int32)}
    if id_flat is not None:
        out["id_sorted"] = id_flat[order].astype(np.int32)
        out["unsort"] = np.argsort(order).astype(np.int32)
    if src is not None:
        pos = np.empty(len(var_flat) + 1, dtype=np.int64)
        pos[order] = np.arange(len(var_flat))
        pos[len(var_flat)] = len(var_flat)
        out["src_sorted"] = np.where(
            src == pad, len(var_flat),
            pos[np.minimum(src, pad)]).astype(np.int32)
    return out


def dss_device_tables(layout, dtype=jnp.float64) -> dict:
    """Device copies of the index tables the apply reads: entity
    gather/scatter indices, the SORTED-slice orientation tables (m > 1:
    cellfaces variant-sorted so each dihedral transform applies to one
    contiguous slice instead of a bit-plane masked select), and the
    block->lattice permutation matmul operand (`perm_matrix`) in the
    working ``dtype``. The distributed layer builds bit-plane tables
    instead (`parallel.dss_dist`): per-shard variant counts cannot be
    static under one shard_map program."""
    t = {k: jnp.asarray(layout[k]) for k in ("vert_id", "vert_src")}
    m = layout["m"]
    if m and m <= 1:
        # every dihedral transform is the identity on (1, 1) blocks /
        # single-node edges: plain tables, no orientation machinery
        t.update({k: jnp.asarray(layout[k]) for k in
                  ("face_id", "edge_id", "face_src", "edge_src")})
    elif m:
        nc = layout["nc"]
        fg = _sorted_side(layout["face_var"].ravel(),
                          id_flat=layout["face_id"].ravel())
        fs = _sorted_side(layout["face_inv"].ravel(),
                          src=layout["face_src"].astype(np.int64),
                          pad=nc * 6)
        eg = _sorted_side(layout["edge_var"].ravel(),
                          id_flat=layout["edge_id"].ravel())
        es = _sorted_side(layout["edge_inv"].ravel(),
                          src=layout["edge_src"].astype(np.int64),
                          pad=nc * 12)
        t.update(
            face_gid=jnp.asarray(fg["id_sorted"]),
            face_gunsort=jnp.asarray(fg["unsort"]),
            face_sorder=jnp.asarray(fs["order"]),
            face_ssrc=jnp.asarray(fs["src_sorted"]),
            edge_gid=jnp.asarray(eg["id_sorted"]),
            edge_gunsort=jnp.asarray(eg["unsort"]),
            edge_sorder=jnp.asarray(es["order"]),
            edge_ssrc=jnp.asarray(es["src_sorted"]),
        )
    if m:
        t["pmat"] = perm_matrix(layout, dtype)
    return t


def _slice_var2d(rows, counts, m):
    """Apply dihedral variant ``v`` to the v-th contiguous slice of the
    variant-sorted ``rows[(R, m*m)]`` (static offsets from the meta
    counts)."""
    from ..fem.unstructured import VAR2D

    parts, off = [], 0
    for v, T in enumerate(VAR2D):
        c = counts[v]
        if c:
            parts.append(T(rows[off:off + c].reshape(c, m, m)
                           ).reshape(c, m * m))
            off += c
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def _slice_var1d(rows, counts):
    from ..fem.unstructured import VAR1D

    parts, off = [], 0
    for v, T in enumerate(VAR1D):
        c = counts[v]
        if c:
            parts.append(T(rows[off:off + c]))
            off += c
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def _pad_cols(a, W):
    if a.shape[1] == W:
        return a
    return jnp.pad(a, ((0, 0), (0, W - a.shape[1])))


def _apply_var2d(rows, t, prefix, m):
    """Per-row dihedral transform of ``rows[(nc, 6, m, m)]`` via the
    THREE decomposed bit-plane passes (transpose / row-reverse /
    col-reverse, `_VAR_BITS`) — chosen over a one-hot
    variant-stacking matmul (more matmul passes + 8x-stacked gather
    operands)."""
    if m <= 1:
        return rows  # every transform is the identity on (1, 1) blocks
    rows = jnp.where(t[prefix + "_t"][..., None, None],
                     rows.swapaxes(-1, -2), rows)
    rows = jnp.where(t[prefix + "_r1"][..., None, None],
                     rows[..., ::-1, :], rows)
    rows = jnp.where(t[prefix + "_r2"][..., None, None],
                     rows[..., :, ::-1], rows)
    return rows


def _apply_var1d(rows, t, prefix, m):
    if m <= 1:
        return rows
    return jnp.where(t[prefix + "_r"][..., None], rows[..., ::-1], rows)


def _offsets(meta):
    o_f = meta.n_int
    o_e = o_f + meta.nF * meta.m * meta.m
    o_v = o_e + meta.nE * meta.m
    return o_f, o_e, o_v


def _gather_rows(x, t, meta):
    """The three entity row-gather stages: face rows (nc, 6*m*m) in
    LOCAL orientation, edge rows (nc, 12*m), vertex values (nc, 8).
    Orientation: sorted-slice transforms + one unsort row gather when
    the tables carry the sorted form (single-device, m > 1), bit-plane
    selects otherwise (distributed tables)."""
    m = meta.m
    o_f, o_e, o_v = _offsets(meta)
    rows = er = None
    if m and "face_gid" in t:
        xf = _pad_cols(x[o_f:o_e].reshape(meta.nF, m * m), meta.Wf)
        rs = xf[t["face_gid"]][:, :m * m]
        rl = _slice_var2d(rs, meta.vslices[0], m)
        rows = rl[t["face_gunsort"]].reshape(meta.nc, 6 * m * m)
        xe = _pad_cols(x[o_e:o_v].reshape(meta.nE, m), meta.We)
        ers = xe[t["edge_gid"]][:, :m]
        er = _slice_var1d(ers, meta.vslices[2])[
            t["edge_gunsort"]].reshape(meta.nc, 12 * m)
    elif m:
        xf = _pad_cols(x[o_f:o_e].reshape(meta.nF, m * m), meta.Wf)
        rows = xf[t["face_id"].reshape(-1)][:, :m * m]
        rows = _apply_var2d(rows.reshape(meta.nc, 6, m, m), t,
                            "face_var", m).reshape(meta.nc, 6 * m * m)
        xe = _pad_cols(x[o_e:o_v].reshape(meta.nE, m), meta.We)
        er = xe[t["edge_id"].reshape(-1)][:, :m]
        er = _apply_var1d(er.reshape(meta.nc, 12, m), t,
                          "edge_var", m).reshape(meta.nc, 12 * m)
    xv8 = jnp.broadcast_to(x[o_v:, None], (meta.nV, 8))
    rv = xv8[t["vert_id"].reshape(-1)][:, 0].reshape(meta.nc, 8)
    return rows, er, rv


def dss_gather(x, t, meta):
    """Continuous dof vector ``(ndofs,)`` -> cell slabs
    ``(nc, n, n, n)`` (the reference gather, src/laplacian.hpp:182-189,
    as reshapes + row gathers). The slab is assembled in entity-block
    COLUMN order — one wide 4-piece concat — and mapped to lattice
    order by a single exact one-hot matmul (``pmat``) instead of a
    concat of 27 small blocks."""
    nc, m = meta.nc, meta.m
    n = meta.P + 1
    rows, er, rv = _gather_rows(x, t, meta)
    if m == 0:
        return rv.reshape(nc, 2, 2, 2)
    ublk = jnp.concatenate(
        [x[:meta.n_int].reshape(nc, m ** 3), rows, er, rv], axis=1)
    u = jnp.einsum("cb,lb->cl", ublk, t["pmat"], precision="highest")
    return u.reshape(nc, n, n, n)


def _src_sum(rows2d, src, first):
    """Entity sums: K row gathers from the zero-row-padded contribution
    array (owner first)."""
    rows2d = jnp.concatenate(
        [rows2d, jnp.zeros((1, rows2d.shape[1]), rows2d.dtype)])
    acc = rows2d[src[:, 0]]
    if not first:
        for k in range(1, src.shape[1]):
            acc = acc + rows2d[src[:, k]]
    return acc


def dss_scatter(yc, t, meta, first=False):
    """Cell slabs ``(nc, n, n, n)`` -> continuous dof vector: each
    entity row-gathers and sums its sharers' contribution rows (the
    reference's atomicAdd scatter, src/laplacian.hpp:272-277, with
    ZERO scatter ops). ``first=True`` takes the owner's row only —
    exact for value-consistent fields (prolongation writes identical
    values from every sharer)."""
    nc, m = meta.nc, meta.m
    n = meta.P + 1
    if m == 0:
        cv = yc.reshape(nc, 8)
        cv8 = jnp.broadcast_to(cv.reshape(-1)[:, None], (nc * 8, 8))
        return _src_sum(cv8, t["vert_src"], first)[:, 0]
    # Lattice -> block column order (exact one-hot matmul), then the
    # entity sections are CONTIGUOUS column ranges.
    yblk = jnp.einsum("cl,lb->cb", yc.reshape(nc, n ** 3), t["pmat"],
                      precision="highest")
    o1 = m ** 3
    o2 = o1 + 6 * m * m
    o3 = o2 + 12 * m
    parts = [yblk[:, :o1].reshape(-1)]
    if "face_sorder" in t:
        # sorted form: contributions variant-sorted, per-slice inverse
        # transforms, entity sums gather from the SORTED array (the
        # remapped source table absorbs the permutation — no unsort).
        cfs = yblk[:, o1:o2].reshape(nc * 6, m * m)[t["face_sorder"]]
        canon = _slice_var2d(cfs, meta.vslices[1], m)
        acc = _src_sum(_pad_cols(canon, meta.Wf), t["face_ssrc"], first)
        parts.append(acc[:, :m * m].reshape(-1))
        ces = yblk[:, o2:o3].reshape(nc * 12, m)[t["edge_sorder"]]
        canon_e = _slice_var1d(ces, meta.vslices[3])
        acc = _src_sum(_pad_cols(canon_e, meta.We), t["edge_ssrc"], first)
        parts.append(acc[:, :m].reshape(-1))
    else:
        cf = _apply_var2d(yblk[:, o1:o2].reshape(nc, 6, m, m), t,
                          "face_inv", m)
        acc = _src_sum(_pad_cols(cf.reshape(nc * 6, m * m), meta.Wf),
                       t["face_src"], first)
        parts.append(acc[:, :m * m].reshape(-1))
        ce = _apply_var1d(yblk[:, o2:o3].reshape(nc, 12, m), t,
                          "edge_inv", m)
        acc = _src_sum(_pad_cols(ce.reshape(nc * 12, m), meta.We),
                       t["edge_src"], first)
        parts.append(acc[:, :m].reshape(-1))
    cv8 = jnp.broadcast_to(yblk[:, o3:].reshape(-1)[:, None], (nc * 8, 8))
    parts.append(_src_sum(cv8, t["vert_src"], first)[:, 0])
    return jnp.concatenate(parts)


def apply_cells(u_cells, G, coeff, D, precision="highest"):
    """Cell-local stiffness action with explicit matmul precision (the
    precision-parametrized `ops.laplacian.laplacian_apply_cells`;
    'highest' = true f32 — an f32 einsum without it may run in TF32 on
    a GPU, ~1e-3 error)."""
    n = D.shape[0]
    g = G.reshape(G.shape[0], n, n, n, 6)
    ux = jnp.einsum("qi,cijk->cqjk", D, u_cells, precision=precision)
    uy = jnp.einsum("qj,cijk->ciqk", D, u_cells, precision=precision)
    uz = jnp.einsum("qk,cijk->cijq", D, u_cells, precision=precision)
    c = coeff[:, None, None, None]
    fw0 = c * (g[..., 0] * ux + g[..., 1] * uy + g[..., 2] * uz)
    fw1 = c * (g[..., 1] * ux + g[..., 3] * uy + g[..., 4] * uz)
    fw2 = c * (g[..., 2] * ux + g[..., 4] * uy + g[..., 5] * uz)
    return (
        jnp.einsum("qi,cqjk->cijk", D, fw0, precision=precision)
        + jnp.einsum("qj,ciqk->cijk", D, fw1, precision=precision)
        + jnp.einsum("qk,cijq->cijk", D, fw2, precision=precision)
    )


def dss_laplacian_apply(x, lv, meta, precision="highest", sigma=0.0,
                        apply_bc=True):
    """Full matrix-free ``y = A x`` on the DSS dof vector (jittable).

    ``lv`` holds the device tables plus ``G (nc, n^3, 6)``, ``coeff
    (nc,)``, ``D (n, n)``, ``bc_marker`` and (when ``sigma``) the
    bc-zeroed lumped mass ``m3``. Semantics identical to
    `ops.laplacian.laplacian_apply` (bc zero on gather, identity rows)."""
    bc = lv["bc_marker"]
    xb = jnp.where(bc, jnp.zeros_like(x), x)
    u = dss_gather(xb, lv, meta)
    yc = apply_cells(u, lv["G"], lv["coeff"], lv["D"], precision=precision)
    y = dss_scatter(yc, lv, meta)
    if sigma:
        y = y + sigma * lv["m3"] * x
    if not apply_bc:
        return y
    return jnp.where(bc, x, y)


def dss_prolongate(xc, M1, lv_c, meta_c, lv_f, meta_f,
                   precision="highest"):
    """Coarse->fine p-transfer: cell-gather coarse, per-cell 1D-Kronecker
    interpolation, owner-write fine (values agree across sharers — the
    C0 interpolant; same semantics as `ops.interpolate.prolongate`)."""
    u = dss_gather(xc, lv_c, meta_c)
    v = jnp.einsum("ai,bj,ck,xijk->xabc", M1, M1, M1, u,
                   precision=precision)
    return dss_scatter(v, lv_f, meta_f, first=True)


def dss_restrict(xf, M1, lv_f, meta_f, lv_c, meta_c, inv_mult_f,
                 precision="highest"):
    """Fine->coarse multiplicity-weighted transpose transfer (same
    semantics as `ops.interpolate.restrict`)."""
    u = dss_gather(xf * inv_mult_f, lv_f, meta_f)
    v = jnp.einsum("ai,bj,ck,xabc->xijk", M1, M1, M1, u,
                   precision=precision)
    return dss_scatter(v, lv_c, meta_c)
