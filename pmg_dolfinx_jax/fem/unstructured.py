"""External UNSTRUCTURED-topology hexahedral meshes.

Closes the reference's last generality edge over the box family: riding
DOLFINx, the reference can load ANY conforming hex mesh and partition it
(src/mesh.hpp:17-98; examples/cg/main.cpp:39 declares a ``--file`` mesh
option). Here an arbitrary ``nodes + connectivity`` hex mesh — loaded
from an ``.npz`` file or a Gmsh ASCII v2.2 ``.msh`` — becomes an
`UnstructuredHexMesh` implementing the same duck-type interface as
`BoxMesh` (``dofmap / boundary_dof_marker / dof_multiplicity /
dof_coords / geometry_x / geometry_dofmap / cell_centroids``), so the
GENERAL code paths run unchanged: the host scipy golden assembly
(`fem.assembly`), the 'dofmap' and 'csr' PMG operator backends with
coarse in {'direct', 'cg', 'smoother'}, Newton, and the collocated L2
norm. The tensor-product fast family (kron/lattice/FDM/hmg, graded
spacing, line/Schwarz blocks, sharded layouts) requires per-axis
structure and is intentionally NOT available here — those paths read
``mesh.nc`` / ``mesh.lattice_shape`` and fail with an AttributeError
naming the missing structure.

Continuity (the CG dofmap) is built GEOMETRICALLY: every cell maps its
reference GLL lattice through the trilinear (Q1) geometry and coincident
physical points are merged with a KDTree union-find at a tolerance far
below the smallest GLL node gap. This sidesteps the classic edge/face
orientation bookkeeping entirely — two cells meeting at a face compute
the same physical points from the same four face corners regardless of
how their local frames are rotated against each other (the GLL lattice
is symmetric), so the merge reproduces the topological dofmap exactly on
any conforming mesh. CONFORMING meshes only: a hanging-node interface
builds a discontinuous (broken) space — this loader targets the same
contract as the reference's DOLFINx ingestion, which is conforming too.
"""

from functools import lru_cache

import numpy as np

from .gll import gauss_lobatto

# Local corner ordering (matches BoxMesh.geometry_dofmap): corner index
# (i*2 + j)*2 + k for (i, j, k) in {0,1}^3 along (x, y, z).
_CORNER_IJK = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)])
# The 6 local faces: (corner ids on the face, lattice axis, lattice end).
_FACES = (
    ((0, 1, 2, 3), 0, 0), ((4, 5, 6, 7), 0, 1),
    ((0, 1, 4, 5), 1, 0), ((2, 3, 6, 7), 1, 1),
    ((0, 2, 4, 6), 2, 0), ((1, 3, 5, 7), 2, 1),
)

# The 12 local edges: (free axis a, fixed axes (b, c) with b < c, ends
# (eb, ec)); edge index = a*4 + eb*2 + ec.
_EDGES = tuple(
    (a, tuple(sorted(set((0, 1, 2)) - {a})), (eb, ec))
    for a in (0, 1, 2) for eb in (0, 1) for ec in (0, 1)
)

# The 8 dihedral transforms of an (..., m, m) block (the possible
# relative orientations of a shared quad face between two conforming
# hexes) and the 2 of an (..., m) block (shared edge directions).
# NumPy/JAX agnostic: only transpose/reverse ops.
VAR2D = (
    lambda M: M,
    lambda M: M.swapaxes(-1, -2),
    lambda M: M[..., ::-1, :],
    lambda M: M[..., :, ::-1],
    lambda M: M[..., ::-1, ::-1],
    lambda M: M.swapaxes(-1, -2)[..., ::-1, :],
    lambda M: M.swapaxes(-1, -2)[..., :, ::-1],
    lambda M: M.swapaxes(-1, -2)[..., ::-1, ::-1],
)
VAR1D = (lambda v: v, lambda v: v[..., ::-1])


def _entity_groups(keys):
    """Group a flat int key array into entities: returns
    ``(n_entities, entity_of_key, src_table, max_sharers)`` where
    ``src_table[(n_entities, K)]`` lists the flat key positions sharing
    each entity (first occurrence first — the owner), padded with
    ``len(keys)``."""
    uniq, first, inv = np.unique(keys, return_index=True,
                                 return_inverse=True)
    ne = len(uniq)
    order = np.argsort(inv, kind="stable")
    cnt = np.bincount(inv, minlength=ne)
    K = int(cnt.max()) if ne else 1
    offs = np.concatenate([[0], np.cumsum(cnt)])
    src = np.full((ne, K), len(keys), dtype=np.int64)
    for k in range(K):
        sel = cnt > k
        src[sel, k] = order[offs[:-1][sel] + k]
    assert np.array_equal(src[:, 0], first)
    return ne, inv, src, K


def _match_variants(canon, local, variants):
    """Per-row variant indices ``var`` (canonical -> local) and ``inv``
    (local -> canonical): ``variants[var[r]](canon[r]) == local[r]``.
    Raises if some row matches no variant (a non-conforming or
    corrupted interface)."""
    var = np.full(canon.shape[0], -1, dtype=np.int8)
    inv = np.full(canon.shape[0], -1, dtype=np.int8)
    axes = tuple(range(1, canon.ndim))
    for v, T in enumerate(variants):
        hit = (T(canon) == local).all(axis=axes)
        var[(var < 0) & hit] = v
        hit_i = (T(local) == canon).all(axis=axes)
        inv[(inv < 0) & hit_i] = v
    if (var < 0).any() or (inv < 0).any():
        raise ValueError(
            "shared-entity dof block matches no dihedral orientation "
            "variant: non-conforming interface or corrupted mesh")
    return var, inv


class UnstructuredHexMesh:
    """Conforming unstructured hex mesh from ``nodes + cells`` arrays.

    Parameters
    ----------
    nodes : (n_nodes, 3) float array
        Corner-vertex coordinates.
    cells : (ncells, 8) int array
        Cell -> vertex connectivity in the package corner order
        ``(i*2 + j)*2 + k`` along (x, y, z) (use `gmsh_corner_permutation`
        for Gmsh-ordered input). Cells must be positively oriented
        (checked: every collocation-point Jacobian determinant > 0).
    dirichlet : True, callable, str, or sequence of str, optional
        ``True`` marks every boundary dof Dirichlet (boundary = faces
        owned by exactly one cell, found topologically). A callable
        ``marker(x[(3, npts)]) -> bool[(npts,)]`` restricts the marking
        to the selected subset of boundary dofs; the rest are natural
        (homogeneous-Neumann) unknowns, exactly as `BoxMesh`'s
        ``dirichlet_faces``. A group name (or sequence of names) marks
        the boundary faces belonging to those ``tagged_faces`` groups —
        the Gmsh physical-surface workflow (`read_gmsh_hex` fills the
        groups from ``$PhysicalNames`` + tagged quads), no geometric
        callables needed.
    tagged_faces : dict, optional
        ``{name: (nq, 4) int array}`` of boundary-quad corner-NODE ids
        per named face group (order-free: faces are matched as corner
        sets).
    tol : float, optional
        Geometric merge tolerance. Default: ``1e-6 * min edge length``
        — at least ~3 orders below the smallest GLL node gap for any
        practical degree.
    """

    is_axis_aligned = False
    is_graded = True          # no uniform-h shortcut anywhere
    has_robin = False

    def __init__(self, nodes, cells, dirichlet=True, tol=None,
                 tagged_faces=None):
        self.tagged_faces = {
            k: np.ascontiguousarray(np.asarray(v, dtype=np.int64))
            for k, v in (tagged_faces or {}).items()
        }
        nodes = np.ascontiguousarray(np.asarray(nodes, dtype=np.float64))
        cells = np.ascontiguousarray(np.asarray(cells, dtype=np.int32))
        if nodes.ndim != 2 or nodes.shape[1] != 3:
            raise ValueError(f"nodes must be (n, 3), got {nodes.shape}")
        if cells.ndim != 2 or cells.shape[1] != 8:
            raise ValueError(f"cells must be (ncells, 8), got {cells.shape}")
        if cells.min() < 0 or cells.max() >= len(nodes):
            raise ValueError("cell connectivity indexes out of range")
        self._nodes = nodes
        self._cells = cells
        self.ncells = len(cells)
        self.robin_alpha = np.zeros((3, 2))
        self._dirichlet = dirichlet
        # Min edge length over the 12 edges of every cell (tolerance
        # scale + degenerate-cell guard).
        C = nodes[cells]  # (ncells, 8, 3)
        edges = [(a, b) for (a, b) in (
            (0, 4), (1, 5), (2, 6), (3, 7),   # x edges
            (0, 2), (1, 3), (4, 6), (5, 7),   # y edges
            (0, 1), (2, 3), (4, 5), (6, 7),   # z edges
        )]
        el = np.stack([np.linalg.norm(C[:, a] - C[:, b], axis=1)
                       for a, b in edges])
        self._min_edge = float(el.min())
        if self._min_edge <= 0.0:
            raise ValueError("degenerate cell: coincident corner nodes")
        self.tol = float(tol) if tol is not None else 1e-6 * self._min_edge
        self._dss_cache = {}
        self._check_orientation()

    # -- geometry (Q1) --------------------------------------------------
    @property
    def geometry_x(self) -> np.ndarray:
        return self._nodes

    @property
    def geometry_dofmap(self) -> np.ndarray:
        return self._cells

    def cell_centroids(self) -> np.ndarray:
        return self._nodes[self._cells].mean(axis=1)

    def _check_orientation(self, P=2):
        """Every Q1 Jacobian determinant at the degree-``P`` collocation
        points must be positive (inverted / tangled cells make the
        whole discretization meaningless — fail loudly). Called at load
        with P=2 (cheap early check) AND per requested degree from
        `_space` — a strongly warped trilinear hex can be positive at
        all 27 degree-2 points yet fold at some higher-degree GLL
        quadrature point, which would make the actual assembly
        indefinite (ADVICE r4)."""
        from .geometry import (geometry_factors, quadrature_weights_3d,
                               tabulate_geometry_dphi)

        _, detJ = geometry_factors(
            self._nodes, self._cells, tabulate_geometry_dphi(P),
            quadrature_weights_3d(P), xp=np,
        )
        # detJ here is w_q * det J; GLL weights are positive.
        if not np.all(np.asarray(detJ) > 0.0):
            bad = int(np.argmin(np.asarray(detJ).min(axis=1)))
            raise ValueError(
                f"non-positive Jacobian in cell {bad} at degree {P}: "
                "inverted or tangled hex (check corner ordering — Gmsh "
                "input needs gmsh_corner_permutation)")

    # -- degree-P space -------------------------------------------------
    def _ref_lattice(self, P: int) -> np.ndarray:
        """Reference GLL lattice, shape ``((P+1)^3, 3)``, z fastest."""
        xg, _ = gauss_lobatto(P + 1)
        X, Y, Z = np.meshgrid(xg, xg, xg, indexing="ij")
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    def _cell_node_coords(self, P: int) -> np.ndarray:
        """Physical coordinates of every cell-local lattice node via the
        trilinear map, shape ``(ncells, (P+1)^3, 3)``."""
        ref = self._ref_lattice(P)  # (nl, 3)
        # Trilinear weights per corner: prod_d phi_{c_d}(xi_d).
        w = np.ones((ref.shape[0], 8))
        for d in range(3):
            t = ref[:, d][:, None]
            w *= np.where(_CORNER_IJK[None, :, d] == 0, 1.0 - t, t)
        return np.einsum("lc,ecD->elD", w, self._nodes[self._cells])

    @lru_cache(maxsize=None)
    def _space(self, P: int):
        """Build (dofmap, ndofs, dof_coords) by geometric merge."""
        from scipy.spatial import cKDTree

        if P > 2:  # load-time check covered P=2
            self._check_orientation(P)
        pts = self._cell_node_coords(P).reshape(-1, 3)
        tree = cKDTree(pts)
        pairs = tree.query_pairs(r=self.tol, output_type="ndarray")
        # Union-find over the point set.
        parent = np.arange(len(pts))

        def find(a):
            root = a
            while parent[root] != root:
                root = parent[root]
            while parent[a] != root:
                parent[a], a = root, parent[a]
            return root

        for a, b in pairs:
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        roots = np.array([find(int(i)) for i in range(len(pts))])
        uniq, dof = np.unique(roots, return_inverse=True)
        ndofs = len(uniq)
        n = P + 1
        dofmap = np.ascontiguousarray(
            dof.reshape(self.ncells, n ** 3).astype(np.int32))
        # Representative coordinates: mean over merged copies (the
        # copies agree to tol; the mean is orientation-symmetric).
        coords = np.zeros((ndofs, 3))
        cnt = np.bincount(dof, minlength=ndofs).astype(np.float64)
        for d in range(3):
            coords[:, d] = np.bincount(dof, weights=pts[:, d],
                                       minlength=ndofs) / cnt
        # Tolerance sanity check: with a healthy mesh the node-gap
        # spectrum is bimodal — merged copies within tol, distinct GLL
        # neighbours at >~ 1e-2 * min_edge. Distinct dofs landing inside
        # 100*tol means the merge tolerance is ambiguous for this
        # geometry (near-degenerate cells, or a slightly-mismatched
        # "conforming" interface): refuse rather than build a subtly
        # broken space. (Truly non-conforming hanging-node interfaces
        # put fine nodes ~h/2 from any coarse node and are out of
        # contract — see the module docstring.)
        close = tree.query_pairs(r=100.0 * self.tol,
                                 output_type="ndarray")
        if len(close):
            unmerged = dof[close[:, 0]] != dof[close[:, 1]]
            if np.any(unmerged):
                raise ValueError(
                    "distinct dofs within 100x the merge tolerance: "
                    "near-degenerate cells or a mismatched interface — "
                    "fix the mesh or pass an explicit tol")
        # DSS renumbering (round 5): reorder the merged dof ids into the
        # entity-blocked layout [cell interiors | face interiors | edge
        # interiors | vertices] and build the row-gather tables of the
        # fast unstructured operator (`ops/unstructured.py`: row
        # gathers only, no element gathers). The renumbering is the mesh's
        # canonical numbering: every backend (dofmap/csr/assembly)
        # shares it, so vectors interoperate with zero conversions.
        dofmap, new, layout = self._build_dss(P, dofmap, ndofs)
        coords_new = np.empty_like(coords)
        coords_new[new] = coords
        self._dss_cache[P] = layout
        coords_new.setflags(write=False)
        dofmap.setflags(write=False)
        return dofmap, ndofs, coords_new

    def dss_layout(self, P: int) -> dict:
        """Entity tables of the DSS dof layout at degree ``P`` (host
        NumPy; see `_build_dss`). Built together with `_space`."""
        self._space(P)
        return self._dss_cache[P]

    def _build_dss(self, P, dofmap, ndofs):
        """Renumber dofs into DSS entity blocks + build gather/scatter
        tables.

        Layout: ``[cell interiors (cell-major, local lattice order) |
        face interiors (canonical = owner-local order) | edge interiors
        | vertices]``, entities ordered by their minimum merged dof id
        (deterministic). Tables (all NumPy int32 unless noted):

        - ``face_id (nc, 6)`` global face index per local face;
          ``face_var / face_inv (nc, 6)`` int8 dihedral variant indices
          (canonical->local and local->canonical, `VAR2D`);
        - ``edge_id (nc, 12)`` + ``edge_var / edge_inv`` (`VAR1D`);
        - ``vert_id (nc, 8)`` global vertex index;
        - ``face_src (nF, <=2)`` / ``edge_src (nE, Ke)`` /
          ``vert_src (nV, Kv)``: flat (cell*nloc + local) sharer rows
          per entity, owner first, padded with the row count (a zero
          row at apply time);
        - sizes ``n_int / nF / nE / nV / Ke / Kv`` and ``m = P - 1``.

        Orientation handling: a shared face's interior dofs as seen by
        the two cells differ by one of the 8 dihedral transforms (the
        trilinear geometry agrees on corners and the GLL lattice is
        symmetric); the variant is found by matching merged dof ids
        against all 8 and FAILS LOUDLY if none matches. Same for edges
        with the 2 direction variants.
        """
        n = P + 1
        m = P - 1
        nc = self.ncells
        dml = dofmap.reshape(nc, n, n, n).astype(np.int64)
        new = np.full(ndofs, -1, dtype=np.int64)

        if m:
            int_ids = dml[:, 1:-1, 1:-1, 1:-1].reshape(nc, -1)
        else:
            int_ids = np.zeros((nc, 0), dtype=np.int64)
        n_int = int_ids.size
        new[int_ids.ravel()] = np.arange(n_int)

        if m:
            fblocks = []
            for _, a, e in _FACES:
                sl = [slice(1, n - 1)] * 3
                sl[a] = 0 if e == 0 else n - 1
                fblocks.append(dml[(slice(None),) + tuple(sl)])
            fbf = np.stack(fblocks, axis=1).reshape(nc * 6, m, m)
            nF, inv_f, fsrc, Kf = _entity_groups(
                fbf.reshape(nc * 6, -1).min(axis=1))
            if Kf > 2:
                raise ValueError(
                    f"a face is shared by {Kf} cells: non-manifold mesh")
            canon_f = fbf[fsrc[:, 0]]
            fvar, finv = _match_variants(canon_f[inv_f], fbf, VAR2D)
            new[canon_f.ravel()] = n_int + np.arange(nF * m * m)

            eblocks = []
            for a, (b, c), (eb, ec) in _EDGES:
                sl = [None] * 3
                sl[a] = slice(1, n - 1)
                sl[b] = 0 if eb == 0 else n - 1
                sl[c] = 0 if ec == 0 else n - 1
                eblocks.append(dml[(slice(None),) + tuple(sl)])
            ebf = np.stack(eblocks, axis=1).reshape(nc * 12, m)
            nE, inv_e, esrc, Ke = _entity_groups(ebf.min(axis=1))
            canon_e = ebf[esrc[:, 0]]
            evar, einv = _match_variants(canon_e[inv_e], ebf, VAR1D)
            new[canon_e.ravel()] = n_int + nF * m * m + np.arange(nE * m)
        else:
            nF = nE = 0
            Ke = 1
            fbf = np.zeros((nc * 6, 0, 0), dtype=np.int64)
            inv_f = np.zeros(nc * 6, dtype=np.int64)
            fsrc = np.zeros((0, 2), dtype=np.int64)
            fvar = finv = np.zeros(nc * 6, dtype=np.int8)
            inv_e = np.zeros(nc * 12, dtype=np.int64)
            esrc = np.zeros((0, 1), dtype=np.int64)
            evar = einv = np.zeros(nc * 12, dtype=np.int8)

        vk = dml[:, [0, -1]][:, :, [0, -1]][:, :, :, [0, -1]].reshape(nc, 8)
        nV, inv_v, vsrc, Kv = _entity_groups(vk.ravel())
        o_vert = n_int + nF * m * m + nE * m
        new[vk.ravel()[vsrc[:, 0]]] = o_vert + np.arange(nV)
        if o_vert + nV != ndofs or (new < 0).any() or (
                np.unique(new).size != ndofs):
            raise AssertionError(
                "DSS renumbering is not a bijection: inconsistent "
                "entity classification (mesh merge produced a dof "
                "shared across entity classes — non-conforming mesh?)")

        dofmap_new = np.ascontiguousarray(
            new[dml.reshape(nc, -1)].astype(np.int32))
        # Block-order -> lattice-order column permutation of the n^3
        # cell slots (`ops.unstructured`: the cell slab is assembled in
        # entity-block column order — one wide concat — and mapped to
        # lattice order by a single exact one-hot matmul instead of a
        # concat of 27 tiny pieces).
        perm = np.empty(n ** 3, dtype=np.int64)
        col = 0
        for i in range(1, n - 1):
            for j in range(1, n - 1):
                for k in range(1, n - 1):
                    perm[col] = (i * n + j) * n + k
                    col += 1
        for _, a, e in _FACES:
            bax, cax = sorted(set((0, 1, 2)) - {a})
            for p in range(1, n - 1):
                for q in range(1, n - 1):
                    idx = [0, 0, 0]
                    idx[a] = 0 if e == 0 else n - 1
                    idx[bax], idx[cax] = p, q
                    perm[col] = (idx[0] * n + idx[1]) * n + idx[2]
                    col += 1
        for a, (bax, cax), (eb, ec) in _EDGES:
            for p in range(1, n - 1):
                idx = [0, 0, 0]
                idx[a] = p
                idx[bax] = 0 if eb == 0 else n - 1
                idx[cax] = 0 if ec == 0 else n - 1
                perm[col] = (idx[0] * n + idx[1]) * n + idx[2]
                col += 1
        for i in (0, 1):
            for j in (0, 1):
                for k in (0, 1):
                    perm[col] = ((i * (n - 1)) * n + j * (n - 1)) * n \
                        + k * (n - 1)
                    col += 1
        assert col == n ** 3 and np.unique(perm).size == n ** 3
        layout = dict(
            perm_lat=perm,
            P=P, m=m, nc=nc, n_int=n_int, nF=nF, nE=nE, nV=nV,
            Ke=Ke, Kv=Kv,
            face_id=inv_f.reshape(nc, 6).astype(np.int32),
            face_var=fvar.reshape(nc, 6).astype(np.int8),
            face_inv=finv.reshape(nc, 6).astype(np.int8),
            edge_id=inv_e.reshape(nc, 12).astype(np.int32),
            edge_var=evar.reshape(nc, 12).astype(np.int8),
            edge_inv=einv.reshape(nc, 12).astype(np.int8),
            vert_id=inv_v.reshape(nc, 8).astype(np.int32),
            face_src=fsrc.astype(np.int32),
            edge_src=esrc.astype(np.int32),
            vert_src=vsrc.astype(np.int32),
        )
        return dofmap_new, new, layout

    def dofmap(self, P: int) -> np.ndarray:
        """Cell dofmap ``(ncells, (P+1)^3)`` int32, z-fastest local
        lattice order (the `BoxMesh.dofmap` contract)."""
        return self._space(P)[0]

    def num_dofs(self, P: int) -> int:
        return self._space(P)[1]

    def dof_coords(self, P: int) -> np.ndarray:
        return self._space(P)[2]

    @lru_cache(maxsize=None)
    def dof_multiplicity(self, P: int) -> np.ndarray:
        """Number of cells sharing each dof (restriction weighting)."""
        dm, ndofs, _ = self._space(P)
        out = np.bincount(dm.ravel(), minlength=ndofs).astype(np.float64)
        out.setflags(write=False)
        return out

    @lru_cache(maxsize=None)
    def _boundary_cell_faces(self):
        """(cell, face) pairs owned by exactly one cell (topological)."""
        keys = {}
        for c in range(self.ncells):
            for fi, (ids, _, _) in enumerate(_FACES):
                key = tuple(sorted(int(self._cells[c, i]) for i in ids))
                keys.setdefault(key, []).append((c, fi))
        return tuple(v[0] for v in keys.values() if len(v) == 1)

    @lru_cache(maxsize=None)
    def boundary_dof_marker(self, P: int) -> np.ndarray:
        dm, ndofs, coords = self._space(P)
        n = P + 1
        dml = dm.reshape(self.ncells, n, n, n)
        on_boundary = np.zeros(ndofs, dtype=bool)
        for c, fi in self._boundary_cell_faces():
            _, axis, end = _FACES[fi]
            sl = [slice(None)] * 3
            sl[axis] = 0 if end == 0 else -1
            on_boundary[dml[c][tuple(sl)].ravel()] = True
        if self._dirichlet is True:
            out = on_boundary
        elif callable(self._dirichlet):
            sel = np.asarray(self._dirichlet(coords.T), dtype=bool)
            out = on_boundary & sel
        elif isinstance(self._dirichlet, (str, list, tuple, set)):
            # Named face groups (Gmsh physical surfaces): mark every
            # boundary face whose corner-node set belongs to one of the
            # selected tagged_faces groups — the tag-driven mixed-BC
            # workflow (unselected groups / untagged faces stay natural).
            names = ([self._dirichlet] if isinstance(self._dirichlet, str)
                     else list(self._dirichlet))
            quads = set()
            for name in names:
                if name not in self.tagged_faces:
                    raise ValueError(
                        f"unknown face group {name!r}; available: "
                        f"{sorted(self.tagged_faces)}")
                for q in self.tagged_faces[name]:
                    quads.add(frozenset(int(v) for v in q))
            out = np.zeros(ndofs, dtype=bool)
            matched = 0
            for c, fi in self._boundary_cell_faces():
                ids, axis, end = _FACES[fi]
                key = frozenset(int(self._cells[c, i]) for i in ids)
                if key not in quads:
                    continue
                matched += 1
                sl = [slice(None)] * 3
                sl[axis] = 0 if end == 0 else -1
                out[dml[c][tuple(sl)].ravel()] = True
            if matched != len(quads):
                raise ValueError(
                    f"{len(quads) - matched} tagged quads match no "
                    "topological boundary face (internal or stale "
                    "surface elements in the mesh file)")
        else:
            raise ValueError("dirichlet must be True, a callable marker, "
                             "or tagged_faces group name(s)")
        if not out.any():
            raise ValueError(
                "no Dirichlet dofs selected: the pure-Neumann operator "
                "is singular (constants in the nullspace)")
        out.setflags(write=False)
        return out

    def __repr__(self):
        return (f"UnstructuredHexMesh({len(self._nodes)} nodes, "
                f"{self.ncells} cells)")


# Gmsh hexahedron (element type 5) corner order -> package order
# (i*2+j)*2+k: gmsh lists (0,0,0),(1,0,0),(1,1,0),(0,1,0),(0,0,1),
# (1,0,1),(1,1,1),(0,1,1) along (x,y,z).
GMSH_HEX_PERM = np.array([0, 4, 3, 7, 1, 5, 2, 6])


def gmsh_corner_permutation(cells_gmsh) -> np.ndarray:
    """Reorder Gmsh-ordered hex connectivity into the package corner
    order."""
    return np.asarray(cells_gmsh)[:, GMSH_HEX_PERM]


def load_hex_mesh_npz(path, dirichlet=True, tol=None) -> UnstructuredHexMesh:
    """Load ``nodes`` (n, 3) float and ``cells`` (ncells, 8) int arrays
    from an ``.npz`` file. Optional key ``corner_order='gmsh'`` (0-d
    string array) marks Gmsh-ordered connectivity."""
    with np.load(path, allow_pickle=False) as z:
        nodes, cells = z["nodes"], z["cells"]
        if "corner_order" in z and str(z["corner_order"]) == "gmsh":
            cells = gmsh_corner_permutation(cells)
    return UnstructuredHexMesh(nodes, cells, dirichlet=dirichlet, tol=tol)


def read_gmsh_hex(path, dirichlet=True, tol=None) -> UnstructuredHexMesh:
    """Minimal Gmsh ASCII reader (v2.2 AND v4.1, Gmsh's current default
    format): ``$Nodes``, the hexahedral elements (type 5) of
    ``$Elements``, and PHYSICAL SURFACE GROUPS — ``$PhysicalNames``
    (dim-2 entries) plus the tagged 4-node quads (type 3) become
    ``mesh.tagged_faces[name]``, so a tagged ``.msh`` drives mixed
    boundary conditions with ``dirichlet=[<group names>]`` and no
    geometric callables (the workflow the reference gets from DOLFINx
    mesh I/O). Node ids may be non-contiguous (renumbered on load)."""
    nodes_raw, elems = {}, []
    phys_names = {}            # (dim, physical tag) -> name
    quads = []                 # (physical tag or None, [4 node ids])
    surf_phys = {}             # v4.1: surface entity tag -> physical tag
    with open(path) as fh:
        lines = iter(fh)
        ver = None
        for line in lines:
            tag = line.strip()
            if tag == "$MeshFormat":
                ver = next(lines).split()[0]
                if not (ver.startswith("2.") or ver.startswith("4.")):
                    raise ValueError(
                        f"only Gmsh ASCII v2.x / v4.x supported, got "
                        f"{ver}")
            elif tag == "$PhysicalNames":
                np_names = int(next(lines))
                for _ in range(np_names):
                    p = next(lines).split(maxsplit=2)
                    phys_names[(int(p[0]), int(p[1]))] = p[2].strip(
                        ).strip('"')
            elif tag == "$Entities":  # v4.1: surface -> physical map
                cnt = [int(v) for v in next(lines).split()]
                npt, ncv, nsf = cnt[0], cnt[1], cnt[2]
                for _ in range(npt):   # points: tag x y z nPhys phys...
                    next(lines)
                for _ in range(ncv):   # curves: tag 6*bbox nPhys ... nB
                    next(lines)
                for _ in range(nsf):
                    p = next(lines).split()
                    nphys = int(p[7])
                    if nphys:
                        surf_phys[int(p[0])] = int(p[8])
            elif tag == "$Nodes" and ver.startswith("2."):
                nn = int(next(lines))
                for _ in range(nn):
                    p = next(lines).split()
                    nodes_raw[int(p[0])] = [float(p[1]), float(p[2]),
                                            float(p[3])]
            elif tag == "$Nodes":  # v4.1: entity blocks
                nblocks = int(next(lines).split()[0])
                for _ in range(nblocks):
                    nb = int(next(lines).split()[3])
                    tags = [int(next(lines)) for _ in range(nb)]
                    for t in tags:
                        p = next(lines).split()
                        nodes_raw[t] = [float(p[0]), float(p[1]),
                                        float(p[2])]
            elif tag == "$Elements" and ver.startswith("2."):
                ne = int(next(lines))
                for _ in range(ne):
                    p = next(lines).split()
                    etype, ntags = int(p[1]), int(p[2])
                    if etype == 5:  # 8-node hexahedron
                        elems.append([int(v) for v in p[3 + ntags:]])
                    elif etype == 3:  # 4-node quad (surface tagging)
                        phys = int(p[3]) if ntags >= 1 else None
                        quads.append((phys, [int(v) for v in
                                             p[3 + ntags:]]))
            elif tag == "$Elements":  # v4.1: entity blocks
                nblocks = int(next(lines).split()[0])
                for _ in range(nblocks):
                    hdr = next(lines).split()
                    etag, etype, nb = int(hdr[1]), int(hdr[2]), int(hdr[3])
                    for _ in range(nb):
                        p = next(lines).split()
                        if etype == 5:
                            elems.append([int(v) for v in p[1:9]])
                        elif etype == 3:
                            quads.append((surf_phys.get(etag),
                                          [int(v) for v in p[1:5]]))
    if not elems:
        raise ValueError(f"no hexahedral (type 5) elements in {path}")
    ids = sorted(nodes_raw)
    renum = {g: i for i, g in enumerate(ids)}
    nodes = np.array([nodes_raw[g] for g in ids])
    cells = np.array([[renum[v] for v in e] for e in elems])
    tagged = {}
    for phys, q in quads:
        if phys is None:
            continue
        name = phys_names.get((2, phys), str(phys))
        tagged.setdefault(name, []).append([renum[v] for v in q])
    tagged = {k: np.asarray(v, dtype=np.int64) for k, v in tagged.items()}
    return UnstructuredHexMesh(nodes, gmsh_corner_permutation(cells),
                               dirichlet=dirichlet, tol=tol,
                               tagged_faces=tagged)


def l_shaped_hex_mesh(n: int, dirichlet=True) -> UnstructuredHexMesh:
    """Demo/test geometry: the extruded L-shape ``([0,2]x[0,1] ∪
    [0,1]x[1,2]) x [0,1]`` with ``3 n^3`` cubic cells of size 1/n — a
    conforming hex mesh whose cell adjacency graph is NOT a box lattice
    (re-entrant edge at (1, 1, z)), i.e. provably outside the
    `BoxMesh`/`PerturbedBoxMesh` family. ``sin(pi x) sin(pi y)
    sin(pi z)`` vanishes on its whole boundary (every boundary face
    lies on an integer plane), making manufactured-solution tests
    one-liners."""
    h = 1.0 / n
    # Candidate (2n, 2n, n) grid; keep cells with cx < n or cy < n.
    nid = {}
    nodes = []

    def node(ix, iy, iz):
        key = (ix, iy, iz)
        if key not in nid:
            nid[key] = len(nodes)
            nodes.append([ix * h, iy * h, iz * h])
        return nid[key]

    cells = []
    for cx in range(2 * n):
        for cy in range(2 * n):
            if cx >= n and cy >= n:
                continue
            for cz in range(n):
                cells.append([
                    node(cx + i, cy + j, cz + k)
                    for i in (0, 1) for j in (0, 1) for k in (0, 1)
                ])
    return UnstructuredHexMesh(np.array(nodes), np.array(cells),
                               dirichlet=dirichlet)
