"""External unstructured-hex mesh ingestion (fem/unstructured.py).

The reference rides DOLFINx and can load any conforming hex mesh
(src/mesh.hpp:17-98); this closes the same generality edge: an
``UnstructuredHexMesh`` built from raw nodes+connectivity (npz / Gmsh
v2.2) drives the host golden assembly and the general PMG operator
backends. Oracles: (1) feeding a BoxMesh's own geometry through the
unstructured loader reproduces its space exactly (matrix equal under the
coordinate-matching permutation), (2) the L-shaped mesh — provably not a
(warped) box: its cell adjacency graph has a re-entrant edge — converges
at the manufactured-solution rate, (3) per-cell ROTATED corner frames
(the orientation headache of topological dofmap builders) change nothing:
the geometric merge is frame-invariant.
"""

import io

import numpy as np
import pytest
from scipy.spatial import cKDTree

from pmg_dolfinx_jax.fem.assembly import (assemble_rhs, assemble_stiffness,
                                          l2_error_collocated)
from pmg_dolfinx_jax.fem.mesh import BoxMesh
from pmg_dolfinx_jax.fem.unstructured import (UnstructuredHexMesh,
                                              gmsh_corner_permutation,
                                              l_shaped_hex_mesh,
                                              load_hex_mesh_npz,
                                              read_gmsh_hex)
from pmg_dolfinx_jax.solvers.pmg import PMGHierarchy

PI = np.pi


def _u_exact(x):
    return np.sin(PI * x[0]) * np.sin(PI * x[1]) * np.sin(PI * x[2])


def _f_rhs(x):
    return 3.0 * PI**2 * _u_exact(x)


def _perm_for_rotation(rot):
    """Corner permutation for a cube rotation: perm[new_local] =
    old_local at the rotated position."""
    def idx(p):
        return (p[0] * 2 + p[1]) * 2 + p[2]

    perm = np.empty(8, dtype=int)
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                perm[idx((i, j, k))] = idx(rot((i, j, k)))
    return perm


ROTATIONS = (
    lambda p: p,                                   # identity
    lambda p: (1 - p[1], p[0], p[2]),              # 90 deg about z
    lambda p: (p[0], 1 - p[2], p[1]),              # 90 deg about x
    lambda p: (p[2], p[1], 1 - p[0]),              # 90 deg about y
)


def test_box_geometry_roundtrip_exact():
    """A BoxMesh's own Q1 geometry fed through the unstructured loader
    rebuilds the identical space: same ndofs/marker/multiplicity and a
    permutation-equal stiffness matrix (geometric dedup == the
    structured lattice numbering)."""
    bm = BoxMesh((2, 3, 2))
    um = UnstructuredHexMesh(bm.geometry_x, bm.geometry_dofmap)
    P = 3
    assert um.num_dofs(P) == bm.num_dofs(P)
    d, idx = cKDTree(bm.dof_coords(P)).query(um.dof_coords(P))
    assert d.max() < 1e-12
    Ab = assemble_stiffness(bm, P, kappa=2.0).toarray()
    Au = assemble_stiffness(um, P, kappa=2.0).toarray()
    assert np.abs(Au - Ab[np.ix_(idx, idx)]).max() < 1e-14
    assert np.array_equal(um.boundary_dof_marker(P),
                          bm.boundary_dof_marker(P)[idx])
    assert np.array_equal(um.dof_multiplicity(P),
                          bm.dof_multiplicity(P)[idx])


def test_l_shape_manufactured_convergence():
    """p-MG (dofmap backend) on the L-shaped extrusion: O(h^{P+1}) L2
    convergence of the manufactured solution — the 'provably not a
    warped box' gate. Also cross-checks the csr backend trajectory."""
    P = 2
    errs = []
    for n in (2, 4):
        mesh = l_shaped_hex_mesh(n)
        b = assemble_rhs(mesh, P, _f_rhs)
        hier = PMGHierarchy(mesh, degrees=(1, P), kappa=1.0,
                            coarse="direct", operator="dofmap")
        u, niter = hier.solve_pcg(b, rtol=1e-10)
        assert niter <= 12
        errs.append(l2_error_collocated(mesh, P, np.asarray(u), _u_exact))
    rate = np.log2(errs[0] / errs[1])
    assert rate > P + 0.5, (errs, rate)
    # csr backend on the same unstructured mesh: identical iterations.
    hc = PMGHierarchy(mesh, degrees=(1, P), kappa=1.0,
                      coarse="direct", operator="csr")
    uc, nc_ = hc.solve_pcg(b, rtol=1e-10)
    assert nc_ == niter
    assert np.linalg.norm(np.asarray(uc) - np.asarray(u)) < \
        1e-9 * np.linalg.norm(np.asarray(u))


def test_rotated_corner_frames_are_equivalent():
    """Randomly rotating every cell's local corner frame (valid
    orientation-preserving relabelings) leaves the discrete problem
    unchanged: same solve answer at matched coordinates. This is the
    orientation-consistency property topological dofmap builders buy
    with edge/face machinery; the geometric merge gets it for free."""
    P = 3
    base = l_shaped_hex_mesh(2)
    rng = np.random.default_rng(11)
    cells = base.geometry_dofmap.copy()
    perms = [_perm_for_rotation(r) for r in ROTATIONS]
    for c in range(len(cells)):
        cells[c] = cells[c][perms[rng.integers(len(perms))]]
    rot = UnstructuredHexMesh(base.geometry_x, cells)
    assert rot.num_dofs(P) == base.num_dofs(P)

    out = []
    for mesh in (base, rot):
        b = assemble_rhs(mesh, P, _f_rhs)
        hier = PMGHierarchy(mesh, degrees=(1, P), kappa=1.0,
                            coarse="direct", operator="dofmap")
        u, _ = hier.solve_pcg(b, rtol=1e-11)
        out.append((mesh.dof_coords(P), np.asarray(u)))
    (cb, ub), (cr, ur) = out
    d, idx = cKDTree(cb).query(cr)
    assert d.max() < 1e-12
    assert np.linalg.norm(ur - ub[idx]) < 1e-9 * np.linalg.norm(ub)


def test_npz_roundtrip(tmp_path):
    mesh = l_shaped_hex_mesh(2)
    path = tmp_path / "l.npz"
    np.savez(path, nodes=mesh.geometry_x, cells=mesh.geometry_dofmap)
    loaded = load_hex_mesh_npz(path)
    P = 2
    assert loaded.num_dofs(P) == mesh.num_dofs(P)
    A0 = assemble_stiffness(mesh, P).toarray()
    A1 = assemble_stiffness(loaded, P).toarray()
    assert np.abs(A1 - A0).max() < 1e-14
    # gmsh corner_order marker applies the permutation on load
    inv = np.argsort(np.array([0, 4, 3, 7, 1, 5, 2, 6]))
    np.savez(tmp_path / "g.npz", nodes=mesh.geometry_x,
             cells=mesh.geometry_dofmap[:, inv],
             corner_order=np.array("gmsh"))
    lg = load_hex_mesh_npz(tmp_path / "g.npz")
    assert np.abs(assemble_stiffness(lg, P).toarray() - A0).max() < 1e-14


def test_gmsh_reader(tmp_path):
    """Minimal Gmsh ASCII v2.2: two unit hexes sharing a face, gmsh
    corner ordering, 1-based non-contiguous node ids, extra non-hex
    elements skipped — matches BoxMesh((2,1,1)) assembly exactly."""
    bm = BoxMesh((2, 1, 1), extent=(2.0, 1.0, 1.0))
    # gmsh corner order from package order:
    inv = np.argsort(np.array([0, 4, 3, 7, 1, 5, 2, 6]))
    nodes = bm.geometry_x
    cells_g = bm.geometry_dofmap[:, inv]
    buf = io.StringIO()
    buf.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n")
    buf.write(f"{len(nodes)}\n")
    for i, p in enumerate(nodes):
        buf.write(f"{i + 10} {p[0]} {p[1]} {p[2]}\n")  # ids offset by 10
    buf.write("$EndNodes\n$Elements\n3\n")
    buf.write("1 15 2 0 1 10\n")  # a point element: must be skipped
    for e, cell in enumerate(cells_g):
        verts = " ".join(str(v + 10) for v in cell)
        buf.write(f"{e + 2} 5 2 0 1 {verts}\n")
    buf.write("$EndElements\n")
    path = tmp_path / "two.msh"
    path.write_text(buf.getvalue())

    gm = read_gmsh_hex(path)
    P = 3
    assert gm.num_dofs(P) == bm.num_dofs(P)
    d, idx = cKDTree(bm.dof_coords(P)).query(gm.dof_coords(P))
    assert d.max() < 1e-12
    Ab = assemble_stiffness(bm, P, kappa=1.5).toarray()
    Ag = assemble_stiffness(gm, P, kappa=1.5).toarray()
    assert np.abs(Ag - Ab[np.ix_(idx, idx)]).max() < 1e-14


def test_mixed_dirichlet_marker_and_guards():
    """Callable dirichlet markers select boundary subsets; inverted
    cells, hanging interfaces (tolerance ambiguity), and pure-Neumann
    configurations are rejected loudly."""
    mesh = l_shaped_hex_mesh(2, dirichlet=lambda x: x[2] < 0.5)
    P = 2
    m = mesh.boundary_dof_marker(P)
    c = mesh.dof_coords(P)
    assert m.any() and not m[c[:, 2] > 0.5].any()
    # z=0 plane fully marked, z=1 plane not
    assert m[np.abs(c[:, 2]) < 1e-12].all()
    assert not m[np.abs(c[:, 2] - 1.0) < 1e-12].any()

    # inverted cell: swap two x-planes of corners -> negative Jacobian
    bm = BoxMesh((1, 1, 1))
    bad = bm.geometry_dofmap.copy()
    bad[0] = bad[0][[4, 5, 6, 7, 0, 1, 2, 3]]
    with pytest.raises(ValueError, match="Jacobian"):
        UnstructuredHexMesh(bm.geometry_x, bad)

    # pure Neumann rejected
    with pytest.raises(ValueError, match="Neumann"):
        l_shaped_hex_mesh(2, dirichlet=lambda x: x[0] > 99.0) \
            .boundary_dof_marker(2)

    # shape validation
    with pytest.raises(ValueError, match="cells"):
        UnstructuredHexMesh(bm.geometry_x, np.zeros((1, 6), dtype=int))


def test_variable_kappa_and_sigma_on_unstructured():
    """Per-cell DG-0 kappa + sigma shift ride the dofmap backend on the
    L-mesh; answer pinned against the assembled scipy system."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from pmg_dolfinx_jax.fem.assembly import lumped_mass_np

    mesh = l_shaped_hex_mesh(2)
    P, sigma = 2, 3.0
    rng = np.random.default_rng(4)
    kap = 1.0 + rng.random(mesh.ncells)
    b = assemble_rhs(mesh, P, _f_rhs)
    hier = PMGHierarchy(mesh, degrees=(1, P), kappa=kap, sigma=sigma,
                        coarse="direct", operator="dofmap")
    u, _ = hier.solve_pcg(b, rtol=1e-12)
    A = (assemble_stiffness(mesh, P, kappa=kap).tocsr()
         + sigma * sp.diags(lumped_mass_np(mesh, P, bc_zero=True)))
    ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(np.asarray(u) - ref) < 1e-8 * np.linalg.norm(ref)


def test_gmsh_v41_reader(tmp_path):
    """Gmsh ASCII v4.1 (entity-block format, the current Gmsh default):
    same two-hex mesh as the v2.2 test, with nodes split across entity
    blocks and a skipped point element — matches BoxMesh assembly."""
    bm = BoxMesh((2, 1, 1), extent=(2.0, 1.0, 1.0))
    inv = np.argsort(np.array([0, 4, 3, 7, 1, 5, 2, 6]))
    nodes = bm.geometry_x
    cells_g = bm.geometry_dofmap[:, inv]
    buf = io.StringIO()
    buf.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n$Nodes\n")
    # two entity blocks, ids offset by 5, non-contiguous
    n0 = len(nodes) // 2
    buf.write(f"2 {len(nodes)} 5 {len(nodes) + 4}\n")
    buf.write(f"3 1 0 {n0}\n")
    for i in range(n0):
        buf.write(f"{i + 5}\n")
    for i in range(n0):
        p = nodes[i]
        buf.write(f"{p[0]} {p[1]} {p[2]}\n")
    buf.write(f"3 2 0 {len(nodes) - n0}\n")
    for i in range(n0, len(nodes)):
        buf.write(f"{i + 5}\n")
    for i in range(n0, len(nodes)):
        p = nodes[i]
        buf.write(f"{p[0]} {p[1]} {p[2]}\n")
    buf.write("$EndNodes\n$Elements\n")
    buf.write(f"2 {len(cells_g) + 1} 1 {len(cells_g) + 1}\n")
    buf.write("0 1 15 1\n1 5\n")  # a point element block: skipped
    buf.write(f"3 1 5 {len(cells_g)}\n")
    for e, cell in enumerate(cells_g):
        verts = " ".join(str(v + 5) for v in cell)
        buf.write(f"{e + 2} {verts}\n")
    buf.write("$EndElements\n")
    path = tmp_path / "two41.msh"
    path.write_text(buf.getvalue())

    gm = read_gmsh_hex(path)
    P = 3
    assert gm.num_dofs(P) == bm.num_dofs(P)
    d, idx = cKDTree(bm.dof_coords(P)).query(gm.dof_coords(P))
    assert d.max() < 1e-12
    Ab = assemble_stiffness(bm, P, kappa=1.5).toarray()
    Ag = assemble_stiffness(gm, P, kappa=1.5).toarray()
    assert np.abs(Ag - Ab[np.ix_(idx, idx)]).max() < 1e-14


def _lshape_msh_text(n, version):
    """Serialize the L-shape as a Gmsh ASCII file with two physical
    surface groups: 'bottom' (z=0 faces) and 'top' (z=1 faces)."""
    from pmg_dolfinx_jax.fem.unstructured import (GMSH_HEX_PERM,
                                                  l_shaped_hex_mesh)

    mesh = l_shaped_hex_mesh(n)
    nodes = mesh.geometry_x
    cells = np.asarray(mesh.geometry_dofmap)
    cells_gmsh = cells[:, np.argsort(GMSH_HEX_PERM)]
    quads = {1: [], 2: []}  # phys tag -> corner quads
    from pmg_dolfinx_jax.fem.unstructured import _FACES

    for c, fi in mesh._boundary_cell_faces():
        ids, _, _ = _FACES[fi]
        q = [int(cells[c, i]) for i in ids]
        z = nodes[q, 2]
        if np.allclose(z, 0.0):
            quads[1].append(q)
        elif np.allclose(z, 1.0):
            quads[2].append(q)
    if version == "2.2":
        out = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat",
               "$PhysicalNames", "2", '2 1 "bottom"', '2 2 "top"',
               "$EndPhysicalNames", "$Nodes", str(len(nodes))]
        for i, p in enumerate(nodes):
            out.append(f"{i+1} {p[0]} {p[1]} {p[2]}")
        out += ["$EndNodes", "$Elements",
                str(sum(len(v) for v in quads.values()) + len(cells))]
        eid = 1
        for phys, qs in quads.items():
            for q in qs:
                out.append(f"{eid} 3 2 {phys} {10+phys} "
                           + " ".join(str(v + 1) for v in q))
                eid += 1
        for e in cells_gmsh:
            out.append(f"{eid} 5 2 0 1 "
                       + " ".join(str(v + 1) for v in e))
            eid += 1
        out.append("$EndElements")
    else:  # 4.1
        nq1, nq2, nc = len(quads[1]), len(quads[2]), len(cells)
        out = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat",
               "$PhysicalNames", "2", '2 1 "bottom"', '2 2 "top"',
               "$EndPhysicalNames", "$Entities", "0 0 2 1",
               "11 0 0 0 2 2 1 1 1 0",
               "12 0 0 0 2 2 1 1 2 0",
               "1 0 0 0 2 2 1 0 0",
               "$EndEntities", "$Nodes",
               f"1 {len(nodes)} 1 {len(nodes)}",
               f"3 1 0 {len(nodes)}"]
        out += [str(i + 1) for i in range(len(nodes))]
        out += [f"{p[0]} {p[1]} {p[2]}" for p in nodes]
        out += ["$EndNodes", "$Elements",
                f"3 {nq1+nq2+nc} 1 {nq1+nq2+nc}"]
        eid = 1
        for etag, qs in ((11, quads[1]), (12, quads[2])):
            out.append(f"2 {etag} 3 {len(qs)}")
            for q in qs:
                out.append(f"{eid} " + " ".join(str(v + 1) for v in q))
                eid += 1
        out.append(f"3 1 5 {nc}")
        for e in cells_gmsh:
            out.append(f"{eid} " + " ".join(str(v + 1) for v in e))
            eid += 1
        out.append("$EndElements")
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("version", ["2.2", "4.1"])
def test_gmsh_physical_groups_drive_mixed_bc(tmp_path, version):
    """A tagged .msh drives mixed BCs with no geometric callables
    (VERDICT r4 item 7): dirichlet=['bottom','top'] reproduces the
    geometric z-plane marker exactly, single groups subset it, and the
    tagged groups parse under both ASCII formats."""
    from pmg_dolfinx_jax.fem.unstructured import (l_shaped_hex_mesh,
                                                  read_gmsh_hex)

    path = tmp_path / f"lshape_{version}.msh"
    path.write_text(_lshape_msh_text(2, version))
    mesh = read_gmsh_hex(str(path), dirichlet=["bottom", "top"])
    assert set(mesh.tagged_faces) == {"bottom", "top"}
    ref = l_shaped_hex_mesh(
        2, dirichlet=lambda x: (x[2] < 1e-12) | (x[2] > 1 - 1e-12))
    P = 2
    # identical geometry => identical numbering; markers must agree
    np.testing.assert_array_equal(mesh.boundary_dof_marker(P),
                                  ref.boundary_dof_marker(P))
    only_bottom = read_gmsh_hex(str(path), dirichlet="bottom")
    mb = only_bottom.boundary_dof_marker(P)
    assert mb.sum() < mesh.boundary_dof_marker(P).sum()
    c = only_bottom.dof_coords(P)
    assert np.allclose(c[mb][:, 2], 0.0)

    with pytest.raises(ValueError, match="unknown face group"):
        read_gmsh_hex(str(path),
                      dirichlet="sides").boundary_dof_marker(P)


def test_tagged_faces_internal_quad_rejected():
    from pmg_dolfinx_jax.fem.unstructured import (UnstructuredHexMesh,
                                                  l_shaped_hex_mesh)

    base = l_shaped_hex_mesh(2)
    cells = np.asarray(base.geometry_dofmap)
    # an interior face: shared between two cells -> not topological bdry
    from pmg_dolfinx_jax.fem.unstructured import _FACES

    keys = {}
    for c in range(base.ncells):
        for fi, (ids, _, _) in enumerate(_FACES):
            key = tuple(sorted(int(cells[c, i]) for i in ids))
            keys.setdefault(key, []).append((c, fi))
    internal = next(k for k, v in keys.items() if len(v) == 2)
    mesh = UnstructuredHexMesh(
        base.geometry_x, cells, dirichlet="bad",
        tagged_faces={"bad": np.asarray([list(internal)])})
    with pytest.raises(ValueError, match="no topological boundary"):
        mesh.boundary_dof_marker(2)
