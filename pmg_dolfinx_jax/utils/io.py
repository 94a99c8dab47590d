"""Solution output: legacy-VTK structured grid and npz writers.

Counterpart of the reference's optional ADIOS2 VTX output
(`--output`, examples/pmg/main.cpp:369-379). The structured lattice maps
directly onto a VTK STRUCTURED_GRID; files open in ParaView/VisIt.
"""

import numpy as np


def write_vtk(path, mesh, P, u, name="u"):
    """Write the dof lattice as an ASCII legacy-VTK structured grid."""
    NX, NY, NZ = mesh.lattice_shape(P)
    coords = mesh.dof_coords(P)
    u = np.asarray(u).reshape(-1)
    assert u.size == NX * NY * NZ
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("pmg_dolfinx_jax solution\nASCII\n")
        f.write("DATASET STRUCTURED_GRID\n")
        # VTK expects x fastest; our lattice is z fastest -> reorder.
        f.write(f"DIMENSIONS {NX} {NY} {NZ}\n")
        f.write(f"POINTS {NX * NY * NZ} double\n")
        pts = coords.reshape(NX, NY, NZ, 3).transpose(2, 1, 0, 3).reshape(-1, 3)
        np.savetxt(f, pts, fmt="%.10g")
        f.write(f"POINT_DATA {NX * NY * NZ}\n")
        f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
        vals = u.reshape(NX, NY, NZ).transpose(2, 1, 0).reshape(-1)
        np.savetxt(f, vals, fmt="%.10g")


def write_npz(path, mesh, P, u, **extra):
    """Write the solution lattice + coordinates to an .npz archive."""
    NX, NY, NZ = mesh.lattice_shape(P)
    np.savez(
        path,
        u=np.asarray(u).reshape(NX, NY, NZ),
        coords=mesh.dof_coords(P).reshape(NX, NY, NZ, 3),
        **extra,
    )
