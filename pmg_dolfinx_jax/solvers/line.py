"""Line-relaxation preconditioner for strongly anisotropic problems.

The third classic geometric-MG anisotropy remedy, after Krylov
wrapping (solve_pcg) and h-MG semi-coarsening (solvers/hmg.py): relax
whole LINES of dofs along the strongly-coupled axis simultaneously, so
the smoother damps the high-frequency error components that point
Jacobi is blind to when one axis dominates (k_a/h_a^2 anisotropy from
a tensor coefficient and/or stretched cells). Used as the per-level
preconditioner inside the fourth-kind Chebyshev smoother of the h-MG
hierarchy: measured on diag(1,1,64)-type problems it takes the V-cycle
contraction rate from ~0.85 (point Jacobi, isotropic coarsening) to
~0.06 per cycle — including PER-CELL variable anisotropy where the FDM
direct solver does not apply. The reference has no line smoothers; its
answer to anisotropy is hypre BoomerAMG's strength-of-connection
coarsening at the p=1 level (src/amg.hpp:11-119) — this module plus
`semicoarsen_sizes` are the geometric replacements.

Design: a line solve is usually a sequential Thomas sweep — one
dependent step per node. Instead, the per-line banded
blocks (half-bandwidth P along the line) are extracted from the
assembled p-level matrix at SETUP (host, f64, the h-levels are coarse)
and inverted; the runtime preconditioner application is then ONE
batched dense matvec ``einsum('lij,lj->li')`` over all lines — no
sequential dependence and no scatter/gather. Memory
is ``nlines * n^2`` floats, negligible at coarse-level sizes (the
builders fail fast past `LINE_BLOCK_DOF_LIMIT`).
"""

import numpy as np

# Cap on line_inv floats (= ndofs * line length): the dense blocks are
# the smoother's dominant device memory (f32: 2e8 = 800 MB) and the
# setup inverts ndofs/n blocks of (n, n) on host. In practice SETUP is
# the binding constraint before this cap: the blocks are extracted from
# the assembled global matrix, ndofs*(2P+1)^3 nonzeros — fine through
# ~500k dofs at p=3 (1.7e8 nnz) or ~2M at p=1 h-levels, hopeless at
# p=6/2M+. Production large-N problems keep line smoothing to the
# coarse p-levels / h-MG levels (which is where it pays anyway).
LINE_BLOCK_DOF_LIMIT = 200_000_000


def line_block_inverses(mesh, P, kappa, axis, sigma=0.0):
    """Dense inverses of the within-line blocks of the assembled
    operator: ``(nlines, n, n)`` with ``n = lattice_shape[axis]``.

    Two dofs are in one line iff their lattice indices differ only
    along ``axis``; the block is the restriction of the full bc-applied
    stiffness (+ ``sigma`` lumped-mass shift) to that line — banded
    with half-bandwidth P, inverted densely (host, f64). The bc rows
    AND columns of the assembled matrix are zeroed with unit diagonal,
    so boundary dofs stay exactly decoupled through the inverse (the
    same invariant the point-Jacobi ``diag_inv`` preserves).
    """
    import scipy.sparse as sp

    from ..fem.assembly import assemble_stiffness, lumped_mass_np

    # Size guard FIRST: it needs only the lattice shape, and the global
    # assembly below is exactly the cost an oversized config must not pay.
    shape = mesh.lattice_shape(P)
    N = int(np.prod(shape))
    n = shape[axis]
    if N * n > LINE_BLOCK_DOF_LIMIT:
        raise ValueError(
            f"line smoother blocks would hold {N * n} floats "
            f"({N} dofs x line length {n}) > {LINE_BLOCK_DOF_LIMIT}; "
            "keep line relaxation to the coarse p-levels / h-MG levels "
            "at this size"
        )
    A = assemble_stiffness(mesh, P, kappa=kappa).tocsr()
    if sigma:
        A = (A + sp.diags(sigma * lumped_mass_np(mesh, P, bc_zero=True))
             ).tocsr()
    # Permute dofs so `axis` is fastest: lines become contiguous and the
    # blocks are the size-n diagonal blocks of the permuted matrix —
    # extracted in one vectorized pass over the COO entries whose row
    # and column fall in the same line (the per-line CSR slicing loop
    # was ~10x slower at 500k dofs).
    order = np.moveaxis(np.arange(N).reshape(shape), axis, -1).ravel()
    Ap = A[order][:, order].tocoo()
    same_line = (Ap.row // n) == (Ap.col // n)
    r, c, v = Ap.row[same_line], Ap.col[same_line], Ap.data[same_line]
    blocks = np.zeros((N // n, n, n))
    blocks[r // n, r % n, c % n] = v
    return np.linalg.inv(blocks)


def line_precond_apply(line_inv, r, shape, axis):
    """Apply the line preconditioner ``r -> T^-1 r`` (jit-traceable).

    ``r`` may be flat or lattice-shaped; the result keeps its shape.
    ``line_inv`` may carry any leading shape (flat ``(nlines, n, n)`` or
    the grid layout's per-axis lead dims) as long as it flattens to the
    line-lex order of ``moveaxis(r, axis, -1)``. One batched dense
    matvec over all lines, no sequential sweep.
    """
    import jax.numpy as jnp

    rm = jnp.moveaxis(r.reshape(shape), axis, -1)
    mshape = rm.shape
    n = mshape[-1]
    y = jnp.einsum(
        "lij,lj->li", line_inv.reshape(-1, n, n), rm.reshape(-1, n),
        precision="highest",
    )
    return jnp.moveaxis(y.reshape(mshape), -1, axis).reshape(r.shape)


def shard_line_blocks(blocks, gshape, axis, starts_per_lead):
    """Global ``(nlines, n, n)`` block inverses -> the duplicated-plane
    lead layout of a sharded class (the single definition for the four
    distributed call sites: DistPMG/GridPMG p-levels, build_hmg_dist and
    the grid h-MG scaffold).

    ``gshape`` is the GLOBAL lattice shape; the blocks' lead dims are
    the two non-line axes in order. ``starts_per_lead`` gives, per lead
    axis, either ``None`` (unsharded: keep global) or ``(starts, npl)``
    — each shard's ``npl`` planes starting at ``starts[s]`` (interface
    planes appear on BOTH shards, so duplicated lines hold identical
    blocks and the "duplicates equal" invariant is preserved).
    """
    n = gshape[axis]
    lead = tuple(gshape[a] for a in range(3) if a != axis)
    blocks = np.asarray(blocks).reshape(lead + (n, n))
    for i, sp in enumerate(starts_per_lead):
        if sp is None:
            continue
        starts, npl = sp
        blocks = np.concatenate(
            [np.take(blocks, range(x0, x0 + npl), axis=i)
             for x0 in starts],
            axis=i,
        )
    return blocks


def parse_line_smoother(smoother, mesh, kappa, allowed=None):
    """Resolve a builder ``smoother`` spec to a line axis (or None).

    'cheb' -> None (point-Jacobi Chebyshev, the default);
    'line' -> auto: the axis with the strongest effective coupling
    ``mean(kappa_aa)/h_a^2`` (the `semicoarsen_axes` metric — tensor
    diagonal AND stretched cells both count);
    'line-x' / 'line-y' / 'line-z' -> that axis.

    ``allowed`` (sharded classes: the unsharded axes) only affects
    auto mode TIE-BREAKING: among axes whose coupling ties the maximum
    (isotropic problems), prefer an allowed one instead of erroring on
    the arbitrary argmax. A strictly strongest disallowed axis is still
    returned — the caller's layout error is the right answer there
    (auto silently picking a weaker axis would break the
    single-vs-sharded trajectory contract).
    """
    if smoother in (None, "cheb"):
        return None
    if smoother == "line":
        from .hmg import axis_coupling

        c = axis_coupling(mesh, kappa)
        best = int(np.argmax(c))
        if allowed is not None and best not in allowed:
            ties = [a for a in allowed if c[a] == c[best]]
            if ties:
                return ties[0]
        return best
    if smoother in ("line-x", "line-y", "line-z"):
        return "xyz".index(smoother[-1])
    raise ValueError(
        f"unknown hmg smoother {smoother!r}: expected 'cheb', 'line' "
        "or 'line-x'/'line-y'/'line-z'"
    )
