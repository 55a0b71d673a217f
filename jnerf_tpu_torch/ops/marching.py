"""Iso-surface extraction: field sampling, marching tetrahedra, PLY output.

Counterpart of `jnerf_tpu/ops/marching.py`:

- ``extract_fields``: a scalar field on an N^3 grid, evaluated on the
  caller's device in x-slabs (the points of each slab are built there);
  ``query_func`` takes [M, 3] and returns [M], tensors on that device.
- ``marching_tetrahedra``: each cube splits into 6 tetrahedra; the
  16-case tet table is derived by enumeration.  The C++ core
  (`jnerf_tpu_torch.native`) or the vectorized numpy path, which give the
  same mesh; vertices are welded at the same 1e-5 rounding.
- ``largest_component`` (scipy) and ``write_ply`` (binary PLY), byte for
  byte the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from jnerf_tpu_torch import native

# Points a query_func call receives at most: bounds the device memory of a
# full-width MLP's activations (2^21 rows x 256 f32 = 2 GiB a layer).
QUERY_ROWS = 1 << 21


# 6 tetrahedra per cube, as corner indices into the cube's 8 corners
# (corner c has offsets ((c>>0)&1, (c>>1)&1, (c>>2)&1) in x,y,z).  This is
# the standard diagonal decomposition through corners 0 and 7.
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    np.int64,
)
_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
)
# Tet edges as (vertex, vertex) index pairs.
_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _build_tet_cases():
    """For each of the 16 inside-masks, the triangles as edge-index triples.

    Derived by enumeration: 1 or 3 vertices inside -> one triangle on the
    three edges from the odd vertex; 2 inside -> a quad (two triangles) on
    the four crossing edges.
    """
    edge_of = {e: i for i, e in enumerate(_EDGES)}

    def edge(a, b):
        return edge_of[(a, b) if a < b else (b, a)]

    cases = []
    for mask in range(16):
        inside = [v for v in range(4) if mask & (1 << v)]
        outside = [v for v in range(4) if v not in inside]
        tris = []
        if len(inside) == 1:
            a = inside[0]
            b, c, d = outside
            tris = [(edge(a, b), edge(a, c), edge(a, d))]
        elif len(inside) == 3:
            a = outside[0]
            b, c, d = inside
            tris = [(edge(a, b), edge(a, d), edge(a, c))]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            e1, e2, e3, e4 = edge(a, c), edge(a, d), edge(b, d), edge(b, c)
            tris = [(e1, e2, e3), (e1, e3, e4)]
        cases.append(tris)
    return cases


_TET_CASES = _build_tet_cases()


def marching_tetrahedra(field: np.ndarray, threshold: float = 0.0,
                        use_native: bool = True):
    """Extract the iso-surface ``field == threshold`` from an [X, Y, Z] grid.

    Returns (vertices [V, 3] in grid-index coordinates, triangles [T, 3]).
    ``use_native`` runs the C++ core (`jnerf_tpu_torch.native`; a failed
    build raises); ``use_native=False`` runs the vectorized numpy path,
    which materializes per-cell corner tables and suits small grids.
    Both give the same vertex set and triangles, in another order.
    """
    if isinstance(field, torch.Tensor):
        field = field.detach().cpu().numpy()
    field = np.asarray(field, np.float32)
    if use_native:
        return native.marching_tets_native(field, threshold)
    nx, ny, nz = field.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    if min(cx, cy, cz) < 1:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # Cell base coordinates, flattened.
    bx, by, bz = np.meshgrid(
        np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij"
    )
    base = np.stack([bx.ravel(), by.ravel(), bz.ravel()], axis=-1)  # [C, 3]

    # Corner values per cell: [C, 8]
    corner_vals = np.empty((base.shape[0], 8), np.float32)
    for c in range(8):
        o = _CORNER_OFFSETS[c]
        corner_vals[:, c] = field[
            o[0] : o[0] + cx, o[1] : o[1] + cy, o[2] : o[2] + cz
        ].ravel()

    verts_out = []
    for tet in _TETS:
        vals = corner_vals[:, tet]  # [C, 4]
        pos = base[:, None, :] + _CORNER_OFFSETS[tet][None, :, :]  # [C, 4, 3]
        inside = vals > threshold
        mask_id = (
            inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4 + inside[:, 3] * 8
        )
        for case in range(1, 15):
            sel = np.nonzero(mask_id == case)[0]
            if sel.size == 0:
                continue
            v_sel = vals[sel]
            p_sel = pos[sel].astype(np.float32)
            # Interpolated crossing point per edge.
            edge_pts = {}
            for ei, (a, b) in enumerate(_EDGES):
                va, vb = v_sel[:, a], v_sel[:, b]
                denom = vb - va
                safe = np.where(np.abs(denom) > 1e-12, denom, 1.0)
                t = np.where(np.abs(denom) > 1e-12, (threshold - va) / safe, 0.5)
                t = np.clip(t, 0.0, 1.0)
                edge_pts[ei] = p_sel[:, a] + t[:, None] * (p_sel[:, b] - p_sel[:, a])
            for tri in _TET_CASES[case]:
                tri_pts = np.stack([edge_pts[e] for e in tri], axis=1)  # [S, 3, 3]
                verts_out.append(tri_pts.reshape(-1, 3))

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    # Triangles are consecutive vertex triples: weld the soup.
    return native.weld(np.concatenate(verts_out, axis=0))


def extract_fields(bound_min, bound_max, resolution, query_func, chunk=64,
                   device="cuda"):
    """Evaluate ``query_func`` over an N^3 grid spanning [bound_min,
    bound_max] -> numpy [N, N, N] f32, x-slabs of ``chunk`` rows at a time
    (`renderer.py:11-26`).  The grid's axes are numpy's f32 linspace, so
    the points are the JAX package's."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    axes = [torch.from_numpy(np.linspace(bound_min[d], bound_max[d],
                                         resolution, dtype=np.float32))
            .to(device) for d in range(3)]
    u = np.zeros((resolution, resolution, resolution), np.float32)
    for x0 in range(0, resolution, chunk):
        xc = axes[0][x0:x0 + chunk]
        gx, gy, gz = torch.meshgrid(xc, axes[1], axes[2], indexing="ij")
        pts = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
        vals = torch.cat([query_func(pts[i:i + QUERY_ROWS]).reshape(-1)
                          for i in range(0, pts.shape[0], QUERY_ROWS)])
        u[x0:x0 + len(xc)] = vals.float().cpu().numpy().reshape(
            len(xc), resolution, resolution)
    return u


def extract_geometry(bound_min, bound_max, resolution, threshold, query_func,
                     device="cuda", use_native=True):
    """Field -> world-space mesh (vertices [V, 3], triangles [T, 3])
    (`renderer.py:29-37`)."""
    u = extract_fields(bound_min, bound_max, resolution, query_func,
                       device=device)
    vertices, triangles = marching_tetrahedra(u, threshold, use_native)
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    vertices = vertices / (resolution - 1.0) * (bound_max - bound_min)[None, :] \
        + bound_min[None, :]
    return vertices, triangles


def largest_component(vertices, triangles):
    """Keep only the largest connected triangle cluster (replaces open3d's
    cluster_connected_triangles in `tools/extract_mesh.py:92-97`)."""
    if len(triangles) == 0:
        return vertices, triangles
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(vertices)
    rows = np.concatenate([triangles[:, 0], triangles[:, 1], triangles[:, 2]])
    cols = np.concatenate([triangles[:, 1], triangles[:, 2], triangles[:, 0]])
    adj = coo_matrix((np.ones_like(rows), (rows, cols)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    counts = np.bincount(labels)
    keep_label = np.argmax(counts)
    tri_keep = labels[triangles[:, 0]] == keep_label
    triangles = triangles[tri_keep]
    used = np.unique(triangles)
    remap = -np.ones(n, np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[triangles]


def write_ply(path, vertices, triangles, colors=None):
    """Minimal binary-little-endian PLY writer (replaces plyfile/trimesh)."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.int32)
    has_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(v)}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {len(t)}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            c = (np.clip(np.asarray(colors), 0, 1) * 255 + 0.5).astype(np.uint8)
            rec = np.zeros(len(v), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = v
            rec["rgb"] = c
            f.write(rec.tobytes())
        else:
            f.write(v.tobytes())
        face = np.zeros(len(t), dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        face["n"] = 3
        face["idx"] = t
        f.write(face.tobytes())
    return path
