"""Reference (Jittor/JNeRF) checkpoint interop helpers.

A copy of `jnerf_tpu/utils/convert_ckpt.py` (that package imports JAX);
numpy only.  An imported reference hash table reads right only through
``hash_indexing='xor'``, which the port's HashEncoder now serves.

The reference's `params.pkl` (`runner.py:123-131`) stores:

- ``sampler``: the density grid flat in MORTON order per cascade
  (`ray_sampler_header.h:642-667`) and the occupancy bitfield packed 8
  cells/byte; our state is dense ``[C, G, G, G]`` in linear (x, y, z) order;
- ``model``: the hash table as one flat fp16 vector (feature-interleaved —
  identical to our ``[n_entries, 2]`` flattened) and MLP weights either as
  plain Linears or as the FMLP's single concatenated-transposed vector
  (`fully_fused_mlp.py:23-43`).

These converters translate grid/bitfield/hash-table state both ways.  MLP
weight transfer additionally needs the density-input permutation (our
encoder emits feature-major [f0 levels..., f1 levels...] vs the reference's
level-major interleave) — `density_input_permutation` provides it.
"""

from __future__ import annotations

import numpy as np


def expand_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(x, y, z):
    """Interleave 10-bit coords -> 30-bit morton code (`:651-657`)."""
    return expand_bits(np.asarray(x)) | (expand_bits(np.asarray(y)) << 1) | (
        expand_bits(np.asarray(z)) << 2
    )


def morton3d_invert(code) -> np.ndarray:
    x = np.asarray(code).astype(np.uint32) & np.uint32(0x49249249)
    x = (x | (x >> 2)) & np.uint32(0xC30C30C3)
    x = (x | (x >> 4)) & np.uint32(0x0F00F00F)
    x = (x | (x >> 8)) & np.uint32(0xFF0000FF)
    x = (x | (x >> 16)) & np.uint32(0x0000FFFF)
    return x


def _morton_to_linear_perm(g: int) -> np.ndarray:
    """perm[morton_idx] = linear idx (x-major: x*g*g + y*g + z)."""
    codes = np.arange(g ** 3, dtype=np.uint32)
    x = morton3d_invert(codes)
    y = morton3d_invert(codes >> np.uint32(1))
    z = morton3d_invert(codes >> np.uint32(2))
    return (x.astype(np.int64) * g + y) * g + z


def density_grid_from_reference(flat_morton: np.ndarray, n_cascades: int,
                                g: int = 128) -> np.ndarray:
    """Reference flat morton [C*G^3] -> our [C, G, G, G] linear grid."""
    out = np.empty((n_cascades, g, g, g), np.float32)
    perm = _morton_to_linear_perm(g)
    for c in range(n_cascades):
        level = flat_morton[c * g ** 3 : (c + 1) * g ** 3]
        dest = np.empty(g ** 3, np.float32)
        dest[perm] = level
        out[c] = dest.reshape(g, g, g)
    return out


def density_grid_to_reference(grid: np.ndarray) -> np.ndarray:
    """Our [C, G, G, G] -> reference flat morton [C*G^3]."""
    c, g = grid.shape[0], grid.shape[1]
    perm = _morton_to_linear_perm(g)
    out = np.empty((c, g ** 3), np.float32)
    for i in range(c):
        out[i] = grid[i].reshape(-1)[perm]
    return out.reshape(-1)


def bitfield_from_reference(packed: np.ndarray, n_cascades: int,
                            g: int = 128) -> np.ndarray:
    """Reference uint8 bitfield (morton bits, 8/byte) -> [C, G, G, G] bool."""
    bits = np.unpackbits(
        packed.reshape(-1, 1), axis=1, bitorder="little"
    ).reshape(-1)
    return density_grid_from_reference(
        bits.astype(np.float32), n_cascades, g
    ) > 0.5


def bitfield_to_reference(bitfield: np.ndarray) -> np.ndarray:
    flat = density_grid_to_reference(bitfield.astype(np.float32)) > 0.5
    return np.packbits(flat.astype(np.uint8), bitorder="little")


def hash_table_from_reference(m_grid: np.ndarray,
                              hash_indexing: str = "xor") -> np.ndarray:
    """Reference flat fp16 [n_params] -> our [n_entries, 2] fp32 (layouts
    coincide: entry-major, features interleaved; `HashEncode.h:grid_index`
    returns index*F + feature).

    Valid ONLY for encoders running ``hash_indexing='xor'`` (reference-exact
    semantics).  The TPU-fast ``'linear_rows'`` path replaces the XOR hash
    with per-level linear hashes, so an imported reference table would be
    read through a different index mapping at every hashed level — silently
    scrambled features (dense levels alone survive).  Pass the target
    encoder's indexing mode so the mismatch is loud.
    """
    if hash_indexing != "xor":
        import warnings

        warnings.warn(
            "Reference hash-table import requires hash_indexing='xor'; the "
            f"target encoder uses {hash_indexing!r}, whose per-level linear "
            "hashes will read the imported table scrambled at hashed levels. "
            "Set hash_indexing='xor' in the config for checkpoint interop.",
            stacklevel=2,
        )
    return np.asarray(m_grid, np.float32).reshape(-1, 2)


def hash_table_to_reference(table: np.ndarray) -> np.ndarray:
    return np.asarray(table, np.float16).reshape(-1)


def density_input_permutation(n_levels: int = 16) -> np.ndarray:
    """Row permutation for the density MLP's first weight matrix.

    Our encoder output column order is [f0_l0..f0_lL, f1_l0..f1_lL]; the
    reference's is [l0_f0, l0_f1, l1_f0, ...].  W_ours = W_ref[perm, :].
    """
    perm = np.empty(2 * n_levels, np.int64)
    for lvl in range(n_levels):
        perm[lvl] = 2 * lvl  # our f0 column takes ref's (lvl, f0) row
        perm[n_levels + lvl] = 2 * lvl + 1
    return perm


def fmlp_from_reference(con_weights: np.ndarray, dims) -> list:
    """Reference FMLP concatenated weight vector -> per-layer param dicts.

    The reference concatenates every layer's [in, out] weight TRANSPOSED and
    flattened (`fully_fused_mlp.py:23-43`: ``weights[i].transpose(1,0)
    .reshape(-1)``), padding the final layer's out-dim to 16 when smaller
    (rgb head is 3-wide).  ``dims`` are the true [in, h..., out] dims.
    Returns ``[{"w": [in, out] fp32}, ...]`` (our bias-free mlp.init_mlp
    schema).
    """
    con_weights = np.asarray(con_weights)
    n_layers = len(dims) - 1
    out, o = [], 0
    for i in range(n_layers):
        ind, outd = dims[i], dims[i + 1]
        stored_out = outd if (i < n_layers - 1 or outd >= 16) else 16
        w_t = con_weights[o : o + ind * stored_out].reshape(stored_out, ind)
        out.append({"w": np.ascontiguousarray(w_t.T[:, :outd], np.float32)})
        o += ind * stored_out
    assert o == con_weights.size, (o, con_weights.size)
    return out


def fmlp_to_reference(layers) -> np.ndarray:
    """Inverse of fmlp_from_reference: per-layer dicts -> flat fp16 vector."""
    parts = []
    n = len(layers)
    for i, p in enumerate(layers):
        w = np.asarray(p["w"], np.float16)
        if i == n - 1 and w.shape[1] < 16:
            w = np.concatenate(
                [w, np.zeros((w.shape[0], 16 - w.shape[1]), np.float16)], 1
            )
        parts.append(np.ascontiguousarray(w.T).reshape(-1))
    return np.concatenate(parts)


def ngp_mlps_from_reference(density_vec, rgb_vec, n_levels: int = 16,
                            density_dims=(32, 64, 16),
                            rgb_dims=(32, 64, 64, 3)):
    """Unpack both NGP FMLPs and apply the density-input permutation
    (our encoder output is feature-major; see density_input_permutation).
    Returns (density_mlp, rgb_mlp) in our NGPNetworks param schema."""
    density = fmlp_from_reference(density_vec, density_dims)
    perm = density_input_permutation(n_levels)
    density[0]["w"] = density[0]["w"][perm, :]
    rgb = fmlp_from_reference(rgb_vec, rgb_dims)
    return density, rgb
