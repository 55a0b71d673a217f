// Marching-tetrahedra iso-surface extraction on the host, for the mesh
// tools (the NGP density mesh and NeuS's validate_mesh).
//
// The port's own copy of native/marching_tets.cpp: the same 6-tet cube
// decomposition and the same programmatically derived 16-case table as
// the numpy path in jnerf_tpu_torch/ops/marching.py, streamed over the
// grid instead of materialising per-cell corner tables, so that 512^3
// fields fit.  It returns the triangle soup; the Python caller welds the
// vertices with the numpy path's rounding, so both give the same mesh.
//
// Plain C ABI, loaded with ctypes by jnerf_tpu_torch/native.py.

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Cube corners: corner c offsets ((c>>0)&1, (c>>1)&1, (c>>2)&1).
const int CORNER[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};
// 6-tet decomposition through the 0-7 diagonal (matches ops/marching.py).
const int TETS[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};
const int EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

struct Tri { int e[3]; };

// Case table: for each 4-bit inside mask, triangles as edge-index triples.
// Derived by the same enumeration as marching.py:_build_tet_cases().
std::vector<Tri> CASES[16];
bool cases_built = false;

int edge_of(int a, int b) {
    if (a > b) { int t = a; a = b; b = t; }
    for (int i = 0; i < 6; ++i)
        if (EDGES[i][0] == a && EDGES[i][1] == b) return i;
    return -1;
}

void build_cases() {
    if (cases_built) return;
    for (int mask = 0; mask < 16; ++mask) {
        int inside[4], outside[4], ni = 0, no = 0;
        for (int v = 0; v < 4; ++v) {
            if (mask & (1 << v)) inside[ni++] = v; else outside[no++] = v;
        }
        auto &out = CASES[mask];
        if (ni == 1) {
            int a = inside[0];
            out.push_back({{edge_of(a, outside[0]), edge_of(a, outside[1]),
                            edge_of(a, outside[2])}});
        } else if (ni == 3) {
            int a = outside[0];
            out.push_back({{edge_of(a, inside[0]), edge_of(a, inside[2]),
                            edge_of(a, inside[1])}});
        } else if (ni == 2) {
            int a = inside[0], b = inside[1], c = outside[0], d = outside[1];
            int e1 = edge_of(a, c), e2 = edge_of(a, d);
            int e3 = edge_of(b, d), e4 = edge_of(b, c);
            out.push_back({{e1, e2, e3}});
            out.push_back({{e1, e3, e4}});
        }
    }
    cases_built = true;
}

struct Buffer {
    std::vector<float> verts;  // xyz triples, 3 per triangle corner
};

}  // namespace

extern "C" {

// Extract triangles from field [nx, ny, nz] (C order) at `threshold`.
// Returns a heap buffer of float triangle soup (9 floats per triangle)
// via *out_tris; caller frees with mt_free.  Return value = #triangles.
int64_t marching_tets(const float *field, int nx, int ny, int nz,
                      float threshold, float **out_tris) {
    build_cases();
    Buffer buf;
    buf.verts.reserve(1 << 20);

    const int64_t sy = nz;          // stride for y
    const int64_t sx = (int64_t)ny * nz;  // stride for x

    for (int x = 0; x < nx - 1; ++x) {
        for (int y = 0; y < ny - 1; ++y) {
            const float *base = field + (int64_t)x * sx + (int64_t)y * sy;
            for (int z = 0; z < nz - 1; ++z) {
                float cv[8];
                bool any_in = false, any_out = false;
                for (int c = 0; c < 8; ++c) {
                    cv[c] = base[CORNER[c][0] * sx + CORNER[c][1] * sy +
                                 CORNER[c][2] + z];
                    (cv[c] > threshold ? any_in : any_out) = true;
                }
                if (!any_in || !any_out) continue;

                for (int t = 0; t < 6; ++t) {
                    float v[4];
                    float p[4][3];
                    int mask = 0;
                    for (int k = 0; k < 4; ++k) {
                        int c = TETS[t][k];
                        v[k] = cv[c];
                        p[k][0] = (float)(x + CORNER[c][0]);
                        p[k][1] = (float)(y + CORNER[c][1]);
                        p[k][2] = (float)(z + CORNER[c][2]);
                        if (v[k] > threshold) mask |= 1 << k;
                    }
                    for (const Tri &tri : CASES[mask]) {
                        for (int k = 0; k < 3; ++k) {
                            int a = EDGES[tri.e[k]][0], b = EDGES[tri.e[k]][1];
                            float denom = v[b] - v[a];
                            float s = std::fabs(denom) > 1e-12f
                                          ? (threshold - v[a]) / denom : 0.5f;
                            if (s < 0.f) s = 0.f;
                            if (s > 1.f) s = 1.f;
                            for (int d = 0; d < 3; ++d)
                                buf.verts.push_back(p[a][d] +
                                                    s * (p[b][d] - p[a][d]));
                        }
                    }
                }
            }
        }
    }

    int64_t n_tris = (int64_t)buf.verts.size() / 9;
    float *out = (float *)std::malloc(buf.verts.size() * sizeof(float));
    std::memcpy(out, buf.verts.data(), buf.verts.size() * sizeof(float));
    *out_tris = out;
    return n_tris;
}

void mt_free(float *p) { std::free(p); }

}  // extern "C"
