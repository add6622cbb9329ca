// Native geometry kernels for the host-side preprocessing path of the
// PyTorch port (a copy of meshanything_tpu/native/geom.cpp).
//
// udf_grid: exact unsigned distance from every node of a size^3 grid to
// a triangle mesh, computed over a uniform-grid spatial index so each
// node only tests nearby triangles. The replacement for the
// mesh2sdf C++ dependency (mesh_to_pc.py:30) — the reference's
// marching-cubes level set uses |sdf|, so the sign is not needed.
//
// Exposed with C linkage for ctypes (no pybind11 needed).
//
// Built with g++ at first use by meshanything_tpu_torch/geometry/native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

static inline Vec3 sub(const Vec3& a, const Vec3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline double dot(const Vec3& a, const Vec3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline Vec3 add(const Vec3& a, const Vec3& b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline Vec3 scale(const Vec3& a, double s) { return {a.x * s, a.y * s, a.z * s}; }

// Ericson, Real-Time Collision Detection: closest point on triangle.
static inline double point_tri_dist2(const Vec3& p, const Vec3& a, const Vec3& b, const Vec3& c) {
  Vec3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0.0 && d2 <= 0.0) { Vec3 d = sub(p, a); return dot(d, d); }

  Vec3 bp = sub(p, b);
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0.0 && d4 <= d3) { Vec3 d = sub(p, b); return dot(d, d); }

  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0.0 && d1 >= 0.0 && d3 <= 0.0) {
    double v = d1 / (d1 - d3);
    Vec3 q = add(a, scale(ab, v));
    Vec3 d = sub(p, q); return dot(d, d);
  }

  Vec3 cp = sub(p, c);
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0.0 && d5 <= d6) { Vec3 d = sub(p, c); return dot(d, d); }

  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0.0 && d2 >= 0.0 && d6 <= 0.0) {
    double w = d2 / (d2 - d6);
    Vec3 q = add(a, scale(ac, w));
    Vec3 d = sub(p, q); return dot(d, d);
  }

  double va = d3 * d6 - d5 * d4;
  if (va <= 0.0 && (d4 - d3) >= 0.0 && (d5 - d6) >= 0.0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    Vec3 q = add(b, scale(sub(c, b), w));
    Vec3 d = sub(p, q); return dot(d, d);
  }

  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  Vec3 q = add(a, add(scale(ab, v), scale(ac, w)));
  Vec3 d = sub(p, q); return dot(d, d);
}

}  // namespace

extern "C" {

// out: size^3 float32 distances, C-order (x-major like numpy (x,y,z)).
// Grid node i has coordinate lo + spacing * i on every axis.
void udf_grid(const double* vertices, int nv,
              const int64_t* faces, int nf,
              int size, double lo, double spacing,
              float* out) {
  (void)nv;
  const int64_t n3 = static_cast<int64_t>(size) * size * size;

  // Bucket triangles into coarse cells of the same grid; a triangle
  // lands in every cell its (padded) bbox touches.
  auto cell_of = [&](double v) {
    int c = static_cast<int>(std::floor((v - lo) / spacing));
    return std::min(std::max(c, 0), size - 1);
  };

  // CSR bucket index (count -> prefix-sum -> fill): one flat triangle
  // array instead of n3 std::vectors — the vector-of-vectors layout
  // allocated ~24 bytes of header per EMPTY cell (50 MB of touched
  // memory at 128^3 before any geometry ran) and scattered each cell's
  // triangle list across the heap.
  const double pad = spacing;  // one-cell halo
  std::vector<int> tri_cell_lo(3 * static_cast<size_t>(nf));
  std::vector<int> tri_cell_hi(3 * static_cast<size_t>(nf));
  std::vector<int32_t> count(static_cast<size_t>(n3) + 1, 0);
  for (int t = 0; t < nf; ++t) {
    const double* A = vertices + 3 * faces[3 * t + 0];
    const double* B = vertices + 3 * faces[3 * t + 1];
    const double* C = vertices + 3 * faces[3 * t + 2];
    for (int k = 0; k < 3; ++k) {
      double bb_lo = std::min({A[k], B[k], C[k]}) - pad;
      double bb_hi = std::max({A[k], B[k], C[k]}) + pad;
      tri_cell_lo[3 * t + k] = cell_of(bb_lo);
      tri_cell_hi[3 * t + k] = cell_of(bb_hi);
    }
    for (int x = tri_cell_lo[3 * t]; x <= tri_cell_hi[3 * t]; ++x)
      for (int y = tri_cell_lo[3 * t + 1]; y <= tri_cell_hi[3 * t + 1]; ++y)
        for (int z = tri_cell_lo[3 * t + 2]; z <= tri_cell_hi[3 * t + 2]; ++z)
          ++count[(static_cast<int64_t>(x) * size + y) * size + z + 1];
  }
  for (int64_t i = 0; i < n3; ++i) count[i + 1] += count[i];
  std::vector<int32_t> entries(static_cast<size_t>(count[n3]));
  std::vector<int32_t> fill(count.begin(), count.end() - 1);
  for (int t = 0; t < nf; ++t) {
    for (int x = tri_cell_lo[3 * t]; x <= tri_cell_hi[3 * t]; ++x)
      for (int y = tri_cell_lo[3 * t + 1]; y <= tri_cell_hi[3 * t + 1]; ++y)
        for (int z = tri_cell_lo[3 * t + 2]; z <= tri_cell_hi[3 * t + 2]; ++z)
          entries[fill[(static_cast<int64_t>(x) * size + y) * size + z]++] = t;
  }

  // Hoist triangle vertices into one flat array: the node loop's
  // per-triangle loads were 9 double-indirections through faces[].
  std::vector<double> tri_verts(9 * static_cast<size_t>(nf));
  for (int t = 0; t < nf; ++t)
    for (int c = 0; c < 3; ++c)
      for (int k = 0; k < 3; ++k)
        tri_verts[9 * t + 3 * c + k] = vertices[3 * faces[3 * t + c] + k];

  // Pass 1: exact distance for nodes whose cell neighborhood holds
  // triangles; mark the rest for Chamfer fill. Embarrassingly parallel
  // over x-slabs — std::thread sized by hardware_concurrency (fleet
  // hosts vary from 1 to many cores; on a 1-core host this degenerates
  // to the serial loop with no overhead beyond one thread spawn).
  std::vector<float> field(static_cast<size_t>(n3), -1.0f);
  auto slab = [&](int x_begin, int x_end) {
    for (int x = x_begin; x < x_end; ++x) {
      for (int y = 0; y < size; ++y) {
        for (int z = 0; z < size; ++z) {
          Vec3 p{lo + spacing * x, lo + spacing * y, lo + spacing * z};
          double best = 1e300;
          const int64_t ci = (static_cast<int64_t>(x) * size + y) * size + z;
          const int32_t e0 = count[ci], e1 = count[ci + 1];
          for (int32_t e = e0; e < e1; ++e) {
            const double* tv = tri_verts.data() + 9 * entries[e];
            const Vec3 A{tv[0], tv[1], tv[2]};
            const Vec3 B{tv[3], tv[4], tv[5]};
            const Vec3 C{tv[6], tv[7], tv[8]};
            best = std::min(best, point_tri_dist2(p, A, B, C));
          }
          field[ci] = e1 > e0 ? static_cast<float>(std::sqrt(best)) : -1.0f;
        }
      }
    }
  };
  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  if (const char* env = std::getenv("GEOM_THREADS")) {
    int v = std::atoi(env);
    if (v > 0) nthreads = static_cast<unsigned>(v);
  }
  nthreads = std::min<unsigned>(nthreads, static_cast<unsigned>(size));
  if (nthreads <= 1) {
    slab(0, size);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (unsigned i = 0; i < nthreads; ++i) {
      int x0 = static_cast<int>(static_cast<int64_t>(size) * i / nthreads);
      int x1 = static_cast<int>(static_cast<int64_t>(size) * (i + 1) / nthreads);
      pool.emplace_back(slab, x0, x1);
    }
    for (auto& th : pool) th.join();
  }

  // Pass 2: approximate far field by outward Chamfer sweeps (two passes
  // of a 26-neighborhood distance transform seeded by the exact band).
  // Far values only need to exceed the marching level (2/size), which
  // the band already brackets, so the approximation is safe.
  const float step1 = static_cast<float>(spacing);
  const float step2 = step1 * 1.41421356f;
  const float step3 = step1 * 1.73205081f;
  auto idx = [&](int x, int y, int z) {
    return (static_cast<int64_t>(x) * size + y) * size + z;
  };
  const float INF = 3.0e38f;
  for (int64_t i = 0; i < n3; ++i)
    if (field[i] < 0.0f) field[i] = INF;

  auto relax = [&](int x, int y, int z) {
    float& v = field[idx(x, y, z)];
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          if (!dx && !dy && !dz) continue;
          int nx = x + dx, ny = y + dy, nz2 = z + dz;
          if (nx < 0 || ny < 0 || nz2 < 0 || nx >= size || ny >= size || nz2 >= size) continue;
          int m = std::abs(dx) + std::abs(dy) + std::abs(dz);
          float w = m == 1 ? step1 : (m == 2 ? step2 : step3);
          float cand = field[idx(nx, ny, nz2)] + w;
          if (cand < v) v = cand;
        }
  };
  for (int x = 0; x < size; ++x)
    for (int y = 0; y < size; ++y)
      for (int z = 0; z < size; ++z) relax(x, y, z);
  for (int x = size - 1; x >= 0; --x)
    for (int y = size - 1; y >= 0; --y)
      for (int z = size - 1; z >= 0; --z) relax(x, y, z);

  std::memcpy(out, field.data(), sizeof(float) * static_cast<size_t>(n3));
}

}  // extern "C"
