// Greedy meshlet clustering — the C++ fast path for
// ash_renderer.scene.build_meshlets (bit-identical output; the pure
// Python loop costs ~10 s at 1.3M triangles, this ~0.05 s).
//
// Algorithm (must stay in lockstep with scene.build_meshlets): walk
// triangles in the caller-provided order; a meshlet accumulates triangles
// while it holds <= 128 distinct vertices and < 128 triangles; new distinct
// vertices are assigned local ids in first-occurrence corner order; flush
// pads vertex windows with source index 0 and triangle rows with
// local (0,0,0) / perm -1.
//
// Reference parity note: the reference has no meshlets (its vertex pull is
// GPU fixed-function, vertex_buffer_components.rs); this order is the packed
// triangle order of every scene (scene.build_meshlets), which the stored
// 1080p goldens were rendered in.
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int MESHLET_TRIS = 128;
constexpr int MESHLET_VERTS = 128;

struct MeshletsResult {
  std::vector<int32_t> vertex_src;  // n_meshlets * MESHLET_VERTS
  std::vector<int32_t> local_tri;   // n_meshlets * MESHLET_TRIS * 3
  std::vector<int32_t> tri_perm;    // n_meshlets * MESHLET_TRIS
};

}  // namespace

extern "C" {

// tri_v: (T, 3) int32 row-major; order: (R,) int32 triangle ids to walk
// (the Morton-ordered real triangles); num_vertices bounds vertex ids.
// Returns an opaque handle (call ash_meshlets_free) or nullptr.
void* ash_build_meshlets(const int32_t* tri_v, int64_t t_rows,
                         const int32_t* order, int64_t r,
                         int64_t num_vertices) {
  if (tri_v == nullptr || (order == nullptr && r > 0) || num_vertices < 0) {
    return nullptr;
  }
  auto* res = new MeshletsResult();
  // membership stamp per vertex: stamp[v] == meshlet serial -> member,
  // with its local id in local_of[v]
  std::vector<int64_t> stamp(static_cast<size_t>(num_vertices) + 1, -1);
  std::vector<int32_t> local_of(static_cast<size_t>(num_vertices) + 1, 0);
  int64_t serial = 0;

  int32_t cur_inv[MESHLET_VERTS];
  int32_t cur_used = 0;
  int32_t cur_ntris = 0;
  int32_t cur_local[MESHLET_TRIS * 3];
  int32_t cur_perm[MESHLET_TRIS];

  auto flush = [&]() {
    if (cur_ntris == 0) return;
    for (int32_t i = 0; i < cur_used; ++i) res->vertex_src.push_back(cur_inv[i]);
    for (int32_t i = cur_used; i < MESHLET_VERTS; ++i)
      res->vertex_src.push_back(0);
    for (int32_t i = 0; i < cur_ntris * 3; ++i)
      res->local_tri.push_back(cur_local[i]);
    for (int32_t i = cur_ntris * 3; i < MESHLET_TRIS * 3; ++i)
      res->local_tri.push_back(0);
    for (int32_t i = 0; i < cur_ntris; ++i) res->tri_perm.push_back(cur_perm[i]);
    for (int32_t i = cur_ntris; i < MESHLET_TRIS; ++i)
      res->tri_perm.push_back(-1);
    ++serial;
    cur_used = 0;
    cur_ntris = 0;
  };

  for (int64_t k = 0; k < r; ++k) {
    const int64_t t = order[k];
    if (t < 0 || t >= t_rows) continue;
    const int32_t* c = tri_v + 3 * t;
    // count distinct new vertices (first-occurrence order)
    int32_t fresh[3];
    int32_t n_fresh = 0;
    for (int j = 0; j < 3; ++j) {
      const int32_t v = c[j];
      if (v < 0 || v >= num_vertices) continue;  // matches dict-on-int path
      bool seen = stamp[v] == serial;
      for (int32_t i = 0; i < n_fresh && !seen; ++i) seen = fresh[i] == v;
      if (!seen) fresh[n_fresh++] = v;
    }
    if (cur_used + n_fresh > MESHLET_VERTS || cur_ntris >= MESHLET_TRIS) {
      flush();
      n_fresh = 0;
      for (int j = 0; j < 3; ++j) {
        const int32_t v = c[j];
        if (v < 0 || v >= num_vertices) continue;
        bool seen = stamp[v] == serial;
        for (int32_t i = 0; i < n_fresh && !seen; ++i) seen = fresh[i] == v;
        if (!seen) fresh[n_fresh++] = v;
      }
    }
    for (int32_t i = 0; i < n_fresh; ++i) {
      const int32_t v = fresh[i];
      stamp[v] = serial;
      local_of[v] = cur_used;
      cur_inv[cur_used++] = v;
    }
    for (int j = 0; j < 3; ++j) {
      const int32_t v = c[j];
      cur_local[cur_ntris * 3 + j] =
          (v >= 0 && v < num_vertices && stamp[v] == serial) ? local_of[v] : 0;
    }
    cur_perm[cur_ntris++] = static_cast<int32_t>(t);
  }
  flush();
  if (res->tri_perm.empty()) {  // degenerate empty scene: one pad meshlet
    res->vertex_src.assign(MESHLET_VERTS, 0);
    res->local_tri.assign(MESHLET_TRIS * 3, 0);
    res->tri_perm.assign(MESHLET_TRIS, -1);
  }
  return res;
}

void ash_meshlets_counts(void* handle, int64_t* n_meshlets) {
  auto* res = static_cast<MeshletsResult*>(handle);
  *n_meshlets = static_cast<int64_t>(res->tri_perm.size()) / MESHLET_TRIS;
}

void ash_meshlets_fill(void* handle, int32_t* vertex_src, int32_t* local_tri,
                       int32_t* tri_perm) {
  auto* res = static_cast<MeshletsResult*>(handle);
  std::copy(res->vertex_src.begin(), res->vertex_src.end(), vertex_src);
  std::copy(res->local_tri.begin(), res->local_tri.end(), local_tri);
  std::copy(res->tri_perm.begin(), res->tri_perm.end(), tri_perm);
}

void ash_meshlets_free(void* handle) {
  delete static_cast<MeshletsResult*>(handle);
}

}  // extern "C"
