// Native host runtime: fast mesh IO + BVH build primitives.
//
// The reference's native layer is ocarina's C++ runtime; the device
// compute path is JAX (plus native/trace.cu), but host-side asset loading
// and accel-build remain native for speed (multi-hundred-MB OBJ scenes
// parse ~20x faster than Python). Exposed as a C ABI consumed via ctypes
// (vision_tpu/native.py).
//
// Build: make -C native   (g++ -O3 -shared -fPIC, into native/build/)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

struct MeshBlob {
  float *positions;   // [n_verts * 3]
  float *normals;     // [n_verts * 3]
  float *uvs;         // [n_verts * 2]
  int32_t *triangles; // [n_tris * 3]
  int64_t n_verts;
  int64_t n_tris;
};

static inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

static inline const char *parse_float(const char *p, const char *end,
                                      float *out) {
  char *q;
  *out = strtof(p, &q);
  (void)end;
  return q;
}

// Parse "v/vt/vn" style index triple. Returns updated pointer.
static inline const char *parse_index(const char *p, const char *end,
                                      int64_t nv, int64_t nt, int64_t nn,
                                      int64_t *vi, int64_t *ti, int64_t *ni) {
  char *q;
  long v = strtol(p, &q, 10);
  *vi = v > 0 ? v - 1 : nv + v;
  *ti = -1;
  *ni = -1;
  p = q;
  if (p < end && *p == '/') {
    ++p;
    if (*p != '/') {
      long t = strtol(p, &q, 10);
      *ti = t > 0 ? t - 1 : nt + t;
      p = q;
    }
    if (p < end && *p == '/') {
      ++p;
      long n = strtol(p, &q, 10);
      *ni = n > 0 ? n - 1 : nn + n;
      p = q;
    }
  }
  return p;
}

int32_t vt_load_obj(const char *path, MeshBlob *out) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return -2;
  }
  fclose(f);

  std::vector<float> vs, vts, vns;
  std::vector<float> opos, onrm, ouv;
  std::vector<int32_t> tris;
  // dedup cache: key = (vi<<42) ^ (ti<<21) ^ ni packed
  std::unordered_map<uint64_t, int32_t> cache;
  cache.reserve(1 << 16);

  const char *p = buf.data();
  const char *end = p + buf.size();
  std::vector<int32_t> face;

  while (p < end) {
    const char *line_end = static_cast<const char *>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char *lp = skip_ws(p, line_end);
    if (lp + 1 < line_end && lp[0] == 'v' && lp[1] == ' ') {
      float x, y, z;
      lp = parse_float(lp + 2, line_end, &x);
      lp = parse_float(lp, line_end, &y);
      lp = parse_float(lp, line_end, &z);
      vs.push_back(x); vs.push_back(y); vs.push_back(z);
    } else if (lp + 2 < line_end && lp[0] == 'v' && lp[1] == 't' && lp[2] == ' ') {
      float u, v;
      lp = parse_float(lp + 3, line_end, &u);
      lp = parse_float(lp, line_end, &v);
      vts.push_back(u); vts.push_back(v);
    } else if (lp + 2 < line_end && lp[0] == 'v' && lp[1] == 'n' && lp[2] == ' ') {
      float x, y, z;
      lp = parse_float(lp + 3, line_end, &x);
      lp = parse_float(lp, line_end, &y);
      lp = parse_float(lp, line_end, &z);
      vns.push_back(x); vns.push_back(y); vns.push_back(z);
    } else if (lp + 1 < line_end && lp[0] == 'f' && lp[1] == ' ') {
      face.clear();
      lp += 2;
      int64_t nv = (int64_t)vs.size() / 3;
      int64_t nt = (int64_t)vts.size() / 2;
      int64_t nn = (int64_t)vns.size() / 3;
      while (lp < line_end) {
        lp = skip_ws(lp, line_end);
        if (lp >= line_end || *lp == '\n' || *lp == '#') break;
        int64_t vi, ti, ni;
        const char *np = parse_index(lp, line_end, nv, nt, nn, &vi, &ti, &ni);
        if (np == lp) break;
        lp = np;
        if (vi < 0 || vi >= nv) continue;
        uint64_t key = ((uint64_t)(vi + 1) << 42) ^ ((uint64_t)(ti + 2) << 21)
                       ^ (uint64_t)(ni + 2);
        auto it = cache.find(key);
        int32_t idx;
        if (it != cache.end()) {
          idx = it->second;
        } else {
          idx = (int32_t)(opos.size() / 3);
          opos.push_back(vs[vi * 3]);
          opos.push_back(vs[vi * 3 + 1]);
          opos.push_back(vs[vi * 3 + 2]);
          if (ni >= 0 && ni < nn) {
            onrm.push_back(vns[ni * 3]);
            onrm.push_back(vns[ni * 3 + 1]);
            onrm.push_back(vns[ni * 3 + 2]);
          } else {
            onrm.push_back(0); onrm.push_back(0); onrm.push_back(0);
          }
          if (ti >= 0 && ti < nt) {
            ouv.push_back(vts[ti * 2]);
            ouv.push_back(vts[ti * 2 + 1]);
          } else {
            ouv.push_back(0); ouv.push_back(0);
          }
          cache.emplace(key, idx);
        }
        face.push_back(idx);
      }
      for (size_t k = 1; k + 1 < face.size(); ++k) {
        tris.push_back(face[0]);
        tris.push_back(face[k]);
        tris.push_back(face[k + 1]);
      }
    }
    p = line_end + 1;
  }

  out->n_verts = (int64_t)opos.size() / 3;
  out->n_tris = (int64_t)tris.size() / 3;
  out->positions = (float *)malloc(opos.size() * sizeof(float));
  out->normals = (float *)malloc(onrm.size() * sizeof(float));
  out->uvs = (float *)malloc(ouv.size() * sizeof(float));
  out->triangles = (int32_t *)malloc(tris.size() * sizeof(int32_t));
  memcpy(out->positions, opos.data(), opos.size() * sizeof(float));
  memcpy(out->normals, onrm.data(), onrm.size() * sizeof(float));
  memcpy(out->uvs, ouv.data(), ouv.size() * sizeof(float));
  memcpy(out->triangles, tris.data(), tris.size() * sizeof(int32_t));
  return 0;
}

void vt_free_mesh(MeshBlob *m) {
  free(m->positions);
  free(m->normals);
  free(m->uvs);
  free(m->triangles);
  memset(m, 0, sizeof(*m));
}

// Morton-code sort of triangle centroids: the O(n log n) host step of the
// LBVH build (accel/bvh.py). Returns the permutation.
static inline uint64_t expand10(uint64_t v) {
  v = (v | (v << 16)) & 0x030000FFull;
  v = (v | (v << 8)) & 0x0300F00Full;
  v = (v | (v << 4)) & 0x030C30C3ull;
  v = (v | (v << 2)) & 0x09249249ull;
  return v;
}

void vt_morton_sort(const float *centroids, int64_t n, int32_t *order_out) {
  float lo[3] = {3e38f, 3e38f, 3e38f};
  float hi[3] = {-3e38f, -3e38f, -3e38f};
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      float c = centroids[i * 3 + k];
      lo[k] = std::min(lo[k], c);
      hi[k] = std::max(hi[k], c);
    }
  }
  float ext[3];
  for (int k = 0; k < 3; ++k) ext[k] = std::max(hi[k] - lo[k], 1e-12f);

  std::vector<std::pair<uint64_t, int32_t>> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t q[3];
    for (int k = 0; k < 3; ++k) {
      float t = (centroids[i * 3 + k] - lo[k]) / ext[k] * 1023.0f;
      q[k] = (uint64_t)std::min(std::max(t, 0.0f), 1023.0f);
    }
    keys[i] = {(expand10(q[0]) << 2) | (expand10(q[1]) << 1) | expand10(q[2]),
               (int32_t)i};
  }
  std::sort(keys.begin(), keys.end());
  for (int64_t i = 0; i < n; ++i) order_out[i] = keys[i].second;
}

}  // extern "C"
