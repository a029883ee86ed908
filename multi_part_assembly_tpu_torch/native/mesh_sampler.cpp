// Native mesh IO + surface sampling for the Breaking-Bad data pipeline.
//
// TPU-native replacement for the reference's host-side data hot path
// (reference: multi_part_assembly/datasets/geometry_data.py:109-131 --
// trimesh.load + trimesh.sample.sample_surface per part per epoch, the
// dominant input-pipeline cost).  This library:
//   * parses OBJ/OFF meshes once and caches them in RAM (handle API), so
//     epochs only pay for resampling;
//   * samples the surface area-weighted with a per-call PCG32 stream
//     (same distribution as trimesh.sample_surface: triangle chosen by
//     cumulative area, uniform barycentric point);
//   * exposes a batched, multithreaded entry point that releases the GIL
//     (ctypes) so a Python thread pool is not needed.
//
// C ABI only; bound from Python via ctypes (multi_part_assembly_tpu_torch/
// datasets/mesh_io.py), which builds it at first use with
// make -C multi_part_assembly_tpu_torch/native BUILD=<build dir>.

#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#if defined(__F16C__)
#include <immintrin.h>
#endif

namespace {

// float -> IEEE-754 half, round-to-nearest-even.  F16C when the build
// allows it (one instruction); portable bit-twiddling otherwise.  The f16
// host wire's store: half floats straight from the sampler halve the
// host-to-device bytes with no extra host pass.
inline uint16_t f32_to_f16(float f) {
#if defined(__F16C__)
  return _cvtss_sh(f, _MM_FROUND_TO_NEAREST_INT);
#else
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((x >> 23) & 0xff) - 127 + 15;
  uint32_t mant = x & 0x7fffffu;
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7c00u);  // inf
  if (exp <= 0) {                                // subnormal / zero
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1u);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1u))) half++;
    return static_cast<uint16_t>(sign | half);
  }
  uint16_t half =
      static_cast<uint16_t>(sign | (exp << 10) | (mant >> 13));
  uint32_t rem = mant & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half++;
  return half;
#endif
}

struct Mesh {
  std::vector<float> verts;     // 3 * n_verts
  std::vector<int32_t> faces;   // 3 * n_faces
  std::vector<double> cum_area; // cumulative triangle areas (for sampling)
  double total_area = 0.0;
  // Walker alias table over triangle areas: O(1) face draws instead of a
  // per-point binary search over cum_area (the sampler is the host input
  // pipeline's hot loop; this container has 1 CPU so per-draw cost is
  // throughput)
  std::vector<double> alias_prob;    // acceptance threshold per bucket
  std::vector<int32_t> alias_index;  // alias face per bucket
  // contiguous per-face triangle vertices (a, b-a, c-a interleaved, 9
  // floats/face): one cache line per draw instead of 3 scattered vertex
  // reads + 3 face-index reads
  std::vector<float> tri;
};

// --- PCG32: tiny, fast, reproducible RNG ---
struct Pcg32 {
  uint64_t state, inc;
  explicit Pcg32(uint64_t seed, uint64_t seq = 0xda3e39cb94b95bdbULL) {
    state = 0U;
    inc = (seq << 1u) | 1u;
    next();
    state += seed;
    next();
  }
  uint32_t next() {
    uint64_t old = state;
    state = old * 6364136223846793005ULL + inc;
    uint32_t xorshifted = static_cast<uint32_t>(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = static_cast<uint32_t>(old >> 59u);
    return (xorshifted >> rot) | (xorshifted << ((-rot) & 31));
  }
  double uniform() { return next() * (1.0 / 4294967296.0); }
};

std::mutex g_registry_mu;
std::unordered_map<int64_t, Mesh *> g_registry;
std::atomic<int64_t> g_next_handle{1};

bool parse_obj(const char *path, Mesh *mesh) {
  std::ifstream in(path);
  if (!in.is_open()) return false;
  std::string line;
  std::vector<float> &verts = mesh->verts;
  std::vector<int32_t> &faces = mesh->faces;
  while (std::getline(in, line)) {
    if (line.size() < 2) continue;
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      float x, y, z;
      if (std::sscanf(line.c_str() + 1, "%f %f %f", &x, &y, &z) == 3) {
        verts.push_back(x);
        verts.push_back(y);
        verts.push_back(z);
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      // faces may be "f a b c", "f a/t b/t c/t", "f a/t/n ...", polygons
      std::istringstream ss(line.substr(1));
      std::vector<int32_t> idx;
      std::string tok;
      while (ss >> tok) {
        // take the leading vertex index of each a/b/c group
        long v = std::strtol(tok.c_str(), nullptr, 10);
        if (v < 0) v = static_cast<long>(verts.size() / 3) + v + 1;
        if (v > 0) idx.push_back(static_cast<int32_t>(v - 1));
      }
      for (size_t k = 2; k < idx.size(); ++k) {  // polygon fan
        faces.push_back(idx[0]);
        faces.push_back(idx[k - 1]);
        faces.push_back(idx[k]);
      }
    }
  }
  return !verts.empty() && !faces.empty();
}

void build_areas(Mesh *mesh) {
  size_t nf = mesh->faces.size() / 3;
  mesh->cum_area.resize(nf);
  double acc = 0.0;
  const float *v = mesh->verts.data();
  for (size_t f = 0; f < nf; ++f) {
    int32_t a = mesh->faces[3 * f], b = mesh->faces[3 * f + 1],
            c = mesh->faces[3 * f + 2];
    double e1[3] = {v[3 * b] - v[3 * a], v[3 * b + 1] - v[3 * a + 1],
                    v[3 * b + 2] - v[3 * a + 2]};
    double e2[3] = {v[3 * c] - v[3 * a], v[3 * c + 1] - v[3 * a + 1],
                    v[3 * c + 2] - v[3 * a + 2]};
    double cx = e1[1] * e2[2] - e1[2] * e2[1];
    double cy = e1[2] * e2[0] - e1[0] * e2[2];
    double cz = e1[0] * e2[1] - e1[1] * e2[0];
    acc += 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
    mesh->cum_area[f] = acc;
  }
  mesh->total_area = acc;

  // Walker/Vose alias table over normalized areas
  mesh->alias_prob.assign(nf, 1.0);
  mesh->alias_index.resize(nf);
  std::vector<double> scaled(nf);
  double prev = 0.0;
  for (size_t f = 0; f < nf; ++f) {
    scaled[f] = (mesh->cum_area[f] - prev) / acc * static_cast<double>(nf);
    prev = mesh->cum_area[f];
    mesh->alias_index[f] = static_cast<int32_t>(f);
  }
  std::vector<int32_t> small, large;
  small.reserve(nf);
  large.reserve(nf);
  for (size_t f = 0; f < nf; ++f)
    (scaled[f] < 1.0 ? small : large).push_back(static_cast<int32_t>(f));
  while (!small.empty() && !large.empty()) {
    int32_t s = small.back(); small.pop_back();
    int32_t l = large.back(); large.pop_back();
    mesh->alias_prob[s] = scaled[s];
    mesh->alias_index[s] = l;
    scaled[l] -= 1.0 - scaled[s];
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  // leftovers (fp residue) keep prob 1.0 / self alias

  // pack triangles contiguously as (a, b-a, c-a): the sample loop then
  // reads one 36B block per draw and uses 6 fmas for the barycentric mix
  mesh->tri.resize(nf * 9);
  for (size_t f = 0; f < nf; ++f) {
    int32_t a = mesh->faces[3 * f], b = mesh->faces[3 * f + 1],
            c = mesh->faces[3 * f + 2];
    float *t = mesh->tri.data() + 9 * f;
    for (int d = 0; d < 3; ++d) {
      t[d] = v[3 * a + d];
      t[3 + d] = v[3 * b + d] - v[3 * a + d];
      t[6 + d] = v[3 * c + d] - v[3 * a + d];
    }
  }
}

// Templated on the output store so that the f32 and f16 outputs share the
// sampling loop (the same RNG stream and math: the f16 output is exactly
// f16(f32 sample), never a different sample).
struct StoreF32 {
  float *out;
  void operator()(size_t j, float val) const { out[j] = val; }
};
struct StoreF16 {
  uint16_t *out;
  void operator()(size_t j, float val) const { out[j] = f32_to_f16(val); }
};

template <typename Store>
void sample_mesh_t(const Mesh &mesh, int n_points, uint64_t seed,
                   Store store) {
  Pcg32 rng(seed);
  size_t nf = mesh.cum_area.size();
  const float *tri = mesh.tri.data();
  for (int i = 0; i < n_points; ++i) {
    // O(1) area-weighted face draw via the alias table
    double rf = rng.uniform() * static_cast<double>(nf);
    size_t lo = static_cast<size_t>(rf);
    if (lo >= nf) lo = nf - 1;
    if (rf - static_cast<double>(lo) >= mesh.alias_prob[lo])
      lo = static_cast<size_t>(mesh.alias_index[lo]);
    // uniform barycentric (sqrt trick), float math on the contiguous
    // (a, b-a, c-a) triangle block
    float su = std::sqrt(static_cast<float>(rng.uniform()));
    float w = static_cast<float>(rng.uniform());
    float b1 = su * (1.0f - w), b2 = su * w;
    const float *t = tri + 9 * lo;
    for (int d = 0; d < 3; ++d) {
      store(3 * i + d, t[d] + b1 * t[3 + d] + b2 * t[6 + d]);
    }
  }
}

void sample_mesh(const Mesh &mesh, int n_points, uint64_t seed, float *out) {
  sample_mesh_t(mesh, n_points, seed, StoreF32{out});
}

Mesh *get_mesh(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_registry_mu);
  auto it = g_registry.find(handle);
  return it == g_registry.end() ? nullptr : it->second;
}

// --- persistent parsed-mesh cache -------------------------------------
// Binary sidecar holding the POST-BUILD representation (contiguous
// (a, b-a, c-a) triangle blocks + Walker alias table), so a cold process
// (or an evicted registry) skips BOTH the OBJ text parse and the
// area/alias construction: one sequential binary read instead
// (reference geometry_data.py:109-131 re-pays trimesh parsing every
// epoch).  Validated against the source's (size, mtime_ns); written
// best-effort via atomic rename (read-only datasets just never cache).
//
// Note: verts/faces are stored as COUNTS only (their data is dead after
// build_areas -- sampling reads `tri`, stats read sizes); a cache-loaded
// mesh has zero-filled verts/faces of the right length.

constexpr uint32_t kCacheMagic = 0x4350414du;  // "MPAC" little-endian
constexpr uint32_t kCacheVersion = 1;

struct CacheHeader {
  uint32_t magic, version;
  uint64_t src_size, src_mtime_ns;
  int64_t n_verts, n_faces;
  double total_area;
};

bool src_stat(const char *path, uint64_t *size, uint64_t *mtime_ns) {
  struct stat st;
  if (stat(path, &st) != 0) return false;
  *size = static_cast<uint64_t>(st.st_size);
#if defined(__APPLE__)
  *mtime_ns = static_cast<uint64_t>(st.st_mtimespec.tv_sec) * 1000000000ull +
              static_cast<uint64_t>(st.st_mtimespec.tv_nsec);
#else
  *mtime_ns = static_cast<uint64_t>(st.st_mtim.tv_sec) * 1000000000ull +
              static_cast<uint64_t>(st.st_mtim.tv_nsec);
#endif
  return true;
}

bool load_mesh_cache(const char *cpath, uint64_t src_size,
                     uint64_t src_mtime_ns, Mesh *m) {
  std::ifstream in(cpath, std::ios::binary);
  if (!in.is_open()) return false;
  CacheHeader h;
  if (!in.read(reinterpret_cast<char *>(&h), sizeof h)) return false;
  if (h.magic != kCacheMagic || h.version != kCacheVersion) return false;
  if (h.src_size != src_size || h.src_mtime_ns != src_mtime_ns)
    return false;  // stale: source changed
  if (h.n_faces <= 0 || h.n_verts <= 0 || !(h.total_area > 0.0))
    return false;
  size_t nf = static_cast<size_t>(h.n_faces);
  m->verts.assign(3 * static_cast<size_t>(h.n_verts), 0.0f);
  m->faces.assign(3 * nf, 0);
  m->tri.resize(9 * nf);
  m->alias_prob.resize(nf);
  m->alias_index.resize(nf);
  m->cum_area.assign(nf, 0.0);  // only its SIZE is read post-build
  m->total_area = h.total_area;
  if (!in.read(reinterpret_cast<char *>(m->tri.data()),
               9 * nf * sizeof(float)))
    return false;
  if (!in.read(reinterpret_cast<char *>(m->alias_prob.data()),
               nf * sizeof(double)))
    return false;
  if (!in.read(reinterpret_cast<char *>(m->alias_index.data()),
               nf * sizeof(int32_t)))
    return false;
  return true;
}

void write_mesh_cache(const char *cpath, uint64_t src_size,
                      uint64_t src_mtime_ns, const Mesh &m) {
  // unique tmp per writer: concurrent loader threads, and the processes
  // of a data-parallel run, may cache the same mesh; the atomic rename
  // makes last-writer-wins safe
  static std::atomic<uint64_t> tmp_ctr{0};
  std::string tmp = std::string(cpath) + ".tmp" +
                    std::to_string(static_cast<long>(getpid())) + "." +
                    std::to_string(tmp_ctr.fetch_add(1));
  {
    std::ofstream out(tmp, std::ios::binary | std::ios::trunc);
    if (!out.is_open()) return;  // read-only location: silently skip
    CacheHeader h;
    h.magic = kCacheMagic;
    h.version = kCacheVersion;
    h.src_size = src_size;
    h.src_mtime_ns = src_mtime_ns;
    h.n_verts = static_cast<int64_t>(m.verts.size() / 3);
    h.n_faces = static_cast<int64_t>(m.faces.size() / 3);
    h.total_area = m.total_area;
    size_t nf = static_cast<size_t>(h.n_faces);
    out.write(reinterpret_cast<const char *>(&h), sizeof h);
    out.write(reinterpret_cast<const char *>(m.tri.data()),
              9 * nf * sizeof(float));
    out.write(reinterpret_cast<const char *>(m.alias_prob.data()),
              nf * sizeof(double));
    out.write(reinterpret_cast<const char *>(m.alias_index.data()),
              nf * sizeof(int32_t));
    if (!out.good()) {
      out.close();
      std::remove(tmp.c_str());
      return;
    }
  }
  if (std::rename(tmp.c_str(), cpath) != 0) std::remove(tmp.c_str());
}

// Batched multithreaded sampling: out is [n_meshes, n_points, 3] of the
// store's type, mesh i sampled with seeds[i] whatever the thread count.
template <typename T, typename Store>
int sample_batch_t(const int64_t *handles, int n_meshes, int n_points,
                   const uint64_t *seeds, T *out, int n_threads) {
  std::vector<Mesh *> meshes(n_meshes);
  for (int i = 0; i < n_meshes; ++i) {
    meshes[i] = get_mesh(handles[i]);
    if (!meshes[i]) return -(i + 1);
  }
  auto one = [&](int i) {
    sample_mesh_t(*meshes[i], n_points, seeds[i],
                  Store{out + static_cast<size_t>(i) * n_points * 3});
  };
  if (n_threads <= 1 || n_meshes == 1) {
    for (int i = 0; i < n_meshes; ++i) one(i);
    return 0;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_meshes) break;
      one(i);
    }
  };
  int nt = std::min(n_threads, n_meshes);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto &th : threads) th.join();
  return 0;
}

}  // namespace

extern "C" {

// Parse + cache a mesh; returns handle > 0, or 0 on failure.
int64_t mpa_load_mesh(const char *path) {
  Mesh *mesh = new Mesh();
  if (!parse_obj(path, mesh)) {
    delete mesh;
    return 0;
  }
  build_areas(mesh);
  if (mesh->total_area <= 0.0) {
    delete mesh;
    return 0;
  }
  int64_t h = g_next_handle.fetch_add(1);
  std::lock_guard<std::mutex> lk(g_registry_mu);
  g_registry[h] = mesh;
  return h;
}

// Shared sidecar-backed load: returns an owned Mesh* (not yet in the
// registry), or nullptr on failure.
static Mesh *load_cached_impl(const char *path, const char *cache_path) {
  uint64_t src_size = 0, src_mtime_ns = 0;
  bool have_stat = src_stat(path, &src_size, &src_mtime_ns);
  bool use_cache = have_stat && cache_path && cache_path[0];
  Mesh *mesh = new Mesh();
  if (use_cache &&
      load_mesh_cache(cache_path, src_size, src_mtime_ns, mesh)) {
    return mesh;
  }
  delete mesh;  // may be partially filled by a truncated cache read
  mesh = new Mesh();
  if (!parse_obj(path, mesh)) {
    delete mesh;
    return nullptr;
  }
  build_areas(mesh);
  if (mesh->total_area <= 0.0) {
    delete mesh;
    return nullptr;
  }
  if (use_cache) write_mesh_cache(cache_path, src_size, src_mtime_ns, *mesh);
  return mesh;
}

static int64_t register_mesh(Mesh *mesh) {
  int64_t h = g_next_handle.fetch_add(1);
  std::lock_guard<std::mutex> lk(g_registry_mu);
  g_registry[h] = mesh;
  return h;
}

// Like mpa_load_mesh, but backed by a persistent sidecar at `cache_path`:
// a valid cache skips parse + table build; a miss/stale cache parses and
// (best-effort) writes the sidecar for the next cold load.  Returns
// handle > 0, or 0 on failure.
int64_t mpa_load_mesh_cached(const char *path, const char *cache_path) {
  Mesh *mesh = load_cached_impl(path, cache_path);
  return mesh ? register_mesh(mesh) : 0;
}

// Threaded batch variant of mpa_load_mesh_cached: the cold-registry
// reload path loads O(batch * parts) sidecars per batch, and a Python
// loop of per-mesh ctypes calls serializes the file IO on the producer
// thread (measured as the cold-cache bench bottleneck, ROADMAP r5).
// paths / cache_paths: n_meshes C strings each, '\0'-separated (an empty
// cache path disables the sidecar for that mesh).  handles[i] receives
// the mesh handle, or 0 on failure.  Returns 0, or -(i+1) for the last
// failed mesh.
int mpa_load_mesh_cached_batch(const char *paths, const char *cache_paths,
                               int n_meshes, int64_t *handles,
                               int n_threads) {
  std::vector<const char *> pptr(n_meshes), cptr(n_meshes);
  const char *p = paths;
  const char *c = cache_paths;
  for (int i = 0; i < n_meshes; ++i) {
    pptr[i] = p;
    p += std::strlen(p) + 1;
    cptr[i] = c;
    c += std::strlen(c) + 1;
  }
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_meshes) break;
      Mesh *mesh = load_cached_impl(pptr[i], cptr[i]);
      if (!mesh) {
        handles[i] = 0;
        err.store(-(i + 1));
        continue;
      }
      handles[i] = register_mesh(mesh);
    }
  };
  int nt = std::max(1, std::min(n_threads, n_meshes));
  if (nt == 1) {
    worker();
    return err.load();
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto &th : threads) th.join();
  return err.load();
}

void mpa_free_mesh(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_registry_mu);
  auto it = g_registry.find(handle);
  if (it != g_registry.end()) {
    delete it->second;
    g_registry.erase(it);
  }
}

int mpa_mesh_stats(int64_t handle, int64_t *n_verts, int64_t *n_faces) {
  Mesh *m = get_mesh(handle);
  if (!m) return -1;
  *n_verts = static_cast<int64_t>(m->verts.size() / 3);
  *n_faces = static_cast<int64_t>(m->faces.size() / 3);
  return 0;
}

// Sample one cached mesh.
int mpa_sample(int64_t handle, int n_points, uint64_t seed, float *out) {
  Mesh *m = get_mesh(handle);
  if (!m) return -1;
  sample_mesh(*m, n_points, seed, out);
  return 0;
}

// Batched multithreaded sampling: out is [n_meshes, n_points, 3].
int mpa_sample_batch(const int64_t *handles, int n_meshes, int n_points,
                     const uint64_t *seeds, float *out, int n_threads) {
  return sample_batch_t<float, StoreF32>(handles, n_meshes, n_points, seeds,
                                         out, n_threads);
}

// The same batch with IEEE-754 half output (the f16 host wire): out is
// [n_meshes, n_points, 3] uint16 (an np.float16 view).  The same RNG
// stream and sample math as mpa_sample_batch; only the store rounds.
int mpa_sample_batch_f16(const int64_t *handles, int n_meshes, int n_points,
                         const uint64_t *seeds, uint16_t *out,
                         int n_threads) {
  return sample_batch_t<uint16_t, StoreF16>(handles, n_meshes, n_points,
                                            seeds, out, n_threads);
}

// Bulk f32 -> f16, round to nearest even (8 lanes at a time under F16C).
void mpa_f32_to_f16(const float *in, uint16_t *out, int64_t n) {
  int64_t i = 0;
#if defined(__F16C__)
  for (; i + 8 <= n; i += 8) {
    __m256 v = _mm256_loadu_ps(in + i);
    __m128i h = _mm256_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT);
    _mm_storeu_si128(reinterpret_cast<__m128i *>(out + i), h);
  }
#endif
  for (; i < n; ++i) out[i] = f32_to_f16(in[i]);
}

// Export the device-sampler tables for a cached mesh (see
// multi_part_assembly_tpu_torch/datasets/device_sampler.py): the GPU
// draws surface points itself from a resident triangle table + Walker alias
// table, so the per-step wire carries piece ids instead of point clouds.
//   tri9:  [9, f_pad] component-major (rows: a.xyz, (b-a).xyz, (c-a).xyz),
//          zero past n_faces;
//   prob:  [f_pad] f32 alias acceptance thresholds (1.0 past n_faces);
//   alias: [f_pad] f32-encoded alias face indices (exact: indices < 2^24;
//          self past n_faces).  f32 so the whole table rides one array.
// Returns n_faces, or -1 if the handle is unknown / f_pad < n_faces.
int64_t mpa_export_tables(int64_t handle, int64_t f_pad, float *tri9,
                          float *prob, float *alias) {
  Mesh *m = get_mesh(handle);
  if (!m) return -1;
  int64_t nf = static_cast<int64_t>(m->cum_area.size());
  if (f_pad < nf) return -1;
  for (int d = 0; d < 9; ++d) {
    float *row = tri9 + d * f_pad;
    for (int64_t f = 0; f < nf; ++f) row[f] = m->tri[9 * f + d];
    for (int64_t f = nf; f < f_pad; ++f) row[f] = 0.0f;
  }
  for (int64_t f = 0; f < nf; ++f) {
    prob[f] = static_cast<float>(m->alias_prob[f]);
    alias[f] = static_cast<float>(m->alias_index[f]);
  }
  for (int64_t f = nf; f < f_pad; ++f) {
    prob[f] = 1.0f;
    alias[f] = static_cast<float>(f);
  }
  return nf;
}

}  // extern "C"
