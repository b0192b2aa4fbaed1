// The rasterizer's stages ahead of compositing, for Hopper (sm_90a):
// projection, tile binning and the settings probe's occupancy count.
//
// These replace no Pallas kernel: the JAX package projects and bins with
// plain array code (`pixelsplat_tpu/ops/rasterizer/projection.py`,
// `binning.py`), which XLA fuses on the TPU. In the port the same plain code
// (`projection.py::project_gaussians_soa_plain`, `binning.py::
// bin_gaussians_plain`, `count_big`, `tile_occupancy`) is a chain of a few
// hundred small PyTorch launches and 5 host syncs a view; here it is a few
// launches and no sync.
//
// What bounds them: device memory, and below that the launches. Projection
// reads about 140 B and writes about 45 B a Gaussian (about 25 us a view
// of 393,216 Gaussians at 3.35 TB/s); binning writes and sorts span^2 keys
// a Gaussian. The design keeps every stage one pass over its data: one
// thread a Gaussian projects it (the camera's inverse and field of view
// computed in the kernel, so nothing is read back), one thread a Gaussian
// tests its span^2 tiles and writes its big-list key, one thread a (tile,
// slot) pair tests the big list, a single block builds the per-tile table,
// and one thread a list slot gathers the sorted pairs into place. The big
// list's selection is one stable `torch.sort` of g 32-bit keys and the pair
// sort another, each between two of the calls here.
//
// Arithmetic rounds op by op (`__fmul_rn` and friends), as PyTorch's
// separate elementwise launches do, and the tile test repeats the plain
// code's operations in its order, so that given the same projected
// Gaussians the tile lists equal the plain code's exactly.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMinAlpha = (float)(1.0 / 255.0);
// PyTorch divides a CUDA float tensor by a Python scalar as a product with
// the scalar's reciprocal taken in double and rounded to float: 255 here
// (`tests/test_torch_project_bin.py` holds PyTorch to it on the card).
constexpr float kInvMinAlpha = (float)(1.0 / (1.0 / 255.0));
constexpr float kNearClip = 0.2f;
constexpr float kDilation = 0.3f;
constexpr float kQSlack = 32.0f * 1.1920928955078125e-07f;  // 32 f32 epsilons
constexpr int kBigInf = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kTableThreads = 1024;
constexpr int kMaxColours = 6;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

// PyTorch's clamp, clamp with tensor bounds and minimum pass a NaN through.
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

}  // namespace

extern "C" {

// A (views, g) plane of f32: element (v, i) at p[v * vs + i * gs].
struct Plane {
  const float* p;
  long long gs;
  long long vs;
};

// The scene's Gaussians in SoA planes: means, the covariance's six unique
// entries (s00, s01, s02, s11, s12, s22) and opacity.
struct Scene {
  Plane m[3];
  Plane cov[6];
  Plane op;
};

// SH coefficients (channels, d_sh, ...): coefficient (c, d) of Gaussian i
// at p[c * sc + d * sd + (i / per_view) * sv + (i % rays) * sr]. The dense
// layout (ch, d_sh, g) has per_view = rays = g; the sample-shared one
// (ch, d_sh, V, 1, R) per_view = S * R and rays = R.
struct Colour {
  const float* p;
  int ch;
  int d_sh;
  long long sc, sd, sv, sr;
  long long per_view, rays;
};

// Projected Gaussians (one view), as binning and the probe read them.
struct Proj {
  Plane mx, my, ca, cb, cc, op, rx, ry, depth;
  const unsigned char* valid;
  long long valid_gs;
  long long valid_vs;
};

struct Bins {
  long long g;
  int tile_size, tiles_x, tiles_y, num_tiles;
  int span, depth_bits, wide, big_capacity;
};

}  // extern "C"

namespace {

__device__ __forceinline__ float at(const Plane& q, int v, long long i) { return q.p[v * q.vs + i * q.gs]; }

// One view's camera as the projection uses it.
struct View {
  float r[9];    // world-to-camera rotation, row-major
  float t[3];    // world-to-camera translation
  float pos[3];  // camera position
  float fx, fy, cx, cy, lim_x, lim_y, scale;
};

// extrinsics e (4x4 camera-to-world), normalized intrinsics k (3x3); with
// `near`, the world rescaled by 1 / near.
__device__ View view_of(const float* e, const float* k, const float* near, int h, int w) {
  View c;
  c.scale = near ? dv(1.0f, *near) : 1.0f;
  const float tw[3] = {mul(e[3], c.scale), mul(e[7], c.scale), mul(e[11], c.scale)};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) c.r[3 * i + j] = e[4 * j + i];
    c.pos[i] = tw[i];
  }
  for (int i = 0; i < 3; ++i)
    c.t[i] = -add(add(mul(c.r[3 * i], tw[0]), mul(c.r[3 * i + 1], tw[1])), mul(c.r[3 * i + 2], tw[2]));
  c.fx = mul(k[0], (float)w);
  c.fy = mul(k[4], (float)h);
  c.cx = mul(k[2], (float)w);
  c.cy = mul(k[5], (float)h);
  // get_fov: the angles between the rays through opposite edge midpoints,
  // through the closed-form inverse of the intrinsics.
  const float fxfy = k[0] * k[4];
  const float a0 = 1.0f / k[0], a1 = -k[1] / fxfy, a2 = (k[1] * k[5] - k[2] * k[4]) / fxfy;
  const float b1 = 1.0f / k[4], b2 = -k[5] / k[4];
  float ray[4][3];
  const float uv[4][2] = {{0.0f, 0.5f}, {1.0f, 0.5f}, {0.5f, 0.0f}, {0.5f, 1.0f}};
  for (int n = 0; n < 4; ++n) {
    const float x = a0 * uv[n][0] + a1 * uv[n][1] + a2, y = b1 * uv[n][1] + b2;
    const float norm = sqrtf(x * x + y * y + 1.0f);
    ray[n][0] = x / norm;
    ray[n][1] = y / norm;
    ray[n][2] = 1.0f / norm;
  }
  const float cos_x = ray[0][0] * ray[1][0] + ray[0][1] * ray[1][1] + ray[0][2] * ray[1][2];
  const float cos_y = ray[2][0] * ray[3][0] + ray[2][1] * ray[3][1] + ray[2][2] * ray[3][2];
  c.lim_x = 1.3f * tanf(0.5f * acosf(fminf(fmaxf(cos_x, -1.0f), 1.0f)));
  c.lim_y = 1.3f * tanf(0.5f * acosf(fminf(fmaxf(cos_y, -1.0f), 1.0f)));
  return c;
}

struct Geo {
  float mx, my, ca, cb, cc, depth, rx, ry;
  float wx, wy, wz;  // the (rescaled) world mean, for the SH direction
  bool valid;
};

// EWA projection of Gaussian i of view v: `project_gaussians_soa_plain`'s
// operations in its order. The probe and the render both call this.
__device__ Geo geometry(const Scene& s, int v, long long i, const View& c, int h, int w) {
  Geo q;
  const float sc2 = mul(c.scale, c.scale);
  const float mx = mul(at(s.m[0], v, i), c.scale), my = mul(at(s.m[1], v, i), c.scale),
              mz = mul(at(s.m[2], v, i), c.scale);
  float cv[6];
  for (int k = 0; k < 6; ++k) cv[k] = mul(at(s.cov[k], v, i), sc2);
  const float op = at(s.op, v, i);
  const float* r = c.r;

  const float tx = add(add(add(mul(r[0], mx), mul(r[1], my)), mul(r[2], mz)), c.t[0]);
  const float ty = add(add(add(mul(r[3], mx), mul(r[4], my)), mul(r[5], mz)), c.t[1]);
  const float tz = add(add(add(mul(r[6], mx), mul(r[7], my)), mul(r[8], mz)), c.t[2]);
  const float safe_tz = fabsf(tz) < 1e-6f ? 1e-6f : tz;
  const float iz = dv(1.0f, safe_tz);
  const float mean_x = sub(add(mul(mul(c.fx, tx), iz), c.cx), 0.5f);
  const float mean_y = sub(add(mul(mul(c.fy, ty), iz), c.cy), 0.5f);

  const float txz = mul(clamp_to(mul(tx, iz), -c.lim_x, c.lim_x), tz);
  const float tyz = mul(clamp_to(mul(ty, iz), -c.lim_y, c.lim_y), tz);
  const float iz2 = mul(iz, iz);
  const float j00 = mul(c.fx, iz), j02 = mul(mul(-c.fx, txz), iz2);
  const float j11 = mul(c.fy, iz), j12 = mul(mul(-c.fy, tyz), iz2);
  const float u0 = add(mul(j00, r[0]), mul(j02, r[6]));
  const float u1 = add(mul(j00, r[1]), mul(j02, r[7]));
  const float u2 = add(mul(j00, r[2]), mul(j02, r[8]));
  const float v0 = add(mul(j11, r[3]), mul(j12, r[6]));
  const float v1 = add(mul(j11, r[4]), mul(j12, r[7]));
  const float v2 = add(mul(j11, r[5]), mul(j12, r[8]));

  const float su0 = add(add(mul(cv[0], u0), mul(cv[1], u1)), mul(cv[2], u2));
  const float su1 = add(add(mul(cv[1], u0), mul(cv[3], u1)), mul(cv[4], u2));
  const float su2 = add(add(mul(cv[2], u0), mul(cv[4], u1)), mul(cv[5], u2));
  const float sv0 = add(add(mul(cv[0], v0), mul(cv[1], v1)), mul(cv[2], v2));
  const float sv1 = add(add(mul(cv[1], v0), mul(cv[3], v1)), mul(cv[4], v2));
  const float sv2 = add(add(mul(cv[2], v0), mul(cv[4], v1)), mul(cv[5], v2));
  const float a = add(add(add(mul(u0, su0), mul(u1, su1)), mul(u2, su2)), kDilation);
  const float b = add(add(mul(v0, su0), mul(v1, su1)), mul(v2, su2));
  const float cc = add(add(add(mul(v0, sv0), mul(v1, sv1)), mul(v2, sv2)), kDilation);

  const float det = sub(mul(a, cc), mul(b, b));
  const float safe_det = det <= 0.0f ? 1.0f : det;
  q.ca = dv(cc, safe_det);
  q.cb = dv(-b, safe_det);
  q.cc = dv(a, safe_det);

  const float t_cut = mul(2.0f, logf(mul(clamp_min(op, kMinAlpha), kInvMinAlpha)));
  const float rx = ceilf(__fsqrt_rn(clamp_min(mul(t_cut, a), 0.0f)));
  const float ry = ceilf(__fsqrt_rn(clamp_min(mul(t_cut, cc), 0.0f)));
  const bool on_screen = add(mean_x, rx) > 0.0f && sub(mean_x, rx) < (float)w &&
                         add(mean_y, ry) > 0.0f && sub(mean_y, ry) < (float)h;
  q.valid = tz > kNearClip && det > 0.0f && on_screen && op > kMinAlpha;
  q.mx = mean_x;
  q.my = mean_y;
  q.depth = tz;
  q.rx = q.valid ? rx : 0.0f;
  q.ry = q.valid ? ry : 0.0f;
  q.wx = mx;
  q.wy = my;
  q.wz = mz;
  return q;
}

// The 3DGS rasterizer's real SH basis (`ops/sh.py::sh_basis_components`).
__device__ void sh_basis(float x, float y, float z, int degree, float* out) {
  out[0] = 0.28209479177387814f;
  if (degree < 1) return;
  out[1] = -0.4886025119029199f * y;
  out[2] = 0.4886025119029199f * z;
  out[3] = -0.4886025119029199f * x;
  if (degree < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
  out[4] = 1.0925484305920792f * xy;
  out[5] = -1.0925484305920792f * yz;
  out[6] = 0.31539156525252005f * (2.0f * zz - xx - yy);
  out[7] = -1.0925484305920792f * xz;
  out[8] = 0.5462742152960396f * (xx - yy);
  if (degree < 3) return;
  out[9] = -0.5900435899266435f * y * (3.0f * xx - yy);
  out[10] = 2.890611442640554f * xy * z;
  out[11] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
  out[12] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  out[13] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
  out[14] = 1.445305721320277f * z * (xx - yy);
  out[15] = -0.5900435899266435f * x * (xx - 3.0f * yy);
  if (degree < 4) return;
  out[16] = 2.5033429417967046f * xy * (xx - yy);
  out[17] = -1.7701307697799304f * yz * (3.0f * xx - yy);
  out[18] = 0.9461746957575601f * xy * (7.0f * zz - 1.0f);
  out[19] = -0.6690465435572892f * yz * (7.0f * zz - 3.0f);
  out[20] = 0.10578554691520431f * (35.0f * zz * zz - 30.0f * zz + 3.0f);
  out[21] = -0.6690465435572892f * xz * (7.0f * zz - 3.0f);
  out[22] = 0.47308734787878004f * (xx - yy) * (7.0f * zz - 1.0f);
  out[23] = -1.7701307697799304f * xz * (xx - 3.0f * yy);
  out[24] = 0.6258357354491761f * (xx * xx - 6.0f * xx * yy + yy * yy);
}

// One thread a Gaussian, blockIdx.y the view. `out` holds rows mx, my,
// conic a, b, c, depth, radius x, y, then the colours, each (views, g).
__global__ void project_kernel(Scene s, const float* extr, const float* intr, const float* near, int h, int w,
                               long long g, Colour col, float* out, unsigned char* valid) {
  const int v = blockIdx.y;
  const View c = view_of(extr + 16 * v, intr + 9 * v, near ? near + v : nullptr, h, w);
  const long long row = (long long)gridDim.y * g;
  const int degree = col.d_sh >= 25 ? 4 : col.d_sh >= 16 ? 3 : col.d_sh >= 9 ? 2 : col.d_sh >= 4 ? 1 : 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < g; i += (long long)gridDim.x * blockDim.x) {
    const Geo q = geometry(s, v, i, c, h, w);
    float* o = out + v * g + i;
    o[0] = q.mx;
    o[row] = q.my;
    o[2 * row] = q.ca;
    o[3 * row] = q.cb;
    o[4 * row] = q.cc;
    o[5 * row] = q.depth;
    o[6 * row] = q.rx;
    o[7 * row] = q.ry;
    valid[v * g + i] = q.valid;
    if (col.p == nullptr) continue;
    const float dx = q.wx - c.pos[0], dy = q.wy - c.pos[1], dz = q.wz - c.pos[2];
    const float inv_n = rsqrtf(dx * dx + dy * dy + dz * dz + 1e-24f);
    float basis[25];
    sh_basis(dx * inv_n, dy * inv_n, dz * inv_n, degree, basis);
    const float* base = col.p + (i / col.per_view) * col.sv + (i % col.rays) * col.sr;
    for (int ch = 0; ch < col.ch; ++ch) {
      float sum = 0.0f;
      for (int d = 0; d < col.d_sh; ++d) sum += base[ch * col.sc + d * col.sd] * basis[d];
      o[(8 + ch) * row] = clamp_min(sum + 0.5f, 0.0f);
    }
  }
}

struct Box {
  int x0, x1, y0, y1;
};

// `binning.py::_tile_bounds`: clamp(floor(v / tile_size), 0, hi - 1).
__device__ __forceinline__ int cell(float v, float inv_ts, int hi) {
  float f = floorf(mul(v, inv_ts));
  if (!isnan(f)) f = fminf(fmaxf(f, 0.0f), (float)(hi - 1));
  return (int)f;
}

__device__ __forceinline__ Box box_of(float mx, float my, float rx, float ry, const Bins& b) {
  const float inv_ts = 1.0f / (float)b.tile_size;
  return {cell(sub(mx, rx), inv_ts, b.tiles_x), cell(add(mx, rx), inv_ts, b.tiles_x),
          cell(sub(my, ry), inv_ts, b.tiles_y), cell(add(my, ry), inv_ts, b.tiles_y)};
}

// What the tile test reads of one Gaussian, clamped as `bin_gaussians_plain`
// clamps it.
struct Conic {
  float mx, my, ca, cb, cc, t;
};

__device__ __forceinline__ Conic conic_of(const Proj& p, long long i) {
  const float op = at(p.op, 0, i);
  return {at(p.mx, 0, i), at(p.my, 0, i), clamp_min(at(p.ca, 0, i), 1e-12f), at(p.cb, 0, i),
          clamp_min(at(p.cc, 0, i), 1e-12f), mul(2.0f, logf(mul(clamp_min(op, kMinAlpha), kInvMinAlpha)))};
}

__device__ __forceinline__ float q_at(const Conic& k, float dx, float dy) {
  const float q = add(mul(add(mul(k.ca, dx), mul(mul(2.0f, k.cb), dy)), dx), mul(mul(k.cc, dy), dy));
  const float mag = add(mul(mul(k.ca, dx), dx), mul(mul(k.cc, dy), dy));
  return sub(q, mul(kQSlack, mag));
}

// `tile_reaches_alpha`: whether the ellipse where alpha >= 1/255 meets
// tile (tx, ty), from the minimum of the quadratic form over the tile.
__device__ bool reaches(int tx, int ty, const Conic& k, int tile_size) {
  const float dx0 = sub(mul((float)tx, (float)tile_size), k.mx);
  const float dx1 = add(dx0, (float)(tile_size - 1));
  const float dy0 = sub(mul((float)ty, (float)tile_size), k.my);
  const float dy1 = add(dy0, (float)(tile_size - 1));
  const bool inside = dx0 <= 0.0f && 0.0f <= dx1 && dy0 <= 0.0f && 0.0f <= dy1;
  const float qx0 = q_at(k, dx0, clamp_to(dv(mul(-k.cb, dx0), k.cc), dy0, dy1));
  const float qx1 = q_at(k, dx1, clamp_to(dv(mul(-k.cb, dx1), k.cc), dy0, dy1));
  const float qy0 = q_at(k, clamp_to(dv(mul(-k.cb, dy0), k.ca), dx0, dx1), dy0);
  const float qy1 = q_at(k, clamp_to(dv(mul(-k.cb, dy1), k.ca), dx0, dx1), dy1);
  return inside || nan_min(nan_min(qx0, qx1), nan_min(qy0, qy1)) <= k.t;
}

__device__ __forceinline__ int depth_key(float depth, const Bins& b) {
  const int pattern = __float_as_int(clamp_min(depth, 0.0f));
  return b.wide ? pattern : pattern >> (31 - b.depth_bits);
}

__device__ __forceinline__ void put_key(const Bins& b, long long pos, bool ok, int tile, int dq, int* k32,
                                        long long* k64) {
  if (b.wide) {
    k64[pos] = ((long long)(ok ? tile : b.num_tiles) << 31) | (long long)dq;
  } else {
    const int shift = b.depth_bits > 0 ? b.depth_bits : 0;
    k32[pos] = ok ? (tile << shift) + dq : (b.num_tiles << shift);
  }
}

// One thread a Gaussian: its span^2 pair keys at slot * g + i and, where
// there is a big list, its big-list key at i: its depth key if it is big,
// else kBigInf (`bin_gaussians_plain`'s `big_dq`).
__global__ void bin_keys_kernel(Proj p, Bins b, int* k32, long long* k64, int* big_dq) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b.g; i += (long long)gridDim.x * blockDim.x) {
    const bool valid = p.valid[i * p.valid_gs];
    const Box x = box_of(at(p.mx, 0, i), at(p.my, 0, i), at(p.rx, 0, i), at(p.ry, 0, i), b);
    const int span_x = x.x1 - x.x0 + 1, span_y = x.y1 - x.y0 + 1;
    const bool small = valid && span_x <= b.span && span_y <= b.span;
    const int dq = depth_key(at(p.depth, 0, i), b);
    const Conic k = conic_of(p, i);
    for (int slot = 0; slot < b.span * b.span; ++slot) {
      const int dx = slot % b.span, dy = slot / b.span;
      const int tx = x.x0 + dx, ty = x.y0 + dy;
      const bool ok = small && dx < span_x && dy < span_y && reaches(tx, ty, k, b.tile_size);
      put_key(b, slot * b.g + i, ok, ty * b.tiles_x + tx, dq, k32, k64);
    }
    if (b.big_capacity > 0) big_dq[i] = valid && !small ? dq : kBigInf;
  }
}

// One thread a (tile, big slot) pair: its key at n_small + tile * bc + slot.
// `dq` and `ids` are the big-list keys stably sorted, with their Gaussians'
// ids: the first big_capacity are the nearest big Gaussians, ties by id, and
// kBigInf past the last. The first thread writes how many big Gaussians the
// list leaves out.
__global__ void big_pairs_kernel(Proj p, Bins b, const int* dq, const long long* ids, long long n_small, int* k32,
                                 long long* k64, int* ovf_big) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    long long lo = 0, hi = b.g;  // the first kBigInf
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (dq[mid] < kBigInf) lo = mid + 1;
      else hi = mid;
    }
    *ovf_big = (int)max(lo - b.big_capacity, 0LL);
  }
  const long long n = (long long)b.num_tiles * b.big_capacity;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int t = (int)(idx / b.big_capacity), j = (int)(idx % b.big_capacity);
    bool ok = false;
    if (dq[j] < kBigInf) {
      const long long gid = ids[j];
      const Box x = box_of(at(p.mx, 0, gid), at(p.my, 0, gid), at(p.rx, 0, gid), at(p.ry, 0, gid), b);
      const int tx = t % b.tiles_x, ty = t / b.tiles_x;
      ok = tx >= x.x0 && tx <= x.x1 && ty >= x.y0 && ty <= x.y1 && reaches(tx, ty, conic_of(p, gid), b.tile_size);
    }
    put_key(b, n_small + idx, ok, t, dq[j], k32, k64);
  }
}

// Exclusive prefix sum over the block; `total` gets the block's sum.
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_sums[(blockDim.x >> 5) - 1];
  return inc - x + (warp > 0 ? warp_sums[warp - 1] : 0);
}

__device__ __forceinline__ long long lower_bound(const int* k32, const long long* k64, long long n, int wide,
                                                 long long value) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long key = wide ? k64[mid] : (long long)k32[mid];
    if (key < value) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One block: each tile's run of the sorted keys, cut at `capacity`, its
// chunk-aligned start in the flat array and whether it fits `nb` blocks,
// the block-to-tile map, and the overflow (`bin_gaussians_plain`'s
// searchsorted, clamp, cumsum, fits test and sums).
__global__ void tile_table_kernel(const int* k32, const long long* k64, long long n, Bins b, int capacity, int chunk,
                                  int nb, const int* ovf_big, int* block_start, int* counts, int* starts,
                                  int* block_map, int* overflow) {
  __shared__ int carry;
  __shared__ unsigned long long ovf_sum;
  for (int q = threadIdx.x; q < nb; q += blockDim.x) block_map[q] = -1;
  if (threadIdx.x == 0) {
    carry = 0;
    ovf_sum = 0;
  }
  __syncthreads();
  const int shift = b.wide ? 31 : (b.depth_bits > 0 ? b.depth_bits : 0);
  unsigned long long ovf = 0;
  for (int t0 = 0; t0 < b.num_tiles; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    int cnt = 0, blocks = 0;
    long long lo = 0;
    if (t < b.num_tiles) {
      lo = lower_bound(k32, k64, n, b.wide, (long long)t << shift);
      const long long raw = lower_bound(k32, k64, n, b.wide, (long long)(t + 1) << shift) - lo;
      cnt = (int)min(raw, (long long)capacity);
      ovf += raw - cnt;
      blocks = (cnt + chunk - 1) / chunk;
    }
    int total;
    int start = block_exclusive_scan(blocks, &total) + carry;
    if (t < b.num_tiles) {
      if ((long long)start + blocks > nb) {
        ovf += cnt;
        cnt = 0;
        start = nb;
      }
      block_start[t] = start;
      counts[t] = cnt;
      starts[t] = (int)lo;
      if (cnt > 0)
        for (int k = 0; k < blocks; ++k) block_map[start + k] = t;
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += total;
    __syncthreads();
  }
  atomicAdd(&ovf_sum, ovf);
  __syncthreads();
  if (threadIdx.x == 0) *overflow = *ovf_big + (int)ovf_sum;
}

// One thread a slot of the flat array: the Gaussian id of its tile's pair
// at that rank, or g.
__global__ void gather_kernel(const long long* order, long long n_small, long long g, int bc, const long long* big_ids,
                              const int* block_map, const int* block_start, const int* counts, const int* starts,
                              int chunk, long long pair_budget, int* flat) {
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < pair_budget;
       q += (long long)gridDim.x * blockDim.x) {
    const int t = block_map[q / chunk];
    int id = (int)g;
    if (t >= 0) {
      const long long r = q - (long long)block_start[t] * chunk;
      if (r < counts[t]) {
        const long long o = order[starts[t] + r];
        id = (int)(o < n_small ? o % g : big_ids[(o - n_small) % bc]);
      }
    }
    flat[q] = id;
  }
}

// The probe's per-tile count of bounding boxes (`tile_occupancy`'s small
// Gaussians) and its big Gaussians (`count_big`), blockIdx.y the view,
// with a shared-memory histogram where the tiles fit.
__global__ void occupancy_kernel(Proj p, Bins b, int use_shared, int* hist, int* n_big) {
  extern __shared__ int shared_hist[];
  __shared__ int block_big;
  const int v = blockIdx.y;
  int* h = use_shared ? shared_hist : hist + (long long)v * b.num_tiles;
  if (use_shared)
    for (int t = threadIdx.x; t < b.num_tiles; t += blockDim.x) shared_hist[t] = 0;
  if (threadIdx.x == 0) block_big = 0;
  __syncthreads();
  int big = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b.g; i += (long long)gridDim.x * blockDim.x) {
    if (!p.valid[v * p.valid_vs + i * p.valid_gs]) continue;
    const Box x = box_of(at(p.mx, v, i), at(p.my, v, i), at(p.rx, v, i), at(p.ry, v, i), b);
    const int span_x = x.x1 - x.x0 + 1, span_y = x.y1 - x.y0 + 1;
    if (span_x > b.span || span_y > b.span) {
      ++big;
      continue;
    }
    for (int dy = 0; dy < span_y; ++dy)
      for (int dx = 0; dx < span_x; ++dx) atomicAdd(&h[(x.y0 + dy) * b.tiles_x + x.x0 + dx], 1);
  }
  atomicAdd(&block_big, big);
  __syncthreads();
  if (threadIdx.x == 0 && block_big) atomicAdd(&n_big[v], block_big);
  if (use_shared)
    for (int t = threadIdx.x; t < b.num_tiles; t += blockDim.x)
      if (shared_hist[t]) atomicAdd(&hist[(long long)v * b.num_tiles + t], shared_hist[t]);
}

// One block: over the views, the largest tile count and the largest flat
// budget once each tile also holds min(n_big, big_capacity) big slots.
__global__ void occupancy_stats_kernel(const int* hist, const int* n_big, int views, int num_tiles, int bc, int chunk,
                                       long long* out) {
  __shared__ unsigned long long red_max, red_sum;
  __shared__ long long best_max, best_sum;
  if (threadIdx.x == 0) best_max = best_sum = 0;
  for (int v = 0; v < views; ++v) {
    __syncthreads();
    if (threadIdx.x == 0) red_max = red_sum = 0;
    __syncthreads();
    const long long extra = min(n_big[v], bc);
    unsigned long long mx = 0, sum = 0;
    for (int t = threadIdx.x; t < num_tiles; t += blockDim.x) {
      const long long c = hist[(long long)v * num_tiles + t] + extra;
      mx = max(mx, (unsigned long long)c);
      sum += (unsigned long long)((c + chunk - 1) / chunk * chunk);
    }
    atomicMax(&red_max, mx);
    atomicAdd(&red_sum, sum);
    __syncthreads();
    if (threadIdx.x == 0) {
      best_max = v == 0 ? (long long)red_max : max(best_max, (long long)red_max);
      best_sum = v == 0 ? (long long)red_sum : max(best_sum, (long long)red_sum);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    out[0] = best_max;
    out[1] = best_sum;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192);
}

}  // namespace

extern "C" {

// Each entry point enqueues on `stream`, allocates nothing and returns
// cudaGetLastError() of its launches.

int project(const Scene* s, const float* extr, const float* intr, const float* near, int views, int h, int w,
            long long g, const Colour* col, float* out, unsigned char* valid, cudaStream_t stream) {
  if (g == 0 || views == 0) return 0;
  if (col->ch > kMaxColours || col->d_sh > 25) return (int)cudaErrorInvalidValue;
  project_kernel<<<dim3(grid_for(g), views), kThreads, 0, stream>>>(*s, extr, intr, near, h, w, g, *col, out, valid);
  return (int)cudaGetLastError();
}

// big_dq: g entries where there is a big list; ovf_big is zeroed here and
// written by big_pairs.
int bin_keys(const Proj* p, const Bins* b, int* k32, long long* k64, int* big_dq, int* ovf_big, cudaStream_t stream) {
  cudaMemsetAsync(ovf_big, 0, sizeof(int), stream);
  if (b->g > 0) bin_keys_kernel<<<grid_for(b->g), kThreads, 0, stream>>>(*p, *b, k32, k64, big_dq);
  return (int)cudaGetLastError();
}

// dq, ids: bin_keys's big_dq stably sorted, and each key's Gaussian.
int big_pairs(const Proj* p, const Bins* b, const int* dq, const long long* ids, int* ovf_big, int* k32,
              long long* k64, cudaStream_t stream) {
  const long long n = (long long)b->num_tiles * b->big_capacity;
  if (n > 0)
    big_pairs_kernel<<<grid_for(n), kThreads, 0, stream>>>(*p, *b, dq, ids, (long long)b->span * b->span * b->g, k32,
                                                           k64, ovf_big);
  return (int)cudaGetLastError();
}

int bin_lists(const int* k32, const long long* k64, const long long* order, long long n, const Bins* b, int capacity,
              int chunk, int nb, const int* ovf_big, const long long* big_ids, int* block_start, int* counts, int* starts,
              int* block_map, int* overflow, int* flat, cudaStream_t stream) {
  tile_table_kernel<<<1, kTableThreads, 0, stream>>>(k32, k64, n, *b, capacity, chunk, nb, ovf_big, block_start,
                                                     counts, starts, block_map, overflow);
  const long long pair_budget = (long long)nb * chunk;
  if (pair_budget > 0)
    gather_kernel<<<grid_for(pair_budget), kThreads, 0, stream>>>(
        order, (long long)b->span * b->span * b->g, b->g, b->big_capacity, big_ids, block_map, block_start, counts,
        starts, chunk, pair_budget, flat);
  return (int)cudaGetLastError();
}

// hist: (views, num_tiles), n_big: (views,), both zeroed here.
int occupancy(const Proj* p, const Bins* b, int views, int* hist, int* n_big, cudaStream_t stream) {
  cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)views * b->num_tiles, stream);
  cudaMemsetAsync(n_big, 0, sizeof(int) * (size_t)views, stream);
  if (b->g == 0 || views == 0) return (int)cudaGetLastError();
  const size_t shared = sizeof(int) * (size_t)b->num_tiles;
  const int use_shared = shared <= 48 * 1024;
  const long long blocks = (b->g + 4 * kThreads - 1) / (4 * kThreads);
  occupancy_kernel<<<dim3((int)(blocks < 128 ? blocks : 128), views), kThreads, use_shared ? shared : 0, stream>>>(
      *p, *b, use_shared, hist, n_big);
  return (int)cudaGetLastError();
}

int occupancy_stats(const int* hist, const int* n_big, int views, int num_tiles, int bc, int chunk, long long* out,
                    cudaStream_t stream) {
  occupancy_stats_kernel<<<1, kTableThreads, 0, stream>>>(hist, n_big, views, num_tiles, bc, chunk, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
