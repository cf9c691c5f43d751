// Epipolar sampling for the GNT renderer, for Hopper (sm_90a): the exact
// sampler and the quad-masked sampler as one kernel, templated on the
// operand mode.
//
// Replaces no TPU kernel: the JAX package samples in XLA
// (pgdvs_tpu/models/gnt/projector.py: epipolar_sample, and the quad sampler
// of epipolar_sample_fused). It was added because the plain PyTorch chain
// (pgdvs_tpu_torch/models/gnt/projector.py: epipolar_sample_plain,
// epipolar_sample_quad_masked_plain, which it is held against) makes about 30
// full-size passes through device memory per ray tile: int64 row gathers,
// float32 casts, products, sums and concatenations. Wrapper:
// pgdvs_tpu_torch/kernels/epipolar.py.
//
//   epipolar_exact        the exact sampler: rgb [V, H, W, 3] bf16 tapped at
//                         the projection (x, y), the features [V, Hf, Wf, F]
//                         bf16 at (x (Wf-1)/(W-1), y (Hf-1)/(H-1)) and the
//                         dynamic mask [V, H, W] f32 (optional) at (x, y):
//                         each tap row times its weight in f32, summed in tap
//                         order (0,0), (0,1), (1,0), (1,1), rounded once to
//                         bf16 (the mask kept in f32 and compared > 1e-3);
//                         the ray-difference code in f32.
//   epipolar_quad_masked  the quad sampler on the fused map [V, H, W, C+1]
//                         bf16 whose trailing channel is the dynamic mask:
//                         each tap weight rounded to bf16, each product and
//                         partial sum rounded to bf16, (top pair) + (bottom
//                         pair); the mask channel compared > 1e-3.
//
// Per (view, ray, sample), one thread projects the point with the view's
// K @ w2c rows (f32; in front where z > 0, x and y divided by max(z, 1e-8)
// and clipped to +-1e6, in bounds on [0, W-1] x [0, H-1]), takes the
// zero-padded bilinear stencil (corner floor(x), floor(y) clamped to
// [0, W-2] x [0, H-2]), gathers the four tap rows, lerps them and writes
// the outputs once: samples [V, R, S, C] bf16, the in-bounds, dynamic and
// valid masks [V, R, S] as bytes, and (exact) the ray-difference code
// [V, R, S, 4] f32. Nothing of size [V, R, S, *] passes through device
// memory on the way.
//
// Bound: the bytes it writes. At the benchmark's tile (V = 10, R = 2048,
// S = 256, C = 35) the exact mode writes 367 MB of samples, 84 MB of
// ray-difference code and 16 MB of masks (0.14 ms at 3.35 TB/s), the quad
// mode 383 MB, while the maps it reads (6-114 MB) are read through L2. The
// design follows from that:
//   - a block of 256 threads takes 256 consecutive items of the views-outer
//     output order, so its samples are one contiguous run of the output,
//     and the grid walks one source view after another: the rays in flight
//     read one view's band of the map while it is in L2;
//   - each thread stages its sample's C channels in shared memory, and the
//     block stores the run with 16-byte streaming stores (the staging is
//     offset so that aligned global chunks are aligned in shared memory);
//     the ray-difference code goes out as one 16-byte store per sample and
//     the masks as bytes, all coalesced; the streaming stores keep the
//     output from evicting the maps from L2;
//   - tap rows load with the widest vector (VEC bf16: 16, 8, 4 or 2 bytes)
//     that their channel count and the map's alignment allow.
// No atomics, no synchronisation beyond the block's barrier, nothing
// allocated; offsets are 64-bit. Any V, R, S and map size of at least 2x2;
// the output's C channels are at most EPI_MAX_C (the staging's 48 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int EPI_THREADS = 256;
constexpr int EPI_MAX_C = (48 * 1024 / 2 - 8) / EPI_THREADS;  // 95

enum { EPI_EXACT = 0, EPI_QUAD = 1 };

struct EpiArgs {
  const float* pts;        // [R, S, 3]
  const float* proj;       // [V, 3, 4] K @ w2c rows
  const float* centers;    // [V+1, 3], the target first (exact)
  const uint16_t* map;     // exact: rgb [V, H, W, 3]; quad: fused [V, H, W, C+1]
  const uint16_t* feat;    // exact: features [V, Hf, Wf, F]
  const float* mask;       // exact: dynamic mask [V, H, W] or null
  int V, R, S, H, W;
  int Hf, Wf, F;           // exact: the feature map; quad: F = C+1, the fused channels
  int C;                   // output channels
  float fsx, fsy;          // exact: the feature coordinates' scales, rounded to f32
  uint16_t* out;           // [V, R, S, C] bf16
  float* ray_diff;         // exact: [V, R, S, 4]
  uint8_t* inbound;        // [V, R, S] each
  uint8_t* invalid;
  uint8_t* valid;
};

// The zero-padded bilinear stencil at (x, y) on view v's H x W map: the flat
// row index of its corner and the tap weights (0,0), (0,1), (1,0), (1,1).
struct Taps {
  int64_t base;
  float w[4];
};

__device__ __forceinline__ Taps quad_taps(float x, float y, int v, int h, int w) {
  const float sx = fminf(fmaxf(floorf(x), 0.f), (float)max(w - 2, 0));
  const float sy = fminf(fmaxf(floorf(y), 0.f), (float)max(h - 2, 0));
  const float wx0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(x, sx))), 0.f);
  const float wx1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(x, __fadd_rn(sx, 1.f)))), 0.f);
  const float wy0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(y, sy))), 0.f);
  const float wy1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(y, __fadd_rn(sy, 1.f)))), 0.f);
  Taps t;
  t.base = ((int64_t)v * h + (int)sy) * w + (int)sx;
  t.w[0] = __fmul_rn(wy0, wx0);
  t.w[1] = __fmul_rn(wy0, wx1);
  t.w[2] = __fmul_rn(wy1, wx0);
  t.w[3] = __fmul_rn(wy1, wx1);
  return t;
}

__device__ __forceinline__ void unpack2(unsigned u, float* f) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}

// VEC bf16 values at p (aligned to 2 * VEC bytes) as f32.
template <int VEC>
__device__ __forceinline__ void load_bf16(const uint16_t* p, float* f) {
  if constexpr (VEC == 8) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(r.x, f);
    unpack2(r.y, f + 2);
    unpack2(r.z, f + 4);
    unpack2(r.w, f + 6);
  } else if constexpr (VEC == 4) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    unpack2(r.x, f);
    unpack2(r.y, f + 2);
  } else if constexpr (VEC == 2) {
    unpack2(__ldg(reinterpret_cast<const unsigned*>(p)), f);
  } else {
    f[0] = __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The plain version's arithmetic as it runs on the card, so that the two
// agree bit for bit there: a projection row as the einsum's matrix product
// sums it (a fused multiply-add chain over x, y, z, then the translation),
// a norm and a dot product of three as torch's reductions sum them
// ((x + z) + y, each term rounded).
__device__ __forceinline__ float dot3(const float* p, float x, float y, float z) {
  return __fadd_rn(__fmaf_rn(p[2], z, __fmaf_rn(p[1], y, __fmul_rn(p[0], x))), p[3]);
}

__device__ __forceinline__ float sum3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(x, z), y);
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(sum3(__fmul_rn(x, x), __fmul_rn(y, y), __fmul_rn(z, z)));
}

// The exact mode's channels of one sample into out[0, 3+F); returns whether
// the lerped dynamic mask exceeds 1e-3.
template <int VEC>
__device__ __forceinline__ bool sample_exact(const EpiArgs& a, int v, float x, float y,
                                             uint16_t* out) {
  const Taps t = quad_taps(x, y, v, a.H, a.W);
  const int64_t off[4] = {0, 1, a.W, a.W + 1};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float row = __uint_as_float(
          (unsigned)__ldg(reinterpret_cast<const unsigned short*>(a.map) +
                          (t.base + off[k]) * 3 + c) << 16);
      const float tap = __fmul_rn(row, t.w[k]);
      acc = k == 0 ? tap : __fadd_rn(acc, tap);
    }
    out[c] = bf16_bits(acc);
  }
  bool inv = false;
  if (a.mask) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float tap = __fmul_rn(__ldg(a.mask + t.base + off[k]), t.w[k]);
      acc = k == 0 ? tap : __fadd_rn(acc, tap);
    }
    inv = acc > 1e-3f;
  }
  const Taps f = quad_taps(__fmul_rn(x, a.fsx), __fmul_rn(y, a.fsy), v, a.Hf, a.Wf);
  const int64_t foff[4] = {0, 1, a.Wf, a.Wf + 1};
  for (int c0 = 0; c0 < a.F; c0 += VEC) {
    float acc[VEC], row[VEC];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      load_bf16<VEC>(a.feat + (f.base + foff[k]) * a.F + c0, row);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float tap = __fmul_rn(row[i], f.w[k]);
        acc[i] = k == 0 ? tap : __fadd_rn(acc[i], tap);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[3 + c0 + i] = bf16_bits(acc[i]);
  }
  return inv;
}

// The quad mode's channels of one sample into out[0, C); returns whether
// the lerped mask channel (the C-th) exceeds 1e-3.
template <int VEC>
__device__ __forceinline__ bool sample_quad(const EpiArgs& a, int v, float x, float y,
                                            uint16_t* out) {
  const Taps t = quad_taps(x, y, v, a.H, a.W);
  const int64_t off[4] = {0, 1, a.W, a.W + 1};
  float wb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) wb[k] = bf16_round(t.w[k]);
  bool inv = false;
  for (int c0 = 0; c0 < a.F; c0 += VEC) {
    float r[4][VEC];
#pragma unroll
    for (int k = 0; k < 4; ++k) load_bf16<VEC>(a.map + (t.base + off[k]) * a.F + c0, r[k]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float top = bf16_round(__fadd_rn(bf16_round(__fmul_rn(r[0][i], wb[0])),
                                             bf16_round(__fmul_rn(r[1][i], wb[1]))));
      const float bot = bf16_round(__fadd_rn(bf16_round(__fmul_rn(r[2][i], wb[2])),
                                             bf16_round(__fmul_rn(r[3][i], wb[3]))));
      const float o = bf16_round(__fadd_rn(top, bot));
      if (c0 + i < a.C) {
        out[c0 + i] = bf16_bits(o);
      } else {
        inv = o > 1e-3f;
      }
    }
  }
  return inv;
}

template <int MODE, int VEC>
__global__ void __launch_bounds__(EPI_THREADS) k_epipolar(const EpiArgs a) {
  extern __shared__ __align__(16) unsigned char epi_smem[];
  uint16_t* stage = reinterpret_cast<uint16_t*>(epi_smem);
  const int64_t rs_total = (int64_t)a.R * a.S;
  const int64_t total = rs_total * a.V;
  const int64_t n0 = (int64_t)blockIdx.x * EPI_THREADS;
  const int cnt = total - n0 < EPI_THREADS ? (int)(total - n0) : EPI_THREADS;
  // the block's run of the output, [g0, g1); element g sits at stage[g - g0 + sh]
  const int64_t g0 = n0 * a.C;
  const int64_t g1 = g0 + (int64_t)cnt * a.C;
  const int sh = (int)(g0 & 7);
  const int tid = threadIdx.x;
  if (tid < cnt) {
    const int64_t n = n0 + tid;
    const int v = (int)(n / rs_total);
    const int64_t rs = n - v * rs_total;
    const float px = __ldg(a.pts + rs * 3), py = __ldg(a.pts + rs * 3 + 1),
                pz = __ldg(a.pts + rs * 3 + 2);
    float p[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) p[i] = __ldg(a.proj + v * 12 + i);
    const float cx = dot3(p, px, py, pz), cy = dot3(p + 4, px, py, pz),
                z = dot3(p + 8, px, py, pz);
    const float zc = fmaxf(z, 1e-8f);
    const float x = fminf(fmaxf(__fdiv_rn(cx, zc), -1e6f), 1e6f);
    const float y = fminf(fmaxf(__fdiv_rn(cy, zc), -1e6f), 1e6f);
    const bool inb = z > 0.f && x >= 0.f && x <= (float)(a.W - 1) && y >= 0.f &&
                     y <= (float)(a.H - 1);
    uint16_t* out = stage + sh + tid * a.C;
    bool inv;
    if constexpr (MODE == EPI_EXACT) {
      inv = sample_exact<VEC>(a, v, x, y, out);
      // the ray-difference code: unit (to target - to source), their dot
      const float* ct = a.centers;
      const float* cs = a.centers + 3 * (v + 1);
      float tx = __fsub_rn(__ldg(ct), px), ty = __fsub_rn(__ldg(ct + 1), py),
            tz = __fsub_rn(__ldg(ct + 2), pz);
      float sx = __fsub_rn(__ldg(cs), px), sy = __fsub_rn(__ldg(cs + 1), py),
            sz = __fsub_rn(__ldg(cs + 2), pz);
      const float nt = __fadd_rn(norm3(tx, ty, tz), 1e-6f);
      const float ns = __fadd_rn(norm3(sx, sy, sz), 1e-6f);
      tx = __fdiv_rn(tx, nt), ty = __fdiv_rn(ty, nt), tz = __fdiv_rn(tz, nt);
      sx = __fdiv_rn(sx, ns), sy = __fdiv_rn(sy, ns), sz = __fdiv_rn(sz, ns);
      const float dx = __fsub_rn(tx, sx), dy = __fsub_rn(ty, sy), dz = __fsub_rn(tz, sz);
      const float dn = fmaxf(norm3(dx, dy, dz), 1e-6f);
      const float dot = sum3(__fmul_rn(tx, sx), __fmul_rn(ty, sy), __fmul_rn(tz, sz));
      __stcs(reinterpret_cast<float4*>(a.ray_diff) + n,
             make_float4(__fdiv_rn(dx, dn), __fdiv_rn(dy, dn), __fdiv_rn(dz, dn), dot));
    } else {
      inv = sample_quad<VEC>(a, v, x, y, out);
    }
    a.inbound[n] = inb;
    a.invalid[n] = inv;
    a.valid[n] = inb && !inv;
  }
  __syncthreads();
  // head and tail element by element, the 8-aligned middle in 16-byte stores
  int64_t a0 = (g0 + 7) & ~(int64_t)7, a1 = g1 & ~(int64_t)7;
  if (a0 >= a1) a0 = a1 = g1;
  for (int64_t g = g0 + tid; g < a0; g += EPI_THREADS) a.out[g] = stage[g - g0 + sh];
  for (int64_t g = a0 + (int64_t)tid * 8; g < a1; g += EPI_THREADS * 8) {
    __stcs(reinterpret_cast<uint4*>(a.out + g),
           *reinterpret_cast<const uint4*>(stage + (g - g0 + sh)));
  }
  for (int64_t g = a1 + tid; g < g1; g += EPI_THREADS) a.out[g] = stage[g - g0 + sh];
}

template <int MODE>
int epi_launch(const EpiArgs& a, int vec, cudaStream_t stream) {
  if ((vec != 1 && vec != 2 && vec != 4 && vec != 8) || a.V < 1 || a.R < 0 || a.S < 0 ||
      a.H < 2 || a.W < 2 || a.C < 1 || a.C > EPI_MAX_C || a.F < 1 || a.F % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (MODE == EPI_EXACT && (a.Hf < 2 || a.Wf < 2 || a.C != 3 + a.F)) {
    return (int)cudaErrorInvalidValue;
  }
  if (MODE == EPI_QUAD && a.C != a.F - 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)a.V * a.R * a.S;
  if (total == 0) return 0;
  const int64_t blocks = (total + EPI_THREADS - 1) / EPI_THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)EPI_THREADS * a.C + 8) * sizeof(uint16_t);
  switch (vec) {
    case 8: k_epipolar<MODE, 8><<<(unsigned)blocks, EPI_THREADS, smem, stream>>>(a); break;
    case 4: k_epipolar<MODE, 4><<<(unsigned)blocks, EPI_THREADS, smem, stream>>>(a); break;
    case 2: k_epipolar<MODE, 2><<<(unsigned)blocks, EPI_THREADS, smem, stream>>>(a); break;
    case 1: k_epipolar<MODE, 1><<<(unsigned)blocks, EPI_THREADS, smem, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The exact sampler: pts [R, S, 3] f32, proj [V, 3, 4] f32, centers [V+1, 3]
// f32 (the target first), rgb [V, H, W, 3] bf16, feat [V, Hf, Wf, F] bf16
// (rows read VEC = vec elements at a time), mask [V, H, W] f32 or null, the
// feature coordinates' scales; out [V, R, S, 3+F] bf16, ray_diff
// [V, R, S, 4] f32, inbound / invalid / valid [V, R, S] bytes; the stream.
// Returns a cudaError_t.
int epipolar_exact(const void* pts, const void* proj, const void* centers, const void* rgb,
                   const void* feat, const void* mask, int V, int R, int S, int H, int W,
                   int Hf, int Wf, int F, int vec, float fsx, float fsy, void* out,
                   void* ray_diff, void* inbound, void* invalid, void* valid,
                   void* stream_ptr) {
  if (!pts || !proj || !centers || !rgb || !feat || !out || !ray_diff || !inbound ||
      !invalid || !valid) {
    return (int)cudaErrorInvalidValue;
  }
  const EpiArgs a{(const float*)pts, (const float*)proj, (const float*)centers,
                  (const uint16_t*)rgb, (const uint16_t*)feat, (const float*)mask,
                  V, R, S, H, W, Hf, Wf, F, 3 + F, fsx, fsy, (uint16_t*)out,
                  (float*)ray_diff, (uint8_t*)inbound, (uint8_t*)invalid, (uint8_t*)valid};
  return epi_launch<EPI_EXACT>(a, vec, (cudaStream_t)stream_ptr);
}

// The quad-masked sampler: pts [R, S, 3] f32, proj [V, 3, 4] f32, the fused
// map [V, H, W, C1] bf16 (its last channel the dynamic mask; rows read vec
// elements at a time); out [V, R, S, C1-1] bf16, inbound / invalid / valid
// [V, R, S] bytes; the stream. Returns a cudaError_t.
int epipolar_quad_masked(const void* pts, const void* proj, const void* maps, int V, int R,
                         int S, int H, int W, int C1, int vec, void* out, void* inbound,
                         void* invalid, void* valid, void* stream_ptr) {
  if (!pts || !proj || !maps || !out || !inbound || !invalid || !valid) {
    return (int)cudaErrorInvalidValue;
  }
  const EpiArgs a{(const float*)pts, (const float*)proj, nullptr, (const uint16_t*)maps,
                  nullptr, nullptr, V, R, S, H, W, 0, 0, C1, C1 - 1, 0.f, 0.f,
                  (uint16_t*)out, nullptr, (uint8_t*)inbound, (uint8_t*)invalid,
                  (uint8_t*)valid};
  return epi_launch<EPI_QUAD>(a, vec, (cudaStream_t)stream_ptr);
}

}  // extern "C"
