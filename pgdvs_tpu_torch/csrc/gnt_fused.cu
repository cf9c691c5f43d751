// Fused GNT transformer forward (depth 8, width 64) for Hopper (sm_90a).
//
// Six entry points share the kernels below. The three whole forwards differ
// only in their prologue, in where the per-(view, token) validity comes from
// (the VSRC template parameter of k_view / k_ray) and in whether the ray-diff
// and point codes are read or made (Mono3In):
//
//   gnt_mono4_forward  replaces pgdvs_tpu/kernels/gnt_fused_mono4.py:
//                      gnt_fused_apply_mono4 on its rgb_feat contract;
//                      validity recomputed from pts and the K @ w2c rows.
//                      Wrapper: pgdvs_tpu_torch/kernels/gnt_fused.py.
//   gnt_mono4_patch_forward  the same function on its patch_rows contract
//                      (raw patch rows + stencil coefficients, the combine in
//                      k_prologue's patch loader). Wrapper:
//                      kernels/gnt_fused_patch.py.
//   gnt_mono3_forward  replaces pgdvs_tpu/kernels/gnt_fused_mono3.py:
//                      gnt_fused_apply_mono3 in each of its operand modes:
//                      validity read from a uint8 mask [V, R, S] (in bounds,
//                      in front and not dynamic; separate, concatenated or
//                      pre-packed in JAX) or K1's projection test (fold_mask);
//                      the bf16 ray-diff code and point + view code read
//                      (the unfolded mode) or made (fold_ray_diff,
//                      fold_pos_code); sampled features, or raw quad rows +
//                      frac combined in k_prologue's quad-rows loader
//                      (fold_lerp). Wrapper:
//                      kernels/gnt_fused_mono3.py.
//
// The two split entry points run one half-block each, with the ray-diff
// code and the validity mask read from memory (VSRC_SPLIT), as the exact
// sampler materializes them; the host loops over the 8 blocks:
//
//   gnt_split_view_forward  K3a, replaces pgdvs_tpu/kernels/gnt_fused.py:
//                           _run_view (_view_kernel): one view block, no q_fc.
//   gnt_split_ray_forward   K3b, replaces gnt_fused.py: _run_ray (_ray_kernel):
//                           one ray block, writing its head-mean first-query
//                           weights row; no epilogue, no count.
//                           Wrapper of both: kernels/gnt_fused_split.py.
//
// gnt_prologue_forward runs the whole forwards' first kernel alone (h and q
// from any of its feature sources), for tests and timing. Wrapper:
// kernels/gnt_prologue.py.
//
// Each wrapper module also holds the plain torch version its kernel is
// checked against.
//
// Work: about 1e4 FLOP per (view, ray, sample) token per block (the 64x64
// value projection dominates), plus 4-head attention over the samples of
// every ray. Three kernels, launched from a host loop over the 8 blocks:
//
//   k_prologue   rgbfeat_fc_0/1 per view token -> h [V, N, 64] bf16 and the
//                max-pool over views -> q [N, 64] f32 (N = R * S tokens), a
//                persistent grid (w0 / w1 staged once per block), fc_0 and
//                fc_1 in mma.sync registers per warp and 16-token tile; one
//                loader per feature source: sampled features read (row
//                stride C or C+1), patch rows combined with their stencil
//                coefficients (each staged row value serving the 4 or 8 rays
//                that share it), or quad taps combined with the bilinear
//                weights of their frac (f32, rounded to bf16). The prologue
//                alone: gnt_prologue_forward (kernels/gnt_prologue.py).
//   k_view       one view transformer (+ q_fc on even blocks), a persistent
//                grid (one 256-thread block per SM, the block's weights
//                staged once with cp.async); each warp takes tiles of 16
//                tokens: validity (recomputed, or read from the mask) and
//                the ray-diff code (made from pts and the camera centres, or
//                read: K3a in f32, K2's unfolded mode in bf16, which reads
//                its q_fc point + view code too), then the views streamed
//                through a per-warp cp.async ring into an online
//                per-channel softmax whose products, logits and statistics
//                never leave mma.sync registers; out_fc, the feed-forward
//                and q_fc follow in registers.
//   k_ray        one ray transformer block, a persistent grid (one block
//                per SM at 140 KB of shared memory, weights staged once
//                per block with cp.async) walking the rays: K / V of a
//                ray's samples into the block's bf16 slab of a global
//                scratch (L2-resident), then each warp takes 16 query rows
//                with all four heads and streams the key tiles through a
//                cp.async double buffer, with an online softmax whose
//                scores and probabilities never leave mma.sync registers;
//                out_fc and the feed-forward follow in registers. S has no
//                cap. The last block (every K3b launch) also writes the
//                head-mean first-query weights (a second pass over the keys
//                with query 0's final max and sum), and the last block of
//                K1 / K2 rgb and the weighted valid-view count.
//
// Bounds on the card: all three run mma.sync m16n8k16 (k_view also
// m16n8k8; bf16, f32 accumulate) fed by ldmatrix, with the softmax
// statistics and layer norms in f32 registers. q stays f32 in global memory between kernels (it is small
// next to h); h is written once and read once per block. k_view reads q
// twice per token (the second time from L2) and writes it once; k_ray reads
// q twice per token (the K / V pass and the query pass) and writes it once.
// k_prologue is bound by bytes: per launch at the main tile it reads the
// features once (0.37 GB sampled, 1.35 GB of patch rows + coefficients) and
// writes h (0.67 GB) and q (0.13 GB), against 7.5e10 FLOP of products.
// k_view is bound by bytes: per launch at the main tile (V=10, N=2048*256)
// it reads h [V, N, 64] bf16 (0.67 GB) and q, and writes q, against ~0.07
// TFLOP of products. At the main tile k_ray's 537 M exponentials at the
// SFU's 16 per clock per SM take longer than its 8.6e10 FLOP at the
// tensor-core peak.
//
// All dense layers run here; the host only composes weights offline
// (wk@wv, wk@wa0, wq@wa0, p1@wa0, exact by linearity).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NW 64
#define PH 8
#define POSENC 63
#define HEADS 4
#define HD 16
#define MAX_VIEWS 32

// In front of the camera and inside [0, W-1] x [0, H-1] (project_points +
// pixel_inbound). P: the 3x4 K @ w2c rows of one view.
__device__ __forceinline__ bool point_valid(const float* P, float x, float y,
                                            float z, float hf, float wf) {
  const float uc = x * P[0] + y * P[1] + z * P[2] + P[3];
  const float vc = x * P[4] + y * P[5] + z * P[6] + P[7];
  const float zc = x * P[8] + y * P[9] + z * P[10] + P[11];
  const float zd = fmaxf(zc, 1e-8f);
  const float uu = fminf(fmaxf(uc / zd, -1e6f), 1e6f);
  const float vv = fminf(fmaxf(vc / zd, -1e6f), 1e6f);
  return uu >= 0.f && uu <= wf - 1.f && vv >= 0.f && vv <= hf - 1.f &&
         zc > 0.f;
}

// ---------------------------------------------------------------------------
// weights
// ---------------------------------------------------------------------------
struct HeadW {
  const bf16* w0; const float* b0; const bf16* w1; const float* b1;
};
struct ViewW {
  const float *ln_s, *ln_b;
  const bf16 *wqa0, *wbig;
  const float *bbig, *p0, *p0b;
  const bf16* wa1; const float* ba1;
  const bf16* wout; const float* bout;
  const float *fln_s, *fln_b;
  const bf16* wf1; const float* bf1;
  const bf16* wf2; const float* bf2;
  const bf16* wq0; const float* bq0;
  const bf16* wq1; const float* bq1;
};
struct RayW {
  const float *ln_s, *ln_b;
  const bf16* wqkv;
  const bf16* wo; const float* bo;
  const float *fln_s, *fln_b;
  const bf16* wf1; const float* bf1;
  const bf16* wf2; const float* bf2;
};
struct FinalW {
  const float *norm_s, *norm_b, *rgb_w, *rgb_b;
};
#define N_HEAD_PTRS 4
#define N_VIEW_PTRS 21
#define N_RAY_PTRS 11
#define N_FINAL_PTRS 4
#define DEPTH 8
#define N_PTRS (N_HEAD_PTRS + DEPTH * (N_VIEW_PTRS + N_RAY_PTRS) + N_FINAL_PTRS)

// The patch_rows operands of K1 (k_prologue's patch loader).
struct PatchIn {
  const void* rows;
  const void* coef;
  int n_pos, nb;  // stencil positions per row, rays per row block
};

// K2's operand sources beyond K1's (gnt_mono3_forward): the channel stride of
// rf; raw quad rows + frac (k_prologue's quad-rows loader); the
// ray-diff code (bf16 [V, N, 4]) and the point + view code (bf16 [N, 126])
// read from memory instead of made from pts. Null pointers: not used.
struct Mono3In {
  int ld;
  const void* lerp_rows;
  const void* frac;
  const void* rd16;
  const void* pos16;
};

// Where validity and the ray-diff code come from.
#define VSRC_PROJ 0   // K1: projection test and ray-diff from pts + cameras
#define VSRC_MASK 1   // K2: uint8 mask [V, N]; ray-diff from pts + cameras
#define VSRC_SPLIT 2  // K3a: uint8 mask [V, N] and f32 ray-diff [V, N, 4]

// Validity of view v at token n: the explicit mask or the projection test
// of the token's point.
template <int VSRC>
__device__ __forceinline__ bool view_valid(const uint8_t* mask, const float* proj,
                                           int v, size_t N, size_t n, float px,
                                           float py, float pz, float hf, float wf) {
  if (VSRC != VSRC_PROJ) return mask[(size_t)v * N + n] != 0;
  return point_valid(proj + v * 12, px, py, pz, hf, wf);
}

// Ray-difference code of point p for source view v: the unit direction of
// (to target - to source) and their dot product (cameras.ray_diff_features),
// each normalisation one reciprocal and three products.
// centers: [V+1, 3], target first.
__device__ __forceinline__ void ray_diff_code(const float* centers, int v, float px,
                                              float py, float pz, float* rd) {
  float ax = centers[0] - px, ay = centers[1] - py, az = centers[2] - pz;
  const float ia = 1.f / (sqrtf(ax * ax + ay * ay + az * az) + 1e-6f);
  ax *= ia; ay *= ia; az *= ia;
  const float* cv = centers + 3 * (v + 1);
  float bx = cv[0] - px, by = cv[1] - py, bz = cv[2] - pz;
  const float ib = 1.f / (sqrtf(bx * bx + by * by + bz * bz) + 1e-6f);
  bx *= ib; by *= ib; bz *= ib;
  const float dx = ax - bx, dy = ay - by, dz = az - bz;
  const float id = 1.f / fmaxf(sqrtf(dx * dx + dy * dy + dz * dz), 1e-6f);
  rd[0] = dx * id;
  rd[1] = dy * id;
  rd[2] = dz * id;
  rd[3] = ax * bx + ay * by + az * bz;
}

// ---------------------------------------------------------------------------
// mma.sync helpers (k_view, k_ray): cp.async, ldmatrix, m16n8k16 / m16n8k8
// bf16 tiles with f32 accumulators, and 16-row x 64-column f32 blocks in the
// accumulator layout
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 8 bytes (cache-all; the source 8-byte aligned)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols bf16 (cols a multiple of 8) from global (dense) to shared
// memory rows ld apart, by the whole block
__device__ __forceinline__ void cp_rows(bf16* dst, int ld, const bf16* src, int cols,
                                        int rows) {
  const int c8 = cols / 8;
  for (int i = threadIdx.x; i < rows * c8; i += blockDim.x)
    cp_async16(dst + (i / c8) * ld + (i % c8) * 8, src + (size_t)i * 8);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a @ b, one m16n8k16 tile (PTX ISA fragment layouts: g = lane / 4,
// t = lane % 4; A regs (g, 2t..) (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..);
// B regs (k 2t.., n g) (k 2t+8.., n g); C (g, 2t..) (g+8, 2t..))
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a @ b, one m16n8k8 tile (A regs (g, 2t..) (g+8, 2t..); B (k 2t.., n g))
__device__ __forceinline__ void mma16808(float c[4], const uint32_t a[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// B fragments of n-tiles n0 and n0 + 8 at k-step k0 of a [K x N] row-major
// matrix in shared memory (ld apart): b[0..1] for n0, b[2..3] for n0 + 8
__device__ __forceinline__ void ldb_kn(uint32_t b[4], const bf16* B, int ld, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, B + (k0 + (m & 1) * 8 + r) * ld + n0 + (m >> 1) * 8);
}

// the same for an [N x K] row-major matrix (element (k, n) at B[n * ld + k])
__device__ __forceinline__ void ldb_nk(uint32_t b[4], const bf16* B, int ld, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
  ldsm_x4(b, B + (n0 + (m >> 1) * 8 + r) * ld + k0 + (m & 1) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A warp's 16 rows x 64 columns in the C layout of 8 n-tiles: f[j][0..1] row
// g, columns 8j + 2t + {0, 1}; f[j][2..3] row g + 8. ks k-steps of A
// fragments from f's n-tiles 2kk, 2kk + 1.
__device__ __forceinline__ void frag_to_a(float (*f)[4], uint32_t (*a)[4], int ks) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= ks) break;
    a[kk][0] = pack_bf16(f[2 * kk][0], f[2 * kk][1]);
    a[kk][1] = pack_bf16(f[2 * kk][2], f[2 * kk][3]);
    a[kk][2] = pack_bf16(f[2 * kk + 1][0], f[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(f[2 * kk + 1][2], f[2 * kk + 1][3]);
  }
}

// acc[0..1] += A (16 x 64, four k-steps) @ B[:, n0 .. n0 + 15], B [64 x N]
// row-major in shared memory
__device__ __forceinline__ void mma_pair(float (*acc)[4], uint32_t (*a)[4],
                                         const bf16* B, int ld, int n0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t b[4];
    ldb_kn(b, B, ld, kk * 16, n0);
    mma16816(acc[0], a[kk], b[0], b[1]);
    mma16816(acc[1], a[kk], b[2], b[3]);
  }
}

// rows row0 .. row0 + 15 of a [*, 64] f32 matrix in the C layout; rows at
// or past nrows read as 0
__device__ __forceinline__ void load_rows(float (*x)[4], const float* src, int row0,
                                          int nrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + g + 8 * hr;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 v = make_float2(0.f, 0.f);
      if (r < nrows) v = *(const float2*)(src + (size_t)r * NW + 8 * j + 2 * t);
      x[j][2 * hr] = v.x;
      x[j][2 * hr + 1] = v.y;
    }
  }
}

// layer norm of the 16 rows in the C layout (each row over the 4 lanes of
// its quad), y may be x
__device__ __forceinline__ void ln_rows(float (*x)[4], const float* scale,
                                        const float* bias, float (*y)[4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += x[j][2 * hr] + x[j][2 * hr + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s * (1.0f / NW);
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d0 = x[j][2 * hr] - mu, d1 = x[j][2 * hr + 1] - mu;
      v += d0 * d0 + d1 * d1;
    }
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const float rs = rsqrtf(v * (1.0f / NW) + 1e-6f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      y[j][2 * hr] = (x[j][2 * hr] - mu) * rs * scale[c] + bias[c];
      y[j][2 * hr + 1] = (x[j][2 * hr + 1] - mu) * rs * scale[c + 1] + bias[c + 1];
    }
  }
}

// store a pair of n-tiles (16 rows x 16 columns) as bf16 at dst[row0.., col0..]
__device__ __forceinline__ void store_pair(bf16* dst, int ld, int row0, int col0,
                                           float (*acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = col0 + 8 * i + 2 * t;
    *(uint32_t*)(dst + (size_t)(row0 + g) * ld + c) = pack_bf16(acc[i][0], acc[i][1]);
    *(uint32_t*)(dst + (size_t)(row0 + g + 8) * ld + c) = pack_bf16(acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------------------------
// k_prologue: per view token h = bf16(rgbfeat_fc_1(bf16(relu(rgbfeat_fc_0(x)))))
// -> h [V, N, 64] bf16, and q = max_v h -> [N, 64] f32, x the token's features
// in bf16 from one of three sources (the SRC template parameter):
//
//   PSRC_RF     rf [V, N, ld] bf16, channels 0..C-1 of each row (ld = C, or
//               C + 1 for K2's pre-packed rows, whose validity channel is
//               not read);
//   PSRC_PATCH  K1's patch rows rows [V, R/NB, S, n_pos*C] and coefficients
//               coef [V, R, S, n_pos] (both bf16): token (r, s) takes
//               x[c] = sum_p rows[v, r / NB, s, p*C + c] * coef[v, r, s, p],
//               accumulated in f32 in p order and rounded once to bf16;
//   PSRC_LERP   K2 fold_lerp's raw quad rows [V, N, 4C] bf16 (pixels (y, x),
//               (y, x+1), (y+1, x), (y+1, x+1)) and frac [V, N, 2] f32: the
//               four taps combined the same way with the zero-pad bilinear
//               weights max(0, 1-|f|), max(0, 1-|f-1|) per axis.
//
// A persistent grid of 8-warp blocks: each block stages w0 [Cp x 64], w1
// [64 x 64] (bf16) and the biases in shared memory once. Then per view and
// 16-token tile a warp runs fc_0 and fc_1 as mma.sync m16n8k16 tiles in
// registers: the accumulators start at the biases, relu(fc_0) is rounded and
// repacked as fc_1's A fragments, fc_1's output is rounded to bf16 into q's
// running max (accumulator layout) and leaves through the warp's [16 x 72]
// shared tile as 16-byte stores; q is written once per tile.
//
// PSRC_RF / PSRC_LERP: every warp walks its own 16-token tiles with its own
// cp.async ring over its (tile, view) items, no block barrier. A tile's rows
// of one view are one contiguous span (16 * ld bf16, or 16 * 4C bf16 and
// 16 * 2 f32), copied as the enclosing 16-byte-aligned span, clamped to the
// tensor's end (a 16-byte chunk holding a byte of the tensor lies in its
// page); the A fragments are filled from it with 2-byte shared loads.
//
// PSRC_PATCH: an item is (row block rb, 8 / NB sample tiles of 16): the NB
// rays of rb that share its rows. Per view the block stages the item's rows
// (one contiguous span) and the NB rays' coefficient spans through a 2-stage
// cp.async ring; then each staged row value is loaded once into f32 and FMAd
// into NB accumulators, one per ray, and the combined bf16 A tiles go to the
// warps' shared tiles (warp w: ray w % NB, sample tile w / NB). Two block
// barriers per view: the stage has landed, and the A tiles are written.
// ---------------------------------------------------------------------------
#define PSRC_RF 0
#define PSRC_PATCH 1
#define PSRC_LERP 2
#define PRO_WARPS 8
#define PRO_THREADS (32 * PRO_WARPS)
#define PT 16               // tokens per warp tile (one mma m-tile)
#define PRO_LDW 72          // bf16 row stride of w0, w1 and the warp tiles: an
                            // odd number of 16-byte units, so the 8 rows of an
                            // ldmatrix fall in distinct banks
#define PRO_TILE_BYTES (PT * PRO_LDW * 2)
#define MAX_CP 64
#define MAX_NPOS 32
#define PRO_FRAC_BYTES (PT * 2 * 4 + 32)

// w0 (Cp rows), w1, b0, b1
__host__ __device__ inline int pro_wbytes(int cp) { return (cp + NW) * PRO_LDW * 2 + 2 * NW * 4; }
__host__ __device__ inline int pro_round16(int x) { return (x + 15) & ~15; }
// a ring stage of the warp loaders: the span of 16 tokens of `row_bytes`
// each, with room for the 16-byte alignment on both ends (+ frac for LERP)
__host__ __device__ inline int pro_span_bytes(int row_bytes) { return pro_round16(PT * row_bytes + 32); }

template <int SRC>
__host__ __device__ constexpr int pro_stages() { return SRC == PSRC_RF ? 3 : 2; }

// Copy bytes [b0, b1) of the tensor at base (b1 already clamped to its end)
// as the enclosing 16-byte-aligned chunks into dst, lane by lane of a warp
// (step 32) or thread by thread of a block (step PRO_THREADS); returns the
// offset of byte b0 in dst.
__device__ __forceinline__ int copy_span(unsigned char* dst, const void* base, size_t b0,
                                         size_t b1, int first, int step) {
  const uintptr_t a = (uintptr_t)base + b0;
  const uintptr_t lo = a & ~(uintptr_t)15, hi = ((uintptr_t)base + b1 + 15) & ~(uintptr_t)15;
  const int n = (int)((hi - lo) >> 4);
  for (int i = first; i < n; i += step)
    cp_async16(dst + 16 * i, (const void*)(lo + 16 * (uintptr_t)i));
  return (int)(a - lo);
}

// h and q's running max of the warp's 16 tokens for one view, from x's A
// fragments, which fill(kk, a) makes for k-step kk (ks k-steps of 16
// channels) as fc_0 needs them: rows 0 .. nrows-1 of the tile go to hrows
// (row r at hrows + r * 64) through the warp's tile ht.
template <class Fill>
__device__ __forceinline__ void prologue_tokens(Fill fill, int ks, const bf16* W0,
                                                const bf16* W1, const float* b0,
                                                const float* b1, float (*qm)[4], bf16* ht,
                                                bf16* __restrict__ hrows, int nrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bb = *(const float2*)(b0 + 8 * j + 2 * t);
    acc[j][0] = acc[j][2] = bb.x;
    acc[j][1] = acc[j][3] = bb.y;
  }
#pragma unroll
  for (int kk = 0; kk < MAX_CP / 16; ++kk) {
    if (kk >= ks) break;
    uint32_t xa[4];
    fill(kk, xa);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldb_kn(b, W0, PRO_LDW, kk * 16, np * 16);
      mma16816(acc[2 * np], xa, b[0], b[1]);
      mma16816(acc[2 * np + 1], xa, b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = fmaxf(acc[j][e], 0.f);
  uint32_t a[4][4];
  frag_to_a(acc, a, 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bb = *(const float2*)(b1 + 8 * j + 2 * t);
    acc[j][0] = acc[j][2] = bb.x;
    acc[j][1] = acc[j][3] = bb.y;
  }
#pragma unroll
  for (int np = 0; np < 4; ++np) mma_pair(&acc[2 * np], a, W1, PRO_LDW, np * 16);
  __syncwarp();  // every lane has read ht (a patch A tile) before it takes h
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(acc[j][2 * hr], acc[j][2 * hr + 1]);
      const float2 f = __bfloat1622float2(hv);
      qm[j][2 * hr] = fmaxf(qm[j][2 * hr], f.x);
      qm[j][2 * hr + 1] = fmaxf(qm[j][2 * hr + 1], f.y);
      *(__nv_bfloat162*)(ht + (g + 8 * hr) * PRO_LDW + 8 * j + 2 * t) = hv;
    }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = lane + 32 * c, r = i >> 3, c8 = i & 7;
    if (r < nrows)
      *(uint4*)(hrows + (size_t)r * NW + c8 * 8) = *(const uint4*)(ht + r * PRO_LDW + c8 * 8);
  }
  __syncwarp();
}

// rows 0 .. nrows-1 of q's running max (the accumulator layout) to qrows
__device__ __forceinline__ void store_qmax(float (*qm)[4], float* __restrict__ qrows,
                                           int nrows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = g + 8 * hr;
    if (r < nrows) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *(float2*)(qrows + (size_t)r * NW + 8 * j + 2 * t) =
            make_float2(qm[j][2 * hr], qm[j][2 * hr + 1]);
    }
  }
}

// A element (row, col) of a warp tile: x of token row, channel col (0 past
// C and past the tile's nrows rows), as bf16 bits. RF: raw rows ld apart.
// LERP: 4 taps of C channels per row, weights wt (of the element's row).
template <int SRC>
__device__ __forceinline__ uint32_t pro_elem(const bf16* raw, int ld, int C, int nrows,
                                             int row, int col, const float* wt) {
  if (col >= C || row >= nrows) return 0u;
  if constexpr (SRC == PSRC_RF) {
    return __bfloat16_as_ushort(raw[row * ld + col]);
  } else {
    const bf16* p = raw + row * 4 * C + col;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = fmaf(__bfloat162float(p[k * C]), wt[k], acc);
    return __bfloat16_as_ushort(__float2bfloat16(acc));
  }
}

template <int SRC, int NB>
__global__ void __launch_bounds__(PRO_THREADS, 2)
k_prologue(const void* __restrict__ src_a, const void* __restrict__ src_b, int ld, int V,
           int R, int S, int C, int Cp, int n_pos, HeadW w, bf16* __restrict__ hout,
           float* __restrict__ qout, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* W0 = (bf16*)smem;                          // [Cp x 72]
  bf16* W1 = W0 + Cp * PRO_LDW;                    // [64 x 72]
  float* b0 = (float*)(W1 + NW * PRO_LDW);
  float* b1 = b0 + NW;
  unsigned char* ring = smem + pro_wbytes(Cp);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2,
            t = lane & 3;
  const int N = R * S, ks = Cp / 16;
  cp_rows(W0, PRO_LDW, w.w0, NW, Cp);
  cp_rows(W1, PRO_LDW, w.w1, NW, NW);
  cp_async_commit();
  for (int i = tid; i < NW; i += PRO_THREADS) {
    b0[i] = w.b0[i];
    b1[i] = w.b1[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  float qm[8][4];
  if constexpr (SRC == PSRC_PATCH) {
    constexpr int TPI = PRO_WARPS / NB;            // sample tiles per item
    const bf16* rows = (const bf16*)src_a;
    const bf16* coef = (const bf16*)src_b;
    const int nrb = R / NB, row_len = n_pos * C, nst = (S + PT - 1) / PT,
              groups = (nst + TPI - 1) / TPI, n_items = nrb * groups;
    const int rows_cap = PT * TPI * row_len * 2, coef_cap = PT * TPI * n_pos * 2;
    bf16* tiles = (bf16*)(ring + 2 * stage_bytes);  // [8 x 16 x 72], warp w's tile w
    bf16* ht = tiles + warp * PT * PRO_LDW;
    const int ri = warp % NB, jt = warp / NB;       // the warp's ray and sample tile
    const int n_steps = blockIdx.x < n_items ? ((n_items - 1 - blockIdx.x) / gridDim.x + 1) * V : 0;

    // step k (item k / V of the block's, view k % V) into stage k % 2: the
    // rows span, then NB coefficient spans, each 16-byte aligned; always one
    // commit group
    auto issue = [&](int k) {
      if (k < n_steps) {
        const int item = blockIdx.x + (k / V) * gridDim.x, v = k % V;
        const int rb = item / groups, sb = (item % groups) * PT * TPI;
        const int ns = min(PT * TPI, S - sb);
        unsigned char* st = ring + (k & 1) * stage_bytes;
        const int rchunks = ns * row_len / 8, cchunks = ns * n_pos / 8;
        const bf16* rsrc = rows + (((size_t)v * nrb + rb) * S + sb) * row_len;
        for (int i = tid; i < rchunks + NB * cchunks; i += PRO_THREADS) {
          if (i < rchunks) {
            cp_async16(st + 16 * i, rsrc + (size_t)8 * i);
          } else {
            const int ray = (i - rchunks) / cchunks, j = i - rchunks - ray * cchunks;
            const bf16* csrc = coef + (((size_t)v * R + rb * NB + ray) * S + sb) * n_pos;
            cp_async16(st + rows_cap + ray * coef_cap + 16 * j, csrc + (size_t)8 * j);
          }
        }
      }
      cp_async_commit();
    };

    issue(0);
    int k = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int rb = item / groups, sb = (item % groups) * PT * TPI;
      const int ns = min(PT * TPI, S - sb), s0 = sb + jt * PT;
      const int nrows = max(0, min(PT, S - s0));   // the warp's tokens in this item
      const size_t n0 = (size_t)(rb * NB + ri) * S + s0;
#pragma unroll
      for (int j = 0; j < 8; ++j) qm[j][0] = qm[j][1] = qm[j][2] = qm[j][3] = -INFINITY;
      for (int v = 0; v < V; ++v, ++k) {
        issue(k + 1);  // stage (k+1) % 2 was last read by step k - 1's combine
        cp_async_wait<1>();
        __syncthreads();  // step k landed; every warp is done with its tile
        const unsigned char* st = ring + (k & 1) * stage_bytes;
        const bf16* srows = (const bf16*)st;
        const bf16* scoef = (const bf16*)(st + rows_cap);
        for (int u = tid; u < PT * TPI * Cp; u += PRO_THREADS) {
          const int js = u / Cp, c = u - js * Cp;
          float acc[NB];
#pragma unroll
          for (int i = 0; i < NB; ++i) acc[i] = 0.f;
          if (c < C && js < ns) {
            const bf16* row = srows + js * row_len + c;
            const bf16* cf = scoef + js * n_pos;
            for (int p0 = 0; p0 < n_pos; p0 += 8) {
              float x[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(row[(p0 + e) * C]);
#pragma unroll
              for (int i = 0; i < NB; ++i) {
                const uint4 u4 = *(const uint4*)(cf + i * (coef_cap / 2) + p0);
                const __nv_bfloat162* k2 = (const __nv_bfloat162*)&u4;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float2 kf = __bfloat1622float2(k2[e]);
                  acc[i] = fmaf(x[2 * e], kf.x, acc[i]);
                  acc[i] = fmaf(x[2 * e + 1], kf.y, acc[i]);
                }
              }
            }
          }
          bf16* dst = tiles + ((js / PT) * NB) * PT * PRO_LDW + (js % PT) * PRO_LDW + c;
#pragma unroll
          for (int i = 0; i < NB; ++i) dst[i * PT * PRO_LDW] = __float2bfloat16(acc[i]);
        }
        __syncthreads();  // the A tiles are written
        if (nrows > 0) {
          auto fill = [&](int kk, uint32_t* a) {
            ldsm_x4(a, ht + (lane & 15) * PRO_LDW + kk * 16 + (lane >> 4) * 8);
          };
          prologue_tokens(fill, ks, W0, W1, b0, b1, qm, ht, hout + ((size_t)v * N + n0) * NW,
                          nrows);
        }
      }
      if (nrows > 0) store_qmax(qm, qout + n0 * NW, nrows);
    }
  } else {
    constexpr int STAGES = pro_stages<SRC>();
    const int rbytes = SRC == PSRC_RF ? ld * 2 : 8 * C;  // bytes per token row
    const int span = pro_span_bytes(rbytes);
    const size_t total = (size_t)V * N * rbytes;
    unsigned char* wring = ring + warp * (STAGES * stage_bytes + PRO_TILE_BYTES);
    bf16* ht = (bf16*)(wring + STAGES * stage_bytes);
    const int ntiles = (N + PT - 1) / PT, wstride = gridDim.x * PRO_WARPS,
              first = blockIdx.x * PRO_WARPS + warp;
    const int n_items = first < ntiles ? ((ntiles - 1 - first) / wstride + 1) * V : 0;

    // item k of the warp's (tile, view) sequence into stage k % STAGES;
    // always one commit group
    auto issue = [&](int k) {
      if (k < n_items) {
        const int n0 = (first + (k / V) * wstride) * PT, v = k % V;
        unsigned char* st = wring + (k % STAGES) * stage_bytes;
        const size_t b = ((size_t)v * N + n0) * rbytes;
        copy_span(st, src_a, b, min(b + (size_t)PT * rbytes, total), lane, 32);
        if (SRC == PSRC_LERP) {
          const size_t f = ((size_t)v * N + n0) * 8;
          copy_span(st + span, src_b, f, min(f + PT * 8, (size_t)V * N * 8), lane, 32);
        }
      }
      cp_async_commit();
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    int k = 0;
    for (int tile = first; tile < ntiles; tile += wstride) {
      const int n0 = tile * PT, nrows = min(PT, N - n0);
#pragma unroll
      for (int j = 0; j < 8; ++j) qm[j][0] = qm[j][1] = qm[j][2] = qm[j][3] = -INFINITY;
      for (int v = 0; v < V; ++v, ++k) {
        __syncwarp();  // every lane is done with the stage item k + STAGES - 1 refills
        issue(k + STAGES - 1);
        cp_async_wait<STAGES - 1>();
        __syncwarp();
        const unsigned char* st = wring + (k % STAGES) * stage_bytes;
        const size_t b = ((size_t)v * N + n0) * rbytes;
        const bf16* raw = (const bf16*)(st + (((uintptr_t)src_a + b) & 15));
        float wt[2][4] = {};
        if (SRC == PSRC_LERP) {
          const size_t f = ((size_t)v * N + n0) * 8;
          const float* fr = (const float*)(st + span + (((uintptr_t)src_b + f) & 15));
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = min(g + 8 * hr, nrows - 1);
            const float fx = fr[2 * r], fy = fr[2 * r + 1];
            const float wx0 = fmaxf(0.f, 1.f - fabsf(fx)), wx1 = fmaxf(0.f, 1.f - fabsf(fx - 1.f));
            const float wy0 = fmaxf(0.f, 1.f - fabsf(fy)), wy1 = fmaxf(0.f, 1.f - fabsf(fy - 1.f));
            wt[hr][0] = wx0 * wy0;
            wt[hr][1] = wx1 * wy0;
            wt[hr][2] = wx0 * wy1;
            wt[hr][3] = wx1 * wy1;
          }
        }
        auto fill = [&](int kk, uint32_t* a) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // regs (g, 2t..) (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..)
            const int row = g + 8 * (q & 1), col = kk * 16 + 2 * t + 8 * (q >> 1);
            const float* wq = wt[q & 1];
            a[q] = pro_elem<SRC>(raw, ld, C, nrows, row, col, wq) |
                   pro_elem<SRC>(raw, ld, C, nrows, row, col + 1, wq) << 16;
          }
        };
        prologue_tokens(fill, ks, W0, W1, b0, b1, qm, ht, hout + ((size_t)v * N + n0) * NW,
                        nrows);
      }
      store_qmax(qm, qout + (size_t)n0 * NW, nrows);
    }
  }
  cp_async_wait<0>();  // the empty groups past the end
}

// One prologue launch's operands (gnt_prologue_forward): src_a / src_b are
// rf / -, rows / coef, or quad rows / frac for PSRC_RF / PSRC_PATCH /
// PSRC_LERP.
struct ProArgs {
  int src;
  const void* a;
  const void* b;
  int ld, V, R, S, C, Cp, n_pos, nb;
  HeadW w;
  void* h;
  void* q;
};

// Launch k_prologue<SRC, NB> on `stream`, or with attrs (int[4]) only report
// its registers per thread, local memory bytes per thread, shared memory per
// block and resident blocks per SM. Returns a cudaError_t.
template <int SRC, int NB>
static int prologue_run(const ProArgs& p, cudaStream_t stream, int* attrs) {
  void (*kern)(const void*, const void*, int, int, int, int, int, int, int, HeadW, bf16*,
               float*, int) = k_prologue<SRC, NB>;
  int stage, smem;
  if (SRC == PSRC_PATCH) {
    stage = (PRO_WARPS / NB) * PT * (p.n_pos * p.C + NB * p.n_pos) * 2;
    smem = pro_wbytes(p.Cp) + 2 * stage + PRO_WARPS * PRO_TILE_BYTES;
  } else {
    stage = SRC == PSRC_RF ? pro_span_bytes(p.ld * 2) : pro_span_bytes(8 * p.C) + PRO_FRAC_BYTES;
    smem = pro_wbytes(p.Cp) + PRO_WARPS * (pro_stages<SRC>() * stage + PRO_TILE_BYTES);
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, PRO_THREADS, smem);
  if (!err) err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (attrs) {
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kern))) return (int)err;
    attrs[0] = fa.numRegs;
    attrs[1] = (int)fa.localSizeBytes;
    attrs[2] = smem;
    attrs[3] = per_sm;
    return 0;
  }
  const int N = p.R * p.S;
  int want;
  if (SRC == PSRC_PATCH) {
    const int tpi = PRO_WARPS / NB, groups = ((p.S + PT - 1) / PT + tpi - 1) / tpi;
    want = p.R / NB * groups;
  } else {
    want = ((N + PT - 1) / PT + PRO_WARPS - 1) / PRO_WARPS;
  }
  const int grid = want < per_sm * sms ? want : per_sm * sms;
  k_prologue<SRC, NB><<<grid, PRO_THREADS, smem, stream>>>(
      p.a, p.b, p.ld, p.V, p.R, p.S, p.C, p.Cp, p.n_pos, p.w, (bf16*)p.h, (float*)p.q, stage);
  return (int)cudaGetLastError();
}

// Check a prologue's operands and run the loader for its source. Returns a
// cudaError_t (cudaErrorInvalidValue for what the kernel does not take).
static int prologue_dispatch(const ProArgs& p, cudaStream_t stream, int* attrs = nullptr) {
  if (p.V < 1 || p.V > MAX_VIEWS || p.R < 1 || p.S < 1 || p.C < 1 || p.Cp % 16 ||
      p.Cp > MAX_CP || p.C > p.Cp || (!attrs && (!p.a || !p.h || !p.q)))
    return (int)cudaErrorInvalidValue;
  if (p.src == PSRC_RF) {
    if (p.ld < p.C || p.ld > p.Cp + 1) return (int)cudaErrorInvalidValue;
    return prologue_run<PSRC_RF, 1>(p, stream, attrs);
  }
  if (p.src == PSRC_LERP) {
    if (!attrs && !p.b) return (int)cudaErrorInvalidValue;
    return prologue_run<PSRC_LERP, 1>(p, stream, attrs);
  }
  if (p.src != PSRC_PATCH || p.nb < 1 || p.n_pos < 8 || p.n_pos > MAX_NPOS || p.n_pos % 8 ||
      p.R % p.nb || (!attrs && (!p.b || ((uintptr_t)p.a & 15) || ((uintptr_t)p.b & 15))))
    return (int)cudaErrorInvalidValue;
  if (p.nb == 8) return prologue_run<PSRC_PATCH, 8>(p, stream, attrs);
  if (p.nb == 4) return prologue_run<PSRC_PATCH, 4>(p, stream, attrs);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// k_view: one view transformer block (+ q_fc_0/1 when has_qfc), q_in -> q_out.
// VSRC_SPLIT reads no pts, centres or view code and needs has_qfc == 0. rd16 /
// pos16 (K2's unfolded modes, may be null): the bf16 ray-diff code [V, N, 4]
// / point + view code [N, 126] read in place of making them; pts may be null
// when neither is made and validity is read.
//
// A persistent grid: each block stages the block's weights in shared memory
// once with cp.async, then every warp walks its own tiles of VT = 16 tokens
// (tiles blockIdx.x * VIEW_WARPS + warp, then + gridDim.x * VIEW_WARPS, ...)
// with no block barrier. Per tile, in mma.sync m16n8k16 registers:
//
//   validity of every (token, view) once (two lanes per token, views split
//   even / odd; a token with no valid view attends to all of them), x =
//   LN(q), the q side of attn_fc[0] (x @ (wq @ wa0)); then the views, whose
//   h rows (16 x 128 B, one contiguous span of [V, N, 64]) and read ray-diff
//   codes stream through a VSTAGES-deep cp.async ring of the warp's own
//   (the flattened (tile, view) sequence, so the next tile's first views
//   load during this tile's epilogue). Per view: pos_fc_0 of the ray-diff
//   code into the stage row beside h, the composed [72 x 72] product (val |
//   the k side of a0) with the biases as the accumulators' start, t =
//   relu(a0) repacked in registers as the bf16 A operand of the logit
//   product attn_fc[2] (m16n8k8), and per (token, channel) the online
//   softmax with one ex2 per element (of the old max and the new logit only
//   the smaller one's exponential is not 1).
//   Then agg / den repacked as out_fc's A operand, the residual (q reloaded,
//   L2), LN, the 64 -> 256 -> 64 feed-forward in four hidden chunks, and
//   q_fc on [q | point code | view code] (the code staged in the free ring
//   stage in two 64-column halves). One f32 store per element below N.
//
// q may be updated in place (q_in == q_out, K1 / K2): each token is read and
// written by the one warp that owns its tile, which reads its rows (at the
// tile's start and again for the residual) before it writes them.
// ---------------------------------------------------------------------------
#define VIEW_WARPS 8
#define VIEW_THREADS (32 * VIEW_WARPS)
#define VT 16            // tokens per warp tile (one mma m-tile)
#define VSTAGES 3        // the per-warp h ring
#define VIEW_LDH 88      // stage row [h (64) | pos_in (8) | -]: smem row strides
#define VIEW_LDB 88      // (bf16) are an odd number of 16-byte units, so the
#define VIEW_LDQA 24     // 8 rows of an ldmatrix fall in distinct banks
#define VIEW_LDW 72
#define VIEW_LDF1 264
#define VSTAGE_BYTES (VT * VIEW_LDH * 2 + VT * 16)  // h + pos_in rows, read ray-diff code
#define LOG2E 1.4426950408889634f
// f32 parameters in shared memory (offsets in floats, all even)
#define P_LNS 0
#define P_LNB 64
#define P_BBIG 128   // 72: val bias (64), a0 bias (8)
#define P_P0 200     // pos_fc_0 [4 x 8]
#define P_P0B 232
#define P_BA1 240
#define P_BOUT 304
#define P_FLNS 368
#define P_FLNB 432
#define P_BF1 496    // 256
#define P_BF2 752
#define P_BQ0 816
#define P_BQ1 880
#define VIEW_NPAR 944
#define VIEW_NGEO (MAX_VIEWS * 12 + (MAX_VIEWS + 1) * 3 + 1)  // proj rows, centres

static constexpr size_t VIEW_WBYTES =
    ((size_t)(NW + PH) * VIEW_LDB + NW * VIEW_LDQA + PH * VIEW_LDW + NW * VIEW_LDW +
     NW * VIEW_LDF1 + 4 * NW * VIEW_LDW + 3 * NW * VIEW_LDW + NW * VIEW_LDW) * 2;
static constexpr size_t VIEW_SMEM = VIEW_WBYTES +
    (size_t)VIEW_WARPS * VSTAGES * VSTAGE_BYTES + (size_t)(VIEW_NPAR + VIEW_NGEO) * 4;

template <int VSRC>
__global__ void __launch_bounds__(VIEW_THREADS, 1)
k_view(const bf16* __restrict__ h, const float* q_in, float* q_out,
       const float* __restrict__ pts, const float* __restrict__ vcode,
       const float* __restrict__ centers, const float* __restrict__ proj,
       const uint8_t* __restrict__ mask, const float* __restrict__ ray_diff,
       const bf16* __restrict__ rd16, const bf16* __restrict__ pos16,
       int V, int N, int S, float hf, float wf, ViewW w, int has_qfc) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Wb = (bf16*)smem;                         // wbig rows 0..71: [h | pos_in] -> [val | a0 | 0]
  bf16* Wqa = Wb + (NW + PH) * VIEW_LDB;          // [64 x 16] wq @ wa0
  bf16* Wa1 = Wqa + NW * VIEW_LDQA;               // [8 x 64] attn_fc[2]
  bf16* Wo = Wa1 + PH * VIEW_LDW;                 // [64 x 64]
  bf16* Wf1 = Wo + NW * VIEW_LDW;                 // [64 x 256]
  bf16* Wf2 = Wf1 + NW * VIEW_LDF1;               // [256 x 64]
  bf16* Wq0 = Wf2 + 4 * NW * VIEW_LDW;            // [192 x 64]
  bf16* Wq1 = Wq0 + 3 * NW * VIEW_LDW;            // [64 x 64]
  unsigned char* ring = smem + VIEW_WBYTES;       // [warps x stages] of VSTAGE_BYTES
  float* par = (float*)(ring + VIEW_WARPS * VSTAGES * VSTAGE_BYTES);
  float* geo = par + VIEW_NPAR;                   // proj [V x 12], centres at MAX_VIEWS * 12
  float* ctr = geo + MAX_VIEWS * 12;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2,
            t = lane & 3;
  cp_rows(Wb, VIEW_LDB, w.wbig, 80, NW + PH);
  cp_rows(Wqa, VIEW_LDQA, w.wqa0, 16, NW);
  cp_rows(Wa1, VIEW_LDW, w.wa1, NW, PH);
  cp_rows(Wo, VIEW_LDW, w.wout, NW, NW);
  cp_rows(Wf1, VIEW_LDF1, w.wf1, 4 * NW, NW);
  cp_rows(Wf2, VIEW_LDW, w.wf2, NW, 4 * NW);
  if (has_qfc) {
    cp_rows(Wq0, VIEW_LDW, w.wq0, NW, 3 * NW);
    cp_rows(Wq1, VIEW_LDW, w.wq1, NW, NW);
  }
  cp_async_commit();
  auto put = [&](int off, const float* src, int n) {
    for (int i = tid; i < n; i += VIEW_THREADS) par[off + i] = src[i];
  };
  put(P_LNS, w.ln_s, NW);
  put(P_LNB, w.ln_b, NW);
  put(P_BBIG, w.bbig, NW + PH);
  put(P_P0, w.p0, 4 * PH);
  put(P_P0B, w.p0b, PH);
  put(P_BA1, w.ba1, NW);
  put(P_BOUT, w.bout, NW);
  put(P_FLNS, w.fln_s, NW);
  put(P_FLNB, w.fln_b, NW);
  put(P_BF1, w.bf1, 4 * NW);
  put(P_BF2, w.bf2, NW);
  if (has_qfc) {
    put(P_BQ0, w.bq0, NW);
    put(P_BQ1, w.bq1, NW);
  }
  if (VSRC == VSRC_PROJ) for (int i = tid; i < V * 12; i += VIEW_THREADS) geo[i] = proj[i];
  if (VSRC != VSRC_SPLIT && !rd16)
    for (int i = tid; i < (V + 1) * 3; i += VIEW_THREADS) ctr[i] = centers[i];
  cp_async_wait<0>();
  __syncthreads();  // the only block barrier: warps are independent from here

  unsigned char* wring = ring + warp * VSTAGES * VSTAGE_BYTES;
  const int ntiles = (N + VT - 1) / VT, wstride = gridDim.x * VIEW_WARPS,
            first = blockIdx.x * VIEW_WARPS + warp;
  const int n_items = first < ntiles ? ((ntiles - 1 - first) / wstride + 1) * V : 0;
  const int tk = lane >> 1, half = lane & 1;  // a token of the tile, two lanes each

  // item k of the warp's (tile, view) sequence into ring stage k % VSTAGES:
  // h rows (tokens past N read token N-1's), the read ray-diff code; always
  // one commit group per item, empty past the end
  auto issue = [&](int k) {
    if (k < n_items) {
      const int n0 = (first + (k / V) * wstride) * VT, v = k % V;
      unsigned char* st = wring + (k % VSTAGES) * VSTAGE_BYTES;
      bf16* sh = (bf16*)st;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = lane + 32 * c, r = i >> 3, c8 = i & 7;
        const int n = min(n0 + r, N - 1);
        cp_async16(sh + r * VIEW_LDH + c8 * 8, h + ((size_t)v * N + n) * NW + c8 * 8);
      }
      unsigned char* srd = st + VT * VIEW_LDH * 2;
      if (lane < VT) {
        const size_t vn = (size_t)v * N + min(n0 + lane, N - 1);
        if (VSRC == VSRC_SPLIT) cp_async16(srd + lane * 16, ray_diff + vn * 4);
        else if (rd16) cp_async8(srd + lane * 8, rd16 + vn * 4);
      }
    }
    cp_async_commit();
  };

  float mx[8][4], den[8][4], agg[8][4], qb[4];
  float px = 0.f, py = 0.f, pz = 0.f;  // token tk's point
  issue(0);
  issue(1);
  int k = 0;  // the warp's item
  for (int tile = first; tile < ntiles; tile += wstride) {
    const int n0 = tile * VT;
    // the tile's validity, LN(q) and the q side of a0
    unsigned vm0, vm1;  // the valid views of rows g and g + 8
    {
      const int n = min(n0 + tk, N - 1);
      if (VSRC != VSRC_SPLIT && pts) {
        px = pts[(size_t)n * 3];
        py = pts[(size_t)n * 3 + 1];
        pz = pts[(size_t)n * 3 + 2];
      }
      unsigned m = 0;
      for (int vv = half; vv < V; vv += 2)
        if (view_valid<VSRC>(mask, geo, vv, N, n, px, py, pz, hf, wf)) m |= 1u << vv;
      m |= __shfl_xor_sync(0xffffffffu, m, 1);
      if (!m) m = V == 32 ? 0xffffffffu : (1u << V) - 1u;  // none valid: attend to all
      vm0 = __shfl_sync(0xffffffffu, m, 2 * g);
      vm1 = __shfl_sync(0xffffffffu, m, 2 * g + 16);
      float x[8][4];
      uint32_t a[4][4];
      load_rows(x, q_in, n0, N);
      ln_rows(x, par + P_LNS, par + P_LNB, x);
      frag_to_a(x, a, 4);
      float qa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];
        ldb_kn(b, Wqa, VIEW_LDQA, kk * 16, 0);
        mma16816(qa, a[kk], b[0], b[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) qb[e] = par[P_BBIG + NW + 2 * t + (e & 1)] - qa[e];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mx[j][e] = -INFINITY;
          den[j][e] = 0.f;
          agg[j][e] = 0.f;
        }
    }
    bf16* sh = nullptr;
    for (int v = 0; v < V; ++v, ++k) {
      __syncwarp();  // every lane is done with the stage item k + 2 refills
      issue(k + 2);
      cp_async_wait<2>();
      __syncwarp();
      unsigned char* st = wring + (k % VSTAGES) * VSTAGE_BYTES;
      sh = (bf16*)st;

      // pos_in = relu(pos_fc_0(ray-diff code of (tk, v))), 4 columns a lane
      {
        float rd[4];
        const unsigned char* srd = st + VT * VIEW_LDH * 2;
        if (VSRC == VSRC_SPLIT) {
          const float4 r4 = *(const float4*)(srd + tk * 16);
          rd[0] = r4.x; rd[1] = r4.y; rd[2] = r4.z; rd[3] = r4.w;
        } else if (rd16) {
          const __nv_bfloat162* r2 = (const __nv_bfloat162*)(srd + tk * 8);
          const float2 lo = __bfloat1622float2(r2[0]), hi = __bfloat1622float2(r2[1]);
          rd[0] = lo.x; rd[1] = lo.y; rd[2] = hi.x; rd[3] = hi.y;
        } else {
          ray_diff_code(ctr, v, px, py, pz, rd);
        }
        float p[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = half * 4 + jj;
          float s = par[P_P0B + j];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) s += rd[kk] * par[P_P0 + kk * PH + j];
          p[jj] = fmaxf(s, 0.f);
        }
        *(uint2*)(sh + tk * VIEW_LDH + NW + half * 4) =
            make_uint2(pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]));
      }
      __syncwarp();

      // [val | a0] = [h_v | pos_in] @ wbig + [bbig | bbig_a0 - qa]
      float acc[9][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b2 = *(const float2*)(par + P_BBIG + 8 * j + 2 * t);
        acc[j][0] = acc[j][2] = b2.x;
        acc[j][1] = acc[j][3] = b2.y;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[8][e] = qb[e];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4], b[4];
        ldsm_x4(a, sh + (lane & 15) * VIEW_LDH + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          ldb_kn(b, Wb, VIEW_LDB, kk * 16, np * 16);
          mma16816(acc[2 * np], a, b[0], b[1]);
          mma16816(acc[2 * np + 1], a, b[2], b[3]);
        }
        ldb_kn(b, Wb, VIEW_LDB, kk * 16, NW);
        mma16816(acc[8], a, b[0], b[1]);
      }
      {  // the pos_in rows of wbig: one k-step of 8
        uint32_t a8[2], b[4];
        ldsm_x2(a8, sh + (lane & 15) * VIEW_LDH + NW);
        const bf16* brow = Wb + (NW + (lane & 7)) * VIEW_LDB;
#pragma unroll
        for (int nq = 0; nq < 2; ++nq) {
          ldsm_x4_t(b, brow + nq * 32 + (lane >> 3) * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma16808(acc[4 * nq + i], a8, b[i]);
        }
        ldsm_x2_t(b, brow + NW + ((lane >> 3) & 1) * 8);
        mma16808(acc[8], a8, b[0]);
      }

      // lg = bf16(relu(a0)) @ wa1 + ba1, then the online softmax per element
      uint32_t ta[2], bl[8];
      ta[0] = pack_bf16(fmaxf(acc[8][0], 0.f), fmaxf(acc[8][1], 0.f));
      ta[1] = pack_bf16(fmaxf(acc[8][2], 0.f), fmaxf(acc[8][3], 0.f));
      ldsm_x4_t(bl, Wa1 + (lane & 7) * VIEW_LDW + (lane >> 3) * 8);
      ldsm_x4_t(bl + 4, Wa1 + (lane & 7) * VIEW_LDW + 32 + (lane >> 3) * 8);
      const bool ok0 = (vm0 >> v) & 1u, ok1 = (vm1 >> v) & 1u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b2 = *(const float2*)(par + P_BA1 + 8 * j + 2 * t);
        float lg[4] = {b2.x, b2.y, b2.x, b2.y};
        mma16808(lg, ta, bl[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = (e < 2 ? ok0 : ok1) ? lg[e] - mx[j][e] : -INFINITY;
          const float ed = ex2(-fabsf(d) * LOG2E);
          const bool up = d > 0.f;
          const float sc = up ? ed : 1.f, p = up ? 1.f : ed;
          mx[j][e] = up ? lg[e] : mx[j][e];
          den[j][e] = fmaf(den[j][e], sc, p);
          agg[j][e] = fmaf(agg[j][e], sc, p * acc[j][e]);
        }
      }
    }

    {
      // x = out_fc(agg / den) + q
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) agg[j][e] /= den[j][e];
      frag_to_a(agg, a, 4);
      float x[8][4];
      load_rows(x, q_in, n0, N);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        float o[2][4] = {};
        mma_pair(o, a, Wo, VIEW_LDW, np * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 b2 = *(const float2*)(par + P_BOUT + np * 16 + 8 * i + 2 * t);
          x[2 * np + i][0] += o[i][0] + b2.x;
          x[2 * np + i][1] += o[i][1] + b2.y;
          x[2 * np + i][2] += o[i][2] + b2.x;
          x[2 * np + i][3] += o[i][3] + b2.y;
        }
      }
      // x += ff(ff_norm(x)), the hidden layer in chunks of 64
      {
        float y[8][4];
        ln_rows(x, par + P_FLNS, par + P_FLNB, y);
        frag_to_a(y, a, 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
#pragma unroll 1
        for (int hc = 0; hc < 4; ++hc) {
          float hid[8][4];
          uint32_t ha[4][4];
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            float o[2][4] = {};
            mma_pair(o, a, Wf1, VIEW_LDF1, hc * NW + np * 16);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float2 b2 =
                  *(const float2*)(par + P_BF1 + hc * NW + np * 16 + 8 * i + 2 * t);
              hid[2 * np + i][0] = fmaxf(o[i][0] + b2.x, 0.f);
              hid[2 * np + i][1] = fmaxf(o[i][1] + b2.y, 0.f);
              hid[2 * np + i][2] = fmaxf(o[i][2] + b2.x, 0.f);
              hid[2 * np + i][3] = fmaxf(o[i][3] + b2.y, 0.f);
            }
          }
          frag_to_a(hid, ha, 4);
#pragma unroll
          for (int np = 0; np < 4; ++np)
            mma_pair(&y[2 * np], ha, Wf2 + hc * NW * VIEW_LDW, VIEW_LDW, np * 16);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b2 = *(const float2*)(par + P_BF2 + 8 * j + 2 * t);
          x[j][0] += y[j][0] + b2.x;
          x[j][1] += y[j][1] + b2.y;
          x[j][2] += y[j][2] + b2.x;
          x[j][3] += y[j][3] + b2.y;
        }
      }
      if (has_qfc) {
        // q = q_fc_1(relu(q_fc_0([q | pts_code | view_code])))  (K = 192): the
        // code's two 64-column halves staged in turn in the last view's stage,
        // free until the next tile's first view refills it
        bf16* cb = sh;  // [16 x VIEW_LDW]
        float hq[8][4];
        frag_to_a(x, a, 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b2 = *(const float2*)(par + P_BQ0 + 8 * j + 2 * t);
          hq[j][0] = hq[j][2] = b2.x;
          hq[j][1] = hq[j][3] = b2.y;
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) mma_pair(&hq[2 * np], a, Wq0, VIEW_LDW, np * 16);
        const int n = min(n0 + tk, N - 1);
#pragma unroll 1
        for (int part = 0; part < 2; ++part) {
          bf16* row = cb + tk * VIEW_LDW;
          if (pos16) {  // code columns 64 * part + 32 * half .. + 31
            const uint32_t* src = (const uint32_t*)(pos16 + (size_t)n * 2 * POSENC +
                                                    64 * part + 32 * half);
            uint32_t* dst = (uint32_t*)(row + 32 * half);
            const int nw = part == 1 && half == 1 ? 15 : 16;  // 126 columns, then 0
            for (int i = 0; i < 16; ++i) dst[i] = i < nw ? src[i] : 0u;
          } else if (part == 0) {  // [pts (3) | sin, cos x 10 octaves (60) | view code 0]
            if (half == 0) {
              const float p3[3] = {px, py, pz};
              float s3[3], c3[3];
#pragma unroll
              for (int kk = 0; kk < 3; ++kk) {
                row[kk] = __float2bfloat16(p3[kk]);
                s3[kk] = sinf(p3[kk]);
                c3[kk] = cosf(p3[kk]);
              }
#pragma unroll
              for (int f = 0; f < 10; ++f) {
#pragma unroll
                for (int kk = 0; kk < 3; ++kk) {
                  row[3 + 6 * f + kk] = __float2bfloat16(s3[kk]);
                  row[6 + 6 * f + kk] = __float2bfloat16(c3[kk]);
                  const float s2 = 2.f * s3[kk] * c3[kk];
                  const float c2 = c3[kk] * c3[kk] - s3[kk] * s3[kk];
                  s3[kk] = s2;
                  c3[kk] = c2;
                }
              }
            } else {
              row[POSENC] = __float2bfloat16(vcode[(size_t)(n / S) * POSENC]);
            }
          } else {  // view code 1..62, then 0
            const float* vc = vcode + (size_t)(n / S) * POSENC + 1;
            for (int c = 32 * half; c < 32 * half + 32; ++c)
              row[c] = __float2bfloat16(c < POSENC - 1 ? vc[c] : 0.f);
          }
          __syncwarp();
          uint32_t ca[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldsm_x4(ca[kk], cb + (lane & 15) * VIEW_LDW + kk * 16 + (lane >> 4) * 8);
          __syncwarp();
#pragma unroll
          for (int np = 0; np < 4; ++np)
            mma_pair(&hq[2 * np], ca, Wq0 + (1 + part) * NW * VIEW_LDW, VIEW_LDW,
                     np * 16);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hq[j][e] = fmaxf(hq[j][e], 0.f);
        frag_to_a(hq, a, 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b2 = *(const float2*)(par + P_BQ1 + 8 * j + 2 * t);
          x[j][0] = x[j][2] = b2.x;
          x[j][1] = x[j][3] = b2.y;
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) mma_pair(&x[2 * np], a, Wq1, VIEW_LDW, np * 16);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = n0 + g + 8 * hr;
        if (r < N) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *(float2*)(q_out + (size_t)r * NW + 8 * j + 2 * t) =
                make_float2(x[j][2 * hr], x[j][2 * hr + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the end
}

// ---------------------------------------------------------------------------
// k_ray: one ray transformer block, q_in -> q (the same buffer in K1 / K2).
// A persistent grid: each block stages the block's weights in shared memory
// once, then takes rays blockIdx.x, blockIdx.x + gridDim.x, ... For each ray:
//
//   A. K and V of every sample (LN, the k / v columns of wqkv) into the
//      block's slab of kv ([Sk x 128] bf16, Sk = S padded to the key tile;
//      pad rows are LN(0) projected, finite, and masked out of the softmax).
//   B. the queries in chunks of 16 * RAY_WARPS rows, one warp per 16 rows and
//      all four heads: LN, Q, then the key tiles of kv streamed through a
//      cp.async double buffer with an online softmax per (row, head), scores
//      and probabilities in mma.sync registers (the QK^T accumulator rescaled,
//      exponentiated and repacked as the A operand of P.V), out_fc, the
//      residual, LN, the 64 -> 256 -> 64 feed-forward in four hidden chunks,
//      the residual, one f32 store per element of the rows below S.
//
// want_w: query 0's final max and sum are kept, and a second pass over the
// keys writes the head-mean of its normalized attention row; final: then rgb
// and the weighted valid-view count (K1 / K2's last block).
// ---------------------------------------------------------------------------
#define RAY_WARPS 8
#define RAY_THREADS (32 * RAY_WARPS)
#define KT 64            // keys per streamed tile
#define RAY_LDQKV 200    // smem row strides (bf16): 16 bytes past a multiple
#define RAY_LDW 72       // of 128, so ldmatrix rows fall in distinct banks
#define RAY_LDF1 264
#define RAY_LDKV 136
#define RAY_NPAR 640     // ln_s, ln_b, bo, fln_s, fln_b, bf2 (64 each), bf1 (256)
// QK^T scale 1/sqrt(16) with log2(e) folded in, for ex2
#define SCORE_C (0.25f * LOG2E)

static constexpr size_t RAY_SMEM =
    ((size_t)NW * RAY_LDQKV + NW * RAY_LDW + NW * RAY_LDF1 + 4 * NW * RAY_LDW +
     2 * KT * RAY_LDKV) * 2 +
    (size_t)(RAY_NPAR + NW + 8 + NW + 4) * 4;

// One key tile (KT keys from key0, K columns 0..63 and V columns 64..127 of
// kt) for the warp's 16 query rows and all four heads: scores in registers,
// the online max / sum per (row, head), P.V into o.
__device__ __forceinline__ void attend_tile(const bf16* kt, int key0, int S,
                                            uint32_t (*qa)[4], float (*o)[2][4],
                                            float (*mrow)[2], float (*lrow)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldb_nk(b, kt, RAY_LDKV, h * HD, np * 16);
      mma16816(s[2 * np], qa[h], b[0], b[1]);
      mma16816(s[2 * np + 1], qa[h], b[2], b[3]);
    }
    if (key0 + KT > S) {  // pad keys take no part
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + 2 * t + (e & 1) >= S) s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(mrow[h][hr], mx);  // finite: every tile has a key < S
      const float alpha = ex2((mrow[h][hr] - mn) * SCORE_C);
      const float mc = mn * SCORE_C;
      float l = lrow[h][hr] * alpha;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[h][i][2 * hr] *= alpha;
        o[h][i][2 * hr + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = ex2(fmaf(s[j][2 * hr], SCORE_C, -mc));
        const float p1 = ex2(fmaf(s[j][2 * hr + 1], SCORE_C, -mc));
        s[j][2 * hr] = p0;
        s[j][2 * hr + 1] = p1;
        l += p0 + p1;
      }
      mrow[h][hr] = mn;
      lrow[h][hr] = l;
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pa[4], b[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      ldb_kn(b, kt + NW, RAY_LDKV, kk * 16, h * HD);
      mma16816(o[h][0], pa, b[0], b[1]);
      mma16816(o[h][1], pa, b[2], b[3]);
    }
  }
}

template <int VSRC>
__global__ void __launch_bounds__(RAY_THREADS, 1)
k_ray(const float* q_in, float* q, bf16* __restrict__ kv, const float* __restrict__ pts,
      const float* __restrict__ proj, const uint8_t* __restrict__ mask, int V, int R,
      int S, float hf, float wf, RayW w, int want_w, int final_, FinalW fw,
      float* __restrict__ rgb_out, float* __restrict__ w_out,
      float* __restrict__ cnt_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Wqkv = (bf16*)smem;                        // [64 x 200]: [q_h | k_h | v_h] x 4
  bf16* Wo = Wqkv + NW * RAY_LDQKV;                // [64 x 72]
  bf16* Wf1 = Wo + NW * RAY_LDW;                   // [64 x 264]
  bf16* Wf2 = Wf1 + NW * RAY_LDF1;                 // [256 x 72]
  bf16* KVt = Wf2 + 4 * NW * RAY_LDW;              // 2 x [KT x 136]
  float* par = (float*)(KVt + 2 * KT * RAY_LDKV);  // [RAY_NPAR]
  float* q0s = par + RAY_NPAR;                     // query 0's q (bf16 values)
  float* m0s = q0s + NW;                           // its max and sum per head
  float* l0s = m0s + HEADS;
  float* pool = l0s + HEADS;                       // [64 + 4]: LN sums, count
  const float* ln_s = par;
  const float* ln_b = par + NW;
  const float* bo = par + 2 * NW;
  const float* fln_s = par + 3 * NW;
  const float* fln_b = par + 4 * NW;
  const float* bf2 = par + 5 * NW;
  const float* bf1 = par + 6 * NW;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2,
            t = lane & 3;
  const int Sk = (S + KT - 1) / KT * KT, ntile = Sk / KT, nrg = (S + 15) / 16;
  bf16* kvb = kv + (size_t)blockIdx.x * Sk * 2 * NW;

  cp_rows(Wqkv, RAY_LDQKV, w.wqkv, 3 * NW, NW);
  cp_rows(Wo, RAY_LDW, w.wo, NW, NW);
  cp_rows(Wf1, RAY_LDF1, w.wf1, 4 * NW, NW);
  cp_rows(Wf2, RAY_LDW, w.wf2, NW, 4 * NW);
  cp_async_commit();
  for (int i = tid; i < NW; i += RAY_THREADS) {
    par[i] = w.ln_s[i];
    par[NW + i] = w.ln_b[i];
    par[2 * NW + i] = w.bo[i];
    par[3 * NW + i] = w.fln_s[i];
    par[4 * NW + i] = w.fln_b[i];
    par[5 * NW + i] = w.bf2[i];
  }
  for (int i = tid; i < 4 * NW; i += RAY_THREADS) par[6 * NW + i] = w.bf1[i];
  if (tid < NW + 4) pool[tid] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  for (int ray = blockIdx.x; ray < R; ray += gridDim.x) {
    const float* qi = q_in + (size_t)ray * S * NW;
    float* qo = q + (size_t)ray * S * NW;

    // A. K, V of samples 0 .. Sk - 1 into the block's slab
    for (int rg = warp; rg < Sk / 16; rg += RAY_WARPS) {
      float x[8][4];
      uint32_t a[4][4];
      load_rows(x, qi, rg * 16, S);
      ln_rows(x, ln_s, ln_b, x);
      frag_to_a(x, a, 4);
#pragma unroll
      for (int h = 0; h < HEADS; ++h) {
#pragma unroll
        for (int part = 1; part <= 2; ++part) {  // k_h, then v_h
          float acc[2][4] = {};
          mma_pair(acc, a, Wqkv, RAY_LDQKV, h * 3 * HD + part * HD);
          store_pair(kvb, 2 * NW, rg * 16, (part - 1) * NW + h * HD, acc);
        }
      }
    }
    __threadfence();
    __syncthreads();

    // B. queries, 16 rows per warp
    for (int c0 = 0; c0 < nrg; c0 += RAY_WARPS) {
      const int rg = c0 + warp;
      const bool act = rg < nrg;
      float x[8][4], o[HEADS][2][4], mrow[HEADS][2], lrow[HEADS][2];
      uint32_t qa[HEADS][4];
      if (act) {
        uint32_t a[4][4];
        float y[8][4];
        load_rows(x, qi, rg * 16, S);
        ln_rows(x, ln_s, ln_b, y);
        frag_to_a(y, a, 4);
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          float acc[2][4] = {};
          mma_pair(acc, a, Wqkv, RAY_LDQKV, h * 3 * HD);
          frag_to_a(acc, &qa[h], 1);
        }
      }
#pragma unroll
      for (int h = 0; h < HEADS; ++h) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mrow[h][hr] = -INFINITY;
          lrow[h][hr] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) o[h][i][0] = o[h][i][1] = o[h][i][2] = o[h][i][3] = 0.f;
      }
      auto load_tile = [&](int ti) {
        bf16* dst = KVt + (ti & 1) * KT * RAY_LDKV;
        const bf16* src = kvb + (size_t)ti * KT * 2 * NW;
        for (int i = tid; i < KT * 16; i += RAY_THREADS)
          cp_async16(dst + (i >> 4) * RAY_LDKV + (i & 15) * 8, src + (size_t)i * 8);
        cp_async_commit();
      };
      load_tile(0);
      for (int ti = 0; ti < ntile; ++ti) {
        if (ti + 1 < ntile) {
          load_tile(ti + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (act) attend_tile(KVt + (ti & 1) * KT * RAY_LDKV, ti * KT, S, qa, o, mrow, lrow);
        __syncthreads();
      }
      if (!act) continue;

      // normalize, out_fc, residual
      uint32_t oa[HEADS][4];
#pragma unroll
      for (int h = 0; h < HEADS; ++h) {
        float inv[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float l = lrow[h][hr];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          lrow[h][hr] = l;
          inv[hr] = 1.f / l;
        }
        oa[h][0] = pack_bf16(o[h][0][0] * inv[0], o[h][0][1] * inv[0]);
        oa[h][1] = pack_bf16(o[h][0][2] * inv[1], o[h][0][3] * inv[1]);
        oa[h][2] = pack_bf16(o[h][1][0] * inv[0], o[h][1][1] * inv[0]);
        oa[h][3] = pack_bf16(o[h][1][2] * inv[1], o[h][1][3] * inv[1]);
      }
      if (want_w && rg == 0 && lane < 4) {  // query 0 = row g 0 of lanes 0..3
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&qa[h][0]);
          const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&qa[h][2]);
          q0s[h * HD + 2 * t] = __low2float(lo);
          q0s[h * HD + 2 * t + 1] = __high2float(lo);
          q0s[h * HD + 8 + 2 * t] = __low2float(hi);
          q0s[h * HD + 9 + 2 * t] = __high2float(hi);
          if (lane == 0) {
            m0s[h] = mrow[h][0];
            l0s[h] = lrow[h][0];
          }
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        float acc[2][4] = {};
        mma_pair(acc, oa, Wo, RAY_LDW, np * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = np * 16 + 8 * i + 2 * t;
          x[2 * np + i][0] += acc[i][0] + bo[c];
          x[2 * np + i][1] += acc[i][1] + bo[c + 1];
          x[2 * np + i][2] += acc[i][2] + bo[c];
          x[2 * np + i][3] += acc[i][3] + bo[c + 1];
        }
      }
      // x += ff(ff_norm(x)), the hidden layer in chunks of 64
      {
        uint32_t a[4][4];
        float y[8][4];
        ln_rows(x, fln_s, fln_b, y);
        frag_to_a(y, a, 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
#pragma unroll 1
        for (int hc = 0; hc < 4; ++hc) {
          float hid[8][4];
          uint32_t ha[4][4];
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            float acc[2][4] = {};
            mma_pair(acc, a, Wf1, RAY_LDF1, hc * NW + np * 16);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int c = hc * NW + np * 16 + 8 * i + 2 * t;
              hid[2 * np + i][0] = fmaxf(acc[i][0] + bf1[c], 0.f);
              hid[2 * np + i][1] = fmaxf(acc[i][1] + bf1[c + 1], 0.f);
              hid[2 * np + i][2] = fmaxf(acc[i][2] + bf1[c], 0.f);
              hid[2 * np + i][3] = fmaxf(acc[i][3] + bf1[c + 1], 0.f);
            }
          }
          frag_to_a(hid, ha, 4);
#pragma unroll
          for (int np = 0; np < 4; ++np)
            mma_pair(&y[2 * np], ha, Wf2 + hc * NW * RAY_LDW, RAY_LDW, np * 16);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          x[j][0] += y[j][0] + bf2[c];
          x[j][1] += y[j][1] + bf2[c + 1];
          x[j][2] += y[j][2] + bf2[c];
          x[j][3] += y[j][3] + bf2[c + 1];
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = rg * 16 + g + 8 * hr;
        if (r < S) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *(float2*)(qo + (size_t)r * NW + 8 * j + 2 * t) =
                make_float2(x[j][2 * hr], x[j][2 * hr + 1]);
        }
      }
      if (final_) {  // pool the rows' norm(q) for rgb
        ln_rows(x, fw.norm_s, fw.norm_b, x);
        const bool v0 = rg * 16 + g < S, v1 = rg * 16 + g + 8 < S;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = (v0 ? x[j][e] : 0.f) + (v1 ? x[j][2 + e] : 0.f);
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 8);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            if (lane < 4) atomicAdd(&pool[8 * j + 2 * t + e], s);
          }
        }
      }
    }
    __syncthreads();

    // query 0's weights row: a second pass over the keys with its final max
    // and sum; then cnt = sum_s w_s * valid_s / V
    if (want_w) {
      float cnt = 0.f;
      const size_t N = (size_t)R * S;
      for (int k = tid; k < S; k += RAY_THREADS) {
        const uint4* kr = (const uint4*)(kvb + (size_t)k * 2 * NW);
        float wk = 0.f;
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint4 u = __ldcg(kr + 2 * h + i);
            const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(p[e]);
              s += q0s[h * HD + 8 * i + 2 * e] * f.x + q0s[h * HD + 8 * i + 2 * e + 1] * f.y;
            }
          }
          wk += ex2(fmaf(s, SCORE_C, -m0s[h] * SCORE_C)) / l0s[h];
        }
        wk *= 1.0f / HEADS;
        w_out[(size_t)ray * S + k] = wk;
        if (final_) {
          const size_t n = (size_t)ray * S + k;
          float px = 0.f, py = 0.f, pz = 0.f;  // pts may be null when validity is read
          if (VSRC == VSRC_PROJ) {
            px = pts[n * 3];
            py = pts[n * 3 + 1];
            pz = pts[n * 3 + 2];
          }
          int nv = 0;
          for (int v = 0; v < V; ++v)
            nv += view_valid<VSRC>(mask, proj, v, N, n, px, py, pz, hf, wf);
          cnt += wk * (float)nv;
        }
      }
      if (final_) {
        for (int o_ = 16; o_ > 0; o_ >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o_);
        if (lane == 0) atomicAdd(&pool[NW], cnt);
      }
    }
    if (final_) {
      __syncthreads();
      if (tid < 3) {
        float acc = fw.rgb_b[tid];
        for (int c = 0; c < NW; ++c) acc += pool[c] * (1.0f / S) * fw.rgb_w[c * 3 + tid];
        rgb_out[(size_t)ray * 3 + tid] = acc;
      }
      if (tid == 0) cnt_out[ray] = pool[NW] / (float)V;
      __syncthreads();
      if (tid < NW + 4) pool[tid] = 0.f;
    }
    __syncthreads();  // the slab and query 0's stats are free for the next ray
  }
}

// ---------------------------------------------------------------------------
// host entry
// ---------------------------------------------------------------------------
// Reads device pointers in the packing order of kernels/gnt_fused.py
// (pack_view_block, pack_ray_block).
struct PtrReader {
  const uint64_t* p;
  int k;
  const bf16* b() { return (const bf16*)(uintptr_t)p[k++]; }
  const float* f() { return (const float*)(uintptr_t)p[k++]; }
};

static void read_view(PtrReader& r, ViewW& a) {
  a.ln_s = r.f(); a.ln_b = r.f(); a.wqa0 = r.b(); a.wbig = r.b(); a.bbig = r.f();
  a.p0 = r.f(); a.p0b = r.f(); a.wa1 = r.b(); a.ba1 = r.f(); a.wout = r.b();
  a.bout = r.f(); a.fln_s = r.f(); a.fln_b = r.f(); a.wf1 = r.b(); a.bf1 = r.f();
  a.wf2 = r.b(); a.bf2 = r.f(); a.wq0 = r.b(); a.bq0 = r.f(); a.wq1 = r.b();
  a.bq1 = r.f();
}

static void read_ray(PtrReader& r, RayW& y) {
  y.ln_s = r.f(); y.ln_b = r.f(); y.wqkv = r.b(); y.wo = r.b(); y.bo = r.f();
  y.fln_s = r.f(); y.fln_b = r.f(); y.wf1 = r.b(); y.bf1 = r.f(); y.wf2 = r.b();
  y.bf2 = r.f();
}

// The view kernel's grid for N tokens on the current device: enough blocks
// for every warp a tile, at most its resident blocks on every SM; raises the
// kernel's shared-memory limit first. Returns the grid (> 0) or a negated
// cudaError_t.
template <int VSRC>
static int view_grid(int N) {
  cudaError_t err = cudaFuncSetAttribute(
      k_view<VSRC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)VIEW_SMEM);
  int per_sm = 0, dev = 0, sms = 0;
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_view<VSRC>,
                                                                VIEW_THREADS, VIEW_SMEM);
  if (!err) err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int want = ((N + VT - 1) / VT + VIEW_WARPS - 1) / VIEW_WARPS;
  return want < per_sm * sms ? want : per_sm * sms;
}

// One ray block launch (k_ray) on `stream`: kv holds kv_blocks slabs of
// gnt_ray_slab(S) bf16, one per resident block; min(kv_blocks, R) blocks
// walk the R rays. Returns a cudaError_t.
template <int VSRC>
static int launch_ray(const float* q_in, float* q, void* kv, int kv_blocks, const void* pts,
                      const void* proj, const void* mask, int V, int R, int S, float hf,
                      float wf, const RayW& w, int want_w, int final_, const FinalW& fw,
                      void* rgb_out, void* w_out, void* cnt_out, cudaStream_t stream) {
  if (!kv || kv_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(k_ray<VSRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)RAY_SMEM);
  if (err) return (int)err;
  k_ray<VSRC><<<kv_blocks < R ? kv_blocks : R, RAY_THREADS, RAY_SMEM, stream>>>(
      q_in, q, (bf16*)kv, (const float*)pts, (const float*)proj, (const uint8_t*)mask, V, R,
      S, hf, wf, w, want_w, final_, fw, (float*)rgb_out, (float*)w_out, (float*)cnt_out);
  return (int)cudaGetLastError();
}

// The whole forward on `stream`: the prologue (k_prologue's loader of rf,
// of *patch when patch is not null, or of m3's quad rows when it has them),
// then 8 x (view block, ray block), which
// read m3's ray-diff and point codes where it has them. wptrs: N_PTRS device
// pointers in the order of pack_mono4_weights
// (pgdvs_tpu_torch/kernels/gnt_fused.py). Returns a cudaError_t.
template <int VSRC>
static int run_forward(const void* rf, const void* mask, const void* pts,
                       const void* vcode, const void* centers, const void* proj,
                       int V, int R, int S, int C, int Cp, float hf, float wf,
                       const uint64_t* wptrs, int n_ptrs, void* h_scratch,
                       void* q_scratch, void* kv_scratch, int kv_blocks, void* rgb_out,
                       void* w_out, void* cnt_out, void* stream_ptr,
                       const PatchIn* patch = nullptr,
                       const Mono3In* m3 = nullptr) {
  if (n_ptrs != N_PTRS || V > MAX_VIEWS || V < 1 || S < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int N = R * S;
  PtrReader rd{wptrs, 0};
  HeadW hw;
  hw.w0 = rd.b(); hw.b0 = rd.f(); hw.w1 = rd.b(); hw.b1 = rd.f();
  ViewW vw[DEPTH];
  RayW rw[DEPTH];
  for (int b = 0; b < DEPTH; ++b) {
    read_view(rd, vw[b]);
    read_ray(rd, rw[b]);
  }
  FinalW fw;
  fw.norm_s = rd.f(); fw.norm_b = rd.f(); fw.rgb_w = rd.f(); fw.rgb_b = rd.f();

  cudaError_t err;
  const int vgrid = view_grid<VSRC>(N);
  if (vgrid < 0) return -vgrid;

  ProArgs pro{PSRC_RF, rf, nullptr, m3 ? m3->ld : C, V, R, S, C, Cp, 0, 1, hw,
              h_scratch, q_scratch};
  if (patch) {
    pro.src = PSRC_PATCH;
    pro.a = patch->rows;
    pro.b = patch->coef;
    pro.n_pos = patch->n_pos;
    pro.nb = patch->nb;
  } else if (m3 && m3->lerp_rows) {
    pro.src = PSRC_LERP;
    pro.a = m3->lerp_rows;
    pro.b = m3->frac;
  }
  if ((err = (cudaError_t)prologue_dispatch(pro, stream))) return (int)err;
  float* q = (float*)q_scratch;
  const bf16* rd16 = m3 ? (const bf16*)m3->rd16 : nullptr;
  const bf16* pos16 = m3 ? (const bf16*)m3->pos16 : nullptr;
  for (int b = 0; b < DEPTH; ++b) {
    k_view<VSRC><<<vgrid, VIEW_THREADS, VIEW_SMEM, stream>>>(
        (const bf16*)h_scratch, q, q, (const float*)pts, (const float*)vcode,
        (const float*)centers, (const float*)proj, (const uint8_t*)mask,
        nullptr, rd16, pos16, V, N, S, hf, wf, vw[b], b % 2 == 0);
    if ((err = cudaGetLastError())) return (int)err;
    const int last = b == DEPTH - 1;
    const int rerr = launch_ray<VSRC>(q, q, kv_scratch, kv_blocks, pts, proj, mask, V, R, S,
                                      hf, wf, rw[b], last, last, fw, rgb_out, w_out, cnt_out,
                                      stream);
    if (rerr) return rerr;
  }
  return 0;
}

extern "C" {

// The ray kernel's shared memory per block, its resident blocks per SM on
// the current device (negative: a cudaError_t), and the bf16 elements of
// one block's K / V slab for S samples (S padded to the key tile, x 128).
// The wrappers size the kv scratch as min(R, blocks per SM x SMs) slabs.
int gnt_ray_smem_bytes() { return (int)RAY_SMEM; }

int gnt_ray_blocks_per_sm() {
  cudaError_t err = cudaFuncSetAttribute(
      k_ray<VSRC_PROJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)RAY_SMEM);
  if (err) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k_ray<VSRC_PROJ>, RAY_THREADS,
                                                      RAY_SMEM);
  return err ? -(int)err : n;
}

// The view kernel's shared memory per block, and for its instantiation
// vsrc (VSRC_PROJ, VSRC_MASK, VSRC_SPLIT) out[0..2] = registers per thread,
// local memory per thread in bytes (spills and stack), resident blocks per
// SM on the current device. Returns a cudaError_t.
int gnt_view_smem_bytes() { return (int)VIEW_SMEM; }

int gnt_view_attrs(int vsrc, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err;
  int grid;
  if (vsrc == VSRC_PROJ) {
    err = cudaFuncGetAttributes(&fa, k_view<VSRC_PROJ>);
    grid = view_grid<VSRC_PROJ>(1 << 30);
  } else if (vsrc == VSRC_MASK) {
    err = cudaFuncGetAttributes(&fa, k_view<VSRC_MASK>);
    grid = view_grid<VSRC_MASK>(1 << 30);
  } else if (vsrc == VSRC_SPLIT) {
    err = cudaFuncGetAttributes(&fa, k_view<VSRC_SPLIT>);
    grid = view_grid<VSRC_SPLIT>(1 << 30);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return (int)err;
  if (grid < 0) return -grid;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev))) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = grid / sms;
  return 0;
}

// The prologue alone (k_prologue), for tests and timing: h [V, N, 64] bf16
// and q [N, 64] f32 of N = R * S tokens from source src (PSRC_RF: a = rf
// [V, N, ld]; PSRC_PATCH: a = rows [V, R/nb, S, n_pos*C], b = coef [V, R, S,
// n_pos]; PSRC_LERP: a = quad rows [V, N, 4C], b = frac [V, N, 2] f32) and
// the head weights w0 [Cp, 64] bf16, b0 [64] f32, w1 [64, 64] bf16, b1 [64]
// f32. Returns a cudaError_t.
int gnt_prologue_forward(int src, const void* a, const void* b, int ld, int V, int R, int S,
                         int C, int Cp, int n_pos, int nb, const void* w0, const void* b0,
                         const void* w1, const void* b1, void* h, void* q, void* stream_ptr) {
  const HeadW hw{(const bf16*)w0, (const float*)b0, (const bf16*)w1, (const float*)b1};
  if (!w0 || !b0 || !w1 || !b1) return (int)cudaErrorInvalidValue;
  const ProArgs p{src, a, b, ld, V, R, S, C, Cp, n_pos, nb, hw, h, q};
  return prologue_dispatch(p, (cudaStream_t)stream_ptr);
}

// The prologue's loader for source src at C channels (row stride ld for
// PSRC_RF, n_pos positions and nb rays per row block for PSRC_PATCH) on the
// current device: out[0..3] = registers per thread, local memory per thread
// in bytes (spills and stack), shared memory per block in bytes, resident
// blocks per SM. Returns a cudaError_t.
int gnt_prologue_attrs(int src, int C, int ld, int n_pos, int nb, int* out) {
  const ProArgs p{src, nullptr, nullptr, ld, 1, nb, 1, C, (C + 15) / 16 * 16, n_pos, nb,
                  HeadW{}, nullptr, nullptr};
  return prologue_dispatch(p, nullptr, out);
}

int gnt_ray_slab(int S) { return (S + KT - 1) / KT * KT * 2 * NW; }

int gnt_mono4_max_views() { return MAX_VIEWS; }

int gnt_mono4_n_ptrs() { return N_PTRS; }

// K1: validity recomputed from pts and proj ([V, 3, 4] K @ w2c rows) against
// the (hf, wf) map size.
int gnt_mono4_forward(const void* rf, const void* pts, const void* vcode,
                      const void* centers, const void* proj, int V, int R,
                      int S, int C, int Cp, float hf, float wf,
                      const uint64_t* wptrs, int n_ptrs, void* h_scratch,
                      void* q_scratch, void* kv_scratch, int kv_blocks, void* rgb_out,
                      void* w_out, void* cnt_out, void* stream_ptr) {
  return run_forward<VSRC_PROJ>(rf, nullptr, pts, vcode, centers, proj, V, R, S,
                            C, Cp, hf, wf, wptrs, n_ptrs, h_scratch, q_scratch,
                            kv_scratch, kv_blocks, rgb_out, w_out, cnt_out, stream_ptr);
}

// K1, patch_rows mode: the features combined in k_prologue's patch loader from rows
// (bf16 [V, R/nb, S, n_pos*C]) and coef (bf16 [V, R/4, 4, S, n_pos]); the rest
// as gnt_mono4_forward.
int gnt_mono4_patch_forward(const void* rows, const void* coef, const void* pts,
                            const void* vcode, const void* centers, const void* proj,
                            int V, int R, int S, int C, int Cp, int n_pos, int nb,
                            float hf, float wf, const uint64_t* wptrs, int n_ptrs,
                            void* h_scratch, void* q_scratch, void* kv_scratch,
                            int kv_blocks, void* rgb_out, void* w_out, void* cnt_out,
                            void* stream_ptr) {
  if (!rows || !coef || n_pos < 1 || n_pos > MAX_NPOS || nb < 1 || R % nb != 0)
    return (int)cudaErrorInvalidValue;
  const PatchIn patch{rows, coef, n_pos, nb};
  return run_forward<VSRC_PROJ>(nullptr, nullptr, pts, vcode, centers, proj, V, R, S,
                                C, Cp, hf, wf, wptrs, n_ptrs, h_scratch, q_scratch,
                                kv_scratch, kv_blocks, rgb_out, w_out, cnt_out, stream_ptr,
                                &patch);
}

// K2, in every operand mode of gnt_fused_apply_mono3, one source per
// operand (a null pointer: not given):
//   features  rf (bf16 [V, R, S, ld], ld = C or C + 1, the first C channels
//             read) or lerp_rows (bf16 [V, R, S, 4C]) + frac (f32 [V, R, S, 2]);
//   validity  mask (uint8 [V, R, S], nonzero = valid) or proj ([V, 3, 4] f32
//             K @ w2c rows, tested against (hf, wf); needs pts);
//   ray-diff  rd16 (bf16 [V, R, S, 4]) or made from pts + centers;
//   q_fc code pos16 (bf16 [R, S, 126]: point code | view code) or made from
//             pts + vcode (f32 [R, 63]).
// Any other combination returns cudaErrorInvalidValue. cnt_out = sum_s w_s *
// (valid views at s) / V. The rest as gnt_mono4_forward.
int gnt_mono3_forward(const void* rf, int ld, const void* lerp_rows,
                            const void* frac, const void* mask, const void* proj,
                            const void* rd16, const void* pos16, const void* pts,
                            const void* vcode, const void* centers, int V, int R,
                            int S, int C, int Cp, float hf, float wf,
                            const uint64_t* wptrs, int n_ptrs, void* h_scratch,
                            void* q_scratch, void* kv_scratch, int kv_blocks,
                            void* rgb_out, void* w_out, void* cnt_out, void* stream_ptr) {
  const bool lerp = lerp_rows != nullptr;
  if (lerp == (rf != nullptr) || (lerp && !frac) || (!lerp && ld != C && ld != C + 1) ||
      (mask == nullptr) == (proj == nullptr) || (proj && !pts) ||
      (!rd16 && (!pts || !centers)) || (!pos16 && (!pts || !vcode)))
    return (int)cudaErrorInvalidValue;
  const Mono3In m3{ld, lerp_rows, frac, rd16, pos16};
  if (proj)
    return run_forward<VSRC_PROJ>(rf, nullptr, pts, vcode, centers, proj, V, R, S, C, Cp,
                                  hf, wf, wptrs, n_ptrs, h_scratch, q_scratch, kv_scratch,
                                  kv_blocks, rgb_out, w_out, cnt_out, stream_ptr, nullptr,
                                  &m3);
  return run_forward<VSRC_MASK>(rf, mask, pts, vcode, centers, nullptr, V, R, S, C, Cp,
                                hf, wf, wptrs, n_ptrs, h_scratch, q_scratch, kv_scratch,
                                kv_blocks, rgb_out, w_out, cnt_out, stream_ptr, nullptr,
                                &m3);
}

// K3a: one view block over N tokens, q_in [N, 64] f32 -> q_out [N, 64] f32
// (may be q_in), reading h [V, N, 64] bf16, ray_diff [V, N, 4] f32 (16-byte
// aligned) and mask (uint8 [V, N], nonzero = valid). wptrs: N_VIEW_PTRS
// pointers of pack_view_block; the q_fc ones are not read.
int gnt_split_view_forward(const void* q_in, void* q_out, const void* h,
                           const void* ray_diff, const void* mask, int V, int N,
                           const uint64_t* wptrs, int n_ptrs, void* stream_ptr) {
  if (n_ptrs != N_VIEW_PTRS || V > MAX_VIEWS || V < 1 || N < 1 || !mask || !ray_diff ||
      ((uintptr_t)ray_diff & 15))
    return (int)cudaErrorInvalidValue;
  PtrReader rd{wptrs, 0};
  ViewW a;
  read_view(rd, a);
  const int grid = view_grid<VSRC_SPLIT>(N);
  if (grid < 0) return -grid;
  k_view<VSRC_SPLIT><<<grid, VIEW_THREADS, VIEW_SMEM, (cudaStream_t)stream_ptr>>>(
      (const bf16*)h, (const float*)q_in, (float*)q_out, nullptr, nullptr, nullptr,
      nullptr, (const uint8_t*)mask, (const float*)ray_diff, nullptr, nullptr, V, N, 1,
      0.f, 0.f, a, 0);
  return (int)cudaGetLastError();
}

// K3b: one ray block over R rays of S samples, q_in [R, S, 64] f32 ->
// q_out (may be q_in), and w_out [R, S] f32, the head-mean of the first
// query's attention row; kv: kv_blocks slabs of gnt_ray_slab(S) bf16.
// wptrs: N_RAY_PTRS pointers of pack_ray_block.
int gnt_split_ray_forward(const void* q_in, void* q_out, void* w_out, void* kv_scratch,
                          int R, int S, int kv_blocks, const uint64_t* wptrs, int n_ptrs,
                          void* stream_ptr) {
  if (n_ptrs != N_RAY_PTRS || R < 1 || S < 1) return (int)cudaErrorInvalidValue;
  PtrReader rd{wptrs, 0};
  RayW y;
  read_ray(rd, y);
  const FinalW none{};
  return launch_ray<VSRC_SPLIT>((const float*)q_in, (float*)q_out, kv_scratch, kv_blocks,
                                nullptr, nullptr, nullptr, 1, R, S, 0.f, 0.f, y, 1, 0, none,
                                nullptr, w_out, nullptr, (cudaStream_t)stream_ptr);
}

int gnt_split_n_view_ptrs() { return N_VIEW_PTRS; }

int gnt_split_n_ray_ptrs() { return N_RAY_PTRS; }

}  // extern "C"
