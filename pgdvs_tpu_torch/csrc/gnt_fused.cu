// Fused GNT transformer forward (depth 8, width 64) for Hopper (sm_90a).
//
// Five entry points share the kernels below. The three whole forwards differ
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
//                      k_prologue_patch). Wrapper: kernels/gnt_fused_patch.py.
//   gnt_mono3_forward  replaces pgdvs_tpu/kernels/gnt_fused_mono3.py:
//                      gnt_fused_apply_mono3 in each of its operand modes:
//                      validity read from a uint8 mask [V, R, S] (in bounds,
//                      in front and not dynamic; separate, concatenated or
//                      pre-packed in JAX) or K1's projection test (fold_mask);
//                      the bf16 ray-diff code and point + view code read
//                      (the unfolded mode) or made (fold_ray_diff,
//                      fold_pos_code); sampled features, or raw quad rows +
//                      frac combined in k_prologue_lerp (fold_lerp). Wrapper:
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
// Each wrapper module also holds the plain torch version its kernel is
// checked against.
//
// Work: about 1e4 FLOP per (view, ray, sample) token per block (the 64x64
// value projection dominates), plus 4-head attention over the samples of
// every ray. Three kernels, launched from a host loop over the 8 blocks:
//
//   k_prologue   rgbfeat_fc_0/1 per view token -> h [V, N, 64] bf16 and the
//                max-pool over views -> q [N, 64] f32 (N = R * S tokens);
//                k_prologue_patch first combines each token's patch row with
//                its stencil coefficients, k_prologue_lerp its four quad taps
//                with the bilinear weights of its frac (f32, rounded to bf16).
//   k_view       one view transformer (+ q_fc on even blocks) for 64
//                tokens: validity (recomputed, or read from the mask) and
//                the ray-diff code from pts and the camera centres (or read
//                from memory: K3a in f32, K2's unfolded mode in bf16, which
//                reads its q_fc point + view code too), views streamed one
//                at a time through an online per-channel softmax, so a
//                token's [V, 64] set never has to sit in shared memory.
//   k_ray        one ray transformer for one ray (all S samples in shared
//                memory, heads one at a time); the last block (every K3b
//                launch) also writes the head-mean first-query weights, and
//                the last block of K1 / K2 rgb and the weighted valid-view
//                count.
//
// Bounds on the card: the products are bf16 WMMA tiles (16x16x16, f32
// accumulate); the per-channel view softmax and the layer norms are f32 CUDA
// core work. q stays f32 in global memory between kernels (it is small next
// to h); h is written once and read once per block. K3a is the one kernel
// here bound by bytes: per launch it reads h [V, N, 64] bf16 and the f32
// ray-diff code once, against ~0.1 TFLOP of products.
//
// All dense layers run here; the host only composes weights offline
// (wk@wv, wk@wa0, wq@wa0, p1@wa0, exact by linearity).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define NW 64
#define PH 8
#define POSENC 63
#define HEADS 4
#define HD 16
#define TT 64          // tokens per block, prologue + view kernels
#define NTHREADS 256
#define NWARPS 8
#define STAGE_LD 20
#define MAX_VIEWS 32
#define QCHUNK 32      // query rows per score chunk in k_ray

// ---------------------------------------------------------------------------
// WMMA helpers. A: bf16 row-major (lda); B: bf16 row-major [K x N] (ldb) or,
// with B_COL, element (k, n) at B[n * ldb + k]. M, N, K multiples of 16.
// Output tiles are spread over the block's 8 warps.
// ---------------------------------------------------------------------------
template <bool B_COL>
__device__ __forceinline__ void tile_mma(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>& acc,
    const bf16* A, int lda, const bf16* B, int ldb, int mt, int nt, int K) {
  wmma::fill_fragment(acc, 0.0f);
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + mt * 16 * lda + k, lda);
    if (B_COL) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, B + (size_t)nt * 16 * ldb + k, ldb);
      wmma::mma_sync(acc, a, b, acc);
    } else {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + (size_t)k * ldb + nt * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
  }
}

// C[M x N] f32 (ldc) = A @ B
template <bool B_COL = false>
__device__ void gemm_store(const bf16* A, int lda, const bf16* B, int ldb,
                           float* C, int ldc, int M, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int ntn = N / 16;
  for (int t = warp; t < (M / 16) * ntn; t += NWARPS) {
    const int mt = t / ntn, nt = t % ntn;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    tile_mma<B_COL>(acc, A, lda, B, ldb, mt, nt, K);
    wmma::store_matrix_sync(C + mt * 16 * ldc + nt * 16, acc, ldc,
                            wmma::mem_row_major);
  }
}

// epi(row, col, value) for every element of A @ B, through a per-warp
// [16 x STAGE_LD] f32 staging tile (stage holds NWARPS of them).
template <class Epi>
__device__ void gemm_epi(const bf16* A, int lda, const bf16* B, int ldb,
                         int M, int N, int K, float* stage, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * 16 * STAGE_LD;
  const int ntn = N / 16;
  for (int t = warp; t < (M / 16) * ntn; t += NWARPS) {
    const int mt = t / ntn, nt = t % ntn;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    tile_mma<false>(acc, A, lda, B, ldb, mt, nt, K);
    wmma::store_matrix_sync(st, acc, STAGE_LD, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i >> 4, c = i & 15;
      epi(mt * 16 + r, nt * 16 + c, st[r * STAGE_LD + c]);
    }
    __syncwarp();
  }
}

// Layer norm of one 64-wide row held by 4 consecutive lanes (16 each).
__device__ __forceinline__ void ln_quad(const float* x, const float* scale,
                                        const float* bias, int g, float* out) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += x[i];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const float mu = s * (1.0f / NW);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float d = x[i] - mu;
    v += d * d;
  }
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  const float rs = rsqrtf(v * (1.0f / NW) + 1e-6f);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[i] = (x[i] - mu) * rs * scale[g * 16 + i] + bias[g * 16 + i];
}

// Layer norm of one 64-wide row held by a whole warp (2 per lane).
__device__ __forceinline__ void ln_warp(float& a, float& b, const float* scale,
                                        const float* bias, int lane) {
  float s = a + b;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s * (1.0f / NW);
  float v = (a - mu) * (a - mu) + (b - mu) * (b - mu);
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const float rs = rsqrtf(v * (1.0f / NW) + 1e-6f);
  a = (a - mu) * rs * scale[2 * lane] + bias[2 * lane];
  b = (b - mu) * rs * scale[2 * lane + 1] + bias[2 * lane + 1];
}

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
  const float *bbig, *p0, *p0b, *wa1, *ba1;
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

// ---------------------------------------------------------------------------
// k_prologue: h = rgbfeat_fc_1(relu(rgbfeat_fc_0(rgb_feat))), q = max_v h
// ---------------------------------------------------------------------------
// The body both prologues share, for the block's TT tokens from n0: per
// view v, load(v, A, lda) fills the A tile [TT x Cp] (bf16, zero past C and
// past N) and syncs; then h = fc_1(relu(fc_0(A))) -> hout, q = max_v h.
template <class Load>
__device__ __forceinline__ void prologue_body(int V, int N, int Cp, const HeadW& w,
                                              bf16* __restrict__ hout,
                                              float* __restrict__ qout,
                                              unsigned char* smem, Load load) {
  const int lda = Cp + 8;
  bf16* A = (bf16*)smem;                       // [TT x lda]
  bf16* A2 = A + TT * lda;                     // [TT x 72]
  float* Cs = (float*)(A2 + TT * 72);          // [TT x 68]
  const int n0 = blockIdx.x * TT;
  const int tid = threadIdx.x, t = tid >> 2, g = tid & 3;
  float qm[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qm[i] = -INFINITY;

  for (int v = 0; v < V; ++v) {
    load(v, A, lda);
    gemm_store(A, lda, w.w0, NW, Cs, 68, TT, NW, Cp);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = g * 16 + i;
      A2[t * 72 + c] = __float2bfloat16(fmaxf(Cs[t * 68 + c] + w.b0[c], 0.f));
    }
    __syncthreads();
    gemm_store(A2, 72, w.w1, NW, Cs, 68, TT, NW, NW);
    __syncthreads();
    if (n0 + t < N) {
      bf16* dst = hout + ((size_t)v * N + n0 + t) * NW + g * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bf16 hb = __float2bfloat16(Cs[t * 68 + g * 16 + i] + w.b1[g * 16 + i]);
        dst[i] = hb;
        qm[i] = fmaxf(qm[i], __bfloat162float(hb));
      }
    }
    __syncthreads();
  }
  if (n0 + t < N) {
#pragma unroll
    for (int i = 0; i < 16; ++i) qout[(size_t)(n0 + t) * NW + g * 16 + i] = qm[i];
  }
}

__host__ __device__ inline size_t prologue_smem(int cp) {
  return (size_t)TT * (cp + 8) * 2 + (size_t)TT * 72 * 2 + (size_t)TT * 68 * 4;
}

// rf rows are ld >= C channels apart (ld = C + 1 for K2's pre-packed mode,
// whose trailing validity channel is not read here).
__global__ void __launch_bounds__(NTHREADS)
k_prologue(const bf16* __restrict__ rf, int V, int N, int C, int ld, int Cp, HeadW w,
           bf16* __restrict__ hout, float* __restrict__ qout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * TT;
  prologue_body(V, N, Cp, w, hout, qout, smem, [&](int v, bf16* A, int lda) {
    const bf16* src = rf + ((size_t)v * N + n0) * ld;
    for (int i = threadIdx.x; i < TT * Cp; i += NTHREADS) {
      const int r = i / Cp, c = i - r * Cp;
      A[r * lda + c] = (c < C && n0 + r < N) ? src[(size_t)r * ld + c]
                                             : __float2bfloat16(0.f);
    }
    __syncthreads();
  });
}

// A tile of view v from stencil rows: token n = ray*S + s takes the row
// rows[v, ray / nb, s, :] (n_pos positions x C channels) and its
// coefficients cf[(n - n0) * n_pos + p] (staged in shared memory):
// rgb_feat[c] = sum_p row[p*C + c] * cf[p], in f32 and p order, rounded once
// to bf16.
__device__ __forceinline__ void combine_rows(const bf16* __restrict__ rows,
                                             const float* cf, int v, int n0, int R,
                                             int S, int C, int Cp, int n_pos, int nb,
                                             bf16* A, int lda) {
  const int N = R * S, nrb = R / nb, row_len = n_pos * C;
  for (int i = threadIdx.x; i < TT * Cp; i += NTHREADS) {
    const int r = i / Cp, c = i - r * Cp, n = n0 + r;
    float acc = 0.f;
    if (c < C && n < N) {
      const int ray = n / S, s = n - ray * S;
      const bf16* row = rows + (((size_t)v * nrb + ray / nb) * S + s) * row_len + c;
      const float* k = cf + r * n_pos;
      for (int p = 0; p < n_pos; ++p) acc += __bfloat162float(row[p * C]) * k[p];
    }
    A[r * lda + c] = __float2bfloat16(acc);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// k_prologue_patch: K1's prologue on its patch_rows operands. Token n = r*S +
// s of view v takes the row rows[v, r / nb, s, :] (n_pos stencil positions x
// C channels) and the coefficients coef[v, r, s, :] ([V, R/4, 4, S, n_pos] is
// [V, R, S, n_pos] in memory): rgb_feat[c] = sum_p row[p*C + c] * coef[p],
// combined in f32 and rounded to bf16 into the A tile. The block's TT tokens'
// coefficients are staged in shared memory ([TT x n_pos] f32 after the
// k_prologue layout) once per view.
// ---------------------------------------------------------------------------
#define MAX_NPOS 32

__global__ void __launch_bounds__(NTHREADS)
k_prologue_patch(const bf16* __restrict__ rows, const bf16* __restrict__ coef, int V,
                 int R, int S, int C, int Cp, int n_pos, int nb, HeadW w,
                 bf16* __restrict__ hout, float* __restrict__ qout) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cf = (float*)(smem + prologue_smem(Cp));      // [TT x n_pos]
  const int N = R * S, n0 = blockIdx.x * TT;
  prologue_body(V, N, Cp, w, hout, qout, smem, [&](int v, bf16* A, int lda) {
    for (int i = threadIdx.x; i < TT * n_pos; i += NTHREADS) {
      const int n = n0 + i / n_pos;
      cf[i] = n < N ? __bfloat162float(coef[((size_t)v * N + n) * n_pos + i % n_pos])
                    : 0.f;
    }
    __syncthreads();
    combine_rows(rows, cf, v, n0, R, S, C, Cp, n_pos, nb, A, lda);
  });
}

// ---------------------------------------------------------------------------
// k_prologue_lerp: K2's fold_lerp prologue. Token n of view v takes its raw
// quad row rows[v, n, :] (the fused map's pixels (y, x), (y, x+1), (y+1, x),
// (y+1, x+1), C channels each) and frac[v, n, :] = (x - sx, y - sy) f32. The
// zero-pad bilinear weights max(0, 1-|f|), max(0, 1-|f-1|) per axis are made
// in f32 and staged ([TT x 4] after the k_prologue layout); the four taps
// combine as k_prologue_patch's stencil (one ray per row, 4 positions).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS)
k_prologue_lerp(const bf16* __restrict__ rows, const float* __restrict__ frac, int V,
                int R, int S, int C, int Cp, HeadW w, bf16* __restrict__ hout,
                float* __restrict__ qout) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cf = (float*)(smem + prologue_smem(Cp));      // [TT x 4]
  const int N = R * S, n0 = blockIdx.x * TT;
  prologue_body(V, N, Cp, w, hout, qout, smem, [&](int v, bf16* A, int lda) {
    if (threadIdx.x < TT) {
      const size_t n = (size_t)v * N + min(n0 + (int)threadIdx.x, N - 1);
      const float fx = frac[2 * n], fy = frac[2 * n + 1];
      const float wx0 = fmaxf(0.f, 1.f - fabsf(fx)), wx1 = fmaxf(0.f, 1.f - fabsf(fx - 1.f));
      const float wy0 = fmaxf(0.f, 1.f - fabsf(fy)), wy1 = fmaxf(0.f, 1.f - fabsf(fy - 1.f));
      float* k = cf + threadIdx.x * 4;
      k[0] = wx0 * wy0;
      k[1] = wx1 * wy0;
      k[2] = wx0 * wy1;
      k[3] = wx1 * wy1;
    }
    __syncthreads();
    combine_rows(rows, cf, v, n0, R, S, C, Cp, 4, 1, A, lda);
  });
}

// The patch_rows operands of K1 (k_prologue_patch runs instead of k_prologue).
struct PatchIn {
  const void* rows;
  const void* coef;
  int n_pos, nb;  // stencil positions per row, rays per row block
};

// K2's operand sources beyond K1's (gnt_mono3_forward): the channel stride of
// rf; raw quad rows + frac (k_prologue_lerp runs instead of k_prologue); the
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
// (to target - to source) and their dot product (cameras.ray_diff_features).
// centers: [V+1, 3], target first.
__device__ __forceinline__ void ray_diff_code(const float* centers, int v, float px,
                                              float py, float pz, float* rd) {
  float ax = centers[0] - px, ay = centers[1] - py, az = centers[2] - pz;
  const float an = sqrtf(ax * ax + ay * ay + az * az) + 1e-6f;
  ax /= an; ay /= an; az /= an;
  const float* cv = centers + 3 * (v + 1);
  float bx = cv[0] - px, by = cv[1] - py, bz = cv[2] - pz;
  const float bn = sqrtf(bx * bx + by * by + bz * bz) + 1e-6f;
  bx /= bn; by /= bn; bz /= bn;
  const float dx = ax - bx, dy = ay - by, dz = az - bz;
  const float dn = fmaxf(sqrtf(dx * dx + dy * dy + dz * dz), 1e-6f);
  rd[0] = dx / dn;
  rd[1] = dy / dn;
  rd[2] = dz / dn;
  rd[3] = ax * bx + ay * by + az * bz;
}

// ---------------------------------------------------------------------------
// k_view: one view transformer block (+ q_fc_0/1 when has_qfc), q_in -> q_out
// (the same buffer in K1 / K2). VSRC_SPLIT reads no pts, centres or view code
// and needs has_qfc == 0. rd16 / pos16 (K2's unfolded modes, may be null):
// the bf16 ray-diff code [V, N, 4] / point + view code [N, 126] read in place
// of making them; pts may be null when neither is made and validity is read.
// ---------------------------------------------------------------------------
#define VIEW_LDA 88   // [h_v (64) | pos_in (8) | zero (16)]
#define VIEW_LDC 84
#define VIEW_LDH 264

template <int VSRC>
__global__ void __launch_bounds__(NTHREADS)
k_view(const bf16* __restrict__ h, const float* q_in, float* q_out,
       const float* __restrict__ pts, const float* __restrict__ vcode,
       const float* __restrict__ centers, const float* __restrict__ proj,
       const uint8_t* __restrict__ mask, const float* __restrict__ ray_diff,
       const bf16* __restrict__ rd16, const bf16* __restrict__ pos16,
       int V, int N, int S, float hf, float wf, ViewW w, int has_qfc) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* A = (bf16*)smem;                                  // [TT x 88]
  float* Cs = (float*)(A + TT * VIEW_LDA);                // [TT x 84]
  bf16* X = (bf16*)(Cs + TT * VIEW_LDC);                  // [TT x 72]
  float* QA = (float*)(X + TT * 72);                      // [TT x 20]
  bf16* H1 = (bf16*)(QA + TT * 20);                       // [TT x 264]
  float* stage = (float*)(H1 + TT * VIEW_LDH);            // [8 x 16 x 20]
  float* pts_s = stage + NWARPS * 16 * STAGE_LD;          // [TT x 3]
  unsigned* vmask = (unsigned*)(pts_s + TT * 3);          // [TT]
  int* vcnt = (int*)(vmask + TT);                         // [TT]
  float* wa1_s = (float*)(vcnt + TT);                     // [8 x 64]

  const int n0 = blockIdx.x * TT;
  const int tid = threadIdx.x, t = tid >> 2, g = tid & 3;
  const bool live = n0 + t < N;

  float qr[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    qr[i] = live ? q_in[(size_t)(n0 + t) * NW + g * 16 + i] : 0.f;

  if (tid < TT) {
    const int n = min(n0 + tid, N - 1);
    float px = 0.f, py = 0.f, pz = 0.f;
    if (VSRC != VSRC_SPLIT && pts) {
      px = pts[n * 3];
      py = pts[n * 3 + 1];
      pz = pts[n * 3 + 2];
    }
    pts_s[tid * 3] = px;
    pts_s[tid * 3 + 1] = py;
    pts_s[tid * 3 + 2] = pz;
    unsigned m = 0;
    int cnt = 0;
    for (int v = 0; v < V; ++v) {
      if (view_valid<VSRC>(mask, proj, v, N, n, px, py, pz, hf, wf)) {
        m |= 1u << v;
        ++cnt;
      }
    }
    vmask[tid] = m;
    vcnt[tid] = cnt;
  }
  for (int i = tid; i < PH * NW; i += NTHREADS) wa1_s[i] = w.wa1[i];
  for (int i = tid; i < TT * 16; i += NTHREADS)
    A[(i >> 4) * VIEW_LDA + 72 + (i & 15)] = __float2bfloat16(0.f);

  // x = attn_norm(q); qa = x @ (wq @ wa0)
  {
    float xo[16];
    ln_quad(qr, w.ln_s, w.ln_b, g, xo);
#pragma unroll
    for (int i = 0; i < 16; ++i) X[t * 72 + g * 16 + i] = __float2bfloat16(xo[i]);
  }
  __syncthreads();
  gemm_store(X, 72, w.wqa0, 16, QA, 20, TT, 16, NW);
  __syncthreads();

  float mx[16], den[16], agg[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mx[i] = -INFINITY;
    den[i] = 0.f;
    agg[i] = 0.f;
  }

  for (int v = 0; v < V; ++v) {
    // A = [h_v | relu(pos_fc_0(ray_diff_v)) | 0]
    const bf16* hv = h + ((size_t)v * N + n0) * NW;
    for (int i = tid; i < TT * 8; i += NTHREADS) {
      const int r = i >> 3, c8 = i & 7;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (n0 + r < N) val = ((const uint4*)(hv + (size_t)r * NW))[c8];
      *(uint4*)(A + r * VIEW_LDA + c8 * 8) = val;
    }
    if (tid < TT) {
      float rd[4];
      if (VSRC == VSRC_SPLIT) {
        const float4 r4 = ((const float4*)ray_diff)[(size_t)v * N + min(n0 + tid, N - 1)];
        rd[0] = r4.x; rd[1] = r4.y; rd[2] = r4.z; rd[3] = r4.w;
      } else if (rd16) {
        const bf16* r4 = rd16 + ((size_t)v * N + min(n0 + tid, N - 1)) * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) rd[k] = __bfloat162float(r4[k]);
      } else {
        ray_diff_code(centers, v, pts_s[tid * 3], pts_s[tid * 3 + 1], pts_s[tid * 3 + 2], rd);
      }
#pragma unroll
      for (int j = 0; j < PH; ++j) {
        float p = w.p0b[j];
#pragma unroll
        for (int k = 0; k < 4; ++k) p += rd[k] * w.p0[k * PH + j];
        A[tid * VIEW_LDA + NW + j] = __float2bfloat16(fmaxf(p, 0.f));
      }
    }
    __syncthreads();
    // [val (64) | a0 w/o the q side (8) | 0 (8)]
    gemm_store(A, VIEW_LDA, w.wbig, 80, Cs, VIEW_LDC, TT, 80, 80);
    __syncthreads();
    const bool valid = (vmask[t] >> v) & 1u;
    if (valid || vcnt[t] == 0) {
      float tj[PH];
#pragma unroll
      for (int j = 0; j < PH; ++j)
        tj[j] = fmaxf(Cs[t * VIEW_LDC + NW + j] + w.bbig[NW + j] - QA[t * 20 + j], 0.f);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = g * 16 + i;
        float lg = w.ba1[c];
#pragma unroll
        for (int j = 0; j < PH; ++j) lg += tj[j] * wa1_s[j * NW + c];
        const float val = Cs[t * VIEW_LDC + c] + w.bbig[c];
        const float mn = fmaxf(mx[i], lg);
        const float sc = __expf(mx[i] - mn);
        const float e = __expf(lg - mn);
        den[i] = den[i] * sc + e;
        agg[i] = agg[i] * sc + e * val;
        mx[i] = mn;
      }
    }
    __syncthreads();
  }

  // x = out_fc(agg) + q
#pragma unroll
  for (int i = 0; i < 16; ++i)
    X[t * 72 + g * 16 + i] = __float2bfloat16(agg[i] / den[i]);
  __syncthreads();
  gemm_store(X, 72, w.wout, NW, Cs, VIEW_LDC, TT, NW, NW);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 16; ++i) qr[i] += Cs[t * VIEW_LDC + g * 16 + i] + w.bout[g * 16 + i];
  // q = x + ff(ff_norm(x))
  {
    float xo[16];
    ln_quad(qr, w.fln_s, w.fln_b, g, xo);
#pragma unroll
    for (int i = 0; i < 16; ++i) X[t * 72 + g * 16 + i] = __float2bfloat16(xo[i]);
  }
  __syncthreads();
  gemm_epi(X, 72, w.wf1, 4 * NW, TT, 4 * NW, NW, stage,
           [&](int r, int c, float val) {
             H1[r * VIEW_LDH + c] = __float2bfloat16(fmaxf(val + w.bf1[c], 0.f));
           });
  __syncthreads();
  gemm_store(H1, VIEW_LDH, w.wf2, NW, Cs, VIEW_LDC, TT, NW, 4 * NW);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 16; ++i) qr[i] += Cs[t * VIEW_LDC + g * 16 + i] + w.bf2[g * 16 + i];

  if (has_qfc) {
    // q = q_fc_1(relu(q_fc_0([q | pts_code | view_code])))  (K = 192)
    const int ldq = 200;
#pragma unroll
    for (int i = 0; i < 16; ++i) H1[t * ldq + g * 16 + i] = __float2bfloat16(qr[i]);
    if (tid < TT) {
      bf16* row = H1 + tid * ldq;
      const int n = min(n0 + tid, N - 1);
      if (pos16) {
        const bf16* src = pos16 + (size_t)n * 2 * POSENC;
        for (int k = 0; k < 2 * POSENC; ++k) row[NW + k] = src[k];
      } else {
        float p3[3] = {pts_s[tid * 3], pts_s[tid * 3 + 1], pts_s[tid * 3 + 2]};
        float s3[3], c3[3];
        for (int k = 0; k < 3; ++k) {
          row[NW + k] = __float2bfloat16(p3[k]);
          s3[k] = sinf(p3[k]);
          c3[k] = cosf(p3[k]);
        }
        for (int f = 0; f < 10; ++f) {
          for (int k = 0; k < 3; ++k) {
            row[NW + 3 + 6 * f + k] = __float2bfloat16(s3[k]);
            row[NW + 6 + 6 * f + k] = __float2bfloat16(c3[k]);
            const float s2 = 2.f * s3[k] * c3[k];
            const float c2 = c3[k] * c3[k] - s3[k] * s3[k];
            s3[k] = s2;
            c3[k] = c2;
          }
        }
        const int ray = n / S;
        for (int k = 0; k < POSENC; ++k)
          row[NW + POSENC + k] = __float2bfloat16(vcode[(size_t)ray * POSENC + k]);
      }
      for (int k = NW + 2 * POSENC; k < ldq; ++k) row[k] = __float2bfloat16(0.f);
    }
    __syncthreads();
    gemm_epi(H1, ldq, w.wq0, NW, TT, NW, 192, stage,
             [&](int r, int c, float val) {
               X[r * 72 + c] = __float2bfloat16(fmaxf(val + w.bq0[c], 0.f));
             });
    __syncthreads();
    gemm_store(X, 72, w.wq1, NW, Cs, VIEW_LDC, TT, NW, NW);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) qr[i] = Cs[t * VIEW_LDC + g * 16 + i] + w.bq1[g * 16 + i];
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 16; ++i) q_out[(size_t)(n0 + t) * NW + g * 16 + i] = qr[i];
  }
}

// ---------------------------------------------------------------------------
// k_ray: one ray transformer block for one ray (blockIdx.x), q_in -> q (the
// same buffer in K1 / K2). want_w: write the head-mean first-query weights
// row; final: then rgb and the weighted valid-view count (K1 / K2's last
// block).
// ---------------------------------------------------------------------------
#define RAY_LDQKV 56   // [q_h (16) | k_h (16) | v_h (16) | pad (8)]
#define RAY_LDH 264

struct RayLayout {
  size_t x, o, qkv, sc, p, hbuf, stage, rowinv, pool, wacc, total;
};

__host__ __device__ inline RayLayout ray_layout(int sp) {
  RayLayout L;
  size_t off = 0;
  L.x = off; off += (size_t)sp * 72 * 2;
  L.o = off; off += (size_t)sp * 72 * 2;
  const size_t attn = (size_t)sp * RAY_LDQKV * 2 + (size_t)QCHUNK * (sp + 4) * 4 +
                      (size_t)QCHUNK * (sp + 8) * 2;
  const size_t ff = (size_t)64 * RAY_LDH * 2;
  L.qkv = off;
  L.sc = off + (size_t)sp * RAY_LDQKV * 2;
  L.p = L.sc + (size_t)QCHUNK * (sp + 4) * 4;
  L.hbuf = off;
  off += attn > ff ? attn : ff;
  off = (off + 127) & ~(size_t)127;
  L.stage = off; off += (size_t)NWARPS * 16 * STAGE_LD * 4;
  L.rowinv = off; off += QCHUNK * 4;
  L.pool = off; off += (NW + 4) * 4;
  L.wacc = off; off += (size_t)sp * 4;
  L.total = off;
  return L;
}

template <int VSRC>
__global__ void __launch_bounds__(NTHREADS)
k_ray(const float* q_in, float* q, const float* __restrict__ pts,
      const float* __restrict__ proj, const uint8_t* __restrict__ mask, int V,
      int S, int Sp, float hf, float wf, RayW w, int want_w, int final_, FinalW fw,
      float* __restrict__ rgb_out,
      float* __restrict__ w_out, float* __restrict__ cnt_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RayLayout L = ray_layout(Sp);
  bf16* X = (bf16*)(smem + L.x);
  bf16* O = (bf16*)(smem + L.o);
  bf16* QKV = (bf16*)(smem + L.qkv);
  float* Sc = (float*)(smem + L.sc);
  bf16* P = (bf16*)(smem + L.p);
  bf16* Hb = (bf16*)(smem + L.hbuf);
  float* stage = (float*)(smem + L.stage);
  float* rowinv = (float*)(smem + L.rowinv);
  float* pool = (float*)(smem + L.pool);
  float* wacc = (float*)(smem + L.wacc);

  const int r = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* qg = q + (size_t)r * S * NW;
  const float* qi = q_in + (size_t)r * S * NW;
  const int lds = Sp + 4, ldp = Sp + 8;

  for (int k = tid; k < Sp; k += NTHREADS) wacc[k] = 0.f;
  if (tid < NW + 4) pool[tid] = 0.f;
  // X = attn_norm(q), zero rows past S
  for (int row = warp; row < Sp; row += NWARPS) {
    float a = 0.f, b = 0.f;
    if (row < S) {
      a = qi[row * NW + 2 * lane];
      b = qi[row * NW + 2 * lane + 1];
      ln_warp(a, b, w.ln_s, w.ln_b, lane);
    }
    X[row * 72 + 2 * lane] = __float2bfloat16(a);
    X[row * 72 + 2 * lane + 1] = __float2bfloat16(b);
  }
  __syncthreads();

  for (int hh = 0; hh < HEADS; ++hh) {
    gemm_epi(X, 72, w.wqkv + hh * 48, 3 * NW, Sp, 48, NW, stage,
             [&](int rr, int c, float val) {
               QKV[rr * RAY_LDQKV + c] = __float2bfloat16(val);
             });
    __syncthreads();
    for (int q0 = 0; q0 < Sp; q0 += QCHUNK) {
      const int nq = min(QCHUNK, Sp - q0);
      gemm_store<true>(QKV + q0 * RAY_LDQKV, RAY_LDQKV, QKV + HD, RAY_LDQKV,
                       Sc, lds, nq, Sp, HD);
      __syncthreads();
      for (int row = warp; row < nq; row += NWARPS) {
        float m = -INFINITY;
        for (int k = lane; k < S; k += 32) m = fmaxf(m, Sc[row * lds + k] * 0.25f);
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float sum = 0.f;
        for (int k = lane; k < Sp; k += 32) {
          const float e = k < S ? expf(Sc[row * lds + k] * 0.25f - m) : 0.f;
          P[row * ldp + k] = __float2bfloat16(e);
          sum += e;
        }
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float inv = 1.f / sum;
        if (lane == 0) rowinv[row] = inv;
        if (want_w && q0 + row == 0) {
          for (int k = lane; k < S; k += 32)
            wacc[k] += expf(Sc[k] * 0.25f - m) * inv * (1.0f / HEADS);
        }
      }
      __syncthreads();
      gemm_epi(P, ldp, QKV + 2 * HD, RAY_LDQKV, nq, HD, Sp, stage,
               [&](int rr, int c, float val) {
                 O[(q0 + rr) * 72 + hh * HD + c] = __float2bfloat16(val * rowinv[rr]);
               });
      __syncthreads();
    }
  }

  // q = q_in + out_fc(O)
  gemm_epi(O, 72, w.wo, NW, Sp, NW, NW, stage, [&](int rr, int c, float val) {
    if (rr < S) qg[rr * NW + c] = qi[rr * NW + c] + val + w.bo[c];
  });
  __syncthreads();
  // q += ff(ff_norm(q)), 64 rows at a time
  for (int row = warp; row < Sp; row += NWARPS) {
    float a = 0.f, b = 0.f;
    if (row < S) {
      a = qg[row * NW + 2 * lane];
      b = qg[row * NW + 2 * lane + 1];
      ln_warp(a, b, w.fln_s, w.fln_b, lane);
    }
    X[row * 72 + 2 * lane] = __float2bfloat16(a);
    X[row * 72 + 2 * lane + 1] = __float2bfloat16(b);
  }
  __syncthreads();
  for (int c0 = 0; c0 < Sp; c0 += 64) {
    const int m = min(64, Sp - c0);
    gemm_epi(X + c0 * 72, 72, w.wf1, 4 * NW, m, 4 * NW, NW, stage,
             [&](int rr, int c, float val) {
               Hb[rr * RAY_LDH + c] = __float2bfloat16(fmaxf(val + w.bf1[c], 0.f));
             });
    __syncthreads();
    gemm_epi(Hb, RAY_LDH, w.wf2, NW, m, NW, 4 * NW, stage,
             [&](int rr, int c, float val) {
               if (c0 + rr < S) qg[(c0 + rr) * NW + c] += val + w.bf2[c];
             });
    __syncthreads();
  }
  if (want_w)
    for (int k = tid; k < S; k += NTHREADS) w_out[(size_t)r * S + k] = wacc[k];
  if (!final_) return;

  // rgb = rgb_fc(mean_s norm(q)), cnt = sum_s w_s * valid_s / V
  float pa = 0.f, pb = 0.f;
  for (int row = warp; row < S; row += NWARPS) {
    float a = qg[row * NW + 2 * lane], b = qg[row * NW + 2 * lane + 1];
    ln_warp(a, b, fw.norm_s, fw.norm_b, lane);
    pa += a;
    pb += b;
  }
  atomicAdd(&pool[2 * lane], pa);
  atomicAdd(&pool[2 * lane + 1], pb);
  float cnt = 0.f;
  const size_t N = (size_t)gridDim.x * S;
  for (int k = tid; k < S; k += NTHREADS) {
    const size_t n = (size_t)r * S + k;
    float px = 0.f, py = 0.f, pz = 0.f;  // pts may be null when validity is read
    if (VSRC == VSRC_PROJ) {
      px = pts[n * 3];
      py = pts[n * 3 + 1];
      pz = pts[n * 3 + 2];
    }
    int nv = 0;
    for (int v = 0; v < V; ++v)
      nv += view_valid<VSRC>(mask, proj, v, N, n, px, py, pz, hf, wf);
    cnt += wacc[k] * (float)nv;
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (lane == 0) atomicAdd(&pool[NW], cnt);
  __syncthreads();
  if (tid < 3) {
    float acc = fw.rgb_b[tid];
    for (int c = 0; c < NW; ++c) acc += pool[c] * (1.0f / S) * fw.rgb_w[c * 3 + tid];
    rgb_out[r * 3 + tid] = acc;
  }
  if (tid == 0) cnt_out[r] = pool[NW] / (float)V;
}

// ---------------------------------------------------------------------------
// host entry
// ---------------------------------------------------------------------------
static inline size_t view_smem() {
  return (size_t)TT * VIEW_LDA * 2 + (size_t)TT * VIEW_LDC * 4 + (size_t)TT * 72 * 2 +
         (size_t)TT * 20 * 4 + (size_t)TT * VIEW_LDH * 2 +
         (size_t)NWARPS * 16 * STAGE_LD * 4 + (size_t)TT * 3 * 4 + (size_t)TT * 4 * 2 +
         (size_t)PH * NW * 4;
}

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
  a.p0 = r.f(); a.p0b = r.f(); a.wa1 = r.f(); a.ba1 = r.f(); a.wout = r.b();
  a.bout = r.f(); a.fln_s = r.f(); a.fln_b = r.f(); a.wf1 = r.b(); a.bf1 = r.f();
  a.wf2 = r.b(); a.bf2 = r.f(); a.wq0 = r.b(); a.bq0 = r.f(); a.wq1 = r.b();
  a.bq1 = r.f();
}

static void read_ray(PtrReader& r, RayW& y) {
  y.ln_s = r.f(); y.ln_b = r.f(); y.wqkv = r.b(); y.wo = r.b(); y.bo = r.f();
  y.fln_s = r.f(); y.fln_b = r.f(); y.wf1 = r.b(); y.bf1 = r.f(); y.wf2 = r.b();
  y.bf2 = r.f();
}

// The whole forward on `stream`: the prologue (k_prologue on rf, or
// k_prologue_patch on *patch when patch is not null, or k_prologue_lerp on
// m3's quad rows when it has them), then 8 x (view block, ray block), which
// read m3's ray-diff and point codes where it has them. wptrs: N_PTRS device
// pointers in the order of pack_mono4_weights
// (pgdvs_tpu_torch/kernels/gnt_fused.py). Returns a cudaError_t.
template <int VSRC>
static int run_forward(const void* rf, const void* mask, const void* pts,
                       const void* vcode, const void* centers, const void* proj,
                       int V, int R, int S, int C, int Cp, float hf, float wf,
                       const uint64_t* wptrs, int n_ptrs, void* h_scratch,
                       void* q_scratch, void* rgb_out, void* w_out,
                       void* cnt_out, void* stream_ptr, const PatchIn* patch = nullptr,
                       const Mono3In* m3 = nullptr) {
  if (n_ptrs != N_PTRS || V > MAX_VIEWS || V < 1 || S < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int N = R * S;
  const int Sp = (S + 15) / 16 * 16;
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
  const size_t sm_view = view_smem(), sm_ray = ray_layout(Sp).total;
  if ((err = cudaFuncSetAttribute(k_view<VSRC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_view))) return (int)err;
  if ((err = cudaFuncSetAttribute(k_ray<VSRC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_ray))) return (int)err;

  const int nblk = (N + TT - 1) / TT;
  if (patch) {
    const size_t sm_pro = prologue_smem(Cp) + (size_t)TT * patch->n_pos * 4;
    if ((err = cudaFuncSetAttribute(k_prologue_patch, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_pro))) return (int)err;
    k_prologue_patch<<<nblk, NTHREADS, sm_pro, stream>>>(
        (const bf16*)patch->rows, (const bf16*)patch->coef, V, R, S, C, Cp, patch->n_pos,
        patch->nb, hw, (bf16*)h_scratch, (float*)q_scratch);
  } else if (m3 && m3->lerp_rows) {
    const size_t sm_pro = prologue_smem(Cp) + (size_t)TT * 4 * 4;
    if ((err = cudaFuncSetAttribute(k_prologue_lerp, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_pro))) return (int)err;
    k_prologue_lerp<<<nblk, NTHREADS, sm_pro, stream>>>(
        (const bf16*)m3->lerp_rows, (const float*)m3->frac, V, R, S, C, Cp, hw,
        (bf16*)h_scratch, (float*)q_scratch);
  } else {
    const size_t sm_pro = prologue_smem(Cp);
    if ((err = cudaFuncSetAttribute(k_prologue, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_pro))) return (int)err;
    k_prologue<<<nblk, NTHREADS, sm_pro, stream>>>(
        (const bf16*)rf, V, N, C, m3 ? m3->ld : C, Cp, hw, (bf16*)h_scratch,
        (float*)q_scratch);
  }
  if ((err = cudaGetLastError())) return (int)err;
  float* q = (float*)q_scratch;
  const bf16* rd16 = m3 ? (const bf16*)m3->rd16 : nullptr;
  const bf16* pos16 = m3 ? (const bf16*)m3->pos16 : nullptr;
  for (int b = 0; b < DEPTH; ++b) {
    k_view<VSRC><<<nblk, NTHREADS, sm_view, stream>>>(
        (const bf16*)h_scratch, q, q, (const float*)pts, (const float*)vcode,
        (const float*)centers, (const float*)proj, (const uint8_t*)mask,
        nullptr, rd16, pos16, V, N, S, hf, wf, vw[b], b % 2 == 0);
    if ((err = cudaGetLastError())) return (int)err;
    const int last = b == DEPTH - 1;
    k_ray<VSRC><<<R, NTHREADS, sm_ray, stream>>>(
        q, q, (const float*)pts, (const float*)proj, (const uint8_t*)mask, V,
        S, Sp, hf, wf, rw[b], last, last, fw, (float*)rgb_out, (float*)w_out,
        (float*)cnt_out);
    if ((err = cudaGetLastError())) return (int)err;
  }
  return 0;
}

extern "C" {

// Shared memory one ray block needs for Sp (padded) samples; the wrappers
// check it against the device limit before launching.
size_t gnt_mono4_ray_smem(int sp) { return ray_layout(sp).total; }

int gnt_mono4_max_views() { return MAX_VIEWS; }

int gnt_mono4_n_ptrs() { return N_PTRS; }

// K1: validity recomputed from pts and proj ([V, 3, 4] K @ w2c rows) against
// the (hf, wf) map size.
int gnt_mono4_forward(const void* rf, const void* pts, const void* vcode,
                      const void* centers, const void* proj, int V, int R,
                      int S, int C, int Cp, float hf, float wf,
                      const uint64_t* wptrs, int n_ptrs, void* h_scratch,
                      void* q_scratch, void* rgb_out, void* w_out,
                      void* cnt_out, void* stream_ptr) {
  return run_forward<VSRC_PROJ>(rf, nullptr, pts, vcode, centers, proj, V, R, S,
                            C, Cp, hf, wf, wptrs, n_ptrs, h_scratch, q_scratch,
                            rgb_out, w_out, cnt_out, stream_ptr);
}

// K1, patch_rows mode: the features combined in k_prologue_patch from rows
// (bf16 [V, R/nb, S, n_pos*C]) and coef (bf16 [V, R/4, 4, S, n_pos]); the rest
// as gnt_mono4_forward.
int gnt_mono4_patch_forward(const void* rows, const void* coef, const void* pts,
                            const void* vcode, const void* centers, const void* proj,
                            int V, int R, int S, int C, int Cp, int n_pos, int nb,
                            float hf, float wf, const uint64_t* wptrs, int n_ptrs,
                            void* h_scratch, void* q_scratch, void* rgb_out,
                            void* w_out, void* cnt_out, void* stream_ptr) {
  if (!rows || !coef || n_pos < 1 || n_pos > MAX_NPOS || nb < 1 || R % nb != 0)
    return (int)cudaErrorInvalidValue;
  const PatchIn patch{rows, coef, n_pos, nb};
  return run_forward<VSRC_PROJ>(nullptr, nullptr, pts, vcode, centers, proj, V, R, S,
                                C, Cp, hf, wf, wptrs, n_ptrs, h_scratch, q_scratch,
                                rgb_out, w_out, cnt_out, stream_ptr, &patch);
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
                            void* q_scratch, void* rgb_out, void* w_out,
                            void* cnt_out, void* stream_ptr) {
  const bool lerp = lerp_rows != nullptr;
  if (lerp == (rf != nullptr) || (lerp && !frac) || (!lerp && ld != C && ld != C + 1) ||
      (mask == nullptr) == (proj == nullptr) || (proj && !pts) ||
      (!rd16 && (!pts || !centers)) || (!pos16 && (!pts || !vcode)))
    return (int)cudaErrorInvalidValue;
  const Mono3In m3{ld, lerp_rows, frac, rd16, pos16};
  if (proj)
    return run_forward<VSRC_PROJ>(rf, nullptr, pts, vcode, centers, proj, V, R, S, C, Cp,
                                  hf, wf, wptrs, n_ptrs, h_scratch, q_scratch, rgb_out,
                                  w_out, cnt_out, stream_ptr, nullptr, &m3);
  return run_forward<VSRC_MASK>(rf, mask, pts, vcode, centers, nullptr, V, R, S, C, Cp,
                                hf, wf, wptrs, n_ptrs, h_scratch, q_scratch, rgb_out,
                                w_out, cnt_out, stream_ptr, nullptr, &m3);
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
  const size_t sm = view_smem();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(k_view<VSRC_SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm))) return (int)err;
  k_view<VSRC_SPLIT><<<(N + TT - 1) / TT, NTHREADS, sm, (cudaStream_t)stream_ptr>>>(
      (const bf16*)h, (const float*)q_in, (float*)q_out, nullptr, nullptr, nullptr,
      nullptr, (const uint8_t*)mask, (const float*)ray_diff, nullptr, nullptr, V, N, 1,
      0.f, 0.f, a, 0);
  return (int)cudaGetLastError();
}

// K3b: one ray block over R rays of S samples, q_in [R, S, 64] f32 ->
// q_out (may be q_in), and w_out [R, S] f32, the head-mean of the first
// query's attention row. wptrs: N_RAY_PTRS pointers of pack_ray_block.
int gnt_split_ray_forward(const void* q_in, void* q_out, void* w_out, int R, int S,
                          const uint64_t* wptrs, int n_ptrs, void* stream_ptr) {
  if (n_ptrs != N_RAY_PTRS || R < 1 || S < 1) return (int)cudaErrorInvalidValue;
  PtrReader rd{wptrs, 0};
  RayW y;
  read_ray(rd, y);
  const int Sp = (S + 15) / 16 * 16;
  const size_t sm = ray_layout(Sp).total;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(k_ray<VSRC_SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm))) return (int)err;
  FinalW none{};
  k_ray<VSRC_SPLIT><<<R, NTHREADS, sm, (cudaStream_t)stream_ptr>>>(
      (const float*)q_in, (float*)q_out, nullptr, nullptr, nullptr, 1, S, Sp, 0.f,
      0.f, y, 1, 0, none, nullptr, (float*)w_out, nullptr);
  return (int)cudaGetLastError();
}

int gnt_split_n_view_ptrs() { return N_VIEW_PTRS; }

int gnt_split_n_ray_ptrs() { return N_RAY_PTRS; }

}  // extern "C"
