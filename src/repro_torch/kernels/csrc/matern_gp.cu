// Fused Matérn GP posterior over a candidate panel, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/matern_gp.py, _gp_kernel (Pallas TPU kernel
// behind the wrapper gp_posterior). Same function, per candidate c:
//   d2_j = |xo_j|^2 + |xc|^2 - 2 xo_j.xc      (expanded form, as the reference)
//   k_j  = matern_nu(sqrt(max(d2_j, 0)) / ell) * mask_j
//   v_i  = sum_{j<=i} Linv[i,j] k_j           (Linv lower-triangular)
//   mean = sum_i w_i v_i,  var = max(1 - sum_i v_i^2, 1e-12)
// Padded observation rows are zeros, so their k_j is NOT zero until the mask
// multiplies it: the mask is applied here as in the reference.
//
// Bounds on an H100 SXM at the paper's panel (N = 18,432 padded candidates,
// T = 256 padded observations, d = 15), counting N*(3*T*d + T^2) flop (the
// distances, then the triangular product V = Linv K): all on the CUDA cores
// at 67 TFLOP/s, 21 us; on the path this kernel takes, the product as
// 3xTF32 on the tensor cores (3 N T^2 / 495 TFLOP/s, 7.3 us) plus the
// distances on the CUDA cores (3.2 us), 10.5 us. The bytes (x_cand, x_obs,
// Linv, w, mask read once, mean and var written once: 1.5 MB) take 0.4 us.
// Bound by operations. Design:
//   * a block owns block_n candidates (the BO-tuned parameter: it sets the
//     grid, N / block_n blocks) and streams them in sub-panels of 32;
//   * each sub-panel's kernel columns, T x 32 values, are computed once into
//     shared memory with every rounding explicit, so K matches the plain
//     version to the ulp;
//   * V = Linv K runs as a GEMM on the tensor cores (mma.sync m16n8k8,
//     3xTF32 from mma_tf32x3.cuh, fp32 accuracy; each k8 step's sum is
//     added to V on the CUDA cores, since the tensor cores' sums round
//     toward zero). Linv is staged through a two-slot ring of 64x64 tiles
//     by cp.async, walking only the lower triangle (row panel i reads
//     column tiles 0..i); the next tile loads while the block multiplies
//     the current one. Each of the 8 warps owns 16 rows x 16 candidates of
//     a 64-row panel;
//   * when a row panel is complete its rows fold into mean and sum(v^2) in
//     registers, then across lanes and warps. V never reaches device memory.
// Shared memory at T = 256, d = 15: the K panel (40 KB) and two Linv tiles
// (34 KB), 80 KB in all, so two blocks fit on an SM. The observations are
// read through L1 (every lane of a warp reads the same row), not staged, so
// the footprint barely grows with d. T may be any multiple of 64 whose panel
// fits: T = 1024 (513 to 1024 observations, from a long or warm-started
// run) takes 209 KB.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;         // candidates a sub-panel
constexpr int LT = 64;           // Linv tile edge: rows of a V panel
constexpr int KS_LD = TILE + 8;  // K panel row stride: B fragments hit distinct banks
constexpr int L_LD = LT + 4;     // Linv tile row stride: A fragments likewise
constexpr int WARPS_M = 4;       // warps along a panel's 64 rows (16 each)
constexpr int WARPS_N = 2;       // warps along the 32 candidates (16 each)
constexpr int SLOTS = 2;         // Linv ring: a tile lands while one is used
constexpr int ROWS = 4;          // covariance rows a thread builds at once

// Every rounding below is explicit (_rn intrinsics, no FMA contraction) and
// in the plain version's order (kernels/ref.py), so the covariance matches it
// to the ulp: near r = 0 the expanded distance cancels, and the Matérn-1/2
// kink turns a last-bit difference in d2 into a visible one in k.
__device__ __forceinline__ float matern(float r, float inv_ell, int nu) {
  const float s = __fmul_rn(r, inv_ell);
  switch (nu) {
    case 0:
      return expf(-s);
    case 1: {
      const float t = __fmul_rn(1.7320508075688772f, s);
      return __fmul_rn(__fadd_rn(1.0f, t), expf(-t));
    }
    case 2: {
      const float t = __fmul_rn(2.23606797749979f, s);
      const float q = __fmul_rn(1.6666666666666667f, __fmul_rn(s, s));
      return __fmul_rn(__fadd_rn(__fadd_rn(1.0f, t), q), expf(-t));
    }
    default:
      return expf(__fmul_rn(-0.5f, __fmul_rn(s, s)));
  }
}

// sum_k a[k]*b[k], each product and sum rounded in index order
__device__ __forceinline__ float dot_rn(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int k = 0; k < d; ++k) s = __fadd_rn(s, __fmul_rn(a[k], b[k]));
  return s;
}

__host__ __device__ __forceinline__ int odd_stride(int d) { return d | 1; }

// Shared-memory floats one block needs; mirrored by kernels/matern_gp.py
// gp_smem_bytes.
__host__ __device__ __forceinline__ size_t smem_floats(int T, int d) {
  return (size_t)T * KS_LD       // Ks: kernel columns of the sub-panel
         + SLOTS * (size_t)LT * L_LD  // the Linv ring
         + 3 * (size_t)T         // |x_obs|^2, w, mask
         + (size_t)TILE * odd_stride(d) + TILE   // sub-panel x_cand, |x_cand|^2
         + 2 * WARPS_M * TILE;   // cross-warp reduction
}

__global__ void gp_posterior_kernel(const float* __restrict__ xc, const float* __restrict__ xo,
                    const float* __restrict__ vinv, const float* __restrict__ w,
                    const float* __restrict__ mask, float* __restrict__ mean,
                    float* __restrict__ var, int T, int d, float inv_ell, int nu,
                    int block_n) {
  extern __shared__ __align__(16) float sm[];
  const int dp = odd_stride(d);   // odd row stride: lanes hit distinct banks
  float* Ks = sm;                 // [T][KS_LD]
  float* Ls = Ks + T * KS_LD;     // [SLOTS][LT][L_LD]
  float* osq = Ls + SLOTS * LT * L_LD;  // [T]
  float* ws = osq + T;            // [T]
  float* ms = ws + T;             // [T]
  float* xcs = ms + T;            // [TILE][dp]
  float* csq = xcs + TILE * dp;   // [TILE]
  float* red = csq + TILE;        // [2][WARPS_M][TILE]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;   // rows wm*16 .. +15 of a panel
  const int wn = warp % WARPS_N;   // candidates wn*16 .. +15
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;

  for (int i = tid; i < T; i += THREADS) {
    ws[i] = w[i];
    ms[i] = mask[i];
    osq[i] = dot_rn(xo + (size_t)i * d, xo + (size_t)i * d, d);
  }

  // Linv tile (pi, pj) into ring slot q % SLOTS, one commit group
  auto load_tile = [&](int q, int pi, int pj) {
    float* dst = Ls + (q % SLOTS) * LT * L_LD;
    const float* src = vinv + (size_t)pi * LT * T + pj * LT;
    for (int v = tid; v < LT * LT / 4; v += THREADS) {
      const int r = v / (LT / 4), c = (v % (LT / 4)) * 4;
      tc::cp_async16(dst + r * L_LD + c, src + (size_t)r * T + c);
    }
    tc::cp_async_commit();
  };

  const int panels = T / LT;
  const int n_tiles = panels * (panels + 1) / 2;   // the lower triangle
  const int base = blockIdx.x * block_n;
  for (int c0 = base; c0 < base + block_n; c0 += TILE) {
    __syncthreads();   // the last sub-panel is done with Ls, Ks, xcs and red
    load_tile(0, 0, 0);  // lands while the kernel columns are computed
    for (int i = tid; i < TILE * d; i += THREADS)
      xcs[(i / d) * dp + i % d] = xc[(size_t)c0 * d + i];
    __syncthreads();
    if (tid < TILE) csq[tid] = dot_rn(xcs + tid * dp, xcs + tid * dp, d);
    __syncthreads();

    // kernel columns: lane c, observations j = warp + 8 u, four at a time
    // so that four rounding chains are in flight (each in dot_rn's order)
    const float* xcl = xcs + lane * dp;
    const float cs = csq[lane];
    for (int j0 = warp; j0 < T; j0 += ROWS * WARPS) {
      float dot[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) dot[u] = 0.f;
      for (int k = 0; k < d; ++k) {
        const float x = xcl[k];
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
          dot[u] = __fadd_rn(
              dot[u], __fmul_rn(__ldg(xo + (j0 + u * WARPS) * d + k), x));
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int j = j0 + u * WARPS;
        const float d2 = __fsub_rn(__fadd_rn(osq[j], cs), __fmul_rn(2.0f, dot[u]));
        Ks[j * KS_LD + lane] = __fmul_rn(matern(sqrtf(fmaxf(d2, 0.0f)), inv_ell, nu), ms[j]);
      }
    }

    // V = Linv K over the lower-triangular tiles, row panel by row panel
    float acc[2][4], mpart[2][2], spart[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      mpart[j][0] = mpart[j][1] = 0.f;
      spart[j][0] = spart[j][1] = 0.f;
    }
    int pi = 0, pj = 0;
    for (int q = 0; q < n_tiles; ++q) {
      tc::cp_async_wait(0);   // tile q has landed (this thread's copies)
      __syncthreads();        // ... everyone's; K is written; slot q-1 free
      const int ni = pj < pi ? pi : pi + 1;   // the walk's next tile
      const int nj = pj < pi ? pj + 1 : 0;
      if (q + 1 < n_tiles) load_tile(q + 1, ni, nj);
      const float* Lt = Ls + (q % SLOTS) * LT * L_LD + wm * 16 * L_LD;
      const float* Kt = Ks + pj * LT * KS_LD + wn * 16;
#pragma unroll
      for (int kk = 0; kk < LT; kk += 8) {
        uint32_t ab[4], as[4];
        tc::load_a_tf32x3(Lt + kk, L_LD, lane, ab, as);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bb[2], bs[2];
          tc::load_b_tf32x3(Kt + kk * KS_LD + j * 8, KS_LD, lane, bb, bs);
          // the tensor cores round their sums toward zero: each k8 step sums
          // into a fresh fragment, added to V here rounded to nearest, so
          // the large cancelling terms of L^-1 K do not drift one way
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          tc::mma_tf32x3(part, ab, as, bb, bs);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
        }
      }
      if (pj == pi) {   // rows pi*64 .. +63 of V are complete: fold them
        const int r = pi * LT + wm * 16 + g;
        const float w0 = ws[r], w1 = ws[r + 8];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v0 = acc[j][e], v1 = acc[j][e + 2];
            mpart[j][e] = fmaf(w1, v1, fmaf(w0, v0, mpart[j][e]));
            spart[j][e] = fmaf(v1, v1, fmaf(v0, v0, spart[j][e]));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        }
      }
      pi = ni;
      pj = nj;
    }

    // sum over the 8 row groups of a fragment (lanes with one lane % 4),
    // then over the 4 warps along the rows
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          mpart[j][e] += __shfl_xor_sync(0xffffffffu, mpart[j][e], o);
          spart[j][e] += __shfl_xor_sync(0xffffffffu, spart[j][e], o);
        }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn * 16 + j * 8 + t2 + e;
          red[wm * TILE + col] = mpart[j][e];
          red[(WARPS_M + wm) * TILE + col] = spart[j][e];
        }
    }
    __syncthreads();
    if (warp == 0) {
      float m = 0.f, s = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS_M; ++k) {
        m += red[k * TILE + lane];
        s += red[(WARPS_M + k) * TILE + lane];
      }
      mean[c0 + lane] = m;
      var[c0 + lane] = fmaxf(1.0f - s, 1e-12f);
    }
  }
}

}  // namespace

extern "C" {

int gp_posterior_f32(const void* xc, const void* xo, const void* vinv,
                     const void* w, const void* mask, void* mean, void* var,
                     int N, int T, int d, float inv_ell, int nu, int block_n,
                     void* stream) {
  if (N <= 0 || d <= 0 || block_n <= 0 || block_n % TILE || N % block_n ||
      T <= 0 || T % LT || nu < 0 || nu > 3)
    return cudaErrorInvalidValue;
  const size_t smem = smem_floats(T, d) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(gp_posterior_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  gp_posterior_kernel<<<N / block_n, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xc), static_cast<const float*>(xo),
      static_cast<const float*>(vinv), static_cast<const float*>(w),
      static_cast<const float*>(mask), static_cast<float*>(mean),
      static_cast<float*>(var), T, d, inv_ell, nu, block_n);
  return cudaGetLastError();
}

int gp_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, gp_posterior_kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
