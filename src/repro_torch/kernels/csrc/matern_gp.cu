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
// Bound on an H100 SXM at the paper's panel (N = 18,432 padded candidates,
// T = 256 padded observations, d = 15): about N*(3*T*d + T^2) = 1.4e9 flop
// over 67 TFLOP/s is 21 us; the bytes (x_cand, x_obs, Linv, w, mask read
// once, mean and var written once: 1.5 MB) take 0.4 us. Bound by operations,
// almost all of them the triangular product V = Linv K. Design:
//   * a block owns block_n candidates (the BO-tuned parameter: it sets the
//     grid, N / block_n blocks) and streams them in sub-tiles of 32, one
//     candidate per lane;
//   * each candidate's kernel column, all T values, is computed once into
//     shared memory (T x 32 floats: 32 KB at T = 256, 64 KB at T = 512);
//   * each warp accumulates 8 rows of V at a time in registers, reading the
//     rows of Linv with 16-byte loads (the same address across the warp, so
//     one broadcast from L1/L2: Linv, 256 KB at T = 256, is shared by every
//     block and stays in L2) and skipping the upper triangle;
//   * mean and sum(v^2) are reduced in registers, then across the 8 warps
//     in shared memory. V is never written to device memory.
// T may be any multiple of 64 whose tiles fit in shared memory (T = 512 for
// a warm-started run whose observations outgrow 256 needs about 104 KB).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;     // candidates per sub-tile: one per lane
constexpr int ROWS = 8;      // rows of V a thread accumulates at once

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

// Shared-memory floats one block needs; mirrored by kernels/ops.py gp_smem_bytes.
__host__ __device__ __forceinline__ size_t smem_floats(int T, int d) {
  return (size_t)T * TILE        // Ks: kernel columns of the sub-tile
         + (size_t)T * d         // x_obs
         + 3 * (size_t)T         // |x_obs|^2, w, mask
         + (size_t)TILE * odd_stride(d) + TILE   // sub-tile x_cand, |x_cand|^2
         + 2 * WARPS * TILE;     // cross-warp reduction
}

__global__ void gp_posterior_kernel(const float* __restrict__ xc, const float* __restrict__ xo,
                    const float* __restrict__ vinv, const float* __restrict__ w,
                    const float* __restrict__ mask, float* __restrict__ mean,
                    float* __restrict__ var, int T, int d, float inv_ell, int nu,
                    int block_n) {
  extern __shared__ __align__(16) float sm[];
  const int dp = odd_stride(d);   // odd row stride: lanes hit distinct banks
  float* Ks = sm;                 // [T][TILE]
  float* xos = Ks + T * TILE;     // [T][d]
  float* osq = xos + T * d;       // [T]
  float* ws = osq + T;            // [T]
  float* ms = ws + T;             // [T]
  float* xcs = ms + T;            // [TILE][dp]
  float* csq = xcs + TILE * dp;   // [TILE]
  float* red = csq + TILE;        // [2][WARPS][TILE]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < T * d; i += THREADS) xos[i] = xo[i];
  for (int i = tid; i < T; i += THREADS) {
    ws[i] = w[i];
    ms[i] = mask[i];
  }
  __syncthreads();
  for (int j = tid; j < T; j += THREADS) osq[j] = dot_rn(xos + j * d, xos + j * d, d);

  const int n_blocks = T / ROWS;          // row blocks of V
  const int per_warp = n_blocks / WARPS;  // T % (ROWS * WARPS) == 0
  const int base = blockIdx.x * block_n;
  for (int c0 = base; c0 < base + block_n; c0 += TILE) {
    for (int i = tid; i < TILE * d; i += THREADS)
      xcs[(i / d) * dp + i % d] = xc[(size_t)c0 * d + i];
    __syncthreads();
    if (tid < TILE) csq[tid] = dot_rn(xcs + tid * dp, xcs + tid * dp, d);
    __syncthreads();

    // kernel columns: a warp covers one observation j for all 32 lanes
    for (int e = tid; e < T * TILE; e += THREADS) {
      const int j = e / TILE;
      const int c = e % TILE;
      const float dot = dot_rn(xos + j * d, xcs + c * dp, d);
      const float d2 = __fsub_rn(__fadd_rn(osq[j], csq[c]), __fmul_rn(2.0f, dot));
      Ks[e] = __fmul_rn(matern(sqrtf(fmaxf(d2, 0.0f)), inv_ell, nu), ms[j]);
    }
    __syncthreads();

    // V rows, 8 at a time. Row blocks are dealt to warps in snake order so
    // every warp gets an equal share of the triangle.
    float mpart = 0.f, spart = 0.f;
    for (int q = 0; q < per_warp; ++q) {
      const int blk = q * WARPS + ((q & 1) ? WARPS - 1 - warp : warp);
      const int i0 = blk * ROWS;
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      const float* L0 = vinv + (size_t)i0 * T;
      // row i0+r needs j <= i0+r; j in (i0+r, i0+ROWS) meets the upper
      // triangle's zeros, so one bound serves the whole row block
      for (int j = 0; j < i0 + ROWS; j += 4) {
        const float k0 = Ks[(j + 0) * TILE + lane];
        const float k1 = Ks[(j + 1) * TILE + lane];
        const float k2 = Ks[(j + 2) * TILE + lane];
        const float k3 = Ks[(j + 3) * TILE + lane];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 l = __ldg(reinterpret_cast<const float4*>(L0 + (size_t)r * T + j));
          acc[r] = fmaf(l.x, k0, acc[r]);
          acc[r] = fmaf(l.y, k1, acc[r]);
          acc[r] = fmaf(l.z, k2, acc[r]);
          acc[r] = fmaf(l.w, k3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        mpart = fmaf(ws[i0 + r], acc[r], mpart);
        spart = fmaf(acc[r], acc[r], spart);
      }
    }
    red[warp * TILE + lane] = mpart;
    red[(WARPS + warp) * TILE + lane] = spart;
    __syncthreads();
    if (warp == 0) {
      float m = 0.f, s = 0.f;
#pragma unroll
      for (int g = 0; g < WARPS; ++g) {
        m += red[g * TILE + lane];
        s += red[(WARPS + g) * TILE + lane];
      }
      mean[c0 + lane] = m;
      var[c0 + lane] = fmaxf(1.0f - s, 1e-12f);
    }
    // the next sub-tile's first __syncthreads orders these reads of red
    // before any warp writes Ks or red again
  }
}

}  // namespace

extern "C" {

int gp_posterior_f32(const void* xc, const void* xo, const void* vinv,
                     const void* w, const void* mask, void* mean, void* var,
                     int N, int T, int d, float inv_ell, int nu, int block_n,
                     void* stream) {
  if (N <= 0 || d <= 0 || block_n <= 0 || block_n % TILE || N % block_n ||
      T <= 0 || T % (ROWS * WARPS) || nu < 0 || nu > 3)
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
