// Tiled GEMM, C = A @ B, for Hopper (sm_90a) on the tensor cores.
//
// Replaces: src/repro/kernels/gemm.py, _gemm_kernel (Pallas TPU kernel behind
// the wrapper gemm). Same function: A (M,K) times B (K,N), accumulated in
// fp32, written back in A's dtype (fp32 or bf16).
//
// Bounds on an H100 SXM at M = N = K = 4096 (2*M*N*K = 1.37e11 flop; the
// bytes, A and B read once and C written once, take 0.06 ms in fp32):
//   * fp32 on the CUDA cores, 67 TFLOP/s: 2.051 ms. cuBLAS's fp32 product
//     runs there; this kernel does not.
//   * fp32 as 3xTF32 on the tensor cores: three TF32 products per product at
//     495 TFLOP/s dense, 0.833 ms. Each fp32 operand is split into two TF32
//     values (mma_tf32x3.cuh) and the products are summed small terms first,
//     so the result keeps fp32 accuracy: plain TF32 (one product) would lose
//     it at this depth.
//   * bf16 on the tensor cores, 989 TFLOP/s: 0.139 ms (one mma a product).
// Both are bound by operations, so the design feeds the tensor cores:
//   * mma.sync m16n8k8 (TF32, fp32) or m16n8k16 (bf16); each warp owns a
//     64x32 tile of C, 4x4 fragments, 64 fp32 accumulators a thread, so a
//     block of block_m x block_n runs (block_m/64)(block_n/32) warps. In
//     fp32 each ring stage sums into 64 more and is added to the running
//     sum on the CUDA cores (the tensor cores' sums round toward zero).
//     That takes 224 registers a thread, so an fp32 block has at most 8
//     warps; bf16 fits 128 and takes 16. Folding each k8 step instead
//     (4 registers, not 64) fits 128 only with spills, and ran slower on
//     the card at every block shape tried (PERF.md);
//   * A and B tiles reach shared memory through a ring of cp.async 16-byte
//     copies, min(4, 227 KB / stage) stages deep: the loads of tile k+S-1
//     run while tile k is multiplied, one __syncthreads a tile. The stage
//     count follows from the block shape; a shape with room for fewer than
//     2 stages is refused (the tuner's static invalid, kernels/ops.py);
//   * A stays K-major (no transpose on the way in), each row padded by 4
//     floats (8 bf16), B's rows by 8 elements, so the lanes of a fragment
//     load hit 32 distinct banks and every row stays 16-byte aligned;
//   * the K loop runs inside the block. On the TPU K was a sequential grid
//     axis carrying the accumulator between grid steps; Hopper blocks run in
//     any order and share nothing, so each block owns its whole K range.
// block_m/n/k are runtime values, the BO search space. A config whose
// registers or shared memory the card cannot give is refused at launch, and
// the entry point returns that error: the tuner's runtime-invalid config.
// Not yet used: wgmma, TMA, a producer warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int WM = 64;              // warp tile rows
constexpr int WN = 32;              // warp tile cols
constexpr int MT = WM / 16;         // m16 fragments a warp
constexpr int NT = WN / 8;          // n8 fragments a warp
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, a block's opt-in maximum

template <typename T>
struct Tile {
  static constexpr int PAD_A = 16 / sizeof(T);   // 4 floats, 8 bf16
  static constexpr int PAD_B = 8;
  static constexpr int VEC = 16 / sizeof(T);     // elements a cp.async
  // the launch bound: a block's threads times the registers nvcc may then
  // give each (fp32 224, bf16 128) stay within the SM's 65,536
  static constexpr int MAX_THREADS = sizeof(T) == 4 ? 256 : 512;
};

// Elements of one ring stage (A then B); mirrored by kernels/gemm.py.
template <typename T>
__host__ __device__ __forceinline__ int stage_elems(int bm, int bn, int bk) {
  return bm * (bk + Tile<T>::PAD_A) + bk * (bn + Tile<T>::PAD_B);
}

template <typename T>
int ring_stages(int bm, int bn, int bk) {
  const int s = SMEM_LIMIT / (stage_elems<T>(bm, bn, bk) * (int)sizeof(T));
  return s < MAX_STAGES ? s : MAX_STAGES;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tc::smem_addr(p)));
}

// c += a * b, bf16 in, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's 64x32 tile over one ring stage: As at the warp's first row,
// Bs at its first column. The tensor cores round each mma's fp32 sum toward
// zero, so a chain of K/8 x 3 mma into one accumulator drifts by up to
// about half an ulp of C each (measured at 4096^3: 1.1e-2, over the fp32
// limit). So a stage is summed into a fresh fragment and added to the
// running sum on the CUDA cores, rounded to nearest: the drift stays within
// a stage, at the stage sum's smaller ulp, and changes sign between stages.
__device__ __forceinline__ void warp_tile(const float* As, int lda,
                                          const float* Bs, int ldb, int bk,
                                          int lane, float (*acc)[NT][4]) {
  float part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
  // bk is a multiple of 64: each 64-deep chunk is unrolled, so the loads
  // and splits of a step can be issued under the previous step's mma
  for (int k0 = 0; k0 < bk; k0 += 64)
#pragma unroll
  for (int kk = k0; kk < k0 + 64; kk += 8) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      tc::load_b_tf32x3(Bs + kk * ldb + j * 8, ldb, lane, bb[j], bs[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ab[4], as[4];
      tc::load_a_tf32x3(As + i * 16 * lda + kk, lda, lane, ab, as);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        tc::mma_tf32x3(part[i][j], ab, as, bb[j], bs[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
}

__device__ __forceinline__ void warp_tile(const __nv_bfloat16* As, int lda,
                                          const __nv_bfloat16* Bs, int ldb,
                                          int bk, int lane,
                                          float (*acc)[NT][4]) {
  // ldmatrix rows: lanes 0-15 address rows 0-15 of the fragment, lanes
  // 16-31 the same rows 8 elements on (the second k half for A, the next
  // n8 fragment for B)
  const int r = lane & 15, h = (lane >> 4) * 8;
  for (int k0 = 0; k0 < bk; k0 += 64)
#pragma unroll
  for (int kk = k0; kk < k0 + 64; kk += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t q[4];
      ldmatrix_x4_trans(q, Bs + (kk + r) * ldb + j * 8 + h);
      b[j][0] = q[0];
      b[j][1] = q[1];
      b[j + 1][0] = q[2];
      b[j + 1][1] = q[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a, As + (i * 16 + r) * lda + kk + h);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T>
__global__ void __launch_bounds__(Tile<T>::MAX_THREADS)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ C, int M, int N, int K, int bm, int bn, int bk,
                int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int VEC = Tile<T>::VEC;
  const int lda = bk + Tile<T>::PAD_A;
  const int ldb = bn + Tile<T>::PAD_B;
  const int a_elems = bm * lda;
  const int stage = stage_elems<T>(bm, bn, bk);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / (bn / WN);
  const int wn = warp % (bn / WN);
  const int row0 = blockIdx.y * bm;
  const int col0 = blockIdx.x * bn;
  const T* Ag = A + (size_t)row0 * K;
  const T* Bg = B + col0;
  // copy plan: each thread copies one fixed 16-byte column of a tile, on
  // every step-th row (the launcher checks that the rows divide evenly)
  const int a_row = bk / VEC, a_step = nthreads / a_row;
  const int b_row = bn / VEC, b_step = nthreads / b_row;
  const int a_r = tid / a_row, a_c = (tid % a_row) * VEC;
  const int b_r = tid / b_row, b_c = (tid % b_row) * VEC;
  const int k_tiles = K / bk;

  auto load = [&](int s, int kt) {
    T* ad = sm + s * stage + a_r * lda + a_c;
    const T* a = Ag + (size_t)a_r * K + (size_t)kt * bk + a_c;
    for (int r = a_r; r < bm; r += a_step) {
      tc::cp_async16(ad, a);
      ad += a_step * lda;
      a += (size_t)a_step * K;
    }
    T* bd = sm + s * stage + a_elems + b_r * ldb + b_c;
    const T* b = Bg + ((size_t)kt * bk + b_r) * N + b_c;
    for (int r = b_r; r < bk; r += b_step) {
      tc::cp_async16(bd, b);
      bd += b_step * ldb;
      b += (size_t)b_step * N;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // fill stages-1 slots of the ring; a group is committed even when empty,
  // so the count of groups in flight is the same on every iteration
  for (int s = 0; s < stages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    tc::cp_async_wait(stages - 2);   // tile kt has landed (this thread's)
    __syncthreads();                 // ... everyone's; slot kt-1 is free
    const int next = kt + stages - 1;
    if (next < k_tiles) load(next % stages, next);
    tc::cp_async_commit();
    const T* As = sm + (kt % stages) * stage;
    warp_tile(As + wm * WM * lda, lda, As + a_elems + wn * WN, ldb, bk, lane,
              acc);
  }

  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = row0 + wm * WM + i * 16 + g;
      const int c = col0 + wn * WN + j * 8 + t2;
      store2(C + (size_t)r * N + c, acc[i][j][0], acc[i][j][1]);
      store2(C + (size_t)(r + 8) * N + c, acc[i][j][2], acc[i][j][3]);
    }
}

template <typename T>
int launch_gemm(const void* a, const void* b, void* c, int M, int N, int K,
                int bm, int bn, int bk, cudaStream_t stream) {
  if (bm <= 0 || bn <= 0 || bk <= 0 || bm % WM || bn % WN || bk % 64 ||
      M % bm || N % bn || K % bk)
    return cudaErrorInvalidValue;
  const int stages = ring_stages<T>(bm, bn, bk);
  if (stages < 2) return cudaErrorInvalidConfiguration;
  const int threads = (bm / WM) * (bn / WN) * 32;
  if (threads > Tile<T>::MAX_THREADS) return cudaErrorInvalidConfiguration;
  // the copy plan's rows divide evenly among the threads
  const int a_row = bk / Tile<T>::VEC, b_row = bn / Tile<T>::VEC;
  if (threads % a_row || bm % (threads / a_row) || threads % b_row ||
      bk % (threads / b_row))
    return cudaErrorInvalidConfiguration;
  const size_t smem =
      (size_t)stages * stage_elems<T>(bm, bn, bk) * sizeof(T);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(gemm_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / bn, M / bm);
  gemm_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, bm, bn, bk, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gemm_f32(const void* a, const void* b, void* c, int M, int N, int K,
             int bm, int bn, int bk, void* stream) {
  return launch_gemm<float>(a, b, c, M, N, K, bm, bn, bk,
                            static_cast<cudaStream_t>(stream));
}

int gemm_bf16(const void* a, const void* b, void* c, int M, int N, int K,
              int bm, int bn, int bk, void* stream) {
  return launch_gemm<__nv_bfloat16>(a, b, c, M, N, K, bm, bn, bk,
                                    static_cast<cudaStream_t>(stream));
}

// Registers per thread and local (spill) bytes of one instance: 0 = fp32,
// 1 = bf16. The resource model and the smoke log read these.
int gemm_attrs(int dtype, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      dtype == 0 ? cudaFuncGetAttributes(&attr, gemm_kernel<float>)
                 : cudaFuncGetAttributes(&attr, gemm_kernel<__nv_bfloat16>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
