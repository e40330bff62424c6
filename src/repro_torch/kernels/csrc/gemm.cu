// Tiled GEMM, C = A @ B, for Hopper (sm_90a) on the CUDA cores.
//
// Replaces: src/repro/kernels/gemm.py, _gemm_kernel (Pallas TPU kernel behind
// the wrapper gemm). Same function: A (M,K) times B (K,N), accumulated in
// fp32, written back in A's dtype (fp32 or bf16).
//
// Bound on an H100 SXM at M = N = K = 4096 in fp32: 2*M*N*K = 1.37e11 flop
// over the 67 TFLOP/s fp32 peak is 2.05 ms; the bytes (A and B read once, C
// written once: 192 MiB) over 3.35 TB/s take 0.06 ms. The kernel is bound by
// operations, so its design is about feeding the FMA units:
//   * each thread keeps an 8x8 tile of fp32 accumulators in registers, so
//     every value it reads from shared memory feeds 8 FMAs;
//   * a block_m x block_k tile of A (stored transposed) and a block_k x
//     block_n tile of B are staged in dynamic shared memory with 16-byte
//     loads; block_m/n/k are runtime values, the BO search space;
//   * the K loop runs inside the block. On the TPU K was a sequential grid
//     axis carrying the accumulator between grid steps; Hopper blocks run in
//     any order and share nothing, so each block owns its whole K range.
// Threads per block = block_m*block_n/64. A config whose registers or shared
// memory the card cannot give is refused at launch, and the entry point
// returns that error: the tuner's runtime-invalid configuration.
// Not yet used: tensor cores (wgmma), TMA, double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;   // accumulator rows per thread
constexpr int TN = 8;   // accumulator cols per thread

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  out[4] = v.x; out[5] = v.y; out[6] = v.z; out[7] = v.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T>
__global__ void gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                            T* __restrict__ C, int M, int N, int K, int bm,
                            int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);   // [bk][bm]: A tile, transposed
  T* Bs = As + bm * bk;                     // [bk][bn]
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tx = tid % (bn / TN);
  const int ty = tid / (bn / TN);
  const int row0 = blockIdx.y * bm;
  const int col0 = blockIdx.x * bn;
  const int a_vecs = bm * (bk / VEC);
  const int b_vecs_row = bn / VEC;
  const int b_vecs = bk * b_vecs_row;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float a[TM], b[TN];

  for (int k0 = 0; k0 < K; k0 += bk) {
    // A tile: row m fastest across threads, so the transposed shared-memory
    // stores of a warp land in distinct banks
    for (int v = tid; v < a_vecs; v += nthreads) {
      const int m = v % bm;
      const int kv = (v / bm) * VEC;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          A + (size_t)(row0 + m) * K + k0 + kv);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int q = 0; q < VEC; ++q) As[(kv + q) * bm + m] = e[q];
    }
    for (int v = tid; v < b_vecs; v += nthreads) {
      const int k = v / b_vecs_row;
      const int nv = (v % b_vecs_row) * VEC;
      *reinterpret_cast<uint4*>(Bs + k * bn + nv) =
          *reinterpret_cast<const uint4*>(B + (size_t)(k0 + k) * N + col0 + nv);
    }
    __syncthreads();
    for (int k = 0; k < bk; ++k) {
      load8(As + k * bm + ty * TM, a);
      load8(Bs + k * bn + tx * TN, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
    store8(C + (size_t)(row0 + ty * TM + i) * N + col0 + tx * TN, acc[i]);
}

template <typename T>
int launch_gemm(const void* a, const void* b, void* c, int M, int N, int K,
                int bm, int bn, int bk, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (bm <= 0 || bn <= 0 || bk <= 0 || bm % TM || bn % TN || bk % VEC ||
      bn % VEC || M % bm || N % bn || K % bk)
    return cudaErrorInvalidValue;
  const int threads = (bm / TM) * (bn / TN);
  const size_t smem = (size_t)(bm * bk + bk * bn) * sizeof(T);
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
      M, N, K, bm, bn, bk);
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
