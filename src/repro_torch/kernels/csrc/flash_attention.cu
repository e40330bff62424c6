// Causal flash attention (prefill) for Hopper (sm_90a), on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel (Pallas TPU
// kernel behind the wrapper flash_attention). Same function: q (B,S,H,hd),
// k/v (B,S,KV,hd) -> o (B,S,H,hd) in q's dtype (fp32 or bf16); scores
// s = (q.k) * scale in fp32, masked above the diagonal with the reference's
// -1e30 sentinel; an online softmax over KV tiles of block_kv keys keeps
// (m, l, acc) on chip, p is cast to v's dtype before p.v, and acc / l is
// written once. Head h reads KV head h / (H/KV): for MQA the reference's
// jnp.repeat of K and V into H heads is never made.
//
// Bound on an H100 SXM at the serving prefill (B 4, S 1,024, H 8, hd 256,
// bf16, causal): 4*B*H*hd*S*(S+1)/2 = 17.2 GFLOP (both products, the
// causal half); against the 989 TFLOP/s bf16 tensor-core peak that is
// 17 us, the 25 MB of q, k, v and o take 8 us: bound by operations. This
// kernel runs on the CUDA cores in fp32 (67 TFLOP/s, 0.26 ms at best):
// tensor cores (wgmma) and TMA are for a later PR. Design:
//   * a block owns block_q query rows of one (b, h) (grid S/block_q x H x B)
//     and streams them in sub-tiles of 64 rows; it loops over its KV tiles
//     itself, replacing the TPU's sequential kv grid axis, and stops at the
//     diagonal (tiles wholly above it are skipped: their p is 0);
//   * the q sub-tile (transposed, fp32) stays in shared memory; keys are
//     staged 64 at a time (K transposed for the score product, V row-major
//     for p.v) through one buffer, so shared memory grows with block_kv only
//     through the 64 x block_kv fp32 score tile: hd*64*4 + 64*hd*4 +
//     64*block_kv*4 bytes, the resource model kernels/ops.py flash_valid
//     mirrors (block_kv 128 and 256 fit at hd 256; 512 does not);
//   * scores: each thread a 4x4 register tile of the 64 x 64 chunk; p.v:
//     each warp 8 rows, each lane hd/32 output dims, 8*hd/32 fp32
//     accumulators in registers for the whole KV loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QT = 64;                // query rows per sub-tile
constexpr int KT = 64;                // keys per staged chunk
constexpr float NEG_INF = -1e30f;     // the reference's mask sentinel

__host__ __device__ inline size_t smem_floats(int hd, int bkv) {
  return (size_t)hd * QT + (size_t)KT * hd + (size_t)QT * bkv + 3 * QT;
}

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int N>
__device__ __forceinline__ void load_smem(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      out[i] = u.x; out[i + 1] = u.y; out[i + 2] = u.z; out[i + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KVH, int bq, int bkv, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                  // [HD][QT]: the q sub-tile, transposed
  float* KV = Qt + HD * QT;        // K chunk [HD][KT], or V chunk [KT][HD]
  float* Ss = KV + KT * HD;        // [QT][bkv]: scores, then p
  float* m_s = Ss + QT * bkv;      // [QT] running max
  float* l_s = m_s + QT;           // [QT] running sum
  float* c_s = l_s + QT;           // [QT] this tile's correction
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DPT = HD / 32;     // output dims per lane

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const size_t q_step = (size_t)H * HD;     // elements between positions
  const size_t kv_step = (size_t)KVH * HD;
  const T* qb = q + (size_t)b * S * q_step + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * kv_step + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * S * kv_step + (size_t)kvh * HD;
  T* ob = o + (size_t)b * S * q_step + (size_t)h * HD;

  const int sr = (tid / 16) * 4;   // score tile: rows sr..sr+3
  const int sc = (tid % 16) * 4;   //             keys sc..sc+3 of the chunk
  const int pr = warp * 8;         // p.v: rows pr..pr+7
  const int pd = lane * DPT;       //      dims pd..pd+DPT-1

  for (int q0 = blockIdx.x * bq; q0 < (blockIdx.x + 1) * bq; q0 += QT) {
    __syncthreads();               // the previous sub-tile is written out
    for (int e = tid; e < QT * (HD / VEC); e += THREADS) {
      const int r = e % QT;
      const int dv = (e / QT) * VEC;
      float f[VEC];
      load16(qb + (size_t)(q0 + r) * q_step + dv, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) Qt[(dv + i) * QT + r] = f[i];
    }
    if (tid < QT) {
      m_s[tid] = NEG_INF;
      l_s[tid] = 0.f;
    }
    float acc[8][DPT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;

    const int q_last = q0 + QT - 1;
    const int kv_end = min(S, q_last + 1);
    for (int k0 = 0; k0 < kv_end; k0 += bkv) {
      // scores of the tile, one 64-key chunk at a time
      for (int c0 = 0; c0 < bkv; c0 += KT) {
        const int kc = k0 + c0;
        if (kc > q_last) {                   // wholly above the diagonal
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) Ss[(sr + i) * bkv + c0 + sc + j] = NEG_INF;
          continue;
        }
        __syncthreads();                     // KV buffer free
        for (int e = tid; e < KT * (HD / VEC); e += THREADS) {
          const int j = e % KT;
          const int dv = (e / KT) * VEC;
          float f[VEC];
          load16(kb + (size_t)(kc + j) * kv_step + dv, f);
#pragma unroll
          for (int i = 0; i < VEC; ++i) KV[(dv + i) * KT + j] = f[i];
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
          const float4 a = *reinterpret_cast<const float4*>(Qt + d * QT + sr);
          const float4 c = *reinterpret_cast<const float4*>(KV + d * KT + sc);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool masked = kc + sc + j > q0 + sr + i;
            Ss[(sr + i) * bkv + c0 + sc + j] = masked ? NEG_INF : s[i][j] * scale;
          }
      }
      __syncthreads();

      // online softmax over the tile: warp w owns rows 8w..8w+7
      for (int r = pr; r < pr + 8; ++r) {
        float* row = Ss + r * bkv;
        float mx = NEG_INF;
        for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, row[j]);
        mx = warp_max(mx);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int j = lane; j < bkv; j += 32) {
          const float p = expf(row[j] - m_new);
          sum += p;
          row[j] = round_to(p, q);            // p in v's dtype for p.v
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float c = c_s[pr + i];
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] *= c;
      }

      // p.v, one 64-key chunk of V at a time
      for (int c0 = 0; c0 < bkv; c0 += KT) {
        const int kc = k0 + c0;
        if (kc > q_last) break;              // p is 0 from here on
        __syncthreads();                     // KV buffer free
        for (int e = tid; e < KT * (HD / VEC); e += THREADS) {
          const int j = e / (HD / VEC);
          const int dv = (e % (HD / VEC)) * VEC;
          float f[VEC];
          load16(vb + (size_t)(kc + j) * kv_step + dv, f);
#pragma unroll
          for (int i = 0; i < VEC; i += 4)
            *reinterpret_cast<float4*>(KV + j * HD + dv + i) =
                make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
        }
        __syncthreads();
#pragma unroll 2
        for (int j = 0; j < KT; ++j) {
          float vv[DPT];
          load_smem<DPT>(KV + j * HD + pd, vv);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float p = Ss[(pr + i) * bkv + c0 + j];
#pragma unroll
            for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
          }
        }
      }
      __syncthreads();                       // Ss is rewritten next tile
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float denom = fmaxf(l_s[pr + i], 1e-30f);
      T* orow = ob + (size_t)(q0 + pr + i) * q_step + pd;
#pragma unroll
      for (int d = 0; d < DPT; ++d) store1(orow + d, acc[i][d] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KVH, int bq, int bkv,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(HD, bkv) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / bq, H, B);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KVH, bq, bkv,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KVH, int hd, int bq, int bkv, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH || bq <= 0 ||
      bkv <= 0 || bq % QT || bkv % KT || S % bq || S % bkv)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KVH, bq, bkv, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KVH, bq, bkv, s);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KVH, bq, bkv, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t attrs_of(int hd, cudaFuncAttributes* attr) {
  switch (hd) {
    case 64: return cudaFuncGetAttributes(attr, flash_attention_kernel<T, 64>);
    case 128: return cudaFuncGetAttributes(attr, flash_attention_kernel<T, 128>);
    case 256: return cudaFuncGetAttributes(attr, flash_attention_kernel<T, 256>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KVH, int hd, int bq, int bkv,
                        void* stream) {
  return dispatch<float>(q, k, v, o, B, S, H, KVH, hd, bq, bkv, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KVH, int hd, int bq, int bkv,
                         void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KVH, hd, bq, bkv, stream);
}

// Registers per thread and local (spill) bytes of one instance:
// dtype 0 = fp32, 1 = bf16; hd 64, 128 or 256.
int flash_attention_attrs(int dtype, int hd, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = dtype == 0 ? attrs_of<float>(hd, &attr)
                                     : attrs_of<__nv_bfloat16>(hd, &attr);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
