// Split-KV flash decode (one new token over the KV cache) for Hopper
// (sm_90a): the split pass and the cross-split combine.
//
// Replaces: src/repro/kernels/flash_decode.py, _decode_split_kernel and
// _decode_combine_kernel (Pallas TPU kernels behind flash_decode).
//
// Split: q (B,H,hd), K/V caches (B,S,KV,hd) in fp32 or bf16, and an fp32
// validity bias (B,Sp), 0 or -inf, Sp >= S a multiple of splits*block_kv
// (slots past S are padding; the reference pads K and V too, this kernel
// never reads them). One block per (split, KV head, b) holds that head's
// G = H/KV query rows, so each K/V row is read once for the group, and runs
// an online softmax over its split's tiles of block_kv slots with the
// reference's isfinite guards: an all-masked split leaves m = -inf, l = 0,
// o = 0. Out: unnormalized o (B,KV,splits,G,hd), m and l (B,KV,splits,G),
// fp32.
// Combine: one block per (KV head, b) folds the splits, weights
// exp(m_i - max m) (0 where m_i = -inf), and writes o / max(l, 1e-30) in
// q's dtype, (B,H,hd).
//
// Bound on an H100 SXM at the serving decode (B 4, capacity 1,088, H 8,
// KV 1, hd 256, bf16): the bytes, K and V of the slots that are valid (a
// masked slot is not read) plus q, bias and partials; at 1,024..1,087 valid
// slots about 4.3 MB, 1.3 us at 3.35 TB/s. The operations (4*H*hd per slot,
// 9 MFLOP) take less. Design:
//   * scores: a warp per slot, each lane holding hd/32 dims of all G query
//     rows in registers, reducing the G dot products by shuffles; a slot
//     whose bias is -inf is not read (its score is -inf);
//   * p.v: thread t owns dim t % hd for all G rows (THREADS/hd groups of
//     threads take alternate slots and are summed at the end), reading V
//     rows coalesced; a masked slot is skipped (its p is exactly 0);
//   * shared memory: the G x block_kv score tile plus the end reduction,
//     4*(G*block_kv + 24 + (256/hd)*G*hd) bytes, under 48 KB for every
//     block_kv of the reference's grid at G <= 8 (kernels/ops.py
//     decode_valid mirrors it).
// At B 4 and one KV head the grid is 4 x splits blocks on 132 SMs: the
// card is mostly idle at this shape; recorded, not addressed here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;              // query rows per KV head a block holds

__host__ __device__ inline size_t split_smem_floats(int G, int hd, int bkv) {
  return (size_t)G * bkv + 3 * MAXG + (size_t)(THREADS / hd) * G * hd;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// false for +-inf and NaN, as jnp.isfinite
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

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
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, int S, int Sp, int KVH, int G,
                    int bkv, int steps, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Ss = sm;                  // [G][bkv]: scores, then p
  float* m_s = Ss + G * bkv;       // [MAXG] running max
  float* l_s = m_s + MAXG;         // [MAXG] running sum
  float* c_s = l_s + MAXG;         // [MAXG] this tile's correction
  float* red = c_s + MAXG;         // [THREADS/HD][G][HD] end reduction
  constexpr int DPT = HD / 32;     // dims per lane in the score product
  constexpr int KSPLIT = THREADS / HD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int H = KVH * G;
  const size_t step = (size_t)KVH * HD;     // elements between cache slots
  const T* kb = k + (size_t)b * S * step + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * S * step + (size_t)kvh * HD;
  const float* brow = bias + (size_t)b * Sp;

  float qr[MAXG][DPT];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      qr[g][d] = g < G ? to_f(q[((size_t)b * H + kvh * G + g) * HD + lane * DPT + d])
                       : 0.f;
  if (tid < MAXG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int dim = tid % HD;        // p.v: this thread's output dim
  const int kg = tid / HD;         //      and its slot group
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  const int base = split * steps * bkv;
  for (int t = 0; t < steps; ++t) {
    const int j0 = base + t * bkv;
    __syncthreads();               // last tile's p read; init visible
    for (int j = warp; j < bkv; j += WARPS) {
      const int slot = j0 + j;
      const float bj = brow[slot];
      if (bj == -INFINITY || slot >= S) {    // masked or padding: not read
        for (int g = lane; g < G; g += 32) Ss[g * bkv + j] = -INFINITY;
        continue;
      }
      float kr[DPT];
      const T* krow = kb + (size_t)slot * step + lane * DPT;
#pragma unroll
      for (int d = 0; d < DPT; ++d) kr[d] = to_f(krow[d]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int d = 0; d < DPT; ++d) part = fmaf(qr[g][d], kr[d], part);
          part = warp_sum(part);
          if (lane == 0) Ss[g * bkv + j] = part * scale + bj;
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float* row = Ss + g * bkv;
      float mx = -INFINITY;
      for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = finite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int j = lane; j < bkv; j += 32) {
        const float p = expf(row[j] - m_safe);   // exp(-inf) == 0
        sum += p;
        row[j] = round_to(p, q);                 // p in v's dtype for p.v
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = finite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] *= c_s[g];
    for (int j = kg; j < bkv; j += KSPLIT) {
      const int slot = j0 + j;
      if (slot >= S || brow[slot] == -INFINITY) continue;   // p == 0
      const float vj = to_f(vb[(size_t)slot * step + dim]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] = fmaf(Ss[g * bkv + j], vj, acc[g]);
    }
  }

  const size_t part = ((size_t)b * KVH + kvh) * nsplit + split;
  if (KSPLIT > 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) red[((size_t)kg * G + g) * HD + dim] = acc[g];
    __syncthreads();
    if (kg == 0) {
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
        for (int r = 0; r < KSPLIT; ++r) s += red[((size_t)r * G + g) * HD + dim];
        o_part[(part * G + g) * HD + dim] = s;
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) o_part[(part * G + g) * HD + dim] = acc[g];
  }
  if (tid < G) {
    m_part[part * G + tid] = m_s[tid];
    l_part[part * G + tid] = l_s[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ o_part,
                      const float* __restrict__ m_part,
                      const float* __restrict__ l_part, T* __restrict__ out,
                      int nsplit, int G, int hd) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int KVH = gridDim.x;
  const size_t base = ((size_t)b * KVH + kvh) * nsplit;
  for (int e = threadIdx.x; e < G * hd; e += THREADS) {
    const int g = e / hd;
    const int d = e % hd;
    float m_tot = -INFINITY;
    for (int s = 0; s < nsplit; ++s) m_tot = fmaxf(m_tot, m_part[(base + s) * G + g]);
    const float m_safe = finite(m_tot) ? m_tot : 0.f;
    float l_tot = 0.f, acc = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float m = m_part[(base + s) * G + g];
      const float w = finite(m) ? expf(m - m_safe) : 0.f;
      l_tot += w * l_part[(base + s) * G + g];
      acc += w * o_part[((base + s) * G + g) * hd + d];
    }
    store1(out + (((size_t)b * KVH + kvh) * G + g) * hd + d,
           acc / fmaxf(l_tot, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* bias, void* o, void* m, void* l, int B,
                         int S, int Sp, int KVH, int G, int bkv, int nsplit,
                         cudaStream_t stream) {
  const size_t smem = split_smem_floats(G, HD, bkv) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(decode_split_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nsplit, KVH, B);
  decode_split_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      S, Sp, KVH, G, bkv, Sp / (nsplit * bkv), 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
int split_dispatch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, void* m, void* l, int B, int S,
                   int Sp, int KVH, int G, int hd, int bkv, int nsplit,
                   void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || G <= 0 || G > MAXG || bkv <= 0 ||
      nsplit <= 0 || Sp < S || Sp % (nsplit * bkv))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_split<T, 64>(q, k, v, bias, o, m, l, B, S, Sp, KVH, G, bkv, nsplit, s);
    case 128: return launch_split<T, 128>(q, k, v, bias, o, m, l, B, S, Sp, KVH, G, bkv, nsplit, s);
    case 256: return launch_split<T, 256>(q, k, v, bias, o, m, l, B, S, Sp, KVH, G, bkv, nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int combine_dispatch(const void* o, const void* m, const void* l, void* out,
                     int B, int KVH, int nsplit, int G, int hd, void* stream) {
  if (B <= 0 || KVH <= 0 || nsplit <= 0 || G <= 0 || hd <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid(KVH, B);
  decode_combine_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<T*>(out), nsplit, G, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t split_attrs_of(int hd, cudaFuncAttributes* attr) {
  switch (hd) {
    case 64: return cudaFuncGetAttributes(attr, decode_split_kernel<T, 64>);
    case 128: return cudaFuncGetAttributes(attr, decode_split_kernel<T, 128>);
    case 256: return cudaFuncGetAttributes(attr, decode_split_kernel<T, 256>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int decode_split_f32(const void* q, const void* k, const void* v,
                     const void* bias, void* o, void* m, void* l, int B, int S,
                     int Sp, int KVH, int G, int hd, int bkv, int nsplit,
                     void* stream) {
  return split_dispatch<float>(q, k, v, bias, o, m, l, B, S, Sp, KVH, G, hd,
                               bkv, nsplit, stream);
}

int decode_split_bf16(const void* q, const void* k, const void* v,
                      const void* bias, void* o, void* m, void* l, int B,
                      int S, int Sp, int KVH, int G, int hd, int bkv,
                      int nsplit, void* stream) {
  return split_dispatch<__nv_bfloat16>(q, k, v, bias, o, m, l, B, S, Sp, KVH,
                                       G, hd, bkv, nsplit, stream);
}

int decode_combine_f32(const void* o, const void* m, const void* l, void* out,
                       int B, int KVH, int nsplit, int G, int hd,
                       void* stream) {
  return combine_dispatch<float>(o, m, l, out, B, KVH, nsplit, G, hd, stream);
}

int decode_combine_bf16(const void* o, const void* m, const void* l,
                        void* out, int B, int KVH, int nsplit, int G, int hd,
                        void* stream) {
  return combine_dispatch<__nv_bfloat16>(o, m, l, out, B, KVH, nsplit, G, hd,
                                         stream);
}

// Registers per thread and local (spill) bytes: kernel 0 = split (at hd),
// 1 = combine; dtype 0 = fp32, 1 = bf16.
int decode_attrs(int kernel, int dtype, int hd, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (kernel == 0)
    err = dtype == 0 ? split_attrs_of<float>(hd, &attr)
                     : split_attrs_of<__nv_bfloat16>(hd, &attr);
  else
    err = dtype == 0 ? cudaFuncGetAttributes(&attr, decode_combine_kernel<float>)
                     : cudaFuncGetAttributes(&attr, decode_combine_kernel<__nv_bfloat16>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
