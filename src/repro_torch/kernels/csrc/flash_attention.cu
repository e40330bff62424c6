// Flash attention (prefill) for Hopper (sm_90a), causal or full: bf16 on the
// tensor cores (wgmma), fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel (Pallas TPU
// kernel behind the wrapper flash_attention). Same function: q (B,S,H,hd),
// k/v (B,S,KV,hd) -> o (B,S,H,hd) in q's dtype (fp32 or bf16); scores
// s = (q.k) * scale in fp32, masked above the diagonal with the reference's
// -1e30 sentinel when causal (the reference's causal=False skips the mask
// and every key tile is taken); an online softmax over KV tiles keeps (m, l, acc) on
// chip, p is cast to v's dtype before p.v, and acc / l is written once.
// Head h reads KV head h / (H/KV): for MQA the reference's jnp.repeat of K
// and V into H heads is never made.
//
// Bound on an H100 SXM at the serving prefill (B 4, S 1,024, H 8, hd 256,
// bf16, causal): 4*B*H*hd*S*(S+1)/2 = 17.2 GFLOP (both products, the
// causal half); against the 989 TFLOP/s bf16 tensor-core peak that is
// 17 us, the 25 MB of q, k, v and o take 8 us: bound by operations.
// Full attention at the same shape does 4*B*H*hd*S*S = 34.4 GFLOP: 35 us.
// At head dim 80 (stablelm-3b: B 4, S 1,024, H 32, KV 32, bf16, causal)
// the work is 4*B*H*80*S*(S+1)/2 = 21.5 GFLOP, 22 us; q, k, v and o are
// 4*B*S*H*80*2 = 84 MB, 25 us: bound by bytes. The kernel below does the
// QK^T product at 80 (5 k16 steps) and P V at 128 columns (two 64-column
// panels, the last half zeros): 1.3x the bound's operations, and shared
// memory as at hd 128.
//
// bf16 (the serving dtype): the products on the tensor cores.
//   * A warpgroup (4 warps) owns 64 query rows; a block holds two
//     warpgroups (128 rows) when block_q is a multiple of 128, else one, and
//     takes block_q rows in such sub-tiles. The grid is (B*H, S / block_q).
//     Causal rows differ in work: a block of one sub-tile (or an odd count)
//     takes a contiguous run, the reversed y index scheduling the longest
//     rows first so that the last wave on 132 SMs is the short rows; an
//     even count is taken in pairs from both ends of the sequence, so every
//     block has the same work.
//   * S = Q K^T runs as wgmma m64n64k16 (bf16 in, fp32 accumulators), Q and
//     K both read from shared memory (K-major); the 64 x 64 score tile stays
//     in registers, the online softmax runs on the accumulator fragments
//     (row max and sum over the 4 lanes of a row by two shuffles; exp2 of
//     log2e-scaled scores), and p, rounded to bf16, is repacked from the
//     accumulator layout into the A-operand registers of O += P V, a wgmma
//     m64n64k16 per 64 output dims with V read from shared memory
//     (MN-major, transposed by the instruction). The O accumulator is hd/2
//     fp32 registers per thread (128 at hd 256), which bounds one softmax
//     update to 64 keys: a larger block_kv is taken as successive 64-key
//     updates, the same online softmax.
//   * Q, K and V tiles are staged in bf16 by cp.async into 128-byte-swizzled
//     panels (64 rows x 64 columns, the layout the wgmma descriptors name),
//     K and V through a ring of max(2, min(8, block_kv/64)) stages of 64
//     keys: the next tiles load while this one is multiplied. No TMA: a
//     tensor map needs cuTensorMapEncodeTiled, which the library (linked
//     against the CUDA runtime alone) does not reach; cp.async needs none.
//   * Shared memory: 1 KB of alignment slack, the Q sub-tile (64 or 128
//     rows x hdp bf16) and the ring (stages x 2 x 64 x hdp bf16), hdp the
//     head dim rounded up to whole 64-column panels; at hd 256 with 128
//     rows and 2 stages that is 193 KB, and block_kv 256 (4 stages) does
//     not fit. kernels/flash_attention.py flash_smem_bytes mirrors the sum.
//   * A head dim that is not a whole number of panels (hd 80: 10 16-byte
//     chunks a row, 160 bytes) is staged as hdp = 128: chunks 8 and 9 land
//     in the second panel at their swizzled places, so every cp.async
//     vector and every descriptor address stays 16-byte aligned within its
//     128-byte panel row, and the 1024-byte panels keep the swizzle's
//     alignment. QK^T stops at hd (5 k16 steps: the last reads the second
//     panel's first 32 bytes of each row, which are chunks 8 and 9), so the
//     padded Q and K columns are never read. P V runs N = 64 on both V
//     panels; the V columns 80..127 of every ring stage are zeroed once at
//     the start of the kernel (cp.async never writes them), so the padded
//     output columns sum zeros, and they are never written back.
//   * A warpgroup skips the tiles wholly above its own diagonal; tiles
//     astride it are masked per element.
//   * Full (non-causal) attention is the same kernel instanced with
//     CAUSAL = false: no mask, every key tile for every row, so all rows
//     have the same work and a block takes a contiguous run of sub-tiles
//     (no pairing from both ends).
// fp32: the CUDA-core kernel of the first port (TF32 on the tensor cores
// would break the 2e-4 fp32 limit, and fp32 is not on the serve path):
// 64-row q sub-tiles and 64-key K/V chunks staged in fp32 shared memory, a
// 64 x block_kv fp32 score tile, 4x4 register tiles for the scores, 8 rows x
// ceil(hd/32) dims of accumulators per lane for p.v (at hd 80, 3 dims: lanes
// 0..26 cover the 80, the dims past hd are neither read nor written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;     // the reference's mask sentinel

// -- fp32: the CUDA-core kernel ------------------------------------------------

namespace cc {

constexpr int THREADS = 256;
constexpr int QT = 64;                // query rows per sub-tile
constexpr int KT = 64;                // keys per staged chunk

__host__ __device__ inline size_t smem_floats(int hd, int bkv) {
  return (size_t)hd * QT + (size_t)KT * hd + (size_t)QT * bkv + 3 * QT;
}

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
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

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_cc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int S,
                int H, int KVH, int bq, int bkv, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                  // [HD][QT]: the q sub-tile, transposed
  float* KV = Qt + HD * QT;        // K chunk [HD][KT], or V chunk [KT][HD]
  float* Ss = KV + KT * HD;        // [QT][bkv]: scores, then p
  float* m_s = Ss + QT * bkv;      // [QT] running max
  float* l_s = m_s + QT;           // [QT] running sum
  float* c_s = l_s + QT;           // [QT] this tile's correction
  constexpr int VEC = 4;
  constexpr int DPT = (HD + 31) / 32;   // output dims per lane
  constexpr bool FULL = HD % 32 == 0;   // every lane's dims lie below HD

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const size_t q_step = (size_t)H * HD;     // elements between positions
  const size_t kv_step = (size_t)KVH * HD;
  const float* qb = q + (size_t)b * S * q_step + (size_t)h * HD;
  const float* kb = k + (size_t)b * S * kv_step + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * S * kv_step + (size_t)kvh * HD;
  float* ob = o + (size_t)b * S * q_step + (size_t)h * HD;

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

    // the last key a row of this sub-tile sees
    const int q_last = CAUSAL ? q0 + QT - 1 : S - 1;
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
            const bool masked = CAUSAL && kc + sc + j > q0 + sr + i;
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
          row[j] = p;
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
          *reinterpret_cast<float4*>(KV + j * HD + dv) =
              *reinterpret_cast<const float4*>(vb + (size_t)(kc + j) * kv_step + dv);
        }
        __syncthreads();
#pragma unroll 2
        for (int j = 0; j < KT; ++j) {
          float vv[DPT];
          if constexpr (FULL) {
            load_smem<DPT>(KV + j * HD + pd, vv);
          } else {
#pragma unroll
            for (int d = 0; d < DPT; ++d)
              vv[d] = pd + d < HD ? KV[j * HD + pd + d] : 0.f;
          }
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
      float* orow = ob + (size_t)(q0 + pr + i) * q_step + pd;
#pragma unroll
      for (int d = 0; d < DPT; ++d)
        if (FULL || pd + d < HD) orow[d] = acc[i][d] / denom;
    }
  }
}

template <int HD, bool CAUSAL>
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
  err = cudaFuncSetAttribute(flash_cc_kernel<HD, CAUSAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / bq, H, B);
  flash_cc_kernel<HD, CAUSAL><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KVH, bq,
      bkv, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace cc

// -- bf16: the tensor-core kernel ------------------------------------------------

namespace tc {

constexpr int WG = 128;               // threads per warpgroup
constexpr int TQ = 64;                // query rows per warpgroup
constexpr int TK = 64;                // keys per tile: one softmax update
constexpr int PANEL = 64 * 128;       // bytes of a swizzled 64 x 64 bf16 panel
constexpr int MAX_STAGES = 8;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int stages_for(int bkv) {
  const int s = bkv / TK;
  return s < 2 ? 2 : (s > MAX_STAGES ? MAX_STAGES : s);
}

// the head dim as staged: whole 64-column panels
__host__ __device__ constexpr int padded_hd(int hd) { return (hd + 63) / 64 * 64; }

__host__ __device__ inline size_t smem_bytes(int hd, int nwg, int bkv) {
  const int hdp = padded_hd(hd);
  return 1024 + (size_t)nwg * TQ * hdp * 2 +
         (size_t)stages_for(bkv) * 2 * TK * hdp * 2;
}

// Byte offset of 16-byte chunk c (8 bf16 columns) of row r (< 64) in a run
// of 64-row panels: panel c / 8, 128 bytes a row, the chunk index XORed
// with r % 8 (the 128-byte swizzle the descriptors name).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * PANEL + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (the count is an immediate in PTX).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes of a wgmma
// operand across the fence / wait around it.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void reg_fence(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D(64x64 fp32) += A(64x16, shared, K-major) * B(16x64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x64 fp32) += A(64x16 bf16, registers) * B(16x64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int NWG, bool CAUSAL>
__global__ void __launch_bounds__(NWG * WG, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int S, int H, int KVH, int bq,
                int stages, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smraw[];
  constexpr int THREADS = NWG * WG;
  constexpr int QT = NWG * TQ;           // query rows per sub-tile
  constexpr int CH = HD / 8;             // 16-byte chunks per row loaded
  constexpr int HDP = padded_hd(HD);     // columns staged: whole panels
  constexpr int NP = HDP / 64;           // 64-dim panels of the output
  constexpr int Q_WG_BYTES = TQ * HDP * 2;
  constexpr int TILE_BYTES = TK * HDP * 2;
  const uint32_t base = (smem_u32(smraw) + 1023u) & ~1023u;
  const uint32_t Qs = base;                          // [NWG][NP panels]
  const uint32_t KVs = base + NWG * Q_WG_BYTES;      // [stages][K, V]

  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int warp = (tid % WG) / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kvh = h / (H / KVH);
  const size_t q_step = (size_t)H * HD;              // elements between positions
  const size_t kv_step = (size_t)KVH * HD;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_step + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_step + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_step + (size_t)kvh * HD;
  __nv_bfloat16* ob = o + (size_t)b * S * q_step + (size_t)h * HD;

  auto load_kv = [&](int tile, int st) {
    const uint32_t ks = KVs + st * 2 * TILE_BYTES;
    const uint32_t vs = ks + TILE_BYTES;
    for (int e = tid; e < TK * CH; e += THREADS) {
      const int j = e / CH, c = e % CH;
      const size_t g = (size_t)(tile * TK + j) * kv_step + c * 8;
      cp_async16(ks + swz(j, c), kb + g);
      cp_async16(vs + swz(j, c), vb + g);
    }
  };

  if constexpr (HDP != HD) {
    // V's columns HD..HDP-1 in the last panel of every ring stage: zeros,
    // written once (cp.async fills only the chunks below HD); the first
    // tile's proxy fence orders them before any wgmma reads them
    constexpr int C0 = CH % 8;           // first padded chunk of the panel
    for (int e = tid; e < stages * TK * (8 - C0); e += THREADS) {
      const int st = e / (TK * (8 - C0));
      const int j = (e / (8 - C0)) % TK, c = C0 + e % (8 - C0);
      const uint32_t vs = KVs + st * 2 * TILE_BYTES + TILE_BYTES;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                       vs + swz(j, (NP - 1) * 8 + c)),
                   "r"(0)
                   : "memory");
    }
  }

  // The block's bq / QT sub-tiles. Causal: an even count is taken in pairs
  // from both ends of the sequence (sub-tiles p and NT-1-p), so that every
  // block has the same causal work; an odd count is a contiguous run, the
  // blocks with the longest rows scheduled first (reversed y index). Full
  // attention gives every row the same work: a contiguous run.
  const int ns = bq / QT, nt_all = S / QT;
  for (int i = 0; i < ns; ++i) {
    int st;
    if (!CAUSAL) {
      st = blockIdx.y * ns + i;
    } else if (ns % 2 == 0) {
      const int pair = blockIdx.y * (ns / 2) + i / 2;
      st = i % 2 == 0 ? nt_all - 1 - pair : pair;
    } else {
      st = (gridDim.y - 1 - blockIdx.y) * ns + i;
    }
    const int q0 = st * QT;
    // key tiles up to the diagonal, or all of them
    const int ntiles = CAUSAL ? (q0 + QT) / TK : S / TK;
    __syncthreads();                     // the last sub-tile's reads are done
    for (int e = tid; e < QT * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      cp_async16(Qs + (r / TQ) * Q_WG_BYTES + swz(r % TQ, c),
                 qb + (size_t)(q0 + r) * q_step + c * 8);
    }
    cp_async_commit();
    for (int s = 0; s < stages - 1; ++s) {
      if (s < ntiles) load_kv(s, s);
      cp_async_commit();
    }

    float acc[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    const int wq0 = q0 + wg * TQ;                    // this warpgroup's rows
    const int r0 = wq0 + warp * 16 + lane / 4;       // fragment rows r0, r0+8
    const uint32_t qw = Qs + wg * Q_WG_BYTES;

    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait(stages - 2);         // tile t has landed (this thread's part)
      fence_proxy_async();
      __syncthreads();                   // ... everyone's; tile t-1's stage is free
      {
        const int nt = t + stages - 1;
        if (nt < ntiles) load_kv(nt, nt % stages);
        cp_async_commit();
      }
      const int kc = t * TK;
      if (CAUSAL && kc > wq0 + TQ - 1) continue;  // wholly above this warpgroup's diagonal
      const uint32_t ks = KVs + (t % stages) * 2 * TILE_BYTES;
      const uint32_t vs = ks + TILE_BYTES;

      // S = Q K^T
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(s, make_desc(qw + (kk >> 2) * PANEL + (kk & 3) * 32, 16, 1024),
                 make_desc(ks + (kk >> 2) * PANEL + (kk & 3) * 32, 16, 1024),
                 kk > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);

      // scale (log2 domain), mask, row max over the 4 lanes of each row
      const bool diag = CAUSAL && kc + TK - 1 > wq0;
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kc + 8 * i + 2 * (lane & 3) + e;
          float a = s[4 * i + e] * scale_log2;
          float c = s[4 * i + 2 + e] * scale_log2;
          if (diag && col > r0) a = NEG_INF;
          if (diag && col > r0 + 8) c = NEG_INF;
          s[4 * i + e] = a;
          s[4 * i + 2 + e] = c;
          mx0 = fmaxf(mx0, a);
          mx1 = fmaxf(mx1, c);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // p, its row sums (this thread's share; the 4 lanes are summed at the
      // end), and p in bf16 as the A operand of P V: k-step kk takes the
      // accumulator's column chunks 2kk and 2kk+1
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 2 * kk + hh;
          const float p00 = ex2(s[4 * i] - mn0), p01 = ex2(s[4 * i + 1] - mn0);
          const float p10 = ex2(s[4 * i + 2] - mn1), p11 = ex2(s[4 * i + 3] - mn1);
          sum0 += p00 + p01;
          sum1 += p10 + p11;
          pa[kk][2 * hh] = pack_bf16(p00, p01);
          pa[kk][2 * hh + 1] = pack_bf16(p10, p11);
        }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[p][4 * i] *= c0;
          acc[p][4 * i + 1] *= c0;
          acc[p][4 * i + 2] *= c1;
          acc[p][4 * i + 3] *= c1;
        }

      // O += P V
#pragma unroll
      for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) reg_fence(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_rs(acc[p], pa[kk],
                   make_desc(vs + p * PANEL + kk * 2048, PANEL, 1024));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* o0 = ob + (size_t)r0 * q_step;
    __nv_bfloat16* o1 = ob + (size_t)(r0 + 8) * q_step;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = p * 64 + 8 * i + 2 * (lane & 3);
        if (HDP != HD && col >= HD) continue;   // a padded column
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
            __floats2bfloat162_rn(acc[p][4 * i] / d0, acc[p][4 * i + 1] / d0);
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
            __floats2bfloat162_rn(acc[p][4 * i + 2] / d1, acc[p][4 * i + 3] / d1);
      }
  }
}

template <int HD, int NWG, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KVH, int bq, int bkv,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, NWG, bkv);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(flash_tc_kernel<HD, NWG, CAUSAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, S / bq);
  flash_tc_kernel<HD, NWG, CAUSAL><<<grid, NWG * WG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, KVH, bq, stages_for(bkv), LOG2E / sqrtf((float)HD));
  return cudaGetLastError();
}

template <int HD, bool CAUSAL>
cudaError_t launch_nwg(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KVH, int bq, int bkv,
                       cudaStream_t stream) {
  return bq % (2 * TQ) == 0
             ? launch<HD, 2, CAUSAL>(q, k, v, o, B, S, H, KVH, bq, bkv, stream)
             : launch<HD, 1, CAUSAL>(q, k, v, o, B, S, H, KVH, bq, bkv, stream);
}

}  // namespace tc

bool bad_args(int B, int S, int H, int KVH, int bq, int bkv) {
  return B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH || bq <= 0 ||
         bkv <= 0 || bq % 64 || bkv % 64 || S % bq || S % bkv;
}

template <int HD, bool CAUSAL>
cudaError_t attrs_of(int dtype, int nwg, cudaFuncAttributes* attr) {
  if (dtype == 0)
    return cudaFuncGetAttributes(attr, cc::flash_cc_kernel<HD, CAUSAL>);
  return nwg == 2
             ? cudaFuncGetAttributes(attr, tc::flash_tc_kernel<HD, 2, CAUSAL>)
             : cudaFuncGetAttributes(attr, tc::flash_tc_kernel<HD, 1, CAUSAL>);
}

// One launcher per head dim and mask: hd 64, 80, 128 or 256; causal or full.
template <int HD>
cudaError_t cc_launch(bool causal, const void* q, const void* k,
                      const void* v, void* o, int B, int S, int H, int KVH,
                      int bq, int bkv, cudaStream_t s) {
  return causal ? cc::launch<HD, true>(q, k, v, o, B, S, H, KVH, bq, bkv, s)
                : cc::launch<HD, false>(q, k, v, o, B, S, H, KVH, bq, bkv, s);
}

template <int HD>
cudaError_t tc_launch(bool causal, const void* q, const void* k,
                      const void* v, void* o, int B, int S, int H, int KVH,
                      int bq, int bkv, cudaStream_t s) {
  return causal
             ? tc::launch_nwg<HD, true>(q, k, v, o, B, S, H, KVH, bq, bkv, s)
             : tc::launch_nwg<HD, false>(q, k, v, o, B, S, H, KVH, bq, bkv, s);
}

}  // namespace

extern "C" {

// causal: 1 masks keys above the diagonal, 0 is full attention.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KVH, int hd, int bq, int bkv,
                        int causal, void* stream) {
  if (bad_args(B, S, H, KVH, bq, bkv)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  switch (hd) {
    case 64: return cc_launch<64>(c, q, k, v, o, B, S, H, KVH, bq, bkv, s);
    case 80: return cc_launch<80>(c, q, k, v, o, B, S, H, KVH, bq, bkv, s);
    case 128: return cc_launch<128>(c, q, k, v, o, B, S, H, KVH, bq, bkv, s);
    case 256: return cc_launch<256>(c, q, k, v, o, B, S, H, KVH, bq, bkv, s);
    default: return cudaErrorInvalidValue;
  }
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KVH, int hd, int bq, int bkv,
                         int causal, void* stream) {
  if (bad_args(B, S, H, KVH, bq, bkv)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  switch (hd) {
    case 64: return tc_launch<64>(c, q, k, v, o, B, S, H, KVH, bq, bkv, s);
    case 80: return tc_launch<80>(c, q, k, v, o, B, S, H, KVH, bq, bkv, s);
    case 128: return tc_launch<128>(c, q, k, v, o, B, S, H, KVH, bq, bkv, s);
    case 256: return tc_launch<256>(c, q, k, v, o, B, S, H, KVH, bq, bkv, s);
    default: return cudaErrorInvalidValue;
  }
}

// Registers per thread and local (spill) bytes of one instance: dtype 0 =
// fp32 (the CUDA-core kernel), 1 = bf16 (the tensor-core kernel with nwg =
// 1 or 2 warpgroups); hd 64, 80, 128 or 256; causal 1 or 0 (full).
int flash_attention_attrs(int dtype, int hd, int nwg, int causal, int* regs,
                          int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  const bool c = causal != 0;
  switch (hd) {
    case 64:
      err = c ? attrs_of<64, true>(dtype, nwg, &attr)
              : attrs_of<64, false>(dtype, nwg, &attr);
      break;
    case 80:
      err = c ? attrs_of<80, true>(dtype, nwg, &attr)
              : attrs_of<80, false>(dtype, nwg, &attr);
      break;
    case 128:
      err = c ? attrs_of<128, true>(dtype, nwg, &attr)
              : attrs_of<128, false>(dtype, nwg, &attr);
      break;
    case 256:
      err = c ? attrs_of<256, true>(dtype, nwg, &attr)
              : attrs_of<256, false>(dtype, nwg, &attr);
      break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
