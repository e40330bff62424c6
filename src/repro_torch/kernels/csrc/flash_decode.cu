// Split-KV flash decode (one new token over the KV cache) for Hopper
// (sm_90a): the split pass with the cross-split combine fused into its
// last block, so one launch does a layer's decode attention.
//
// Replaces: src/repro/kernels/flash_decode.py, _decode_split_kernel and
// _decode_combine_kernel (Pallas TPU kernels behind flash_decode).
//
// In: q (B,H,hd), K/V caches (B,S,KV,hd) in fp32 or bf16, and an fp32
// validity bias (B,Sp), 0 or -inf, Sp >= S a multiple of splits*block_kv
// (slots past S are padding; the reference pads K and V too, this kernel
// never reads them). Split i covers slots [i*L, (i+1)*L), L = Sp/splits.
// Two modes, one kernel template:
//   * fused (`out` given): the reference's flash_decode(combine="kernel")
//     whole. Out: o / max(l, 1e-30) in q's dtype, (B,H,hd); a head group
//     with no valid slot gives exact zeros (the reference's 0 / 1e-30).
//   * partials (`out` null): per split, the reference's unnormalized
//     partials with its isfinite guards: an all-masked split gives m = -inf,
//     l = 0, o = 0. Out: o (B,KV,splits,G,hd), m and l (B,KV,splits,G),
//     fp32 (the tensor-op combine and decode_split take these).
//
// Bound on an H100 SXM at the serving decode (B 4, capacity 1,088, H 8,
// KV 1, hd 256, bf16): the bytes, K and V of the slots that are valid (a
// masked slot is not read) plus q, bias and the output; at 1,024..1,087
// valid slots about 4.3 MB, 1.3 us at 3.35 TB/s. The operations (4*H*hd
// per slot, 9 MFLOP) take less: at about 8 flop a byte the CUDA cores keep
// up, so the design is about blocks on SMs and bytes in flight. The
// combine's own work, reading the splits' partials (33 KB at one split)
// and writing the output, is 0.015 us of bytes; as a launch of its own it
// cost what any launch costs, so it is folded into a launch that already
// folds.
//   * The grid fills the card: each split's slots below S are cut into C
//     chunks of `chunk` slots (a multiple of the 64-slot tile), one block
//     each, grid (C, splits, B*KV). The wrapper's plan
//     (kernels/flash_decode.py decode_plan) picks C so that B*KV*splits*C
//     reaches 132 blocks where the split has the tiles. A live chunk's
//     block writes its (o, m, l) to a scratch, fences, and counts itself in
//     an arrival counter; the last to arrive folds the partials (max m,
//     weights exp(m_i - max m), 0 where m_i = -inf, then the weighted sums
//     of l and o) and resets the counter for the next launch. Partials
//     mode counts per split and folds its chunks into the split's
//     partials. Fused mode counts per (b, KV head) group and folds every
//     live chunk of every split in one pass: the reference's two levels,
//     chunks to splits and splits to the group, as one, only the fp32 sums
//     in another order; then it normalizes and writes out. Counters of the
//     two modes are separate buffers (the wrapper's), so launches of both
//     on one stream never share one. A fold of one block (one live chunk
//     of a split; of a group, fused) writes directly, with no scratch or
//     counter. Splits of padding only write m = -inf, l = 0, o = 0 from one
//     block in partials mode and nothing in fused mode; chunks past S exit
//     at once.
//   * K and V tiles of 64 slots are staged by cp.async in 16-byte vectors,
//     16-byte chunks XOR-swizzled by slot % 8, through a ring of two stages
//     (one where two do not fit: fp32 at hd 256); a masked slot is neither
//     loaded nor read, and a thread reads the bias of all its slots before
//     it issues any copy.
//   * 256 threads. Scores: a thread owns one slot of the tile and RPT of
//     the query rows, over the whole head dim: its dot products need no
//     shuffle, K is read once from shared memory, q (fp32 in shared
//     memory) is a broadcast. A block holds all G rows of its KV head: the
//     kernel is instanced for G <= 8 (2 rows a thread, a 64 x 8 score tile)
//     and for 8 < G <= 16 (4 rows a thread, a 64 x 16 tile), so a head
//     group's K and V are read once whatever G is; splitting G over two
//     blocks instead would read them twice, and the decode is bound by
//     those bytes. The 8-row instance stays for G <= 8: there the 16-row
//     one (245 registers a thread against about 156) takes 1.2-1.4x its
//     time on an H100 SXM (scripts/decode_rows_instance.py). The online
//     softmax reduces each query row once per tile
//     (a warp per row). p.v: a thread owns 2 dims of all G rows, reading V
//     from the staged tile and p as 16-byte loads; SG = 256 / (hd/2) slot
//     groups (hd 80: 6, the 16 threads left over idle in p.v) are summed
//     at the end.
//   * At mistral-large's decode (B 4, capacity 1,088 at 1,054 valid slots,
//     KV 8, G 12, hd 128, bf16) the bytes are K and V of the valid slots,
//     2 x 4 x 1,054 x 8 x 128 x 2 = 17.3 MB, with q, bias and the output:
//     5.2 us at 3.35 TB/s. The kernel reads each slot's K and V once per
//     head group (the G 12 rows share the block), so it moves the bound's
//     bytes; its scratch adds (o, m, l) of each chunk in fp32.
//   * Staged rows are padded to whole 128-byte groups of 8 chunks, so the
//     XOR swizzle by slot % 8 stays inside a row: hd 80 in bf16 is 10
//     chunks (160 bytes) staged in 256, in fp32 20 chunks staged in 384.
//   * The fold reads each (chunk, row)'s m and l once into shared memory,
//     computes the weights there, and each thread sums its 2 dims of its
//     rows over the chunks with the loads unrolled.
//   * Shared memory: the ring, q, the 64 x GM score tile (GM = 8 or 16),
//     the slot groups' end reduction and the per-row (m, l, corr): at most
//     181 KB (hd 256, G 16; 158 KB at G <= 8); kernels/flash_decode.py
//     decode_smem_bytes mirrors it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 16;             // query rows per KV head the kernel takes
constexpr int TILE = 64;             // slots per staged tile
constexpr int RG = THREADS / TILE;   // row groups of the score pass

// rows of the instance that holds G query rows: 8 or 16
__host__ __device__ inline int group_rows(int G) { return G <= 8 ? 8 : 16; }

// bytes of a staged K or V row: whole 128-byte groups of 16-byte chunks
__host__ __device__ constexpr int row_bytes(int hd, int esize) {
  return (hd * esize / 16 + 7) / 8 * 8 * 16;
}

__host__ __device__ inline int split_stages(int hd, int esize) {
  return 4 * TILE * row_bytes(hd, esize) <= 131072 ? 2 : 1;
}

// floats of the slot groups' end reduction, which the fold reuses for the
// chunks' l (TILE x GM)
__host__ __device__ inline size_t red_floats(int hd, int G) {
  const size_t sums = (size_t)(THREADS / (hd / 2)) * G * hd;
  const size_t lc = (size_t)TILE * group_rows(G);
  return sums > lc ? sums : lc;
}

__host__ __device__ inline size_t split_smem_bytes(int hd, int esize, int G) {
  const int gm = group_rows(G);
  const size_t ring =
      (size_t)split_stages(hd, esize) * 2 * TILE * row_bytes(hd, esize);
  const size_t floats =
      (size_t)G * hd + gm * TILE + 3 * gm + red_floats(hd, G);
  return ring + 4 * floats + 4 * (TILE + 4);
}

// live chunks of split s: its slots below S, [s*L, min(s*L + L, S)), cut
// into chunks of `chunk` slots
__host__ __device__ inline int live_chunks(int s, int S, int L, int chunk) {
  const int lo = s * L, end = min(lo + L, S);
  return end > lo ? (end - lo + chunk - 1) / chunk : 0;
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

// two outputs of a row, normalized by its l as the reference's combine
template <typename T>
__device__ __forceinline__ void store_normalized(T* p, float a, float b,
                                                 float l) {
  const float d = fmaxf(l, 1e-30f);
  store1(p, a / d);
  store1(p + 1, b / d);
}

// 16 bytes of K or V from shared memory, as fp32
__device__ __forceinline__ void unpack16(const unsigned char* p, float* out,
                                         const float*) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
}

__device__ __forceinline__ void unpack16(const unsigned char* p, float* out,
                                         const __nv_bfloat16*) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// two consecutive elements of V from shared memory, as fp32
__device__ __forceinline__ float2 load2(const unsigned char* p, const float*) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const unsigned char* p,
                                        const __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending > 0)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int HD, int GM, bool FUSED>
__global__ void __launch_bounds__(THREADS, 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, T* __restrict__ out,
                    float* o_scr, float* m_scr, float* l_scr, int* counters,
                    int S, int Sp, int KVH, int G, int chunk, int stages,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smraw[];
  constexpr int ES = sizeof(T);
  constexpr int EPC = 16 / ES;          // elements per 16-byte chunk
  constexpr int CH = HD / EPC;          // 16-byte chunks per row
  constexpr int ROW = row_bytes(HD, ES);  // bytes per staged row (padded)
  constexpr int TILE_BYTES = TILE * ROW;
  constexpr int NDT = HD / 2;           // p.v: threads over one slot's dims
  constexpr int SG = THREADS / NDT;     //      slot groups (2 to 8)
  constexpr int RPT = GM / RG;          // query rows a thread scores
  unsigned char* ring = smraw;                            // [stages][K, V]
  float* qs = reinterpret_cast<float*>(ring + stages * 2 * TILE_BYTES);
  float* Ss = qs + G * HD;              // [TILE][GM]: scores, then p
  float* m_s = Ss + GM * TILE;          // [GM] running max
  float* l_s = m_s + GM;                // [GM] running sum
  float* c_s = l_s + GM;                // [GM] this tile's correction
  float* red = c_s + GM;                // [SG][G][HD] slot groups' sums
  int* vld = reinterpret_cast<int*>(red + red_floats(HD, G));   // [TILE]
  int* last = vld + TILE;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.x;             // chunk
  const int split = blockIdx.y;
  const int bk = blockIdx.z;            // b * KVH + kv head
  const int C = gridDim.x;
  const int nsplit = gridDim.y;
  const int b = bk / KVH;
  const int kvh = bk % KVH;
  const int H = KVH * G;
  const int L = Sp / nsplit;
  const int s_lo = split * L;
  const int s_end = min(s_lo + L, S);   // the split's slots below S
  const int n_live = live_chunks(split, S, L, chunk);
  const size_t part = (size_t)bk * nsplit + split;

  if (n_live == 0) {                    // padding only: the empty result
    if (!FUSED && c == 0) {
      for (int e = tid; e < G * HD; e += THREADS) o_part[part * G * HD + e] = 0.f;
      if (tid < G) {
        m_part[part * G + tid] = -INFINITY;
        l_part[part * G + tid] = 0.f;
      }
    }
    return;
  }
  if (c >= n_live) return;              // a chunk past S
  const int lo = s_lo + c * chunk;
  const int hi = min(lo + chunk, s_end);
  const int ntiles = (hi - lo + TILE - 1) / TILE;

  const size_t step = (size_t)KVH * HD;     // elements between cache slots
  const T* kb = k + (size_t)b * S * step + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * S * step + (size_t)kvh * HD;
  const float* brow = bias + (size_t)b * Sp;

  // the bias of a thread's slots is read first, all at once: a read
  // between two copies would wait for its own round trip each time
  // 16-byte chunks a thread copies (the last round partly, at hd 80)
  constexpr int PER = (TILE * CH + THREADS - 1) / THREADS;
  auto load = [&](int t, int st) {
    unsigned char* ks = ring + st * 2 * TILE_BYTES;
    unsigned char* vs = ks + TILE_BYTES;
    const int t0 = lo + t * TILE;
    uint32_t live = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int slot = t0 + e / CH;
      live |= (uint32_t)(e < TILE * CH && slot < hi &&
                         __ldg(brow + slot) != -INFINITY) << i;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int j = e / CH, cc = e % CH;
      if (live >> i & 1u) {              // a masked slot is never read
        const int off = j * ROW + ((cc ^ (j & 7)) << 4);
        cp_async16(ks + off, kb + (size_t)(t0 + j) * step + cc * EPC);
        cp_async16(vs + off, vb + (size_t)(t0 + j) * step + cc * EPC);
      }
    }
  };

  load(0, 0);
  cp_async_commit();
  for (int e = tid; e < G * HD; e += THREADS)
    qs[e] = to_f(q[((size_t)b * H + (size_t)kvh * G) * HD + e]);
  if (tid < GM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int ja = tid % TILE;            // scores: this thread's slot
  const int ga = (tid / TILE) * RPT;    //         and its first query row
  const int dp = (tid % NDT) * 2;       // p.v: dims dp, dp+1
  const int sg = tid / NDT;             //      and the slot group
  const bool pv = sg < SG;              // false: idle in p.v (hd 80)
  float acc[GM][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (stages > 1 && t + 1 < ntiles) load(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait(stages > 1 ? 1 : 0);  // tile t has landed (this thread's part)
    __syncthreads();                    // ... everyone's; q and init visible
    const unsigned char* ks = ring + (stages > 1 ? (t & 1) : 0) * 2 * TILE_BYTES;
    const unsigned char* vs = ks + TILE_BYTES;

    {
      const int slot = lo + t * TILE + ja;
      const bool ok = slot < hi && brow[slot] != -INFINITY;
      float sc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) sc[r] = 0.f;
      if (ok) {
        const unsigned char* krow = ks + ja * ROW;
#pragma unroll 4
        for (int cc = 0; cc < CH; ++cc) {
          float kf[EPC];
          unpack16(krow + ((cc ^ (ja & 7)) << 4), kf, k);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            if (ga + r < G) {
              const float* qq = qs + (ga + r) * HD + cc * EPC;
#pragma unroll
              for (int e = 0; e < EPC; e += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qq + e);
                sc[r] = fmaf(q4.x, kf[e], sc[r]);
                sc[r] = fmaf(q4.y, kf[e + 1], sc[r]);
                sc[r] = fmaf(q4.z, kf[e + 2], sc[r]);
                sc[r] = fmaf(q4.w, kf[e + 3], sc[r]);
              }
            }
          }
        }
      }
      const float bj = ok ? brow[slot] : 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) sc[r] = ok ? sc[r] * scale + bj : -INFINITY;
      if constexpr (RPT == 2)
        *reinterpret_cast<float2*>(Ss + ja * GM + ga) = make_float2(sc[0], sc[1]);
      else
        *reinterpret_cast<float4*>(Ss + ja * GM + ga) =
            make_float4(sc[0], sc[1], sc[2], sc[3]);
      if (ga == 0) vld[ja] = ok;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float* ra = Ss + lane * GM + g;
      float* rz = Ss + (lane + 32) * GM + g;
      const float a = *ra, z = *rz;
      const float mx = warp_max(fmaxf(a, z));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = finite(m_new) ? m_new : 0.f;
      const float pa = expf(a - m_safe), pz = expf(z - m_safe);  // exp(-inf) == 0
      const float sum = warp_sum(pa + pz);
      *ra = round_to(pa, q);                       // p in v's dtype for p.v
      *rz = round_to(pz, q);
      if (lane == 0) {
        const float corr = finite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        acc[g][0] *= c_s[g];
        acc[g][1] *= c_s[g];
      }
    const int boff = dp * ES;           // byte of dim dp in a row
    for (int j = sg; pv && j < TILE; j += SG) {
      if (!vld[j]) continue;            // p == 0, V not loaded
      const float2 vv = load2(vs + j * ROW + ((((boff >> 4) ^ (j & 7))) << 4) +
                                  (boff & 15), v);
      float p[GM];
#pragma unroll
      for (int u = 0; u < GM / 4; ++u) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ss + j * GM + 4 * u);
        p[4 * u] = p4.x; p[4 * u + 1] = p4.y; p[4 * u + 2] = p4.z; p[4 * u + 3] = p4.w;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) {
          acc[g][0] = fmaf(p[g], vv.x, acc[g][0]);
          acc[g][1] = fmaf(p[g], vv.y, acc[g][1]);
        }
    }
    __syncthreads();                    // the stage and Ss are free
    if (stages == 1 && t + 1 < ntiles) load(t + 1, 0);
  }

  if (SG > 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (pv && g < G) {
        red[(sg * G + g) * HD + dp] = acc[g][0];
        red[(sg * G + g) * HD + dp + 1] = acc[g][1];
      }
    __syncthreads();
    if (sg == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G)
          for (int r = 1; r < SG; ++r) {
            acc[g][0] += red[(r * G + g) * HD + dp];
            acc[g][1] += red[(r * G + g) * HD + dp + 1];
          }
    }
  }

  // The partials the last block folds lie in the scratch from c0 on, n_fold
  // of them: the split's live chunks (partials mode), or every live chunk
  // of the head group, split by split (fused); this block's is at c0 + rank.
  int n_fold = n_live, rank = c;
  size_t c0 = part * C;
  if (FUSED) {
    n_fold = rank = 0;
    for (int s = 0; s < nsplit; ++s) {
      const int n = live_chunks(s, S, L, chunk);
      rank += s < split ? n : 0;
      n_fold += n;
    }
    rank += c;
    c0 = (size_t)bk * nsplit * C;
  }
  // fused: the group's rows of the output
  T* ob = FUSED ? out + ((size_t)b * H + (size_t)kvh * G) * HD : nullptr;
  const bool direct = n_fold == 1;
  if (FUSED && direct) {                // the one live block: normalize
    if (sg == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G)
          store_normalized(ob + g * HD + dp, acc[g][0], acc[g][1], l_s[g]);
    }
    return;
  }
  const size_t cpart = direct ? part : c0 + rank;
  float* od = (direct ? o_part : o_scr) + cpart * G * HD;
  float* md = (direct ? m_part : m_scr) + cpart * G;
  float* ld = (direct ? l_part : l_scr) + cpart * G;
  if (sg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
        *reinterpret_cast<float2*>(od + g * HD + dp) =
            make_float2(acc[g][0], acc[g][1]);
  }
  if (tid < G) {
    md[tid] = m_s[tid];
    ld[tid] = l_s[tid];
  }
  if (direct) return;

  // the last of the live chunks to arrive folds their partials
  int* cnt = counters + (FUSED ? (size_t)bk : part);
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(cnt, 1) == n_fold - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // The fold, 64 chunks at a time: each (chunk, row)'s m and l into shared
  // memory by one load a thread (kept from the first pass to the second
  // when there are at most 64 chunks), the rows' max m, the weights
  // exp(m_i - max m) (0 where m_i = -inf), then each thread's 2 dims of
  // its rows, the chunks' loads unrolled so that they are in flight
  // together.
  float* lc = red;                      // [TILE][GM]: the chunks' l
  auto load_ml = [&](int cb, int nb) {
    for (int e = tid; e < nb * G; e += THREADS) {
      Ss[(e / G) * GM + e % G] = __ldcg(m_scr + (c0 + cb) * G + e);
      lc[(e / G) * GM + e % G] = __ldcg(l_scr + (c0 + cb) * G + e);
    }
  };
  if (tid < GM) m_s[tid] = -INFINITY;
  for (int cb = 0; cb < n_fold; cb += TILE) {
    const int nb = min(TILE, n_fold - cb);
    __syncthreads();
    load_ml(cb, nb);
    __syncthreads();
    if (tid < G)
      for (int i = 0; i < nb; ++i) m_s[tid] = fmaxf(m_s[tid], Ss[i * GM + tid]);
  }
  float of[GM][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) of[g][0] = of[g][1] = 0.f;
  float lt = 0.f;
  for (int cb = 0; cb < n_fold; cb += TILE) {
    const int nb = min(TILE, n_fold - cb);
    __syncthreads();
    if (n_fold > TILE) {
      load_ml(cb, nb);
      __syncthreads();
    }
    for (int e = tid; e < nb * G; e += THREADS) {
      const int i = e / G, g = e % G;
      const float m = Ss[i * GM + g];
      const float mt = m_s[g];
      Ss[i * GM + g] = finite(m) ? expf(m - (finite(mt) ? mt : 0.f)) : 0.f;
    }
    __syncthreads();
    if (tid < G)
      for (int i = 0; i < nb; ++i) lt += Ss[i * GM + tid] * lc[i * GM + tid];
#pragma unroll 4
    for (int i = 0; i < nb; ++i) {
      const float* oc = o_scr + (c0 + cb + i) * G * HD + dp;
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G && g % SG == sg) {
          const float w = Ss[i * GM + g];
          const float2 ov = __ldcg(reinterpret_cast<const float2*>(oc + g * HD));
          of[g][0] = fmaf(w, ov.x, of[g][0]);
          of[g][1] = fmaf(w, ov.y, of[g][1]);
        }
    }
  }
  if (FUSED) {                          // normalize: out = o / max(l, 1e-30)
    if (tid < G) l_s[tid] = lt;
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G && g % SG == sg)
        store_normalized(ob + g * HD + dp, of[g][0], of[g][1], l_s[g]);
  } else {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G && g % SG == sg)
        *reinterpret_cast<float2*>(o_part + (part * G + g) * HD + dp) =
            make_float2(of[g][0], of[g][1]);
    if (tid < G) {
      m_part[part * G + tid] = m_s[tid];
      l_part[part * G + tid] = lt;
    }
  }
  if (tid == 0) *cnt = 0;               // ready for the next launch
}

template <typename T, int HD, int GM>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* bias, void* o, void* m, void* l,
                         void* out, void* o_scr, void* m_scr, void* l_scr,
                         void* counters, int B, int S, int Sp, int KVH, int G,
                         int nsplit, int C, int chunk, cudaStream_t stream) {
  auto kernel = decode_split_kernel<T, HD, GM, false>;
  if (out) kernel = decode_split_kernel<T, HD, GM, true>;
  const size_t smem = split_smem_bytes(HD, sizeof(T), G);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(C, nsplit, B * KVH);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<T*>(out), static_cast<float*>(o_scr),
      static_cast<float*>(m_scr), static_cast<float*>(l_scr),
      static_cast<int*>(counters), S, Sp, KVH, G, chunk,
      split_stages(HD, sizeof(T)), 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// The instance of head dim HD that holds G rows (8 or 16 a block).
template <typename T, int HD>
cudaError_t launch_group(const void* q, const void* k, const void* v,
                         const void* bias, void* o, void* m, void* l,
                         void* out, void* o_scr, void* m_scr, void* l_scr,
                         void* counters, int B, int S, int Sp, int KVH, int G,
                         int nsplit, int C, int chunk, cudaStream_t s) {
  return G <= 8
             ? launch_split<T, HD, 8>(q, k, v, bias, o, m, l, out, o_scr,
                                      m_scr, l_scr, counters, B, S, Sp, KVH,
                                      G, nsplit, C, chunk, s)
             : launch_split<T, HD, 16>(q, k, v, bias, o, m, l, out, o_scr,
                                       m_scr, l_scr, counters, B, S, Sp, KVH,
                                       G, nsplit, C, chunk, s);
}

// `out` null: partials mode (o, m, l needed); else fused (o, m, l unused).
// The scratch and counters are needed where a fold may take more than one
// block's partials: C > 1 (partials), splits * C > 1 (fused).
template <typename T>
int split_dispatch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, void* m, void* l, void* out,
                   void* o_scr, void* m_scr, void* l_scr, void* counters,
                   int B, int S, int Sp, int KVH, int G, int hd, int bkv,
                   int nsplit, int C, int chunk, void* stream) {
  const long long folds = out ? (long long)nsplit * C : C;
  if (B <= 0 || S <= 0 || KVH <= 0 || G <= 0 || G > MAXG || bkv <= 0 ||
      nsplit <= 0 || Sp < S || Sp % (nsplit * bkv) || C <= 0 || chunk <= 0 ||
      chunk % TILE || (long long)C * chunk < (long long)min(Sp / nsplit, S) ||
      (!out && (!o || !m || !l)) ||
      (folds > 1 && (!o_scr || !m_scr || !l_scr || !counters)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_group<T, 64>(q, k, v, bias, o, m, l, out, o_scr, m_scr, l_scr, counters, B, S, Sp, KVH, G, nsplit, C, chunk, s);
    case 80: return launch_group<T, 80>(q, k, v, bias, o, m, l, out, o_scr, m_scr, l_scr, counters, B, S, Sp, KVH, G, nsplit, C, chunk, s);
    case 128: return launch_group<T, 128>(q, k, v, bias, o, m, l, out, o_scr, m_scr, l_scr, counters, B, S, Sp, KVH, G, nsplit, C, chunk, s);
    case 256: return launch_group<T, 256>(q, k, v, bias, o, m, l, out, o_scr, m_scr, l_scr, counters, B, S, Sp, KVH, G, nsplit, C, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int GM, bool FUSED>
cudaError_t split_attrs_gm(int hd, cudaFuncAttributes* attr) {
  switch (hd) {
    case 64: return cudaFuncGetAttributes(attr, decode_split_kernel<T, 64, GM, FUSED>);
    case 80: return cudaFuncGetAttributes(attr, decode_split_kernel<T, 80, GM, FUSED>);
    case 128: return cudaFuncGetAttributes(attr, decode_split_kernel<T, 128, GM, FUSED>);
    case 256: return cudaFuncGetAttributes(attr, decode_split_kernel<T, 256, GM, FUSED>);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool FUSED>
cudaError_t split_attrs_of(int hd, int G, cudaFuncAttributes* attr) {
  return G <= 8 ? split_attrs_gm<T, 8, FUSED>(hd, attr)
                : split_attrs_gm<T, 16, FUSED>(hd, attr);
}

}  // namespace

extern "C" {

int decode_split_f32(const void* q, const void* k, const void* v,
                     const void* bias, void* o, void* m, void* l, void* out,
                     void* o_scr, void* m_scr, void* l_scr, void* counters,
                     int B, int S, int Sp, int KVH, int G, int hd, int bkv,
                     int nsplit, int C, int chunk, void* stream) {
  return split_dispatch<float>(q, k, v, bias, o, m, l, out, o_scr, m_scr,
                               l_scr, counters, B, S, Sp, KVH, G, hd, bkv,
                               nsplit, C, chunk, stream);
}

int decode_split_bf16(const void* q, const void* k, const void* v,
                      const void* bias, void* o, void* m, void* l, void* out,
                      void* o_scr, void* m_scr, void* l_scr, void* counters,
                      int B, int S, int Sp, int KVH, int G, int hd, int bkv,
                      int nsplit, int C, int chunk, void* stream) {
  return split_dispatch<__nv_bfloat16>(q, k, v, bias, o, m, l, out, o_scr,
                                       m_scr, l_scr, counters, B, S, Sp, KVH,
                                       G, hd, bkv, nsplit, C, chunk, stream);
}

// Registers per thread and local (spill) bytes of the kernel at hd, in the
// instance that holds G query rows (G <= 8, or 8 < G <= 16): mode 0 =
// partials, 1 = fused (the combine in its last block); dtype 0 = fp32,
// 1 = bf16.
int decode_attrs(int mode, int dtype, int hd, int G, int* regs,
                 int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (G <= 0 || G > MAXG) return cudaErrorInvalidValue;
  if (mode == 0)
    err = dtype == 0 ? split_attrs_of<float, false>(hd, G, &attr)
                     : split_attrs_of<__nv_bfloat16, false>(hd, G, &attr);
  else
    err = dtype == 0 ? split_attrs_of<float, true>(hd, G, &attr)
                     : split_attrs_of<__nv_bfloat16, true>(hd, G, &attr);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
