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
//   * A block is a producer warp and 8 consumer warps over a ring of D
//     stages of 64-slot K and V tiles. The producer reads the bias of its
//     slots D tiles ahead (cp.async into a small ring of its own). For
//     each tile, once the consumers have released its stage (an `empty`
//     mbarrier, an arrival from each consumer warp), it copies the tile's
//     bias into the stage and the K and V rows of the tile's valid slots,
//     16 bytes a cp.async, lanes along a row; each lane's arrival on the
//     stage's `full` mbarrier comes when its copies have landed
//     (cp.async.mbarrier.arrive.noinc). A masked slot is neither loaded
//     nor read: the consumers skip it by the stage's bias, and its p.v
//     term is 0 x 0 whatever stale bytes the stage holds. The consumers'
//     phases of a tile (scores, softmax, p.v) meet at a named barrier of
//     the 256 consumer threads; no block-wide barrier stands between two
//     tiles, so D - 1 tiles stay requested while one is computed. (A
//     cp.async.bulk a row is slower for 160-byte rows: 0.437 ms against
//     0.332 at stablelm-3b's decode below, two blocks an SM.)
//   * D and the blocks an SM holds come from the shared memory an instance
//     (hd, dtype, 8 or 16 rows) leaves (split_smem_bytes,
//     kernels/flash_decode.py decode_stages): three blocks of the 8-row
//     instance where each keeps two stages (bf16 at hd 64 and 80; its
//     registers then capped at 72 a thread, the 16-row instance needs
//     more), else one block with as many stages as fit, at most 8 (fp32 at
//     hd 256: one, no tile requested ahead). At stablelm-3b's decode (hd
//     80, bf16, G 1) that is 3 blocks of 2 stages: 3 x 1 x 20 KB = 60 KB of
//     K and V requested ahead an SM, where covering ~1 us of latency at
//     the card's rate takes ~25 KB; B 24 x KV 32 = 768 blocks run in 1.9
//     waves of 396. There the consumers' compute, not the loads, sets a
//     tile's time: on an H100 SXM (B 24, 2,112 valid slots of 2,176, 0.155
//     ms of bytes) a launch took 0.299 ms with no copy at all and 0.023 ms
//     with no compute (two blocks an SM, before the row loops below), so
//     the blocks an SM holds, which overlap their consumers, count for
//     more than the stages: one block of 8 stages took 0.564 ms, three of
//     2 take 0.209.
//   * 256 consumer threads. Scores: a thread owns one slot of the tile
//     and RPT of the query rows, over the whole head dim: its dot products
//     need no shuffle, K is read once from shared memory, q (fp32 in shared
//     memory) is a broadcast. The rows a thread scores past G, and p.v's
//     fours of rows past G, are left out by a branch outside the loops,
//     not a test inside them (0.138 ms against 0.165 at batch_decode). A block holds all G rows of its KV head: the
//     kernel is instanced for G <= 8 (2 rows a thread, a 64 x 8 score tile)
//     and for 8 < G <= 16 (4 rows a thread, a 64 x 16 tile), so a head
//     group's K and V are read once whatever G is; splitting G over two
//     blocks instead would read them twice, and the decode is bound by
//     those bytes. The 8-row instance stays for G <= 8: there the 16-row
//     one (245 registers a thread against about 156) took 1.2-1.4x its
//     time on an H100 SXM with an earlier two-stage ring
//     (scripts/decode_rows_instance.py). The online softmax reduces each
//     query row once per tile
//     (a warp per row). p.v: a thread owns 2 dims of all G rows, reading V
//     from the staged tile and p as 16-byte loads; SG = 256 / (hd/2) slot
//     groups (hd 80: 6, the 16 threads left over idle in p.v) are summed
//     at the end. The score tile has two buffers, by tile parity, so a
//     thread may score tile t + 1 while another still reads tile t's p.
//   * At mistral-large's decode (B 4, capacity 1,088 at 1,054 valid slots,
//     KV 8, G 12, hd 128, bf16) the bytes are K and V of the valid slots,
//     2 x 4 x 1,054 x 8 x 128 x 2 = 17.3 MB, with q, bias and the output:
//     5.2 us at 3.35 TB/s. The kernel reads each slot's K and V once per
//     head group (the G 12 rows share the block), so it moves the bound's
//     bytes; its scratch adds (o, m, l) of each chunk in fp32.
//   * Staged rows lie an odd number of 16-byte chunks apart (hd 80 in bf16:
//     10 chunks, 160 bytes, staged 176 apart), so the score pass's 16-byte
//     reads of 8 consecutive rows fall in 8 distinct bank groups.
//   * The fold reads each (chunk, row)'s m and l once into shared memory,
//     computes the weights there, and each thread sums its 2 dims of its
//     rows over the chunks with the loads unrolled.
//   * Shared memory: the ring (per stage K, V, the tile's bias, two slots
//     of the producer's bias ring, two mbarriers), q, two 64 x GM score
//     tiles (GM = 8 or 16), the slot groups' end reduction and the per-row
//     (m, l, corr); kernels/flash_decode.py decode_smem_bytes mirrors it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;         // consumer threads
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK = THREADS + 32;  // and the producer warp
constexpr int MAXG = 16;             // query rows per KV head the kernel takes
constexpr int TILE = 64;             // slots per staged tile
constexpr int RG = THREADS / TILE;   // row groups of the score pass
constexpr int MAX_STAGES = 8;
constexpr int SMEM_SM = 233472;      // an H100 SM's shared memory (228 KB),
constexpr int SMEM_BLOCK = 232448;   // a block's at most (227 KB),
constexpr int SMEM_RESERVED = 1024;  // and what the runtime keeps a block

// rows of the instance that holds G query rows: 8 or 16
__host__ __device__ constexpr int group_rows(int G) { return G <= 8 ? 8 : 16; }

// bytes between staged K or V rows: an odd number of 16-byte chunks
__host__ __device__ constexpr int row_bytes(int hd, int esize) {
  return ((hd * esize / 16) | 1) * 16;
}

// one stage of the ring: K and V tiles, the tile's bias, two slots of the
// producer's bias ring, the full and empty mbarriers
__host__ __device__ constexpr int stage_bytes(int hd, int esize) {
  return 2 * TILE * row_bytes(hd, esize) + 3 * TILE * 4 + 16;
}

// floats of the slot groups' end reduction, which the fold reuses for the
// chunks' l (TILE x GM)
__host__ __device__ constexpr size_t red_floats(int hd, int G) {
  return (size_t)(THREADS / (hd / 2)) * G * hd > (size_t)TILE * group_rows(G)
             ? (size_t)(THREADS / (hd / 2)) * G * hd
             : (size_t)TILE * group_rows(G);
}

// everything but the ring: q, the two score tiles, (m, l, corr), the end
// reduction, the fold's flag
__host__ __device__ constexpr size_t state_bytes(int hd, int G) {
  return 4 * ((size_t)G * hd + 2 * group_rows(G) * TILE + 3 * group_rows(G) +
              red_floats(hd, G)) + 16;
}

// stages that fit beside the instance's largest state (G = gm) when
// `blocks` share an SM: 1 to MAX_STAGES
__host__ __device__ constexpr int stages_at(int hd, int esize, int gm,
                                            int blocks) {
  long budget = SMEM_SM / blocks - SMEM_RESERVED;
  if (budget > SMEM_BLOCK) budget = SMEM_BLOCK;
  const long d = (budget - (long)state_bytes(hd, gm)) / stage_bytes(hd, esize);
  return d < 1 ? 1 : d > MAX_STAGES ? MAX_STAGES : (int)d;
}

// blocks an SM holds: three of the 8-row instance where each keeps two
// stages (its registers then capped at 72 a thread; the 16-row instance
// needs more), else one
__host__ __device__ constexpr int ring_blocks(int hd, int esize, int gm) {
  return gm == 8 && stages_at(hd, esize, gm, 3) >= 2 ? 3 : 1;
}

__host__ __device__ constexpr int ring_stages(int hd, int esize, int gm) {
  return stages_at(hd, esize, gm, ring_blocks(hd, esize, gm));
}

__host__ __device__ constexpr size_t split_smem_bytes(int hd, int esize,
                                                      int G) {
  return (size_t)ring_stages(hd, esize, group_rows(G)) *
             stage_bytes(hd, esize) +
         state_bytes(hd, G);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, global to shared, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes, global to shared
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's cp.async groups but the newest N have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// an arrival on `bar` when this thread's cp.async copies so far have
// landed (counted in the barrier's init: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the 256 consumer threads (named barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

template <typename T, int HD, int GM, bool FUSED>
__global__ void __launch_bounds__(BLOCK, ring_blocks(HD, sizeof(T), GM))
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, T* __restrict__ out,
                    float* o_scr, float* m_scr, float* l_scr, int* counters,
                    int S, int Sp, int KVH, int G, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smraw[];
  constexpr int ES = sizeof(T);
  constexpr int EPC = 16 / ES;          // elements per 16-byte chunk
  constexpr int CH = HD / EPC;          // 16-byte chunks per row
  constexpr int ROW = row_bytes(HD, ES);  // bytes between staged rows
  constexpr int RB = HD * ES;           // bytes of one slot's row: a copy
  constexpr int TILE_BYTES = TILE * ROW;
  constexpr int D = ring_stages(HD, ES, GM);
  constexpr int NDT = HD / 2;           // p.v: threads over one slot's dims
  constexpr int SG = THREADS / NDT;     //      slot groups (2 to 8)
  constexpr int RPT = GM / RG;          // query rows a thread scores
  unsigned char* ring = smraw;                            // [D][K, V]
  float* tb = reinterpret_cast<float*>(ring + D * 2 * TILE_BYTES);  // [D][TILE]
  float* pf = tb + D * TILE;            // [2D][TILE] the producer's bias ring
  uint64_t* full = reinterpret_cast<uint64_t*>(pf + 2 * D * TILE);  // [D]
  uint64_t* empty = full + D;           // [D]
  float* qs = reinterpret_cast<float*>(empty + D);
  float* Ss = qs + G * HD;              // [2][TILE][GM]: scores, then p
  float* m_s = Ss + 2 * GM * TILE;      // [GM] running max
  float* l_s = m_s + GM;                // [GM] running sum
  float* c_s = l_s + GM;                // [GM] this tile's correction
  float* red = c_s + GM;                // [SG][G][HD] slot groups' sums
  int* last = reinterpret_cast<int*>(red + red_floats(HD, G));

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
    if (!FUSED && c == 0 && tid < THREADS) {
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

  if (tid == 0) {
    for (int st = 0; st < D; ++st) {
      mbar_init(full + st, 32);         // the producer's lanes' copies
      mbar_init(empty + st, WARPS);     // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < THREADS) {
    for (int e = tid; e < G * HD; e += THREADS)
      qs[e] = to_f(q[((size_t)b * H + (size_t)kvh * G) * HD + e]);
    if (tid < GM) {
      m_s[tid] = -INFINITY;
      l_s[tid] = 0.f;
      c_s[tid] = 0.f;
    }
  }
  __syncthreads();                      // the last block-wide barrier

  if (warp == WARPS) {
    // The producer. Lane l reads the bias of slots l and l + 32 of tile t
    // D tiles ahead, into pf slot t % 2D (read D iterations before it is
    // written again): one cp.async group a tile, empty past the last. For
    // tile t, once its stage is released, it copies the tile's bias for
    // the consumers, then the K and V rows of the valid slots, 16 bytes a
    // copy, lanes along a row; each lane's arrival on the stage's full
    // mbarrier comes when its copies have landed.
    const int j0 = lane, j1 = lane + 32;
    auto prefetch = [&](int t) {
      if (t < ntiles) {
        const int t0 = lo + t * TILE;
        float* dst = pf + (t % (2 * D)) * TILE;
        if (t0 + j0 < hi) cp_async4(dst + j0, brow + t0 + j0);
        if (t0 + j1 < hi) cp_async4(dst + j1, brow + t0 + j1);
      }
      cp_async_commit();
    };
    for (int t = 0; t < D; ++t) prefetch(t);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % D;
      const int t0 = lo + t * TILE;
      cp_async_wait<D - 1>();           // tile t's bias has landed
      const float* got = pf + (t % (2 * D)) * TILE;
      const uint32_t live0 =
          __ballot_sync(~0u, t0 + j0 < hi && got[j0] != -INFINITY);
      const uint32_t live1 =
          __ballot_sync(~0u, t0 + j1 < hi && got[j1] != -INFINITY);
      if (t >= D) mbar_wait(empty + st, (t / D - 1) & 1);   // stage released
      float* bt = tb + st * TILE;
      if (t0 + j0 < hi) cp_async4(bt + j0, brow + t0 + j0);
      if (t0 + j1 < hi) cp_async4(bt + j1, brow + t0 + j1);
      unsigned char* ks = ring + st * 2 * TILE_BYTES;
      unsigned char* vs = ks + TILE_BYTES;
#pragma unroll 4
      for (int i = 0; i < 2 * CH; ++i) {  // the tile's 64 x CH chunks
        const int e = lane + 32 * i;
        const int j = e / CH, cc = e % CH;
        const uint32_t live = j < 32 ? live0 >> j : live1 >> (j - 32);
        if (live & 1u) {                // a masked slot is never read
          const size_t src = (size_t)(t0 + j) * step + cc * EPC;
          cp_async16(ks + j * ROW + cc * 16, kb + src);
          cp_async16(vs + j * ROW + cc * 16, vb + src);
        }
      }
      cp_async_arrive(full + st);
      prefetch(t + D);
    }
    return;
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
    const int st = t % D;
    mbar_wait(full + st, (t / D) & 1);  // tile t's bias, K and V have landed
    const unsigned char* ks = ring + st * 2 * TILE_BYTES;
    const unsigned char* vs = ks + TILE_BYTES;
    const float* bt = tb + st * TILE;   // the tile's bias below hi
    const int n_in = hi - (lo + t * TILE);   // slots of the tile below hi
    float* St = Ss + (t & 1) * GM * TILE;

    {
      const float bj = ja < n_in ? bt[ja] : -INFINITY;
      const bool ok = bj != -INFINITY;
      float sc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) sc[r] = 0.f;
      if (ok) {
        const unsigned char* krow = ks + ja * ROW;
        // NR rows of G from ga: a constant inside the loop over the chunks
        auto dot = [&](auto rows) {
          constexpr int NR = decltype(rows)::value;
#pragma unroll 4
          for (int cc = 0; cc < CH; ++cc) {
            float kf[EPC];
            unpack16(krow + (cc << 4), kf, k);
#pragma unroll
            for (int r = 0; r < NR; ++r) {
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
        };
        const int nr = G - ga;          // at most 0: no row of G here
        if (nr >= RPT) {
          dot(std::integral_constant<int, RPT>{});
        } else if (nr == 1) {
          dot(std::integral_constant<int, 1>{});
        } else if constexpr (RPT == 4) {
          if (nr == 2) dot(std::integral_constant<int, 2>{});
          if (nr == 3) dot(std::integral_constant<int, 3>{});
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) sc[r] = ok ? sc[r] * scale + bj : -INFINITY;
      if constexpr (RPT == 2)
        *reinterpret_cast<float2*>(St + ja * GM + ga) = make_float2(sc[0], sc[1]);
      else
        *reinterpret_cast<float4*>(St + ja * GM + ga) =
            make_float4(sc[0], sc[1], sc[2], sc[3]);
    }
    consumer_sync();

    for (int g = warp; g < G; g += WARPS) {
      float* ra = St + lane * GM + g;
      float* rz = St + (lane + 32) * GM + g;
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
    consumer_sync();

    // rows in fours (a float4 of c and of p), the fours past G skipped; a
    // row past G in the last four sums what no output reads
#pragma unroll
    for (int u = 0; u < GM / 4; ++u)
      if (4 * u < G) {
        const float4 c4 = *reinterpret_cast<const float4*>(c_s + 4 * u);
        const float cr[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[4 * u + r][0] *= cr[r];
          acc[4 * u + r][1] *= cr[r];
        }
      }
    if (pv) {
      const unsigned char* vd = vs + dp * ES;
#pragma unroll 4
      for (int i = 0; i < (TILE + SG - 1) / SG; ++i) {
        const int j = sg + i * SG;
        if (j < TILE) {
          // a masked slot's p is 0 and its V is whatever the stage holds:
          // 0 x 0 keeps it out of the sums
          float2 vv = load2(vd + j * ROW, v);
          if (j >= n_in || bt[j] == -INFINITY) vv = make_float2(0.f, 0.f);
#pragma unroll
          for (int u = 0; u < GM / 4; ++u)
            if (4 * u < G) {
              const float4 p4 = *reinterpret_cast<const float4*>(St + j * GM + 4 * u);
              const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                acc[4 * u + r][0] = fmaf(pr[r], vv.x, acc[4 * u + r][0]);
                acc[4 * u + r][1] = fmaf(pr[r], vv.y, acc[4 * u + r][1]);
              }
            }
        }
      }
    }
    __syncwarp();                       // the warp's reads of the stage are done
    if (lane == 0) mbar_arrive(empty + st);
  }

  if (SG > 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (pv && g < G) {
        red[(sg * G + g) * HD + dp] = acc[g][0];
        red[(sg * G + g) * HD + dp + 1] = acc[g][1];
      }
    consumer_sync();
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
  consumer_sync();
  if (tid == 0) *last = atomicAdd(cnt, 1) == n_fold - 1;
  consumer_sync();
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
    consumer_sync();
    load_ml(cb, nb);
    consumer_sync();
    if (tid < G)
      for (int i = 0; i < nb; ++i) m_s[tid] = fmaxf(m_s[tid], Ss[i * GM + tid]);
  }
  float of[GM][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) of[g][0] = of[g][1] = 0.f;
  float lt = 0.f;
  for (int cb = 0; cb < n_fold; cb += TILE) {
    const int nb = min(TILE, n_fold - cb);
    consumer_sync();
    if (n_fold > TILE) {
      load_ml(cb, nb);
      consumer_sync();
    }
    for (int e = tid; e < nb * G; e += THREADS) {
      const int i = e / G, g = e % G;
      const float m = Ss[i * GM + g];
      const float mt = m_s[g];
      Ss[i * GM + g] = finite(m) ? expf(m - (finite(mt) ? mt : 0.f)) : 0.f;
    }
    consumer_sync();
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
    consumer_sync();
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

// The kernel's shared memory for G rows, allowed (with the carveout that
// lets two blocks share an SM), or an error where the card has too little.
template <typename KernelFn>
cudaError_t prepare(KernelFn kernel, size_t smem) {
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
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
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
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(C, nsplit, B * KVH);
  kernel<<<grid, BLOCK, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<T*>(out), static_cast<float*>(o_scr),
      static_cast<float*>(m_scr), static_cast<float*>(l_scr),
      static_cast<int*>(counters), S, Sp, KVH, G, chunk,
      1.0f / sqrtf((float)HD));
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

// The ring of the fused instance that holds G rows: its stages, and the
// blocks an SM holds by the card's occupancy calculator.
template <typename T, int HD, int GM>
cudaError_t ring_gm(int G, int* stages, int* blocks) {
  auto kernel = decode_split_kernel<T, HD, GM, true>;
  const size_t smem = split_smem_bytes(HD, sizeof(T), G);
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  *stages = ring_stages(HD, sizeof(T), GM);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, BLOCK,
                                                       smem);
}

template <typename T>
cudaError_t ring_of(int hd, int G, int* stages, int* blocks) {
  const bool eight = group_rows(G) == 8;
  switch (hd) {
    case 64: return eight ? ring_gm<T, 64, 8>(G, stages, blocks) : ring_gm<T, 64, 16>(G, stages, blocks);
    case 80: return eight ? ring_gm<T, 80, 8>(G, stages, blocks) : ring_gm<T, 80, 16>(G, stages, blocks);
    case 128: return eight ? ring_gm<T, 128, 8>(G, stages, blocks) : ring_gm<T, 128, 16>(G, stages, blocks);
    case 256: return eight ? ring_gm<T, 256, 8>(G, stages, blocks) : ring_gm<T, 256, 16>(G, stages, blocks);
    default: return cudaErrorInvalidValue;
  }
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

// The K/V ring of the fused kernel at hd and G: its stages, and the blocks
// an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor); dtype 0 =
// fp32, 1 = bf16.
int decode_ring(int dtype, int hd, int G, int* stages, int* blocks) {
  if (G <= 0 || G > MAXG) return cudaErrorInvalidValue;
  return dtype == 0 ? ring_of<float>(hd, G, stages, blocks)
                    : ring_of<__nv_bfloat16>(hd, G, stages, blocks);
}

}  // extern "C"
