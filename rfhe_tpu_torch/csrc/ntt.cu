// Negacyclic NTT kernels for Hopper (sm_90a), in two forms: the one-block
// form, where one CTA holds the whole vector of a (poly, limb), n <= 8192,
// and the large-ring form, which splits the vector n = na·nb over the CTAs of
// a thread-block cluster (one trip through global memory) or over two passes.
//
// Replace the two Pallas kernels of the JAX package:
//   rfhe_ntt_fwd, rfhe_ntt_fwd_cluster, rfhe_ntt_fwd_col + rfhe_ntt_fwd_row
//                 <- rfhe_tpu/ops/ntt_fused.py:_fwd_kernel
//   rfhe_ntt_inv, rfhe_ntt_inv_cluster, rfhe_ntt_inv_row + rfhe_ntt_inv_col
//                 <- rfhe_tpu/ops/ntt_fused.py:_inv_kernel
// Those run a four-step transform on int8 digit matmuls for the TPU's MXU.
// The map they compute is fixed and exact, so these kernels compute it
// another way and stay bit-identical.  For limb l with prime q, ψ the
// negacyclic root and R = 2^32 mod q:
//   fwd: y[p] = R · Σ_t x[t] · ψ^((2·nu[p]+1)·t)                  mod q
//   inv: x[t] = n⁻¹ · R⁻¹ · Σ_p y[p] · ψ^(−(2·nu[p]+1)·t)          mod q
// with the reference's slot order nu (rfhe_tpu/ops/ntt_mxu.py:237-240).
//
// Every form runs the same radix-2 network: Cooley-Tukey forward on
// bit-reversed ψ powers, the mirrored Gentleman-Sande network on ψ^-1 powers
// inverse, every product a Shoup multiplication on __umulhi (q < 2^31).  The
// forward exit applies R and writes network position j to its slot, the
// inverse entry reads that slot and the inverse exit applies n⁻¹·R⁻¹.
// Per-limb tables are indexed by a limb-id array, so a plan over any subset
// of the chain shares one set of tables:
//   tw:     (Lf, 4, n) uint32 [ψ^brev, Shoup, ψ^-brev, Shoup] per chain limb
//   consts: (Lf, 8) uint32 [q, R, R', n⁻¹R⁻¹, (n⁻¹R⁻¹)', ⌊2^32/q⌋, 0, 0]
//   limbs:  (L,) chain index of each limb
//   x, y:   (B, L, n) int64, words below 2^32 in, canonical residues out
// An input word need not be a residue below q: a fault campaign flips bits of
// live operands, and the plain versions reduce such a word in their first
// product.  The kernels reduce every word as they take it (enter16), so the
// butterflies' ranges hold and the output is that of the word mod q.
// The device functions of the large-ring section below (register rounds,
// twiddle slots, exchanges, the closed-form slot) serve all kernels; the
// one-block kernels follow the cluster kernels, whose shape they share.
// Last comes `rfhe_span_mark`, no transform: trace/spans.py's one-thread
// clock mark, kept here so that it builds and loads with the kernels.

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w,
                                              uint32_t w_shoup, uint32_t q) {
  // x*w mod q with w' = floor(w*2^32/q): r = x*w - hi(x*w')*q in [0, 2q)
  const uint32_t hi = __umulhi(x, w_shoup);
  const uint32_t r = x * w - hi * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_q(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;  // < 2q < 2^32
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_q(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// ---------------------------------------------------------------------------
// Large-ring form: n = na·nb (element j = r·nb + c), 16 <= na <= 256,
// 2 <= nb <= 256, n >= 256.
//
// The radix-2 network splits at n = na·nb.  The stages that pair elements
// 2^h apart with h >= log2(nb) stay inside a column (the column phase, a
// size-na network whose twiddles depend on the row pair only); the stages
// with h < log2(nb) stay inside a row (the row phase).  Forward runs the
// column phase first (Cooley-Tukey, h descending), inverse the row phase
// first (Gentleman-Sande, h ascending).  Every kernel takes the same tables
// and leaves canonical residues, so the forms are bit-identical.
//
// What bounds it on this card: bytes first, 32-bit integer instructions
// close behind.  A transform must read 8 and write 8 bytes per int64 element;
// a plain copy of (21, 22, 65536) runs at 2.98 TB/s on an H100.  The
// n/2·log2 n Shoup butterflies run on the integer pipes (64 lanes per SM),
// where 12 instructions a butterfly take about two thirds of the time the
// bytes take.  So the design is about moving each byte once, in full
// sectors, about keeping those moves in flight while the butterflies run,
// and about fewer instructions per butterfly:
//
//  * Butterflies in registers.  A thread holds 16 elements and runs up to
//    four stages on them (a "round").  A phase is two rounds with one
//    exchange through shared memory between them, one barrier instead of
//    eight.  A round's elements are j = j0 + (e << hb), e = 0..15: register
//    bit i is bit hb + i of j, so the stage with distance 2^h is the register
//    distance 2^(h-hb).  The row exchange is padded by one word in 16 and the
//    column exchange keeps 32 adjacent columns in consecutive banks: neither
//    has a bank conflict.
//  * Twiddles resident across polynomials.  A CTA owns one (limb, tile) and
//    loops over the polynomials b = blockIdx.y, blockIdx.y + gridDim.y, ...
//    The twiddle of a butterfly depends on (limb, position) only, so the
//    thread's 15 (w, w') pairs of a round are fetched once: into registers
//    where every thread's differ (the row phase's last four stages), into
//    shared memory where a warp shares them (read as a broadcast).
//  * Loads in flight while a tile computes.  The next polynomial's 16 words
//    are loaded into registers before the current one's rounds run; only the
//    low word of each int64 residue is loaded.  Staging the whole words in
//    shared memory by 16-byte cp.async requests instead was 2-3% slower in the
//    forward cluster kernel at n >= 32768 on an H100 (the build variant
//    RFHE_NTT_CLUSTER_CP_ASYNC below, timed by time_ntt.py); TMA is untried.
//  * Contiguous slot rows.  Network position j holds slot
//    p = brev(j / n1)·n1 + brev(j mod n1) (n1 the slot order's split).  The
//    kernels compute it with __brev; there is no slot table.  With nb = n1,
//    the form's own split from n = 16384 up, row r is slot row brev(r) and a
//    warp stores two 128-byte runs of it straight from registers.
//  * One trip through device memory (the cluster kernels).  A thread-block
//    cluster of nb/C CTAs (C = 16: 16 CTAs at nb = 256, above the portable 8,
//    which the H100 takes with an opt-in) holds one (poly, limb) vector in
//    its CTAs' shared memory.  Each CTA runs the first phase on its tile and
//    pushes the result into the shared memory of the CTAs that own it in the
//    second phase (distributed shared memory), across a split cluster
//    barrier.  16 bytes per element and one launch.  The two-pass kernels do
//    the same phases with a uint32 intermediate in global memory between
//    them (24 bytes per element, two launches).  On an H100 the cluster
//    kernels win or draw for launches of up to 3·28·65536 words and the two
//    passes win above: a cluster's CTAs run in step, polynomial by
//    polynomial, and what a CTA does between two barriers (loads, 64
//    butterflies a thread, stores) overlaps little, while the passes' CTAs
//    are independent and each does half the arithmetic per byte.
//    `ops/ntt_cuda.py` says which kernels a launch takes.
//  * Lazy butterflies.  For q < 2^30 the butterflies skip the conditional
//    corrections (see mul_shoup_lazy): 7 instructions instead of 12.
//
// Geometry, checked by the caller: C = 2^log_c columns per column tile (at
// most 32 in the two passes, 16 in a cluster), na·C/16 threads; the row pass works on chunks of 2^log_chunk
// consecutive words (a multiple of 256), chunk/16 threads.  Grid: x = limb ·
// tiles + tile (the cluster: consecutive tiles of one limb), y = polynomial
// group.
// ---------------------------------------------------------------------------

constexpr int kLargeThreads = 512;   // 256 rows x 32 columns / 16, or a chunk of 8192
constexpr int kSlots = 15;           // twiddles of a round: 1 + 2 + 4 + 8

// Bit t set: the round whose register bit 0 is bit hb of j runs its stage t
// (register distance 8 >> t, h = hb + 3 - t), for the stages h_lo <= h <= h_hi.
__device__ __forceinline__ int stage_mask(int hb, int h_lo, int h_hi) {
  int m = 0;
  for (int t = 0; t < 4; ++t) {
    const int h = hb + 3 - t;
    if (h >= h_lo && h <= h_hi) m |= 1 << t;
  }
  return m;
}

// Twiddle slot k of a round on the elements j0 + (e << hb): stage
// t = floor(log2(k + 1)), group g = k + 1 - 2^t, whose lower elements start at
// e = g << (4 - t).  The stage with distance 2^h takes table entry
// 2^(log_n-1-h) + (j >> (h+1)), in both directions.
__device__ __forceinline__ uint2 load_tw(const uint32_t* __restrict__ w,
                                         const uint32_t* __restrict__ ws,
                                         int log_n, int j0, int hb, int mask, int k) {
  const int t = 31 - __clz(k + 1);
  if (!((mask >> t) & 1)) return make_uint2(0u, 0u);
  const int e = (k + 1 - (1 << t)) << (4 - t);
  const int h = hb + 3 - t;
  const int idx = (1 << (log_n - 1 - h)) + ((j0 + (e << hb)) >> (h + 1));
  return make_uint2(w[idx], ws[idx]);
}

// Twiddles that several threads share, into shared memory: `reps` rounds of
// kSlots each, round i on the elements j_base + i·j_step + (e << hb).
__device__ __forceinline__ void stage_tw(uint2* dst, int reps, int j_base, int j_step,
                                         int hb, int mask,
                                         const uint32_t* __restrict__ w,
                                         const uint32_t* __restrict__ ws, int log_n) {
  for (int i = threadIdx.x; i < reps * kSlots; i += blockDim.x)
    dst[i] = load_tw(w, ws, log_n, j_base + (i / kSlots) * j_step, hb, mask, i % kSlots);
}

// Lazy butterflies (Harvey): for q < 2^30 residues may stay in [0, 4q)
// (forward) or [0, 2q) (inverse) between stages, which drops the conditional
// corrections of the strict butterflies: 4 additions beside the 3
// multiplications instead of 9.  The lazy Shoup product takes any 32-bit x to
// [0, 2q); the exit factor's strict product makes the result canonical, so
// the outputs are those of the strict butterflies bit for bit.  Limbs with
// q >= 2^30 take the strict ones.
__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t x, uint32_t w,
                                                   uint32_t w_shoup, uint32_t q) {
  return x * w - __umulhi(x, w_shoup) * q;
}

// Up to four Cooley-Tukey stages on 16 registers, distance 8, 4, 2, 1.
template <bool LAZY>
__device__ __forceinline__ void ct_round(uint32_t (&a)[16], const uint2* tw, int mask,
                                         uint32_t q) {
#ifdef RFHE_NTT_SKIP_BUTTERFLIES   // timing only (time_ntt.py): what the data movement alone takes
  mask = 0;
#endif
  const uint32_t q2 = 2 * q;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if ((mask >> t) & 1) {
      const int d = 8 >> t;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int g = k >> (3 - t);
        const int e = (g << (4 - t)) + (k & (d - 1));
        const uint2 w = tw[(1 << t) - 1 + g];
        if (LAZY) {                       // a[e], a[e+d] in [0, 4q) before and after
          const uint32_t u = min(a[e], a[e] - q2);
          const uint32_t v = mul_shoup_lazy(a[e + d], w.x, w.y, q);
          a[e] = u + v;
          a[e + d] = u - v + q2;
        } else {
          const uint32_t u = a[e];
          const uint32_t v = mul_shoup(a[e + d], w.x, w.y, q);
          a[e] = add_q(u, v, q);
          a[e + d] = sub_q(u, v, q);
        }
      }
    }
  }
}

// Up to four Gentleman-Sande stages on 16 registers, distance 1, 2, 4, 8.
template <bool LAZY>
__device__ __forceinline__ void gs_round(uint32_t (&a)[16], const uint2* tw, int mask,
                                         uint32_t q) {
#ifdef RFHE_NTT_SKIP_BUTTERFLIES   // timing only (time_ntt.py): what the data movement alone takes
  mask = 0;
#endif
  const uint32_t q2 = 2 * q;
#pragma unroll
  for (int t = 3; t >= 0; --t) {
    if ((mask >> t) & 1) {
      const int d = 8 >> t;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int g = k >> (3 - t);
        const int e = (g << (4 - t)) + (k & (d - 1));
        const uint2 w = tw[(1 << t) - 1 + g];
        const uint32_t u = a[e], v = a[e + d];
        if (LAZY) {                       // a[e], a[e+d] in [0, 2q) before and after
          const uint32_t sum = u + v;
          a[e] = min(sum, sum - q2);
          a[e + d] = mul_shoup_lazy(u - v + q2, w.x, w.y, q);
        } else {
          a[e] = add_q(u, v, q);
          a[e + d] = mul_shoup(sub_q(u, v, q), w.x, w.y, q);
        }
      }
    }
  }
}

// Slot of network position j: brev(j / n1)·n1 + brev(j mod n1).
__device__ __forceinline__ int slot_of(int j, int log_n, int log_n1) {
  const int lo = j & ((1 << log_n1) - 1), hi = j >> log_n1;
  return (int)((__brev((unsigned)hi) >> (32 - (log_n - log_n1))) << log_n1) |
         (int)(__brev((unsigned)lo) >> (32 - log_n1));
}

__device__ __forceinline__ uint32_t low_word(const int64_t* __restrict__ p, size_t i) {
  return reinterpret_cast<const uint32_t*>(p)[2 * i];
}

// The geometry and the tables of one CTA.
struct Large {
  int log_n, log_na, log_nb, log_n1;
  int l;                       // limb of this CTA
  uint32_t q;
  bool lazy;                   // q < 2^30: the lazy butterflies
  const uint32_t* w;           // the direction's twiddle row of the limb
  const uint32_t* ws;          // and its Shoup companions
  const uint32_t* c;           // the limb's constants
};

// The geometry alone: reads no memory, so a kernel can issue its first
// polynomial's loads before it looks up the limb's tables.
__device__ __forceinline__ Large geometry_of(int l, int log_n, int log_na, int log_n1) {
  Large g;
  g.log_n = log_n; g.log_na = log_na; g.log_nb = log_n - log_na; g.log_n1 = log_n1;
  g.l = l;
  return g;
}

__device__ __forceinline__ void tables_of(Large& g, const uint32_t* __restrict__ tw,
                                          const uint32_t* __restrict__ consts,
                                          const int32_t* __restrict__ limbs, bool inverse) {
  const int lid = limbs[g.l];
  g.w = tw + ((size_t)lid * 4 + (inverse ? 2 : 0)) * ((size_t)1 << g.log_n);
  g.ws = g.w + ((size_t)1 << g.log_n);
  g.c = consts + (size_t)lid * 8;
  g.q = g.c[0];
  g.lazy = g.q < (1u << 30);
}

// Entry of a vector: 16 words below 2^32 to [0, q).  The lazy Shoup product by
// 1 (w' = ⌊2^32/q⌋) takes a word to [0, 2q), one correction to [0, q).
__device__ __forceinline__ void enter16(uint32_t (&a)[16], const Large& g) {
  const uint32_t s = g.c[5];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const uint32_t r = a[e] - __umulhi(a[e], s) * g.q;
    a[e] = min(r, r - g.q);
  }
}

__device__ __forceinline__ Large large_of(const uint32_t* __restrict__ tw,
                                          const uint32_t* __restrict__ consts,
                                          const int32_t* __restrict__ limbs, int l,
                                          int log_n, int log_na, int log_n1,
                                          bool inverse) {
  Large g = geometry_of(l, log_n, log_na, log_n1);
  tables_of(g, tw, consts, limbs, inverse);
  return g;
}

// ---- column phase ----------------------------------------------------------
// A tile of C = 2^log_c adjacent columns x na rows; thread (xr, c) with c
// fastest.  "hi" round: rows (e << (S-4)) | xr, the four highest row bits in
// registers; "lo" round: rows xr·16 + e.  S = log2(na) >= 4.
struct ColThread {
  int xr, c, mask_hi, mask_lo;
  const uint2* tw_hi;
  const uint2* tw_lo;
};

// Shared memory: [kSlots hi][(na/16)·kSlots lo] uint2.  Returns its size in
// uint32 words.
__device__ __forceinline__ int col_setup(const Large& g, int log_c, bool inverse,
                                         uint32_t* sm, ColThread& th) {
  const int S = g.log_na, reps = 1 << (S - 4);
  th.xr = threadIdx.x >> log_c;
  th.c = threadIdx.x & ((1 << log_c) - 1);
  // forward: hi runs all four, lo the stages below them; inverse: lo runs all
  // four, hi the stages above them
  th.mask_hi = inverse ? stage_mask(g.log_nb + S - 4, g.log_nb + 4, g.log_n - 1) : 15;
  th.mask_lo = inverse ? 15 : stage_mask(g.log_nb, g.log_nb, g.log_nb + S - 5);
  uint2* tws = reinterpret_cast<uint2*>(sm);
  stage_tw(tws, 1, 0, 0, g.log_nb + S - 4, th.mask_hi, g.w, g.ws, g.log_n);
  stage_tw(tws + kSlots, reps, 0, 16 << g.log_nb, g.log_nb, th.mask_lo, g.w, g.ws, g.log_n);
  th.tw_hi = tws;
  th.tw_lo = tws + kSlots * (1 + th.xr);
  return 2 * kSlots * (1 + reps);
}

__device__ __forceinline__ int col_row_hi(const Large& g, const ColThread& th, int e) {
  return (e << (g.log_na - 4)) | th.xr;
}

__device__ __forceinline__ int col_row_lo(const ColThread& th, int e) {
  return th.xr * 16 + e;
}

// Word of (row r, column c of the tile) in a tile buffer.  32 columns fill
// the banks; a narrower tile is padded by 16 words every 16 rows, so that the
// rows xr·16 + e of the threads of a warp fall into different banks.
__device__ __forceinline__ int col_at(int r, int c, int log_c) {
  return (r << log_c) + c + (log_c < 5 ? (r >> 4) << 4 : 0);
}

__device__ __host__ __forceinline__ int tile_words(int log_na, int log_c) {
  return (1 << (log_na + log_c)) + (log_c < 5 ? 1 << log_na : 0);
}

// a: rows of the hi round on entry, rows of the lo round on exit.
template <bool LAZY>
__device__ __forceinline__ void fwd_col_phase(uint32_t (&a)[16], uint32_t* buf,
                                              const Large& g, const ColThread& th,
                                              int log_c) {
  ct_round<LAZY>(a, th.tw_hi, th.mask_hi, g.q);
#pragma unroll
  for (int e = 0; e < 16; ++e) buf[col_at(col_row_hi(g, th, e), th.c, log_c)] = a[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = buf[col_at(col_row_lo(th, e), th.c, log_c)];
  ct_round<LAZY>(a, th.tw_lo, th.mask_lo, g.q);
}

// a: rows of the lo round on entry, rows of the hi round on exit.
template <bool LAZY>
__device__ __forceinline__ void inv_col_phase(uint32_t (&a)[16], uint32_t* buf,
                                              const Large& g, const ColThread& th,
                                              int log_c) {
  gs_round<LAZY>(a, th.tw_lo, th.mask_lo, g.q);
#pragma unroll
  for (int e = 0; e < 16; ++e) buf[col_at(col_row_lo(th, e), th.c, log_c)] = a[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = buf[col_at(col_row_hi(g, th, e), th.c, log_c)];
  gs_round<LAZY>(a, th.tw_hi, th.mask_hi, g.q);
}

// ---- row phase -------------------------------------------------------------
// A chunk of consecutive words starting at `base`; thread x.  "hi" round:
// local words (x/16)·256 + e·16 + x%16 (bits 4..7 in registers); "lo" round:
// local words x·16 + e.  The lo round's twiddles differ for every thread and
// live in registers; the hi round's are shared by 16 threads.
struct RowThread {
  int mask_hi, mask_lo;
  const uint2* tw_hi;
};

__device__ __forceinline__ int row_word_hi(int e) {
  return ((threadIdx.x >> 4) << 8) + (e << 4) + (threadIdx.x & 15);
}

__device__ __forceinline__ int row_word_lo(int e) { return threadIdx.x * 16 + e; }

// The exchange buffer is padded by one word in 16.
__device__ __forceinline__ int row_pad(int i) { return i + (i >> 4); }

// Shared memory: [(chunk/256)·kSlots] uint2.  Returns its size in words.
__device__ __forceinline__ int row_setup(const Large& g, int base, int chunk,
                                         uint32_t* sm, RowThread& th, uint2 (&tw_lo)[kSlots]) {
  th.mask_hi = stage_mask(4, 0, g.log_nb - 1);
  th.mask_lo = stage_mask(0, 0, g.log_nb - 1);
  uint2* tws = reinterpret_cast<uint2*>(sm);
  stage_tw(tws, chunk >> 8, base, 256, 4, th.mask_hi, g.w, g.ws, g.log_n);
  th.tw_hi = tws + kSlots * (threadIdx.x >> 4);
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    tw_lo[k] = load_tw(g.w, g.ws, g.log_n, base + threadIdx.x * 16, 0, th.mask_lo, k);
  return 2 * kSlots * (chunk >> 8);
}

// a: words of the hi round on entry, of the lo round on exit.
template <bool LAZY>
__device__ __forceinline__ void fwd_row_phase(uint32_t (&a)[16], uint32_t* xb,
                                              const Large& g, const RowThread& th,
                                              const uint2 (&tw_lo)[kSlots]) {
  ct_round<LAZY>(a, th.tw_hi, th.mask_hi, g.q);
#pragma unroll
  for (int e = 0; e < 16; ++e) xb[row_pad(row_word_hi(e))] = a[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = xb[row_pad(row_word_lo(e))];
  ct_round<LAZY>(a, tw_lo, th.mask_lo, g.q);
}

// a: words of the lo round on entry, of the hi round on exit.
template <bool LAZY>
__device__ __forceinline__ void inv_row_phase(uint32_t (&a)[16], uint32_t* xb,
                                              const Large& g, const RowThread& th,
                                              const uint2 (&tw_lo)[kSlots]) {
  gs_round<LAZY>(a, tw_lo, th.mask_lo, g.q);
#pragma unroll
  for (int e = 0; e < 16; ++e) xb[row_pad(row_word_lo(e))] = a[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = xb[row_pad(row_word_hi(e))];
  gs_round<LAZY>(a, th.tw_hi, th.mask_hi, g.q);
}

// Forward exit: slot of word j scaled by R.  Inverse entry reads the same slot.
__device__ __forceinline__ void store_slots(const uint32_t (&a)[16], int64_t* __restrict__ y,
                                            size_t off, int base, const Large& g) {
  const uint32_t r = g.c[1], r_s = g.c[2];
#pragma unroll
  for (int e = 0; e < 16; ++e)
    y[off + slot_of(base + row_word_lo(e), g.log_n, g.log_n1)] =
        (int64_t)mul_shoup(a[e], r, r_s, g.q);
}

__device__ __forceinline__ void load_slots(uint32_t (&a)[16], const int64_t* __restrict__ y,
                                           size_t off, int base, const Large& g) {
#pragma unroll
  for (int e = 0; e < 16; ++e)
    a[e] = low_word(y, off + slot_of(base + row_word_lo(e), g.log_n, g.log_n1));
}

// Inverse exit of the column phase: n^-1 R^-1 at the store, rows of the hi round.
__device__ __forceinline__ void store_coeffs(const uint32_t (&a)[16], int64_t* __restrict__ x,
                                             size_t off, int col, const Large& g,
                                             const ColThread& th) {
  const uint32_t f = g.c[3], f_s = g.c[4];
#pragma unroll
  for (int e = 0; e < 16; ++e)
    x[off + ((size_t)col_row_hi(g, th, e) << g.log_nb) + col] =
        (int64_t)mul_shoup(a[e], f, f_s, g.q);
}

__device__ __forceinline__ void load_coeffs(uint32_t (&a)[16], const int64_t* __restrict__ x,
                                            size_t off, int col, const Large& g,
                                            const ColThread& th) {
#pragma unroll
  for (int e = 0; e < 16; ++e)
    a[e] = low_word(x, off + ((size_t)col_row_hi(g, th, e) << g.log_nb) + col);
}

__device__ __forceinline__ void copy16(uint32_t (&dst)[16], const uint32_t (&src)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) dst[e] = src[e];
}

// ---- two passes through a uint32 intermediate -------------------------------
// tmp: (B, L, n) uint32, natural order j = r·nb + c.

__global__ void __launch_bounds__(kLargeThreads)
ntt_fwd_col_kernel(const int64_t* __restrict__ x, uint32_t* __restrict__ tmp,
                   const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
                   const int32_t* __restrict__ limbs, int L, int B, int log_n,
                   int log_na, int log_c) {
  extern __shared__ uint32_t sm[];
  const int tiles = 1 << (log_n - log_na - log_c);
  const Large g = large_of(tw, consts, limbs, blockIdx.x / tiles, log_n, log_na, 0, false);
  ColThread th;
  uint32_t* bufs = sm + col_setup(g, log_c, false, sm, th);
  __syncthreads();
  const int tile = tile_words(log_na, log_c);
  const int col = ((blockIdx.x % tiles) << log_c) + th.c;
  const size_t n = (size_t)1 << log_n;
  uint32_t a[16], nxt[16];
  int b = blockIdx.y;
  if (b < B) load_coeffs(nxt, x, ((size_t)b * L + g.l) * n, col, g, th);
  for (int it = 0; b < B; b += gridDim.y, ++it) {
    const size_t off = ((size_t)b * L + g.l) * n;
    copy16(a, nxt);
    if (b + (int)gridDim.y < B)
      load_coeffs(nxt, x, ((size_t)(b + gridDim.y) * L + g.l) * n, col, g, th);
    enter16(a, g);
    if (g.lazy) fwd_col_phase<true>(a, bufs + (it & 1) * tile, g, th, log_c);
    else fwd_col_phase<false>(a, bufs + (it & 1) * tile, g, th, log_c);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      tmp[off + ((size_t)col_row_lo(th, e) << g.log_nb) + col] = a[e];
  }
}

__global__ void __launch_bounds__(kLargeThreads)
ntt_fwd_row_kernel(const uint32_t* __restrict__ tmp, int64_t* __restrict__ y,
                   const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
                   const int32_t* __restrict__ limbs, int L, int B, int log_n,
                   int log_na, int log_chunk, int log_n1) {
  extern __shared__ uint32_t sm[];
  const int chunks = 1 << (log_n - log_chunk), chunk = 1 << log_chunk;
  const Large g = large_of(tw, consts, limbs, blockIdx.x / chunks, log_n, log_na, log_n1, false);
  const int base = (blockIdx.x % chunks) << log_chunk;
  RowThread th;
  uint2 tw_lo[kSlots];
  uint32_t* xbs = sm + row_setup(g, base, chunk, sm, th, tw_lo);
  __syncthreads();
  const int padded = chunk + (chunk >> 4);
  const size_t n = (size_t)1 << log_n;
  uint32_t a[16], nxt[16];
  int b = blockIdx.y;
  auto load = [&](uint32_t (&dst)[16], int bb) {
    const uint32_t* src = tmp + ((size_t)bb * L + g.l) * n + base;
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = src[row_word_hi(e)];
  };
  if (b < B) load(nxt, b);
  for (int it = 0; b < B; b += gridDim.y, ++it) {
    copy16(a, nxt);
    if (b + (int)gridDim.y < B) load(nxt, b + gridDim.y);
    if (g.lazy) fwd_row_phase<true>(a, xbs + (it & 1) * padded, g, th, tw_lo);
    else fwd_row_phase<false>(a, xbs + (it & 1) * padded, g, th, tw_lo);
    store_slots(a, y, ((size_t)b * L + g.l) * n, base, g);
  }
}

__global__ void __launch_bounds__(kLargeThreads)
ntt_inv_row_kernel(const int64_t* __restrict__ y, uint32_t* __restrict__ tmp,
                   const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
                   const int32_t* __restrict__ limbs, int L, int B, int log_n,
                   int log_na, int log_chunk, int log_n1) {
  extern __shared__ uint32_t sm[];
  const int chunks = 1 << (log_n - log_chunk), chunk = 1 << log_chunk;
  const Large g = large_of(tw, consts, limbs, blockIdx.x / chunks, log_n, log_na, log_n1, true);
  const int base = (blockIdx.x % chunks) << log_chunk;
  RowThread th;
  uint2 tw_lo[kSlots];
  uint32_t* xbs = sm + row_setup(g, base, chunk, sm, th, tw_lo);
  __syncthreads();
  const int padded = chunk + (chunk >> 4);
  const size_t n = (size_t)1 << log_n;
  uint32_t a[16], nxt[16];
  int b = blockIdx.y;
  if (b < B) load_slots(nxt, y, ((size_t)b * L + g.l) * n, base, g);
  for (int it = 0; b < B; b += gridDim.y, ++it) {
    copy16(a, nxt);
    if (b + (int)gridDim.y < B)
      load_slots(nxt, y, ((size_t)(b + gridDim.y) * L + g.l) * n, base, g);
    enter16(a, g);
    if (g.lazy) inv_row_phase<true>(a, xbs + (it & 1) * padded, g, th, tw_lo);
    else inv_row_phase<false>(a, xbs + (it & 1) * padded, g, th, tw_lo);
    uint32_t* dst = tmp + ((size_t)b * L + g.l) * n + base;
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[row_word_hi(e)] = a[e];
  }
}

__global__ void __launch_bounds__(kLargeThreads)
ntt_inv_col_kernel(const uint32_t* __restrict__ tmp, int64_t* __restrict__ x,
                   const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
                   const int32_t* __restrict__ limbs, int L, int B, int log_n,
                   int log_na, int log_c) {
  extern __shared__ uint32_t sm[];
  const int tiles = 1 << (log_n - log_na - log_c);
  const Large g = large_of(tw, consts, limbs, blockIdx.x / tiles, log_n, log_na, 0, true);
  ColThread th;
  uint32_t* bufs = sm + col_setup(g, log_c, true, sm, th);
  __syncthreads();
  const int tile = tile_words(log_na, log_c);
  const int col = ((blockIdx.x % tiles) << log_c) + th.c;
  const size_t n = (size_t)1 << log_n;
  uint32_t a[16], nxt[16];
  int b = blockIdx.y;
  auto load = [&](uint32_t (&dst)[16], int bb) {
    const uint32_t* src = tmp + ((size_t)bb * L + g.l) * n + col;
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = src[(size_t)col_row_lo(th, e) << g.log_nb];
  };
  if (b < B) load(nxt, b);
  for (int it = 0; b < B; b += gridDim.y, ++it) {
    copy16(a, nxt);
    if (b + (int)gridDim.y < B) load(nxt, b + gridDim.y);
    if (g.lazy) inv_col_phase<true>(a, bufs + (it & 1) * tile, g, th, log_c);
    else inv_col_phase<false>(a, bufs + (it & 1) * tile, g, th, log_c);
    store_coeffs(a, x, ((size_t)b * L + g.l) * n, col, g, th);
  }
}

// ---- one trip: a cluster of nb/C CTAs holds the vector ----------------------
// CTA `rank` of the cluster owns the columns [rank·C, (rank+1)·C) in the
// column phase and the words [rank·na·C, (rank+1)·na·C) (whole rows) in the
// row phase.  The phase that runs first pushes its results into the shared
// memory of the CTAs that own them in the second phase (stores to
// distributed shared memory do not stall the writer): the forward column
// phase writes row r into CTA r / (na·C/nb) as local words (padded by 16 in
// 256), the inverse row phase writes word (r, col) into CTA col/C as (row,
// column in tile).  The receiving buffer is double-buffered and the cluster
// barrier is split: a CTA produces polynomial k+1, fetches polynomial k from
// its own shared memory into registers, arrives, and runs the second phase
// of polynomial k while the others catch up; the wait that follows makes
// polynomial k+1 complete everywhere and buffer k free again.

__device__ __forceinline__ int rows_pad(int i) { return i + ((i >> 8) << 4); }

// The two halves of the cluster barrier: arrive releases this thread's
// writes (to any CTA's shared memory), wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

#ifdef RFHE_NTT_CLUSTER_CP_ASYNC
// Timing only (time_ntt.py --cp-async): the forward cluster kernel fetches the
// next polynomial's column tile as whole int64 words with cp.async, 16 bytes a
// request, into a staging buffer of shared memory (na rows x C columns,
// dense), in place of the register prefetch of the low words.  x must be
// 16-byte aligned.
__device__ __forceinline__ void stage_coeffs(int64_t* st, const int64_t* __restrict__ x,
                                             size_t off, int col0, const Large& g, int log_c) {
  const int log_p = log_c - 1;                       // 16-byte pieces in a row of the tile
  for (int i = threadIdx.x; i < (1 << (g.log_na + log_p)); i += blockDim.x) {
    const int r = i >> log_p, piece = i & ((1 << log_p) - 1);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(st + 2 * i);
    const int64_t* src = x + off + ((size_t)r << g.log_nb) + col0 + 2 * piece;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  }
}
#endif

__global__ void __launch_bounds__(kLargeThreads)
ntt_fwd_cluster_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ y,
                       const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
                       const int32_t* __restrict__ limbs, int L, int B, int log_n,
                       int log_na, int log_c, int log_n1) {
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int log_k = log_n - log_na - log_c;          // CTAs in the cluster
  const int rank = (int)cluster.block_rank();
  const Large g = large_of(tw, consts, limbs, blockIdx.x >> log_k, log_n, log_na, log_n1, false);
  const int tile = 1 << (log_na + log_c), base = rank * tile;
  const int padded = tile + (tile >> 4);
  ColThread ct;
  RowThread rt;
  uint2 tw_lo[kSlots];
#ifdef RFHE_NTT_CLUSTER_CP_ASYNC
  int64_t* st = reinterpret_cast<int64_t*>(sm);      // tile int64: the staged coefficients
  uint32_t* p = sm + 2 * tile;
  p += col_setup(g, log_c, false, p, ct);
#else
  uint32_t* p = sm + col_setup(g, log_c, false, sm, ct);
#endif
  p += row_setup(g, base, tile, p, rt, tw_lo);
  uint32_t* recv = p;                                // 2 x padded: my rows, pushed by all
  uint32_t* xb = recv + 2 * padded;                  // padded: the row exchange
  uint32_t* cb = xb + padded;                        // tile: the column exchange
  const int col = (rank << log_c) + ct.c;
  const int log_rows = log_na - log_k;               // rows a CTA owns: 2^log_rows
  const size_t n = (size_t)1 << log_n;
  const int G = gridDim.y;
  int b = blockIdx.y;
#ifdef RFHE_NTT_CLUSTER_CP_ASYNC
  uint32_t a[16];
  if (b < B) stage_coeffs(st, x, ((size_t)b * L + g.l) * n, rank << log_c, g, log_c);
#else
  uint32_t a[16], nxt[16];
  if (b < B) load_coeffs(nxt, x, ((size_t)b * L + g.l) * n, col, g, ct);
#endif
  // every CTA of the cluster is running before any shared memory is written
  cluster.sync();
  auto produce = [&](int bb, int k) {                // column phase of polynomial bb
#ifdef RFHE_NTT_CLUSTER_CP_ASYNC
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 16; ++e)
      a[e] = reinterpret_cast<const uint32_t*>(st)[2 * ((col_row_hi(g, ct, e) << log_c) + ct.c)];
    __syncthreads();
    if (bb + G < B)
      stage_coeffs(st, x, ((size_t)(bb + G) * L + g.l) * n, rank << log_c, g, log_c);
#else
    copy16(a, nxt);
    if (bb + G < B) load_coeffs(nxt, x, ((size_t)(bb + G) * L + g.l) * n, col, g, ct);
#endif
    enter16(a, g);
    if (g.lazy) fwd_col_phase<true>(a, cb, g, ct, log_c);
    else fwd_col_phase<false>(a, cb, g, ct, log_c);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = col_row_lo(ct, e);
      uint32_t* theirs = cluster.map_shared_rank(recv + (k & 1) * padded, r >> log_rows);
      theirs[rows_pad(((r & ((1 << log_rows) - 1)) << g.log_nb) + col)] = a[e];
    }
  };
  if (b < B) produce(b, 0);
  cluster_arrive();
  for (int k = 0; b < B; b += G, ++k) {
    cluster_wait();
    if (b + G < B) produce(b + G, k + 1);
    const uint32_t* mine = recv + (k & 1) * padded;
#pragma unroll
    for (int e = 0; e < 16; ++e) a[e] = mine[rows_pad(row_word_hi(e))];
    cluster_arrive();
    if (g.lazy) fwd_row_phase<true>(a, xb, g, rt, tw_lo);
    else fwd_row_phase<false>(a, xb, g, rt, tw_lo);
    store_slots(a, y, ((size_t)b * L + g.l) * n, base, g);
  }
  cluster_wait();
}

__global__ void __launch_bounds__(kLargeThreads)
ntt_inv_cluster_kernel(const int64_t* __restrict__ y, int64_t* __restrict__ x,
                       const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
                       const int32_t* __restrict__ limbs, int L, int B, int log_n,
                       int log_na, int log_c, int log_n1) {
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int log_k = log_n - log_na - log_c;
  const int rank = (int)cluster.block_rank();
  const Large g = large_of(tw, consts, limbs, blockIdx.x >> log_k, log_n, log_na, log_n1, true);
  const int tile = 1 << (log_na + log_c), base = rank * tile;
  ColThread ct;
  RowThread rt;
  uint2 tw_lo[kSlots];
  uint32_t* p = sm + col_setup(g, log_c, true, sm, ct);
  p += row_setup(g, base, tile, p, rt, tw_lo);
  const int tw_ = tile_words(log_na, log_c);
  uint32_t* recv = p;                                // 2 x tile: my columns, pushed by all
  uint32_t* cb = recv + 2 * tw_;                     // tile: the column exchange
  uint32_t* xb = cb + tw_;                           // tile + tile/16: the row exchange
  const int col = (rank << log_c) + ct.c;
  const size_t n = (size_t)1 << log_n;
  const int G = gridDim.y;
  uint32_t a[16], nxt[16];
  int b = blockIdx.y;
  if (b < B) load_slots(nxt, y, ((size_t)b * L + g.l) * n, base, g);
  cluster.sync();
  auto produce = [&](int bb, int k) {                // row phase of polynomial bb
    copy16(a, nxt);
    if (bb + G < B) load_slots(nxt, y, ((size_t)(bb + G) * L + g.l) * n, base, g);
    enter16(a, g);
    if (g.lazy) inv_row_phase<true>(a, xb, g, rt, tw_lo);
    else inv_row_phase<false>(a, xb, g, rt, tw_lo);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int j = base + row_word_hi(e);
      const int r = j >> g.log_nb, cc = j & ((1 << g.log_nb) - 1);
      uint32_t* theirs = cluster.map_shared_rank(recv + (k & 1) * tw_, cc >> log_c);
      theirs[col_at(r, cc & ((1 << log_c) - 1), log_c)] = a[e];
    }
  };
  if (b < B) produce(b, 0);
  cluster_arrive();
  for (int k = 0; b < B; b += G, ++k) {
    cluster_wait();
    if (b + G < B) produce(b + G, k + 1);
    const uint32_t* mine = recv + (k & 1) * tw_;
#pragma unroll
    for (int e = 0; e < 16; ++e) a[e] = mine[col_at(col_row_lo(ct, e), ct.c, log_c)];
    cluster_arrive();
    if (g.lazy) inv_col_phase<true>(a, cb, g, ct, log_c);
    else inv_col_phase<false>(a, cb, g, ct, log_c);
    store_coeffs(a, x, ((size_t)b * L + g.l) * n, col, g, ct);
  }
  cluster_wait();
}

// ---- one-block form: one CTA holds the whole vector, n <= 8192 -------------
// The cluster kernels with a cluster of one: the column phase and the row
// phase run back to back on the whole vector (one column tile of nb columns,
// one row chunk of n words), the exchange between them through the CTA's own
// shared memory and a __syncthreads.  n/16 threads, 16 elements a thread.
//
// The split per ring, na = 16 up to n = 4096 and 32 at n = 8192 (the caller
// passes it: ops/ntt_cuda.py:one_block_split), puts the highest four stages
// into the column phase's first round and leaves the row phase at most eight,
// so that a round is either full or the only short one:
//   n = 256   16 x 16    rounds of 4 + 4 stages            (1 exchange)
//   n = 512   16 x 32    4 + 1 + 4                         (2)
//   n = 1024  16 x 64    4 + 2 + 4                         (2)
//   n = 2048  16 x 128   4 + 3 + 4                         (2)
//   n = 4096  16 x 256   4 + 4 + 4                         (2)
//   n = 8192  32 x 256   4 + 1 + 4 + 4                     (3)
// A round that has no stage is left out with its exchange: the column
// phase's second round unless na = 32 (at na = 16 both rounds hold the same
// rows), the row phase's first round at n = 256.  The kernels are templates
// on the count of rounds (2, 3 or 4), so a launch carries only the code its
// ring runs.  A launch in the middle of a rotation finds the instruction
// caches cold: with all rings in one kernel (113 KB of code) a 31-bit limb's
// launch of (2, 1, 4096), whose strict butterflies came last in it, took 17-20
// us after other kernels on an H100 against 7-8 in a loop of its own; with the
// kernel of its ring alone it takes 7-8 in both (time_ntt.py --cold).
//
// What bounds it on this card: at (21, 22, 4096) the 30 MB of input and
// output stay in the L2, and the n/2·log2 n butterflies on the integer pipes
// (64 lanes per SM) take longer than the bytes; a launch of a few vectors is
// a chain of latencies.  So the design is about few instructions and few
// dependent trips:
//  * Stages in register rounds, 2-3 barriers a transform instead of one per
//    stage; every exchange free of bank conflicts from n = 512 up (padded by
//    16 words in 256 between the phases, by one in 16 inside the row phase,
//    unpadded between the column rounds, where a warp holds 32 adjacent
//    columns).  The exchanges alternate between two buffers, so one barrier
//    per exchange is enough: a thread that writes a buffer again has passed
//    the barrier of the exchange in between, which every thread reaches only
//    after its reads of that buffer.
//  * Twiddles once per CTA.  A CTA owns one limb and loops over the
//    polynomials b = blockIdx.y, blockIdx.y + gridDim.y, ...: the last
//    round's 15 (w, w') pairs in registers, the other rounds' in shared
//    memory (read as broadcasts).
//  * Loads up front.  The first polynomial's 16 words are requested before
//    the limb id is looked up, the thread's own twiddles before the shared
//    ones are staged, the next polynomial's words before the current one's
//    rounds; only the low word of each int64 residue is loaded.
//  * No slot table: slot_of, as in the large-ring kernels.  With n1 = 128 (every
//    n <= 8192) a warp stores a register as four runs of eight consecutive
//    slots, whole 32-byte sectors.
//  * Lazy butterflies for q < 2^30, strict ones for a 31-bit prime, by limb.

struct OneBlock {
  ColThread ct;
  RowThread rt;
  uint32_t* bufs;      // two exchange buffers of `padded` words each
  int padded, flip;
};

// A CTA's twiddles, after tables_of.  Shared memory: [column tw][row tw]
// [2 x (n + n/16) exchange words].
__device__ __forceinline__ void one_block_setup(const Large& g, bool inverse, uint32_t* sm,
                                                OneBlock& ob, uint2 (&tw_lo)[kSlots]) {
  const int n = 1 << g.log_n;
  ob.rt.mask_hi = stage_mask(4, 0, g.log_nb - 1);
  ob.rt.mask_lo = stage_mask(0, 0, g.log_nb - 1);
#pragma unroll
  for (int k = 0; k < kSlots; ++k)      // requested before the shared ones are waited for
    tw_lo[k] = load_tw(g.w, g.ws, g.log_n, threadIdx.x * 16, 0, ob.rt.mask_lo, k);
  uint32_t* p = sm + col_setup(g, g.log_nb, inverse, sm, ob.ct);
  uint2* tws = reinterpret_cast<uint2*>(p);
  stage_tw(tws, n >> 8, 0, 256, 4, ob.rt.mask_hi, g.w, g.ws, g.log_n);
  ob.rt.tw_hi = tws + kSlots * (threadIdx.x >> 4);
  ob.bufs = p + 2 * kSlots * (n >> 8);
  ob.padded = n + (n >> 4);
  ob.flip = 0;
}

__device__ __forceinline__ uint32_t* next_buf(OneBlock& ob) {
  ob.flip ^= 1;
  return ob.bufs + ob.flip * ob.padded;
}

// Word of network position (row r, column c) between the phases.
__device__ __forceinline__ int between(const Large& g, int r, int c) {
  return rows_pad((r << g.log_nb) + c);
}

// a: rows of the column phase's hi round on entry, words of the row phase's
// lo round on exit.  ROUNDS: 2 at n = 256, 3 up to n = 4096, 4 at n = 8192.
template <bool LAZY, int ROUNDS>
__device__ __forceinline__ void fwd_one_block(uint32_t (&a)[16], OneBlock& ob, const Large& g,
                                              const uint2 (&tw_lo)[kSlots]) {
  if (ROUNDS == 4) fwd_col_phase<LAZY>(a, next_buf(ob), g, ob.ct, g.log_nb);
  else ct_round<LAZY>(a, ob.ct.tw_hi, ob.ct.mask_hi, g.q);
  uint32_t* buf = next_buf(ob);
#pragma unroll
  for (int e = 0; e < 16; ++e) buf[between(g, col_row_lo(ob.ct, e), ob.ct.c)] = a[e];
  __syncthreads();
  if (ROUNDS >= 3) {
#pragma unroll
    for (int e = 0; e < 16; ++e) a[e] = buf[rows_pad(row_word_hi(e))];
    fwd_row_phase<LAZY>(a, next_buf(ob), g, ob.rt, tw_lo);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) a[e] = buf[rows_pad(row_word_lo(e))];
    ct_round<LAZY>(a, tw_lo, ob.rt.mask_lo, g.q);
  }
}

// a: words of the row phase's lo round on entry, rows of the column phase's
// hi round on exit.
template <bool LAZY, int ROUNDS>
__device__ __forceinline__ void inv_one_block(uint32_t (&a)[16], OneBlock& ob, const Large& g,
                                              const uint2 (&tw_lo)[kSlots]) {
  uint32_t* buf;
  if (ROUNDS >= 3) {
    inv_row_phase<LAZY>(a, next_buf(ob), g, ob.rt, tw_lo);
    buf = next_buf(ob);
#pragma unroll
    for (int e = 0; e < 16; ++e) buf[rows_pad(row_word_hi(e))] = a[e];
  } else {
    gs_round<LAZY>(a, tw_lo, ob.rt.mask_lo, g.q);
    buf = next_buf(ob);
#pragma unroll
    for (int e = 0; e < 16; ++e) buf[rows_pad(row_word_lo(e))] = a[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = buf[between(g, col_row_lo(ob.ct, e), ob.ct.c)];
  if (ROUNDS == 4) inv_col_phase<LAZY>(a, next_buf(ob), g, ob.ct, g.log_nb);
  else gs_round<LAZY>(a, ob.ct.tw_lo, ob.ct.mask_lo, g.q);
}

template <int ROUNDS>
__global__ void __launch_bounds__(ROUNDS == 4 ? 512 : 256, ROUNDS == 4 ? 1 : 2)
ntt_fwd_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ y,
               const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
               const int32_t* __restrict__ limbs, int L, int B, int log_n, int log_na,
               int log_n1) {
  extern __shared__ uint32_t sm[];
  Large g = geometry_of(blockIdx.x, log_n, log_na, log_n1);
  OneBlock ob;
  ob.ct.xr = threadIdx.x >> g.log_nb;
  ob.ct.c = threadIdx.x & ((1 << g.log_nb) - 1);
  const size_t n = (size_t)1 << log_n;
  const int G = gridDim.y;
  uint32_t a[16], nxt[16];
  int b = blockIdx.y;
  if (b < B) load_coeffs(nxt, x, ((size_t)b * L + g.l) * n, ob.ct.c, g, ob.ct);
  tables_of(g, tw, consts, limbs, false);
  uint2 tw_lo[kSlots];
  one_block_setup(g, false, sm, ob, tw_lo);
  __syncthreads();
  for (; b < B; b += G) {
    copy16(a, nxt);
    if (b + G < B) load_coeffs(nxt, x, ((size_t)(b + G) * L + g.l) * n, ob.ct.c, g, ob.ct);
    enter16(a, g);
    if (g.lazy) fwd_one_block<true, ROUNDS>(a, ob, g, tw_lo);
    else fwd_one_block<false, ROUNDS>(a, ob, g, tw_lo);
    store_slots(a, y, ((size_t)b * L + g.l) * n, 0, g);
  }
}

template <int ROUNDS>
__global__ void __launch_bounds__(ROUNDS == 4 ? 512 : 256, ROUNDS == 4 ? 1 : 2)
ntt_inv_kernel(const int64_t* __restrict__ y, int64_t* __restrict__ x,
               const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
               const int32_t* __restrict__ limbs, int L, int B, int log_n, int log_na,
               int log_n1) {
  extern __shared__ uint32_t sm[];
  Large g = geometry_of(blockIdx.x, log_n, log_na, log_n1);
  const size_t n = (size_t)1 << log_n;
  const int G = gridDim.y;
  uint32_t a[16], nxt[16];
  int b = blockIdx.y;
  if (b < B) load_slots(nxt, y, ((size_t)b * L + g.l) * n, 0, g);
  tables_of(g, tw, consts, limbs, true);
  OneBlock ob;
  uint2 tw_lo[kSlots];
  one_block_setup(g, true, sm, ob, tw_lo);
  __syncthreads();
  for (; b < B; b += G) {
    copy16(a, nxt);
    if (b + G < B) load_slots(nxt, y, ((size_t)(b + G) * L + g.l) * n, 0, g);
    enter16(a, g);
    if (g.lazy) inv_one_block<true, ROUNDS>(a, ob, g, tw_lo);
    else inv_one_block<false, ROUNDS>(a, ob, g, tw_lo);
    store_coeffs(a, x, ((size_t)b * L + g.l) * n, ob.ct.c, g, ob.ct);
  }
}

// Opt-in dynamic shared memory (above 48 KB) and the non-portable cluster
// size are attributes of a kernel on a device: asked for once, not per launch.
struct Grant {
  size_t smem = 48 * 1024;
  bool big_cluster = false;
};

cudaError_t grant(const void* kernel, size_t smem, int cluster) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, Grant> grants;
  if (smem <= 48 * 1024 && cluster <= 8) return cudaSuccess;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  Grant& have = grants[std::make_pair(kernel, device)];
  if (smem > have.smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    have.smem = smem;
  }
  if (cluster > 8 && !have.big_cluster) {  // above the portable size: the H100 takes 16
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    have.big_cluster = true;
  }
  return cudaSuccess;
}

// Launch with `smem` bytes of dynamic shared memory and, where cluster > 0,
// as thread-block clusters of that many CTAs along x.
template <typename Kernel, typename... Args>
int launch_large(Kernel kernel, dim3 grid, int threads, size_t smem, int cluster,
                 void* stream, Args... args) {
  const cudaError_t granted = grant(reinterpret_cast<const void*>(kernel), smem, cluster);
  if (granted != cudaSuccess) return (int)granted;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  if (cluster > 0) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

size_t col_tw_bytes(int log_na) { return sizeof(uint2) * kSlots * (1 + (1 << (log_na - 4))); }
size_t row_tw_bytes(int elems) { return sizeof(uint2) * kSlots * (elems >> 8); }
size_t padded_bytes(int elems) { return sizeof(uint32_t) * (elems + (elems >> 4)); }

int launch_col(bool inverse, const void* in, void* out, const void* tw,
               const void* consts, const void* limbs, int L, int B, int G,
               int log_n, int log_na, int log_c, void* stream) {
  const int tile = 1 << (log_na + log_c);
  const dim3 grid(L << (log_n - log_na - log_c), G);
  const size_t smem = col_tw_bytes(log_na) + 2 * tile_words(log_na, log_c) * sizeof(uint32_t);
  if (inverse)
    return launch_large(ntt_inv_col_kernel, grid, tile / 16, smem, 0, stream,
                        (const uint32_t*)in, (int64_t*)out, (const uint32_t*)tw,
                        (const uint32_t*)consts, (const int32_t*)limbs, L, B, log_n,
                        log_na, log_c);
  return launch_large(ntt_fwd_col_kernel, grid, tile / 16, smem, 0, stream,
                      (const int64_t*)in, (uint32_t*)out, (const uint32_t*)tw,
                      (const uint32_t*)consts, (const int32_t*)limbs, L, B, log_n,
                      log_na, log_c);
}

int launch_row(bool inverse, const void* in, void* out, const void* tw,
               const void* consts, const void* limbs, int L, int B, int G,
               int log_n, int log_na, int log_chunk, int log_n1, void* stream) {
  const int chunk = 1 << log_chunk;
  const dim3 grid(L << (log_n - log_chunk), G);
  const size_t smem = row_tw_bytes(chunk) + 2 * padded_bytes(chunk);
  if (inverse)
    return launch_large(ntt_inv_row_kernel, grid, chunk / 16, smem, 0, stream,
                        (const int64_t*)in, (uint32_t*)out, (const uint32_t*)tw,
                        (const uint32_t*)consts, (const int32_t*)limbs, L, B, log_n,
                        log_na, log_chunk, log_n1);
  return launch_large(ntt_fwd_row_kernel, grid, chunk / 16, smem, 0, stream,
                      (const uint32_t*)in, (int64_t*)out, (const uint32_t*)tw,
                      (const uint32_t*)consts, (const int32_t*)limbs, L, B, log_n,
                      log_na, log_chunk, log_n1);
}

int launch_cluster(bool inverse, const void* in, void* out, const void* tw,
                   const void* consts, const void* limbs, int L, int B, int G,
                   int log_n, int log_na, int log_c, int log_n1, void* stream) {
  const int tile = 1 << (log_na + log_c);
  const int k = 1 << (log_n - log_na - log_c);
  const dim3 grid(L * k, G);
  const size_t tw_bytes = col_tw_bytes(log_na) + row_tw_bytes(tile);
  const size_t tile_bytes = tile_words(log_na, log_c) * sizeof(uint32_t);
  size_t smem = tw_bytes + tile_bytes + padded_bytes(tile) +
      2 * (inverse ? tile_bytes : padded_bytes(tile));
#ifdef RFHE_NTT_CLUSTER_CP_ASYNC
  if (!inverse) smem += (size_t)tile * sizeof(int64_t);
#endif
  return launch_large(inverse ? ntt_inv_cluster_kernel : ntt_fwd_cluster_kernel, grid,
                      tile / 16, smem, k, stream, (const int64_t*)in, (int64_t*)out,
                      (const uint32_t*)tw, (const uint32_t*)consts,
                      (const int32_t*)limbs, L, B, log_n, log_na, log_c, log_n1);
}

template <int ROUNDS>
int launch_rounds(bool inverse, const void* in, void* out, const void* tw,
                  const void* consts, const void* limbs, int L, int B, int G,
                  int log_n, int log_na, int log_n1, void* stream) {
  const int n = 1 << log_n;
  const size_t smem = col_tw_bytes(log_na) + row_tw_bytes(n) + 2 * padded_bytes(n);
  return launch_large(inverse ? ntt_inv_kernel<ROUNDS> : ntt_fwd_kernel<ROUNDS>, dim3(L, G),
                      n / 16, smem, 0, stream, (const int64_t*)in, (int64_t*)out,
                      (const uint32_t*)tw, (const uint32_t*)consts, (const int32_t*)limbs, L, B,
                      log_n, log_na, log_n1);
}

int launch_one_block(bool inverse, const void* in, void* out, const void* tw,
                     const void* consts, const void* limbs, int L, int B, int G,
                     int log_n, int log_na, int log_n1, void* stream) {
  // the split that the kernels' rounds assume (ops/ntt_cuda.py:one_block_split)
  if (log_n < 8 || log_n > 13 || log_na != (log_n == 13 ? 5 : 4)) return (int)cudaErrorInvalidValue;
  auto launch = log_n == 8 ? launch_rounds<2> : log_n == 13 ? launch_rounds<4> : launch_rounds<3>;
  return launch(inverse, in, out, tw, consts, limbs, L, B, G, log_n, log_na, log_n1, stream);
}

// A span boundary of trace/spans.py, in stream order: not part of any
// transform.  acc holds three int64 words per span (the time it last opened,
// the nanoseconds it has been open, the times it closed); bit i of `closes`
// and `opens` is span i.  One thread reads the card's nanosecond clock, adds
// the time since its opening to each span it closes and counts it, then
// stamps each span it opens.  Kernels of one stream run one after another,
// so the time between two marks is the work enqueued between them.
__global__ void rfhe_span_mark(int64_t* acc, uint64_t closes, uint64_t opens) {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  for (uint64_t m = closes; m; m &= m - 1) {
    int64_t* span = acc + 3 * (__ffsll((long long)m) - 1);
    span[1] += (int64_t)now - span[0];
    span[2] += 1;
  }
  for (uint64_t m = opens; m; m &= m - 1) acc[3 * (__ffsll((long long)m) - 1)] = (int64_t)now;
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller checks shapes and the tile
// geometry (ops/ntt_cuda.py).  G is the number of polynomial groups (grid.y);
// a CTA transforms the polynomials g, g + G, ... of its limb (and tile).
// One-block form, 256 <= n <= 8192: grid (L, G), n/16 threads.
int rfhe_ntt_fwd(const void* x, void* y, const void* tw, const void* consts,
                 const void* limbs, int L, int B, int G, int log_n, int log_na,
                 int log_n1, void* stream) {
  return launch_one_block(false, x, y, tw, consts, limbs, L, B, G, log_n, log_na, log_n1,
                          stream);
}

int rfhe_ntt_inv(const void* y, void* x, const void* tw, const void* consts,
                 const void* limbs, int L, int B, int G, int log_n, int log_na,
                 int log_n1, void* stream) {
  return launch_one_block(true, y, x, tw, consts, limbs, L, B, G, log_n, log_na, log_n1,
                          stream);
}

// Large-ring form.
// Two passes, one entry point each.  Forward: col then row; inverse: row
// then col.  Column passes: grid (L·nb/C, G); row passes: grid (L·n/chunk, G).
int rfhe_ntt_fwd_col(const void* x, void* tmp, const void* tw, const void* consts,
                     const void* limbs, int L, int B, int G, int log_n, int log_na,
                     int log_c, void* stream) {
  return launch_col(false, x, tmp, tw, consts, limbs, L, B, G, log_n, log_na, log_c, stream);
}

int rfhe_ntt_fwd_row(const void* tmp, void* y, const void* tw, const void* consts,
                     const void* limbs, int L, int B, int G, int log_n, int log_na,
                     int log_chunk, int log_n1, void* stream) {
  return launch_row(false, tmp, y, tw, consts, limbs, L, B, G, log_n, log_na, log_chunk,
                    log_n1, stream);
}

int rfhe_ntt_inv_row(const void* y, void* tmp, const void* tw, const void* consts,
                     const void* limbs, int L, int B, int G, int log_n, int log_na,
                     int log_chunk, int log_n1, void* stream) {
  return launch_row(true, y, tmp, tw, consts, limbs, L, B, G, log_n, log_na, log_chunk,
                    log_n1, stream);
}

int rfhe_ntt_inv_col(const void* tmp, void* x, const void* tw, const void* consts,
                     const void* limbs, int L, int B, int G, int log_n, int log_na,
                     int log_c, void* stream) {
  return launch_col(true, tmp, x, tw, consts, limbs, L, B, G, log_n, log_na, log_c, stream);
}

// One trip: clusters of nb/C CTAs, grid (L·nb/C, G).
int rfhe_ntt_fwd_cluster(const void* x, void* y, const void* tw, const void* consts,
                         const void* limbs, int L, int B, int G, int log_n, int log_na,
                         int log_c, int log_n1, void* stream) {
  return launch_cluster(false, x, y, tw, consts, limbs, L, B, G, log_n, log_na, log_c,
                        log_n1, stream);
}

int rfhe_ntt_inv_cluster(const void* y, void* x, const void* tw, const void* consts,
                         const void* limbs, int L, int B, int G, int log_n, int log_na,
                         int log_c, int log_n1, void* stream) {
  return launch_cluster(true, y, x, tw, consts, limbs, L, B, G, log_n, log_na, log_c,
                        log_n1, stream);
}

// One span boundary (rfhe_span_mark above): one thread on `stream`.
int rfhe_span_mark_launch(void* acc, uint64_t closes, uint64_t opens, void* stream) {
  rfhe_span_mark<<<1, 1, 0, (cudaStream_t)stream>>>((int64_t*)acc, closes, opens);
  return (int)cudaGetLastError();
}

}  // extern "C"
