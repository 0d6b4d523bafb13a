// Negacyclic NTT kernels for Hopper (sm_90a), in two forms: one CTA per
// (poly, limb) with the whole vector in shared memory, and a large-ring form
// in two passes through global memory.
//
// Replace the two Pallas kernels of the JAX package:
//   rfhe_ntt_fwd, rfhe_ntt_fwd_col + rfhe_ntt_fwd_row
//                 <- rfhe_tpu/ops/ntt_fused.py:_fwd_kernel
//   rfhe_ntt_inv, rfhe_ntt_inv_row + rfhe_ntt_inv_col
//                 <- rfhe_tpu/ops/ntt_fused.py:_inv_kernel
// Those run a four-step transform on int8 digit matmuls for the TPU's MXU.
// The map they compute is fixed and exact, so these kernels compute it
// another way and stay bit-identical.  For limb l with prime q, ψ the
// negacyclic root and R = 2^32 mod q:
//   fwd: y[p] = R · Σ_t x[t] · ψ^((2·nu[p]+1)·t)                  mod q
//   inv: x[t] = n⁻¹ · R⁻¹ · Σ_p y[p] · ψ^(−(2·nu[p]+1)·t)          mod q
// with the reference's slot order nu (rfhe_tpu/ops/ntt_mxu.py:237-240).
//
// One-block form: the n-coefficient vector of one (poly, limb) sits in shared
// memory as uint32 (16 KB at n = 4096; 64 KB and 128 KB at n = 16384 and
// 32768, which the launch asks for as opt-in dynamic shared memory).  The forward pass is an in-place
// Cooley-Tukey network on bit-reversed ψ powers; the inverse pass is the
// mirrored Gentleman-Sande network on ψ^-1 powers.  Every product is a
// Shoup multiplication on __umulhi (q < 2^31, residues kept canonical).
// The forward store applies R and writes slot p from position
// pos[p] = brev(nu[p]); the inverse load reads slot p into that position and
// its store applies n⁻¹·R⁻¹.  Per-limb tables are indexed by a limb-id
// array, so a plan over any subset of the chain shares one set of tables.
//
// What bounds it on this card: at n = 4096 each CTA does 12 butterfly
// stages separated by __syncthreads, on 2048 butterflies each, and reads
// its input and writes its output once (8 bytes per int64 element).  The
// arithmetic is small; the kernel is latency- and shared-memory-bound (the
// stage barriers and the shared-memory traffic of each stage), which is
// why it runs 512 threads per CTA and keeps several CTAs resident per SM.
// Above 48 KB of shared memory one to three CTAs are resident per SM and run
// 1024 threads: at n = 16384 that is still the faster form on an H100, at
// n = 32768 (one CTA per SM, 15 serial stages) the large-ring form below is;
// n = 65536 (256 KB) does not fit and has no choice.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;       // one-block form, n <= 8192
constexpr int kThreadsBig = 1024;   // one-block form above 48 KB of shared memory

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

// Cooley-Tukey butterfly (forward) and Gentleman-Sande butterfly (inverse)
// on two shared-memory words.
__device__ __forceinline__ void ct_butterfly(uint32_t* a, int j1, int j2,
                                             uint32_t w, uint32_t ws, uint32_t q) {
  const uint32_t u = a[j1];
  const uint32_t v = mul_shoup(a[j2], w, ws, q);
  a[j1] = add_q(u, v, q);
  a[j2] = sub_q(u, v, q);
}

__device__ __forceinline__ void gs_butterfly(uint32_t* a, int j1, int j2,
                                             uint32_t w, uint32_t ws, uint32_t q) {
  const uint32_t u = a[j1], v = a[j2];
  a[j1] = add_q(u, v, q);
  a[j2] = mul_shoup(sub_q(u, v, q), w, ws, q);
}

// tw:     (Lf, 4, n) uint32 [ψ^brev, Shoup, ψ^-brev, Shoup] per chain limb
// consts: (Lf, 8) uint32 [q, R, R', n⁻¹R⁻¹, (n⁻¹R⁻¹)', 0, 0, 0]
// pos:    (n,) brev(nu[p]);  limbs: (L,) chain index of each limb
// x, y:   (B, L, n) int64, canonical residues
__global__ void __launch_bounds__(kThreadsBig)
ntt_fwd_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ y,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ consts,
               const int32_t* __restrict__ pos,
               const int32_t* __restrict__ limbs, int L, int log_n) {
  extern __shared__ uint32_t a[];
  const int n = 1 << log_n;
  const int l = blockIdx.x;
  const int lid = limbs[l];
  const uint32_t* psi = tw + (size_t)lid * 4 * n;
  const uint32_t* psi_s = psi + n;
  const uint32_t* c = consts + (size_t)lid * 8;
  const uint32_t q = c[0];
  const size_t off = ((size_t)blockIdx.y * L + l) * n;

  for (int t = threadIdx.x; t < n; t += blockDim.x) a[t] = (uint32_t)x[off + t];
  __syncthreads();
  for (int s = 0; s < log_n; ++s) {
    const int hs = log_n - 1 - s;  // half-size 2^hs, 2^s groups
    for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) {
      const int i = k >> hs;
      const int j1 = (i << (hs + 1)) + (k & ((1 << hs) - 1));
      const int j2 = j1 + (1 << hs);
      ct_butterfly(a, j1, j2, psi[(1 << s) + i], psi_s[(1 << s) + i], q);
    }
    __syncthreads();
  }
  const uint32_t r = c[1], r_s = c[2];
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    y[off + p] = (int64_t)mul_shoup(a[pos[p]], r, r_s, q);
}

__global__ void __launch_bounds__(kThreadsBig)
ntt_inv_kernel(const int64_t* __restrict__ y, int64_t* __restrict__ x,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ consts,
               const int32_t* __restrict__ pos,
               const int32_t* __restrict__ limbs, int L, int log_n) {
  extern __shared__ uint32_t a[];
  const int n = 1 << log_n;
  const int l = blockIdx.x;
  const int lid = limbs[l];
  const uint32_t* psi_inv = tw + (size_t)lid * 4 * n + 2 * (size_t)n;
  const uint32_t* psi_inv_s = psi_inv + n;
  const uint32_t* c = consts + (size_t)lid * 8;
  const uint32_t q = c[0];
  const size_t off = ((size_t)blockIdx.y * L + l) * n;

  for (int p = threadIdx.x; p < n; p += blockDim.x) a[pos[p]] = (uint32_t)y[off + p];
  __syncthreads();
  for (int s = 0; s < log_n; ++s) {
    const int hg = log_n - 1 - s;  // 2^hg groups, half-size 2^s
    for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) {
      const int i = k >> s;
      const int j1 = (i << (s + 1)) + (k & ((1 << s) - 1));
      const int j2 = j1 + (1 << s);
      gs_butterfly(a, j1, j2, psi_inv[(1 << hg) + i], psi_inv_s[(1 << hg) + i], q);
    }
    __syncthreads();
  }
  const uint32_t f = c[3], f_s = c[4];
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    x[off + t] = (int64_t)mul_shoup(a[t], f, f_s, q);
}

// ---------------------------------------------------------------------------
// Large-ring form: n = na·nb, two passes through global memory.
//
// The radix-2 network splits at n = na·nb (element j = r·nb + c).  The first
// log2(na) Cooley-Tukey stages pair elements of one column c (distance a
// multiple of nb) with twiddles that depend on the row pair only; the last
// log2(nb) stages stay inside a contiguous row of nb elements.  So the forward
// transform is a column pass (a size-na network down every column, on the
// first na entries of the same ψ table), a uint32 intermediate in global
// memory, and a row pass that finishes the network on contiguous chunks,
// applies R and scatters slot pos_inv[j] = nu⁻¹(brev(j)).  The inverse mirrors
// it: gather through pos_inv, row pass of Gentleman-Sande stages, intermediate,
// column pass, n⁻¹R⁻¹ at the store.  Tables, arithmetic and stage order are
// those of the one-block kernels, so the outputs are bit-identical.
//
// What bounds it on this card: bytes.  A transform must read 8 and write 8
// bytes per int64 element; this form adds 4 + 4 for the intermediate
// (24 against 16), which stays in the 50 MB L2 only for small batches.  The
// arithmetic (n/2·log2 n Shoup butterflies) is several times below the
// integer rate that those bytes allow.  What the design does about it: the
// column pass holds a tile of `C` adjacent columns × na rows, so every global
// access is a run of C consecutive words (256 B at C = 32) and consecutive
// threads hit consecutive shared-memory banks; the intermediate is uint32,
// half the width of the residues; each pass keeps its tile in shared memory
// for all of its stages, so global memory is touched once per pass.  The slot
// scatter of the forward row pass (gather in the inverse) goes through a
// table and writes 8-byte words 64 B apart inside one 1-2 KB output row;
// L2 merges them.
//
// tmp:     (B, L, n) uint32 intermediate, natural order j = r·nb + c
// pos_inv: (n,) int32, slot of network position j
// log_c:   column tile width C = 2^log_c <= nb, na·C·4 bytes of shared memory
// log_chunk: row-pass chunk 2^log_chunk, a multiple of nb, <= n
// Grid: x = limb·tiles + tile, y = poly.
// ---------------------------------------------------------------------------

constexpr int kPassThreads = 512;

__global__ void __launch_bounds__(kPassThreads)
ntt_fwd_col_kernel(const int64_t* __restrict__ x, uint32_t* __restrict__ tmp,
                   const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ consts,
                   const int32_t* __restrict__ limbs, int L, int log_n,
                   int log_na, int log_c) {
  extern __shared__ uint32_t a[];  // (na, C)
  const int n = 1 << log_n, log_nb = log_n - log_na;
  const int cmask = (1 << log_c) - 1;
  const int tiles = 1 << (log_nb - log_c);
  const int l = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) << log_c;
  const int lid = limbs[l];
  const uint32_t* psi = tw + (size_t)lid * 4 * n;
  const uint32_t* psi_s = psi + n;
  const uint32_t q = consts[(size_t)lid * 8];
  const size_t off = ((size_t)blockIdx.y * L + l) * n + c0;
  const int tile = 1 << (log_na + log_c);

  for (int t = threadIdx.x; t < tile; t += blockDim.x)
    a[t] = (uint32_t)x[off + ((size_t)(t >> log_c) << log_nb) + (t & cmask)];
  __syncthreads();
  for (int s = 0; s < log_na; ++s) {
    const int hs = log_na - 1 - s;  // half-size 2^hs rows, 2^s groups
    for (int k = threadIdx.x; k < (tile >> 1); k += blockDim.x) {
      const int kr = k >> log_c;
      const int i = kr >> hs;
      const int r1 = (i << (hs + 1)) + (kr & ((1 << hs) - 1));
      const int j1 = (r1 << log_c) + (k & cmask);
      ct_butterfly(a, j1, j1 + (1 << (hs + log_c)), psi[(1 << s) + i],
                   psi_s[(1 << s) + i], q);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x)
    tmp[off + ((size_t)(t >> log_c) << log_nb) + (t & cmask)] = a[t];
}

__global__ void __launch_bounds__(kPassThreads)
ntt_fwd_row_kernel(const uint32_t* __restrict__ tmp, int64_t* __restrict__ y,
                   const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ consts,
                   const int32_t* __restrict__ pos_inv,
                   const int32_t* __restrict__ limbs, int L, int log_n,
                   int log_na, int log_chunk) {
  extern __shared__ uint32_t a[];  // (chunk,)
  const int n = 1 << log_n, chunk = 1 << log_chunk;
  const int chunks = 1 << (log_n - log_chunk);
  const int l = blockIdx.x / chunks;
  const int base = (blockIdx.x % chunks) << log_chunk;
  const int lid = limbs[l];
  const uint32_t* psi = tw + (size_t)lid * 4 * n;
  const uint32_t* psi_s = psi + n;
  const uint32_t* c = consts + (size_t)lid * 8;
  const uint32_t q = c[0];
  const size_t off = ((size_t)blockIdx.y * L + l) * n;

  for (int t = threadIdx.x; t < chunk; t += blockDim.x) a[t] = tmp[off + base + t];
  __syncthreads();
  for (int s = log_na; s < log_n; ++s) {
    const int hs = log_n - 1 - s;  // half-size 2^hs < nb
    for (int kl = threadIdx.x; kl < (chunk >> 1); kl += blockDim.x) {
      const int k = (base >> 1) + kl;  // butterfly index in the whole vector
      const int i = k >> hs;
      const int j1 = (i << (hs + 1)) + (k & ((1 << hs) - 1)) - base;
      ct_butterfly(a, j1, j1 + (1 << hs), psi[(1 << s) + i], psi_s[(1 << s) + i], q);
    }
    __syncthreads();
  }
  const uint32_t r = c[1], r_s = c[2];
  for (int t = threadIdx.x; t < chunk; t += blockDim.x)
    y[off + pos_inv[base + t]] = (int64_t)mul_shoup(a[t], r, r_s, q);
}

__global__ void __launch_bounds__(kPassThreads)
ntt_inv_row_kernel(const int64_t* __restrict__ y, uint32_t* __restrict__ tmp,
                   const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ consts,
                   const int32_t* __restrict__ pos_inv,
                   const int32_t* __restrict__ limbs, int L, int log_n,
                   int log_na, int log_chunk) {
  extern __shared__ uint32_t a[];  // (chunk,)
  const int n = 1 << log_n, chunk = 1 << log_chunk;
  const int log_nb = log_n - log_na;
  const int chunks = 1 << (log_n - log_chunk);
  const int l = blockIdx.x / chunks;
  const int base = (blockIdx.x % chunks) << log_chunk;
  const int lid = limbs[l];
  const uint32_t* psi_inv = tw + (size_t)lid * 4 * n + 2 * (size_t)n;
  const uint32_t* psi_inv_s = psi_inv + n;
  const uint32_t q = consts[(size_t)lid * 8];
  const size_t off = ((size_t)blockIdx.y * L + l) * n;

  for (int t = threadIdx.x; t < chunk; t += blockDim.x)
    a[t] = (uint32_t)y[off + pos_inv[base + t]];
  __syncthreads();
  for (int s = 0; s < log_nb; ++s) {
    const int hg = log_n - 1 - s;  // 2^hg groups, half-size 2^s < nb
    for (int kl = threadIdx.x; kl < (chunk >> 1); kl += blockDim.x) {
      const int k = (base >> 1) + kl;
      const int i = k >> s;
      const int j1 = (i << (s + 1)) + (k & ((1 << s) - 1)) - base;
      gs_butterfly(a, j1, j1 + (1 << s), psi_inv[(1 << hg) + i],
                   psi_inv_s[(1 << hg) + i], q);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) tmp[off + base + t] = a[t];
}

__global__ void __launch_bounds__(kPassThreads)
ntt_inv_col_kernel(const uint32_t* __restrict__ tmp, int64_t* __restrict__ x,
                   const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ consts,
                   const int32_t* __restrict__ limbs, int L, int log_n,
                   int log_na, int log_c) {
  extern __shared__ uint32_t a[];  // (na, C)
  const int n = 1 << log_n, log_nb = log_n - log_na;
  const int cmask = (1 << log_c) - 1;
  const int tiles = 1 << (log_nb - log_c);
  const int l = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) << log_c;
  const int lid = limbs[l];
  const uint32_t* psi_inv = tw + (size_t)lid * 4 * n + 2 * (size_t)n;
  const uint32_t* psi_inv_s = psi_inv + n;
  const uint32_t* c = consts + (size_t)lid * 8;
  const uint32_t q = c[0];
  const size_t off = ((size_t)blockIdx.y * L + l) * n + c0;
  const int tile = 1 << (log_na + log_c);

  for (int t = threadIdx.x; t < tile; t += blockDim.x)
    a[t] = tmp[off + ((size_t)(t >> log_c) << log_nb) + (t & cmask)];
  __syncthreads();
  for (int sr = 0; sr < log_na; ++sr) {  // stage s = log_nb + sr, half 2^sr rows
    const int hg = log_na - 1 - sr;      // = log_n - 1 - s
    for (int k = threadIdx.x; k < (tile >> 1); k += blockDim.x) {
      const int kr = k >> log_c;
      const int i = kr >> sr;
      const int r1 = (i << (sr + 1)) + (kr & ((1 << sr) - 1));
      const int j1 = (r1 << log_c) + (k & cmask);
      gs_butterfly(a, j1, j1 + (1 << (sr + log_c)), psi_inv[(1 << hg) + i],
                   psi_inv_s[(1 << hg) + i], q);
    }
    __syncthreads();
  }
  const uint32_t f = c[3], f_s = c[4];
  for (int t = threadIdx.x; t < tile; t += blockDim.x)
    x[off + ((size_t)(t >> log_c) << log_nb) + (t & cmask)] =
        (int64_t)mul_shoup(a[t], f, f_s, q);
}

int launch(bool inverse, const void* in, void* out, const void* tw,
           const void* consts, const void* pos, const void* limbs, int L,
           int B, int log_n, void* stream) {
  const int n = 1 << log_n;
  const dim3 grid(L, B);
  const size_t smem = (size_t)n * sizeof(uint32_t);
  const bool big = smem > 48 * 1024;
  const int cap = big ? kThreadsBig : kThreads;
  const int threads = (n / 2) < cap ? (n / 2) : cap;
  auto kernel = inverse ? ntt_inv_kernel : ntt_fwd_kernel;
  if (big) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (const uint32_t*)tw,
      (const uint32_t*)consts, (const int32_t*)pos, (const int32_t*)limbs, L,
      log_n);
  return (int)cudaGetLastError();
}

int pass_threads(int elems) {
  return (elems / 2) < kPassThreads ? (elems / 2) : kPassThreads;
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller checks shapes and the tile
// geometry (ops/ntt_cuda.py).  One-block form: grid (L, B).
int rfhe_ntt_fwd(const void* x, void* y, const void* tw, const void* consts,
                 const void* pos, const void* limbs, int L, int B, int log_n,
                 void* stream) {
  return launch(false, x, y, tw, consts, pos, limbs, L, B, log_n, stream);
}

int rfhe_ntt_inv(const void* y, void* x, const void* tw, const void* consts,
                 const void* pos, const void* limbs, int L, int B, int log_n,
                 void* stream) {
  return launch(true, y, x, tw, consts, pos, limbs, L, B, log_n, stream);
}

// Large-ring form, one pass each.  Forward: col then row; inverse: row then
// col.  Column passes: grid (L·nb/C, B); row passes: grid (L·n/chunk, B).
int rfhe_ntt_fwd_col(const void* x, void* tmp, const void* tw,
                     const void* consts, const void* limbs, int L, int B,
                     int log_n, int log_na, int log_c, void* stream) {
  const dim3 grid(L << (log_n - log_na - log_c), B);
  const int tile = 1 << (log_na + log_c);
  ntt_fwd_col_kernel<<<grid, pass_threads(tile), tile * sizeof(uint32_t),
                       (cudaStream_t)stream>>>(
      (const int64_t*)x, (uint32_t*)tmp, (const uint32_t*)tw,
      (const uint32_t*)consts, (const int32_t*)limbs, L, log_n, log_na, log_c);
  return (int)cudaGetLastError();
}

int rfhe_ntt_fwd_row(const void* tmp, void* y, const void* tw,
                     const void* consts, const void* pos_inv,
                     const void* limbs, int L, int B, int log_n, int log_na,
                     int log_chunk, void* stream) {
  const dim3 grid(L << (log_n - log_chunk), B);
  const int chunk = 1 << log_chunk;
  ntt_fwd_row_kernel<<<grid, pass_threads(chunk), chunk * sizeof(uint32_t),
                       (cudaStream_t)stream>>>(
      (const uint32_t*)tmp, (int64_t*)y, (const uint32_t*)tw,
      (const uint32_t*)consts, (const int32_t*)pos_inv, (const int32_t*)limbs,
      L, log_n, log_na, log_chunk);
  return (int)cudaGetLastError();
}

int rfhe_ntt_inv_row(const void* y, void* tmp, const void* tw,
                     const void* consts, const void* pos_inv,
                     const void* limbs, int L, int B, int log_n, int log_na,
                     int log_chunk, void* stream) {
  const dim3 grid(L << (log_n - log_chunk), B);
  const int chunk = 1 << log_chunk;
  ntt_inv_row_kernel<<<grid, pass_threads(chunk), chunk * sizeof(uint32_t),
                       (cudaStream_t)stream>>>(
      (const int64_t*)y, (uint32_t*)tmp, (const uint32_t*)tw,
      (const uint32_t*)consts, (const int32_t*)pos_inv, (const int32_t*)limbs,
      L, log_n, log_na, log_chunk);
  return (int)cudaGetLastError();
}

int rfhe_ntt_inv_col(const void* tmp, void* x, const void* tw,
                     const void* consts, const void* limbs, int L, int B,
                     int log_n, int log_na, int log_c, void* stream) {
  const dim3 grid(L << (log_n - log_na - log_c), B);
  const int tile = 1 << (log_na + log_c);
  ntt_inv_col_kernel<<<grid, pass_threads(tile), tile * sizeof(uint32_t),
                       (cudaStream_t)stream>>>(
      (const uint32_t*)tmp, (int64_t*)x, (const uint32_t*)tw,
      (const uint32_t*)consts, (const int32_t*)limbs, L, log_n, log_na, log_c);
  return (int)cudaGetLastError();
}

}  // extern "C"
