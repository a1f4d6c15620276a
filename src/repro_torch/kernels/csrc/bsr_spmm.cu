// Block-sparse-row SpMM for Hopper:  Z[M,N] = P[M,K] @ Q[K,N], P in BSR.
//
// Replaces the TPU kernel `_kernel` / `bsr_spmm` of the JAX package's
// kernels/bsr_spmm.py.  That kernel needs a third, sequential grid axis
// with a predicate, clamped index maps and scalar prefetch because a TPU
// grid is fixed and runs in order.  Here one thread block owns one output
// tile (block-row i, column tile j), reads row_ptr[i] and row_ptr[i+1]
// itself and loops over exactly the stored blocks of its row: only
// effectual blocks are fetched and multiplied (the paper's Skip at tile
// granularity), and an empty block-row stores zeros.
//
// Numerics: the product accumulates in fp32 registers over the whole row
// and is rounded to the output type once at the store (the TPU kernel
// adds every step's product into the output tile in the output type).
//
// The route and the column tile are chosen by the Python wrapper
// (bsr_plan) and passed in; a route this file does not have returns -1.
//
// "fma" (bsr_spmm_kernel: fp32, and bf16 blocks of 8 rows) stages the
// operands through shared memory as fp32 in chunks of KC along k; every
// thread owns a TM x TN register tile updated with FMA arithmetic in full
// fp32.
//
// "wmma" (bsr_spmm_wmma_kernel: bf16, bm = 16 or 32) stages them as bf16
// and multiplies 16x16x16 fragments on the tensor cores (wmma, fp32
// accumulators); a warp owns a run of output fragments in row-major order.
//
// "wgmma" (bsr_spmm_wgmma_kernel: bf16, bm = 64 or 128).  At a block
// density of 0.1 the product is bound by bytes (Q read and Z written once
// outweigh the tensor cores' time), so what matters is keeping loads in
// flight and fetching each stored block few times.  A producer warp walks
// the stored blocks of the row and, for each, loads by TMA the P block and
// the bk x BN slab of Q it multiplies into a ring of 2-4 stages in shared
// memory (swizzled, `full` and `empty` mbarriers per stage); bm / 64
// consumer warpgroups multiply with wgmma m64nBNk16 (A = P, K-major; B = Q,
// N-major) while the next blocks load, and release a stage one block late
// so that consecutive blocks' products overlap.  The column tile BN is up
// to 256, so a stored block is fetched N / 256 times, not N / 64.  The
// wrapper picks the order blocks are issued in: block-row fastest (the
// blocks running at once share their Q slabs in L2) or column tile fastest.
#include <mma.h>
#include <stdint.h>

#include <mma.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int KC = 32;  // k-chunk staged per step; bk is a multiple of it

template <int BM, int BN>
struct Tile {
  static constexpr int TM = BM >= 64 ? 8 : (BM >= 32 ? 4 : (BM >= 16 ? 2 : 1));
  static constexpr int TN = 4;
  static constexpr int TX = BN / TN;  // thread columns
  static constexpr int TY = BM / TM;  // thread rows
  static constexpr int NT = TX * TY;  // threads per block (64..256)
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::NT)
bsr_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ col_idx,
                const int* __restrict__ row_ptr, const T* __restrict__ q,
                T* __restrict__ z, int n, int bk) {
  using C = Tile<BM, BN>;
  constexpr int TM = C::TM, TN = C::TN, TX = C::TX, NT = C::NT;
  // P chunk transposed (k-major) so a thread's rows are contiguous; the
  // odd row stride keeps the transposing writes free of bank conflicts.
  __shared__ float sP[KC][BM + 1];
  __shared__ float sQ[KC][BN];

  const int i = blockIdx.x;  // block-row of P and Z
  const int j = blockIdx.y;  // column tile of Q and Z
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.0f;

  const int s0 = row_ptr[i];
  const int s1 = row_ptr[i + 1];
  for (int s = s0; s < s1; ++s) {
    const T* pb = blocks + (size_t)s * BM * bk;
    const T* qb = q + (size_t)col_idx[s] * bk * n + (size_t)j * BN;
    for (int k0 = 0; k0 < bk; k0 += KC) {
      for (int idx = tid; idx < BM * KC; idx += NT) {
        const int r = idx / KC, kk = idx % KC;
        sP[kk][r] = repro::to_f32<T>(pb[(size_t)r * bk + k0 + kk]);
      }
      for (int idx = tid; idx < KC * BN; idx += NT) {
        const int kk = idx / BN, c = idx % BN;
        sQ[kk][c] = repro::to_f32<T>(qb[(size_t)(k0 + kk) * n + c]);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float pa[TM], qv[TN];
#pragma unroll
        for (int a = 0; a < TM; ++a) pa[a] = sP[kk][ty * TM + a];
        // a thread's columns are interleaved (tx, tx+TX, ...) so that
        // neighbouring threads read neighbouring shared-memory words
#pragma unroll
        for (int b = 0; b < TN; ++b) qv[b] = sQ[kk][tx + TX * b];
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(pa[a], qv[b], acc[a][b]);
      }
      __syncthreads();
    }
  }

  T* zb = z + ((size_t)i * BM + (size_t)ty * TM) * n + (size_t)j * BN;
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b)
      zb[(size_t)a * n + tx + TX * b] = repro::from_f32<T>(acc[a][b]);
}

template <typename T, int BM, int BN>
int launch(const void* blocks, const int* col_idx, const int* row_ptr,
           const void* q, void* z, int m_blocks, int n, int bk,
           cudaStream_t stream) {
  dim3 grid(m_blocks, n / BN);
  bsr_spmm_kernel<T, BM, BN><<<grid, Tile<BM, BN>::NT, 0, stream>>>(
      static_cast<const T*>(blocks), col_idx, row_ptr,
      static_cast<const T*>(q), static_cast<T*>(z), n, bk);
  return static_cast<int>(cudaGetLastError());
}

// The column tile is the wrapper's choice: 64 or 32.
template <typename T, int BM>
int launch_tile(const void* blocks, const int* col_idx, const int* row_ptr,
                const void* q, void* z, int m_blocks, int n, int bk, int bn,
                cudaStream_t stream) {
  if (bn == 64)
    return launch<T, BM, 64>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
  if (bn == 32)
    return launch<T, BM, 32>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
  return -1;
}

int launch_fma(const void* blocks, const int* col_idx, const int* row_ptr,
               const void* q, void* z, int m_blocks, int n, int bm, int bk,
               int bn, int is_bf16, cudaStream_t stream) {
  if (is_bf16)   // bf16 blocks of 8 rows: below the tensor cores' tiles
    return bm == 8 ? launch_tile<__nv_bfloat16, 8>(blocks, col_idx, row_ptr, q,
                                                   z, m_blocks, n, bk, bn, stream)
                   : -1;
  switch (bm) {
    case 8:
      return launch_tile<float, 8>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, bn, stream);
    case 16:
      return launch_tile<float, 16>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, bn, stream);
    case 32:
      return launch_tile<float, 32>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, bn, stream);
    case 64:
      return launch_tile<float, 64>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, bn, stream);
    case 128:
      return launch_tile<float, 128>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, bn, stream);
    default:
      return -1;
  }
}

// ---------------------------------------------------------- bf16: wmma

template <int BM, int BN>
struct WmmaTile {
  static constexpr int RF = BM / 16;            // fragment rows
  static constexpr int CF = BN / 16;            // fragment columns
  static constexpr int F = RF * CF;             // fragments per tile
  static constexpr int W = F < 8 ? F : 8;       // warps per block
  static constexpr int FPW = F / W;             // fragments per warp
  static constexpr int NT = W * 32;
  static constexpr int PS = KC + 8;             // padded row strides (bf16)
  static constexpr int QS = BN + 8;
};

template <int BM, int BN>
__global__ void __launch_bounds__(WmmaTile<BM, BN>::NT)
bsr_spmm_wmma_kernel(const __nv_bfloat16* __restrict__ blocks,
                     const int* __restrict__ col_idx,
                     const int* __restrict__ row_ptr,
                     const __nv_bfloat16* __restrict__ q,
                     __nv_bfloat16* __restrict__ z, int n, int bk) {
  using namespace nvcuda;
  using C = WmmaTile<BM, BN>;
  constexpr int CF = C::CF, W = C::W, FPW = C::FPW, NT = C::NT;
  constexpr int PS = C::PS, QS = C::QS;
  __shared__ __align__(32) __nv_bfloat16 sP[BM * PS];   // [row][k]
  __shared__ __align__(32) __nv_bfloat16 sQ[KC * QS];   // [k][col]
  __shared__ __align__(32) float stage[W][16 * 16];

  const int i = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FPW];
#pragma unroll
  for (int f = 0; f < FPW; ++f) wmma::fill_fragment(acc[f], 0.0f);

  const int s0 = row_ptr[i];
  const int s1 = row_ptr[i + 1];
  for (int s = s0; s < s1; ++s) {
    const __nv_bfloat16* pb = blocks + (size_t)s * BM * bk;
    const __nv_bfloat16* qb = q + (size_t)col_idx[s] * bk * n + (size_t)j * BN;
    for (int k0 = 0; k0 < bk; k0 += KC) {
      // 16-byte vectors: 4 per row of the P chunk, BN / 8 per row of Q
      for (int idx = tid; idx < BM * (KC / 8); idx += NT) {
        const int r = idx / (KC / 8), c = idx % (KC / 8);
        *reinterpret_cast<uint4*>(&sP[r * PS + c * 8]) =
            *reinterpret_cast<const uint4*>(&pb[(size_t)r * bk + k0 + c * 8]);
      }
      for (int idx = tid; idx < KC * (BN / 8); idx += NT) {
        const int kk = idx / (BN / 8), c = idx % (BN / 8);
        *reinterpret_cast<uint4*>(&sQ[kk * QS + c * 8]) =
            *reinterpret_cast<const uint4*>(&qb[(size_t)(k0 + kk) * n + c * 8]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        int last_r = -1;
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
          const int fr = (warp * FPW + f) / CF;
          const int fc = (warp * FPW + f) % CF;
          if (fr != last_r) {
            wmma::load_matrix_sync(a, &sP[fr * 16 * PS + kk], PS);
            last_r = fr;
          }
          wmma::load_matrix_sync(b, &sQ[kk * QS + fc * 16], QS);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
      __syncthreads();
    }
  }

  // fp32 fragment -> per-warp staging tile -> one rounding -> 16-byte stores
  const int er = lane >> 1;          // row of the fragment
  const int ec = (lane & 1) * 8;     // first of this lane's 8 columns
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const int fr = (warp * FPW + f) / CF;
    const int fc = (warp * FPW + f) % CF;
    wmma::store_matrix_sync(stage[warp], acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    __align__(16) __nv_bfloat16 out[8];
#pragma unroll
    for (int x = 0; x < 8; ++x)
      out[x] = __float2bfloat16_rn(stage[warp][er * 16 + ec + x]);
    __nv_bfloat16* zp = z + ((size_t)i * BM + fr * 16 + er) * n +
                        (size_t)j * BN + fc * 16 + ec;
    *reinterpret_cast<uint4*>(zp) = *reinterpret_cast<const uint4*>(out);
    __syncwarp();
  }
}

template <int BM, int BN>
int launch_wmma(const void* blocks, const int* col_idx, const int* row_ptr,
                const void* q, void* z, int m_blocks, int n, int bk,
                cudaStream_t stream) {
  dim3 grid(m_blocks, n / BN);
  bsr_spmm_wmma_kernel<BM, BN><<<grid, WmmaTile<BM, BN>::NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(blocks), col_idx, row_ptr,
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(z), n,
      bk);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_wmma_tile(const void* blocks, const int* col_idx,
                     const int* row_ptr, const void* q, void* z, int m_blocks,
                     int n, int bk, int bn, cudaStream_t stream) {
  if (bn == 64)
    return launch_wmma<BM, 64>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
  if (bn == 32)
    return launch_wmma<BM, 32>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
  return -1;
}

// ---------------------------------------------------------- bf16: wgmma

constexpr int WG_MAX_STAGES = 4;

template <int BM>
struct WgTile {
  static constexpr int CONSUMERS = BM / 64;          // warpgroups
  static constexpr int NT = CONSUMERS * 128 + 32;    // + one producer warp
  // ring bytes: with 64-row blocks two thread blocks share an SM, with
  // 128-row blocks the registers allow one, which takes a deeper ring
  static constexpr int SMEM_BUDGET = (BM == 64 ? 110 : 200) * 1024;
};

template <int BM, int BN>
__global__ void __launch_bounds__(WgTile<BM>::NT, BM == 64 ? 2 : 1)
bsr_spmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_p,
                      const __grid_constant__ CUtensorMap tm_q,
                      const int* __restrict__ col_idx,
                      const int* __restrict__ row_ptr,
                      __nv_bfloat16* __restrict__ z, int m_blocks, int n,
                      int bk, int stages, int rows_fastest) {
  constexpr int CONSUMERS = WgTile<BM>::CONSUMERS;
  constexpr int QW = BN < 64 ? BN : 64;     // Q columns per swizzle span
  const int pw = bk < 64 ? bk : 64;         // P columns per swizzle span
  const int p_bytes = BM * bk * 2;          // bk / pw regions of BM rows
  const int q_bytes = bk * BN * 2;          // BN / QW regions of bk rows
  const int stage_bytes = p_bytes + q_bytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = repro::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + WG_MAX_STAGES;

  const int n_tiles = n / BN;
  const int i = rows_fastest ? blockIdx.x % m_blocks : blockIdx.x / n_tiles;
  const int j = rows_fastest ? blockIdx.x / m_blocks : blockIdx.x % n_tiles;
  const int s0 = row_ptr[i];
  const int s1 = row_ptr[i + 1];
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      repro::mbar_init(&full[st], 1);
      repro::mbar_init(&empty[st], CONSUMERS * 128);
    }
    repro::fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ------------------------------------------------------ producer
    if (threadIdx.x % 32 == 0) {
      for (int s = s0; s < s1; ++s) {
        const int t = s - s0;
        const int st = t % stages;
        repro::mbar_wait(&empty[st], ((t / stages) & 1) ^ 1);
        repro::mbar_expect_tx(&full[st], stage_bytes);
        uint8_t* sp = smem + st * stage_bytes;
        for (int c = 0; c < bk / pw; ++c)
          repro::tma_load_2d(sp + c * BM * pw * 2, &tm_p, &full[st], c * pw,
                             s * BM);
        const int k0 = col_idx[s] * bk;
#pragma unroll
        for (int c = 0; c < BN / QW; ++c)
          repro::tma_load_2d(sp + p_bytes + c * bk * QW * 2, &tm_q, &full[st],
                             j * BN + c * QW, k0);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    const int cw = warp / 4;
    float acc[BN / 2];
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) acc[x] = 0.0f;
    const uint32_t p_layout =
        pw == 64 ? repro::SWIZZLE_128B : repro::SWIZZLE_64B;
    constexpr uint32_t q_layout =
        QW == 64 ? repro::SWIZZLE_128B : repro::SWIZZLE_64B;
    for (int s = s0; s < s1; ++s) {
      const int t = s - s0;
      const int st = t % stages;
      repro::mbar_wait(&full[st], (t / stages) & 1);
      const uint8_t* sp = smem + st * stage_bytes + cw * 64 * pw * 2;
      const uint8_t* sq = smem + st * stage_bytes + p_bytes;
      repro::wgmma_fence();
      for (int k = 0; k < bk; k += 16) {
        repro::Wgmma<BN>::template ss<1>(
            acc,
            repro::smem_desc(sp + (k / pw) * BM * pw * 2 + (k % pw) * 2, 16,
                             8 * pw * 2, p_layout),
            repro::smem_desc(sq + k * QW * 2, bk * QW * 2, 8 * QW * 2,
                             q_layout),
            1);
      }
      repro::wgmma_commit();
      // the previous block's products are done: release its stage
      repro::wgmma_wait<1>();
      if (t > 0) repro::mbar_arrive(&empty[(t - 1) % stages]);
    }
    repro::wgmma_wait<0>();
    repro::fence_regs(acc);

    const int tid = threadIdx.x % 128;
    const int g = (tid % 32) / 4;
    const int t4 = tid % 4;
    const size_t row = (size_t)i * BM + cw * 64 + (tid / 32) * 16 + g;
    __nv_bfloat16* zp = z + row * n + (size_t)j * BN + 2 * t4;
#pragma unroll
    for (int x = 0; x < BN / 8; ++x) {
      *reinterpret_cast<__nv_bfloat162*>(zp + 8 * x) =
          __floats2bfloat162_rn(acc[4 * x + 0], acc[4 * x + 1]);
      *reinterpret_cast<__nv_bfloat162*>(zp + 8 * (size_t)n + 8 * x) =
          __floats2bfloat162_rn(acc[4 * x + 2], acc[4 * x + 3]);
    }
  }
}

template <int BM, int BN>
int launch_wgmma(const void* blocks, const int* col_idx, const int* row_ptr,
                 const void* q, void* z, int nnz, int m_blocks, int n, int k,
                 int bk, int rows_fastest, cudaStream_t stream) {
  constexpr int QW = BN < 64 ? BN : 64;
  const uint32_t pw = bk < 64 ? bk : 64;
  // P: the blocks as one [nnz * BM][bk] matrix, a box is one block's
  // columns of one swizzle span; Q: [K][N], a box is bk rows of QW columns
  CUtensorMap tm_p, tm_q;
  const uint64_t p_dims[2] = {(uint64_t)bk, (uint64_t)nnz * BM};
  const uint64_t p_strides[1] = {(uint64_t)bk * 2};
  const uint32_t p_box[2] = {pw, BM};
  int err = repro::make_tensor_map(&tm_p, blocks, 2, p_dims, p_strides, p_box,
                                   pw * 2);
  if (err != 0) return err;
  const uint64_t q_dims[2] = {(uint64_t)n, (uint64_t)k};
  const uint64_t q_strides[1] = {(uint64_t)n * 2};
  const uint32_t q_box[2] = {QW, (uint32_t)bk};
  err = repro::make_tensor_map(&tm_q, q, 2, q_dims, q_strides, q_box, QW * 2);
  if (err != 0) return err;

  const int stage_bytes = (BM * bk + bk * BN) * 2;
  const int stages =
      max(2, min(WG_MAX_STAGES, WgTile<BM>::SMEM_BUDGET / stage_bytes));
  const int bytes = stages * stage_bytes + 2 * WG_MAX_STAGES * 8 + 1024;
  static int smem_limit[64];
  err = repro::raise_smem_limit(
      reinterpret_cast<const void*>(bsr_spmm_wgmma_kernel<BM, BN>), bytes,
      smem_limit);
  if (err != 0) return err;
  const long long grid = (long long)m_blocks * (n / BN);
  if (grid > 0x7fffffffLL) return -1;
  bsr_spmm_wgmma_kernel<BM, BN><<<(unsigned)grid, WgTile<BM>::NT, bytes,
                                  stream>>>(
      tm_p, tm_q, col_idx, row_ptr, static_cast<__nv_bfloat16*>(z), m_blocks,
      n, bk, stages, rows_fastest);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_wgmma_tile(const void* blocks, const int* col_idx,
                      const int* row_ptr, const void* q, void* z, int nnz,
                      int m_blocks, int n, int k, int bk, int bn,
                      int rows_fastest, cudaStream_t stream) {
  switch (bn) {
    case 256:
      return launch_wgmma<BM, 256>(blocks, col_idx, row_ptr, q, z, nnz, m_blocks, n, k, bk, rows_fastest, stream);
    case 128:
      return launch_wgmma<BM, 128>(blocks, col_idx, row_ptr, q, z, nnz, m_blocks, n, k, bk, rows_fastest, stream);
    case 64:
      return launch_wgmma<BM, 64>(blocks, col_idx, row_ptr, q, z, nnz, m_blocks, n, k, bk, rows_fastest, stream);
    case 32:
      return launch_wgmma<BM, 32>(blocks, col_idx, row_ptr, q, z, nnz, m_blocks, n, k, bk, rows_fastest, stream);
    default:
      return -1;
  }
}

}  // namespace

// Routes, as numbered by the Python wrappers.
enum { ROUTE_FMA = 0, ROUTE_WMMA = 1, ROUTE_WGMMA = 2 };

// Plain C entry point; every operand contiguous and 16-byte aligned.
// `route` and the column tile `bn` are the wrapper's choice:
//   ROUTE_FMA   fp32 (any bm), bf16 with bm = 8;   bn 64 or 32
//   ROUTE_WMMA  bf16 with bm = 16 or 32;           bn 64 or 32
//   ROUTE_WGMMA bf16 with bm = 64 or 128;          bn 256, 128, 64 or 32
// `rows_fastest` = 1 issues blocks block-row fastest, 0 column tile
// fastest (wgmma only).  Returns cudaGetLastError() of the launch, or -1
// for a route, shape or type the kernels do not take.  Launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int repro_bsr_spmm(const void* blocks, const int* col_idx,
                              const int* row_ptr, const void* q, void* z,
                              int nnz, int m_blocks, int n, int k, int bm,
                              int bk, int is_bf16, int route, int bn,
                              int rows_fastest, void* stream) {
  if (nnz <= 0 || m_blocks <= 0 || n <= 0 || bn <= 0 || n % bn != 0) return -1;
  if (bk <= 0 || bk % KC != 0 || k <= 0 || k % bk != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_FMA) {
    if (n / bn > 65535) return -1;
    return launch_fma(blocks, col_idx, row_ptr, q, z, m_blocks, n, bm, bk, bn,
                      is_bf16, st);
  }
  if (route == ROUTE_WMMA && is_bf16) {
    if (n / bn > 65535) return -1;
    if (bm == 16)
      return launch_wmma_tile<16>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, bn, st);
    if (bm == 32)
      return launch_wmma_tile<32>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, bn, st);
    return -1;
  }
  if (route == ROUTE_WGMMA && is_bf16) {
    if (bm == 64)
      return launch_wgmma_tile<64>(blocks, col_idx, row_ptr, q, z, nnz, m_blocks, n, k, bk, bn, rows_fastest, st);
    if (bm == 128)
      return launch_wgmma_tile<128>(blocks, col_idx, row_ptr, q, z, nnz, m_blocks, n, k, bk, bn, rows_fastest, st);
    return -1;
  }
  return -1;
}
