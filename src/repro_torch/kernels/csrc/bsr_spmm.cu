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
// Two kernels share that plan.  bsr_spmm_kernel (fp32, and bf16 blocks of
// 8 rows) stages the operands through shared memory as fp32 in chunks of
// KC along k; every thread owns a TM x TN register tile updated with FMA
// arithmetic in full fp32.  bsr_spmm_wmma_kernel (bf16, bm >= 16) stages
// them as bf16 and multiplies 16x16x16 fragments on the tensor cores
// (wmma, fp32 accumulators); a warp owns a run of output fragments in
// row-major order and keeps the A fragment while the row does not change.
// The column tile is the kernel's own choice (64 where it divides N, else
// 32), not the caller's.  Loads are plain and synchronous: wgmma, TMA and
// copy/compute overlap are later work.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

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

// The kernel picks its own column tile: 64 where it divides N, else 32.
template <typename T, int BM>
int launch_tile(const void* blocks, const int* col_idx, const int* row_ptr,
                const void* q, void* z, int m_blocks, int n, int bk,
                cudaStream_t stream) {
  return n % 64 == 0
             ? launch<T, BM, 64>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream)
             : launch<T, BM, 32>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
}

int launch_fp32(const void* blocks, const int* col_idx, const int* row_ptr,
                const void* q, void* z, int m_blocks, int n, int bm, int bk,
                cudaStream_t stream) {
  switch (bm) {
    case 8:
      return launch_tile<float, 8>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    case 16:
      return launch_tile<float, 16>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    case 32:
      return launch_tile<float, 32>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    case 64:
      return launch_tile<float, 64>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    case 128:
      return launch_tile<float, 128>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    default:
      return -1;
  }
}

// ---------------------------------------------------------------- bf16

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
                     int n, int bk, cudaStream_t stream) {
  return n % 64 == 0
             ? launch_wmma<BM, 64>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream)
             : launch_wmma<BM, 32>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
}

int launch_bf16(const void* blocks, const int* col_idx, const int* row_ptr,
                const void* q, void* z, int m_blocks, int n, int bm, int bk,
                cudaStream_t stream) {
  switch (bm) {
    case 8:  // below the tensor cores' 16-row fragment
      return launch_tile<__nv_bfloat16, 8>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    case 16:
      return launch_wmma_tile<16>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    case 32:
      return launch_wmma_tile<32>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    case 64:
      return launch_wmma_tile<64>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    case 128:
      return launch_wmma_tile<128>(blocks, col_idx, row_ptr, q, z, m_blocks, n, bk, stream);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry point.  Returns cudaGetLastError() of the launch, or -1
// for a shape or type the kernel does not take.  Launches on `stream`,
// allocates nothing, does not synchronise.
extern "C" int repro_bsr_spmm(const void* blocks, const int* col_idx,
                              const int* row_ptr, const void* q, void* z,
                              int m_blocks, int n, int bm, int bk,
                              int is_bf16, void* stream) {
  if (m_blocks <= 0 || n <= 0 || n % 32 != 0) return -1;
  if (bk <= 0 || bk % KC != 0) return -1;
  if (n / 32 > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(blocks, col_idx, row_ptr, q, z, m_blocks, n,
                               bm, bk, st)
                 : launch_fp32(blocks, col_idx, row_ptr, q, z, m_blocks, n,
                               bm, bk, st);
}
