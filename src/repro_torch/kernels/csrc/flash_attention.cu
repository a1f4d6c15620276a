// Blocked attention forward for Hopper: softmax(Q K^T / sqrt(hd)) V with an
// online softmax, causal or not.
//
// Replaces the TPU kernel `_kernel` / `flash_attention` of the JAX
// package's kernels/flash_attention.py.  There the running max, running
// sum and fp32 accumulator live in scratch memory carried across the
// steps of a sequential grid axis, and key/value blocks above the
// diagonal are predicated off.  Here one thread block owns one
// (batch*head, query tile) and loops over the key/value tiles itself: the
// carried state lives in registers, and the causal skip is the loop bound,
// not a predicate.  m, l and the accumulator are fp32; each tile rescales
// by exp(m_prev - m_cur); the end divides by max(l, 1e-30); inside a tile
// that holds the diagonal (or the end of a sequence that is not a whole
// number of tiles) masked scores get weight 0: they are -1e30 as in the
// TPU kernel (fp32), or -inf ahead of the folded exponent (bf16).
//
// The route is chosen by the Python wrapper (flash_plan) and passed in.
//
// "fma", fp32 inputs (flash_fwd_kernel): 64-row query tiles and 64-key
// tiles; thread (ty, tx) of 16 x 16 owns query rows ty*4..ty*4+3 and, of
// every 16 consecutive columns, column tx.  Q, K (transposed), V and the
// probability tile are staged in shared memory as fp32 and both products
// run on FMA arithmetic in full fp32: bound by operations at the fp32 FMA
// rate.
//
// "wgmma", bf16 inputs (flash_fwd_wgmma_kernel): bound by operations on the
// tensor cores once S is a few hundred, so the design keeps the tensor
// cores fed.  128-row query tiles, 128-key tiles, three warpgroups:
//   * a producer warpgroup (registers lowered with setmaxnreg) whose one
//     thread loads Q once, and the K and V tiles into two-stage rings (one
//     for K, one for V) in shared memory by TMA, 128-byte swizzled, with a
//     `full` and an `empty` mbarrier per stage; rows past S read as zero;
//   * two consumer warpgroups (registers raised), 64 query rows each.  Per
//     tile: S = Q K^T with wgmma m64n128k16 (A = Q and B = K from shared
//     memory, both K-major), the online softmax in base 2 on the fp32
//     accumulator in registers (the scale folded into the exponent, one FMA
//     and one ex2.approx an element), probabilities rounded to bf16 (the
//     running sum keeps fp32), then O += P V with wgmma m64n{hd}k16, A = P from
//     registers (the accumulator layout is the register-A layout) and
//     B = V from shared memory, N-major.  Each consumer is software-
//     pipelined: the score product of tile t is issued with P V of tile
//     t - 1, and the softmax of tile t runs while P V is on the tensor
//     cores; a K stage is released as soon as its score product is done.
//     The two consumers take turns to issue their products (two named
//     barriers, FA3's ping-pong), so that one's softmax runs while the
//     tensor cores work on the other's products.
// Query tiles are issued longest causal rows first, all heads at once.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per tile
constexpr int NT = 256;   // threads per block (fp32 kernel)
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + HD * (BKV + 1) + BKV * HD + BQ * (BKV + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S,
                 float scale, int causal) {
  constexpr int DJ = HD / 16;       // output columns per thread
  constexpr int QS = HD + 1;        // sQ row stride (odd: no bank conflicts)
  constexpr int KS = BKV + 1;       // sK row stride (K is stored d-major)
  constexpr int PS = BKV + 1;       // sP row stride
  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][QS]
  float* sK = sQ + BQ * QS;         // [HD][KS]   sK[d][key]
  float* sV = sK + HD * KS;         // [BKV][HD]
  float* sP = sV + BKV * HD;        // [BQ][PS]

  // the longest causal rows first, so the tail of the grid is short work
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qi * BQ;
  const size_t base = (size_t)bh * S * HD;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    sQ[r * QS + d] = repro::to_f32<T>(q[base + (size_t)(q0 + r) * HD + d]);
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < DJ; ++b) acc[a][b] = 0.0f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers of sK, sV, sP are done
    for (int idx = tid; idx < BKV * HD; idx += NT) {
      const int r = idx / HD, d = idx % HD;
      const size_t g = base + (size_t)(kv0 + r) * HD + d;
      sK[d * KS + r] = repro::to_f32<T>(k[g]);
      sV[r * HD + d] = repro::to_f32<T>(v[g]);
    }
    __syncthreads();

    // scores: rows ty*4+a, columns tx+16*b of this tile
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = sQ[(ty * 4 + a) * QS + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = sK[d * KS + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
    }

    const bool diag = causal && (kv0 + BKV - 1 > q0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty * 4 + a;
      float mx = NEG_INF;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float x = s[a][b] * scale;
        if (diag && (kv0 + tx + 16 * b > row)) x = NEG_INF;
        s[a][b] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 lanes that share this row are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_cur);
      float sum = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_cur);
        sP[(ty * 4 + a) * PS + tx + 16 * b] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[a] = l[a] * alpha + sum;
      m[a] = m_cur;
#pragma unroll
      for (int b = 0; b < DJ; ++b) acc[a][b] *= alpha;
    }
    __syncthreads();  // sP is complete

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = sP[(ty * 4 + a) * PS + kk];
#pragma unroll
      for (int b = 0; b < DJ; ++b) vv[b] = sV[kk * HD + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < DJ; ++b) acc[a][b] = fmaf(pv[a], vv[b], acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float inv = 1.0f / fmaxf(l[a], 1e-30f);
    T* orow = o + base + (size_t)(q0 + ty * 4 + a) * HD;
#pragma unroll
    for (int b = 0; b < DJ; ++b)
      orow[tx + 16 * b] = repro::from_f32<T>(acc[a][b] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int S, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(S / BQ, bh);
  flash_fwd_kernel<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16

constexpr int WG_TILE = 128;   // query rows per block = keys per tile
constexpr int WG_STAGES = 2;   // depth of the K ring and of the V ring
constexpr int WG_NT = 384;     // producer + two consumer warpgroups

template <int HD>
struct WgSmem {
  // a Q, K or V tile: HD / 64 regions of 128 rows x 128 bytes
  static constexpr int TILE = WG_TILE * HD * 2;
  static constexpr int REGION = WG_TILE * 128;
  static constexpr int Q = 0;
  static constexpr int K = TILE;
  static constexpr int V = K + WG_STAGES * TILE;
  static constexpr int BAR = V + WG_STAGES * TILE;
  static constexpr int BYTES = BAR + 128 + 1024;  // barriers, alignment slack
};

// S = Q K^T, 64 query rows x 128 keys; issued, not waited for.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[64], const uint8_t* sq,
                                         const uint8_t* sk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * WgSmem<HD>::REGION + (kk % 4) * 32;
    repro::Wgmma<128>::ss<0>(
        s, repro::smem_desc(sq + off, 16, 1024, repro::SWIZZLE_128B),
        repro::smem_desc(sk + off, 16, 1024, repro::SWIZZLE_128B), kk > 0);
  }
}

// O += P V, P from registers; V is [key][d], d contiguous, so B is
// N-major.  Issued, not waited for.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[8][4],
                                         const uint8_t* sv) {
#pragma unroll
  for (int kk = 0; kk < WG_TILE / 16; ++kk)
    repro::Wgmma<HD>::rs(
        o, pa[kk],
        repro::smem_desc(sv + kk * 16 * 128, WgSmem<HD>::REGION, 1024,
                         repro::SWIZZLE_128B),
        1);
}

// One online-softmax step on a score tile in registers, base 2.  Masked
// scores (`masked` tiles only) become -inf; the running max m is taken on
// the raw scores times scale2 (> 0), so the scale folds into the exponent:
// p = 2^(s * scale2 - m), one FMA and one MUFU instruction an element.
// Updates m and this lane's share of the running sum l, leaves p in s and
// the factor that rescales the earlier accumulator in alpha.  Rows row0
// and row0 + 8.  (Every row that is stored has a key it may see in every
// tile it visits, so m is finite after the first tile.)
__device__ __forceinline__ void softmax_step(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale2, bool masked,
                                             int causal, int row0, int kv0,
                                             int t4, int S) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = kv0 + 8 * j + 2 * t4 + (e & 1);
        if (causal ? col > row : col >= S) s[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the 4 lanes of a quad share a row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_cur = fmaxf(m[h], mx[h] * scale2);
    alpha[h] = repro::ex2(m[h] - m_cur);
    m[h] = m_cur;
    neg_m[h] = -m_cur;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = repro::ex2(fmaf(s[4 * j + e], scale2, neg_m[e >> 1]));
      s[4 * j + e] = p;
      l[e >> 1] += p;   // the sum keeps fp32 probabilities
    }
  }
}

// Probabilities rounded to bf16 in the register-A layout of the second
// product: keys 16kk..16kk+15 are the n-tiles 2kk and 2kk + 1.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pa[j / 2][(j % 2) * 2 + 0] = repro::pack_bf16(s[4 * j + 0], s[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = repro::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(WG_NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int S, float scale,
                       int causal) {
  using L = WgSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = repro::align_1024(smem_raw);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full_v = full_k + WG_STAGES;
  uint64_t* empty_k = full_v + WG_STAGES;
  uint64_t* empty_v = empty_k + WG_STAGES;
  uint64_t* q_bar = empty_v + WG_STAGES;

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;   // longest causal rows first
  const int n_tiles = gridDim.y;
  const int q0 = qi * WG_TILE;
  const int n_kv = causal ? min(n_tiles, qi + 1) : n_tiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < WG_STAGES; ++st) {
      repro::mbar_init(&full_k[st], 1);
      repro::mbar_init(&full_v[st], 1);
      repro::mbar_init(&empty_k[st], 256);   // every consumer thread
      repro::mbar_init(&empty_v[st], 256);
    }
    repro::mbar_init(q_bar, 1);
    repro::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer
    repro::regs_dec<40>();
    if (threadIdx.x == 0) {
      repro::mbar_expect_tx(q_bar, L::TILE);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
        repro::tma_load_3d(smem + L::Q + c * L::REGION, &tm_q, q_bar, c * 64,
                           q0, bh);
      for (int t = 0; t < n_kv; ++t) {
        const int st = t % WG_STAGES;
        const int ph = ((t / WG_STAGES) & 1) ^ 1;
        uint8_t* sk = smem + L::K + st * L::TILE;
        uint8_t* sv = smem + L::V + st * L::TILE;
        repro::mbar_wait(&empty_k[st], ph);
        repro::mbar_expect_tx(&full_k[st], L::TILE);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          repro::tma_load_3d(sk + c * L::REGION, &tm_k, &full_k[st], c * 64,
                             t * WG_TILE, bh);
        repro::mbar_wait(&empty_v[st], ph);
        repro::mbar_expect_tx(&full_v[st], L::TILE);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          repro::tma_load_3d(sv + c * L::REGION, &tm_v, &full_v[st], c * 64,
                             t * WG_TILE, bh);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    // Software-pipelined: the score product of tile t runs on the tensor
    // cores while the probabilities of tile t - 1 multiply V, and the
    // softmax of tile t overlaps that second product.
    repro::regs_inc<232>();
    const int tid = threadIdx.x % 128;
    const int t4 = tid % 4;
    const int row0 = q0 + 64 * (wg - 1) + 16 * (tid / 32) + (tid % 32) / 4;
    const float scale2 = scale * 1.4426950408889634f;    // log2(e)
    const uint8_t* sq = smem + L::Q + (wg - 1) * 64 * 128;
    auto masked = [&](int t) {
      return causal ? (t == qi) : (t * WG_TILE + WG_TILE > S);
    };

    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.0f, 0.0f};   // this lane's share of the row sum
    float alpha[2];
    float s[64];
    uint32_t pa[8][4];

    // ping-pong: a consumer issues its products once the other has issued
    // its own (named barrier 1 + consumer), consumer 0 first
    const int cw = wg - 1;
    auto my_turn = [&] { repro::named_sync(1 + cw, 256); };
    auto your_turn = [&] { repro::named_arrive(2 - cw, 256); };
    if (cw == 1) your_turn();

    repro::mbar_wait(q_bar, 0);
    repro::mbar_wait(&full_k[0], 0);
    my_turn();
    repro::wgmma_fence();
    issue_qk<HD>(s, sq, smem + L::K);
    repro::wgmma_commit();
    your_turn();
    repro::wgmma_wait<0>();
    repro::fence_regs(s);
    repro::mbar_arrive(&empty_k[0]);
    softmax_step(s, m, l, alpha, scale2, masked(0), causal, row0, 0, t4, S);

    for (int t = 1; t < n_kv; ++t) {
      const int st = t % WG_STAGES;
      const int pv = (t - 1) % WG_STAGES;
      pack_p(s, pa);
      repro::mbar_wait(&full_k[st], (t / WG_STAGES) & 1);
      repro::mbar_wait(&full_v[pv], ((t - 1) / WG_STAGES) & 1);
      my_turn();
      repro::wgmma_fence();
      issue_qk<HD>(s, sq, smem + L::K + st * L::TILE);
      repro::wgmma_commit();
      issue_pv<HD>(oacc, pa, smem + L::V + pv * L::TILE);
      repro::wgmma_commit();
      your_turn();

      repro::wgmma_wait<1>();   // the score product is done
      repro::fence_regs(s);
      repro::mbar_arrive(&empty_k[st]);
      softmax_step(s, m, l, alpha, scale2, masked(t), causal, row0,
                   t * WG_TILE, t4, S);

      repro::wgmma_wait<0>();   // so is P V of the tile before
      repro::fence_regs(oacc);
      repro::mbar_arrive(&empty_v[pv]);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        oacc[4 * j + 0] *= alpha[0];
        oacc[4 * j + 1] *= alpha[0];
        oacc[4 * j + 2] *= alpha[1];
        oacc[4 * j + 3] *= alpha[1];
      }
    }
    const int last = (n_kv - 1) % WG_STAGES;
    pack_p(s, pa);
    repro::mbar_wait(&full_v[last], ((n_kv - 1) / WG_STAGES) & 1);
    my_turn();
    repro::wgmma_fence();
    issue_pv<HD>(oacc, pa, smem + L::V + last * L::TILE);
    repro::wgmma_commit();
    if (cw == 0) your_turn();   // every arrival is matched by a wait
    repro::wgmma_wait<0>();
    repro::fence_regs(oacc);

    const int t4c = 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + 8 * h;
      if (row < S) {
        const float inv = 1.0f / fmaxf(l[h], 1e-30f);
        __nv_bfloat16* orow = o + ((size_t)bh * S + row) * HD + t4c;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(oacc[4 * j + 2 * h] * inv,
                                    oacc[4 * j + 2 * h + 1] * inv);
      }
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh,
                 int S, float scale, int causal, cudaStream_t stream) {
  using L = WgSmem<HD>;
  // [bh][S][HD], HD innermost; a box is 64 columns (one 128-byte swizzle
  // span) of 128 rows of one head
  const uint64_t dims[3] = {HD, (uint64_t)S, (uint64_t)bh};
  const uint64_t strides[2] = {HD * 2, (uint64_t)S * HD * 2};
  const uint32_t box[3] = {64, WG_TILE, 1};
  CUtensorMap tm[3];
  const void* base[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int e = repro::make_tensor_map(&tm[i], base[i], 3, dims, strides,
                                         box, 128);
    if (e != 0) return e;
  }
  static int smem_limit[64];
  const int err = repro::raise_smem_limit(
      reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<HD>), L::BYTES,
      smem_limit);
  if (err != 0) return err;
  dim3 grid(bh, (S + WG_TILE - 1) / WG_TILE);
  flash_fwd_wgmma_kernel<HD><<<grid, WG_NT, L::BYTES, stream>>>(
      tm[0], tm[1], tm[2], static_cast<__nv_bfloat16*>(o), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Routes, as numbered by the Python wrappers.
enum { ROUTE_FMA = 0, ROUTE_WMMA = 1, ROUTE_WGMMA = 2 };

// Plain C entry point; q, k, v, o are contiguous [bh, S, hd], 16-byte
// aligned.  `route` is the wrapper's choice: ROUTE_FMA takes fp32,
// ROUTE_WGMMA bf16.  Returns cudaGetLastError() of the launch, or -1 for a
// route, shape or type the kernels do not take.  Launches on `stream`,
// allocates nothing, does not synchronise.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int S,
                                     int hd, float scale, int causal,
                                     int is_bf16, int route, void* stream) {
  if (bh <= 0 || bh > 65535 || S <= 0 || S % BQ != 0 || S % BKV != 0)
    return -1;
  if (hd != 64 && hd != 128) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_FMA && !is_bf16) {
    return hd == 128 ? launch<float, 128>(q, k, v, o, bh, S, scale, causal, st)
                     : launch<float, 64>(q, k, v, o, bh, S, scale, causal, st);
  }
  if (route == ROUTE_WGMMA && is_bf16) {
    return hd == 128 ? launch_wgmma<128>(q, k, v, o, bh, S, scale, causal, st)
                     : launch_wgmma<64>(q, k, v, o, bh, S, scale, causal, st);
  }
  return -1;
}
