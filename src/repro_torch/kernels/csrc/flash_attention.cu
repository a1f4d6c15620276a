// Blocked attention forward for Hopper: softmax(Q K^T / sqrt(hd)) V with an
// online softmax, causal or not.
//
// Replaces the TPU kernel `_kernel` / `flash_attention` of the JAX
// package's kernels/flash_attention.py.  There the running max, running
// sum and fp32 accumulator live in scratch memory carried across the
// steps of a sequential grid axis, and key/value blocks above the
// diagonal are predicated off.  Here one thread block owns one
// (batch*head, 64-row query tile) and loops over the key/value tiles
// itself: the carried state lives in registers, and the causal skip is
// the loop bound (kv_end = min(S, (qi+1)*BQ)), not a predicate.
//
// Layout inside the block (256 threads as 16 x 16): thread (ty, tx) owns
// query rows ty*4..ty*4+3 and, of every 16 consecutive columns, column tx
// — of the 64 score columns of a tile and of the hd output columns — so a
// row of q or acc is spread over 16 lanes and no thread holds a whole
// 128-wide row.  m, l and acc are fp32; each tile rescales by
// exp(m_prev - m_cur); the end divides by max(l, 1e-30).  Inside the
// diagonal tile, masked scores are -1e30 as in the TPU kernel.
//
// Two kernels share that plan.
//
// fp32 inputs (flash_fwd_kernel): Q, K (transposed), V and the probability
// tile are staged in shared memory as fp32 and both products run on FMA
// arithmetic in full fp32, so it is bound by operations at the fp32 FMA
// rate.
//
// bf16 inputs (flash_fwd_mma_kernel): both products run on the tensor
// cores with mma.sync m16n8k16 (bf16 in, fp32 out).  A warp owns 16 query
// rows; its Q fragments, the score tile and the output accumulator live in
// registers in the mma fragment layout, so the score tile feeds
// the second product without touching shared memory (probabilities are
// rounded to bf16 for that product, the running sum keeps them in fp32).
// K and V are staged row-major with padded rows and their B fragments are
// read with ldmatrix (transposing for V), free of bank conflicts; the
// softmax runs in base 2 (scores pre-multiplied by log2 e).  Global loads
// are plain and synchronous: wgmma, TMA and copy/compute overlap are later
// work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per tile
constexpr int NT = 256;   // threads per block (fp32 kernel)
constexpr int NT_MMA = 128;  // threads per block (bf16 kernel): 4 warps
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

// D = A(16x16, row) * B(16x8, col) + D on the tensor cores.  Lane
// g = lane / 4, t = lane % 4 holds
//   a[0] = A[g][2t..2t+1]    a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..2t+9]  a[3] = A[g+8][2t+8..2t+9]
//   b0 = B[2t..2t+1][g]      b1 = B[2t+8..2t+9][g]
//   c[0..1] = C[g][2t..2t+1] c[2..3] = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane L gives the address of
// row L % 8 of matrix L / 8.  Lane (g, t) receives elements [g][2t..2t+1]
// of each matrix, or [2t..2t+1][g] with `trans`.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(NT_MMA)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, float scale,
                     int causal) {
  constexpr int KS = HD + 8;    // row stride of sK, sV: ldmatrix conflict-free
  constexpr int KC = HD / 16;   // k-chunks of the score product
  constexpr int ON = HD / 8;    // n-tiles of the output
  constexpr int SN = BKV / 8;   // n-tiles of the score tile
  constexpr int C8 = HD / 8;    // 16-byte vectors per row of q, k, v
  __shared__ __align__(16) __nv_bfloat16 sK[BKV * KS];   // [key][d]; Q first
  __shared__ __align__(16) __nv_bfloat16 sV[BKV * KS];   // [key][d]

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qi * BQ;
  const size_t base = (size_t)bh * S * HD;
  // ldmatrix address roles of this lane: matrix lane / 8, row lane % 8
  const int lm_row = lane & 7;
  const int lm_lo = (lane >> 3) & 1;
  const int lm_hi = lane >> 4;
  const float scale2 = scale * 1.4426950408889634f;   // log2(e): base-2 softmax

  // Q tile through the K buffer (BQ == BKV) into A fragments
  for (int idx = tid; idx < BQ * C8; idx += NT_MMA) {
    const int r = idx / C8, c = idx % C8;
    *reinterpret_cast<uint4*>(&sK[r * KS + c * 8]) =
        *reinterpret_cast<const uint4*>(&q[base + (size_t)(q0 + r) * HD + c * 8]);
  }
  __syncthreads();
  uint32_t qf[KC][4];
  {
    const __nv_bfloat16* r0 = &sK[(warp * 16 + g) * KS + 2 * t];
    const __nv_bfloat16* r1 = r0 + 8 * KS;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qf[kc][0] = *reinterpret_cast<const uint32_t*>(r0 + kc * 16);
      qf[kc][1] = *reinterpret_cast<const uint32_t*>(r1 + kc * 16);
      qf[kc][2] = *reinterpret_cast<const uint32_t*>(r0 + kc * 16 + 8);
      qf[kc][3] = *reinterpret_cast<const uint32_t*>(r1 + kc * 16 + 8);
    }
  }

  // rows g (index 0) and g + 8 (index 1) of this warp's 16
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};   // this lane's share of the row sum
  float oacc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's (or Q's) readers are done
    for (int idx = tid; idx < BKV * C8; idx += NT_MMA) {
      const int r = idx / C8, c = idx % C8;
      const size_t gofs = base + (size_t)(kv0 + r) * HD + c * 8;
      *reinterpret_cast<uint4*>(&sK[r * KS + c * 8]) =
          *reinterpret_cast<const uint4*>(&k[gofs]);
      *reinterpret_cast<uint4*>(&sV[r * KS + c * 8]) =
          *reinterpret_cast<const uint4*>(&v[gofs]);
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp
    float sacc[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int j = 0; j < SN; j += 2) {
        // matrices: (keys j, d lo), (keys j, d hi), (keys j+1, d lo), (.., hi)
        uint32_t kb[4];
        ldmatrix_x4(kb, &sK[((j + lm_hi) * 8 + lm_row) * KS + kc * 16 + lm_lo * 8]);
        mma_bf16_16816(sacc[j], qf[kc], kb[0], kb[1]);
        mma_bf16_16816(sacc[j + 1], qf[kc], kb[2], kb[3]);
      }
    }

    const bool diag = causal && (kv0 + BKV - 1 > q0);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < SN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[j][e] * scale2;
        if (diag) {
          const int row = q0 + warp * 16 + g + (e >> 1) * 8;
          const int col = kv0 + j * 8 + 2 * t + (e & 1);
          if (col > row) x = NEG_INF;
        }
        sacc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the 4 lanes of a quad share a row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_cur = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_cur);
      m[h] = m_cur;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < SN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sacc[j][e] - m[e >> 1]);
        sacc[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // acc += P V: two neighbouring score n-tiles are one A fragment
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      pa[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      pa[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ON; n += 2) {
        // matrices: (keys lo, d n), (keys hi, d n), (keys lo, d n+1), (.., hi)
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, &sV[(kk * 16 + lm_lo * 8 + lm_row) * KS + (n + lm_hi) * 8]);
        mma_bf16_16816(oacc[n], pa, vb[0], vb[1]);
        mma_bf16_16816(oacc[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float inv = 1.0f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow =
        o + base + (size_t)(q0 + warp * 16 + g + h * 8) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(oacc[n][2 * h] * inv, oacc[n][2 * h + 1] * inv);
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int bh,
               int S, float scale, int causal, cudaStream_t stream) {
  dim3 grid(S / BQ, bh);
  flash_fwd_mma_kernel<HD><<<grid, NT_MMA, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point; q, k, v, o are contiguous [bh, S, hd].  Returns
// cudaGetLastError() of the launch, or -1 for a shape or type the kernel
// does not take.  Launches on `stream`, allocates nothing, does not
// synchronise.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bh, int S,
                                     int hd, float scale, int causal,
                                     int is_bf16, void* stream) {
  if (bh <= 0 || bh > 65535 || S <= 0 || S % BQ != 0 || S % BKV != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) {
    return is_bf16 ? launch_mma<128>(q, k, v, o, bh, S, scale, causal, st)
                   : launch<float, 128>(q, k, v, o, bh, S, scale, causal, st);
  }
  if (hd == 64) {
    return is_bf16 ? launch_mma<64>(q, k, v, o, bh, S, scale, causal, st)
                   : launch<float, 64>(q, k, v, o, bh, S, scale, causal, st);
  }
  return -1;
}
