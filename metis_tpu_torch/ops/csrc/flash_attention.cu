// Blockwise (flash) attention for Hopper: forward, dQ pass and dK/dV pass.
//
// Built by metis_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface (the three extern "C" functions at
// the end), loaded through ctypes by metis_tpu_torch/ops/flash_attention.py.
//
// Layout: heads folded into the leading dim. q/o/dO/dq are [b*hq, s_q, D],
// k/v/dk/dv are [b*hkv, s_kv, D], all bf16 and contiguous; m, l, lse and
// delta are fp32 [b*hq, s_q]. GQA (hq > hkv) reads K/V row
// (bh / hq) * hkv + (bh % hq) / g with g = hq / hkv, so K and V are never
// expanded in memory. Causal masking is top-left aligned: query row i sees
// key rows j <= i. Any sequence length runs: the ragged last tile is masked
// here, never padded by the caller.
//
// Design, shared by the three kernels. A Pallas grid on the TPU runs in order
// and carries (m, l, acc) in VMEM scratch across its last grid dimension; on
// Hopper blocks run in no order, so each CTA owns one output tile and loops
// over the other operand inside the CTA. The causal block skip becomes the
// bound of that loop. Tiles are 64 x D (16 KB at D = 128 in bf16), staged in
// shared memory with a 16-byte row pad against bank conflicts. 4 warps per
// CTA; each warp owns 16 rows of the CTA's tile and runs its products on the
// tensor cores through WMMA (16x16x16 bf16, fp32 accumulate). The softmax and
// gradient elementwise work reads the fp32 product tiles back from shared
// memory, because the WMMA accumulator layout is opaque.
//
// What the simple design leaves on the table (work for later PRs): WMMA is
// mma.sync, about half of what wgmma reaches; loads are synchronous
// (no cp.async / TMA double buffering), so the tensor cores idle while a tile
// arrives; products round-trip through shared memory for the elementwise
// step; the dK/dV kernel runs one CTA per SM at D = 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;          // rows of every Q and KV tile
constexpr int WARPS = 4;          // each warp owns 16 rows of a tile
constexpr int THREADS = WARPS * 32;
constexpr int PAD_H = 8;          // bf16 row pad (16 bytes)
constexpr int PAD_F = 4;          // fp32 row pad (16 bytes)
constexpr float NEG_INF = -1e30f; // the reference's mask value

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared-memory geometry for head dim D. Every region is a multiple of 128
// bytes, so carving them in sequence keeps each one 128-byte aligned, and
// every 16-row fragment start stays 32-byte aligned as WMMA requires.
template <int D>
struct Tiles {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int LDH = D + PAD_H;     // bf16 [64][D] tiles (Q, K, V, dO)
  static constexpr int LDO = D + PAD_F;     // fp32 [64][D] accumulator / staging
  static constexpr int LDS = TILE + PAD_F;  // fp32 [64][64] product tiles
  static constexpr int LDP = TILE + PAD_H;  // bf16 [64][64] probability tiles
  static constexpr size_t H = TILE * LDH * sizeof(bf16);
  static constexpr size_t O = TILE * LDO * sizeof(float);
  static constexpr size_t S = TILE * LDS * sizeof(float);
  static constexpr size_t P = TILE * LDP * sizeof(bf16);
  static constexpr size_t ROW = TILE * sizeof(float);
  static constexpr size_t FWD = 3 * H + S + P + O + 2 * ROW;
  static constexpr size_t DQ = 4 * H + 2 * S + P + 2 * ROW;
  static constexpr size_t DKV = 4 * H + 2 * S + 2 * P + 2 * ROW;
  static_assert(O <= 2 * S, "fp32 output staging must fit in two product tiles");
};

// Copy rows [row0, row0 + 64) of a contiguous [nrows, D] bf16 matrix into a
// padded shared tile, 16 bytes per thread per step; rows past nrows read 0.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int nrows) {
  constexpr int CHUNKS = D / 8;
  constexpr int LDH = Tiles<D>::LDH;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// Load 64 fp32 per-row values (lse, delta) starting at row0; rows past nrows read 0.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int nrows) {
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    dst[i] = (row0 + i < nrows) ? src[row0 + i] : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// out[16 x 64] (fp32, ldm ldo) = A[16 x D] . B[64 x D]^T, A and B bf16 row-major
// in shared memory: one warp's product of its rows against a whole tile.
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float* out, int ldo, const bf16* a,
                                                  const bf16* b) {
  constexpr int LDH = Tiles<D>::LDH;
#pragma unroll
  for (int n = 0; n < TILE; n += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk, LDH);
      wmma::load_matrix_sync(fb, b + n * LDH + kk, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n, acc, ldo, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------------------
// B1. Replaces metis_tpu/ops/flash_attention.py:85 _fa_kernel (pallas_call at
// :390, reached through _fa_call :344).
//
// One CTA per (b*hq, 64-row Q tile), looping over the KV tiles with an online
// softmax; the causal skip is the loop bound (KV tiles that start after the
// tile's last row are never visited). normalize=1 writes O = acc / l,
// normalize=0 the unnormalised acc; m_out/l_out (optional) get the per-row
// running max and sum.
//
// Bound on an H100 SXM at the main-path shape (b=4, h=32, s=1024, d=128,
// causal, bf16): 2*b*h*s^2*d = 3.4e10 FLOP, 35 us at 989 TFLOP/s; it reads
// Q, K, V and writes O, 4 x 33.5 MB, 40 us at 3.35 TB/s. So it is bound by
// bytes at this shape, narrowly.
template <int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ m_out, float* __restrict__ l_out, int s_q,
              int s_kv, int hq, int hkv, float sm_scale, int causal, int normalize) {
  typedef Tiles<D> T;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + T::H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * T::H);
  float* sS = reinterpret_cast<float*>(smem + 3 * T::H);
  bf16* sP = reinterpret_cast<bf16*>(smem + 3 * T::H + T::S);
  float* sO = reinterpret_cast<float*>(smem + 3 * T::H + T::S + T::P);
  float* sM = reinterpret_cast<float*>(smem + 3 * T::H + T::S + T::P + T::O);
  float* sL = sM + TILE;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int g = hq / hkv;
  const int bh_kv = (bh / hq) * hkv + (bh % hq) / g;
  const bf16* kb = k + (size_t)bh_kv * s_kv * D;
  const bf16* vb = v + (size_t)bh_kv * s_kv * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile<D>(sQ, q + (size_t)bh * s_q * D, q0, s_q);
  for (int i = threadIdx.x; i < TILE * T::LDO; i += THREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }

  const int kv_end = causal ? min(s_kv, q0 + TILE) : s_kv;
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done with sK/sV
    load_tile<D>(sK, kb, k0, s_kv);
    load_tile<D>(sV, vb, k0, s_kv);
    __syncthreads();

    rows_times_tile_t<D>(sS + r0 * T::LDS, T::LDS, sQ + r0 * T::LDH, sK);
    __syncwarp();

    // online softmax over this warp's 16 rows; lane owns columns lane, lane+32
    for (int r = r0; r < r0 + 16; ++r) {
      const int qi = q0 + r;
      const float m_prev = sM[r];
      const float l_prev = sL[r];
      float s[2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + lane + 32 * j;
        float val = sS[r * T::LDS + lane + 32 * j] * sm_scale;
        if (causal && kj > qi) val = NEG_INF;
        s[j] = val;
        if (kj < s_kv) mx = fmaxf(mx, val);  // columns past the end do not exist
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = __expf(m_prev - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + lane + 32 * j;
        const float p = (kj < s_kv) ? __expf(s[j] - m_new) : 0.f;
        sP[r * T::LDP + lane + 32 * j] = __float2bfloat16(p);
        psum += p;
      }
      psum = warp_sum(psum);
      for (int c = lane; c < D; c += 32) sO[r * T::LDO + c] *= alpha;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = l_prev * alpha + psum;
      }
    }
    __syncwarp();

    // acc[16 x D] += P[16 x 64] . V[64 x D]
#pragma unroll
    for (int n = 0; n < D; n += 16) {
      FragC acc;
      wmma::load_matrix_sync(acc, sO + r0 * T::LDO + n, T::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < TILE; kk += 16) {
        FragA fa;
        FragBRow fb;
        wmma::load_matrix_sync(fa, sP + r0 * T::LDP + kk, T::LDP);
        wmma::load_matrix_sync(fb, sV + kk * T::LDH + n, T::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + r0 * T::LDO + n, acc, T::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= s_q) break;
    const float l = sL[r];
    const float denom = (normalize && l != 0.f) ? l : 1.f;
    bf16* orow = o + ((size_t)bh * s_q + qi) * D;
    for (int c = lane; c < D; c += 32) {
      orow[c] = __float2bfloat16(sO[r * T::LDO + c] / denom);
    }
    if (m_out != nullptr && lane == 0) {
      m_out[(size_t)bh * s_q + qi] = sM[r];
      l_out[(size_t)bh * s_q + qi] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// B2. Replaces metis_tpu/ops/flash_attention.py:137 _fa_bwd_dq_kernel
// (pallas_call at :276, reached through _fa_bwd_call :244).
//
// One CTA per (b*hq, 64-row Q tile), looping over the KV tiles it can see:
//   p = exp(s - lse), dp = dO V^T, ds = p (dp - delta) scale, dq += ds K.
// dq accumulates in WMMA fragments (registers) across the loop and is written
// once.
//
// Bound on an H100 SXM at the main-path shape: three products, 3*b*h*s^2*d =
// 5.2e10 FLOP, 52 us at 989 TFLOP/s; bytes (Q, K, V, dO, dQ, lse, delta)
// 5 x 33.5 MB, 50 us at 3.35 TB/s.
template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int s_q, int s_kv, int hq, int hkv,
                 float sm_scale, int causal) {
  typedef Tiles<D> T;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + T::H);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * T::H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * T::H);
  float* sS = reinterpret_cast<float*>(smem + 4 * T::H);
  float* sdP = reinterpret_cast<float*>(smem + 4 * T::H + T::S);
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * T::H + 2 * T::S);
  float* sLse = reinterpret_cast<float*>(smem + 4 * T::H + 2 * T::S + T::P);
  float* sDelta = sLse + TILE;
  float* sStage = sS;  // fp32 [64][LDO] dq staging, reuses sS and sdP at the end

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int g = hq / hkv;
  const int bh_kv = (bh / hq) * hkv + (bh % hq) / g;
  const bf16* kb = k + (size_t)bh_kv * s_kv * D;
  const bf16* vb = v + (size_t)bh_kv * s_kv * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile<D>(sQ, q + (size_t)bh * s_q * D, q0, s_q);
  load_tile<D>(sdO, dout + (size_t)bh * s_q * D, q0, s_q);
  load_rows(sLse, lse + (size_t)bh * s_q, q0, s_q);
  load_rows(sDelta, delta + (size_t)bh * s_q, q0, s_q);

  FragC dq_acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) wmma::fill_fragment(dq_acc[i], 0.f);

  const int kv_end = causal ? min(s_kv, q0 + TILE) : s_kv;
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();
    load_tile<D>(sK, kb, k0, s_kv);
    load_tile<D>(sV, vb, k0, s_kv);
    __syncthreads();

    rows_times_tile_t<D>(sS + r0 * T::LDS, T::LDS, sQ + r0 * T::LDH, sK);
    rows_times_tile_t<D>(sdP + r0 * T::LDS, T::LDS, sdO + r0 * T::LDH, sV);
    __syncwarp();

    for (int r = r0; r < r0 + 16; ++r) {
      const int qi = q0 + r;
      const float row_lse = sLse[r];
      const float row_delta = sDelta[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const int kj = k0 + c;
        float p = __expf(sS[r * T::LDS + c] * sm_scale - row_lse);
        if ((causal && kj > qi) || kj >= s_kv) p = 0.f;
        const float ds = p * (sdP[r * T::LDS + c] - row_delta) * sm_scale;
        sdS[r * T::LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dq[16 x D] += dS[16 x 64] . K[64 x D]
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
#pragma unroll
      for (int kk = 0; kk < TILE; kk += 16) {
        FragA fa;
        FragBRow fb;
        wmma::load_matrix_sync(fa, sdS + r0 * T::LDP + kk, T::LDP);
        wmma::load_matrix_sync(fb, sK + kk * T::LDH + i * 16, T::LDH);
        wmma::mma_sync(dq_acc[i], fa, fb, dq_acc[i]);
      }
    }
  }
  __syncthreads();  // every warp is done with sS/sdP before they become staging

#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    wmma::store_matrix_sync(sStage + r0 * T::LDO + i * 16, dq_acc[i], T::LDO,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= s_q) break;
    bf16* row = dq + ((size_t)bh * s_q + qi) * D;
    for (int c = lane; c < D; c += 32) row[c] = __float2bfloat16(sStage[r * T::LDO + c]);
  }
}

// ---------------------------------------------------------------------------
// B3. Replaces metis_tpu/ops/flash_attention.py:186 _fa_bwd_dkv_kernel
// (pallas_call at :309, reached through _fa_bwd_call :244).
//
// One CTA per (b*hkv, 64-row KV tile), looping over the g query heads of the
// GQA group and, for each, the Q tiles that can see this KV tile:
//   dv += p^T dO, dk += ds^T Q.
// Warps own KV rows, so the products are taken transposed (S^T = K Q^T,
// dP^T = V dO^T). dk and dv accumulate in registers and each output tile is
// written once: no atomics, as in the reference.
//
// Bound on an H100 SXM at the main-path shape: four products, 4*b*h*s^2*d =
// 6.9e10 FLOP, 69 us at 989 TFLOP/s; bytes (Q, K, V, dO, dK, dV, lse, delta)
// 6 x 33.5 MB, 60 us at 3.35 TB/s.
template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int s_q, int s_kv,
                  int hq, int hkv, float sm_scale, int causal) {
  typedef Tiles<D> T;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + T::H);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * T::H);
  bf16* sdO = reinterpret_cast<bf16*>(smem + 3 * T::H);
  float* sS = reinterpret_cast<float*>(smem + 4 * T::H);           // S^T [kv][q]
  float* sdP = reinterpret_cast<float*>(smem + 4 * T::H + T::S);   // dP^T [kv][q]
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * T::H + 2 * T::S);  // p^T
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * T::H + 2 * T::S + T::P);
  float* sLse = reinterpret_cast<float*>(smem + 4 * T::H + 2 * T::S + 2 * T::P);
  float* sDelta = sLse + TILE;
  float* sStage = sS;

  const int bh_kv = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int g = hq / hkv;
  const int batch = bh_kv / hkv;
  const int kvh = bh_kv % hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile<D>(sK, k + (size_t)bh_kv * s_kv * D, k0, s_kv);
  load_tile<D>(sV, v + (size_t)bh_kv * s_kv * D, k0, s_kv);

  FragC dk_acc[D / 16];
  FragC dv_acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    wmma::fill_fragment(dk_acc[i], 0.f);
    wmma::fill_fragment(dv_acc[i], 0.f);
  }

  // causal: query rows before k0 see none of this tile
  const int q_begin = causal ? (k0 / TILE) * TILE : 0;
  for (int member = 0; member < g; ++member) {
    const int bh = batch * hq + kvh * g + member;
    const bf16* qb = q + (size_t)bh * s_q * D;
    const bf16* dob = dout + (size_t)bh * s_q * D;
    for (int q0 = q_begin; q0 < s_q; q0 += TILE) {
      __syncthreads();
      load_tile<D>(sQ, qb, q0, s_q);
      load_tile<D>(sdO, dob, q0, s_q);
      load_rows(sLse, lse + (size_t)bh * s_q, q0, s_q);
      load_rows(sDelta, delta + (size_t)bh * s_q, q0, s_q);
      __syncthreads();

      rows_times_tile_t<D>(sS + r0 * T::LDS, T::LDS, sK + r0 * T::LDH, sQ);
      rows_times_tile_t<D>(sdP + r0 * T::LDS, T::LDS, sV + r0 * T::LDH, sdO);
      __syncwarp();

      for (int r = r0; r < r0 + 16; ++r) {
        const int kj = k0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          const int qi = q0 + c;
          float p = __expf(sS[r * T::LDS + c] * sm_scale - sLse[c]);
          if ((causal && kj > qi) || qi >= s_q) p = 0.f;
          const float ds = p * (sdP[r * T::LDS + c] - sDelta[c]) * sm_scale;
          sP[r * T::LDP + c] = __float2bfloat16(p);
          sdS[r * T::LDP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();

      // dv[16 x D] += p^T[16 x 64] . dO[64 x D];  dk[16 x D] += ds^T[16 x 64] . Q[64 x D]
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
#pragma unroll
        for (int kk = 0; kk < TILE; kk += 16) {
          FragA fa;
          FragBRow fb;
          wmma::load_matrix_sync(fa, sP + r0 * T::LDP + kk, T::LDP);
          wmma::load_matrix_sync(fb, sdO + kk * T::LDH + i * 16, T::LDH);
          wmma::mma_sync(dv_acc[i], fa, fb, dv_acc[i]);
          wmma::load_matrix_sync(fa, sdS + r0 * T::LDP + kk, T::LDP);
          wmma::load_matrix_sync(fb, sQ + kk * T::LDH + i * 16, T::LDH);
          wmma::mma_sync(dk_acc[i], fa, fb, dk_acc[i]);
        }
      }
    }
  }
  __syncthreads();

  bf16* outs[2] = {dk + (size_t)bh_kv * s_kv * D, dv + (size_t)bh_kv * s_kv * D};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      wmma::store_matrix_sync(sStage + r0 * T::LDO + i * 16,
                              which == 0 ? dk_acc[i] : dv_acc[i], T::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const int kj = k0 + r;
      if (kj >= s_kv) break;
      bf16* row = outs[which] + (size_t)kj * D;
      for (int c = lane; c < D; c += 32) row[c] = __float2bfloat16(sStage[r * T::LDO + c]);
    }
    __syncwarp();
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* m,
                       void* l, int b, int hq, int hkv, int s_q, int s_kv, int causal,
                       int normalize, cudaStream_t stream) {
  cudaError_t err = prepare(fa_fwd_kernel<D>, Tiles<D>::FWD);
  if (err != cudaSuccess) return err;
  dim3 grid((s_q + TILE - 1) / TILE, b * hq);
  fa_fwd_kernel<D><<<grid, THREADS, Tiles<D>::FWD, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(m),
      static_cast<float*>(l), s_q, s_kv, hq, hkv, 1.0f / sqrtf((float)D), causal, normalize);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int b, int hq,
                      int hkv, int s_q, int s_kv, int causal, cudaStream_t stream) {
  cudaError_t err = prepare(fa_bwd_dq_kernel<D>, Tiles<D>::DQ);
  if (err != cudaSuccess) return err;
  dim3 grid((s_q + TILE - 1) / TILE, b * hq);
  fa_bwd_dq_kernel<D><<<grid, THREADS, Tiles<D>::DQ, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), s_q, s_kv, hq, hkv, 1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int b,
                       int hq, int hkv, int s_q, int s_kv, int causal,
                       cudaStream_t stream) {
  cudaError_t err = prepare(fa_bwd_dkv_kernel<D>, Tiles<D>::DKV);
  if (err != cudaSuccess) return err;
  dim3 grid((s_kv + TILE - 1) / TILE, b * hkv);
  fa_bwd_dkv_kernel<D><<<grid, THREADS, Tiles<D>::DKV, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s_q, s_kv, hq, hkv,
      1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

}  // namespace

// C interface. Each function launches on `stream` without synchronising and
// returns cudaGetLastError() (cudaErrorInvalidValue for a head dim with no
// instantiation). The Python wrapper validates shapes, types and contiguity.
extern "C" {

int metis_fa_fwd(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                 int b, int hq, int hkv, int s_q, int s_kv, int d, int causal,
                 int normalize, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_fwd<64>(q, k, v, o, m, l, b, hq, hkv, s_q, s_kv, causal, normalize, st);
    case 128:
      return launch_fwd<128>(q, k, v, o, m, l, b, hq, hkv, s_q, s_kv, causal, normalize, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int metis_fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int b, int hq, int hkv,
                    int s_q, int s_kv, int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, b, hq, hkv, s_q, s_kv, causal, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, b, hq, hkv, s_q, s_kv, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int metis_fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int b, int hq,
                     int hkv, int s_q, int s_kv, int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, s_q, s_kv,
                            causal, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, s_q, s_kv,
                             causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
