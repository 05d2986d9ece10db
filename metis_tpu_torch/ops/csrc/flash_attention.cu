// Blockwise (flash) attention for Hopper: forward, dQ pass and dK/dV pass.
//
// Built by metis_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface (the three extern "C" functions at
// the end), loaded through ctypes by metis_tpu_torch/ops/flash_attention.py.
// hopper.cuh beside this file holds the cp.async, wgmma and lane primitives.
//
// Layout: heads folded into the leading dim. q/o/dO/dq are [b*hq, s_q, D],
// k/v/dk/dv are [b*hkv, s_kv, D], all bf16 and contiguous; m, l, lse and
// delta are fp32 [b*hq, s_q]. GQA (hq > hkv) reads K/V row
// (bh / hq) * hkv + (bh % hq) / g with g = hq / hkv, so K and V are never
// expanded in memory. Causal masking is top-left aligned: query row i sees
// key rows j <= i. Any sequence length runs: the ragged last tile is masked
// here, never padded by the caller.
//
// A Pallas grid on the TPU runs in order and carries (m, l, acc) in VMEM
// scratch across its last grid dimension; on Hopper blocks run in no order,
// so each CTA owns one output tile and loops over the other operand inside
// the CTA, with the causal block skip as the bound of that loop.
//
// All three are built for Hopper: two warpgroups per CTA run their products
// as wgmma, whose accumulator layout is documented, so the softmax and
// gradient elementwise work happens on the accumulators in registers and the
// bf16 weights feed the next product straight from registers. Their tiles
// arrive asynchronously in the 128-byte-swizzled layout wgmma reads, the next
// tile in flight while the current one computes: B1's and B2's through a TMA
// ring that a producer warp fills, B3's through a cp.async ring.
//
// The host side of B1 and B2 builds their TMA tensor maps with
// cuTensorMapEncodeTiled, which it takes from the driver at run time
// (cudaGetDriverEntryPoint), so the library needs no link flag beyond the
// runtime.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f; // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Issue the asynchronous copy of rows [row0, row0 + ROWS) of a contiguous
// [nrows, D] bf16 matrix into a 128-byte-swizzled [ROWS][D] tile (hopper.cuh);
// rows past nrows are zero-filled. All NTHREADS threads of the CTA take part.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_sw128(unsigned char* dst, const bf16* src,
                                                int row0, int nrows) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CHUNKS % NTHREADS == 0, "tile must split evenly over the CTA");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / NTHREADS; ++it) {
    const int i = it * NTHREADS + threadIdx.x;
    const int r = i / CHUNKS;
    const int c = i % CHUNKS;
    const bool valid = row0 + r < nrows;
    metis::cp_async_16(dst + metis::sw128_offset(ROWS, r, c),
                       src + (size_t)(valid ? row0 + r : 0) * D + c * 8, valid);
  }
}

// ---------------------------------------------------------------------------
// B1. Replaces metis_tpu/ops/flash_attention.py:85 _fa_kernel (pallas_call at
// :390, reached through _fa_call :344).
//
// One CTA per (b*hq, 128-row Q tile), looping over 128-row KV tiles with an
// online softmax. normalize=1 writes O = acc / l, normalize=0 the
// unnormalised acc (the stats mode of ring attention); m_out/l_out (optional)
// get the per-row running max and sum.
//
// Bound on an H100 SXM at the main-path shape (b=4, h=32, s=1024, d=128,
// causal, bf16): 4 * b*h*s(s+1)/2 * d = 3.4e10 FLOP, 35 us at 989 TFLOP/s;
// it reads Q, K, V and writes O, 4 x 33.5 MB, 40 us at 3.35 TB/s. Bound by
// bytes, narrowly.
//
// What held the first design back (0.973 ms, 24x its bound): the fp32 output
// accumulator lived in shared memory, loaded, rescaled and stored on every
// KV tile, because WMMA fragments are opaque; S went to shared memory too
// and came back one row at a time per warp with two 5-step shuffle
// reductions; K and V arrived synchronously between two barriers; 113 KB of
// shared memory per 64-row CTA left 8 warps per SM.
//
// This design: a producer warp and two consumer warpgroups, each owning 64
// query rows (16 per warp). The producer's one lane loads Q once and then K
// and V tile by tile with TMA (128-byte-swizzled boxes; rows past the end
// read as zeros) into a two-stage ring, tracked by mbarriers: full when a
// tile has landed, empty when every consumer is done with it. So the next
// tile is in flight while one computes, and the consumers spend no
// instructions and no barrier of the CTA on loads. S = Q K^T is one wgmma
// chain per KV tile (m64n128k16, Q and K read from shared memory through
// descriptors) into registers; the output accumulator O (64 x D per
// warpgroup, D/2 fp32 per thread) is a wgmma accumulator and stays in
// registers for the whole KV loop. The online softmax works on S in place:
// each lane holds two rows, so the row max and sum are two-step quad
// shuffles; exp2 with log2(e) folded into the scale; the alpha rescale
// multiplies O in registers; P is rounded to bf16 in registers and is the A
// operand of O += P V (m64nDk16, V read from shared memory, transposed). No
// fp32 tile touches shared memory. The two warpgroups take turns issuing
// S = Q K^T (named barriers), so one's softmax runs while the other's
// products use the tensor cores. The per-lane row sums are reduced across
// the quad once, after the loop. The causal mask is applied only on the
// diagonal tile (and the ragged end). The heaviest causal Q tiles are
// launched first (reversed blockIdx.x), so the tail wave is short.
// Shared memory per CTA: Q 128 x D bf16 + 2 stages x (K, V) 128 x D bf16 + 7
// mbarriers + 1 KB of alignment slack = 164,920 bytes at D = 128, 83,000 at
// D = 64. Registers (ptxas, CUDA 12.8): 166 per thread at D = 128, 137 at
// D = 64, no spills; 1 CTA (9 warps) per SM.
//
// Tried on the card and left out, because they were slower at the main-path
// shape (tools/torch_kernel_ab.py, H100 80GB HBM3 at 700 W): 64-row KV tiles
// in three stages, 0.138-0.140 ms against 0.130-0.132 ms; the softmax of
// tile j overlapping P V of tile j - 1 inside one warpgroup (S_j and
// P_{j-1} V_{j-1} issued together), 0.180 ms against 0.138 ms at 64-row
// tiles; cp.async loads by all threads with a barrier of the CTA per tile,
// 0.146-0.161 ms.
constexpr int FWD_BM = 128;     // query rows per CTA: 2 consumer warpgroups x 64
constexpr int FWD_BN = 128;     // key rows per KV tile
constexpr int FWD_STAGES = 2;   // K/V ring depth
constexpr int FWD_CONSUMERS = 256;
constexpr int FWD_THREADS = FWD_CONSUMERS + 32;  // + one producer warp
static_assert(FWD_BN == FWD_BM, "every warpgroup sees every KV tile up to the diagonal");

template <int D>
struct FwdSmem {
  static constexpr size_t Q = FWD_BM * D * sizeof(bf16);
  static constexpr size_t KV = FWD_BN * D * sizeof(bf16);
  static constexpr size_t BARS = (1 + 3 * FWD_STAGES) * sizeof(uint64_t);
  // Q, the (K, V) stages, the barriers, alignment slack
  static constexpr size_t BYTES = Q + 2 * FWD_STAGES * KV + BARS + metis::SW128_ATOM;
};

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fa_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
              float* __restrict__ m_out, float* __restrict__ l_out, int s_q,
              int s_kv, int hq, int hkv, float sm_scale, int causal, int normalize) {
  typedef FwdSmem<D> L;
  constexpr int NT = FWD_BN / 8;  // 8-column tiles of S per warp
  constexpr int DT = D / 8;       // 8-column tiles of O per warp
  constexpr int ROW = metis::SW128_ROW;
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + ((metis::SW128_ATOM - metis::smem_u32(smem_raw) %
                                     metis::SW128_ATOM) % metis::SW128_ATOM);
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + L::Q;  // stage s: K at 2s KV, V at (2s + 1) KV
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + 2 * FWD_STAGES * L::KV);
  uint64_t* k_full = q_full + 1;             // [FWD_STAGES]: K of the stage has landed
  uint64_t* v_full = k_full + FWD_STAGES;    // [FWD_STAGES]: V of the stage has landed
  uint64_t* empty = v_full + FWD_STAGES;     // [FWD_STAGES]: every consumer is done with it

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_BM;  // heaviest causal tiles first
  const int g = hq / hkv;
  const int bh_kv = (bh / hq) * hkv + (bh % hq) / g;
  const int kv_end = causal ? min(s_kv, q0 + FWD_BM) : s_kv;
  const int n_tiles = (kv_end + FWD_BN - 1) / FWD_BN;

  if (threadIdx.x == 0) {
    metis::mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      metis::mbar_init(&k_full[s], 1);
      metis::mbar_init(&v_full[s], 1);
      metis::mbar_init(&empty[s], FWD_CONSUMERS);
    }
    metis::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= FWD_CONSUMERS) {  // the producer warp: one lane issues every load
    if (threadIdx.x == FWD_CONSUMERS) {
      metis::mbar_arrive_expect_tx(q_full, L::Q);
      for (int slab = 0; slab < D / 64; ++slab) {
        metis::tma_load_3d(sQ + slab * FWD_BM * ROW, &tm_q, q_full, slab * 64, q0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % FWD_STAGES;
        const int round = j / FWD_STAGES;
        if (round > 0) metis::mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* stage = sKV + s * 2 * L::KV;
        metis::mbar_arrive_expect_tx(&k_full[s], L::KV);
        for (int slab = 0; slab < D / 64; ++slab) {
          metis::tma_load_3d(stage + slab * FWD_BN * ROW, &tm_k, &k_full[s], slab * 64,
                             j * FWD_BN, bh_kv);
        }
        metis::mbar_arrive_expect_tx(&v_full[s], L::KV);
        for (int slab = 0; slab < D / 64; ++slab) {
          metis::tma_load_3d(stage + L::KV + slab * FWD_BN * ROW, &tm_v, &v_full[s],
                             slab * 64, j * FWD_BN, bh_kv);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wq = q0 + warp * 16;  // first query row of this warp

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // rows gid and gid + 8 of the warp: running max (log2 units) and this
  // lane's share of the running sum
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = sm_scale * LOG2E;

  // The two warpgroups take turns issuing S = Q K^T: warpgroup w waits on
  // named barrier 1 + w for its turn and hands the turn over on the other's,
  // so one's softmax runs while the other's products do. Warpgroup 0 starts.
  if (wg == 1) metis::named_bar_arrive(1, FWD_CONSUMERS);
  metis::mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FWD_BN;
    const int s = j % FWD_STAGES;
    const uint32_t parity = (j / FWD_STAGES) & 1;
    const unsigned char* cK = sKV + s * 2 * L::KV;
    const unsigned char* cV = cK + L::KV;

    // KV tiles are as wide as the Q tile, so every row of the CTA sees each
    // tile up to the diagonal one: no warpgroup skips a tile.
    metis::mbar_wait(&k_full[s], parity);
    metis::named_bar_sync(1 + wg, FWD_CONSUMERS);
    // S[64 x 128] = Q[64 x D] . K[128 x D]^T, k16 blocks along D
    float sc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
    metis::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = (kk % 4) * 32;  // byte offset of the k16 block in its slab's rows
      metis::wgmma_m64n128k16_ss(
          sc, metis::desc_k_major(sQ + (kk / 4) * FWD_BM * ROW + wg * 64 * ROW + col),
          metis::desc_k_major(cK + (kk / 4) * FWD_BN * ROW + col), 1);
    }
    metis::wgmma_commit();
    metis::named_bar_arrive(2 - wg, FWD_CONSUMERS);
    metis::wgmma_wait<0>();
    metis::fence_operands(sc);

    // online softmax on the accumulators: lane holds rows gid (e = 0, 1)
    // and gid + 8 (e = 2, 3), columns 8 nt + 2 tig + (e & 1)
    const bool edge = (causal && k0 + FWD_BN - 1 > wq) || k0 + FWD_BN > s_kv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale_log2;
        if (edge) {
          const int col = k0 + nt * 8 + 2 * tig + (e & 1);
          const int row = wq + gid + (e >> 1) * 8;
          if (col >= s_kv || (causal && col > row)) x = -INFINITY;
        }
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], metis::quad_max(mx[r]));
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing seen yet
      alpha[r] = metis::exp2_approx(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = metis::exp2_approx(sc[nt][e] - m_use[e >> 1]);
        sc[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O[64 x D] += P[64 x 128] . V[128 x D], P from registers, V transposed
    uint32_t pa[FWD_BN / 16][4];
#pragma unroll
    for (int kc = 0; kc < FWD_BN / 16; ++kc) {
      pa[kc][0] = metis::pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      pa[kc][1] = metis::pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      pa[kc][2] = metis::pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      pa[kc][3] = metis::pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
    }
    metis::mbar_wait(&v_full[s], parity);
    metis::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < FWD_BN / 16; ++kc) {
      metis::wgmma_rs_tb<D>(acc, pa[kc], metis::desc_mn_major(cV + kc * 16 * ROW, FWD_BN * ROW));
    }
    metis::wgmma_commit();
    metis::wgmma_wait<0>();
    metis::fence_operands(acc);
    metis::mbar_arrive(&empty[s]);  // this thread is done with the stage
  }
  if (wg == 0) metis::named_bar_sync(1, FWD_CONSUMERS);  // warpgroup 1's last hand-over

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq + gid + 8 * r;
    const float l = metis::quad_sum(l_run[r]);
    if (row >= s_q) continue;
    const float inv = (normalize && l != 0.f) ? 1.f / l : 1.f;
    bf16* orow = o + ((size_t)bh * s_q + row) * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          metis::pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (m_out != nullptr && tig == 0) {
      m_out[(size_t)bh * s_q + row] = m_run[r] == -INFINITY ? NEG_INF : m_run[r] * LN2;
      l_out[(size_t)bh * s_q + row] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// B2. Replaces metis_tpu/ops/flash_attention.py:137 _fa_bwd_dq_kernel
// (pallas_call at :276, reached through _fa_bwd_call :244).
//
// One CTA per (b*hq, 128-row Q tile), looping over the 64-row KV tiles its
// rows can see:
//   p = exp(s - lse), dp = dO V^T, ds = p (dp - delta) scale, dq += ds K.
// dq accumulates in registers and each output tile is written once, after
// the loop: no atomics, as in the reference.
//
// Bound on an H100 SXM at the main-path shape (b=4, h=32, s=1024, d=128,
// causal, bf16): three products, 6 * b*h*s(s+1)/2 * d = 5.2e10 FLOP, 52 us
// at 989 TFLOP/s; bytes (Q, K, V, dO, dQ, lse, delta) 5 x 33.5 MB, 50 us at
// 3.35 TB/s. Bound by operations, narrowly.
//
// What held the first design back (0.6684 ms, 13x its bound): S = Q K^T and
// dP = dO V^T were opaque WMMA fragments stored to shared memory as fp32
// tiles and read back one row at a time per warp; dS went to shared memory
// as bf16 and came back as WMMA fragments for dQ += dS K; the A fragments of
// Q and dO were re-read from shared memory for every 16-column tile of S and
// dP, and K's for every 16-column tile of dQ; K and V arrived synchronously
// between two barriers of the CTA; 114 KB of shared memory per 64-row CTA
// of 4 warps left 8 warps per SM; the lightest causal tiles launched first;
// dQ was staged through shared memory and stored one element per lane.
//
// This design is B1's skeleton with a third product: a producer warp and two
// consumer warpgroups, each owning 64 query rows (16 per warp). The
// producer's one lane loads Q and dO once and then K and V tile by tile with
// TMA (128-byte-swizzled boxes; rows past the end read as zeros) into a
// two-stage ring tracked by mbarriers: full when a tile has landed, empty
// when every consumer is done with it. lse (with log2(e) folded in) and
// delta belong to the two rows a lane owns, so each lane reads its four
// values from global memory once, before the loop. Per KV tile a warpgroup
// issues S = Q K^T and dP = dO V^T as two wgmma chains (m64n64k16, both
// operands read from shared memory through descriptors) into registers,
// computes p = exp2(s scale log2e - lse log2e) on S while dP is still in
// flight, then ds = p (dp - delta) scale on the accumulators, rounds dS to
// bf16 in registers and uses it as the A operand of dQ += dS K (m64nDk16, K
// read transposed from shared memory). The dQ accumulator (64 x D per
// warpgroup, D/2 fp32 per thread) stays in registers for the whole loop; no
// tile touches shared memory inside it, and the epilogue stores packed bf16
// pairs straight from the accumulator layout. The causal mask is applied
// only on the diagonal tile (and the ragged end). The last causal KV tile
// lies wholly after warpgroup 0's rows, and a warpgroup with no valid row
// (s_q - q0 <= 64) sees no tile: a warpgroup that skips a tile still waits
// for it to land and then arrives on its empty barrier, so every phase
// counts all consumers and no arrival falls into an earlier round's phase.
// The heaviest causal Q tiles are launched first (reversed blockIdx.x).
// Shared memory per CTA: Q, dO 128 x D bf16 + 2 stages x (K, V) 64 x D bf16
// + 7 mbarriers + 1 KB of alignment slack = 132,152 bytes at D = 128, 66,616
// at D = 64. Registers (ptxas, CUDA 12.8): 158 per thread at D = 128, 125 at
// D = 64, no spills; 1 CTA (9 warps) per SM. 0.135-0.138 ms at the main-path
// shape (tools/torch_kernel_ab.py, H100 80GB HBM3 at 700 W), 2.6x its bound.
//
// Tried on the card and left out, because they were slower at the main-path
// shape (tools/torch_kernel_ab.py, same card, against 0.135-0.137 ms in the
// same calls): the two warpgroups taking turns to issue S and dP (named
// barriers, as in B1), 0.140 ms; three stages, 0.142; no skipped tiles
// (every warpgroup computes every tile, masked), 0.147; dQ += dS K of tile
// j - 1 left in flight while tile j's S and dP are issued, 0.190; p computed
// only after both products retire, 0.148; the first k16 block overwriting S
// and dP (scale_d 0) instead of zeroing them, 0.139; the grid's Q tiles
// slowest-varying (heaviest first across all heads, at the cost of K/V reuse
// in L2), 0.149; 128-row KV tiles, 168 registers with 2,844 bytes of spill
// at D = 128, 0.863 ms (before the fence ahead of the dP chain was added).
constexpr int DQ_BM = 128;    // query rows per CTA: 2 consumer warpgroups x 64
constexpr int DQ_BN = 64;     // key rows per KV tile (the m64n64 products of S and dP)
constexpr int DQ_STAGES = 2;  // K/V ring depth
constexpr int DQ_CONSUMERS = 256;
constexpr int DQ_THREADS = DQ_CONSUMERS + 32;  // + one producer warp

template <int D>
struct DqSmem {
  static constexpr size_t Q = DQ_BM * D * sizeof(bf16);   // Q or dO
  static constexpr size_t KV = DQ_BN * D * sizeof(bf16);  // K or V tile
  static constexpr size_t BARS = (1 + 3 * DQ_STAGES) * sizeof(uint64_t);
  // Q, dO, the (K, V) stages, the barriers, alignment slack
  static constexpr size_t BYTES = 2 * Q + 2 * DQ_STAGES * KV + BARS + metis::SW128_ATOM;
};

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq, int s_q, int s_kv,
                 int hq, int hkv, float sm_scale, int causal) {
  typedef DqSmem<D> L;
  constexpr int NT = DQ_BN / 8;  // 8-column tiles of S and dP per warp
  constexpr int DT = D / 8;      // 8-column tiles of dQ per warp
  constexpr int ROW = metis::SW128_ROW;
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + ((metis::SW128_ATOM - metis::smem_u32(smem_raw) %
                                     metis::SW128_ATOM) % metis::SW128_ATOM);
  unsigned char* sQ = smem;
  unsigned char* sdO = smem + L::Q;
  unsigned char* sKV = smem + 2 * L::Q;  // stage s: K at 2s KV, V at (2s + 1) KV
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(sKV + 2 * DQ_STAGES * L::KV);
  uint64_t* k_full = qdo_full + 1;          // [DQ_STAGES]: K of the stage has landed
  uint64_t* v_full = k_full + DQ_STAGES;    // [DQ_STAGES]: V of the stage has landed
  uint64_t* empty = v_full + DQ_STAGES;     // [DQ_STAGES]: every consumer is done with it

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BM;  // heaviest causal tiles first
  const int g = hq / hkv;
  const int bh_kv = (bh / hq) * hkv + (bh % hq) / g;
  const int kv_end = causal ? min(s_kv, q0 + DQ_BM) : s_kv;
  const int n_tiles = (kv_end + DQ_BN - 1) / DQ_BN;

  if (threadIdx.x == 0) {
    metis::mbar_init(qdo_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      metis::mbar_init(&k_full[s], 1);
      metis::mbar_init(&v_full[s], 1);
      metis::mbar_init(&empty[s], DQ_CONSUMERS);
    }
    metis::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= DQ_CONSUMERS) {  // the producer warp: one lane issues every load
    if (threadIdx.x == DQ_CONSUMERS) {
      metis::mbar_arrive_expect_tx(qdo_full, 2 * L::Q);
      for (int slab = 0; slab < D / 64; ++slab) {
        metis::tma_load_3d(sQ + slab * DQ_BM * ROW, &tm_q, qdo_full, slab * 64, q0, bh);
        metis::tma_load_3d(sdO + slab * DQ_BM * ROW, &tm_do, qdo_full, slab * 64, q0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % DQ_STAGES;
        const int round = j / DQ_STAGES;
        if (round > 0) metis::mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* stage = sKV + s * 2 * L::KV;
        metis::mbar_arrive_expect_tx(&k_full[s], L::KV);
        for (int slab = 0; slab < D / 64; ++slab) {
          metis::tma_load_3d(stage + slab * DQ_BN * ROW, &tm_k, &k_full[s], slab * 64,
                             j * DQ_BN, bh_kv);
        }
        metis::mbar_arrive_expect_tx(&v_full[s], L::KV);
        for (int slab = 0; slab < D / 64; ++slab) {
          metis::tma_load_3d(stage + L::KV + slab * DQ_BN * ROW, &tm_v, &v_full[s],
                             slab * 64, j * DQ_BN, bh_kv);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  // read through a shuffle, so the warpgroup's skip below is a uniform
  // branch: 0.136 ms against 0.146 with warp / 4
  const int wg = metis::warpgroup_index();
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wq = q0 + warp * 16;    // first query row of this warp
  const int wgq = q0 + wg * 64;     // ... and of its warpgroup

  // rows gid and gid + 8 of the warp: lse in log2 units and delta; a row
  // past the end gets p = 0
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq + gid + 8 * r;
    const bool valid = row < s_q;
    lse2[r] = valid ? lse[(size_t)bh * s_q + row] * LOG2E : INFINITY;
    dlt[r] = valid ? delta[(size_t)bh * s_q + row] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float scale_log2 = sm_scale * LOG2E;

  metis::mbar_wait(qdo_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * DQ_BN;
    const int s = j % DQ_STAGES;
    const uint32_t parity = (j / DQ_STAGES) & 1;
    const unsigned char* cK = sKV + s * 2 * L::KV;
    const unsigned char* cV = cK + L::KV;

    metis::mbar_wait(&k_full[s], parity);
    if ((causal && k0 > wgq + 63) || wgq >= s_q) {
      // every key of the tile follows every row of this warpgroup, or it has
      // no valid row: nothing to add. The arrival still counts; waiting for
      // the tile first keeps it out of the stage's previous phase.
      metis::mbar_arrive(&empty[s]);
      continue;
    }

    // S[64 x 64] = Q[64 x D] . K[64 x D]^T and dP = dO . V^T, k16 blocks along D
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    metis::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = (kk % 4) * 32;  // byte offset of the k16 block in its slab's rows
      metis::wgmma_m64n64k16_ss(
          sc, metis::desc_k_major(sQ + (kk / 4) * DQ_BM * ROW + wg * 64 * ROW + col),
          metis::desc_k_major(cK + (kk / 4) * DQ_BN * ROW + col), 1);
    }
    metis::wgmma_commit();
    metis::mbar_wait(&v_full[s], parity);
    // without this fence ptxas fences and waits after every product of the
    // kernel itself (its warning C7520): 0.166 ms against 0.135
    metis::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = (kk % 4) * 32;
      metis::wgmma_m64n64k16_ss(
          dp, metis::desc_k_major(sdO + (kk / 4) * DQ_BM * ROW + wg * 64 * ROW + col),
          metis::desc_k_major(cV + (kk / 4) * DQ_BN * ROW + col), 1);
    }
    metis::wgmma_commit();

    // p on the accumulators while dP is in flight: lane holds rows gid
    // (e = 0, 1) and gid + 8 (e = 2, 3), columns 8 nt + 2 tig + (e & 1)
    metis::wgmma_wait<1>();
    metis::fence_operands(sc);
    const bool edge = (causal && k0 + DQ_BN - 1 > wq) || k0 + DQ_BN > s_kv;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = metis::exp2_approx(sc[nt][e] * scale_log2 - lse2[e >> 1]);
        if (edge) {
          const int col = k0 + nt * 8 + 2 * tig + (e & 1);
          const int row = wq + gid + (e >> 1) * 8;
          if (col >= s_kv || (causal && col > row)) p = 0.f;
        }
        sc[nt][e] = p;
      }
    }
    metis::wgmma_wait<0>();
    metis::fence_operands(dp);

    // dS = p (dp - delta) scale, rounded to bf16 pairs: the A operand of dQ += dS K
    uint32_t da[DQ_BN / 16][4];
#pragma unroll
    for (int kc = 0; kc < DQ_BN / 16; ++kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nt = 2 * kc + h;
        da[kc][2 * h] = metis::pack_bf16(sc[nt][0] * (dp[nt][0] - dlt[0]) * sm_scale,
                                         sc[nt][1] * (dp[nt][1] - dlt[0]) * sm_scale);
        da[kc][2 * h + 1] = metis::pack_bf16(sc[nt][2] * (dp[nt][2] - dlt[1]) * sm_scale,
                                             sc[nt][3] * (dp[nt][3] - dlt[1]) * sm_scale);
      }
    }
    metis::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DQ_BN / 16; ++kc) {
      metis::wgmma_rs_tb<D>(acc, da[kc], metis::desc_mn_major(cK + kc * 16 * ROW, DQ_BN * ROW));
    }
    metis::wgmma_commit();
    metis::wgmma_wait<0>();
    metis::fence_operands(acc);
    metis::mbar_arrive(&empty[s]);  // this thread is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq + gid + 8 * r;
    if (row >= s_q) continue;
    bf16* out = dq + ((size_t)bh * s_q + row) * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8) =
          metis::pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// B3. Replaces metis_tpu/ops/flash_attention.py:186 _fa_bwd_dkv_kernel
// (pallas_call at :309, reached through _fa_bwd_call :244).
//
// One CTA per (b*hkv, 128-row KV tile), looping over the g query heads of
// the GQA group and, for each, the 64-row Q tiles that can see this KV tile:
//   dv += p^T dO, dk += ds^T Q,  p = exp(s - lse), ds = p (dp - delta) scale.
// dk and dv accumulate in registers and each output tile is written once,
// after the loop over the group: no atomics, as in the reference.
//
// Bound on an H100 SXM at the main-path shape: four products,
// 8 * b*h*s(s+1)/2 * d = 6.9e10 FLOP, 70 us at 989 TFLOP/s; bytes (Q, K, V,
// dO, dK, dV, lse, delta) 6 x 33.5 MB, 60 us at 3.35 TB/s. Bound by
// operations.
//
// What held the first design back (1.186 ms, 17x its bound): dK and dV as
// WMMA fragments across 4 warps took 255 registers with 52 bytes of spill at
// D = 128; S^T and dP^T went to shared memory as fp32 and came back, and
// p^T and dS^T went there again as bf16 for the dV and dK products; 123 KB
// of shared memory held one CTA of 4 warps per SM; Q, dO, lse and delta
// arrived synchronously for every Q tile.
//
// This design: two warpgroups, each owning 64 KV rows (16 per warp), with
// their dK and dV rows (2 x 64 x D fp32 per warpgroup, D fp32 per thread) as
// wgmma accumulators. For each Q tile a warpgroup computes S^T = K Q^T and
// dP^T = V dO^T (m64n64k16, both operands read from shared memory through
// descriptors) into registers, applies p = exp2(s scale log2e - lse log2e)
// and ds = p (dp - delta) scale there, with lse and delta per column read
// from shared memory, rounds P^T and dS^T to bf16 in registers, and uses
// them directly as the A operands of dV += P^T dO and dK += dS^T Q (m64nDk16,
// dO and Q read transposed from shared memory). P^T and dS^T never touch
// shared memory. Q, dO, lse and delta flow through two cp.async stages over
// one flattened (group member, Q tile) loop, so the next tile, or the next
// member's first tile, arrives while the current one computes. The causal
// mask is applied only on Q tiles that cross the diagonal (or the ragged
// end); a warpgroup whose 64 keys follow every row of a Q tile skips it. KV
// tile 0 sees every query row, and the grid launches it first.
// Shared memory per CTA: K, V 128 x D bf16 + 2 stages x (Q, dO 64 x D bf16 +
// lse, delta 64 fp32, rounded up to 1 KB) + 1 KB of alignment slack =
// 134,144 bytes at D = 128, 68,608 at D = 64. Registers (ptxas, CUDA 12.8):
// 239 per thread at D = 128, 219 at D = 64, no spills; 1 CTA (8 warps) per SM.
constexpr int DKV_BN = 128;  // key rows per CTA: 2 warpgroups x 64
constexpr int DKV_BM = 64;   // query rows per Q tile
constexpr int DKV_THREADS = 256;

template <int D>
struct DkvSmem {
  static constexpr size_t KV = DKV_BN * D * sizeof(bf16);  // K or V
  static constexpr size_t QT = DKV_BM * D * sizeof(bf16);  // Q or dO tile
  // Q, dO, lse, delta; rounded up so that every stage's tiles start on a swizzle atom
  static constexpr size_t STAGE =
      (2 * QT + 2 * DKV_BM * sizeof(float) + metis::SW128_ATOM - 1) / metis::SW128_ATOM *
      metis::SW128_ATOM;
  static constexpr size_t BYTES = 2 * KV + 2 * STAGE + metis::SW128_ATOM;
};

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
fa_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int s_q, int s_kv,
                  int hq, int hkv, float sm_scale, int causal) {
  typedef DkvSmem<D> L;
  constexpr int NT = DKV_BM / 8;  // 8-column tiles of S^T and dP^T per warp
  constexpr int DT = D / 8;       // 8-column tiles of dK and dV per warp
  constexpr int ROW = metis::SW128_ROW;
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + ((metis::SW128_ATOM - metis::smem_u32(smem_raw) %
                                     metis::SW128_ATOM) % metis::SW128_ATOM);
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::KV;
  unsigned char* stages = smem + 2 * L::KV;  // stage s: Q, dO, lse, delta

  const int bh_kv = blockIdx.y;
  const int k0 = blockIdx.x * DKV_BN;
  const int g = hq / hkv;
  const int batch = bh_kv / hkv;
  const int kvh = bh_kv % hkv;
  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wk = k0 + warp * 16;  // first key row of this warp
  const int wgk = k0 + wg * 64;   // ... and of its warpgroup

  // causal: query rows before k0 see none of this tile
  const int q_begin = causal ? (k0 / DKV_BM) * DKV_BM : 0;
  const int nq = s_q > q_begin ? (s_q - q_begin + DKV_BM - 1) / DKV_BM : 0;
  const int total = g * nq;  // (group member, Q tile) pairs

  auto load_stage = [&](int it) {
    const int q0 = q_begin + (it % nq) * DKV_BM;
    const size_t bh = (size_t)batch * hq + kvh * g + it / nq;
    unsigned char* base = stages + (it & 1) * L::STAGE;
    load_tile_sw128<D, DKV_BM, DKV_THREADS>(base, q + bh * s_q * D, q0, s_q);
    load_tile_sw128<D, DKV_BM, DKV_THREADS>(base + L::QT, dout + bh * s_q * D, q0, s_q);
    if (threadIdx.x < 2 * DKV_BM) {  // lse rows, then delta rows
      const int i = threadIdx.x % DKV_BM;
      const float* src = (threadIdx.x < DKV_BM ? lse : delta) + bh * s_q;
      const bool valid = q0 + i < s_q;
      metis::cp_async_4(reinterpret_cast<float*>(base + 2 * L::QT) + threadIdx.x,
                        src + (valid ? q0 + i : 0), valid);
    }
  };

  load_tile_sw128<D, DKV_BN, DKV_THREADS>(sK, k + (size_t)bh_kv * s_kv * D, k0, s_kv);
  load_tile_sw128<D, DKV_BN, DKV_THREADS>(sV, v + (size_t)bh_kv * s_kv * D, k0, s_kv);
  if (total > 0) load_stage(0);
  metis::cp_async_commit();

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }
  const float scale_log2 = sm_scale * LOG2E;

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) load_stage(it + 1);
    metis::cp_async_commit();
    metis::cp_async_wait<1>();    // this stage (and K, V) have landed for this thread
    metis::fence_proxy_async();  // ... where wgmma reads them
    __syncthreads();              // ... for every thread
    const int q0 = q_begin + (it % nq) * DKV_BM;
    const unsigned char* cQ = stages + (it & 1) * L::STAGE;
    const unsigned char* cdO = cQ + L::QT;
    const float* cLse = reinterpret_cast<const float*>(cQ + 2 * L::QT);
    const float* cDelta = cLse + DKV_BM;

    if (!causal || q0 + DKV_BM - 1 >= wgk) {  // else every row of the tile precedes these keys
      // S^T[64 x 64] = K[64 x D] . Q[64 x D]^T, dP^T = V . dO^T, k16 blocks along D
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
        dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
      }
      metis::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_at = (kk / 4) * DKV_BN * ROW + wg * 64 * ROW + (kk % 4) * 32;
        const int b_at = (kk / 4) * DKV_BM * ROW + (kk % 4) * 32;
        metis::wgmma_m64n64k16_ss(st, metis::desc_k_major(sK + a_at),
                                  metis::desc_k_major(cQ + b_at), 1);
        metis::wgmma_m64n64k16_ss(dpt, metis::desc_k_major(sV + a_at),
                                  metis::desc_k_major(cdO + b_at), 1);
      }
      metis::wgmma_commit();
      metis::wgmma_wait<0>();
      metis::fence_operands(st);
      metis::fence_operands(dpt);

      // p and ds on the accumulators: lane holds key rows gid (e = 0, 1)
      // and gid + 8 (e = 2, 3), query columns 8 nt + 2 tig + (e & 1)
      const bool edge = (causal && q0 < wk + 15) || q0 + DKV_BM > s_q;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + 2 * tig + (e & 1);
          float p = metis::exp2_approx(st[nt][e] * scale_log2 - cLse[qc] * LOG2E);
          if (edge) {
            const int qi = q0 + qc;
            const int kj = wk + gid + (e >> 1) * 8;
            if (qi >= s_q || (causal && kj > qi)) p = 0.f;
          }
          dpt[nt][e] = p * (dpt[nt][e] - cDelta[qc]) * sm_scale;
          st[nt][e] = p;
        }
      }
      uint32_t pa[DKV_BM / 16][4], da[DKV_BM / 16][4];
#pragma unroll
      for (int kc = 0; kc < DKV_BM / 16; ++kc) {
        pa[kc][0] = metis::pack_bf16(st[2 * kc][0], st[2 * kc][1]);
        pa[kc][1] = metis::pack_bf16(st[2 * kc][2], st[2 * kc][3]);
        pa[kc][2] = metis::pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]);
        pa[kc][3] = metis::pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3]);
        da[kc][0] = metis::pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]);
        da[kc][1] = metis::pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]);
        da[kc][2] = metis::pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]);
        da[kc][3] = metis::pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3]);
      }

      // dV[64 x D] += P^T[64 x 64] . dO[64 x D];  dK += dS^T . Q  (B transposed)
      metis::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DKV_BM / 16; ++kc) {
        const uint64_t d_do = metis::desc_mn_major(cdO + kc * 16 * ROW, DKV_BM * ROW);
        const uint64_t d_q = metis::desc_mn_major(cQ + kc * 16 * ROW, DKV_BM * ROW);
        metis::wgmma_rs_tb<D>(dv_acc, pa[kc], d_do);
        metis::wgmma_rs_tb<D>(dk_acc, da[kc], d_q);
      }
      metis::wgmma_commit();
      metis::wgmma_wait<0>();
      metis::fence_operands(dv_acc);
      metis::fence_operands(dk_acc);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  metis::cp_async_wait<0>();  // no copy outlives the CTA (total == 0 leaves K, V in flight)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = wk + gid + 8 * r;
    if (kj >= s_kv) continue;
    const size_t at = ((size_t)bh_kv * s_kv + kj) * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + at + dt * 8) =
          metis::pack_bf16(dk_acc[dt][2 * r], dk_acc[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + dt * 8) =
          metis::pack_bf16(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (so the
// library links the runtime only).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// TMA map of a contiguous [n][rows][d] bf16 tensor, boxes of box_rows x 64
// columns written 128-byte-swizzled; rows past the end read as zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int n, int rows, int d,
                       int box_rows) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                              reinterpret_cast<void**>(&encode),
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(bf16),
                                 (cuuint64_t)rows * d * sizeof(bf16)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* m,
                       void* l, int b, int hq, int hkv, int s_q, int s_kv, int causal,
                       int normalize, cudaStream_t stream) {
  cudaError_t err = prepare(fa_fwd_kernel<D>, FwdSmem<D>::BYTES);
  CUtensorMap tm_q, tm_k, tm_v;
  if (err == cudaSuccess) err = tensor_map(&tm_q, q, b * hq, s_q, D, FWD_BM);
  if (err == cudaSuccess) err = tensor_map(&tm_k, k, b * hkv, s_kv, D, FWD_BN);
  if (err == cudaSuccess) err = tensor_map(&tm_v, v, b * hkv, s_kv, D, FWD_BN);
  if (err != cudaSuccess) return err;
  dim3 grid((s_q + FWD_BM - 1) / FWD_BM, b * hq);
  fa_fwd_kernel<D><<<grid, FWD_THREADS, FwdSmem<D>::BYTES, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(m),
      static_cast<float*>(l), s_q, s_kv, hq, hkv, 1.0f / sqrtf((float)D), causal, normalize);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int b, int hq,
                      int hkv, int s_q, int s_kv, int causal, cudaStream_t stream) {
  cudaError_t err = prepare(fa_bwd_dq_kernel<D>, DqSmem<D>::BYTES);
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (err == cudaSuccess) err = tensor_map(&tm_q, q, b * hq, s_q, D, DQ_BM);
  if (err == cudaSuccess) err = tensor_map(&tm_k, k, b * hkv, s_kv, D, DQ_BN);
  if (err == cudaSuccess) err = tensor_map(&tm_v, v, b * hkv, s_kv, D, DQ_BN);
  if (err == cudaSuccess) err = tensor_map(&tm_do, dout, b * hq, s_q, D, DQ_BM);
  if (err != cudaSuccess) return err;
  dim3 grid((s_q + DQ_BM - 1) / DQ_BM, b * hq);
  fa_bwd_dq_kernel<D><<<grid, DQ_THREADS, DqSmem<D>::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), s_q, s_kv, hq, hkv,
      1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int b,
                       int hq, int hkv, int s_q, int s_kv, int causal,
                       cudaStream_t stream) {
  cudaError_t err = prepare(fa_bwd_dkv_kernel<D>, DkvSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((s_kv + DKV_BN - 1) / DKV_BN, b * hkv);
  fa_bwd_dkv_kernel<D><<<grid, DKV_THREADS, DkvSmem<D>::BYTES, stream>>>(
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
