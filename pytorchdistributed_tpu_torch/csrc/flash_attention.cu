// Flash attention forward and FlashAttention-2 backward for Hopper
// (sm_90a), plain C interface.
//
// Replaces three Pallas kernels of pytorchdistributed_tpu/ops/
// pallas_attention.py:
//   * _fwd_kernel (carry=False, launched by _flash_fwd) -> flash_fwd_kernel:
//     online-softmax attention, writes O and the fp32 row LSE;
//   * _bwd_dkv_kernel (launched by _flash_bwd) -> flash_bwd_dkv_kernel:
//     for one K/V tile, recompute P = exp(S - LSE) and
//     dS = P * (dO·Vᵀ - Δ) * scale against every q tile of every q head
//     of the GQA group, accumulating dV = Pᵀ·dO and dK = dSᵀ·Q;
//   * _bwd_dq_kernel (launched by _flash_bwd) -> flash_bwd_dq_kernel:
//     the same recompute, accumulating dQ = dS·K over the k tiles; it
//     also forms Δ = rowsum(dO ∘ O) for its rows (the Pallas code leaves
//     Δ to XLA) and writes it for the dK/dV kernel, launched after it.
// and, with kCarry = true (the Pallas bodies traced with carry=True), the
// three hop kernels of pytorchdistributed_tpu/ops/ring_attention.py:
//   * _pallas_fwd_update -> flash_fwd_kernel<D, true, kBlockM>: fold one
//     visiting K/V block into the fp32 (m, l, acc) carry, left
//     unnormalized;
//   * _pallas_bwd_update -> flash_bwd_dq_kernel<D, true> and
//     flash_bwd_dkv_kernel<D, true>: add one block's share to the
//     fp32 dQ and to the co-travelling dK/dV accumulators (Δ is read).
// A hop kernel starts from the carry instead of -1e30 / 0 / 0 and stores
// it back in fp32, in place (each CTA reads and writes only its own rows
// or keys). At the ring's hop shape (B·H 96, S 256, D 64) the carry's
// round trip dominates: every hop is bound by bytes, not operations.
//
// Layout: q/k/v/dO are [B, S, Hx, D] bfloat16 with any batch, sequence
// and head strides (multiples of 8 elements, 16-byte aligned base) and a
// unit last stride, so the views of a fused qkv projection are read in
// place. O, dQ, dK and dV are written [B, S, Hx, D]-contiguous; LSE and
// Δ are fp32 [B, H, S]. The hop kernels' carries are fp32: acc, dQ, dK
// and dV [B, S, Hx, D]-contiguous, m and l [B, H, S]. Rows past S are
// loaded as zeros (a padded row never reaches a dot, since 0·NaN is NaN)
// and never written.
//
// Numerics follow the Pallas bodies: bf16 operands with fp32
// accumulation (mma.sync m16n8k16), the scale applied to the fp32
// logits, masked logits at the finite -1e30, p rounded to bf16 before
// P·V and before Pᵀ·dO, dS rounded to bf16 before dSᵀ·Q and dS·K,
// O = acc / max(l, 1e-30) and LSE = m + log(max(l, 1e-30)).
//
// What bounds it: at the GPT-2-small training shape (B·H 96, S 1024,
// D 64, causal) the forward does 12.9 GFLOP over 50.7 MB (254 flop/byte,
// just under the ~295 at which an H100's tensor cores rather than its
// memory become the limit: bound 0.015 ms by bytes), dK/dV 25.8 GFLOP
// over 76 MB and dQ 19.3 GFLOP over 64 MB (above it: bounds 0.026 and
// 0.020 ms by operations). So nothing S x S may reach memory, and the
// products must run on the tensor cores. In practice no kernel here is
// near either bound (4.3-4.5x on the H100, see PERF.md): each spends its
// time issuing instructions per tile pair — shared-memory fragment
// loads, mask arithmetic, exponentials and the mma.sync products
// themselves — and waiting on its own tile loads.
//
// The forward (flash_fwd_kernel) is built to cut those per-pair costs:
//   * one CTA per (b·h, kBlockM-row q tile) and 4 warps at D <= 64: 128
//     rows for the flash step, each warp owning 32 (two 16-row m-tiles
//     that share every K and V fragment it loads, which halves the
//     shared-memory reads per product and gives each warp two
//     independent chains of products); 64 rows, 16 a warp, for the
//     ring's hop, whose S_local 256 would leave 192 CTAs of 128 rows for
//     132 SMs. At D 128 a warp owns 16 rows (its registers hold no more);
//   * the warp's rows of Q are fetched once into A fragments held in
//     registers for the whole K loop;
//   * K/V tiles of 64 keys move through a two-stage ring in shared
//     memory with 16-byte cp.async copies (rows past S zero-filled by the
//     copy itself): tile j + 1 is in flight while tile j is computed, and
//     one barrier per tile both publishes tile j and frees tile j - 1's
//     stage;
//   * fragments come from shared memory by ldmatrix (K's by x4, V's by
//     x4.trans, since P·V wants V key-major): one instruction for four
//     8x8 matrices, in place of 32-bit and 16-bit scalar loads; rows are
//     padded by 8 elements (a 144-byte pitch at D 64), so the eight row
//     addresses of each matrix fall in distinct banks;
//   * only tiles that hold keys past S or, under causal, keys past the
//     warp's first row test a mask: the others run with no compare; a
//     warp whose rows all lie above a tile's first key skips the tile,
//     and on a diagonal tile it skips the 16-key chunks above its last
//     row;
//   * the softmax runs in base 2: scale·log2(e) folded into one fma per
//     logit before ex2, the running max kept in natural units, so LSE and
//     the ring's carried m are unchanged; p becomes P·V's A fragment 16
//     keys at a time, and O takes one reciprocal of l a row.
// What bounds it now: the mma.sync products and the exponentials (one
// ex2 per logit, 16 a clock an SM against 128 fp32 fmas), issued from
// 8 warps an SM in two 255-register CTAs. A warp of 16 rows
// (more CTAs, fewer registers) and K/V tiles of 128 keys (fewer
// barriers and rescales) were both slower on the H100 — see PERF.md.
//
// The backward pair (flash_bwd_dq_kernel, flash_bwd_dkv_kernel) does two
// products more per tile pair than the forward (dO·Vᵀ, and dS·K or Pᵀ·dO
// with dSᵀ·Q) and no running max, and is built from the same pieces:
//   * one CTA per (b·h, 64-row q tile) for dQ and per (b·h_kv, 64-key
//     tile) for dK/dV, 16 rows or keys a warp; the side the CTA does not
//     own streams past it in 64-row tiles;
//   * the operands that never change in the loop are fetched once into A
//     fragments held in registers: Q and dO in dQ; K and V in dK/dV,
//     across every q tile of every q head of the GQA group (at D 128 the
//     dK/dV accumulators leave no room, and K/V fragments are re-read by
//     ldmatrix at each use);
//   * the streamed tiles (K/V in dQ; Q/dO with their LSE and Δ rows in
//     dK/dV) move through a two-stage cp.async ring, one barrier a tile;
//     the dK/dV ring runs on across head boundaries of the group, so the
//     next head's first tile is in flight during this head's last;
//   * every B fragment comes by ldmatrix: x4 where the tile is stored
//     [n][k] (K in Q·Kᵀ, V in dO·Vᵀ, Q in K·Qᵀ, dO in V·dOᵀ), x4.trans
//     where it is stored [k][n] (K in dS·K, dO in Pᵀ·dO, Q in dSᵀ·Q);
//   * the recompute runs 16 keys (dQ) or 16 q rows (dK/dV) at a time,
//     so each chunk's S and dP die in its own two products: P =
//     2^(s·scale·log2(e) - LSE·log2(e)) as one fma and one ex2 an
//     element, LSE staying in natural units at the interface (the ring
//     and the plain twins read it); dS = P·(dP - Δ)·scale;
//   * masks only on diagonal and ragged tiles, as in the forward: a warp
//     that sees nothing of a tile skips it, and on a diagonal tile it
//     skips the 16-wide chunks wholly masked for it;
//   * the flash step's dQ kernel forms Δ from O and its dO fragments,
//     and so launches first; the ring's hops read the Δ their shard
//     computed once.
// What bounds the pair now: shared memory. A warp of 16 rows or keys
// shares no streamed fragment with another, so every chunk issues one
// ldmatrix.x4 (512 bytes; the SM reads 128 a clock) for every two
// mma.sync. Two m-tiles a warp would halve that but need two sets of
// accumulators: for dQ that was 3 % faster on the flash step and 9 %
// slower on the hop, for dK/dV the registers do not hold them; 128-wide
// CTA sides were slower for both kernels — see PERF.md.
// In every kernel the fragments follow the PTX m16n8k16 layouts, and a
// logits fragment turns into the next product's A fragment in registers,
// so S, P and dS never touch shared or device memory; the dK/dV CTA loops
// over the group's q heads itself, so the GQA reduction needs no atomics
// and the backward is deterministic.
// Left to a later change: wgmma with TMA loads and a producer warp
// (warp specialisation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // rows of a streamed K/V or Q/dO tile
constexpr float kNegInf = -1e30f;  // the Pallas kernels' finite -inf

struct Params {
  const bf16 *q, *k, *v, *dout;
  const bf16* o_in;            // the flash dQ kernel's O, for Δ
  const float *lse_in, *delta;
  bf16 *o, *dq, *dk, *dv;
  float *lse, *delta_out;
  float *m, *l, *acc;          // forward hop carry, updated in place
  float *dqf, *dkf, *dvf;      // backward hop carries, updated in place
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, o_sb, o_ss, o_sh;
  int B, S, H, Hkv;
  float scale;
  int causal;
};

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

// The logits fragments s[2c], s[2c+1] (two 16x8 accumulators) rounded to
// bf16 as the A fragment of the 16-deep chunk c of the next product.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4],
                                       const float hi[4]) {
  a[0] = pack_f2(lo[0], lo[1]);
  a[1] = pack_f2(lo[2], lo[3]);
  a[2] = pack_f2(hi[0], hi[1]);
  a[3] = pack_f2(hi[2], hi[3]);
}

// the two bf16 of a packed pair (low half first) as floats, exactly
__device__ __forceinline__ float2 bf16x2_float2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows `row` and `row + 8` of 16x8 fragments, each divided by its row's
// divisor, written as bf16 pairs into a [B, S, Hx, D]-contiguous output
// at (b, row, head)
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float acc[D / 8][4],
                                           float div0, float div1, int b,
                                           int row, int S, int heads,
                                           int head, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + half * 8;
    if (r >= S) continue;
    const float div = half ? div1 : div0;
    bf16* dst = out + ((static_cast<long long>(b) * S + r) * heads + head) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8 + 2 * t) =
          pack_f2(acc[nt][2 * half] / div, acc[nt][2 * half + 1] / div);
  }
}

// a hop's fp32 carry at (b, rows `row` and `row + 8`, head) of a
// [B, S, Hx, D]-contiguous tensor, in the 16x8 accumulator fragments
// (zeros past S), and back
template <int D>
__device__ __forceinline__ void load_rows_f32(float acc[D / 8][4],
                                              const float* src, int b,
                                              int row, int S, int heads,
                                              int head, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + half * 8;
    const float* p =
        src + ((static_cast<long long>(b) * S + min(r, S - 1)) * heads + head) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      float2 val = make_float2(0.f, 0.f);
      if (r < S) val = *reinterpret_cast<const float2*>(p + nt * 8 + 2 * t);
      acc[nt][2 * half] = val.x;
      acc[nt][2 * half + 1] = val.y;
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float acc[D / 8][4],
                                               int b, int row, int S,
                                               int heads, int head, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + half * 8;
    if (r >= S) continue;
    float* dst = out + ((static_cast<long long>(b) * S + r) * heads + head) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(dst + nt * 8 + 2 * t) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// the forward: Q in registers, K/V through a two-stage cp.async ring,
// fragments by ldmatrix

// q rows per CTA of the forward: the flash step's, and the ring hop's
// (the benchmark of the two tilings builds this file with others)
#ifndef PTD_FLASH_FWD_BLOCK_M
#define PTD_FLASH_FWD_BLOCK_M 128
#endif
#ifndef PTD_RING_FWD_BLOCK_M
#define PTD_RING_FWD_BLOCK_M 64
#endif

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing registers and L1;
// with valid false the copy reads nothing and writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices from the shared-memory address `a`, lanes
// 8i..8i+7 giving the row addresses of matrix i; r[i] is the lane's
// fragment of matrix i (row lane / 4, columns 2·(lane % 4) and the next)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same, each matrix transposed: the lane holds rows 2·(lane % 4) and
// the next of column lane / 4
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + kRows) of one head's [S, D] slice into shared memory
// at `sm` (row pitch D + 8) by cp.async from kThreadsT threads; rows past
// S are zero-filled by the copy, never read
template <int D, int kRows, int kThreadsT>
__device__ __forceinline__ void load_tile_async(uint32_t sm, const bf16* base,
                                                long long row_stride,
                                                int row0, int S) {
  constexpr int LD = D + 8, CH = D / 8;
  static_assert(kRows * CH % kThreadsT == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < kRows * CH / kThreadsT; ++it) {
    const int i = threadIdx.x + it * kThreadsT;
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < S;
    cp_async16(sm + (r * LD + c) * 2,
               base + (ok ? static_cast<long long>(row0 + r) * row_stride + c
                          : 0),
               ok);
  }
}

// How the forward divides a q tile of kBlockM rows among warps: 32 rows
// a warp (two 16-row m-tiles, each K and V fragment feeding both) where
// the registers allow it — a 128-row tile at D <= 64 — else 16. K/V
// tiles hold kTile keys.
template <int D, int kBlockM>
struct FwdShape {
  static constexpr int kMt = (D <= 64 && kBlockM == 128) ? 2 : 1;
  static constexpr int kWarps = kBlockM / (16 * kMt);
  static constexpr int kThreads = 32 * kWarps;
  // registers a thread may take, and so the CTAs an SM keeps: 255 for
  // two m-tiles or D 128 (two 4-warp CTAs an SM, or one of 8 warps); one
  // m-tile at D 64 holds 168 (three 4-warp CTAs), at D 32 128 (four)
  static constexpr int kRegs = (kMt == 2 || D == 128) ? 255 : D == 64 ? 168 : 128;
  static constexpr int kMinCtas = 65536 / (kRegs * kThreads);
  // the Q tile and two stages of K and V
  static constexpr int kSmem = (kBlockM + 4 * kTile) * (D + 8) * 2;
};

// One K/V tile of kTile keys at n0 folded into a warp's (m, l, acc) for its
// MT m-tiles of 16 rows, m-tile i holding rows row + 16·i and
// row + 16·i + 8: S = Q·Kᵀ from the register-held Q fragments, the
// online softmax in base 2, acc += bf16(P)·V. `k_lane` and `v_lane` are
// the shared addresses this lane gives ldmatrix for the tile's first
// fragments; the rest are constant offsets from them. kMask: the tile
// holds keys past S or, under causal, keys past one of the warp's rows,
// and those keys get logit -inf; the running m starts at the finite
// -1e30 and never falls below it, so a masked key adds exactly 0 to l and
// acc, as the Pallas body's -1e30 does. Without kMask nothing is tested.
template <int D, int MT, bool kMask>
__device__ __forceinline__ void fwd_tile(const uint32_t qf[MT][D / 16][4],
                                         uint32_t k_lane, uint32_t v_lane,
                                         float acc[MT][D / 8][4],
                                         float m[MT][2], float l[MT][2],
                                         int row, int n0, int S, int causal,
                                         float scale, int lane) {
  constexpr int LD = D + 8;
  const int t = lane & 3;
  // under causal, keys past the warp's last row are masked for all its
  // rows: the 16-key chunks that hold only such keys skip their products
  // and exponentials (their logits stay -inf, their p 0)
  const int chunks = kMask && causal
      ? min(kTile / 16, (row - (lane >> 2) + 16 * MT - 1 - n0) / 16 + 1)
      : kTile / 16;
  float s[MT][kTile / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
      s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      if (np >= chunks) continue;
      uint32_t bk[4];
      ldsm_x4(bk, k_lane + (np * 16 * LD + kc * 16) * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(s[mt][2 * np], qf[mt][kc], bk[0], bk[1]);
        mma16816(s[mt][2 * np + 1], qf[mt][kc], bk[2], bk[3]);
      }
    }

  float mb[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // each row's max over the lane's 16 logits as four chains of four,
    // so few fmaxf wait on one another
    float mx[2][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kMask) {
          const int col = n0 + nt * 8 + 2 * t + (i & 1);
          if (col >= S || (causal && row + mt * 16 + (i >> 1) * 8 < col))
            s[mt][nt][i] = -INFINITY;
        }
        float& c = mx[i >> 1][(nt & 1) * 2 + (i & 1)];
        c = nt < 2 ? s[mt][nt][i] : fmaxf(c, s[mt][nt][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float row_max = fmaxf(fmaxf(mx[r][0], mx[r][1]),
                                  fmaxf(mx[r][2], mx[r][3]));
      const float mn = fmaxf(m[mt][r], quad_max(row_max) * scale);  // scale > 0
      const float corr = ex2((m[mt][r] - mn) * kLog2e);
      mb[mt][r] = mn * kLog2e;
      m[mt][r] = mn;
      l[mt][r] *= corr;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[mt][nt][2 * r] *= corr;
        acc[mt][nt][2 * r + 1] *= corr;
      }
    }
  }
  const float scale2 = scale * kLog2e;
  // p for 16 keys at a time, straight into the A fragment of P·V, so the
  // fp32 logits die as they are used
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    if (kc >= chunks) continue;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 2 * kc; nt < 2 * kc + 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[mt][nt][i] = ex2(fmaf(s[mt][nt][i], scale2, -mb[mt][i >> 1]));
      // the row sums take the 16 keys' four p's per row as a tree
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[mt][r] += (s[mt][2 * kc][2 * r] + s[mt][2 * kc][2 * r + 1]) +
                    (s[mt][2 * kc + 1][2 * r] + s[mt][2 * kc + 1][2 * r + 1]);
      c_to_a(a[mt], s[mt][2 * kc], s[mt][2 * kc + 1]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      ldsm_x4_t(bv, v_lane + (kc * 16 * LD + dp * 16) * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(acc[mt][2 * dp], a[mt], bv[0], bv[1]);
        mma16816(acc[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
      }
    }
  }
}

template <int D, bool kCarry, int kBlockM>
__global__ void __launch_bounds__(FwdShape<D, kBlockM>::kThreads,
                                  FwdShape<D, kBlockM>::kMinCtas)
    flash_fwd_kernel(Params p) {
  using Shape = FwdShape<D, kBlockM>;
  constexpr int LD = D + 8, MT = Shape::kMt, kThreadsT = Shape::kThreads;
  constexpr int kTileBytes = kTile * LD * 2;
  constexpr int kStageBytes = 2 * kTileBytes;  // K then V of one stage
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = smem_addr(smem);
  const uint32_t skv = sq + kBlockM * LD * 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;  // longest rows first
  const int wrow0 = q0 + warp * 16 * MT;  // the warp's rows: 16·MT from here
  const int row = wrow0 + (lane >> 2);    // m-tile i: row + 16·i, and + 8
  const bf16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  load_tile_async<D, kBlockM, kThreadsT>(sq, p.q + b * p.q_sb + h * p.q_sh,
                                         p.q_ss, q0, p.S);
  load_tile_async<D, kTile, kThreadsT>(skv, kb, p.k_ss, 0, p.S);
  load_tile_async<D, kTile, kThreadsT>(skv + kTileBytes, vb, p.v_ss, 0, p.S);
  cp_async_commit();

  float m[MT][2], l[MT][2], acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int rmt = row + mt * 16;
    if constexpr (kCarry) {
      // m is one value per row, the same in all four lanes of a quad; l is
      // a per-lane partial sum over each lane's columns that quad_sum
      // joins at the end, so the carried-in l enters in lane t == 0 only
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = rmt + r * 8;
        m[mt][r] = kNegInf;
        l[mt][r] = 0.f;
        if (rr < p.S) {
          m[mt][r] = p.m[static_cast<long long>(bh) * p.S + rr];
          if (t == 0) l[mt][r] = p.l[static_cast<long long>(bh) * p.S + rr];
        }
      }
      load_rows_f32<D>(acc[mt], p.acc, b, rmt, p.S, p.H, h, lane);
    } else {
      m[mt][0] = m[mt][1] = kNegInf;
      l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[MT][D / 16][4];  // the warp's rows of Q, for the whole loop
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      ldsm_x4(qf[mt][kc],
              sq + (((warp * MT + mt) * 16 + (lane & 15)) * LD +
                    (lane >> 4) * 8 + kc * 16) * 2);
  // the lane's ldmatrix rows in a stage: K [key][d] in matrices (keys 0-7
  // | 8-15) x (d 0-7 | 8-15), which give b0, b1 of a pair of 8-key
  // n-tiles; V the same read transposed, (keys 0-7 | 8-15) x (d 0-7 |
  // 8-15), b0, b1 of a pair of 8-wide d-tiles
  const uint32_t k_lane =
      skv + (((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t v_lane = skv + kTileBytes +
      ((((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8) * 2;

  const int kend = p.causal ? min(p.S, q0 + kBlockM) : p.S;
  const int ntiles = (kend + kTile - 1) / kTile;
  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {
      // tile j has landed, and every warp is done with tile j - 1, whose
      // stage the next copies overwrite
      cp_async_wait_all();
      __syncthreads();
    }
    if (j + 1 < ntiles) {
      const uint32_t next = skv + ((j + 1) & 1) * kStageBytes;
      load_tile_async<D, kTile, kThreadsT>(next, kb, p.k_ss, (j + 1) * kTile,
                                           p.S);
      load_tile_async<D, kTile, kThreadsT>(next + kTileBytes, vb, p.v_ss,
                                           (j + 1) * kTile, p.S);
    }
    cp_async_commit();
    const int n0 = j * kTile;
    // every key of the tile above every row of the warp
    if (p.causal && n0 > wrow0 + 16 * MT - 1) continue;
    const uint32_t stage = (j & 1) * kStageBytes;
    if (n0 + kTile > p.S || (p.causal && n0 + kTile - 1 > wrow0))
      fwd_tile<D, MT, true>(qf, k_lane + stage, v_lane + stage, acc, m, l,
                            row, n0, p.S, p.causal, p.scale, lane);
    else
      fwd_tile<D, MT, false>(qf, k_lane + stage, v_lane + stage, acc, m, l,
                             row, n0, p.S, p.causal, p.scale, lane);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int rmt = row + mt * 16;
    if constexpr (kCarry) {
      // the carry leaves unnormalized: the ring divides once after its
      // last hop
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lr = quad_sum(l[mt][r]);
        const int rr = rmt + r * 8;
        if (t == 0 && rr < p.S) {
          p.m[static_cast<long long>(bh) * p.S + rr] = m[mt][r];
          p.l[static_cast<long long>(bh) * p.S + rr] = lr;
        }
      }
      store_rows_f32<D>(p.acc, acc[mt], b, rmt, p.S, p.H, h, lane);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lsum = fmaxf(quad_sum(l[mt][r]), 1e-30f);
        const int rr = rmt + r * 8;
        if (t == 0 && rr < p.S)
          p.lse[static_cast<long long>(bh) * p.S + rr] = m[mt][r] + logf(lsum);
        // O = acc / l as one reciprocal a row and a product an element
        const float inv = 1.f / lsum;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          acc[mt][nt][2 * r] *= inv;
          acc[mt][nt][2 * r + 1] *= inv;
        }
      }
      store_rows<D>(p.o, acc[mt], 1.f, 1.f, b, rmt, p.S, p.H, h, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// the backward: the warp's invariant operands in registers, the streamed
// side through a two-stage cp.async ring, fragments by ldmatrix

// one fp32 from global to shared memory (4-byte copies: a row statistic's
// rows need not start 16-byte aligned); with valid false it writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

// The lane's ldmatrix row address, in bytes from a tile's start, for the
// first fragments of a [rows][D + 8] bf16 tile:
//   lane_a:  the A operand, rows 0-15 x k 0-15 (x4: a0..a3);
//   lane_nk: a B operand stored [n][k] (x4: b0, b1 of n rows 0-7, then
//            of n rows 8-15, over k 0-15);
//   lane_kn: a B operand stored [k][n] (x4.trans: b0, b1 of n columns
//            0-7, then of 8-15, over k rows 0-15).
// The rest are constant offsets: 16 rows are 16·(D + 8)·2 bytes, 16
// columns 32.
template <int D>
__device__ __forceinline__ uint32_t lane_a(int lane) {
  return ((lane & 15) * (D + 8) + (lane >> 4) * 8) * 2;
}
template <int D>
__device__ __forceinline__ uint32_t lane_nk(int lane) {
  return (((lane >> 4) * 8 + (lane & 7)) * (D + 8) + ((lane >> 3) & 1) * 8) *
         2;
}
template <int D>
__device__ __forceinline__ uint32_t lane_kn(int lane) {
  return ((((lane >> 3) & 1) * 8 + (lane & 7)) * (D + 8) + (lane >> 4) * 8) *
         2;
}

// A backward CTA owns kTile rows (dQ) or keys (dK/dV), 16 a warp.
// Registers a thread may take, and so the CTAs an SM keeps: 168 at
// D <= 64 (three 4-warp CTAs), 255 at D 128 (two). A CTA side of 128
// (8 warps, each streamed tile feeding twice the warps) was slower for
// both kernels on the H100 — see PERF.md.
template <int D>
struct BwdShape {
  static constexpr int kThreads = 32 * (kTile / 16);
  static constexpr int kRegs = D == 128 ? 255 : 168;
  static constexpr int kMinCtas = 65536 / (kRegs * kThreads);
  static constexpr int kTileBytes = kTile * (D + 8) * 2;
  // dQ: its Q and dO tiles, then two stages of K and V
  static constexpr int kDqSmem = 6 * kTileBytes;
  // dK/dV: its K and V tiles, then two stages of Q, dO, LSE and Δ
  static constexpr int kDkvStage = 2 * kTileBytes + 2 * kTile * 4;
  static constexpr int kDkvSmem = 2 * kTileBytes + 2 * kDkvStage;
};

// One K/V tile of kTile keys at n0 folded into a warp's dQ for its 16
// rows (row and row + 8 in this lane), 16 keys at a time: S = Q·Kᵀ and
// dP = dO·Vᵀ from the register-held Q and dO fragments, P = 2^(S·scale·
// log2(e) - LSE·log2(e)) and dS = P·(dP - Δ)·scale, then dQ += bf16(dS)·K.
// `nk` and `kn` are this lane's ldmatrix addresses of the stage's K tile
// ([n][k] for Q·Kᵀ, [k][n] for dS·K; V follows K by one tile); lse2 holds
// the rows' LSE·log2(e), dlt their Δ. kMask: the tile holds keys past S
// or, under causal, past one of the warp's rows; those get P = 0 and
// dS = 0 exactly, and 16-key chunks that hold only such keys are skipped.
// Without kMask nothing is tested.
template <int D, bool kMask>
__device__ __forceinline__ void dq_tile(const uint32_t qf[D / 16][4],
                                        const uint32_t dof[D / 16][4],
                                        uint32_t nk, uint32_t kn,
                                        float dq[D / 8][4],
                                        const float lse2[2],
                                        const float dlt[2], int row, int n0,
                                        int S, int causal, float scale,
                                        int lane) {
  constexpr int LD = D + 8, kTileBytes = kTile * LD * 2;
  const int t = lane & 3;
  int chunks = kTile / 16;
  if (kMask) {
    chunks = min(chunks, (S - 1 - n0) / 16 + 1);
    if (causal)  // keys past the warp's last row
      chunks = min(chunks, (row - (lane >> 2) + 15 - n0) / 16 + 1);
  }
  const float scale2 = scale * kLog2e;
  // not unrolled: unrolled by 2 or 4, ptxas hoists the next chunk's
  // fragment loads and spills at 168 registers, and was no faster
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    float s[2][4], dp[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t bk[4], bv[4];
      ldsm_x4(bk, nk + (c * 16 * LD + kc * 16) * 2);
      ldsm_x4(bv, nk + kTileBytes + (c * 16 * LD + kc * 16) * 2);
      mma16816(s[0], qf[kc], bk[0], bk[1]);
      mma16816(s[1], qf[kc], bk[2], bk[3]);
      mma16816(dp[0], dof[kc], bv[0], bv[1]);
      mma16816(dp[1], dof[kc], bv[2], bv[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i];
        if constexpr (kMask) {
          const int col = n0 + c * 16 + nt * 8 + 2 * t + (i & 1);
          if (col >= S || (causal && row + (i >> 1) * 8 < col)) x = -INFINITY;
        }
        const float pr = ex2(fmaf(x, scale2, -lse2[i >> 1]));
        dp[nt][i] = pr * (dp[nt][i] - dlt[i >> 1]) * scale;
      }
    uint32_t a[4];
    c_to_a(a, dp[0], dp[1]);
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t bk[4];
      ldsm_x4_t(bk, kn + (c * 16 * LD + dd * 16) * 2);
      mma16816(dq[2 * dd], a, bk[0], bk[1]);
      mma16816(dq[2 * dd + 1], a, bk[2], bk[3]);
    }
  }
}

template <int D, bool kCarry>
__global__ void __launch_bounds__(BwdShape<D>::kThreads,
                                  BwdShape<D>::kMinCtas)
    flash_bwd_dq_kernel(Params p) {
  using Shape = BwdShape<D>;
  constexpr int LD = D + 8, kThreadsT = Shape::kThreads;
  constexpr int kTileBytes = Shape::kTileBytes;
  constexpr int kStageBytes = 2 * kTileBytes;  // K then V of one stage
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = smem_addr(smem);
  const uint32_t sdo = sq + kTileBytes;
  const uint32_t skv = sdo + kTileBytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const int wrow0 = q0 + warp * 16;      // the warp's 16 rows
  const int row = wrow0 + (lane >> 2);   // and row + 8
  const bf16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  load_tile_async<D, kTile, kThreadsT>(sq, p.q + b * p.q_sb + h * p.q_sh,
                                       p.q_ss, q0, p.S);
  load_tile_async<D, kTile, kThreadsT>(
      sdo, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.S);
  load_tile_async<D, kTile, kThreadsT>(skv, kb, p.k_ss, 0, p.S);
  load_tile_async<D, kTile, kThreadsT>(skv + kTileBytes, vb, p.v_ss, 0, p.S);
  cp_async_commit();

  // the rows' statistics, for the whole loop (zeros past S). Δ =
  // rowsum(dO ∘ O): the flash step's kernel forms Δ from O and writes it
  // for the dK/dV kernel that follows; the ring's hop reads the Δ its
  // shard computed once
  constexpr bool kFuseDelta = !kCarry;
  float lse2[2], dlt[2];
  uint32_t of[D / 16][4];  // O in the A-fragment layout of dO
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + r * 8;
    const long long i = static_cast<long long>(bh) * p.S + rr;
    lse2[r] = rr < p.S ? p.lse_in[i] * kLog2e : 0.f;
    dlt[r] = rr < p.S && !kFuseDelta ? p.delta[i] : 0.f;
  }
  if constexpr (kFuseDelta) {
    const bf16* ob = p.o_in + b * p.o_sb + h * p.o_sh + 2 * (lane & 3);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = row + (j & 1) * 8;
        of[kc][j] = rr < p.S ? *reinterpret_cast<const uint32_t*>(
                                   ob + rr * p.o_ss + kc * 16 + (j >> 1) * 8)
                             : 0u;
      }
  }
  float dq[D / 8][4];
  if constexpr (kCarry) {
    load_rows_f32<D>(dq, p.dqf, b, row, p.S, p.H, h, lane);
  } else {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
  }

  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];  // the warp's rows, for the loop
  const uint32_t a_off = lane_a<D>(lane) + warp * 16 * LD * 2;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    ldsm_x4(qf[kc], sq + a_off + kc * 32);
    ldsm_x4(dof[kc], sdo + a_off + kc * 32);
  }
  if constexpr (kFuseDelta) {
    // the lane's 2·D/8 products a row (a0, a2 on row, a1, a3 on row + 8),
    // then the quad's
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = bf16x2_float2(dof[kc][j]);
        const float2 y = bf16x2_float2(of[kc][j]);
        dlt[j & 1] = fmaf(x.y, y.y, fmaf(x.x, y.x, dlt[j & 1]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dlt[r] = quad_sum(dlt[r]);
      const int rr = row + r * 8;
      if ((lane & 3) == 0 && rr < p.S)
        p.delta_out[static_cast<long long>(bh) * p.S + rr] = dlt[r];
    }
  }
  const uint32_t nk = skv + lane_nk<D>(lane), kn = skv + lane_kn<D>(lane);

  const int kend = p.causal ? min(p.S, q0 + kTile) : p.S;
  const int ntiles = (kend + kTile - 1) / kTile;
  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {
      // tile j has landed, and every warp is done with tile j - 1, whose
      // stage the next copies overwrite
      cp_async_wait_all();
      __syncthreads();
    }
    if (j + 1 < ntiles) {
      const uint32_t next = skv + ((j + 1) & 1) * kStageBytes;
      load_tile_async<D, kTile, kThreadsT>(next, kb, p.k_ss, (j + 1) * kTile,
                                           p.S);
      load_tile_async<D, kTile, kThreadsT>(next + kTileBytes, vb, p.v_ss,
                                           (j + 1) * kTile, p.S);
    }
    cp_async_commit();
    const int n0 = j * kTile;
    // every key of the tile past every row of the warp
    if (p.causal && n0 > wrow0 + 15) continue;
    const uint32_t stage = (j & 1) * kStageBytes;
    if (n0 + kTile > p.S || (p.causal && n0 + kTile - 1 > wrow0))
      dq_tile<D, true>(qf, dof, nk + stage, kn + stage, dq, lse2, dlt, row,
                       n0, p.S, p.causal, p.scale, lane);
    else
      dq_tile<D, false>(qf, dof, nk + stage, kn + stage, dq, lse2, dlt, row,
                        n0, p.S, p.causal, p.scale, lane);
  }
  if constexpr (kCarry)
    store_rows_f32<D>(p.dqf, dq, b, row, p.S, p.H, h, lane);
  else
    store_rows<D>(p.dq, dq, 1.f, 1.f, b, row, p.S, p.H, h, lane);
}

// q tile `it` of a dK/dV CTA's walk — q head hk·group + it / nq of the
// group, rows qstart + (it % nq)·kTile — into the stage at `st`: its Q
// and dO rows, then its LSE and Δ rows (zeros past S)
template <int D, int kThreadsT>
__device__ __forceinline__ void load_q_tile(uint32_t st, const Params& p,
                                            int b, int hk, int qstart,
                                            int nq, int it) {
  constexpr int kTileBytes = kTile * (D + 8) * 2;
  const int h = hk * (p.H / p.Hkv) + it / nq;
  const int q0 = qstart + (it % nq) * kTile;
  const long long bh = static_cast<long long>(b) * p.H + h;
  load_tile_async<D, kTile, kThreadsT>(st, p.q + b * p.q_sb + h * p.q_sh,
                                       p.q_ss, q0, p.S);
  load_tile_async<D, kTile, kThreadsT>(
      st + kTileBytes, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, p.S);
  for (int i = threadIdx.x; i < 2 * kTile; i += kThreadsT) {
    const int r = i % kTile;
    const float* src = (i < kTile ? p.lse_in : p.delta) + bh * p.S;
    const bool ok = q0 + r < p.S;
    cp_async4(st + 2 * kTileBytes + i * 4, src + (ok ? q0 + r : 0), ok);
  }
}

// One q tile of kTile rows at q0 folded into a warp's dK and dV for its
// 16 keys (key and key + 8 in this lane), 16 q rows at a time: Sᵀ = K·Qᵀ
// and dPᵀ = V·dOᵀ from the warp's K and V fragments (held in registers
// when kHold, else read from the CTA's tiles at ka / va), Pᵀ and dSᵀ as in
// dq_tile with the statistics indexed by column, then dV += bf16(Pᵀ)·dO
// and dK += bf16(dSᵀ)·Q. `nk` and `kn` are this lane's ldmatrix addresses
// of the stage's Q tile (dO follows by one tile), `stats` its LSE row (Δ
// follows by kTile). kMask: the tile holds rows past S or, under causal,
// rows above one of the warp's keys; those get P = 0 and dS = 0 exactly,
// and 16-row chunks that hold only such rows are skipped.
template <int D, bool kHold, bool kMask>
__device__ __forceinline__ void dkv_tile(const uint32_t kf[][4],
                                         const uint32_t vf[][4], uint32_t ka,
                                         uint32_t va, uint32_t nk,
                                         uint32_t kn, const float* stats,
                                         float dk[D / 8][4],
                                         float dv[D / 8][4], int key, int q0,
                                         int S, int causal, float scale,
                                         int lane) {
  constexpr int LD = D + 8, kTileBytes = kTile * LD * 2;
  const int t = lane & 3;
  int first = 0, last = kTile / 16;
  if (kMask) {
    last = min(last, (S - q0 + 15) / 16);
    if (causal)  // rows above the warp's first key
      first = max(0, (key - (lane >> 2) - q0) / 16);
  }
  const float scale2 = scale * kLog2e;
  // not unrolled, as in dq_tile
#pragma unroll 1
  for (int c = first; c < last; ++c) {
    float st[2][4], dpt[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ak[4], av[4], bq[4], bo[4];
      if constexpr (kHold) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[i] = kf[kc][i];
          av[i] = vf[kc][i];
        }
      } else {
        ldsm_x4(ak, ka + kc * 32);
        ldsm_x4(av, va + kc * 32);
      }
      ldsm_x4(bq, nk + (c * 16 * LD + kc * 16) * 2);
      ldsm_x4(bo, nk + kTileBytes + (c * 16 * LD + kc * 16) * 2);
      mma16816(st[0], ak, bq[0], bq[1]);
      mma16816(st[1], ak, bq[2], bq[3]);
      mma16816(dpt[0], av, bo[0], bo[1]);
      mma16816(dpt[1], av, bo[2], bo[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      // this lane's two q rows of the 8-wide n-tile
      const int col = c * 16 + nt * 8 + 2 * t;
      const float2 lse = *reinterpret_cast<const float2*>(stats + col);
      const float2 dl = *reinterpret_cast<const float2*>(stats + kTile + col);
      // -LSE·log2(e) of the two rows, once as the lane reads them
      const float nl2[2] = {-lse.x * kLog2e, -lse.y * kLog2e};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = st[nt][i];
        if constexpr (kMask) {
          const int qr = q0 + col + (i & 1);
          if (qr >= S || (causal && qr < key + (i >> 1) * 8)) x = -INFINITY;
        }
        const float pr = ex2(fmaf(x, scale2, nl2[i & 1]));
        st[nt][i] = pr;
        dpt[nt][i] = pr * (dpt[nt][i] - ((i & 1) ? dl.y : dl.x)) * scale;
      }
    }
    uint32_t ap[4], ads[4];
    c_to_a(ap, st[0], st[1]);
    c_to_a(ads, dpt[0], dpt[1]);
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t bo[4], bq[4];
      ldsm_x4_t(bo, kn + kTileBytes + (c * 16 * LD + dd * 16) * 2);
      ldsm_x4_t(bq, kn + (c * 16 * LD + dd * 16) * 2);
      mma16816(dv[2 * dd], ap, bo[0], bo[1]);
      mma16816(dv[2 * dd + 1], ap, bo[2], bo[3]);
      mma16816(dk[2 * dd], ads, bq[0], bq[1]);
      mma16816(dk[2 * dd + 1], ads, bq[2], bq[3]);
    }
  }
}

template <int D, bool kCarry>
__global__ void __launch_bounds__(BwdShape<D>::kThreads,
                                  BwdShape<D>::kMinCtas)
    flash_bwd_dkv_kernel(Params p) {
  using Shape = BwdShape<D>;
  constexpr int LD = D + 8, kThreadsT = Shape::kThreads;
  constexpr int kTileBytes = Shape::kTileBytes;
  constexpr int kStageBytes = Shape::kDkvStage;
  // at D 128 the K and V fragments would leave the accumulators too few
  // registers: they are read from shared memory at every use instead
  constexpr bool kHold = D <= 64;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sk = smem_addr(smem);
  const uint32_t sv = sk + kTileBytes;
  const int ring_off = 2 * kTileBytes;  // the Q/dO stages, in bytes
  const uint32_t sring = sk + ring_off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bkv = blockIdx.x, b = bkv / p.Hkv, hk = bkv % p.Hkv;
  const int n0 = blockIdx.y * kTile;  // the most q tiles first under causal
  const int kw0 = n0 + warp * 16;       // the warp's 16 keys
  const int key = kw0 + (lane >> 2);    // and key + 8
  load_tile_async<D, kTile, kThreadsT>(sk, p.k + b * p.k_sb + hk * p.k_sh,
                                       p.k_ss, n0, p.S);
  load_tile_async<D, kTile, kThreadsT>(sv, p.v + b * p.v_sb + hk * p.v_sh,
                                       p.v_ss, n0, p.S);
  // the walk: every q tile of every q head of the group, one ring across
  // head boundaries; under causal the first q tile that reaches this CTA's
  // keys starts at n0 (a multiple of kTile)
  const int qstart = p.causal ? n0 : 0;
  const int nq = (p.S - qstart + kTile - 1) / kTile;
  const int ntiles = (p.H / p.Hkv) * nq;
  load_q_tile<D, kThreadsT>(sring, p, b, hk, qstart, nq, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
  if constexpr (kCarry) {
    load_rows_f32<D>(dk, p.dkf, b, key, p.S, p.Hkv, hk, lane);
    load_rows_f32<D>(dv, p.dvf, b, key, p.S, p.Hkv, hk, lane);
  } else {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dk[nt][i] = dv[nt][i] = 0.f;
  }

  cp_async_wait_all();
  __syncthreads();
  const uint32_t a_off = lane_a<D>(lane) + warp * 16 * LD * 2;
  uint32_t kf[kHold ? D / 16 : 1][4], vf[kHold ? D / 16 : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      ldsm_x4(kf[kc], sk + a_off + kc * 32);
      ldsm_x4(vf[kc], sv + a_off + kc * 32);
    }
  }
  const uint32_t nk = sring + lane_nk<D>(lane), kn = sring + lane_kn<D>(lane);

  for (int it = 0; it < ntiles; ++it) {
    if (it > 0) {
      // tile it has landed, and every warp is done with tile it - 1,
      // whose stage the next copies overwrite
      cp_async_wait_all();
      __syncthreads();
    }
    if (it + 1 < ntiles)
      load_q_tile<D, kThreadsT>(sring + ((it + 1) & 1) * kStageBytes, p, b,
                                hk, qstart, nq, it + 1);
    cp_async_commit();
    const int q0 = qstart + (it % nq) * kTile;
    // every row of the tile above every key of the warp
    if (p.causal && q0 + kTile - 1 < kw0) continue;
    const int stage = (it & 1) * kStageBytes;
    const float* stats = reinterpret_cast<const float*>(
        smem + ring_off + stage + 2 * kTileBytes);
    if (q0 + kTile > p.S || (p.causal && q0 < kw0 + 15))
      dkv_tile<D, kHold, true>(kf, vf, sk + a_off, sv + a_off, nk + stage,
                               kn + stage, stats, dk, dv, key, q0, p.S,
                               p.causal, p.scale, lane);
    else
      dkv_tile<D, kHold, false>(kf, vf, sk + a_off, sv + a_off, nk + stage,
                                kn + stage, stats, dk, dv, key, q0, p.S,
                                p.causal, p.scale, lane);
  }
  if constexpr (kCarry) {
    store_rows_f32<D>(p.dkf, dk, b, key, p.S, p.Hkv, hk, lane);
    store_rows_f32<D>(p.dvf, dv, b, key, p.S, p.Hkv, hk, lane);
  } else {
    store_rows<D>(p.dk, dk, 1.f, 1.f, b, key, p.S, p.Hkv, hk, lane);
    store_rows<D>(p.dv, dv, 1.f, 1.f, b, key, p.S, p.Hkv, hk, lane);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Params& p,
                   cudaStream_t st, int threads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

enum Which { kFwd, kDkv, kDq };

template <int D, bool kCarry>
cudaError_t launch_d(Which which, const Params& p, cudaStream_t st) {
  constexpr int bm = kCarry ? PTD_RING_FWD_BLOCK_M : PTD_FLASH_FWD_BLOCK_M;
  using Bwd = BwdShape<D>;
  switch (which) {
    case kFwd:
      return launch(flash_fwd_kernel<D, kCarry, bm>,
                    dim3(p.B * p.H, (p.S + bm - 1) / bm),
                    FwdShape<D, bm>::kSmem, p, st, FwdShape<D, bm>::kThreads);
    case kDkv:
      return launch(flash_bwd_dkv_kernel<D, kCarry>,
                    dim3(p.B * p.Hkv, (p.S + kTile - 1) / kTile),
                    Bwd::kDkvSmem, p, st, Bwd::kThreads);
    default:
      return launch(flash_bwd_dq_kernel<D, kCarry>,
                    dim3(p.B * p.H, (p.S + kTile - 1) / kTile),
                    Bwd::kDqSmem, p, st, Bwd::kThreads);
  }
}

template <bool kCarry>
cudaError_t launch_head_dim(Which which, const Params& p, int D,
                            cudaStream_t st) {
  switch (D) {
    case 32: return launch_d<32, kCarry>(which, p, st);
    case 64: return launch_d<64, kCarry>(which, p, st);
    case 128: return launch_d<128, kCarry>(which, p, st);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, bool carry, Params& p, const long long* strides,
        int nstrided, int B, int S, int H, int Hkv, int D, float scale,
        int causal, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long* dst[5][3] = {{&p.q_sb, &p.q_ss, &p.q_sh},
                          {&p.k_sb, &p.k_ss, &p.k_sh},
                          {&p.v_sb, &p.v_ss, &p.v_sh},
                          {&p.do_sb, &p.do_ss, &p.do_sh},
                          {&p.o_sb, &p.o_ss, &p.o_sh}};
  for (int t = 0; t < nstrided; ++t)
    for (int j = 0; j < 3; ++j) *dst[t][j] = strides[3 * t + j];
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(carry ? launch_head_dim<true>(which, p, D, st)
                                : launch_head_dim<false>(which, p, D, st));
}

// the read-only operands (dout, lse and delta only in the backward)
Params operands(const void* q, const void* k, const void* v,
                const void* dout = nullptr, const void* lse = nullptr,
                const void* delta = nullptr) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  return p;
}

}  // namespace

// strides: (batch, seq, head) element strides of q, k, v (and dO in the
// backward), in that order. Each entry returns cudaGetLastError() after
// its launch (0 = launched).
extern "C" int ptd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* strides,
                             int B, int S, int H, int Hkv, int D, float scale,
                             int causal, void* stream) {
  Params p = operands(q, k, v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  return run(kFwd, false, p, strides, 3, B, S, H, Hkv, D, scale, causal,
             stream);
}

extern "C" int ptd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const long long* strides, int B, int S,
                                 int H, int Hkv, int D, float scale,
                                 int causal, void* stream) {
  Params p = operands(q, k, v, dout, lse, delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  return run(kDkv, false, p, strides, 4, B, S, H, Hkv, D, scale, causal,
             stream);
}

// delta [B, H, S] is written from O and dO (launch the dK/dV kernel
// after this one, on the same stream, to read it); strides carry O's after
// dO's
extern "C" int ptd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                void* delta, const void* o, void* dq,
                                const long long* strides, int B, int S,
                                int H, int Hkv, int D, float scale,
                                int causal, void* stream) {
  Params p = operands(q, k, v, dout, lse);
  p.o_in = static_cast<const bf16*>(o);
  p.delta_out = static_cast<float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  return run(kDq, false, p, strides, 5, B, S, H, Hkv, D, scale, causal,
             stream);
}

// One ring hop. The fp32 carries are updated in place: m and l [B, H, S];
// acc, dq, dk and dv [B, S, Hx, D]-contiguous. causal = 1 is the
// diagonal hop (local positions mask), 0 a fully visible one.
extern "C" int ptd_ring_fwd(const void* q, const void* k, const void* v,
                            void* m, void* l, void* acc,
                            const long long* strides, int B, int S, int H,
                            int Hkv, int D, float scale, int causal,
                            void* stream) {
  Params p = operands(q, k, v);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.acc = static_cast<float*>(acc);
  return run(kFwd, true, p, strides, 3, B, S, H, Hkv, D, scale, causal,
             stream);
}

extern "C" int ptd_ring_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const long long* strides, int B, int S, int H,
                                int Hkv, int D, float scale, int causal,
                                void* stream) {
  Params p = operands(q, k, v, dout, lse, delta);
  p.dkf = static_cast<float*>(dk);
  p.dvf = static_cast<float*>(dv);
  return run(kDkv, true, p, strides, 4, B, S, H, Hkv, D, scale, causal,
             stream);
}

extern "C" int ptd_ring_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq,
                               const long long* strides, int B, int S, int H,
                               int Hkv, int D, float scale, int causal,
                               void* stream) {
  Params p = operands(q, k, v, dout, lse, delta);
  p.dqf = static_cast<float*>(dq);
  return run(kDq, true, p, strides, 4, B, S, H, Hkv, D, scale, causal,
             stream);
}
