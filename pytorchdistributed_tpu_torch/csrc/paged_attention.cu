// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces pytorchdistributed_tpu/ops/pallas_attention.py:_paged_kernel
// (launched by paged_flash_attention): one decode token per slot attends
// that slot's K/V pages, found by chasing its block table through the
// shared pool [num_blocks, block_size, kv_heads, head_dim]. Positions
// <= length are attended; with window > 0 only positions < sink or
// > length - window are, and fully dead middle pages are never read.
// An int8 pool is dequantized row by row (codes * fp32 scale, rounded to
// q's dtype — the ops/quant.kv_dequantize spelling) before the dots, and
// the probabilities are rounded to that dtype before the P·V sum, as the
// Pallas kernel does. The output is acc / max(l, 1e-30) in q's dtype; a
// slot of length 0 still reads page 0 and gives a finite row.
//
// What bounds it: bytes. A tick reads every live K/V row once and does
// 4·head_dim flops per row per q head, far below the ~20 flop/byte at
// which the H100's fp32 units, let alone its tensor cores, become the
// limit. So the design is about keeping enough bytes in flight (about
// 3 MB across the card at 3.35 TB/s) while reading each byte once.
//
// Design (flash-decoding):
//  * Pages split across CTAs. The grid is (split, kv head x tile of the
//    GQA group, slot); a CTA takes a contiguous run of per_split pages,
//    chosen by the caller from the table width and the SM count alone
//    (never from the lengths, which stay on the device). A CTA whose
//    first page lies past its slot's length marks its partial empty and
//    exits at once. Inside the CTA, 4 warps take its pages round-robin.
//  * The whole GQA group (1, 4 or 8 q rows; larger groups tile) shares
//    a CTA, so a kv head's pages are read once for all of its q heads.
//  * 16-byte loads: a lane holds 16 bytes of q's dtype of a row, E = 8
//    bf16 or 4 fp32 elements (an int8 pool reads the same E codes), so
//    head_dim / E lanes cover a row and one warp instruction reads
//    32 / (head_dim / E) rows; a score is a log2(lanes)-step shuffle
//    inside the lane group. A warp issues the K and V rows of a whole
//    chunk of up to 16 rows (one page at block 16, head_dim 64) before
//    any arithmetic, and reads its pages' table entries 32 at a time,
//    up front, so that no page waits on its table read. Enough CTAs
//    keep enough chunks in flight; a second chunk in flight per warp
//    measured no faster.
//  * Every lane group keeps its own online-softmax state in base 2
//    (m, l, acc) in fp32 registers; q sits in shared memory as fp32.
//    Lane groups merge by xor shuffles, warps through shared memory in
//    warp order. With one split the CTA writes the output; otherwise it
//    leaves its fp32 partial (m, l, acc) in the caller's workspace (a
//    CTA past its slot's length leaves l = 0), and paged_merge_kernel
//    folds a row's partials by the log-sum-exp rule in split order, in
//    one pass that reads no lengths. No atomics anywhere: the output is
//    bitwise repeatable, and nothing but the launches touches the host,
//    so a CUDA graph can hold a call. The final divisions are
//    __fdividef: the IEEE division's slow-path call made ptxas spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's finite -inf
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and back to float
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a lane's 16 bytes of one row in q's dtype, to and from fp32
template <typename Q>
struct Slice;
template <>
struct Slice<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void unpack(const uint4& b, float* f) {
    f[0] = __uint_as_float(b.x);
    f[1] = __uint_as_float(b.y);
    f[2] = __uint_as_float(b.z);
    f[3] = __uint_as_float(b.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Slice<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void unpack(const uint4& b, float* f) {
    const unsigned w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      memcpy(&w[i], &h, 4);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// one lane's slice of a pool row: loaded raw, then turned into q's dtype
// (a pool in q's dtype passes through; int8 codes dequantize)
template <typename Q, typename KV>
struct Pool {
  static constexpr bool kQuant = false;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const KV* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint4 to_q(const Raw& r, float) {
    return r;
  }
};

template <int N>
struct Codes;  // N int8 codes in one load
template <>
struct Codes<8> {
  using Raw = uint2;
  static __device__ __forceinline__ int get(const uint2& r, int i) {
    const unsigned w = i < 4 ? r.x : r.y;
    return static_cast<int>(w << (24 - 8 * (i & 3))) >> 24;
  }
};
template <>
struct Codes<4> {
  using Raw = unsigned;
  static __device__ __forceinline__ int get(unsigned r, int i) {
    return static_cast<int>(r << (24 - 8 * i)) >> 24;
  }
};

template <typename Q>
struct Pool<Q, int8_t> {
  static constexpr bool kQuant = true;
  static constexpr int kElems = Slice<Q>::kElems;
  using Raw = typename Codes<kElems>::Raw;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  static __device__ __forceinline__ uint4 to_q(const Raw& r, float s) {
    float f[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i)
      f[i] = round_to<Q>(static_cast<float>(Codes<kElems>::get(r, i)) * s);
    return Slice<Q>::pack(f);
  }
};

template <typename Q, typename KV, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Q* __restrict__ q, const KV* __restrict__ kp,
                       const KV* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, Q* __restrict__ out,
                       float* __restrict__ part_ml,
                       float* __restrict__ part_acc, int heads, int kv_heads,
                       int block_size, int pages, int table_stride,
                       int per_split, int sink, int window,
                       float scale_log2) {
  using P = Pool<Q, KV>;
  constexpr int E = Slice<Q>::kElems;    // elements a lane holds of a row
  constexpr int LANES = D / E;           // lanes a row spans
  constexpr int RPI = 32 / LANES;        // rows one warp instruction reads
  constexpr int NR = 16 / RPI < 4 ? 16 / RPI : 4;  // rows a lane loads
  constexpr int CHUNK = RPI * NR;        // rows a warp issues at once
  static_assert(LANES >= 4 && LANES <= 32, "head_dim 32, 64 or 128");

  const int split = blockIdx.x, splits = gridDim.x;
  const int group = heads / kv_heads;
  const int tiles = (group + G - 1) / G;
  const int kvh = blockIdx.y / tiles;
  const int tile = blockIdx.y % tiles;
  const int slot = blockIdx.z;
  const int rows = min(G, group - tile * G);
  const int head0 = kvh * group + tile * G;  // kv head g owns q rows g*group+
  const int length = lengths[slot];
  const int p0 = split * per_split;
  if (split > 0 && p0 * block_size > length) {
    // past the slot's last live page: an empty partial (l = 0), which
    // the merge passes over without reading its acc (split 0 always
    // runs, so a slot's row is written whatever its length)
    if (threadIdx.x < rows) {
      const int64_t at = (static_cast<int64_t>(slot) * heads + head0
                          + threadIdx.x) * splits + split;
      part_ml[2 * at] = kNegInf;
      part_ml[2 * at + 1] = 0.f;
    }
    return;
  }
  const int p1 = min(p0 + per_split, pages);

  __shared__ __align__(16) float sq[G][D];
  __shared__ float sm[kWarps][G], sl[kWarps][G];
  __shared__ float sacc[kWarps][G][D];
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    sq[g][i % D] =
        g < rows ? to_f(q[(static_cast<int64_t>(slot) * heads + head0 + g) * D
                          + i % D])
                 : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / LANES;  // which row of an instruction
  const int li = lane % LANES;   // which 16 bytes of that row
  const int* trow = tables + static_cast<int64_t>(slot) * table_stride;

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  int entry = 0;  // lane i: the table entry of this warp's page i (mod 32)
  for (int i = 0;; ++i) {
    const int j = p0 + warp + i * kWarps;
    const int base = j * block_size;
    if (j >= p1 || base > length) break;  // later pages lie further out
    if ((i & 31) == 0) {  // the next 32 pages' entries at once
      const int jj = j + lane * kWarps;
      entry = jj < p1 ? trow[jj] : 0;
    }
    const int64_t blk = __shfl_sync(0xffffffffu, entry, i & 31);
    if (window > 0 && base >= sink && base + block_size <= length - window + 1)
      continue;  // fully dead middle page: skipped, never read
    for (int t0 = 0; t0 < block_size; t0 += CHUNK) {
      // every row's loads before any arithmetic
      typename P::Raw kr[NR], vr[NR];
      float ksc[NR], vsc[NR];
      bool ok[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int t = t0 + grp + r * RPI;
        const int pos = base + t;
        bool v = t < block_size && pos <= length;
        if (window > 0) v = v && (pos < sink || pos > length - window);
        ok[r] = v;
        const int64_t row = (blk * block_size + t) * kv_heads + kvh;
        kr[r] = vr[r] = typename P::Raw{};
        ksc[r] = vsc[r] = 0.f;
        if (v) {
          kr[r] = P::load(kp + row * D + li * E);
          vr[r] = P::load(vp + row * D + li * E);
          if constexpr (P::kQuant) {
            ksc[r] = ks[row];
            vsc[r] = vs[row];
          }
        }
      }
      uint4 kq[NR], vq[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        kq[r] = P::to_q(kr[r], ksc[r]);
        vq[r] = P::to_q(vr[r], vsc[r]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= rows) break;
        float qf[E];
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(&sq[g][li * E + e]);
          qf[e] = x.x;
          qf[e + 1] = x.y;
          qf[e + 2] = x.z;
          qf[e + 3] = x.w;
        }
        float s[NR];
        float mc = kNegInf;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          float kf[E];
          Slice<Q>::unpack(kq[r], kf);
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part += qf[e] * kf[e];
#pragma unroll
          for (int o = LANES / 2; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          s[r] = ok[r] ? part * scale_log2 : kNegInf;
          mc = fmaxf(mc, s[r]);
        }
        const float mn = fmaxf(m[g], mc);
        const float corr = exp2f(m[g] - mn);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float p = ok[r] ? exp2f(s[r] - mn) : 0.f;
          l[g] += p;
          const float pv = round_to<Q>(p);  // P cast to V's dtype
          float vf[E];
          Slice<Q>::unpack(vq[r], vf);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += pv * vf[e];
        }
        m[g] = mn;
      }
    }
  }

  // merge the lane groups' states (xor butterfly: every group ends equal)
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = LANES; o < 32; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn), b = exp2f(mo - mn);
      l[g] = l[g] * a + lo * b;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a
                    + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * b;
      m[g] = mn;
    }
  }
  // then the warps', through shared memory in warp order
  if (lane < LANES) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm[warp][g] = m[g];
        sl[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sacc[warp][g][li * E + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w][g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm[w][g] - mx);
      lt += sl[w][g] * f;
      at += sacc[w][g][d] * f;
    }
    const int64_t row = static_cast<int64_t>(slot) * heads + head0 + g;
    if (splits == 1) {
      out[row * D + d] = from_f<Q>(__fdividef(at, fmaxf(lt, 1e-30f)));
    } else {
      const int64_t at_split = row * splits + split;
      part_acc[at_split * D + d] = at;
      if (d == 0) {
        part_ml[2 * at_split] = mx;
        part_ml[2 * at_split + 1] = lt;
      }
    }
  }
}

// one (head, slot) per CTA, one thread per output element: the slot's
// partials folded by the log-sum-exp rule in split order, in one pass;
// an empty partial (l = 0) rescales nothing and its acc is never used
template <typename Q>
__global__ void __launch_bounds__(128)
paged_merge_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, Q* __restrict__ out,
                   int heads, int head_dim, int splits) {
  const int64_t row = static_cast<int64_t>(blockIdx.y) * heads + blockIdx.x;
  const float* ml = part_ml + 2 * row * splits;
  const float* acc = part_acc + row * splits * head_dim;
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float mx = kNegInf, lt = 0.f, at = 0.f;
#pragma unroll 4
    for (int i = 0; i < splits; ++i) {
      const float mi = ml[2 * i], li = ml[2 * i + 1];
      const float ai = acc[static_cast<int64_t>(i) * head_dim + d];
      const float mn = fmaxf(mx, mi);
      const float a = exp2f(mx - mn), b = exp2f(mi - mn);
      lt = lt * a + li * b;
      at = at * a + (li > 0.f ? ai * b : 0.f);
      mx = mn;
    }
    out[row * head_dim + d] = from_f<Q>(__fdividef(at, fmaxf(lt, 1e-30f)));
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *tables, *lengths;
  void* out;
  float *part_ml, *part_acc;
  int slots, heads, kv_heads, head_dim, block_size, pages, table_stride,
      per_split, splits, rows, sink, window;
  float scale_log2;
  cudaStream_t stream;
};

template <typename Q, typename KV, int D, int G>
void launch_main(const Args& a) {
  const int tiles = (a.heads / a.kv_heads + G - 1) / G;
  const dim3 grid(a.splits, a.kv_heads * tiles, a.slots);
  paged_attention_kernel<Q, KV, D, G><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const Q*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), a.ks, a.vs, a.tables, a.lengths,
      static_cast<Q*>(a.out), a.part_ml, a.part_acc, a.heads, a.kv_heads,
      a.block_size, a.pages, a.table_stride, a.per_split, a.sink, a.window,
      a.scale_log2);
}

template <typename Q, typename KV, int D>
cudaError_t launch_rows(const Args& a) {
  switch (a.rows) {
    case 1: launch_main<Q, KV, D, 1>(a); break;
    case 4: launch_main<Q, KV, D, 4>(a); break;
    case 8: launch_main<Q, KV, D, 8>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename Q, typename KV>
cudaError_t launch(const Args& a) {
  cudaError_t err;
  switch (a.head_dim) {
    case 32: err = launch_rows<Q, KV, 32>(a); break;
    case 64: err = launch_rows<Q, KV, 64>(a); break;
    case 128: err = launch_rows<Q, KV, 128>(a); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  paged_merge_kernel<Q><<<dim3(a.heads, a.slots), a.head_dim, 0, a.stream>>>(
      a.part_ml, a.part_acc, static_cast<Q*>(a.out), a.heads, a.head_dim,
      a.splits);
  return cudaGetLastError();
}

}  // namespace

// dtype codes for q (and a model-dtype pool): 0 = float32, 1 = bfloat16.
// kv_int8 != 0 selects the int8 pool with fp32 scales. rows (1, 4 or 8)
// is the q rows of the GQA group a CTA holds; per_split the pages a
// CTA takes. With more than one split, part_ml ([slots, heads, splits,
// 2]) and part_acc ([slots, heads, splits, head_dim]), fp32, take the
// partials; their contents before the call do not matter.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ptd_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* lengths, void* out, float* part_ml, float* part_acc,
    int slots, int heads, int kv_heads, int head_dim, int block_size,
    int pages, int table_stride, int per_split, int rows, int sink,
    int window, float scale, int q_dtype, int kv_int8, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || slots <= 0 || pages <= 0
      || per_split <= 0 || block_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (pages + per_split - 1) / per_split;
  if (splits > 1 && (part_ml == nullptr || part_acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out,
               part_ml, part_acc, slots, heads, kv_heads, head_dim,
               block_size, pages, table_stride, per_split, splits, rows,
               sink, window, scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (q_dtype == 0 && !kv_int8) {
    err = launch<float, float>(a);
  } else if (q_dtype == 0) {
    err = launch<float, int8_t>(a);
  } else if (q_dtype == 1 && !kv_int8) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(a);
  } else if (q_dtype == 1) {
    err = launch<__nv_bfloat16, int8_t>(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
