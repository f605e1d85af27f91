// K3/K3', flash attention: out[b,i,h,:] = sum_j softmax_j(scale * q_i . k_j,
// masked) v_j, streamed over key tiles with an online softmax, stored in
// q's dtype (f32, bf16 or f16). One design per input width:
//   - fp32 inputs: fp32-accurate, products in 3xTF32 on the tensor cores
//     (mma.sync m16n8k8), fp32 accumulation, exact expf.
//   - bf16 and f16 inputs: the function the JAX library's Pallas TPU
//     forward computes on 16-bit inputs (jax/experimental/pallas/ops/tpu/
//     flash_attention.py, _flash_attention_kernel). s = q k^T as 16-bit x
//     16-bit products summed in fp32, times scale, masked; per key tile of
//     128 (the library's block) the running row max m and p = exp(s - m)
//     in fp32; l sums the unrounded p; p is rounded to v's dtype before
//     o += p v, which sums in fp32 (the library's p.astype(v.dtype)). No
//     tf32 split. wgmma for D <= 128, mma.sync m16n8k16 for D <= 256.
//
// Replaces two TPU entries that compute the same function:
//   - mxnet_tpu/ops/contrib.py _flash_attention (K3): the JAX library's
//     Pallas TPU flash attention (jax/experimental/pallas/ops/tpu/
//     flash_attention.py, pallas_call at :758), taken above 1024 keys when
//     S_q % 128 == 0 and D >= 64;
//   - mxnet_tpu/pallas/kernels.py _blockwise_pallas (K3'): the lax.scan
//     online softmax of mxnet_tpu/parallel/ring_attention.py _blockwise_impl
//     that every other backend runs above 1024 keys. On a TPU it keeps p in
//     fp32 on 16-bit inputs too; here both entries share the kernels, so
//     both compute the rounded function in 16 bits, as the backward does.
// This one kernel takes every S_kv above 1024, any S_q and S_kv (not only
// multiples of a tile) and any D up to 256. Causal masking is bottom-right
// aligned as in _blockwise_impl (query i attends keys j <= i + S_kv - S_q);
// a query row with no allowed key is written as zeros.
//
// Bound on an H100: operations. A launch does two products of
// 2 * B * H * S_q * S_kv * D flops (s = q k^T and p v; half of that under
// causal) against about 4 * B * H * S * D * 4 bytes of q, k, v and out; at
// S 4096, D 64 that is 1024 flops a byte. On fp32 CUDA cores the least
// time is 4 * B * H * S_q * S_kv * D / 67 TFLOP/s; in 3xTF32 (three tf32
// passes per product) it is 3 * 4 * B * H * S_q * S_kv * D / 495 TFLOP/s on
// the tensor cores; in 16 bits 4 * B * H * S_q * S_kv * D / 989 TFLOP/s.
//
// Common to every design:
//   - One CTA per (R query rows, batch * head); query tiles vary fastest
//     across the grid, so the CTAs in flight share the K and V of a few
//     heads in L2. Tiles of C keys of K and V stream through a cp.async
//     ring; the copy width (16, 8 or 4 bytes, or plain loads) is chosen
//     per launch from the pointers and strides, and the copy zero-fills
//     keys past S_kv and columns past d, so D 16, 40, 80 and 100 ride in
//     the next DP up. Under causal the key loop ends at the diagonal of
//     the CTA's last row.
//   - Masks (keys past S_kv, bottom-right causal) are applied per
//     accumulator element in tile coordinates. The update is
//     _online_block's, per row: m_new = max(m, rowmax), alpha = exp(m -
//     m_new), p = exp(s * scale - m_new), l = l * alpha + sum p, o = o *
//     alpha + p v; out = o / l (an IEEE divide) and lse = m + log l. A row
//     with no allowed key is written as zeros (lse +inf).
//   - Offsets are 64-bit: q, k, v and out are addressed through their own
//     (batch, seq, head) strides in elements with a contiguous D, so
//     strided views of a fused QKV projection are read in place.
//   - When a gradient is wanted the wrapper passes an fp32 (B * H, S_q)
//     buffer for lse, which the backward kernels (flash_attention_bwd.cu)
//     recompute the probabilities from as exp(s * scale - lse). Serving
//     passes no buffer and writes nothing more.
//
// fp32, with the backward's tile helpers (flash_tiles.cuh, mma_tf32.cuh):
//   - The q tile is staged once, split into tf32 hi and lo; K and V tiles
//     go through a two-stage ring (tile t + 1 copies while tile t
//     computes).
//   - s = q K^T is mma.sync m16n8k8 tf32 in 3xTF32 (lo*hi and hi*lo into
//     an accumulator of their own, then hi*hi), fresh for each tile. Exact
//     expf. A masked score is -1e30, as in _blockwise_impl: a row whose
//     keys are all masked so far keeps m = -1e30 and p = 1 on them until
//     an allowed key arrives and alpha wipes them, as in the plain
//     version.
//   - p v sums each tile into a zeroed accumulator that is then added to
//     o (after o * alpha) with fp32 adds: the tensor cores do not round
//     their accumulation to nearest (flash_attention_bwd.cu). p is fp32
//     and p v takes three passes.
//   - D <= 64: R x C = 128 x 64, 8 warps; a warp owns 16 rows and every key
//     of the tile, so the row max and sum are reduced over the four lanes
//     of a row with two xor shuffles, p is the A fragment of p v as it
//     stands in the s accumulator (the permuted k of flash_tiles.cuh) and a
//     tile step has one barrier, the ring's. D <= 128: 64 x 32, a warp owns
//     32 rows, a quarter of the keys and a quarter of the out columns; D <=
//     256: 32 x 16, 4 warps, 16 rows and halves. These are the backward's
//     tilings, chosen so the ring and q's hi and lo fit the 227 KB of a CTA
//     and o the registers. There a row's keys are split across warps: the
//     row max is combined through shared memory (a second barrier), each
//     warp keeps the sum l over its own keys (alpha is the same in every
//     warp of a row) and the partial sums are added once at the end; p
//     goes through shared memory for p v (a third barrier).
//
// 16 bits, D <= 128 (wgmma.cuh, flash_wg.cuh): 128-key tiles of K and V
// stream through a three-stage ring, q resident, all in 128-byte-swizzled
// 64-column tiles (the backward's layout). D 64: a CTA owns 64 query rows
// (one warpgroup) and two CTAs share an SM (105 KiB of shared memory and
// 191 to 238 registers a thread each); their tile steps are not in
// lockstep, so one CTA's exp overlaps the other's wgmma (faster on an
// H100 than one CTA of two warpgroups). D 128: 128 rows, two warpgroups,
// one CTA per SM (225 KiB).
//   - s = q K^T is wgmma m64n128k16 with both operands from shared memory,
//     K-major. A warp holds 16 whole rows of s, so the row max and sum need
//     only the four lanes of a row (and four independent chains within a
//     thread): no shared-memory combine and no second barrier. p = 2^(s *
//     scale * log2 e - m) is one FFMA and one exp2, with m in that log2
//     domain; masked scores are -inf (p 0). A row's first tile holds key
//     0, which it attends unless it attends none, so no row with an
//     allowed key sees a tile with none before it.
//   - p is packed in place into the 16-bit A fragments of o += p V (the
//     accumulator layout is the A layout): that packing is the rounding to
//     v's dtype. o += p V is wgmma m64nDk16 with A from registers and the V
//     tile MN-major, accumulating in o's registers.
//   - One tile step issues s of tile t and then p V of tile t - 1 as two
//     wgmma groups (at t = 0 a product of zeros), waits for s only, and
//     runs the masks, the exp and the sums while p V of tile t - 1 is
//     still on the tensor cores; then it retires p V, rescales o by alpha
//     and packs p of tile t. A stage of the ring is free once p V of its
//     tile has retired, so the copies run one tile ahead.
//   - Where every row is D 16-byte-aligned elements (the main path), a
//     thread's copies of a tile have their addresses fixed at compile
//     time but for one row step (issue_rows_full): the general copy's
//     per-chunk divisions by a run-time width were the largest cost of a
//     tile step on an H100.
//
// 16 bits, D <= 256 (mma_16bit.cuh): mma.sync m16n8k16. R x C = 64 x 32,
// 4 warps; a warp owns 16 rows, every key of a tile and every out column
// (o is 128 fp32 registers a thread), so p stays in registers as the A
// fragment of p V, packed to 16 bits, and a tile step has one barrier,
// the ring's (three stages, two tiles ahead). q, K and V are 16-bit rows
// of D + 8 elements read with ldmatrix (transposed for V).
//
// Tolerance: within 1e-5 of max |out| of the plain version in fp32 (3xTF32
// drops only lo * lo, below 2^-22 of each product; the sums run in another
// order) and 1e-2 in bf16 and fp16.
//
// C interface for ctypes: flash_attention_launch returns the cudaError_t of
// the launch (0 on success); flash_attention_error_string names it;
// flash_attention_smem_bytes gives the kernel's shared memory per CTA. lse
// may be null.

#include <math.h>

#include "flash_tiles.cuh"
#include "flash_wg.cuh"
#include "mma_16bit.cuh"

using namespace mxtt;

namespace {

constexpr float kNeg = -1e30f;    // the mask value of _blockwise_impl
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;                     // (bh, s_q) row log-sum-exp, or null
  int64_t heads, bh, s_q, s_kv;
  int d;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
  int width;                      // cp.async bytes of k and v rows, 0: plain
};

// fp32: the ring of K and V, q's hi and lo, p where it leaves the
// registers, and one row statistic per warp where a row's keys are split
// across warps
template <typename T, int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  using C = Tiles<DP>;
  return 2 * 2 * C::kStream * stream_stride<T, DP>() * sizeof(T)  // ring
         + 2 * C::kRes * C::kRS * 4                             // hi, lo
         + (C::kRegP ? 0 : C::kRes * C::kSS * 4)                // p
         + (C::kWN > 1 ? C::kWN * C::kRes * 4 : 0);             // m, l
}

// x reduced over the four lanes that hold one row of an accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// the row statistics x[m][hh] of this warp's rows combined over the WN
// warps that share them, through red [WN][R] (max, or sum in warp order);
// every thread of the CTA calls it
template <int R, int MT, int WN, bool MAX>
__device__ __forceinline__ void combine_rows(float (&x)[MT][2], float* red,
                                             int warp, int r0, int g,
                                             int t) {
  if (t == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        red[(warp % WN) * R + r0 + 16 * m + g + 8 * hh] = x[m][hh];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 16 * m + g + 8 * hh;
      float y = red[r];
#pragma unroll
      for (int w = 1; w < WN; ++w) {
        y = MAX ? fmaxf(y, red[w * R + r]) : y + red[w * R + r];
      }
      x[m][hh] = y;
    }
  }
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(Tiles<DP>::kThreads, 1)
flash_attention_kernel(Params p) {
  using C = Tiles<DP>;
  constexpr int BQ = C::kRes;        // query rows of the CTA
  constexpr int BK = C::kStream;     // keys per tile
  constexpr int MT = C::kMT;
  constexpr int WN = C::kWN;
  constexpr int N1 = C::kN1;
  constexpr int N2 = C::kN2;
  constexpr int NT = C::kThreads;
  constexpr int RS = C::kRS;
  constexpr int SS = C::kSS;
  constexpr int RT = stream_stride<T, DP>();
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);                      // [2][BK][RT]
  T* Vs = Ks + 2 * BK * RT;                                 // [2][BK][RT]
  uint32_t* Qh = reinterpret_cast<uint32_t*>(Vs + 2 * BK * RT);  // [BQ][RS]
  uint32_t* Ql = Qh + BQ * RS;
  float* Ps = reinterpret_cast<float*>(Ql + BQ * RS);
  float* red = Ps + (C::kRegP ? 0 : BQ * SS);   // Ps [BQ][SS] unless kRegP,
                                                // red [WN][BQ] if WN > 1

  const int tid = threadIdx.x;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int warp = tid >> 5;
  const int r0 = 16 * MT * (warp / WN);          // the warp's query rows
  const int kofs = (warp % WN) * (BK / WN);      // its keys of a tile
  const int dofs = (warp % WN) * (DP / WN);      // its out columns
  const int64_t bh = bh_index();
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  // key j is allowed for query i when j <= i + offset (bottom-right causal)
  const int64_t offset = p.s_kv - p.s_q;
  int64_t kv_end = p.s_kv;
  if (CAUSAL) {
    const int64_t last_row = (m0 + BQ < p.s_q ? m0 + BQ : p.s_q) - 1;
    const int64_t limit = last_row + offset + 1;
    kv_end = limit < kv_end ? limit : kv_end;
  }
  const int64_t nt = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  auto issue = [&](int64_t tile, int st) {
    const int64_t n0 = tile * BK;
    issue_rows<T, DP, BK, NT>(Ks + st * BK * RT, k, p.k_ss, n0, p.s_kv, p.d,
                              p.width);
    issue_rows<T, DP, BK, NT>(Vs + st * BK * RT, v, p.v_ss, n0, p.s_kv, p.d,
                              p.width);
  };
  if (nt > 0) issue(0, 0);
  cp_async_commit();
  stage_split<T, DP, BQ, NT>(Qh, Ql, q, p.q_ss, m0, p.s_q, p.d);

  // running max and sum of rows r0 + 16 m + g + 8 hh (the sum over this
  // warp's keys where WN > 1)
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_r[m][hh] = kNeg;
      l_r[m][hh] = 0.0f;
    }
  }
  float o[MT * N2][4], part[MT * N2][4];
  zero(o);
  zero(part);

  for (int64_t it = 0; it < nt; ++it) {
    const int st = static_cast<int>(it & 1);
    cp_async_wait<0>();               // tile `it` has landed
    __syncthreads();                  // ... for every thread; tile it - 1,
                                      // its stage, p and red are free
    if (it + 1 < nt) issue(it + 1, st ^ 1);
    cp_async_commit();
    const T* Kt = Ks + st * BK * RT;
    const T* Vt = Vs + st * BK * RT;
    const int64_t n0 = it * BK;
    // masks in tile coordinates: query r, key c of the tile
    const int lim_k = static_cast<int>(p.s_kv - n0 < BK ? p.s_kv - n0 : BK);
    const int64_t dg = m0 + offset - n0;      // allowed when c - r <= dg
    const int diag = static_cast<int>(dg > BK ? BK : (dg < -BQ ? -BQ : dg));

    // (1) s = q K^T: queries r0.., keys kofs..; scaled, masked, row max
    float s[MT * N1][4];
    zero(s);
    product_over_d<T, DP, MT, N1, RS, RT>(s, Qh, Ql, Kt, r0, kofs, g, t);
    float mx[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mx[m][0] = kNeg;
      mx[m][1] = kNeg;
    }
#pragma unroll
    for (int i = 0; i < MT * N1; ++i) {
      const int c = kofs + 8 * (i % N1) + 2 * t;
      const int m = i / N1;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 16 * m + g + 8 * hh;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool ok = c + e < lim_k;
          if (CAUSAL) ok = ok && (c + e) - r <= diag;
          const float x = ok ? s[i][2 * hh + e] * p.scale : kNeg;
          s[i][2 * hh + e] = x;
          mx[m][hh] = fmaxf(mx[m][hh], x);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mx[m][0] = quad_max(mx[m][0]);
      mx[m][1] = quad_max(mx[m][1]);
    }
    if constexpr (WN > 1) {
      combine_rows<BQ, MT, WN, true>(mx, red, warp, r0, g, t);
    }

    // (2) the online softmax update: p in place of s
    float alpha[MT][2], sum[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m_r[m][hh], mx[m][hh]);
        alpha[m][hh] = expf(m_r[m][hh] - m_new);
        m_r[m][hh] = m_new;
        sum[m][hh] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < MT * N1; ++i) {
      const int m = i / N1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(s[i][e] - m_r[m][e >> 1]);
        s[i][e] = pr;
        sum[m][e >> 1] += pr;
      }
      if constexpr (!C::kRegP) {
        const int c = kofs + 8 * (i % N1) + 2 * t;
        const int r = r0 + 16 * m + g;
        *reinterpret_cast<float2*>(Ps + r * SS + c) =
            make_float2(s[i][0], s[i][1]);
        *reinterpret_cast<float2*>(Ps + (r + 8) * SS + c) =
            make_float2(s[i][2], s[i][3]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l_r[m][hh] = l_r[m][hh] * alpha[m][hh] + quad_sum(sum[m][hh]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT * N2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha[i / N2][e >> 1];
    }

    // (3) o += p V over the tile's keys
    if constexpr (C::kRegP) {
      product_over_regs<T, N2, BK, RT>(o, part, s, Vt, dofs, g, t);
    } else {
      __syncthreads();                // p of every warp is stored
      product_over_rows<T, MT, N2, BK, SS, RT>(o, part, Ps, Vt, r0, dofs, g,
                                               t);
    }
  }
  if constexpr (WN > 1) {
    combine_rows<BQ, MT, WN, false>(l_r, red, warp, r0, g, t);
  }

  // out = o / l in q's dtype, lse = m + log l; rows with no allowed key
  // are zeros with lse +inf
#pragma unroll
  for (int i = 0; i < MT * N2; ++i) {
    const int m = i / N2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t row = m0 + r0 + 16 * m + g + 8 * (e >> 1);
      const bool empty = CAUSAL && row + offset < 0;
      o[i][e] = empty ? 0.0f : o[i][e] / l_r[m][e >> 1];
    }
  }
  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
  store_acc<T, N2>(out, p.o_ss, m0 + r0, p.s_q, p.d, dofs, o, 1.0f, g, t);
  if (p.lse != nullptr && t == 0 && warp % WN == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t row = m0 + r0 + 16 * m + g + 8 * hh;
        if (row >= p.s_q) continue;
        const bool empty = CAUSAL && row + offset < 0;
        p.lse[bh * p.s_q + row] =
            empty ? INFINITY : m_r[m][hh] + logf(l_r[m][hh]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The 16-bit designs: the library's function on bf16 and f16 inputs.

constexpr float kLn2 = 0.6931471805599453f;

// the larger (MAX) or the sum of two values
template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return MAX ? fmaxf(a, b) : a + b;
}

// the larger (MAX) or the sum of the 2 J values of row half hh of s, in
// four independent chains: no long chain of dependent adds
template <bool MAX, int J>
__device__ __forceinline__ float row_reduce(const float (&s)[J][4], int hh) {
  static_assert(J % 4 == 0, "four chains");
  float a[4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float x = combine<MAX>(s[j][2 * hh], s[j][2 * hh + 1]);
    a[j % 4] = j < 4 ? x : combine<MAX>(a[j % 4], x);
  }
  return combine<MAX>(combine<MAX>(a[0], a[1]), combine<MAX>(a[2], a[3]));
}

// One tile's online softmax in a 16-bit kernel, per thread, with m in the
// log2 domain (scaled by scale * log2 e): s holds J n-tiles of a warp's
// 16 rows in the accumulator layout (row r and r + 8 of the CTA tile,
// columns 8 j + 2t and 8 j + 2t + 1 of the key tile), whole rows within
// the warp. s becomes p = 2^(s sl2 - m_new) in fp32 (one FFMA and the
// exp2 per element); m and l are updated (l from the unrounded p) and
// alpha = 2^(m - m_new) is returned per row for o. MASKED sets the keys
// past lim_k and, under CAUSAL, those past the bottom-right diagonal
// (allowed when c - r <= diag) to -inf, so their p is 0. A row's first
// tile holds key 0, which it may attend unless it attends none, so a row
// with an allowed key never sees a tile with none before its first.
template <int J, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[J][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2], float sl2,
                                             int r, int t, int lim_k,
                                             int diag) {
  if (MASKED) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        bool ok = c < lim_k;
        if (CAUSAL) ok = ok && c - (r + 8 * (e >> 1)) <= diag;
        s[j][e] = ok ? s[j][e] : -INFINITY;
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float mx = quad_max(row_reduce<true>(s, hh)) * sl2;
    const float m_new = fmaxf(m[hh], mx);
    alpha[hh] = exp2_fast(m[hh] - m_new);
    m[hh] = m_new;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_fast(fmaf(s[j][e], sl2, -m[e >> 1]));
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = l[hh] * alpha[hh] + quad_sum(row_reduce<false>(s, hh));
  }
}

// out = o / l in q's dtype for a warp's 16 rows (row0 + g, + 8) and every
// column, lse = m ln 2 + log l; rows with no allowed key are zeros with
// lse +inf
template <typename T, int J2, bool CAUSAL>
__device__ __forceinline__ void finish_rows(const Params& p, int64_t bh,
                                            T* out, int64_t row0,
                                            float (&o)[J2][4],
                                            const float (&m)[2],
                                            const float (&l)[2], int g,
                                            int t) {
  const int64_t offset = p.s_kv - p.s_q;
#pragma unroll
  for (int j = 0; j < J2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t row = row0 + g + 8 * (e >> 1);
      const bool empty = CAUSAL && row + offset < 0;
      o[j][e] = empty ? 0.0f : o[j][e] / l[e >> 1];
    }
  }
  store_acc<T, J2>(out, p.o_ss, row0, p.s_q, p.d, 0, o, 1.0f, g, t);
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t row = row0 + g + 8 * hh;
      if (row >= p.s_q) continue;
      const bool empty = CAUSAL && row + offset < 0;
      p.lse[bh * p.s_q + row] =
          empty ? INFINITY : m[hh] * kLn2 + logf(l[hh]);
    }
  }
}

// the keys a CTA of query rows [m0, m0 + rows) visits: up to the diagonal
// of its last row under causal
template <bool CAUSAL>
__device__ __forceinline__ int64_t kv_end_of(const Params& p, int64_t m0,
                                             int rows) {
  int64_t kv_end = p.s_kv;
  if (CAUSAL) {
    const int64_t last_row = (m0 + rows < p.s_q ? m0 + rows : p.s_q) - 1;
    const int64_t limit = last_row + p.s_kv - p.s_q + 1;
    kv_end = limit < kv_end ? limit : kv_end;
  }
  return kv_end;
}

// start copying rows [r0, r0 + ROWS) of a (seq, D) operand into the
// swizzled tiles dst [DP / 64][ROWS][128 bytes] with 16-byte cp.async from
// thread tid of NT, when every row is DP elements of 16-byte-aligned
// memory (issue_rows_sw with width 16 and d = DP, its index arithmetic at
// compile time): a thread keeps its 16-byte chunk of a row and steps NT /
// (DP / 8) rows at a time; rows past n are zero-filled
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void issue_rows_full(T* dst, const T* src,
                                                int64_t ss, int64_t r0,
                                                int64_t n, int tid) {
  constexpr int PR = DP * 2 / 16;              // chunks per row
  constexpr int STEP = NT / PR;                // rows per pass
  static_assert(NT % PR == 0 && ROWS % STEP == 0, "whole passes");
  const int c = tid % PR;
  const int r = tid / PR;
  char* o = reinterpret_cast<char*>(dst) + (c >> 3) * ROWS * 128 + r * 128 +
            (((c & 7) ^ (r & 7)) << 4);
  const char* s = reinterpret_cast<const char*>(src + (r0 + r) * ss) + c * 16;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const bool ok = r0 + r + i * STEP < n;
    // STEP is a multiple of 8: the swizzle of row r + i STEP is r's
    cp_async<16>(o + i * STEP * 128,
                 ok ? s + i * STEP * ss * static_cast<int64_t>(sizeof(T))
                    : reinterpret_cast<const char*>(src),
                 ok ? 16 : 0);
  }
}

// tiles of head dim DP (64 or 128) for the wgmma forward: 128 keys per
// tile in a three-stage ring; at D 64 64 query rows (one warpgroup) and two
// CTAs per SM, at D 128 128 rows (two warpgroups) and one
template <int DP>
struct TilesFwdWG {
  static constexpr int kRes = DP == 64 ? 64 : 128;
  static constexpr int kStream = 128;
  static constexpr int kStages = 3;
  static constexpr int kThreads = 2 * kRes;
  static constexpr int kCtasPerSm = DP == 64 ? 2 : 1;
};

template <int DP>
__host__ __device__ constexpr size_t smem_bytes_fwd_wg() {
  using C = TilesFwdWG<DP>;
  return 1024                                       // alignment slack
         + C::kRes * DP * 2                         // q
         + C::kStages * 2 * C::kStream * DP * 2;    // ring of K and V
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(TilesFwdWG<DP>::kThreads,
                                  TilesFwdWG<DP>::kCtasPerSm)
flash_attention_fwd_wgmma_kernel(Params p) {
  using C = TilesFwdWG<DP>;
  constexpr int BQ = C::kRes;        // query rows of the CTA
  constexpr int BK = C::kStream;     // keys per tile
  constexpr int NS = C::kStages;
  constexpr int NT = C::kThreads;
  constexpr int J1 = BK / 8;         // n-tiles of s
  constexpr int J2 = DP / 8;         // n-tiles of o
  extern __shared__ float4 smem4[];
  char* sm = align1024(smem4);
  T* Qs = reinterpret_cast<T*>(sm);                 // [DP / 64][BQ][64]
  T* Ks = Qs + BQ * DP;                             // [NS][DP / 64][BK][64]
  T* Vs = Ks + NS * BK * DP;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = tid >> 7;                          // warpgroup: 64 queries
  const int rw = 64 * wg + 16 * ((tid >> 5) & 3);   // the warp's first query
  const int64_t bh = bh_index();
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float sl2 = p.scale * kLog2e;
  const int64_t offset = p.s_kv - p.s_q;
  const int64_t kv_end = kv_end_of<CAUSAL>(p, m0, BQ);
  const int64_t nt = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  const bool full_rows = p.width == 16 && p.d == DP;
  auto issue = [&](int64_t tile, int st) {
    const int64_t n0 = tile * BK;
    if (full_rows) {
      issue_rows_full<T, DP, BK, NT>(Ks + st * BK * DP, k, p.k_ss, n0,
                                     p.s_kv, tid);
      issue_rows_full<T, DP, BK, NT>(Vs + st * BK * DP, v, p.v_ss, n0,
                                     p.s_kv, tid);
    } else {
      issue_rows_sw<T, DP, BK>(Ks + st * BK * DP, k, p.k_ss, n0, p.s_kv,
                               p.d, p.width, tid, NT);
      issue_rows_sw<T, DP, BK>(Vs + st * BK * DP, v, p.v_ss, n0, p.s_kv,
                               p.d, p.width, tid, NT);
    }
  };
  // group 0: q and the first tile; then one group per tile, NS - 2 ahead
  issue_rows_sw<T, DP, BQ>(Qs, q, p.q_ss, m0, p.s_q, p.d, p.width, tid, NT);
#pragma unroll
  for (int i = 0; i < NS - 2; ++i) {
    if (i < nt) issue(i, i);
    cp_async_commit();
  }
  // this warpgroup's 64 queries of q: A of s
  const uint32_t q_base = smem_u32(Qs) + wg * 64 * 128;

  float m_r[2] = {kNeg, kNeg};       // running max of rows rw + g (+ 8),
  float l_r[2] = {0.0f, 0.0f};       // log2 domain, and sum
  float o[J2][4], s[J1][4];
  zero(o);
  zero(s);
  // p of the previous tile as 16-bit A fragments, and its V tile: zeros
  // and any stage before the first tile, so every step issues p V
  uint32_t ap[BK / 16][4] = {};
  uint32_t v_prev = smem_u32(Vs);

  for (int64_t it = 0; it < nt; ++it) {
    const int st = static_cast<int>(it % NS);
    cp_async_wait<NS - 3>();          // tile `it` (and q) has landed
    fence_proxy_async();              // ... visible to wgmma's reads
    __syncthreads();                  // ... for every thread; p V of tile
                                      // it - 2 has retired, its stage is
                                      // free
    if (it + NS - 2 < nt) {
      issue(it + NS - 2, static_cast<int>((it + NS - 2) % NS));
    }
    cp_async_commit();
    const uint32_t k_base = smem_u32(Ks + st * BK * DP);
    const int64_t n0 = it * BK;
    // masks in tile coordinates: query r, key c of the tile
    const int lim_k = static_cast<int>(p.s_kv - n0 < BK ? p.s_kv - n0 : BK);
    const int64_t dg = m0 + offset - n0;      // allowed when c - r <= dg
    const int diag = static_cast<int>(dg > BK ? BK : (dg < -BQ ? -BQ : dg));
    const bool full_tile = lim_k == BK && (!CAUSAL || diag >= BK - 1);

    // (1) s = q K^T as one group, then o += p V of the previous tile as a
    // second; wait for s only
    fence_regs(s);
    fence_regs(o);
    fence_regs(ap);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BK, T>::template ss<0>(s, desc_k<BQ>(q_base, kk),
                                   desc_k<BK>(k_base, kk), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      Wgmma<DP, T>::template rs<1>(o, ap[kq], desc_mn<BK>(v_prev, kq), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // (2) masks, row max, p and l in fp32, while p V may still run
    float alpha[2];
    if (full_tile) {
      softmax_tile<J1, CAUSAL, false>(s, m_r, l_r, alpha, sl2, rw + g, t,
                                      lim_k, diag);
    } else {
      softmax_tile<J1, CAUSAL, true>(s, m_r, l_r, alpha, sl2, rw + g, t,
                                     lim_k, diag);
    }

    // (3) p V retired: o * alpha; p rounded to T as the next A fragments
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ap);
#pragma unroll
    for (int j = 0; j < J2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) pack_a<T>(ap[kq], s, kq);
    v_prev = smem_u32(Vs + st * BK * DP);
  }
  if (nt > 0) {                       // o += p V of the last tile
    fence_regs(o);
    fence_regs(ap);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      Wgmma<DP, T>::template rs<1>(o, ap[kq], desc_mn<BK>(v_prev, kq), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ap);
  }

  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
  finish_rows<T, J2, CAUSAL>(p, bh, out, m0 + rw, o, m_r, l_r, g, t);
}

// tiles of head dim 256 for the mma.sync forward: 64 query rows (4 warps
// of 16), 32 keys per tile in a three-stage ring, rows of D + 8 elements
struct TilesFwd16 {
  static constexpr int kDP = 256;
  static constexpr int kRes = 64;
  static constexpr int kStream = 32;
  static constexpr int kStages = 3;
  static constexpr int kThreads = 32 * kRes / 16;
  static constexpr int kRS = kDP + 8;
};

__host__ __device__ constexpr size_t smem_bytes_fwd16() {
  using C = TilesFwd16;
  return (C::kStages * 2 * C::kStream + C::kRes) * C::kRS * 2;
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(TilesFwd16::kThreads, 1)
flash_attention_fwd_mma16_kernel(Params p) {
  using C = TilesFwd16;
  constexpr int DP = C::kDP;
  constexpr int BQ = C::kRes;        // query rows of the CTA
  constexpr int BK = C::kStream;     // keys per tile
  constexpr int NS = C::kStages;
  constexpr int NT = C::kThreads;
  constexpr int RS = C::kRS;
  constexpr int J1 = BK / 8;         // n-tiles of s
  constexpr int J2 = DP / 8;         // n-tiles of o
  static_assert(RS == stream_stride<T, DP>(), "one row stride");
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);                     // [NS][BK][RS]
  T* Vs = Ks + NS * BK * RS;                               // [NS][BK][RS]
  T* Qs = Vs + NS * BK * RS;                               // [BQ][RS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * (tid >> 5);                // the warp's query rows
  const int64_t bh = bh_index();
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float sl2 = p.scale * kLog2e;
  const int64_t offset = p.s_kv - p.s_q;
  const int64_t kv_end = kv_end_of<CAUSAL>(p, m0, BQ);
  const int64_t nt = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  auto issue = [&](int64_t tile, int st) {
    const int64_t n0 = tile * BK;
    issue_rows<T, DP, BK, NT>(Ks + st * BK * RS, k, p.k_ss, n0, p.s_kv, p.d,
                              p.width);
    issue_rows<T, DP, BK, NT>(Vs + st * BK * RS, v, p.v_ss, n0, p.s_kv, p.d,
                              p.width);
  };
  // group 0: q and the first tile; then one group per tile
  issue_rows<T, DP, BQ, NT>(Qs, q, p.q_ss, m0, p.s_q, p.d, p.width);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nt) issue(i, i);
    cp_async_commit();
  }

  float m_r[2] = {kNeg, kNeg};
  float l_r[2] = {0.0f, 0.0f};
  float o[J2][4];
  zero(o);

  for (int64_t it = 0; it < nt; ++it) {
    const int st = static_cast<int>(it % NS);
    cp_async_wait<NS - 2>();          // tile `it` (and q) has landed
    __syncthreads();                  // ... for every thread; the stage of
                                      // tile it - 1 is free
    if (it + NS - 1 < nt) {
      issue(it + NS - 1, static_cast<int>((it + NS - 1) % NS));
    }
    cp_async_commit();
    const T* Kt = Ks + st * BK * RS;
    const T* Vt = Vs + st * BK * RS;
    const int64_t n0 = it * BK;
    const int lim_k = static_cast<int>(p.s_kv - n0 < BK ? p.s_kv - n0 : BK);
    const int64_t dg = m0 + offset - n0;      // allowed when c - r <= dg
    const int diag = static_cast<int>(dg > BK ? BK : (dg < -BQ ? -BQ : dg));
    const bool full_tile = lim_k == BK && (!CAUSAL || diag >= BK - 1);

    // (1) s = q K^T: the warp's 16 queries x the tile's keys
    float s[J1][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4];
      ldsm_block<false, true>(aq, Qs, RS, r0, 16 * kk, lane);
#pragma unroll
      for (int j = 0; j < J1; j += 2) {
        uint32_t bk[4];
        ldsm_block<false, false>(bk, Kt, RS, 8 * j, 16 * kk, lane);
        mma16<T>(s[j], aq, bk[0], bk[1]);
        mma16<T>(s[j + 1], aq, bk[2], bk[3]);
      }
    }
    // (2) the online softmax; o * alpha
    float alpha[2];
    if (full_tile) {
      softmax_tile<J1, CAUSAL, false>(s, m_r, l_r, alpha, sl2, r0 + g, t,
                                      lim_k, diag);
    } else {
      softmax_tile<J1, CAUSAL, true>(s, m_r, l_r, alpha, sl2, r0 + g, t,
                                     lim_k, diag);
    }
#pragma unroll
    for (int j = 0; j < J2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    }
    // (3) o += p V, p rounded to T as the A fragments
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      uint32_t ap[4];
      pack_a<T>(ap, s, kq);
#pragma unroll
      for (int j = 0; j < J2; j += 2) {
        uint32_t bv[4];
        ldsm_block<true, true>(bv, Vt, RS, 16 * kq, 8 * j, lane);
        mma16<T>(o[j], ap, bv[0], bv[1]);
        mma16<T>(o[j + 1], ap, bv[2], bv[3]);
      }
    }
  }

  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
  finish_rows<T, J2, CAUSAL>(p, bh, out, m0 + r0, o, m_r, l_r, g, t);
}

// ---------------------------------------------------------------------------
// Launches.

// one launch over (query tiles of `rows`, batch * head)
cudaError_t launch_grid(void (*kernel)(Params), size_t smem, int threads,
                        int rows, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t q_tiles = (p.s_q + rows - 1) / rows;
  const int64_t max_y = 65535;
  const int64_t grid_y = p.bh < max_y ? p.bh : max_y;
  const int64_t grid_z = (p.bh + grid_y - 1) / grid_y;
  if (q_tiles > 0x7fffffffLL || grid_z > max_y) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(q_tiles),
                  static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(grid_z));
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, bool CAUSAL>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  using C = Tiles<DP>;
  constexpr size_t smem = smem_bytes<float, DP>();
  static_assert(smem <= kMaxSmem, "tiles exceed the shared memory of a CTA");
  return launch_grid(flash_attention_kernel<float, DP, CAUSAL>, smem,
                     C::kThreads, C::kRes, p, stream);
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_wg(const Params& p, cudaStream_t stream) {
  using C = TilesFwdWG<DP>;
  constexpr size_t smem = smem_bytes_fwd_wg<DP>();
  static_assert(smem * C::kCtasPerSm <= kMaxSmem,
                "tiles exceed the shared memory of an SM");
  return launch_grid(flash_attention_fwd_wgmma_kernel<T, DP, CAUSAL>, smem,
                     C::kThreads, C::kRes, p, stream);
}

template <typename T, bool CAUSAL>
cudaError_t launch_mma16(const Params& p, cudaStream_t stream) {
  using C = TilesFwd16;
  constexpr size_t smem = smem_bytes_fwd16();
  static_assert(smem <= kMaxSmem, "tiles exceed the shared memory of a CTA");
  return launch_grid(flash_attention_fwd_mma16_kernel<T, CAUSAL>, smem,
                     C::kThreads, C::kRes, p, stream);
}

// fp32: the copy width is that of the streamed k and v rows
cudaError_t launch_dim_f32(const Params& p, bool causal, cudaStream_t s) {
  Params pw = p;
  const int64_t st[6] = {p.k_sb, p.k_ss, p.k_sh, p.v_sb, p.v_ss, p.v_sh};
  pw.width = copy_width(p.k, p.v, sizeof(float), st);
  if (p.d <= 64) {
    return causal ? launch_f32<64, true>(pw, s) : launch_f32<64, false>(pw, s);
  }
  if (p.d <= 128) {
    return causal ? launch_f32<128, true>(pw, s)
                  : launch_f32<128, false>(pw, s);
  }
  return causal ? launch_f32<256, true>(pw, s) : launch_f32<256, false>(pw, s);
}

// 16 bits: q is copied too, so the width is the widest that every row of
// q, k and v allows
template <typename T>
cudaError_t launch_dim16(const Params& p, bool causal, cudaStream_t s) {
  Params pw = p;
  const int64_t qk[6] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh};
  const int64_t vv[6] = {p.v_sb, p.v_ss, p.v_sh, p.v_sb, p.v_ss, p.v_sh};
  const int wqk = copy_width(p.q, p.k, sizeof(T), qk);
  const int wv = copy_width(p.v, p.v, sizeof(T), vv);
  pw.width = wqk < wv ? wqk : wv;
  if (p.d <= 64) {
    return causal ? launch_wg<T, 64, true>(pw, s)
                  : launch_wg<T, 64, false>(pw, s);
  }
  if (p.d <= 128) {
    return causal ? launch_wg<T, 128, true>(pw, s)
                  : launch_wg<T, 128, false>(pw, s);
  }
  return causal ? launch_mma16<T, true>(pw, s) : launch_mma16<T, false>(pw, s);
}

long long smem_f32(int d) {
  if (d <= 64) return static_cast<long long>(smem_bytes<float, 64>());
  if (d <= 128) return static_cast<long long>(smem_bytes<float, 128>());
  return static_cast<long long>(smem_bytes<float, 256>());
}

long long smem_16bit(int d) {
  if (d <= 64) return static_cast<long long>(smem_bytes_fwd_wg<64>());
  if (d <= 128) return static_cast<long long>(smem_bytes_fwd_wg<128>());
  return static_cast<long long>(smem_bytes_fwd16());
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long batch,
    long long heads, long long s_q, long long s_kv, int d, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, float scale,
    int dtype, void* stream) {
  if (q == nullptr || k == nullptr || v == nullptr || out == nullptr ||
      batch <= 0 || heads <= 0 || s_q <= 0 || s_kv <= 0 || d <= 0 ||
      d > 256) {
    return cudaErrorInvalidValue;
  }
  Params p{q, k, v, out, static_cast<float*>(lse), heads, batch * heads,
           s_q, s_kv, d,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, scale, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_dim_f32(p, causal != 0, s);
    case DT_BF16:
      return launch_dim16<__nv_bfloat16>(p, causal != 0, s);
    case DT_F16:
      return launch_dim16<__half>(p, causal != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dynamic shared memory of one CTA for a dtype code and head dim, in
// bytes; -1 for one not taken
extern "C" long long flash_attention_smem_bytes(int dtype, int d) {
  if (d <= 0 || d > 256) return -1;
  switch (dtype) {
    case DT_F32:
      return smem_f32(d);
    case DT_BF16:
    case DT_F16:
      return smem_16bit(d);
    default:
      return -1;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
