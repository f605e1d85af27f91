// K3/K3', flash attention: out[b,i,h,:] = sum_j softmax_j(scale * q_i . k_j,
// masked) v_j, streamed over key tiles with an online softmax, fp32-accurate
// (products in 3xTF32 on the tensor cores, fp32 accumulation, exact expf),
// stored in q's dtype (f32, bf16 or f16).
//
// Replaces two TPU entries that compute the same function:
//   - mxnet_tpu/ops/contrib.py _flash_attention (K3): the JAX library's
//     Pallas TPU flash attention (jax/experimental/pallas/ops/tpu/
//     flash_attention.py, pallas_call at :758), taken above 1024 keys when
//     S_q % 128 == 0 and D >= 64;
//   - mxnet_tpu/pallas/kernels.py _blockwise_pallas (K3'): the lax.scan
//     online softmax of mxnet_tpu/parallel/ring_attention.py _blockwise_impl
//     that every other backend runs above 1024 keys.
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
// the tensor cores.
//
// Design, with the backward's tile helpers (flash_tiles.cuh, mma_tf32.cuh):
//   - One CTA per (R query rows, batch * head); query tiles vary fastest
//     across the grid, so the CTAs in flight share the K and V of a few
//     heads in L2. The q tile is staged once, split into tf32 hi and lo
//     (hi only for 16-bit inputs, which are exact in tf32). Tiles of C keys
//     of K and V stream through a two-stage cp.async ring (tile t + 1 copies
//     while tile t computes); the copy width (16, 8 or 4 bytes, or plain
//     loads) is chosen per launch from the pointers and strides, and the
//     copy zero-fills keys past S_kv and columns past d, so D 16, 40, 80
//     and 100 ride in the next DP up. Under causal the key loop ends at the
//     diagonal of the CTA's last row.
//   - s = q K^T is mma.sync m16n8k8 tf32 in 3xTF32 (lo*hi and hi*lo into
//     an accumulator of their own, then hi*hi; one pass for 16-bit inputs),
//     fresh for each tile. Masks (keys past S_kv, bottom-right causal) are
//     applied per accumulator element in tile coordinates: a masked score
//     is -1e30, as in _blockwise_impl.
//   - The update is _online_block's, per row: m_new = max(m, rowmax),
//     alpha = exp(m - m_new), p = exp(s * scale - m_new), l = l * alpha +
//     sum p, o = o * alpha + p v; out = o / l and lse = m + log l. Exact
//     expf and an IEEE divide. A row whose keys are all masked so far keeps
//     m = -1e30 and p = 1 on them until an allowed key arrives and alpha
//     wipes them, as in the plain version; a row with no allowed key at all
//     is written as zeros (lse +inf).
//   - p v sums each tile into a zeroed accumulator that is then added to
//     o (after o * alpha) with fp32 adds: the tensor cores do not round
//     their accumulation to nearest (flash_attention_bwd.cu). p is fp32,
//     so p v takes three passes for fp32 inputs and two (p_lo v, p_hi v)
//     for 16-bit ones.
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
//   - Offsets are 64-bit: q, k, v and out are addressed through their own
//     (batch, seq, head) strides in elements with a contiguous D, so
//     strided views of a fused QKV projection are read in place.
//   - When a gradient is wanted the wrapper passes an fp32 (B * H, S_q)
//     buffer for lse, which the backward kernels (flash_attention_bwd.cu)
//     recompute the probabilities from as exp(s * scale - lse). Serving
//     passes no buffer and writes nothing more.
//
// Tolerance: within 1e-5 of max |out| of the plain version in fp32 (3xTF32
// drops only lo * lo, below 2^-22 of each product; the sums run in another
// order) and 1e-2 in bf16.
//
// C interface for ctypes: flash_attention_launch returns the cudaError_t of
// the launch (0 on success); flash_attention_error_string names it;
// flash_attention_smem_bytes gives the kernel's shared memory per CTA. lse
// may be null.

#include <math.h>

#include "flash_tiles.cuh"

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

// the ring of K and V, q's hi (and lo), p where it leaves the registers,
// and one row statistic per warp where a row's keys are split across warps
template <typename T, int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  using C = Tiles<DP>;
  return 2 * 2 * C::kStream * stream_stride<T, DP>() * sizeof(T)  // ring
         + (sizeof(T) < 4 ? 1 : 2) * C::kRes * C::kRS * 4       // hi (, lo)
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
  constexpr bool EXACT = sizeof(T) < 4;
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
  uint32_t* Ql = Qh + BQ * RS;                              // fp32 only
  float* Ps = reinterpret_cast<float*>(Ql + (EXACT ? 0 : BQ * RS));
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

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_kernel(const Params& p, cudaStream_t stream) {
  using C = Tiles<DP>;
  constexpr size_t smem = smem_bytes<T, DP>();
  static_assert(smem <= kMaxSmem, "tiles exceed the shared memory of a CTA");
  auto kernel = flash_attention_kernel<T, DP, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t q_tiles = (p.s_q + C::kRes - 1) / C::kRes;
  const int64_t max_y = 65535;
  const int64_t grid_y = p.bh < max_y ? p.bh : max_y;
  const int64_t grid_z = (p.bh + grid_y - 1) / grid_y;
  if (q_tiles > 0x7fffffffLL || grid_z > max_y) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(q_tiles),
                  static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(grid_z));
  kernel<<<grid, C::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_causal(const Params& p, bool causal, cudaStream_t s) {
  return causal ? launch_kernel<T, DP, true>(p, s)
                : launch_kernel<T, DP, false>(p, s);
}

template <typename T>
cudaError_t launch_dim(const Params& p, bool causal, cudaStream_t s) {
  Params pw = p;
  const int64_t st[6] = {p.k_sb, p.k_ss, p.k_sh, p.v_sb, p.v_ss, p.v_sh};
  pw.width = copy_width(p.k, p.v, sizeof(T), st);
  if (p.d <= 64) return launch_causal<T, 64>(pw, causal, s);
  if (p.d <= 128) return launch_causal<T, 128>(pw, causal, s);
  return launch_causal<T, 256>(pw, causal, s);
}

template <typename T>
long long smem_for(int d) {
  if (d <= 64) return static_cast<long long>(smem_bytes<T, 64>());
  if (d <= 128) return static_cast<long long>(smem_bytes<T, 128>());
  return static_cast<long long>(smem_bytes<T, 256>());
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
      return launch_dim<float>(p, causal != 0, s);
    case DT_BF16:
      return launch_dim<__nv_bfloat16>(p, causal != 0, s);
    case DT_F16:
      return launch_dim<__half>(p, causal != 0, s);
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
      return smem_for<float>(d);
    case DT_BF16:
      return smem_for<__nv_bfloat16>(d);
    case DT_F16:
      return smem_for<__half>(d);
    default:
      return -1;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
