// K3's backward, flash attention: dq, dk and dv of out = softmax(scale *
// q k^T, masked) v, given dout, the forward's row log-sum-exp lse and the
// row sums delta = sum_d dout * out; dq, dk and dv are stored in q's dtype
// (f32, bf16 or f16). One design per input width:
//   - fp32 inputs: fp32-accurate, products in 3xTF32 on the tensor cores
//     (mma.sync m16n8k8), fp32 accumulation, exact expf.
//   - bf16 and f16 inputs: the function the JAX library's kernels compute
//     on 16-bit inputs. s and dp are 16-bit x 16-bit products summed in
//     fp32; p = exp(scale s - lse) and ds = p (dp - delta) are fp32, then p
//     and scale * ds are rounded to the input dtype before dv += p^T dout,
//     dk += (scale ds)^T q and dq += (scale ds) k, which sum in fp32 (the
//     library's p.T.astype(do.dtype), ds.T.astype(do.dtype) after the scale
//     and ds.astype(k.dtype): flash_attention.py:900, :918, :1258). No tf32
//     split. wgmma for D <= 128, mma.sync m16n8k16 for D <= 256.
//
// Replaces the two Pallas TPU kernels that the JAX library's flash
// attention runs under jax.grad, reached from mxnet_tpu/ops/contrib.py
// _flash_attention (K3):
//   - _flash_attention_bwd_dkv (jax/experimental/pallas/ops/tpu/
//     flash_attention.py, pallas_call at :1121): dk and dv;
//   - _flash_attention_bwd_dq (pallas_call at :1456): dq.
// and the autodiff of _blockwise_impl's lax.scan under jax.checkpoint
// (mxnet_tpu/parallel/ring_attention.py, K3'), which computes the same
// gradients. Both recompute the probabilities from the saved softmax
// statistics; so do these kernels: p = exp(scale * q.k - lse). Like the
// library, delta is computed outside the kernels (one PyTorch reduction in
// the wrapper; plain JAX between the two pallas_calls in the library).
// Causal masking is bottom-right aligned as in the forward (query i attends
// keys j <= i + S_kv - S_q); a masked pair and a query row with no allowed
// key contribute nothing, whatever its lse.
//
// Per query row i and key j, with ds = p * (dp - delta_i):
//   dv_j += p_ij dout_i      dp_ij = dout_i . v_j
//   dq_i += scale ds_ij k_j  dk_j += scale ds_ij q_i
//
// Bound on an H100: operations. The two kernels do 7 products of
// 2 * B * H * S_q * S_kv * D flops (s and dp in both, dv, dk, dq; half
// under causal) against about 8 * B * H * S * D * 4 bytes of q, k, v, dout
// and the three gradients. The 5 products the gradients need take at least
// 10 * B * H * S_q * S_kv * D / 67 TFLOP/s on fp32 CUDA cores; in 3xTF32
// (three tf32 passes per product) 3 * 10 * B * H * S_q * S_kv * D / 495
// TFLOP/s on the tensor cores; in 16 bits 10 * B * H * S_q * S_kv * D / 989
// TFLOP/s.
//
// Design. Two kernels, as the TPU splits it, deterministic, no atomics:
// each gradient is written once.
//   - dkv: a CTA owns R keys of one (batch, head): K and V stay in shared
//     memory; it streams tiles of C query rows (q, dout, lse, delta), from
//     the first query that may attend the keys under causal. dk and dv
//     accumulate in registers.
//   - dq: a CTA owns R queries (q and dout resident; lse and delta of its
//     rows in registers) and streams tiles of C keys (k, v) up to the
//     diagonal under causal. dq accumulates in registers.
//   - The copy width of the streamed tiles (16, 8 or 4 bytes) is the
//     widest every row's address allows, chosen per launch from the
//     pointers and strides, so a 16-bit head dim of 100 (200-byte rows)
//     copies 8 bytes at a time; a 16-bit row at an odd element offset is
//     loaded by plain loads. Rows past the sequence and columns past d are
//     zero-filled by the copy itself: the products contract over D padded
//     with zeros. Masks (ragged rows, bottom-right causal) are applied per
//     accumulator element in tile coordinates; a masked pair gives p = 0
//     whatever its row's lse.
//   - Offsets are 64-bit: q, k, v, dout, dq, dk and dv are addressed
//     through their own (batch, seq, head) strides with a contiguous D, so
//     the gradient of a fused QKV projection is written in place through
//     the same column-block strides its forward read.
//
// fp32:
//   - Every product is mma.sync m16n8k8 tf32 with fp32 accumulators in
//     3xTF32 (mma_tf32.cuh): lo*hi and hi*lo, then hi*hi. In s and dp
//     (contracted over D) the lo terms go to an accumulator of their own;
//     the gradient products sum each tile into a zeroed accumulator that
//     is then added to dk, dv or dq with fp32 adds: the tensor cores do not
//     round their accumulation to nearest, and over the 4096 rows of one
//     accumulator that bias reached 5e-5 of max |grad| on an H100 (D 64).
//     Resident tiles are split into hi and lo once at staging; streamed
//     elements are split in registers as fragments are built.
//   - The tilings, the staging, the ring and the products are the tile
//     helpers that the forward shares (flash_tiles.cuh). The k index of a
//     product contracted over the tile's rows is read permuted there, so
//     the accumulator of s or dp is the A fragment of p or ds as it stands.
//   - D <= 64: R x C = 128 x 64, 8 warps, a warp owns 16 rows and every
//     column, so p and ds never leave its registers and a tile step has
//     one barrier (the ring's). D <= 128: 64 x 32, a warp owns 32 rows and
//     a quarter of the columns; D <= 256: 32 x 16, 4 warps, 16 rows and
//     half the columns. There p and ds go through shared memory [R][C + 8]
//     (a second barrier) and are split as they are read. Streamed tiles go
//     through a two-stage cp.async ring.
//
// 16 bits, D <= 128 (wgmma.cuh): the hi/lo words are gone, so every
// operand stays in shared memory as 16-bit values, in 128-byte-swizzled
// 64-column tiles that serve as K-major and as MN-major wgmma operands.
//   - R = 128: two warpgroups of 64 resident rows. dkv computes in the
//     transposed form: s^T = K q^T and dp^T = V dout^T are wgmma m64nCk16
//     with A = the warpgroup's K or V and B = the streamed q or dout tile,
//     both from shared memory, K-major; dv += p^T dout and dk += (scale
//     ds)^T q are m64nDk16 with A from registers (the s^T, dp^T
//     accumulators as p, ds, packed into 16-bit pairs in place: the
//     accumulator layout is the A layout) and B = the same streamed tile,
//     MN-major. dq likewise: s = q K^T, dp = dout V^T from shared memory,
//     dq += (scale ds) K with ds in registers. At D 64 a thread holds 32
//     fp32 registers per 64 x 64 accumulator.
//   - C = 128 at D 64 (at D 128: 32 in dkv, 64 in dq, where the gradient
//     accumulators take the registers). The streamed tiles go through a
//     three-stage cp.async ring, two tiles ahead, written into the
//     swizzled layout; each tile step waits for its tile, makes the copies
//     visible to wgmma (fence.proxy.async) and passes one barrier of the
//     CTA, then runs the s and dp products as one wgmma group, the exp and
//     masking in registers, and the gradient products as a second group.
//
// 16 bits, D <= 256 (mma_16bit.cuh): mma.sync m16n8k16, whose accumulator
// layout is the A fragment of the next product with no permutation. R x C
// = 64 x 32, 8 warps: a warp owns 16 rows and half the columns (the dk and
// dv accumulators of 16 rows x 256 columns would not fit a warp's
// registers), so p and ds, rounded to 16 bits, go through shared memory
// [R][C + 8]. K and V (or q and dout) stay in shared memory as 16-bit rows
// of D + 8 elements, read with ldmatrix (transposed for the operands
// contracted over the tile's rows); the streamed tiles go through a
// three-stage cp.async ring.
//
// C interface for ctypes: flash_attention_bwd_dkv_launch and
// flash_attention_bwd_dq_launch return the cudaError_t of the launch (0 on
// success); flash_attention_bwd_error_string names it;
// flash_attention_bwd_smem_bytes gives a kernel's shared memory per CTA.

#include <math.h>

#include <type_traits>

#include "flash_tiles.cuh"
#include "flash_wg.cuh"
#include "mma_16bit.cuh"

using namespace mxtt;

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;      // (bh, s_q)
  const float* delta;    // (bh, s_q)
  int64_t heads, bh, s_q, s_kv;
  int d;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  float scale;
  int width;             // cp.async bytes of the streamed rows, 0: plain
};

// p and ds arrays of a CTA in shared memory: 2 in dkv (p, ds), 1 in dq
// (ds), none where they stay in registers
template <int DP>
__host__ __device__ constexpr int p_arrays(int which) {
  return Tiles<DP>::kRegP ? 0 : (which == DKV ? 2 : 1);
}

template <typename T, int DP, int WHICH>
__host__ __device__ constexpr size_t smem_bytes() {
  using C = Tiles<DP>;
  return 2 * 2 * C::kStream * stream_stride<T, DP>() * sizeof(T)  // ring
         + (WHICH == DKV ? 2 * 2 * C::kStream * 4 : 0)          // lse, delta
         + 4 * C::kRes * C::kRS * 4                             // hi, lo
         + p_arrays<DP>(WHICH) * C::kRes * C::kSS * 4;          // p, ds
}

// start copying lse and delta of rows [r0, r0 + ROWS) (zeros past n)
template <int ROWS>
__device__ __forceinline__ void issue_stats(float* lse_d, float* delta_d,
                                            const float* lse,
                                            const float* delta, int64_t r0,
                                            int64_t n) {
  const int i = threadIdx.x;
  if (i >= 2 * ROWS) return;
  const bool second = i >= ROWS;
  const int r = second ? i - ROWS : i;
  const int64_t row = r0 + r;
  const float* base = second ? delta : lse;
  cp_async<4>((second ? delta_d : lse_d) + r, row < n ? base + row : base,
              row < n ? 4 : 0);
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(Tiles<DP>::kThreads, 1)
flash_attention_bwd_dkv_kernel(BwdParams p) {
  using C = Tiles<DP>;
  constexpr int BK = C::kRes;        // keys of the CTA
  constexpr int BQ = C::kStream;     // query rows per tile
  constexpr int MT = C::kMT;
  constexpr int N1 = C::kN1;
  constexpr int N2 = C::kN2;
  constexpr int NT = C::kThreads;
  constexpr int RS = C::kRS;
  constexpr int SS = C::kSS;
  constexpr int RT = stream_stride<T, DP>();
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);                      // [2][BQ][RT]
  T* dOs = Qs + 2 * BQ * RT;                                // [2][BQ][RT]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * RT);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                          // [2][BQ]
  uint32_t* Kh = reinterpret_cast<uint32_t*>(delta_s + 2 * BQ);  // [BK][RS]
  uint32_t* Vh = Kh + BK * RS;
  uint32_t* Kl = Vh + BK * RS;
  uint32_t* Vl = Kl + BK * RS;
  float* Ps = reinterpret_cast<float*>(Vl + BK * RS);
  float* dSs = Ps + BK * SS;              // [BK][SS] each, unless kRegP

  const int tid = threadIdx.x;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int warp = tid >> 5;
  const int r0 = 16 * MT * (warp / C::kWN);          // the warp's key rows
  const int qofs = (warp % C::kWN) * (BQ / C::kWN);  // its s, dp columns
  const int dofs = (warp % C::kWN) * (DP / C::kWN);  // its dk, dv columns
  const int64_t bh = bh_index();
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BK;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + bh * p.s_q;
  const float* delta = p.delta + bh * p.s_q;

  // query i may attend key j when j <= i + offset (bottom-right causal):
  // the first query tile that can reach this key tile
  const int64_t offset = p.s_kv - p.s_q;
  int64_t q_begin = 0;
  if (CAUSAL) {
    q_begin = n0 - offset;
    if (q_begin < 0) q_begin = 0;
  }
  const int64_t t_begin = q_begin / BQ;
  const int64_t t_end = (p.s_q + BQ - 1) / BQ;
  const int64_t nt = t_end > t_begin ? t_end - t_begin : 0;

  auto issue = [&](int64_t tile, int st) {
    const int64_t m0 = tile * BQ;
    issue_rows<T, DP, BQ, NT>(Qs + st * BQ * RT, q, p.q_ss, m0, p.s_q, p.d,
                              p.width);
    issue_rows<T, DP, BQ, NT>(dOs + st * BQ * RT, dout, p.do_ss, m0, p.s_q,
                              p.d, p.width);
    issue_stats<BQ>(lse_s + st * BQ, delta_s + st * BQ, lse, delta, m0,
                    p.s_q);
  };
  if (nt > 0) issue(t_begin, 0);
  cp_async_commit();
  stage_split<T, DP, BK, NT>(Kh, Kl, k, p.k_ss, n0, p.s_kv, p.d);
  stage_split<T, DP, BK, NT>(Vh, Vl, v, p.v_ss, n0, p.s_kv, p.d);

  float dk[MT * N2][4], dv[MT * N2][4], part[MT * N2][4];
  zero(dk);
  zero(dv);
  zero(part);

  for (int64_t it = 0; it < nt; ++it) {
    const int st = static_cast<int>(it & 1);
    cp_async_wait<0>();               // tile `it` has landed
    __syncthreads();                  // ... for every thread; tile it - 1,
                                      // its stage and p, ds are free
    if (it + 1 < nt) issue(t_begin + it + 1, st ^ 1);
    cp_async_commit();
    const T* Qt = Qs + st * BQ * RT;
    const T* dOt = dOs + st * BQ * RT;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;
    const int64_t m0 = (t_begin + it) * BQ;
    // masks in tile coordinates: key r, query c of the tile
    const int lim_k = static_cast<int>(p.s_kv - n0 < BK ? p.s_kv - n0 : BK);
    const int lim_q = static_cast<int>(p.s_q - m0 < BQ ? p.s_q - m0 : BQ);
    const int64_t dg = m0 + offset - n0;      // allowed when r - c <= dg
    const int diag = static_cast<int>(dg > BK ? BK : (dg < -BQ ? -BQ : dg));

    // (1) s^T = K q^T and dp^T = V dout^T: keys r0.., queries qofs..
    float s[MT * N1][4], dp[MT * N1][4];
    zero(s);
    zero(dp);
    product_over_d<T, DP, MT, N1, RS, RT>(s, Kh, Kl, Qt, r0, qofs, g, t);
    product_over_d<T, DP, MT, N1, RS, RT>(dp, Vh, Vl, dOt, r0, qofs, g, t);
    // p and ds in place of s and dp
#pragma unroll
    for (int i = 0; i < MT * N1; ++i) {
      const int c = qofs + 8 * (i % N1) + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 16 * (i / N1) + g + 8 * hh;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool ok = r < lim_k && c + e < lim_q;
          if (CAUSAL) ok = ok && r - (c + e) <= diag;
          const float pr =
              ok ? expf(s[i][2 * hh + e] * p.scale - lse_t[c + e]) : 0.0f;
          s[i][2 * hh + e] = pr;
          dp[i][2 * hh + e] = pr * (dp[i][2 * hh + e] - delta_t[c + e]);
        }
        if constexpr (!C::kRegP) {
          *reinterpret_cast<float2*>(Ps + r * SS + c) =
              make_float2(s[i][2 * hh], s[i][2 * hh + 1]);
          *reinterpret_cast<float2*>(dSs + r * SS + c) =
              make_float2(dp[i][2 * hh], dp[i][2 * hh + 1]);
        }
      }
    }

    // (2) dv += p^T dout and dk += ds^T q over the tile's query rows
    if constexpr (C::kRegP) {
      product_over_regs<T, N2, BQ, RT>(dv, part, s, dOt, dofs, g, t);
      product_over_regs<T, N2, BQ, RT>(dk, part, dp, Qt, dofs, g, t);
    } else {
      __syncthreads();                // p and ds of every warp are stored
      product_over_rows<T, MT, N2, BQ, SS, RT>(dv, part, Ps, dOt, r0, dofs,
                                               g, t);
      product_over_rows<T, MT, N2, BQ, SS, RT>(dk, part, dSs, Qt, r0, dofs,
                                               g, t);
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_acc<T, N2>(dkp, p.dk_ss, n0 + r0, p.s_kv, p.d, dofs, dk, p.scale, g,
                   t);
  store_acc<T, N2>(dvp, p.dv_ss, n0 + r0, p.s_kv, p.d, dofs, dv, 1.0f, g, t);
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(Tiles<DP>::kThreads, 1)
flash_attention_bwd_dq_kernel(BwdParams p) {
  using C = Tiles<DP>;
  constexpr int BQ = C::kRes;        // query rows of the CTA
  constexpr int BK = C::kStream;     // keys per tile
  constexpr int MT = C::kMT;
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
  uint32_t* dOh = Qh + BQ * RS;
  uint32_t* Ql = dOh + BQ * RS;
  uint32_t* dOl = Ql + BQ * RS;
  float* dSs = reinterpret_cast<float*>(dOl + BQ * RS);

  const int tid = threadIdx.x;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int warp = tid >> 5;
  const int r0 = 16 * MT * (warp / C::kWN);          // the warp's query rows
  const int kofs = (warp % C::kWN) * (BK / C::kWN);  // its s, dp columns
  const int dofs = (warp % C::kWN) * (DP / C::kWN);  // its dq columns
  const int64_t bh = bh_index();
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

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
  stage_split<T, DP, BQ, NT>(dOh, dOl, dout, p.do_ss, m0, p.s_q, p.d);
  float lse_r[MT][2], delta_r[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t row = m0 + r0 + 16 * m + g + 8 * hh;
      lse_r[m][hh] = row < p.s_q ? p.lse[bh * p.s_q + row] : 0.0f;
      delta_r[m][hh] = row < p.s_q ? p.delta[bh * p.s_q + row] : 0.0f;
    }
  }

  float acc[MT * N2][4], part[MT * N2][4];
  zero(acc);
  zero(part);

  for (int64_t it = 0; it < nt; ++it) {
    const int st = static_cast<int>(it & 1);
    cp_async_wait<0>();               // tile `it` has landed
    __syncthreads();                  // ... for every thread; tile it - 1,
                                      // its stage and ds are free
    if (it + 1 < nt) issue(it + 1, st ^ 1);
    cp_async_commit();
    const T* Kt = Ks + st * BK * RT;
    const T* Vt = Vs + st * BK * RT;
    const int64_t n0 = it * BK;
    // masks in tile coordinates: query r, key c of the tile
    const int lim_k = static_cast<int>(p.s_kv - n0 < BK ? p.s_kv - n0 : BK);
    const int lim_q = static_cast<int>(p.s_q - m0 < BQ ? p.s_q - m0 : BQ);
    const int64_t dg = m0 + offset - n0;      // allowed when c - r <= dg
    const int diag = static_cast<int>(dg > BK ? BK : (dg < -BQ ? -BQ : dg));

    // (1) s = q K^T and dp = dout V^T: queries r0.., keys kofs..
    float s[MT * N1][4], dp[MT * N1][4];
    zero(s);
    zero(dp);
    product_over_d<T, DP, MT, N1, RS, RT>(s, Qh, Ql, Kt, r0, kofs, g, t);
    product_over_d<T, DP, MT, N1, RS, RT>(dp, dOh, dOl, Vt, r0, kofs, g, t);
#pragma unroll
    for (int i = 0; i < MT * N1; ++i) {
      const int c = kofs + 8 * (i % N1) + 2 * t;
      const int m = i / N1;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 16 * m + g + 8 * hh;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool ok = c + e < lim_k && r < lim_q;
          if (CAUSAL) ok = ok && (c + e) - r <= diag;
          const float pr =
              ok ? expf(s[i][2 * hh + e] * p.scale - lse_r[m][hh]) : 0.0f;
          dp[i][2 * hh + e] = pr * (dp[i][2 * hh + e] - delta_r[m][hh]);
        }
        if constexpr (!C::kRegP) {
          *reinterpret_cast<float2*>(dSs + r * SS + c) =
              make_float2(dp[i][2 * hh], dp[i][2 * hh + 1]);
        }
      }
    }

    // (2) dq += ds K over the tile's keys
    if constexpr (C::kRegP) {
      product_over_regs<T, N2, BK, RT>(acc, part, dp, Kt, dofs, g, t);
    } else {
      __syncthreads();                // ds of every warp is stored
      product_over_rows<T, MT, N2, BK, SS, RT>(acc, part, dSs, Kt, r0, dofs,
                                               g, t);
    }
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_acc<T, N2>(dqp, p.dq_ss, m0 + r0, p.s_q, p.d, dofs, acc, p.scale, g,
                   t);
}

// ---------------------------------------------------------------------------
// The 16-bit design for D <= 256: mma.sync m16n8k16, fp32 accumulation.

// tiles of head dim 256 for 16-bit inputs: R = 64 resident rows kept as
// 16-bit values, C = 32 rows per streamed tile in a three-stage ring; a
// warp owns 16 resident rows and half the columns of each product
template <int DP>
struct Tiles16 {
  static_assert(DP == 256, "wgmma takes D <= 128");
  static constexpr int kWN = 2;
  static constexpr int kRes = 64;
  static constexpr int kStream = 32;
  static constexpr int kStages = 3;
  static constexpr int kThreads = 32 * kWN * kRes / 16;
  static constexpr int kN1 = kStream / (8 * kWN);   // n-tiles of s, dp
  static constexpr int kN2 = DP / (8 * kWN);        // n-tiles of a gradient
  static constexpr int kRS = DP + 8;                // row stride, elements
  static constexpr int kPS = kStream + 8;           // p, ds row stride
  static_assert(kN1 % 2 == 0 && kN2 % 2 == 0, "n-tiles go in pairs");
};

template <int DP, int WHICH>
__host__ __device__ constexpr size_t smem_bytes16() {
  using C = Tiles16<DP>;
  return C::kStages * 2 * C::kStream * C::kRS * 2           // ring
         + 2 * C::kRes * C::kRS * 2                         // resident
         + (WHICH == DKV ? 2 : 1) * C::kRes * C::kPS * 2    // p, ds
         + (WHICH == DKV ? C::kStages * 2 * C::kStream * 4 : 0);  // stats
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(Tiles16<DP>::kThreads, 1)
flash_attention_bwd_dkv_mma16_kernel(BwdParams p) {
  using C = Tiles16<DP>;
  constexpr int BK = C::kRes;        // keys of the CTA
  constexpr int BQ = C::kStream;     // query rows per tile
  constexpr int NS = C::kStages;
  constexpr int N1 = C::kN1;
  constexpr int N2 = C::kN2;
  constexpr int NT = C::kThreads;
  constexpr int RS = C::kRS;
  constexpr int PS = C::kPS;
  static_assert(RS == stream_stride<T, DP>(), "one row stride");
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);                     // [NS][BQ][RS]
  T* dOs = Qs + NS * BQ * RS;                              // [NS][BQ][RS]
  T* Ks = dOs + NS * BQ * RS;                              // [BK][RS]
  T* Vs = Ks + BK * RS;                                    // [BK][RS]
  T* Ps = Vs + BK * RS;                              // [BK][PS] each
  T* dSs = Ps + BK * PS;
  float* lse_s = reinterpret_cast<float*>(dSs + BK * PS);
  float* delta_s = lse_s + NS * BQ;                        // [NS][BQ] each

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = tid >> 5;
  const int r0 = 16 * (warp / C::kWN);               // the warp's key rows
  const int qofs = (warp % C::kWN) * (BQ / C::kWN);  // its s, dp columns
  const int dofs = (warp % C::kWN) * (DP / C::kWN);  // its dk, dv columns
  const int64_t bh = bh_index();
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BK;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + bh * p.s_q;
  const float* delta = p.delta + bh * p.s_q;
  const float sl2 = p.scale * kLog2e;

  const int64_t offset = p.s_kv - p.s_q;
  int64_t q_begin = 0;
  if (CAUSAL) {
    q_begin = n0 - offset;
    if (q_begin < 0) q_begin = 0;
  }
  const int64_t t_begin = q_begin / BQ;
  const int64_t t_end = (p.s_q + BQ - 1) / BQ;
  const int64_t nt = t_end > t_begin ? t_end - t_begin : 0;

  auto issue = [&](int64_t tile, int st) {
    const int64_t m0 = tile * BQ;
    issue_rows<T, DP, BQ, NT>(Qs + st * BQ * RS, q, p.q_ss, m0, p.s_q, p.d,
                              p.width);
    issue_rows<T, DP, BQ, NT>(dOs + st * BQ * RS, dout, p.do_ss, m0, p.s_q,
                              p.d, p.width);
    issue_stats<BQ>(lse_s + st * BQ, delta_s + st * BQ, lse, delta, m0,
                    p.s_q);
  };
  // group 0: K, V and the first tile; then one group per tile
  issue_rows<T, DP, BK, NT>(Ks, k, p.k_ss, n0, p.s_kv, p.d, p.width);
  issue_rows<T, DP, BK, NT>(Vs, v, p.v_ss, n0, p.s_kv, p.d, p.width);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nt) issue(t_begin + i, i);
    cp_async_commit();
  }

  float dk[N2][4], dv[N2][4];
  zero(dk);
  zero(dv);

  for (int64_t it = 0; it < nt; ++it) {
    const int st = static_cast<int>(it % NS);
    cp_async_wait<NS - 2>();          // tile `it` (and K, V) has landed
    __syncthreads();                  // ... for every thread; the stage of
                                      // tile it - 1 and p, ds are free
    if (it + NS - 1 < nt) {
      issue(t_begin + it + NS - 1, static_cast<int>((it + NS - 1) % NS));
    }
    cp_async_commit();
    const T* Qt = Qs + st * BQ * RS;
    const T* dOt = dOs + st * BQ * RS;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;
    const int64_t m0 = (t_begin + it) * BQ;
    // masks in tile coordinates: key r, query c of the tile
    const int lim_k = static_cast<int>(p.s_kv - n0 < BK ? p.s_kv - n0 : BK);
    const int lim_q = static_cast<int>(p.s_q - m0 < BQ ? p.s_q - m0 : BQ);
    const int64_t dg = m0 + offset - n0;      // allowed when r - c <= dg
    const int diag = static_cast<int>(dg > BK ? BK : (dg < -BQ ? -BQ : dg));
    const bool full = lim_k == BK && lim_q == BQ && (!CAUSAL || diag >= BK - 1);

    // (1) s^T = K q^T and dp^T = V dout^T: keys r0.., queries qofs..
    float s[N1][4], dp[N1][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_block<false, true>(ak, Ks, RS, r0, 16 * kk, lane);
      ldsm_block<false, true>(av, Vs, RS, r0, 16 * kk, lane);
#pragma unroll
      for (int j = 0; j < N1; j += 2) {
        uint32_t bq[4], bo[4];
        ldsm_block<false, false>(bq, Qt, RS, qofs + 8 * j, 16 * kk, lane);
        ldsm_block<false, false>(bo, dOt, RS, qofs + 8 * j, 16 * kk, lane);
        mma16<T>(s[j], ak, bq[0], bq[1]);
        mma16<T>(s[j + 1], ak, bq[2], bq[3]);
        mma16<T>(dp[j], av, bo[0], bo[1]);
        mma16<T>(dp[j + 1], av, bo[2], bo[3]);
      }
    }
    // p and scale * ds, in fp32, rounded to T in pairs into shared memory
#pragma unroll
    for (int i = 0; i < N1; ++i) {
      const int c = qofs + 8 * i + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh;
        float pr[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool ok = full || (r < lim_k && c + e < lim_q);
          if (CAUSAL) ok = ok && (full || r - (c + e) <= diag);
          pr[e] = ok ? exp2_fast(s[i][2 * hh + e] * sl2 -
                                 lse_t[c + e] * kLog2e)
                     : 0.0f;
          ds[e] = pr[e] * (dp[i][2 * hh + e] - delta_t[c + e]) * p.scale;
        }
        *reinterpret_cast<uint32_t*>(Ps + r * PS + c) =
            pack16<T>(pr[0], pr[1]);
        *reinterpret_cast<uint32_t*>(dSs + r * PS + c) =
            pack16<T>(ds[0], ds[1]);
      }
    }
    __syncthreads();                  // p, ds of every warp

    // (2) dv += p^T dout and dk += (scale ds)^T q over the tile's queries
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t ap[4], ad[4];
      ldsm_block<false, true>(ap, Ps, PS, r0, 16 * kq, lane);
      ldsm_block<false, true>(ad, dSs, PS, r0, 16 * kq, lane);
#pragma unroll
      for (int j = 0; j < N2; j += 2) {
        uint32_t bo[4], bq[4];
        ldsm_block<true, true>(bo, dOt, RS, 16 * kq, dofs + 8 * j, lane);
        ldsm_block<true, true>(bq, Qt, RS, 16 * kq, dofs + 8 * j, lane);
        mma16<T>(dv[j], ap, bo[0], bo[1]);
        mma16<T>(dv[j + 1], ap, bo[2], bo[3]);
        mma16<T>(dk[j], ad, bq[0], bq[1]);
        mma16<T>(dk[j + 1], ad, bq[2], bq[3]);
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_acc<T, N2>(dkp, p.dk_ss, n0 + r0, p.s_kv, p.d, dofs, dk, 1.0f, g, t);
  store_acc<T, N2>(dvp, p.dv_ss, n0 + r0, p.s_kv, p.d, dofs, dv, 1.0f, g, t);
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(Tiles16<DP>::kThreads, 1)
flash_attention_bwd_dq_mma16_kernel(BwdParams p) {
  using C = Tiles16<DP>;
  constexpr int BQ = C::kRes;        // query rows of the CTA
  constexpr int BK = C::kStream;     // keys per tile
  constexpr int NS = C::kStages;
  constexpr int N1 = C::kN1;
  constexpr int N2 = C::kN2;
  constexpr int NT = C::kThreads;
  constexpr int RS = C::kRS;
  constexpr int PS = C::kPS;
  static_assert(RS == stream_stride<T, DP>(), "one row stride");
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);                     // [NS][BK][RS]
  T* Vs = Ks + NS * BK * RS;                               // [NS][BK][RS]
  T* Qs = Vs + NS * BK * RS;                               // [BQ][RS]
  T* dOs = Qs + BQ * RS;                                   // [BQ][RS]
  T* dSs = dOs + BQ * RS;                                  // [BQ][PS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = tid >> 5;
  const int r0 = 16 * (warp / C::kWN);               // the warp's query rows
  const int kofs = (warp % C::kWN) * (BK / C::kWN);  // its s, dp columns
  const int dofs = (warp % C::kWN) * (DP / C::kWN);  // its dq columns
  const int64_t bh = bh_index();
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float sl2 = p.scale * kLog2e;

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
    issue_rows<T, DP, BK, NT>(Ks + st * BK * RS, k, p.k_ss, n0, p.s_kv, p.d,
                              p.width);
    issue_rows<T, DP, BK, NT>(Vs + st * BK * RS, v, p.v_ss, n0, p.s_kv, p.d,
                              p.width);
  };
  // group 0: q, dout and the first tile; then one group per tile
  issue_rows<T, DP, BQ, NT>(Qs, q, p.q_ss, m0, p.s_q, p.d, p.width);
  issue_rows<T, DP, BQ, NT>(dOs, dout, p.do_ss, m0, p.s_q, p.d, p.width);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nt) issue(i, i);
    cp_async_commit();
  }
  float lse2_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t row = m0 + r0 + g + 8 * hh;
    lse2_r[hh] = row < p.s_q ? p.lse[bh * p.s_q + row] * kLog2e : 0.0f;
    delta_r[hh] = row < p.s_q ? p.delta[bh * p.s_q + row] : 0.0f;
  }

  float acc[N2][4];
  zero(acc);

  for (int64_t it = 0; it < nt; ++it) {
    const int st = static_cast<int>(it % NS);
    cp_async_wait<NS - 2>();          // tile `it` (and q, dout) has landed
    __syncthreads();                  // ... for every thread; the stage of
                                      // tile it - 1 and ds are free
    if (it + NS - 1 < nt) {
      issue(it + NS - 1, static_cast<int>((it + NS - 1) % NS));
    }
    cp_async_commit();
    const T* Kt = Ks + st * BK * RS;
    const T* Vt = Vs + st * BK * RS;
    const int64_t n0 = it * BK;
    // masks in tile coordinates: query r, key c of the tile
    const int lim_k = static_cast<int>(p.s_kv - n0 < BK ? p.s_kv - n0 : BK);
    const int lim_q = static_cast<int>(p.s_q - m0 < BQ ? p.s_q - m0 : BQ);
    const int64_t dg = m0 + offset - n0;      // allowed when c - r <= dg
    const int diag = static_cast<int>(dg > BK ? BK : (dg < -BQ ? -BQ : dg));
    const bool full = lim_k == BK && lim_q == BQ && (!CAUSAL || diag >= BK - 1);

    // (1) s = q K^T and dp = dout V^T: queries r0.., keys kofs..
    float s[N1][4], dp[N1][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_block<false, true>(aq, Qs, RS, r0, 16 * kk, lane);
      ldsm_block<false, true>(ao, dOs, RS, r0, 16 * kk, lane);
#pragma unroll
      for (int j = 0; j < N1; j += 2) {
        uint32_t bk[4], bv[4];
        ldsm_block<false, false>(bk, Kt, RS, kofs + 8 * j, 16 * kk, lane);
        ldsm_block<false, false>(bv, Vt, RS, kofs + 8 * j, 16 * kk, lane);
        mma16<T>(s[j], aq, bk[0], bk[1]);
        mma16<T>(s[j + 1], aq, bk[2], bk[3]);
        mma16<T>(dp[j], ao, bv[0], bv[1]);
        mma16<T>(dp[j + 1], ao, bv[2], bv[3]);
      }
    }
    // scale * ds in fp32, rounded to T in pairs into shared memory
#pragma unroll
    for (int i = 0; i < N1; ++i) {
      const int c = kofs + 8 * i + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool ok = full || (c + e < lim_k && r < lim_q);
          if (CAUSAL) ok = ok && (full || (c + e) - r <= diag);
          const float pr =
              ok ? exp2_fast(s[i][2 * hh + e] * sl2 - lse2_r[hh]) : 0.0f;
          ds[e] = pr * (dp[i][2 * hh + e] - delta_r[hh]) * p.scale;
        }
        *reinterpret_cast<uint32_t*>(dSs + r * PS + c) =
            pack16<T>(ds[0], ds[1]);
      }
    }
    __syncthreads();                  // ds of every warp

    // (2) dq += (scale ds) K over the tile's keys
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      uint32_t ad[4];
      ldsm_block<false, true>(ad, dSs, PS, r0, 16 * kq, lane);
#pragma unroll
      for (int j = 0; j < N2; j += 2) {
        uint32_t bk[4];
        ldsm_block<true, true>(bk, Kt, RS, 16 * kq, dofs + 8 * j, lane);
        mma16<T>(acc[j], ad, bk[0], bk[1]);
        mma16<T>(acc[j + 1], ad, bk[2], bk[3]);
      }
    }
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_acc<T, N2>(dqp, p.dq_ss, m0 + r0, p.s_q, p.d, dofs, acc, 1.0f, g, t);
}

// ---------------------------------------------------------------------------
// The 16-bit design for D <= 128: wgmma, two warpgroups of 64 resident rows.

// start copying lse and delta of rows [r0, r0 + ROWS) (zeros past n) from
// thread tid of nthreads
template <int ROWS>
__device__ __forceinline__ void issue_stats_by(float* lse_d, float* delta_d,
                                               const float* lse,
                                               const float* delta,
                                               int64_t r0, int64_t n,
                                               int tid, int nthreads) {
  for (int i = tid; i < 2 * ROWS; i += nthreads) {
    const bool second = i >= ROWS;
    const int r = second ? i - ROWS : i;
    const int64_t row = r0 + r;
    const float* base = second ? delta : lse;
    cp_async<4>((second ? delta_d : lse_d) + r, row < n ? base + row : base,
                row < n ? 4 : 0);
  }
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(TilesWG<DP, DKV>::kThreads, 1)
flash_attention_bwd_dkv_wgmma_kernel(BwdParams p) {
  using C = TilesWG<DP, DKV>;
  constexpr int BK = C::kRes;        // keys of the CTA
  constexpr int BQ = C::kStream;     // query rows per tile
  constexpr int NS = C::kStages;
  constexpr int NT = C::kThreads;
  constexpr int J1 = BQ / 8;         // n-tiles of s^T, dp^T
  constexpr int J2 = DP / 8;         // n-tiles of dk, dv
  extern __shared__ float4 smem4[];
  char* sm = align1024(smem4);
  T* Ks = reinterpret_cast<T*>(sm);                 // [DP / 64][BK][64]
  T* Vs = Ks + BK * DP;
  T* Qs = Vs + BK * DP;                             // [NS][DP / 64][BQ][64]
  T* dOs = Qs + NS * BQ * DP;
  float* lse_s = reinterpret_cast<float*>(dOs + NS * BQ * DP);  // [NS][BQ]
  float* delta_s = lse_s + NS * BQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = tid >> 7;                          // warpgroup: 64 keys
  const int rw = 64 * wg + 16 * ((tid >> 5) & 3);   // the warp's first key
  const int64_t bh = bh_index();
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BK;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + bh * p.s_q;
  const float* delta = p.delta + bh * p.s_q;
  const float sl2 = p.scale * kLog2e;

  const int64_t offset = p.s_kv - p.s_q;
  int64_t q_begin = 0;
  if (CAUSAL) {
    q_begin = n0 - offset;
    if (q_begin < 0) q_begin = 0;
  }
  const int64_t t_begin = q_begin / BQ;
  const int64_t t_end = (p.s_q + BQ - 1) / BQ;
  const int64_t nt = t_end > t_begin ? t_end - t_begin : 0;

  auto issue = [&](int64_t tile, int st) {
    const int64_t m0 = tile * BQ;
    issue_rows_sw<T, DP, BQ>(Qs + st * BQ * DP, q, p.q_ss, m0, p.s_q, p.d,
                             p.width, tid, NT);
    issue_rows_sw<T, DP, BQ>(dOs + st * BQ * DP, dout, p.do_ss, m0, p.s_q,
                             p.d, p.width, tid, NT);
    issue_stats_by<BQ>(lse_s + st * BQ, delta_s + st * BQ, lse, delta, m0,
                       p.s_q, tid, NT);
  };
  // group 0: K, V and the first tile; then one group per tile
  issue_rows_sw<T, DP, BK>(Ks, k, p.k_ss, n0, p.s_kv, p.d, p.width, tid, NT);
  issue_rows_sw<T, DP, BK>(Vs, v, p.v_ss, n0, p.s_kv, p.d, p.width, tid, NT);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nt) issue(t_begin + i, i);
    cp_async_commit();
  }
  // this warpgroup's 64 keys of K and V: A of s^T and dp^T
  const uint32_t k_base = smem_u32(Ks) + wg * 64 * 128;
  const uint32_t v_base = smem_u32(Vs) + wg * 64 * 128;

  float dk[J2][4], dv[J2][4], s[J1][4], dp[J1][4];
  zero(dk);
  zero(dv);
  zero(s);
  zero(dp);
  uint32_t ap[BQ / 16][4], ad[BQ / 16][4];

  for (int64_t it = 0; it < nt; ++it) {
    const int st = static_cast<int>(it % NS);
    cp_async_wait<NS - 2>();          // tile `it` (and K, V) has landed
    fence_proxy_async();              // ... visible to wgmma's reads
    __syncthreads();                  // ... for every thread; the stage of
                                      // tile it - 1 is free
    if (it + NS - 1 < nt) {
      issue(t_begin + it + NS - 1, static_cast<int>((it + NS - 1) % NS));
    }
    cp_async_commit();
    const uint32_t q_base = smem_u32(Qs + st * BQ * DP);
    const uint32_t o_base = smem_u32(dOs + st * BQ * DP);
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;
    const int64_t m0 = (t_begin + it) * BQ;
    // masks in tile coordinates: key r, query c of the tile
    const int lim_k = static_cast<int>(p.s_kv - n0 < BK ? p.s_kv - n0 : BK);
    const int lim_q = static_cast<int>(p.s_q - m0 < BQ ? p.s_q - m0 : BQ);
    const int64_t dg = m0 + offset - n0;      // allowed when r - c <= dg
    const int diag = static_cast<int>(dg > BK ? BK : (dg < -BQ ? -BQ : dg));
    const bool full_tile =
        lim_k == BK && lim_q == BQ && (!CAUSAL || diag >= BK - 1);

    // (1) s^T = K q^T and dp^T = V dout^T: the warpgroup's 64 keys x BQ
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BQ, T>::template ss<0>(s, desc_k<BK>(k_base, kk),
                                   desc_k<BQ>(q_base, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BQ, T>::template ss<0>(dp, desc_k<BK>(v_base, kk),
                                   desc_k<BQ>(o_base, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dk);
    fence_regs(dv);
    // p and scale * ds in fp32, in place of s and dp: per query column c
    // lse * log2 e and delta * scale, then one FFMA, the exp2, one FFMA and
    // one FMUL per element
    auto scores = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < J1; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
        const float ls[2] = {l2.x * kLog2e, l2.y * kLog2e};
        const float dsc[2] = {d2.x * p.scale, d2.y * p.scale};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2_fast(fmaf(s[j][e], sl2, -ls[e & 1]));
          if (decltype(masked)::value) {
            const int r = rw + g + 8 * (e >> 1);
            const int cc = c + (e & 1);
            bool ok = r < lim_k && cc < lim_q;
            if (CAUSAL) ok = ok && r - cc <= diag;
            pr = ok ? pr : 0.0f;
          }
          s[j][e] = pr;
          dp[j][e] = pr * fmaf(dp[j][e], p.scale, -dsc[e & 1]);
        }
      }
    };
    if (full_tile) {
      scores(std::false_type());
    } else {
      scores(std::true_type());
    }

    // (2) dv += p^T dout and dk += (scale ds)^T q, p and ds rounded to T
    // as the A fragments, B the streamed tiles MN-major
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      pack_a<T>(ap[kq], s, kq);
      pack_a<T>(ad[kq], dp, kq);
    }
    fence_regs(ap);
    fence_regs(ad);
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      Wgmma<DP, T>::template rs<1>(dv, ap[kq], desc_mn<BQ>(o_base, kq), 1);
    }
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      Wgmma<DP, T>::template rs<1>(dk, ad[kq], desc_mn<BQ>(q_base, kq), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_acc<T, J2>(dkp, p.dk_ss, n0 + rw, p.s_kv, p.d, 0, dk, 1.0f, g, t);
  store_acc<T, J2>(dvp, p.dv_ss, n0 + rw, p.s_kv, p.d, 0, dv, 1.0f, g, t);
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(TilesWG<DP, DQ>::kThreads, 1)
flash_attention_bwd_dq_wgmma_kernel(BwdParams p) {
  using C = TilesWG<DP, DQ>;
  constexpr int BQ = C::kRes;        // query rows of the CTA
  constexpr int BK = C::kStream;     // keys per tile
  constexpr int NS = C::kStages;
  constexpr int NT = C::kThreads;
  constexpr int J1 = BK / 8;         // n-tiles of s, dp
  constexpr int J2 = DP / 8;         // n-tiles of dq
  extern __shared__ float4 smem4[];
  char* sm = align1024(smem4);
  T* Qs = reinterpret_cast<T*>(sm);                 // [DP / 64][BQ][64]
  T* dOs = Qs + BQ * DP;
  T* Ks = dOs + BQ * DP;                            // [NS][DP / 64][BK][64]
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
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float sl2 = p.scale * kLog2e;

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
    issue_rows_sw<T, DP, BK>(Ks + st * BK * DP, k, p.k_ss, n0, p.s_kv, p.d,
                             p.width, tid, NT);
    issue_rows_sw<T, DP, BK>(Vs + st * BK * DP, v, p.v_ss, n0, p.s_kv, p.d,
                             p.width, tid, NT);
  };
  // group 0: q, dout and the first tile; then one group per tile
  issue_rows_sw<T, DP, BQ>(Qs, q, p.q_ss, m0, p.s_q, p.d, p.width, tid, NT);
  issue_rows_sw<T, DP, BQ>(dOs, dout, p.do_ss, m0, p.s_q, p.d, p.width, tid,
                           NT);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nt) issue(i, i);
    cp_async_commit();
  }
  // the rows' lse * log2 e and delta * scale
  float ls_r[2], ds_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t row = m0 + rw + g + 8 * hh;
    ls_r[hh] = row < p.s_q ? p.lse[bh * p.s_q + row] * kLog2e : 0.0f;
    ds_r[hh] = row < p.s_q ? p.delta[bh * p.s_q + row] * p.scale : 0.0f;
  }
  // this warpgroup's 64 queries of q and dout: A of s and dp
  const uint32_t q_base = smem_u32(Qs) + wg * 64 * 128;
  const uint32_t o_base = smem_u32(dOs) + wg * 64 * 128;

  float acc[J2][4], s[J1][4], dp[J1][4];
  zero(acc);
  zero(s);
  zero(dp);
  uint32_t ad[BK / 16][4];

  for (int64_t it = 0; it < nt; ++it) {
    const int st = static_cast<int>(it % NS);
    cp_async_wait<NS - 2>();          // tile `it` (and q, dout) has landed
    fence_proxy_async();              // ... visible to wgmma's reads
    __syncthreads();                  // ... for every thread; the stage of
                                      // tile it - 1 is free
    if (it + NS - 1 < nt) {
      issue(it + NS - 1, static_cast<int>((it + NS - 1) % NS));
    }
    cp_async_commit();
    const uint32_t k_base = smem_u32(Ks + st * BK * DP);
    const uint32_t v_base = smem_u32(Vs + st * BK * DP);
    const int64_t n0 = it * BK;
    // masks in tile coordinates: query r, key c of the tile
    const int lim_k = static_cast<int>(p.s_kv - n0 < BK ? p.s_kv - n0 : BK);
    const int lim_q = static_cast<int>(p.s_q - m0 < BQ ? p.s_q - m0 : BQ);
    const int64_t dg = m0 + offset - n0;      // allowed when c - r <= dg
    const int diag = static_cast<int>(dg > BK ? BK : (dg < -BQ ? -BQ : dg));
    const bool full_tile =
        lim_k == BK && lim_q == BQ && (!CAUSAL || diag >= BK - 1);

    // (1) s = q K^T and dp = dout V^T: the warpgroup's 64 queries x BK
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BK, T>::template ss<0>(s, desc_k<BQ>(q_base, kk),
                                   desc_k<BK>(k_base, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BK, T>::template ss<0>(dp, desc_k<BQ>(o_base, kk),
                                   desc_k<BK>(v_base, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(acc);
    // scale * ds in fp32, in place of dp
    auto scores = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < J1; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          float pr = exp2_fast(fmaf(s[j][e], sl2, -ls_r[hh]));
          if (decltype(masked)::value) {
            const int r = rw + g + 8 * hh;
            const int cc = 8 * j + 2 * t + (e & 1);
            bool ok = cc < lim_k && r < lim_q;
            if (CAUSAL) ok = ok && cc - r <= diag;
            pr = ok ? pr : 0.0f;
          }
          dp[j][e] = pr * fmaf(dp[j][e], p.scale, -ds_r[hh]);
        }
      }
    };
    if (full_tile) {
      scores(std::false_type());
    } else {
      scores(std::true_type());
    }

    // (2) dq += (scale ds) K, ds rounded to T as the A fragments, B the
    // streamed K tile MN-major
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) pack_a<T>(ad[kq], dp, kq);
    fence_regs(ad);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      Wgmma<DP, T>::template rs<1>(acc, ad[kq], desc_mn<BK>(k_base, kq), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_acc<T, J2>(dqp, p.dq_ss, m0 + rw, p.s_q, p.d, 0, acc, 1.0f, g, t);
}

// one launch over (resident tiles of `rows`, batch * head)
cudaError_t launch_grid(void (*kernel)(BwdParams), size_t smem, int threads,
                        int rows, int64_t len, const BwdParams& p,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t tiles = (len + rows - 1) / rows;
  const int64_t max_y = 65535;
  const int64_t grid_y = p.bh < max_y ? p.bh : max_y;
  const int64_t grid_z = (p.bh + grid_y - 1) / grid_y;
  if (tiles > 0x7fffffffLL || grid_z > max_y) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(grid_z));
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP, bool CAUSAL, int WHICH>
cudaError_t launch_kernel(const BwdParams& p, cudaStream_t stream) {
  using C = Tiles<DP>;
  constexpr size_t smem = smem_bytes<T, DP, WHICH>();
  static_assert(smem <= kMaxSmem, "tiles exceed the shared memory of a CTA");
  auto kernel = WHICH == DKV ? flash_attention_bwd_dkv_kernel<T, DP, CAUSAL>
                             : flash_attention_bwd_dq_kernel<T, DP, CAUSAL>;
  return launch_grid(kernel, smem, C::kThreads, C::kRes,
                     WHICH == DKV ? p.s_kv : p.s_q, p, stream);
}

template <typename T, int DP, bool CAUSAL, int WHICH>
cudaError_t launch_kernel16(const BwdParams& p, cudaStream_t stream) {
  using C = Tiles16<DP>;
  constexpr size_t smem = smem_bytes16<DP, WHICH>();
  static_assert(smem <= kMaxSmem, "tiles exceed the shared memory of a CTA");
  auto kernel = WHICH == DKV
                    ? flash_attention_bwd_dkv_mma16_kernel<T, DP, CAUSAL>
                    : flash_attention_bwd_dq_mma16_kernel<T, DP, CAUSAL>;
  return launch_grid(kernel, smem, C::kThreads, C::kRes,
                     WHICH == DKV ? p.s_kv : p.s_q, p, stream);
}

template <typename T, int DP, int WHICH>
cudaError_t launch_causal(const BwdParams& p, bool causal, cudaStream_t s) {
  return causal ? launch_kernel<T, DP, true, WHICH>(p, s)
                : launch_kernel<T, DP, false, WHICH>(p, s);
}

// the widest cp.async that every row of the streamed operands allows (q
// and dout in dkv, k and v in dq)
template <typename T, int WHICH>
int copy_width(const BwdParams& p) {
  const void* a = WHICH == DKV ? p.q : p.k;
  const void* b = WHICH == DKV ? p.dout : p.v;
  const int64_t st[6] = {
      WHICH == DKV ? p.q_sb : p.k_sb, WHICH == DKV ? p.q_ss : p.k_ss,
      WHICH == DKV ? p.q_sh : p.k_sh, WHICH == DKV ? p.do_sb : p.v_sb,
      WHICH == DKV ? p.do_ss : p.v_ss, WHICH == DKV ? p.do_sh : p.v_sh};
  return mxtt::copy_width(a, b, sizeof(T), st);
}

template <typename T, int WHICH>
cudaError_t launch_dim(const BwdParams& p, bool causal, cudaStream_t s) {
  BwdParams pw = p;
  pw.width = copy_width<T, WHICH>(p);
  if (p.d <= 64) return launch_causal<T, 64, WHICH>(pw, causal, s);
  if (p.d <= 128) return launch_causal<T, 128, WHICH>(pw, causal, s);
  return launch_causal<T, 256, WHICH>(pw, causal, s);
}

template <typename T, int DP, bool CAUSAL, int WHICH>
cudaError_t launch_kernel_wg(const BwdParams& p, cudaStream_t stream) {
  using C = TilesWG<DP, WHICH>;
  constexpr size_t smem = smem_bytes_wg<DP, WHICH>();
  static_assert(smem <= kMaxSmem, "tiles exceed the shared memory of a CTA");
  auto kernel = WHICH == DKV
                    ? flash_attention_bwd_dkv_wgmma_kernel<T, DP, CAUSAL>
                    : flash_attention_bwd_dq_wgmma_kernel<T, DP, CAUSAL>;
  return launch_grid(kernel, smem, C::kThreads, C::kRes,
                     WHICH == DKV ? p.s_kv : p.s_q, p, stream);
}

template <typename T, int DP, int WHICH>
cudaError_t launch_causal16(const BwdParams& p, bool causal, cudaStream_t s) {
  if constexpr (DP <= 128) {
    return causal ? launch_kernel_wg<T, DP, true, WHICH>(p, s)
                  : launch_kernel_wg<T, DP, false, WHICH>(p, s);
  } else {
    return causal ? launch_kernel16<T, DP, true, WHICH>(p, s)
                  : launch_kernel16<T, DP, false, WHICH>(p, s);
  }
}

// 16-bit inputs: the resident operands are copied too, so the width is
// the widest that every row of q, k, v and dout allows
template <typename T, int WHICH>
cudaError_t launch_dim16(const BwdParams& p, bool causal, cudaStream_t s) {
  BwdParams pw = p;
  const int wq = copy_width<T, DKV>(p);
  const int wk = copy_width<T, DQ>(p);
  pw.width = wq < wk ? wq : wk;
  if (p.d <= 64) return launch_causal16<T, 64, WHICH>(pw, causal, s);
  if (p.d <= 128) return launch_causal16<T, 128, WHICH>(pw, causal, s);
  return launch_causal16<T, 256, WHICH>(pw, causal, s);
}

template <int WHICH>
long long smem_f32(int d) {
  if (d <= 64) return static_cast<long long>(smem_bytes<float, 64, WHICH>());
  if (d <= 128) return static_cast<long long>(smem_bytes<float, 128, WHICH>());
  return static_cast<long long>(smem_bytes<float, 256, WHICH>());
}

template <int WHICH>
long long smem_16bit(int d) {
  if (d <= 64) return static_cast<long long>(smem_bytes_wg<64, WHICH>());
  if (d <= 128) return static_cast<long long>(smem_bytes_wg<128, WHICH>());
  return static_cast<long long>(smem_bytes16<256, WHICH>());
}

template <int WHICH>
long long smem_of(int dtype, int d) {
  if (d <= 0 || d > 256) return -1;
  switch (dtype) {
    case DT_F32:
      return smem_f32<WHICH>(d);
    case DT_BF16:
    case DT_F16:
      return smem_16bit<WHICH>(d);
    default:
      return -1;
  }
}

template <int WHICH>
int launch(const BwdParams& p, int causal, int dtype, void* stream) {
  if (p.q == nullptr || p.k == nullptr || p.v == nullptr ||
      p.dout == nullptr || p.lse == nullptr || p.delta == nullptr ||
      (WHICH == DKV && (p.dk == nullptr || p.dv == nullptr)) ||
      (WHICH == DQ && p.dq == nullptr) || p.bh <= 0 || p.heads <= 0 ||
      p.s_q <= 0 || p.s_kv <= 0 || p.d <= 0 || p.d > 256) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_dim<float, WHICH>(p, causal != 0, s);
    case DT_BF16:
      return launch_dim16<__nv_bfloat16, WHICH>(p, causal != 0, s);
    case DT_F16:
      return launch_dim16<__half, WHICH>(p, causal != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

BwdParams make_params(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, const void* lse, const void* delta, long long batch,
    long long heads, long long s_q, long long s_kv, int d,
    const long long* st, float scale) {
  return BwdParams{q, k, v, dout, dq, dk, dv,
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta), heads, batch * heads,
                   s_q, s_kv, d,
                   st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                   st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                   st[15], st[16], st[17], st[18], st[19], st[20], scale, 0};
}

}  // namespace

// strides: 21 values, (batch, seq, head) of q, k, v, dout, dq, dk, dv in
// that order, in elements; the head dim is contiguous
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, void* dk,
    void* dv, const void* lse, const void* delta, long long batch,
    long long heads, long long s_q, long long s_kv, int d,
    const long long* strides, int causal, float scale, int dtype,
    void* stream) {
  if (strides == nullptr) return cudaErrorInvalidValue;
  const BwdParams p = make_params(q, k, v, dout, nullptr, dk, dv, lse, delta,
                                  batch, heads, s_q, s_kv, d, strides, scale);
  return launch<DKV>(p, causal, dtype, stream);
}

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    const void* lse, const void* delta, long long batch, long long heads,
    long long s_q, long long s_kv, int d, const long long* strides,
    int causal, float scale, int dtype, void* stream) {
  if (strides == nullptr) return cudaErrorInvalidValue;
  const BwdParams p = make_params(q, k, v, dout, dq, nullptr, nullptr, lse,
                                  delta, batch, heads, s_q, s_kv, d, strides,
                                  scale);
  return launch<DQ>(p, causal, dtype, stream);
}

// dynamic shared memory of one CTA of the dK/dV (which 0) or dQ (which 1)
// kernel for a dtype code and head dim, in bytes; -1 for one not taken
extern "C" long long flash_attention_bwd_smem_bytes(int which, int dtype,
                                                    int d) {
  return which == DKV ? smem_of<DKV>(dtype, d) : smem_of<DQ>(dtype, d);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

