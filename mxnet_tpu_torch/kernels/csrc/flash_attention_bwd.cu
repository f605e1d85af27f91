// K3's backward, flash attention: dq, dk and dv of out = softmax(scale *
// q k^T, masked) v, given dout, the forward's row log-sum-exp lse and the
// row sums delta = sum_d dout * out. All math in fp32; dq, dk and dv are
// stored in q's dtype (f32, bf16 or f16).
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
// 2 * B * H * S_q * S_kv * D flops (s and dp twice, dv, dk, dq; half under
// causal) against about 8 * B * H * S * D * 4 bytes of q, k, v, dout and
// the three gradients; the least time of the 5 products the gradients need
// is 10 * B * H * S_q * S_kv * D / 67 TFLOP/s (fp32 FMA, no tensor cores,
// no TF32, as every fp32 path of the port).
//
// Design (a first version that is right and simple; tensor-core tiles,
// TMA staging and bf16 operands come later). Two kernels, as the TPU splits
// it, deterministic, with no atomics:
//   - dkv: one CTA of 256 threads owns a tile of BK keys of one (batch,
//     head) and loops over the 64-row query tiles (from the first query
//     that may attend it under causal). K and V stay in shared memory; dk
//     and dv accumulate in registers.
//   - dq: one CTA owns a tile of 64 query rows and loops over the BK-key
//     tiles (up to the diagonal under causal); q and dout stay in shared
//     memory, dq accumulates in registers.
//   - BK is 64 keys for D <= 128 and 32 for D <= 256, so shared memory
//     stays within the 227 KB a CTA may use (set with cudaFuncSetAttribute
//     at each launch, as the forward does).
//   - Every operand is staged as fp32 rows [row][D + 4]: a thread of the
//     16 x 16 grid owns rows ty + 16 i of one operand and tx + 16 j of the
//     other, so a product reads one float4 of each row per 4 columns; the
//     16 distinct rows a warp reads are 4 banks apart (conflict-free), the
//     rows the two half-warps share are broadcasts.
//   - p and ds go to shared memory [row][BK + 16 or 80] (the two
//     half-warps' stores land on different banks) and feed the accumulation
//     of dv, dk or dq, each thread owning 4 columns of every 64 of D.
//   - Exact expf, as in the forward and the plain version.
//   - Offsets are 64-bit: q, k, v, dout, dq, dk and dv are addressed
//     through their own (batch, seq, head) strides with a contiguous D, so
//     the gradient of a fused QKV projection is written in place through
//     the same column-block strides its forward read.
//
// C interface for ctypes: flash_attention_bwd_dkv_launch and
// flash_attention_bwd_dq_launch return the cudaError_t of the launch (0 on
// success); flash_attention_bwd_error_string names it.

#include <math.h>

#include "epilogue_common.cuh"

using namespace mxtt;

namespace {

constexpr int kBQ = 64;            // query rows per tile
constexpr int kThreadsBwd = 256;   // 16 x 16 threads
constexpr int kPadP = 80;          // row stride of the dkv kernel's p, ds

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
};

template <int DP>
__host__ __device__ constexpr int key_tile() { return DP <= 128 ? 64 : 32; }

template <int DP>
constexpr int dq_smem_floats() {
  // q, dout [kBQ][DP + 4]; K, V [BK][DP + 4]; ds [kBQ][BK + 16]
  return 2 * kBQ * (DP + 4) + 2 * key_tile<DP>() * (DP + 4) +
         kBQ * (key_tile<DP>() + 16);
}

template <int DP>
constexpr int dkv_smem_floats() {
  // K, V [BK][DP + 4]; q, dout [kBQ][DP + 4]; p, ds [BK][kPadP]; lse, delta
  return 2 * key_tile<DP>() * (DP + 4) + 2 * kBQ * (DP + 4) +
         2 * key_tile<DP>() * kPadP + 2 * kBQ;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [r0, r0 + ROWS) of a (seq, D) operand with sequence stride ss into
// dst [ROWS][DP + 4] as fp32; rows past n and columns past d are zeros
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int64_t ss, int64_t r0,
                                           int64_t n, int d) {
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += kThreadsBwd) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int64_t row = r0 + r;
    dst[r * (DP + 4) + c] =
        (row < n && c < d) ? to_f32(src[row * ss + c]) : 0.0f;
  }
}

// acc[i][j] = A[ty + 16 i] . B[tx + 16 j] over DP columns
template <int DP, int NA, int NB>
__device__ __forceinline__ void rows_dot(float (&acc)[NA][NB],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int RS = DP + 4;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 a[NA], b[NB];
#pragma unroll
    for (int i = 0; i < NA; ++i) a[i] = ld4(A + (ty + 16 * i) * RS + c);
#pragma unroll
    for (int j = 0; j < NB; ++j) b[j] = ld4(B + (tx + 16 * j) * RS + c);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][4 nc + e] += sum_r W[ty + 16 i][r] * M[r][64 nc + 4 tx + e] over
// R rows of M ([R][DP + 4]); W has row stride WS
template <int DP, int NA, int R, int WS>
__device__ __forceinline__ void accum_rows(float (&acc)[NA][DP / 16],
                                           const float* W, const float* M,
                                           int ty, int tx) {
  constexpr int RS = DP + 4;
  constexpr int NC = DP / 64;
#pragma unroll 2
  for (int r0 = 0; r0 < R; r0 += 4) {
    float w[NA][4];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float4 x = ld4(W + (ty + 16 * i) * WS + r0);
      w[i][0] = x.x;
      w[i][1] = x.y;
      w[i][2] = x.z;
      w[i][3] = x.w;
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const float4 m = ld4(M + (r0 + rr) * RS + 64 * nc + 4 * tx);
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          acc[i][4 * nc + 0] = fmaf(w[i][rr], m.x, acc[i][4 * nc + 0]);
          acc[i][4 * nc + 1] = fmaf(w[i][rr], m.y, acc[i][4 * nc + 1]);
          acc[i][4 * nc + 2] = fmaf(w[i][rr], m.z, acc[i][4 * nc + 2]);
          acc[i][4 * nc + 3] = fmaf(w[i][rr], m.w, acc[i][4 * nc + 3]);
        }
      }
    }
  }
}

// rows ty + 16 i of acc * mul into a (seq, D) gradient from row r0
template <typename T, int DP, int NA>
__device__ __forceinline__ void store_rows(T* dst, int64_t ss, int64_t r0,
                                           int64_t n, int d,
                                           const float (&acc)[NA][DP / 16],
                                           float mul, int ty, int tx) {
  constexpr int NC = DP / 64;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int64_t row = r0 + ty + 16 * i;
    if (row >= n) continue;
    T* o = dst + row * ss;
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * nc + 4 * tx + e;
        if (c < d) o[c] = from_f32<T>(acc[i][4 * nc + e] * mul);
      }
    }
  }
}

__device__ __forceinline__ int64_t bh_index() {
  return static_cast<int64_t>(blockIdx.y) +
         static_cast<int64_t>(gridDim.y) * blockIdx.z;
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreadsBwd)
flash_attention_bwd_dkv_kernel(BwdParams p) {
  constexpr int BK = key_tile<DP>();
  constexpr int RK = BK / 16;     // keys per thread
  constexpr int RS = DP + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BK][RS]
  float* Vs = Ks + BK * RS;                      // [BK][RS]
  float* Qs = Vs + BK * RS;                      // [kBQ][RS]
  float* dOs = Qs + kBQ * RS;                    // [kBQ][RS]
  float* Ps = dOs + kBQ * RS;                    // [BK][kPadP]
  float* dSs = Ps + BK * kPadP;                  // [BK][kPadP]
  float* lse_s = dSs + BK * kPadP;               // [kBQ]
  float* delta_s = lse_s + kBQ;                  // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
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

  stage_rows<T, DP, BK>(Ks, k, p.k_ss, n0, p.s_kv, p.d);
  stage_rows<T, DP, BK>(Vs, v, p.v_ss, n0, p.s_kv, p.d);

  // query i may attend key j when j <= i + offset (bottom-right causal):
  // the first query tile that can reach this key tile
  const int64_t offset = p.s_kv - p.s_q;
  int64_t q_begin = 0;
  if (CAUSAL) {
    q_begin = n0 - offset;
    if (q_begin < 0) q_begin = 0;
  }
  const int64_t t_begin = q_begin / kBQ;
  const int64_t t_end = (p.s_q + kBQ - 1) / kBQ;

  float dk[RK][DP / 16], dv[RK][DP / 16];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      dk[i][c] = 0.0f;
      dv[i][c] = 0.0f;
    }
  }

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t m0 = t * kBQ;
    __syncthreads();              // the last tile's Qs, dOs, Ps, dSs are read
    stage_rows<T, DP, kBQ>(Qs, q, p.q_ss, m0, p.s_q, p.d);
    stage_rows<T, DP, kBQ>(dOs, dout, p.do_ss, m0, p.s_q, p.d);
    if (tid < kBQ) {
      const int64_t row = m0 + tid;
      lse_s[tid] = row < p.s_q ? lse[row] : 0.0f;
      delta_s[tid] = row < p.s_q ? delta[row] : 0.0f;
    }
    __syncthreads();

    // keys ty + 16 i against queries tx + 16 j
    float s[RK][4], dp[RK][4];
    rows_dot<DP, RK, 4>(s, Ks, Qs, ty, tx);
    rows_dot<DP, RK, 4>(dp, Vs, dOs, ty, tx);
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int64_t key = n0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const int64_t row = m0 + qi;
        bool ok = key < p.s_kv && row < p.s_q;
        if (CAUSAL) ok = ok && key <= row + offset;
        const float pr = ok ? expf(s[i][j] * p.scale - lse_s[qi]) : 0.0f;
        Ps[(ty + 16 * i) * kPadP + qi] = pr;
        dSs[(ty + 16 * i) * kPadP + qi] = pr * (dp[i][j] - delta_s[qi]);
      }
    }
    __syncthreads();

    accum_rows<DP, RK, kBQ, kPadP>(dv, Ps, dOs, ty, tx);
    accum_rows<DP, RK, kBQ, kPadP>(dk, dSs, Qs, ty, tx);
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<T, DP, RK>(dkp, p.dk_ss, n0, p.s_kv, p.d, dk, p.scale, ty, tx);
  store_rows<T, DP, RK>(dvp, p.dv_ss, n0, p.s_kv, p.d, dv, 1.0f, ty, tx);
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreadsBwd)
flash_attention_bwd_dq_kernel(BwdParams p) {
  constexpr int BK = key_tile<DP>();
  constexpr int RK = BK / 16;     // keys per thread
  constexpr int RS = DP + 4;
  constexpr int SS = BK + 16;     // row stride of ds
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][RS]
  float* dOs = Qs + kBQ * RS;                    // [kBQ][RS]
  float* Ks = dOs + kBQ * RS;                    // [BK][RS]
  float* Vs = Ks + BK * RS;                      // [BK][RS]
  float* dSs = Vs + BK * RS;                     // [kBQ][SS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t bh = bh_index();
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  stage_rows<T, DP, kBQ>(Qs, q, p.q_ss, m0, p.s_q, p.d);
  stage_rows<T, DP, kBQ>(dOs, dout, p.do_ss, m0, p.s_q, p.d);
  float lse_i[4], delta_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + ty + 16 * i;
    lse_i[i] = row < p.s_q ? p.lse[bh * p.s_q + row] : 0.0f;
    delta_i[i] = row < p.s_q ? p.delta[bh * p.s_q + row] : 0.0f;
  }

  // key j is allowed for query i when j <= i + offset (bottom-right causal)
  const int64_t offset = p.s_kv - p.s_q;
  int64_t kv_end = p.s_kv;
  if (CAUSAL) {
    const int64_t last_row = (m0 + kBQ < p.s_q ? m0 + kBQ : p.s_q) - 1;
    const int64_t limit = last_row + offset + 1;
    kv_end = limit < kv_end ? limit : kv_end;
  }
  const int64_t n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  float acc[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[i][c] = 0.0f;
  }

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t n0 = t * BK;
    __syncthreads();              // the last tile's Ks, Vs and dSs are read
    stage_rows<T, DP, BK>(Ks, k, p.k_ss, n0, p.s_kv, p.d);
    stage_rows<T, DP, BK>(Vs, v, p.v_ss, n0, p.s_kv, p.d);
    __syncthreads();

    // queries ty + 16 i against keys tx + 16 j
    float s[4][RK], dp[4][RK];
    rows_dot<DP, 4, RK>(s, Qs, Ks, ty, tx);
    rows_dot<DP, 4, RK>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kj = tx + 16 * j;
        const int64_t key = n0 + kj;
        bool ok = key < p.s_kv && row < p.s_q;
        if (CAUSAL) ok = ok && key <= row + offset;
        const float pr = ok ? expf(s[i][j] * p.scale - lse_i[i]) : 0.0f;
        dSs[(ty + 16 * i) * SS + kj] = pr * (dp[i][j] - delta_i[i]);
      }
    }
    __syncthreads();

    accum_rows<DP, 4, BK, SS>(acc, dSs, Ks, ty, tx);
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<T, DP, 4>(dqp, p.dq_ss, m0, p.s_q, p.d, acc, p.scale, ty, tx);
}

enum Which { DKV = 0, DQ = 1 };

template <typename T, int DP, bool CAUSAL, int WHICH>
cudaError_t launch_kernel(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (WHICH == DKV ? dkv_smem_floats<DP>()
                                                    : dq_smem_floats<DP>());
  auto kernel = WHICH == DKV ? flash_attention_bwd_dkv_kernel<T, DP, CAUSAL>
                             : flash_attention_bwd_dq_kernel<T, DP, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t tile = WHICH == DKV ? key_tile<DP>() : kBQ;
  const int64_t len = WHICH == DKV ? p.s_kv : p.s_q;
  const int64_t tiles = (len + tile - 1) / tile;
  const int64_t max_y = 65535;
  const int64_t grid_y = p.bh < max_y ? p.bh : max_y;
  const int64_t grid_z = (p.bh + grid_y - 1) / grid_y;
  if (tiles > 0x7fffffffLL || grid_z > max_y) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(grid_z));
  kernel<<<grid, kThreadsBwd, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP, int WHICH>
cudaError_t launch_causal(const BwdParams& p, bool causal, cudaStream_t s) {
  return causal ? launch_kernel<T, DP, true, WHICH>(p, s)
                : launch_kernel<T, DP, false, WHICH>(p, s);
}

template <typename T, int WHICH>
cudaError_t launch_dim(const BwdParams& p, bool causal, cudaStream_t s) {
  if (p.d <= 64) return launch_causal<T, 64, WHICH>(p, causal, s);
  if (p.d <= 128) return launch_causal<T, 128, WHICH>(p, causal, s);
  return launch_causal<T, 256, WHICH>(p, causal, s);
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
      return launch_dim<__nv_bfloat16, WHICH>(p, causal != 0, s);
    case DT_F16:
      return launch_dim<__half, WHICH>(p, causal != 0, s);
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
                   st[15], st[16], st[17], st[18], st[19], st[20], scale};
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

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
