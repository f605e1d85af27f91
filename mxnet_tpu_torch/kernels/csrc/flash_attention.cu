// K3/K3', flash attention: out[b,i,h,:] = sum_j softmax_j(scale * q_i . k_j,
// masked) v_j, streamed over key tiles with an online softmax, all math in
// fp32, stored in q's dtype (f32, bf16 or f16).
//
// Replaces two TPU entries that compute the same function:
//   - mxnet_tpu/ops/contrib.py _flash_attention (K3): the JAX library's
//     Pallas TPU flash attention, taken above 1024 keys when S_q % 128 == 0
//     and D >= 64;
//   - mxnet_tpu/pallas/kernels.py _blockwise_pallas (K3'): the lax.scan
//     online softmax of mxnet_tpu/parallel/ring_attention.py _blockwise_impl
//     that every other backend runs above 1024 keys.
// This one kernel takes every S_kv above 1024, any S_q and S_kv (not only
// multiples of a tile) and any D up to 256. Causal masking is bottom-right
// aligned as in _blockwise_impl (query i attends keys j <= i + S_kv - S_q);
// a query row with no allowed key is written as zeros.
//
// Bound on an H100: operations. A launch does 4 * B * H * S_q * S_kv * D
// flops (half of that under causal) against about 4 * B * H * S * D * 4
// bytes of q, k, v and out; at S 4096, D 64 that is 1024 flops a byte,
// far above the card's 20 flops a byte for fp32 outside the tensor cores.
// The least time is flops / 67 TFLOP/s (fp32 FMA, no tensor cores, no
// TF32, as every fp32 path of the port).
//
// Design (a first version that is right and simple; tensor-core tiles,
// TMA staging and bf16 operands come later):
//   - One CTA of 256 threads per (tile of 64 query rows, batch * head).
//     Query tiles vary fastest across the grid, so the CTAs in flight share
//     the K and V of a few heads in L2.
//   - The q tile is staged once in shared memory, transposed to [d][row];
//     each K/V tile of 64 keys is staged as K^T [d][key] and V [key][d],
//     all as fp32 (rows padded to 68 floats: float4 reads stay aligned and
//     the two half-warps land on different banks).
//   - Thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3 and, in
//     the score tile, keys 4tx..4tx+3: per d one float4 of q^T and one of
//     K^T feed 16 FMAs. The 16 threads of a row are 16 lanes of one warp,
//     so the row max and row sum are combined with 4 xor shuffles.
//   - The probabilities go to shared memory [row][key]; P V accumulates in
//     registers, each thread owning its 4 rows times 4 columns of every 64
//     columns of D (16 to 64 accumulators).
//   - The update is _online_block's: m_new = max(m, rowmax), alpha =
//     exp(m - m_new), p = exp(s - m_new), l = l * alpha + sum p, o = o *
//     alpha + p v; out = o / l. Exact expf (no __expf) and an IEEE divide,
//     so the kernel holds 1e-5 of max |out| against the plain version;
//     only the order of the sums differs.
//   - Masked scores are -1e30 as in _blockwise_impl; under causal, key
//     tiles past the diagonal of the CTA's last row are skipped (their
//     exp(-1e30 - m) is an exact 0 in the plain version too). Keys past
//     S_kv in the last tile are masked the same way.
//   - Offsets are 64-bit: q, k, v and out are addressed through their own
//     (batch, seq, head) strides in elements with a contiguous D, so
//     strided views of a fused QKV projection are read in place.
//   - When a gradient is wanted the wrapper passes an fp32 (B * H, S_q)
//     buffer and the kernel also writes each row's log-sum-exp m + log l,
//     which the backward kernels (flash_attention_bwd.cu) recompute the
//     probabilities from; a row with no allowed key gets +inf there, so
//     exp(s - lse) is 0 for every key. Serving passes no buffer and writes
//     nothing more.
//
// C interface for ctypes: flash_attention_launch returns the cudaError_t of
// the launch (0 on success); flash_attention_error_string names it. lse may
// be null.

#include "epilogue_common.cuh"

using namespace mxtt;

namespace {

constexpr int kBM = 64;           // query rows per CTA
constexpr int kBN = 64;           // keys per tile
constexpr int kThreadsFA = 256;   // 16 x 16 threads, 4 x 4 rows x keys each
constexpr int kPad = 68;          // row stride of Qt, Kt and Ps, in floats
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
};

template <int DP>
constexpr int smem_floats() {
  return 2 * DP * kPad + kBN * DP + kBM * kPad;  // Qt, Kt, Vs, Ps
}

// max and sum over the 16 lanes that share a query row (xor 8, 4, 2, 1 stays
// inside each half of the warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(kFull, x, off);
  }
  return x;
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreadsFA)
flash_attention_kernel(Params p) {
  constexpr int NC = DP / 64;     // 64-column chunks of D per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [DP][kPad]: q^T
  float* Kt = Qt + DP * kPad;                    // [DP][kPad]: K^T
  float* Vs = Kt + DP * kPad;                    // [kBN][DP]
  float* Ps = Vs + kBN * DP;                     // [kBM][kPad]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t bh = static_cast<int64_t>(blockIdx.y) +
                     static_cast<int64_t>(gridDim.y) * blockIdx.z;
  if (bh >= p.bh) return;                        // whole CTA: no barrier hit
  const int64_t b = bh / p.heads;
  const int64_t h = bh % p.heads;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;

  // q tile, transposed; rows past S_q and columns past D are zeros
  for (int idx = tid; idx < kBM * DP; idx += kThreadsFA) {
    const int r = idx / DP;
    const int c = idx % DP;
    const int64_t row = m0 + r;
    Qt[c * kPad + r] =
        (row < p.s_q && c < p.d) ? to_f32(q[row * p.q_ss + c]) : 0.0f;
  }

  // key j is allowed for query i when j <= i + offset (bottom-right causal)
  const int64_t offset = p.s_kv - p.s_q;
  int64_t kv_end = p.s_kv;
  if (CAUSAL) {
    const int64_t last_row = (m0 + kBM < p.s_q ? m0 + kBM : p.s_q) - 1;
    const int64_t limit = last_row + offset + 1;
    kv_end = limit < kv_end ? limit : kv_end;
  }
  const int64_t n_tiles = kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;

  float m_i[4], l_i[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNeg;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.0f;
  }

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t n0 = t * kBN;
    __syncthreads();              // the last tile's Kt, Vs and Ps are read
    for (int idx = tid; idx < kBN * DP; idx += kThreadsFA) {
      const int r = idx / DP;
      const int c = idx % DP;
      const int64_t key = n0 + r;
      const bool in = key < p.s_kv && c < p.d;
      Kt[c * kPad + r] = in ? to_f32(k[key * p.k_ss + c]) : 0.0f;
      Vs[r * DP + c] = in ? to_f32(v[key * p.v_ss + c]) : 0.0f;
    }
    __syncthreads();

    // scores of rows 4ty+i against keys 4tx+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + c * kPad +
                                                        4 * ty);
      const float4 kk = *reinterpret_cast<const float4*>(Kt + c * kPad +
                                                         4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
      }
    }

    // scale, mask, online softmax update; p goes to Ps
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = m0 + 4 * ty + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t key = n0 + 4 * tx + j;
        bool ok = key < p.s_kv;
        if (CAUSAL) ok = ok && key <= row + offset;
        s[i][j] = ok ? s[i][j] * p.scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l_i[i] = l_i[i] * alpha + row_sum(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(Ps + (4 * ty + i) * kPad + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // o += p v over the tile's 64 keys, four at a time
#pragma unroll 2
    for (int j0 = 0; j0 < kBN; j0 += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(
            Ps + (4 * ty + i) * kPad + j0);
        pr[i][0] = x.x;
        pr[i][1] = x.y;
        pr[i][2] = x.z;
        pr[i][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) {
          const float4 w = *reinterpret_cast<const float4*>(
              Vs + (j0 + jj) * DP + 64 * nc + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * nc + 0] = fmaf(pr[i][jj], w.x, acc[i][4 * nc + 0]);
            acc[i][4 * nc + 1] = fmaf(pr[i][jj], w.y, acc[i][4 * nc + 1]);
            acc[i][4 * nc + 2] = fmaf(pr[i][jj], w.z, acc[i][4 * nc + 2]);
            acc[i][4 * nc + 3] = fmaf(pr[i][jj], w.w, acc[i][4 * nc + 3]);
          }
        }
      }
    }
  }

  // out = o / l in q's dtype; rows with no allowed key are zeros
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + 4 * ty + i;
    if (row >= p.s_q) continue;
    const bool empty = CAUSAL && row + offset < 0;
    if (p.lse != nullptr && tx == 0) {
      p.lse[bh * p.s_q + row] = empty ? INFINITY : m_i[i] + logf(l_i[i]);
    }
    T* o = out + row * p.o_ss;
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * nc + 4 * tx + e;
        if (c < p.d) {
          o[c] = from_f32<T>(empty ? 0.0f : acc[i][4 * nc + e] / l_i[i]);
        }
      }
    }
  }
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_kernel(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP>();
  auto kernel = flash_attention_kernel<T, DP, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t q_tiles = (p.s_q + kBM - 1) / kBM;
  const int64_t max_y = 65535;
  const int64_t grid_y = p.bh < max_y ? p.bh : max_y;
  const int64_t grid_z = (p.bh + grid_y - 1) / grid_y;
  if (q_tiles > 0x7fffffffLL || grid_z > max_y) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(q_tiles),
                  static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(grid_z));
  kernel<<<grid, kThreadsFA, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_causal(const Params& p, bool causal, cudaStream_t s) {
  return causal ? launch_kernel<T, DP, true>(p, s)
                : launch_kernel<T, DP, false>(p, s);
}

template <typename T>
cudaError_t launch_dim(const Params& p, bool causal, cudaStream_t s) {
  if (p.d <= 64) return launch_causal<T, 64>(p, causal, s);
  if (p.d <= 128) return launch_causal<T, 128>(p, causal, s);
  return launch_causal<T, 256>(p, causal, s);
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
           o_sb, o_ss, o_sh, scale};
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

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
