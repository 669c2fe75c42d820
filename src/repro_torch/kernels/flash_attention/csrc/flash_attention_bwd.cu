// Flash attention backward for Hopper (sm_90a), built by kernels/build.py
// into a shared library with a plain C interface and called through ctypes
// from kernels/flash_attention/ops.py (the backward of its
// torch.autograd.Function).
//
// The TPU package has no backward kernel: it trains by autodiff through
// the plain dense_attention (src/repro/models/layers/attention.py:93).
// These kernels differentiate the function of the forward kernel
// (flash_attention.cu, which replaces
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel)
// from q, k, v, the upstream gradient dO and the row log-sum-exp L that the
// forward writes:
//
//   S = softcap(scale q k^T), masked     P = exp(S - L)
//   dP = dO V^T                          D_i = sum_j P_ij dP_ij
//   dS = P o (dP - D) o (1 - tanh^2(scale q k^T / cap))   (no softcap: 1)
//   dQ = scale dS K      dK = scale dS^T Q      dV = P^T dO
//
// D_i equals rowsum(dO o O) in exact arithmetic, but from the bf16 output
// O it misses the bf16 tolerance on rows whose softmax is peaked (there dQ
// is small and D's rounding error is not); summed from P and dP in fp32 it
// is what the plain version's autograd computes.
//
// with the causal mask, the sliding window, GQA (q head h reads KV head
// h / (H / KV)) and ragged Sq, Sk; masked pairs have P = 0, so a row with no
// live key (L = -inf) gives exactly 0 and no NaN.
//
// Two kernels, each a loop inside one block of 4 warps, both on scalar
// fp32 FMAs (tensor cores are later work), for fp32 and bf16 inputs (fp32
// arithmetic, grads stored in the input dtype), any head dim from 8 to 256
// that is a multiple of 4 (padded with zeros to a multiple of 32), q, k, v
// read through their (B, H, S, D) strides:
//
// flash_bwd_dq_kernel: one block per (q tile, head, batch).  It walks the
//   live KV tiles of 32 keys twice: first for D_i of its rows (written out
//   for the next kernel), then for dQ.  Lane j owns key j for S and dP
//   (the rows' q and dO broadcast from shared memory), and output dims
//   lane + 32 c for dQ += dS K.
// flash_bwd_dkdv_kernel: one block per (KV tile, KV head, batch).  It walks
//   every q head of the GQA group and every live q tile of 32 queries:
//   lane j owns query j for S^T and dP^T (the block's keys broadcast), and
//   output dims lane + 32 c for dV += P^T dO and dK += dS^T Q.  The group
//   sums in registers, so no atomics and no second pass.
//
// What bounds it.  At the gpt-1.3b training shape (B 8, H 32, S 512, D 64,
// causal, bf16) the function reads q, k, v, dO (bf16) and L (fp32) and
// writes dq, dk, dv (bf16): ~118 MB, 35 us at 3.35 TB/s.  Its products
// (dP = dO V^T, dQ, dK, dV, and S once) are 10 D FLOP per live (q, k)
// pair: ~22 GFLOP, 22 us at 989 TFLOP/s of bf16 tensor cores, so bytes
// bound the function.  These kernels do 18 D FLOP a pair (S and dP three
// times: twice in the dq kernel, once in the dkdv kernel) on the fp32
// pipe (67 TFLOP/s): ~0.6 ms at best, so the scalar arithmetic bounds
// them; tensor cores are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;  // keys (dq) or queries (dkdv) of an inner tile
// rows a warp owns: q rows (dq kernel) or keys (dkdv kernel); fewer at the
// large head dims, where the accumulators (rows x D / 32 a lane) grow
__host__ __device__ constexpr int dq_rows(int dp) {
  return dp <= 128 ? 16 : 8;
}
__host__ __device__ constexpr int dkdv_rows(int dp) {
  return dp <= 64 ? 16 : 8;
}

// tensors, in the order of BwdParams::st
enum { kQ, kK, kV, kDO, kDQ, kDK, kDV, kTensors };

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B, H, Sq), natural log, -inf for a row with no key
  float* delta;      // (B, H, Sq): D_i, written by the dq kernel
  void* dq;
  void* dk;
  void* dv;
  int B, H, KVH, Sq, Sk, D;
  long long st[kTensors][3];  // batch, head, seq strides in elements
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows s0 .. s0 + nrows - 1 of a (S, D) matrix (row stride ss) into an fp32
// shared tile of row stride ld; rows past S and dims past D are zeros.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long ss, int s0, int S, int D,
                                          int nrows) {
  for (int i = threadIdx.x; i < nrows * DP; i += kThreads) {
    const int r = i / DP, d = i - (i / DP) * DP, s = s0 + r;
    dst[r * ld + d] = s < S && d < D ? to_f(src[s * ss + d]) : 0.f;
  }
}

__device__ __forceinline__ bool live(const BwdParams& p, int qp, int kp) {
  bool in = qp < p.Sq && kp < p.Sk;
  if (p.causal) in = in && kp <= qp;
  if (p.window > 0) in = in && qp - kp < p.window;
  return in;
}

// The logit of q.k = s after the scale and the softcap, as the forward
// kernels compute it; dcap is its derivative in the scaled score.
__device__ __forceinline__ float logit(const BwdParams& p, float s,
                                       float& dcap) {
  float x = s * p.scale;
  dcap = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    dcap = 1.f - t * t;
  }
  return x;
}

template <typename T, int DP>
constexpr size_t dq_smem_bytes() {
  constexpr int TQ = kWarps * dq_rows(DP);
  // q, dO [TQ][DP]; k, v [32][DP + 4]; dS [4][rows][32]; L, D [TQ]
  return sizeof(float) * (2 * TQ * DP + 2 * kCols * (DP + 4) +
                          TQ * kCols + 2 * TQ);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  constexpr int R = dq_rows(DP);
  constexpr int TQ = kWarps * R;
  constexpr int KS = DP + 4;  // lane-indexed rows: 4 floats apart in banks
  constexpr int NC = DP / 32;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + TQ * DP;
  float* k_s = do_s + TQ * DP;
  float* v_s = k_s + kCols * KS;
  float* ds_s = v_s + kCols * KS;
  float* lse_s = ds_s + TQ * kCols;
  float* di_s = lse_s + TQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_start = qt * TQ;
  const int row0 = warp * R;

  const T* qg = static_cast<const T*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][1];
  const T* kg =
      static_cast<const T*>(p.k) + b * p.st[kK][0] + kvh * p.st[kK][1];
  const T* vg =
      static_cast<const T*>(p.v) + b * p.st[kV][0] + kvh * p.st[kV][1];
  const T* dog =
      static_cast<const T*>(p.dout) + b * p.st[kDO][0] + h * p.st[kDO][1];
  T* dqg = static_cast<T*>(p.dq) + b * p.st[kDQ][0] + h * p.st[kDQ][1];
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_rows<T, DP>(q_s, DP, qg, p.st[kQ][2], q_start, p.Sq, p.D, TQ);
  load_rows<T, DP>(do_s, DP, dog, p.st[kDO][2], q_start, p.Sq, p.D, TQ);
  if (tid < TQ)
    lse_s[tid] = q_start + tid < p.Sq ? p.lse[row_base + q_start + tid] : 0.f;
  // (the first tile's barrier publishes q_s, do_s, lse_s)

  // live KV tiles: those the forward kernels keep for this q tile
  const int q_last = min(q_start + TQ, p.Sq) - 1;
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  const int kv_lo = p.window > 0 ? max(0, q_start - p.window + 1) : 0;
  const int t_lo = kv_lo / kCols;
  const int t_hi = (kv_hi + kCols - 1) / kCols;

  float acc[R][NC], dsum[R];  // dQ; this lane's share of D_i
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dsum[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  float* ds_w = ds_s + row0 * kCols;

  // pass 0 sums D_i, pass 1 accumulates dQ
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = t_lo; t < t_hi; ++t) {
      const int kv_start = t * kCols;
      __syncthreads();  // every warp is done with the previous K/V tile
      load_rows<T, DP>(k_s, KS, kg, p.st[kK][2], kv_start, p.Sk, p.D, kCols);
      load_rows<T, DP>(v_s, KS, vg, p.st[kV][2], kv_start, p.Sk, p.D, kCols);
      __syncthreads();

      // S = q k^T and dP = dO v^T: lane owns key kv_start + lane
      float s[R], dp[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
      const float4* krow = reinterpret_cast<const float4*>(k_s + lane * KS);
      const float4* vrow = reinterpret_cast<const float4*>(v_s + lane * KS);
#pragma unroll 2
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 kk = krow[d4];
        const float4 vv = vrow[d4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r] = dot4(
              reinterpret_cast<const float4*>(q_s + (row0 + r) * DP)[d4], kk,
              s[r]);
          dp[r] = dot4(
              reinterpret_cast<const float4*>(do_s + (row0 + r) * DP)[d4], vv,
              dp[r]);
        }
      }

      const int kp = kv_start + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int qp = q_start + row0 + r;
        float dcap;
        const float x = logit(p, s[r], dcap);
        const float pr = live(p, qp, kp) ? expf(x - lse_s[row0 + r]) : 0.f;
        if (pass == 0)
          dsum[r] = fmaf(pr, dp[r], dsum[r]);
        else
          ds_w[r * kCols + lane] = pr * (dp[r] - di_s[row0 + r]) * dcap;
      }
      if (pass == 0) continue;
      __syncwarp();

      // dQ += dS K: lane owns dims lane + 32 c
#pragma unroll 2
      for (int j4 = 0; j4 < kCols / 4; ++j4) {
        float kk[4][NC];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            kk[jj][c] = k_s[(j4 * 4 + jj) * KS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 dd =
              reinterpret_cast<const float4*>(ds_w + r * kCols)[j4];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[r][c] = fmaf(dd.x, kk[0][c], acc[r][c]);
            acc[r][c] = fmaf(dd.y, kk[1][c], acc[r][c]);
            acc[r][c] = fmaf(dd.z, kk[2][c], acc[r][c]);
            acc[r][c] = fmaf(dd.w, kk[3][c], acc[r][c]);
          }
        }
      }
    }
    if (pass == 0) {
      // D_i for this warp's rows, read by its own lanes in pass 1 and by
      // the dkdv kernel
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float di = warp_sum(dsum[r]);
        const int qp = q_start + row0 + r;
        if (lane == 0) {
          di_s[row0 + r] = di;
          if (qp < p.Sq) p.delta[row_base + qp] = di;
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qp = q_start + row0 + r;
    if (qp < p.Sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < p.D)
          store(dqg + qp * p.st[kDQ][2] + lane + 32 * c, acc[r][c] * p.scale);
    }
  }
}

template <typename T, int DP>
constexpr size_t dkdv_smem_bytes() {
  constexpr int TK = kWarps * dkdv_rows(DP);
  // k, v [TK][DP]; q, dO [32][DP + 4]; P, dS [4][rows][32]; L, D [32]
  return sizeof(float) * (2 * TK * DP + 2 * kCols * (DP + 4) +
                          2 * TK * kCols + 2 * kCols);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const __grid_constant__ BwdParams p) {
  constexpr int R = dkdv_rows(DP);
  constexpr int TK = kWarps * R;
  constexpr int KS = DP + 4;
  constexpr int NC = DP / 32;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + TK * DP;
  float* q_s = v_s + TK * DP;
  float* do_s = q_s + kCols * KS;
  float* p_s = do_s + kCols * KS;
  float* ds_s = p_s + TK * kCols;
  float* lse_s = ds_s + TK * kCols;
  float* di_s = lse_s + kCols;

  // the first key tiles see the most queries under the causal mask, and
  // blocks are issued in index order: they go first
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.H / p.KVH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kv_start = kt * TK;
  const int kv_last = min(kv_start + TK, p.Sk) - 1;
  const int row0 = warp * R;

  const T* kg =
      static_cast<const T*>(p.k) + b * p.st[kK][0] + kvh * p.st[kK][1];
  const T* vg =
      static_cast<const T*>(p.v) + b * p.st[kV][0] + kvh * p.st[kV][1];
  load_rows<T, DP>(k_s, DP, kg, p.st[kK][2], kv_start, p.Sk, p.D, TK);
  load_rows<T, DP>(v_s, DP, vg, p.st[kV][2], kv_start, p.Sk, p.D, TK);

  // live q tiles for these keys
  const int q_lo = p.causal ? kv_start : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, kv_last + p.window);
  const int t_lo = q_lo / kCols;
  const int t_hi = (q_hi + kCols - 1) / kCols;

  float dk[R][NC], dv[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;
  float* p_w = p_s + row0 * kCols;
  float* ds_w = ds_s + row0 * kCols;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const T* qg =
        static_cast<const T*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][1];
    const T* dog =
        static_cast<const T*>(p.dout) + b * p.st[kDO][0] + h * p.st[kDO][1];
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q_start = t * kCols;
      __syncthreads();  // every warp is done with the previous q tile
      load_rows<T, DP>(q_s, KS, qg, p.st[kQ][2], q_start, p.Sq, p.D, kCols);
      load_rows<T, DP>(do_s, KS, dog, p.st[kDO][2], q_start, p.Sq, p.D,
                       kCols);
      if (tid < kCols) {
        const int qp = q_start + tid;
        lse_s[tid] = qp < p.Sq ? p.lse[row_base + qp] : 0.f;
        di_s[tid] = qp < p.Sq ? p.delta[row_base + qp] : 0.f;
      }
      __syncthreads();

      // S^T = k q^T and dP^T = v dO^T: lane owns query q_start + lane
      float s[R], dp[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
      const float4* qrow = reinterpret_cast<const float4*>(q_s + lane * KS);
      const float4* orow = reinterpret_cast<const float4*>(do_s + lane * KS);
#pragma unroll 2
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 qq = qrow[d4];
        const float4 oo = orow[d4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r] = dot4(
              reinterpret_cast<const float4*>(k_s + (row0 + r) * DP)[d4], qq,
              s[r]);
          dp[r] = dot4(
              reinterpret_cast<const float4*>(v_s + (row0 + r) * DP)[d4], oo,
              dp[r]);
        }
      }

      const int qp = q_start + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int kp = kv_start + row0 + r;
        float dcap;
        const float x = logit(p, s[r], dcap);
        const float pr = live(p, qp, kp) ? expf(x - lse_s[lane]) : 0.f;
        p_w[r * kCols + lane] = pr;
        ds_w[r * kCols + lane] = pr * (dp[r] - di_s[lane]) * dcap;
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T Q: lane owns dims lane + 32 c
#pragma unroll 2
      for (int j4 = 0; j4 < kCols / 4; ++j4) {
        float qv[4][NC], ov[4][NC];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            qv[jj][c] = q_s[(j4 * 4 + jj) * KS + lane + 32 * c];
            ov[jj][c] = do_s[(j4 * 4 + jj) * KS + lane + 32 * c];
          }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 pp =
              reinterpret_cast<const float4*>(p_w + r * kCols)[j4];
          const float4 dd =
              reinterpret_cast<const float4*>(ds_w + r * kCols)[j4];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[r][c] = fmaf(pp.x, ov[0][c], dv[r][c]);
            dv[r][c] = fmaf(pp.y, ov[1][c], dv[r][c]);
            dv[r][c] = fmaf(pp.z, ov[2][c], dv[r][c]);
            dv[r][c] = fmaf(pp.w, ov[3][c], dv[r][c]);
            dk[r][c] = fmaf(dd.x, qv[0][c], dk[r][c]);
            dk[r][c] = fmaf(dd.y, qv[1][c], dk[r][c]);
            dk[r][c] = fmaf(dd.z, qv[2][c], dk[r][c]);
            dk[r][c] = fmaf(dd.w, qv[3][c], dk[r][c]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.st[kDK][0] + kvh * p.st[kDK][1];
  T* dvg = static_cast<T*>(p.dv) + b * p.st[kDV][0] + kvh * p.st[kDV][1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kp = kv_start + row0 + r;
    if (kp < p.Sk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < p.D) {
          store(dkg + kp * p.st[kDK][2] + d, dk[r][c] * p.scale);
          store(dvg + kp * p.st[kDV][2] + d, dv[r][c]);
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const BwdParams& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t s) {
  constexpr int TQ = kWarps * dq_rows(DP);
  const dim3 grid((p.Sq + TQ - 1) / TQ, p.H, p.B);
  return launch(flash_bwd_dq_kernel<T, DP>, dq_smem_bytes<T, DP>(), grid, p,
                s);
}

template <typename T, int DP>
cudaError_t launch_dkdv(const BwdParams& p, cudaStream_t s) {
  constexpr int TK = kWarps * dkdv_rows(DP);
  const dim3 grid((p.Sk + TK - 1) / TK, p.KVH, p.B);
  return launch(flash_bwd_dkdv_kernel<T, DP>, dkdv_smem_bytes<T, DP>(), grid,
                p, s);
}

// which: 0 = the dq kernel, 1 = the dkdv kernel; D padded to 32.
template <typename T>
cudaError_t dispatch(int which, const BwdParams& p, cudaStream_t s) {
#define FLASH_BWD_CASE(DP)                                          \
  case DP:                                                          \
    return which == 0 ? launch_dq<T, DP>(p, s) : launch_dkdv<T, DP>(p, s);
  switch ((p.D + 31) / 32 * 32) {
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(96)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(160)
    FLASH_BWD_CASE(192)
    FLASH_BWD_CASE(224)
    FLASH_BWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, void* delta, void* dq, void* dk,
        void* dv, int dtype, int B, int H, int KVH, int Sq, int Sk, int D,
        const long long* strides, int causal, int window, float softcap,
        float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 ||
      D < 8 || D > 256 || D % 4 != 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  for (int t = 0; t < kTensors; ++t)
    for (int i = 0; i < 3; ++i) p.st[t][i] = strides[3 * t + i];
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(which, p, s);
  if (dtype == 1) return dispatch<bf16>(which, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, one dtype for q, k, v, dout and the
// grads.  lse and delta: (B, H, Sq) fp32, contiguous.  strides: 21 element
// strides, (batch, head, seq) of q, k, v, dout, dq, dk, dv in that order;
// the head-dim stride of each must be 1.  scale is D ** -0.5 as the forward
// took it.  Each returns the CUDA error code of its launch (0 = launched).
// The dq kernel writes delta, which the dkdv kernel reads: launch it first,
// on the same stream.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int H, int KVH, int Sq, int Sk, int D,
    const long long* strides, int causal, int window, float softcap,
    float scale, void* stream) {
  return run(0, q, k, v, dout, lse, delta, dq, dk, dv, dtype, B, H, KVH,
             Sq, Sk, D, strides, causal, window, softcap, scale, stream);
}

extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int H, int KVH, int Sq, int Sk, int D,
    const long long* strides, int causal, int window, float softcap,
    float scale, void* stream) {
  return run(1, q, k, v, dout, lse, delta, dq, dk, dv, dtype, B, H, KVH,
             Sq, Sk, D, strides, causal, window, softcap, scale, stream);
}
