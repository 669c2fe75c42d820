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
// live key (L = -inf) gives exactly 0 and no NaN.  Any head dim from 8 to
// 256 that is a multiple of 4; q, k, v and dO read through their
// (B, H, S, D) strides.
//
// Two kernels for each dtype, each a loop inside one block of 4 warps.
// The dq kernel runs first: one block per (q tile, head, batch) walks the
// live K/V tiles twice, first for D_i of its rows (written out for the
// dkdv kernel), then for dQ.  The dkdv kernel: one block per (key tile, KV
// head, batch) walks every q head of the GQA group and every live q tile,
// so the group sums dK and dV in registers: no atomics, no second pass.
//
// bf16: flash_bwd_dq_kernel_mma and flash_bwd_dkdv_kernel_mma, on
// mma.sync.m16n8k16 tensor cores (bf16 in, fp32 accumulate).  Each warp
// owns 16 rows of the block's 64 (q rows; keys in the dkdv kernel).  The
// tiles are staged as bf16 in shared memory by cp.async (16 B copies, 8 B
// at D 100; the same rule as the forward), rows padded by 16 B so that the
// 8 rows an ldmatrix reads fall in 8 bank groups, D padded with zeros to a
// multiple of 16; the next tile loads while this one is multiplied.
//   dq: S = Q K^T and dP = dO V^T take K and V as B through plain
//   ldmatrix (Q and dO as A fragments, held in registers up to D 64); P and
//   D_i (pass 0) or dS (pass 1) are formed on the accumulators, and dS's
//   accumulator layout is the A layout of dQ += dS K (K by ldmatrix.trans).
//   dkdv: S^T = K Q^T and dP^T = V dO^T (K and V held as A fragments up
//   to D 64); dV += P^T dO and dK += dS^T Q take dO and Q by
//   ldmatrix.trans.  Above D 128 the dK and dV columns are split into two
//   halves, one block each, each recomputing S^T and dP^T: the
//   accumulators (16 x D a warp, each) would not fit in registers.
// P and dS enter the products as hi = bf16(x) and lo = bf16(x - hi), both
// multiplied (exact to ~2^-17, as the plain version's fp32): without the
// lo planes the forward's P V missed the bf16 tolerance by 2.3x
// (flash_attention.cu).  So dQ, dK and dV each cost two products.
//
// fp32: flash_bwd_dq_kernel and flash_bwd_dkdv_kernel, scalar fp32 FMAs
// (TF32 cannot meet fp32's 2e-5).  Lane j owns key j (dq) or query j
// (dkdv) of a tile of 32 for S and dP, and output dims lane + 32 c for
// the products; D padded to a multiple of 32.
//
// What bounds it.  At the gpt-1.3b training shape (B 8, H 32, S 512, D 64,
// causal, bf16) the function reads q, k, v, dO (bf16) and L (fp32) and
// writes dq, dk, dv (bf16): ~118 MB, 35 us at 3.35 TB/s.  Its products
// (dP = dO V^T, dQ, dK, dV, and S once) are 10 D FLOP per live (q, k)
// pair: ~22 GFLOP, 22 us at 989 TFLOP/s of bf16 tensor cores, so bytes
// bound the function.  The bf16 kernels run 24 D FLOP a pair on the
// tensor cores (S and dP three times, dQ, dK and dV twice each for hi and
// lo): ~52 GFLOP over the live pairs, more on the diagonal tiles, and
// mma.sync reaches a fraction of the card's 989 TFLOP/s (the wgmma rate),
// so the products bound them; the fp32 kernels run 18 D FLOP a pair on
// the fp32 pipe (67 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

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
  int vec;  // bf16: elements a copy of q, k, v, dO, 8 (16 B) or 4 (8 B)
};

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

// ---------------------------------------------------------------------------
// fp32: scalar FMA kernels
// ---------------------------------------------------------------------------

constexpr int kCols = 32;  // keys (dq) or queries (dkdv) of an inner tile
// rows a warp owns: q rows (dq kernel) or keys (dkdv kernel); fewer at the
// large head dims, where the accumulators (rows x D / 32 a lane) grow
__host__ __device__ constexpr int dq_rows(int dp) {
  return dp <= 128 ? 16 : 8;
}
__host__ __device__ constexpr int dkdv_rows(int dp) {
  return dp <= 64 ? 16 : 8;
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
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long ss,
                                          int s0, int S, int D, int nrows) {
  for (int i = threadIdx.x; i < nrows * DP; i += kThreads) {
    const int r = i / DP, d = i - (i / DP) * DP, s = s0 + r;
    dst[r * ld + d] = s < S && d < D ? src[s * ss + d] : 0.f;
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  constexpr int TQ = kWarps * dq_rows(DP);
  // q, dO [TQ][DP]; k, v [32][DP + 4]; dS [4][rows][32]; L, D [TQ]
  return sizeof(float) * (2 * TQ * DP + 2 * kCols * (DP + 4) +
                          TQ * kCols + 2 * TQ);
}

template <int DP>
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

  const float* qg =
      static_cast<const float*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][1];
  const float* kg =
      static_cast<const float*>(p.k) + b * p.st[kK][0] + kvh * p.st[kK][1];
  const float* vg =
      static_cast<const float*>(p.v) + b * p.st[kV][0] + kvh * p.st[kV][1];
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.st[kDO][0] + h * p.st[kDO][1];
  float* dqg = static_cast<float*>(p.dq) + b * p.st[kDQ][0] + h * p.st[kDQ][1];
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_rows<DP>(q_s, DP, qg, p.st[kQ][2], q_start, p.Sq, p.D, TQ);
  load_rows<DP>(do_s, DP, dog, p.st[kDO][2], q_start, p.Sq, p.D, TQ);
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
      load_rows<DP>(k_s, KS, kg, p.st[kK][2], kv_start, p.Sk, p.D, kCols);
      load_rows<DP>(v_s, KS, vg, p.st[kV][2], kv_start, p.Sk, p.D, kCols);
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
          dqg[qp * p.st[kDQ][2] + lane + 32 * c] = acc[r][c] * p.scale;
    }
  }
}

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  constexpr int TK = kWarps * dkdv_rows(DP);
  // k, v [TK][DP]; q, dO [32][DP + 4]; P, dS [4][rows][32]; L, D [32]
  return sizeof(float) * (2 * TK * DP + 2 * kCols * (DP + 4) +
                          2 * TK * kCols + 2 * kCols);
}

template <int DP>
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

  const float* kg =
      static_cast<const float*>(p.k) + b * p.st[kK][0] + kvh * p.st[kK][1];
  const float* vg =
      static_cast<const float*>(p.v) + b * p.st[kV][0] + kvh * p.st[kV][1];
  load_rows<DP>(k_s, DP, kg, p.st[kK][2], kv_start, p.Sk, p.D, TK);
  load_rows<DP>(v_s, DP, vg, p.st[kV][2], kv_start, p.Sk, p.D, TK);

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
    const float* qg =
        static_cast<const float*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][1];
    const float* dog =
        static_cast<const float*>(p.dout) + b * p.st[kDO][0] + h * p.st[kDO][1];
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q_start = t * kCols;
      __syncthreads();  // every warp is done with the previous q tile
      load_rows<DP>(q_s, KS, qg, p.st[kQ][2], q_start, p.Sq, p.D, kCols);
      load_rows<DP>(do_s, KS, dog, p.st[kDO][2], q_start, p.Sq, p.D,
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

  float* dkg =
      static_cast<float*>(p.dk) + b * p.st[kDK][0] + kvh * p.st[kDK][1];
  float* dvg =
      static_cast<float*>(p.dv) + b * p.st[kDV][0] + kvh * p.st[kDV][1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kp = kv_start + row0 + r;
    if (kp < p.Sk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < p.D) {
          dkg[kp * p.st[kDK][2] + d] = dk[r][c] * p.scale;
          dvg[kp * p.st[kDV][2] + d] = dv[r][c];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Copy BYTES (16, 8 or 4) from global to shared memory, or zeros if !in.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool in) {
  const int n = in ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %3, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) = hi + lo to ~2^-17: hi = bf16(u, v), lo = bf16((u, v) - hi).
__device__ __forceinline__ void split(float u, float v, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

// The A fragments (hi, lo) of 16 columns of a 16-row accumulator: its two
// 8-column tiles c0, c1 (the m16n8 accumulator layout is the A layout).
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// 2^x, flushing results below 2^-126 to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows r0 .. r0 + ROWS - 1 of an (S, D) bf16 matrix (row stride ss), COLS
// columns, into shared rows of ld elements; rows past S and columns past D
// are zeros.  VEC elements a cp.async; neighbouring threads take
// neighbouring copies of a row.
template <int ROWS, int COLS, int VEC>
__device__ __forceinline__ void stage_vec(bf16* dst, int ld, const bf16* src,
                                          long long ss, int r0, int S,
                                          int D) {
  constexpr int kPerRow = COLS / VEC;
  if constexpr (kThreads % kPerRow == 0) {
    // a thread's column is the same in every row it copies
    constexpr int kStep = kThreads / kPerRow;
    const int j = threadIdx.x / kPerRow, col = (threadIdx.x % kPerRow) * VEC;
    const bf16* from = src + (r0 + j) * ss + col;
    const uint32_t to = smem_u32(dst + j * ld + col);
#pragma unroll
    for (int n = 0; n < (ROWS + kStep - 1) / kStep; ++n) {
      if (ROWS % kStep == 0 || j + n * kStep < ROWS) {
        const bool in = col < D && r0 + j + n * kStep < S;
        cp_async<2 * VEC>(to + 2 * n * kStep * ld,
                          in ? from + n * kStep * ss : src, in);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
      const int j = i / kPerRow, col = (i % kPerRow) * VEC, s = r0 + j;
      const bool in = s < S && col < D;
      cp_async<2 * VEC>(smem_u32(dst + j * ld + col),
                        in ? src + s * ss + col : src, in);
    }
  }
}

template <int ROWS, int COLS>
__device__ __forceinline__ void stage(int vec, bf16* dst, int ld,
                                      const bf16* src, long long ss, int r0,
                                      int S, int D) {
  if (vec == 8)
    stage_vec<ROWS, COLS, 8>(dst, ld, src, ss, r0, S, D);
  else
    stage_vec<ROWS, COLS, 4>(dst, ld, src, ss, r0, S, D);
}

// ROWS fp32 values from r0 on (zeros past S), 4 B copies.
template <int ROWS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int r0, int S) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool in = r0 + i < S;
    cp_async<4>(smem_u32(dst + i), in ? src + r0 + i : src, in);
  }
}

__device__ __forceinline__ void store2(bf16* dst, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(u, v);
}

// Every (q, k) pair of q rows [q0, q0 + nq) and keys [k0, k0 + nk) live:
// the tile needs no mask.
__device__ __forceinline__ bool all_live(const BwdParams& p, int q0, int nq,
                                         int k0, int nk) {
  bool in = q0 + nq <= p.Sq && k0 + nk <= p.Sk;
  if (p.causal) in = in && k0 + nk - 1 <= q0;
  if (p.window > 0) in = in && q0 + nq - 1 - k0 < p.window;
  return in;
}

// P = exp(x - L) of a pair from its score s, 0 where kMask and the
// pair's column c is outside its row's live range [lo, hi); lse2 is
// L log2(e).  dcap: the softcap's derivative.  kCap and kMask are uniform
// over a tile, so the tanh and the mask cost nothing where they are not
// needed.
template <bool kCap, bool kMask>
__device__ __forceinline__ float prob(const BwdParams& p, float s,
                                      float lse2, int c, int lo, int hi,
                                      float& dcap) {
  float pr;
  if constexpr (kCap) {
    const float t = tanhf(s * (p.scale / p.softcap));
    dcap = 1.f - t * t;
    pr = exp2_ftz(fmaf(p.softcap * kLog2e, t, -lse2));
  } else {
    dcap = 1.f;
    pr = exp2_ftz(fmaf(s, p.scale * kLog2e, -lse2));
  }
  if constexpr (kMask) {
    if (c < lo || c >= hi) pr = 0.f;
  }
  return pr;
}

// The live keys [lo, hi) of query qp: those live() keeps.
__device__ __forceinline__ int2 live_keys(const BwdParams& p, int qp) {
  const int lo = p.window > 0 ? qp - p.window + 1 : 0;
  const int hi = qp >= p.Sq ? 0 : p.causal ? min(p.Sk, qp + 1) : p.Sk;
  return make_int2(lo, hi);
}

// The live queries [lo, hi) of key kp: those live() keeps.
__device__ __forceinline__ int2 live_queries(const BwdParams& p, int kp) {
  const int lo = p.causal ? kp : 0;
  const int hi = kp >= p.Sk ? 0 : p.window > 0 ? min(p.Sq, kp + p.window)
                                               : p.Sq;
  return make_int2(lo, hi);
}

template <bool kCap_, bool kMask_>
struct Flags {
  static constexpr bool kCap = kCap_, kMask = kMask_;
};

// f(Flags<cap, mask>()): the tile's softcap and mask as compile-time flags.
template <typename F>
__device__ __forceinline__ void with_flags(bool cap, bool mask, F&& f) {
  if (cap) {
    if (mask)
      f(Flags<true, true>());
    else
      f(Flags<true, false>());
  } else {
    if (mask)
      f(Flags<false, true>());
    else
      f(Flags<false, false>());
  }
}

// Stages of the tile rings: the next tile loads while this one is used,
// one barrier a tile.
constexpr int kStages = 2;

// Blocks an SM: three at D <= 64 (168 registers a thread), where the
// training shapes are.
__host__ __device__ constexpr int min_blocks(int dp) {
  return dp <= 64 ? 3 : dp <= 128 ? 2 : 1;
}

// The dq kernel's shapes.  Q and dO of the block's 64 rows stay in shared
// memory (and in registers up to D 64); K and V tiles of kTile keys in a
// ring of kStages; a warp forms S and dP kSub keys at a time (fewer at
// large D, where the dQ accumulator, 16 x D a warp, takes the registers).
template <int DP>
struct DqMma {
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kTile = DP <= 128 ? 64 : 32;
  static constexpr int kSub = DP <= 64 ? 64 : DP <= 128 ? 32 : 16;
  static constexpr bool kHold = DP <= 64;
  static constexpr int kLd = DP + 8;
  static constexpr size_t kSmem =
      2 * (2 * kRows * kLd + 2 * kStages * kTile * kLd);
};

template <int DP>
__global__ void __launch_bounds__(kThreads, min_blocks(DP))
    flash_bwd_dq_kernel_mma(const __grid_constant__ BwdParams p) {
  using C = DqMma<DP>;
  constexpr int LD = C::kLd, TK = C::kTile, SUB = C::kSub;
  constexpr int KS = DP / 16;  // k-steps over D
  constexpr int NT = DP / 8;   // 8-column tiles of dQ
  constexpr int NS = SUB / 8;  // 8-key tiles of S in a sub-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* do_s = q_s + C::kRows * LD;              // [kRows][LD]
  bf16* kv_s = do_s + C::kRows * LD;             // [kStages][K, V][TK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // ldmatrix lane roles: the lane's row within an 8 x 8 matrix, and which
  // of the four matrices of an x4 it addresses
  const int lr = lane & 7, m_lo = (lane >> 3) & 1, m_hi = lane >> 4;
  const int q_start = qt * C::kRows;
  const int row0 = 16 * warp;
  const int qr0 = q_start + row0 + g, qr1 = qr0 + 8;  // this lane's rows

  const bf16* qg =
      static_cast<const bf16*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][1];
  const bf16* kg =
      static_cast<const bf16*>(p.k) + b * p.st[kK][0] + kvh * p.st[kK][1];
  const bf16* vg =
      static_cast<const bf16*>(p.v) + b * p.st[kV][0] + kvh * p.st[kV][1];
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + b * p.st[kDO][0] + h * p.st[kDO][1];
  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.st[kDQ][0] + h * p.st[kDQ][1];
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
  // L log2(e) and the live keys of this lane's rows
  const float lse0 = qr0 < p.Sq ? p.lse[row_base + qr0] * kLog2e : 0.f;
  const float lse1 = qr1 < p.Sq ? p.lse[row_base + qr1] * kLog2e : 0.f;
  const int2 keys0 = live_keys(p, qr0), keys1 = live_keys(p, qr1);

  // live K/V tiles: those the forward kernels keep for this q tile
  const int q_last = min(q_start + C::kRows, p.Sq) - 1;
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  const int kv_lo = p.window > 0 ? max(0, q_start - p.window + 1) : 0;
  const int t_lo = kv_lo / TK;
  const int n_t = max(0, (kv_hi + TK - 1) / TK - t_lo);

  // iteration it walks tile t_lo + it % n_t (pass it / n_t) in stage
  // it % ST
  constexpr int ST = kStages;
  const int n_it = 2 * n_t;
  auto issue = [&](int it) {
    const int kv0 = (t_lo + it % n_t) * TK;
    bf16* dst = kv_s + (it % ST) * 2 * TK * LD;
    stage<TK, DP>(p.vec, dst, LD, kg, p.st[kK][2], kv0, p.Sk, p.D);
    stage<TK, DP>(p.vec, dst + TK * LD, LD, vg, p.st[kV][2], kv0, p.Sk, p.D);
  };
  if (n_t > 0) {
    stage<C::kRows, DP>(p.vec, q_s, LD, qg, p.st[kQ][2], q_start, p.Sq, p.D);
    stage<C::kRows, DP>(p.vec, do_s, LD, dog, p.st[kDO][2], q_start, p.Sq,
                        p.D);
  }
#pragma unroll
  for (int it = 0; it < ST - 1; ++it) {
    if (it < n_it) issue(it);
    cp_async_commit();
  }

  uint32_t qf[C::kHold ? KS : 1][4], of[C::kHold ? KS : 1][4];
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float di[2] = {0.f, 0.f};  // D_i of rows qr0, qr1: pass 0 sums it

#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    for (int tt = 0; tt < n_t; ++tt) {
      const int it = pass * n_t + tt;
      cp_async_wait<ST - 2>();
      __syncthreads();  // tile it landed; every warp is done with it - 1
      if (it + ST - 1 < n_it) issue(it + ST - 1);
      cp_async_commit();
      if constexpr (C::kHold) {
        if (it == 0) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const int at = (row0 + lr + 8 * m_lo) * LD + 16 * ks + 8 * m_hi;
            ldsm_x4(qf[ks], smem_u32(q_s + at));
            ldsm_x4(of[ks], smem_u32(do_s + at));
          }
        }
      }
      const int kv0 = (t_lo + tt) * TK;
      const bf16* k_t = kv_s + (it % ST) * 2 * TK * LD;
      const bf16* v_t = k_t + TK * LD;
      const bool mask = !all_live(p, q_start + row0, 16, kv0, TK);
#pragma unroll
      for (int j0 = 0; j0 < TK; j0 += SUB) {
        // S = Q K^T and dP = dO V^T on keys kv0 + j0 ..
        float s[NS][4], dp[NS][4];
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t aq[4], ao[4];
          if constexpr (C::kHold) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              aq[e] = qf[ks][e];
              ao[e] = of[ks][e];
            }
          } else {
            const int at = (row0 + lr + 8 * m_lo) * LD + 16 * ks + 8 * m_hi;
            ldsm_x4(aq, smem_u32(q_s + at));
            ldsm_x4(ao, smem_u32(do_s + at));
          }
#pragma unroll
          for (int n2 = 0; n2 < NS / 2; ++n2) {
            const int at = (j0 + 16 * n2 + 8 * m_hi + lr) * LD + 16 * ks +
                           8 * m_lo;
            uint32_t kb[4], vb[4];
            ldsm_x4(kb, smem_u32(k_t + at));
            ldsm_x4(vb, smem_u32(v_t + at));
            mma(s[2 * n2], aq, kb[0], kb[1]);
            mma(s[2 * n2 + 1], aq, kb[2], kb[3]);
            mma(dp[2 * n2], ao, vb[0], vb[1]);
            mma(dp[2 * n2 + 1], ao, vb[2], vb[3]);
          }
        }
        // pass 0: D_i += P dP; pass 1: dS in place of S
        with_flags(p.softcap > 0.f, mask, [&](auto flags) {
          using F = decltype(flags);
#pragma unroll
          for (int nt = 0; nt < NS; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e / 2;
              float dcap;
              const int2 keys = r ? keys1 : keys0;
              const float pr = prob<F::kCap, F::kMask>(
                  p, s[nt][e], r ? lse1 : lse0,
                  kv0 + j0 + 8 * nt + 2 * t + (e & 1), keys.x, keys.y,
                  dcap);
              if (pass == 0)
                di[r] = fmaf(pr, dp[nt][e], di[r]);
              else
                s[nt][e] = pr * (dp[nt][e] - di[r]) * dcap;
            }
        });
        if (pass == 1) {
          // dQ += dS K: dS's accumulators as A (hi, lo), K by ldmatrix.trans
#pragma unroll
          for (int kk = 0; kk < NS / 2; ++kk) {
            uint32_t hi[4], lo[4];
            split_frag(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              const int at =
                  (j0 + 16 * kk + lr + 8 * m_lo) * LD + 16 * np + 8 * m_hi;
              uint32_t kb[4];
              ldsm_x4_t(kb, smem_u32(k_t + at));
              mma(acc[2 * np], hi, kb[0], kb[1]);
              mma(acc[2 * np + 1], hi, kb[2], kb[3]);
              mma(acc[2 * np], lo, kb[0], kb[1]);
              mma(acc[2 * np + 1], lo, kb[2], kb[3]);
            }
          }
        }
      }
    }
    if (pass == 0) {
      // D_i: the sum over the quad that shares a row; written for the dkdv
      // kernel
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        di[r] += __shfl_xor_sync(0xffffffffu, di[r], 1);
        di[r] += __shfl_xor_sync(0xffffffffu, di[r], 2);
      }
      if (t == 0) {
        if (qr0 < p.Sq) p.delta[row_base + qr0] = di[0];
        if (qr1 < p.Sq) p.delta[row_base + qr1] = di[1];
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = 8 * nt + 2 * t;
    if (col < p.D) {
      if (qr0 < p.Sq)
        store2(dqg + qr0 * p.st[kDQ][2] + col, acc[nt][0] * p.scale,
               acc[nt][1] * p.scale);
      if (qr1 < p.Sq)
        store2(dqg + qr1 * p.st[kDQ][2] + col, acc[nt][2] * p.scale,
               acc[nt][3] * p.scale);
    }
  }
}

// The dkdv kernel's shapes.  K and V of the block's 64 keys stay in shared
// memory (and in registers up to D 64); Q and dO tiles of kTile queries,
// with their L and D, in a ring of kStages; a warp forms S^T and dP^T kSub
// queries at a time.  Above D 128 a block takes kCols of the dK and dV
// columns (kChunks blocks a key tile), so that its accumulators fit.
template <int DP>
struct DkdvMma {
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kTile = DP <= 128 ? 64 : 32;
  static constexpr int kChunks = (DP + 127) / 128;
  static constexpr int kCols = (DP / kChunks + 15) / 16 * 16;
  static constexpr int kWidth = kChunks * kCols;  // staged Q, dO columns
  static constexpr int kSub = kCols <= 64 ? 32 : 16;
  static constexpr bool kHold = DP <= 64;
  static constexpr int kLdK = DP + 8, kLdQ = kWidth + 8;
  static constexpr size_t kSmem =
      2 * (2 * kRows * kLdK + 2 * kStages * kTile * kLdQ) +
      4 * 2 * kStages * kTile;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, min_blocks(DP))
    flash_bwd_dkdv_kernel_mma(const __grid_constant__ BwdParams p) {
  using C = DkdvMma<DP>;
  constexpr int LDK = C::kLdK, LDQ = C::kLdQ, TQ = C::kTile, SUB = C::kSub;
  constexpr int KS = DP / 16;         // k-steps over D
  constexpr int NT = C::kCols / 8;    // 8-column tiles of dK, dV
  constexpr int NS = SUB / 8;         // 8-query tiles of S^T in a sub-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LDK]
  bf16* v_s = k_s + C::kRows * LDK;              // [kRows][LDK]
  constexpr int ST = kStages;
  bf16* qo_s = v_s + C::kRows * LDK;             // [ST][Q, dO][TQ][LDQ]
  float* ld_s =
      reinterpret_cast<float*>(qo_s + 2 * ST * TQ * LDQ);  // [ST][L, D][TQ]

  // the first key tiles see the most queries under the causal mask, and
  // blocks are issued in index order: they go first
  const int kt = blockIdx.x;
  const int kvh = blockIdx.y / C::kChunks;
  const int c0 = (blockIdx.y % C::kChunks) * C::kCols;  // first dK/dV column
  const int b = blockIdx.z;
  const int rep = p.H / p.KVH;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int lr = lane & 7, m_lo = (lane >> 3) & 1, m_hi = lane >> 4;
  const int kv_start = kt * C::kRows;
  const int kv_last = min(kv_start + C::kRows, p.Sk) - 1;
  const int row0 = 16 * warp;
  const int key0 = kv_start + row0 + g, key1 = key0 + 8;  // this lane's keys
  const int2 qs0 = live_queries(p, key0), qs1 = live_queries(p, key1);

  const bf16* kg =
      static_cast<const bf16*>(p.k) + b * p.st[kK][0] + kvh * p.st[kK][1];
  const bf16* vg =
      static_cast<const bf16*>(p.v) + b * p.st[kV][0] + kvh * p.st[kV][1];

  // live q tiles for these keys
  const int q_lo = p.causal ? kv_start : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, kv_last + p.window);
  const int t_lo = q_lo / TQ;
  const int n_t = max(0, (q_hi + TQ - 1) / TQ - t_lo);
  const int n_it = rep * n_t;

  // iteration i walks q head kvh rep + i / n_t, q tile t_lo + i % n_t
  auto issue = [&](int i) {
    const int h = kvh * rep + i / n_t;
    const int q0 = (t_lo + i % n_t) * TQ;
    const bf16* qg =
        static_cast<const bf16*>(p.q) + b * p.st[kQ][0] + h * p.st[kQ][1];
    const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.st[kDO][0] +
                      h * p.st[kDO][1];
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
    bf16* dst = qo_s + (i % ST) * 2 * TQ * LDQ;
    float* ldst = ld_s + (i % ST) * 2 * TQ;
    stage<TQ, C::kWidth>(p.vec, dst, LDQ, qg, p.st[kQ][2], q0, p.Sq, p.D);
    stage<TQ, C::kWidth>(p.vec, dst + TQ * LDQ, LDQ, dog, p.st[kDO][2], q0,
                         p.Sq, p.D);
    stage_f32<TQ>(ldst, p.lse + row_base, q0, p.Sq);
    stage_f32<TQ>(ldst + TQ, p.delta + row_base, q0, p.Sq);
  };
  if (n_it > 0) {
    stage<C::kRows, DP>(p.vec, k_s, LDK, kg, p.st[kK][2], kv_start, p.Sk,
                        p.D);
    stage<C::kRows, DP>(p.vec, v_s, LDK, vg, p.st[kV][2], kv_start, p.Sk,
                        p.D);
  }
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_it) issue(i);
    cp_async_commit();
  }

  uint32_t kf[C::kHold ? KS : 1][4], vf[C::kHold ? KS : 1][4];
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile i landed; every warp is done with i - 1
    if (i + ST - 1 < n_it) issue(i + ST - 1);
    cp_async_commit();
    if constexpr (C::kHold) {
      if (i == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int at = (row0 + lr + 8 * m_lo) * LDK + 16 * ks + 8 * m_hi;
          ldsm_x4(kf[ks], smem_u32(k_s + at));
          ldsm_x4(vf[ks], smem_u32(v_s + at));
        }
      }
    }
    const int q0 = (t_lo + i % n_t) * TQ;
    const bf16* q_t = qo_s + (i % ST) * 2 * TQ * LDQ;
    const bf16* o_t = q_t + TQ * LDQ;
    const float* l_t = ld_s + (i % ST) * 2 * TQ;
    const float* d_t = l_t + TQ;
    const bool mask = !all_live(p, q0, TQ, kv_start + row0, 16);
#pragma unroll
    for (int j0 = 0; j0 < TQ; j0 += SUB) {
      // S^T = K Q^T and dP^T = V dO^T on queries q0 + j0 ..
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ak[4], av[4];
        if constexpr (C::kHold) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ak[e] = kf[ks][e];
            av[e] = vf[ks][e];
          }
        } else {
          const int at = (row0 + lr + 8 * m_lo) * LDK + 16 * ks + 8 * m_hi;
          ldsm_x4(ak, smem_u32(k_s + at));
          ldsm_x4(av, smem_u32(v_s + at));
        }
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          const int at =
              (j0 + 16 * n2 + 8 * m_hi + lr) * LDQ + 16 * ks + 8 * m_lo;
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, smem_u32(q_t + at));
          ldsm_x4(ob, smem_u32(o_t + at));
          mma(s[2 * n2], ak, qb[0], qb[1]);
          mma(s[2 * n2 + 1], ak, qb[2], qb[3]);
          mma(dp[2 * n2], av, ob[0], ob[1]);
          mma(dp[2 * n2 + 1], av, ob[2], ob[3]);
        }
      }
      // P^T in place of S^T, dS^T in place of dP^T
      with_flags(p.softcap > 0.f, mask, [&](auto flags) {
        using F = decltype(flags);
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          const int ql = j0 + 8 * nt + 2 * t;  // this lane's queries: ql, +1
          const float2 lse = *reinterpret_cast<const float2*>(l_t + ql);
          const float2 dd = *reinterpret_cast<const float2*>(d_t + ql);
          const float lse2[2] = {lse.x * kLog2e, lse.y * kLog2e};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float dcap;
            const int2 qs = e < 2 ? qs0 : qs1;
            const float pr = prob<F::kCap, F::kMask>(
                p, s[nt][e], lse2[e & 1], q0 + ql + (e & 1), qs.x, qs.y,
                dcap);
            s[nt][e] = pr;
            dp[nt][e] = pr * (dp[nt][e] - (e & 1 ? dd.y : dd.x)) * dcap;
          }
        }
      });
      // dV += P^T dO and dK += dS^T Q on this chunk's columns: P^T and
      // dS^T as A (hi, lo), dO and Q by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        split_frag(s[2 * kk], s[2 * kk + 1], ph, pl);
        split_frag(dp[2 * kk], dp[2 * kk + 1], dh, dl);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int at = (j0 + 16 * kk + lr + 8 * m_lo) * LDQ + c0 +
                         16 * np + 8 * m_hi;
          uint32_t ob[4], qb[4];
          ldsm_x4_t(ob, smem_u32(o_t + at));
          ldsm_x4_t(qb, smem_u32(q_t + at));
          mma(dv[2 * np], ph, ob[0], ob[1]);
          mma(dv[2 * np + 1], ph, ob[2], ob[3]);
          mma(dk[2 * np], dh, qb[0], qb[1]);
          mma(dk[2 * np + 1], dh, qb[2], qb[3]);
          mma(dv[2 * np], pl, ob[0], ob[1]);
          mma(dv[2 * np + 1], pl, ob[2], ob[3]);
          mma(dk[2 * np], dl, qb[0], qb[1]);
          mma(dk[2 * np + 1], dl, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.st[kDK][0] + kvh * p.st[kDK][1];
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.st[kDV][0] + kvh * p.st[kDV][1];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = c0 + 8 * nt + 2 * t;
    if (col < p.D) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = r ? key1 : key0;
        if (kp < p.Sk) {
          store2(dkg + kp * p.st[kDK][2] + col, dk[nt][2 * r] * p.scale,
                 dk[nt][2 * r + 1] * p.scale);
          store2(dvg + kp * p.st[kDV][2] + col, dv[nt][2 * r],
                 dv[nt][2 * r + 1]);
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

// which: 0 = the dq kernel, 1 = the dkdv kernel.

template <int DP>
cudaError_t launch_fma(int which, const BwdParams& p, cudaStream_t s) {
  if (which == 0) {
    constexpr int TQ = kWarps * dq_rows(DP);
    return launch(flash_bwd_dq_kernel<DP>, dq_smem_bytes<DP>(),
                  dim3((p.Sq + TQ - 1) / TQ, p.H, p.B), p, s);
  }
  constexpr int TK = kWarps * dkdv_rows(DP);
  return launch(flash_bwd_dkdv_kernel<DP>, dkdv_smem_bytes<DP>(),
                dim3((p.Sk + TK - 1) / TK, p.KVH, p.B), p, s);
}

template <int DP>
cudaError_t launch_mma(int which, const BwdParams& p, cudaStream_t s) {
  if (which == 0) {
    using C = DqMma<DP>;
    return launch(flash_bwd_dq_kernel_mma<DP>, C::kSmem,
                  dim3((p.Sq + C::kRows - 1) / C::kRows, p.H, p.B), p, s);
  }
  using C = DkdvMma<DP>;
  if (p.KVH > 65535 / C::kChunks) return cudaErrorInvalidValue;
  return launch(flash_bwd_dkdv_kernel_mma<DP>, C::kSmem,
                dim3((p.Sk + C::kRows - 1) / C::kRows, p.KVH * C::kChunks,
                     p.B),
                p, s);
}

// fp32: D padded to a multiple of 32.
cudaError_t dispatch_fma(int which, const BwdParams& p, cudaStream_t s) {
  switch ((p.D + 31) / 32 * 32) {
    case 32: return launch_fma<32>(which, p, s);
    case 64: return launch_fma<64>(which, p, s);
    case 96: return launch_fma<96>(which, p, s);
    case 128: return launch_fma<128>(which, p, s);
    case 160: return launch_fma<160>(which, p, s);
    case 192: return launch_fma<192>(which, p, s);
    case 224: return launch_fma<224>(which, p, s);
    case 256: return launch_fma<256>(which, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: D padded to a multiple of 16.
cudaError_t dispatch_mma(int which, const BwdParams& p, cudaStream_t s) {
  switch ((p.D + 15) / 16 * 16) {
    case 16: return launch_mma<16>(which, p, s);
    case 32: return launch_mma<32>(which, p, s);
    case 48: return launch_mma<48>(which, p, s);
    case 64: return launch_mma<64>(which, p, s);
    case 80: return launch_mma<80>(which, p, s);
    case 96: return launch_mma<96>(which, p, s);
    case 112: return launch_mma<112>(which, p, s);
    case 128: return launch_mma<128>(which, p, s);
    case 144: return launch_mma<144>(which, p, s);
    case 160: return launch_mma<160>(which, p, s);
    case 176: return launch_mma<176>(which, p, s);
    case 192: return launch_mma<192>(which, p, s);
    case 208: return launch_mma<208>(which, p, s);
    case 224: return launch_mma<224>(which, p, s);
    case 240: return launch_mma<240>(which, p, s);
    case 256: return launch_mma<256>(which, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// Elements a copy of q, k, v and dO for the bf16 kernels: 8 (16 B) where
// D, their pointers and B/H/S strides allow it, else 4 (8 B), else 0 (not
// taken); the grads, stored in pairs, need 2.  The rule of the forward's
// wrapper (ops.py::_copy_width).
int copy_width(const BwdParams& p) {
  const void* ptrs[kTensors] = {p.q, p.k, p.v, p.dout, p.dq, p.dk, p.dv};
  long long in = p.D, out = 0;
  for (int t = 0; t < kTensors; ++t) {
    long long& bits = t < kDQ ? in : out;
    bits |= static_cast<long long>(reinterpret_cast<uintptr_t>(ptrs[t]) /
                                   sizeof(bf16));
    for (int i = 0; i < 3; ++i) bits |= p.st[t][i];
  }
  if (out % 2 != 0) return 0;
  return in % 8 == 0 ? 8 : in % 4 == 0 ? 4 : 0;
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
  p.vec = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fma(which, p, s);
  if (dtype == 1) {
    p.vec = copy_width(p);
    if (p.vec == 0) return cudaErrorInvalidValue;
    return dispatch_mma(which, p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (the scalar kernels), 1 = bfloat16 (the tensor-core
// kernels), one dtype for q, k, v, dout and the grads.  lse and delta:
// (B, H, Sq) fp32, contiguous.  strides: 21 element strides, (batch, head,
// seq) of q, k, v, dout, dq, dk, dv in that order; the head-dim stride of
// each must be 1; in bf16, D, the pointers and the strides of q, k, v and
// dout must be multiples of 4 elements, those of the grads of 2.  scale is
// D ** -0.5 as the forward took it.  Each returns the CUDA error code of
// its launch (0 = launched).  The dq kernel writes delta, which the dkdv
// kernel reads: launch it first, on the same stream.
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
