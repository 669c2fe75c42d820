// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), built by
// kernels/build.py into a shared library with a plain C interface and
// called through ctypes from kernels/ssd_scan/ops.py (SSDScan.backward).
//
// Differentiates the function of the TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:72 ssd_scan_kernel
// (and of this port's forward, csrc/ssd_scan.cu).  The JAX package has no
// backward kernel: its training path takes the gradient by autodiff
// through src/repro/models/layers/ssd.py::ssd_chunked.  This kernel
// computes that gradient in the same chunked form.  Per head, with the
// forward h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t, y_t = h_t C_t, it
// takes dy (the cotangent of y) and dh_T (of the final state, or zero) and
// writes dx, d dt, and per-block partials of da, dB and dC (B and C are
// shared by all heads, a by all batch rows: the wrapper sums the partials
// in a fixed order, so no float atomics are used and runs repeat bit for
// bit), and dh0 when an initial state was given.
//
// Per (head, batch) one block of 256 threads makes two passes over chunks
// of Q = 64 positions:
//   pass 1, in order: the state at the start of each chunk, h <- exp(la_Q) h
//     + (x dt o exp(la_Q - la))^T B as the forward's FMA kernel does, each
//     chunk's start state written to a scratch (B, H, ceil(L/64), P, N)
//     fp32 that the wrapper allocates;
//   pass 2, in reverse: with la = cumsum(dt a) within the chunk,
//     E_ij = causal exp(la_i - la_j), M = (C B^T) o E, u = x dt,
//     el = exp(la), w = exp(la_Q - la), h_prev from the scratch and the
//     adjoint state g (P x N fp32, carried in shared memory from dh_T):
//       dM = causal (dy u^T), dS = dM o E, G = dM o M
//       du = M^T dy + w o (B g^T)        -> dx = dt du, d dt += x . du
//       dC = dS B + el o (dy h_prev)
//       dB = dS^T C + (w dt) o (x g)
//       d la_i = rowsum(G)_i - colsum(G)_i + el_i C_i . (dy h_prev)_i
//                - w_i dw_i, with dw_i = dt_i x_i . (B g^T)_i, and at the
//                chunk's last row also el_Q <h_prev, g> + sum_j w_j dw_j
//       g <- el_Q g + (el o dy)^T C
//     then d l = reverse cumsum of d la within the chunk (l = dt a):
//     d dt += a d l and da += sum dt d l.
// The exponent is masked before exp (exp of a positive gap above the
// diagonal would overflow, and inf * 0 is NaN).  Positions past L are
// staged as zeros with dt = 0 (so la stays flat and they carry nothing)
// and get no output.
//
// What bounds it.  At the training shape of the largest rank call of
// mamba2-370m's Cluster A plan (B 10, H 32, L 2048, P 64, N 128, bf16) the
// function moves ~270 MB (x, dt, B, C, dy read once; dx, d dt, da, dB, dC
// written once): 81 us at 3.35 TB/s; the chunked form's products (C B^T,
// dy u^T, M^T dy, dS B, dS^T C over causal pairs; B g^T, dy h_prev, x g,
// the adjoint and the state update over Q x P x N) are ~75 GFLOP, 76 us at
// 989 TFLOP/s of bf16 tensor cores.  This first kernel does every product
// as a scalar fp32 FMA on fp32 operands staged in shared memory (bf16
// inputs are widened when staged), so it runs far from that bound: the
// fp32 pipe's peak is 67 TFLOP/s, and one 206 KB block fits an SM.  What
// is left: the products on tensor cores (mma.sync or wgmma, with the
// forward's hi/lo split of the fp32 operands), B and C staged once for all
// heads of a batch row, and the chunk states kept from the forward
// instead of recomputed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 64;        // positions per chunk
constexpr int kQS = kQ + 4;   // row stride of the Q x Q tiles

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* h_in;    // initial state, contiguous (B, H, P, N), or null
  const void* dy;       // cotangent of y, x's dtype
  const float* dh_out;  // cotangent of the final state, contiguous, or null
  float* states;        // scratch (B, H, n_chunks, P, N)
  void* dx;             // x's dtype
  float* ddt;
  float* da;            // (B, H) partials
  float* db;            // (B, H, L, N) partials, contiguous
  float* dc;            // (B, H, L, N) partials, contiguous
  float* dh_in;         // (B, H, P, N), or null when h_in is null
  int B, H, L;
  long long x_sb, x_sh, x_sl;
  long long dt_sb, dt_sh, dt_sl;
  long long b_sb, b_sl;
  long long c_sb, c_sl;
  long long dy_sb, dy_sh, dy_sl;
  long long dx_sb, dx_sh, dx_sl;
  long long ddt_sb, ddt_sh, ddt_sl;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float dot4(const float4& u, const float4& v,
                                      float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Sum over the 16 lanes of a half warp (each half warp owns one row).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory in floats.  Rows are padded by 4 floats so that float4
// reads of 8 different rows hit 8 different bank quads.
template <int P, int N>
constexpr int smem_floats() {
  return 2 * P * (N + 4)      // h_prev, adjoint g
         + 2 * kQ * (P + 4)   // x, dy
         + 2 * kQ * (N + 4)   // B, C
         + 2 * kQ * kQS       // M, dS
         + 16 * kQ            // column partials of G
         + 8 * kQ             // dt, la, el, w, d la, d dt direct, dw, el term
         + kWarps;            // block sum
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_bwd_kernel(Params p) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P, N");
  constexpr int NS = N + 4;
  constexpr int PS = P + 4;
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;               // [P][NS] the chunk's start state
  float* g_s = h_s + P * NS;       // [P][NS] adjoint of the chunk's end state
  float* x_s = g_s + P * NS;       // [kQ][PS]
  float* dy_s = x_s + kQ * PS;     // [kQ][PS]
  float* b_s = dy_s + kQ * PS;     // [kQ][NS]
  float* c_s = b_s + kQ * NS;      // [kQ][NS]
  float* m_s = c_s + kQ * NS;      // [kQ][kQS] M
  float* ds_s = m_s + kQ * kQS;    // [kQ][kQS] dS
  float* cp_s = ds_s + kQ * kQS;   // [16][kQ] column partials of G
  float* dt_s = cp_s + 16 * kQ;    // [kQ]
  float* la_s = dt_s + kQ;         // cumsum(dt a) within the chunk
  float* el_s = la_s + kQ;         // exp(la)
  float* w_s = el_s + kQ;          // exp(la_Q - la)
  float* dla_s = w_s + kQ;         // row sums of G
  float* dd_s = dla_s + kQ;        // d dt through u = x dt
  float* dw_s = dd_s + kQ;         // dw
  float* et_s = dw_s + kQ;         // el_i C_i . (dy h_prev)_i
  float* red_s = et_s + kQ;        // [kWarps]

  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const float a = p.a[hh];

  const T* xg = static_cast<const T*>(p.x) + bb * p.x_sb + hh * p.x_sh;
  const float* dtg = p.dt + bb * p.dt_sb + hh * p.dt_sh;
  const T* bg = static_cast<const T*>(p.b) + bb * p.b_sb;
  const T* cg = static_cast<const T*>(p.c) + bb * p.c_sb;
  const T* dyg = static_cast<const T*>(p.dy) + bb * p.dy_sb + hh * p.dy_sh;
  T* dxg = static_cast<T*>(p.dx) + bb * p.dx_sb + hh * p.dx_sh;
  float* ddtg = p.ddt + bb * p.ddt_sb + hh * p.ddt_sh;
  const long long bh = static_cast<long long>(bb) * p.H + hh;
  float* dbg = p.db + bh * p.L * N;
  float* dcg = p.dc + bh * p.L * N;
  const int n_chunks = (p.L + kQ - 1) / kQ;
  float* stg = p.states + bh * n_chunks * P * N;

  // Stage x (and dy, C when `all`) and B of the chunk at l0 as fp32 (rows
  // past L are zero); warp 0 reads dt and scans la as the forward does.
  auto stage = [&](int l0, bool all) {
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int j = i / P, pp = i % P, l = l0 + j;
      const bool in = l < p.L;
      x_s[j * PS + pp] = in ? to_float(xg[l * p.x_sl + pp]) : 0.f;
      if (all) dy_s[j * PS + pp] = in ? to_float(dyg[l * p.dy_sl + pp]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int j = i / N, n = i % N, l = l0 + j;
      const bool in = l < p.L;
      b_s[j * NS + n] = in ? to_float(bg[l * p.b_sl + n]) : 0.f;
      if (all) c_s[j * NS + n] = in ? to_float(cg[l * p.c_sl + n]) : 0.f;
    }
    if (tid < 32) {
      // lane owns positions 2 lane and 2 lane + 1: sum its pair, then an
      // inclusive scan of the pair sums across the warp
      const int j0 = 2 * tid;
      const float d0 = l0 + j0 < p.L ? dtg[(l0 + j0) * p.dt_sl] : 0.f;
      const float d1 = l0 + j0 + 1 < p.L ? dtg[(l0 + j0 + 1) * p.dt_sl]
                                         : 0.f;
      const float s0 = d0 * a;
      const float s1 = s0 + d1 * a;
      float incl = s1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) prev = 0.f;
      const float la0 = prev + s0, la1 = prev + s1;
      const float la_q = __shfl_sync(0xffffffffu, la1, 31);
      dt_s[j0] = d0;
      dt_s[j0 + 1] = d1;
      la_s[j0] = la0;
      la_s[j0 + 1] = la1;
      el_s[j0] = expf(la0);
      el_s[j0 + 1] = expf(la1);
      w_s[j0] = expf(la_q - la0);
      w_s[j0 + 1] = expf(la_q - la1);
    }
  };

  // ---- pass 1: the state at the start of every chunk, into the scratch
  const float* hin = p.h_in == nullptr ? nullptr : p.h_in + bh * P * N;
  for (int i = tid; i < P * NS; i += kThreads) {
    const int r = i / NS, n = i % NS;
    h_s[i] = hin != nullptr && n < N ? hin[r * N + n] : 0.f;
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();  // the previous chunk is done with x_s, b_s and h_s
    stage(ch * kQ, false);
    __syncthreads();
    // h <- exp(la_Q) h + (x dt o exp(la_Q - la))^T B; rows tp + PT r,
    // columns 4 tn .. 4 tn + 3 and N / 2 + 4 tn .. N / 2 + 4 tn + 3; the
    // start state is written out first
    constexpr int NT = N / 8;
    constexpr int PT = kThreads / NT;
    constexpr int RP = PT < P ? P / PT : 1;
    static_assert(PT >= P || P % PT == 0, "rows per thread");
    const int tn = tid % NT, tp = tid / NT;
    if (tp < P) {
      const bool last = ch == n_chunks - 1;
      const float e_q = el_s[kQ - 1];
      float* st = stg + static_cast<long long>(ch) * P * N;
      float acc[RP][8];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int row = tp + PT * r;
        const float* hrow = h_s + row * NS;
        const float4 h0 = reinterpret_cast<const float4*>(hrow)[tn];
        const float4 h1 = reinterpret_cast<const float4*>(hrow + N / 2)[tn];
        reinterpret_cast<float4*>(st + row * N)[tn] = h0;
        reinterpret_cast<float4*>(st + row * N + N / 2)[tn] = h1;
        acc[r][0] = e_q * h0.x;
        acc[r][1] = e_q * h0.y;
        acc[r][2] = e_q * h0.z;
        acc[r][3] = e_q * h0.w;
        acc[r][4] = e_q * h1.x;
        acc[r][5] = e_q * h1.y;
        acc[r][6] = e_q * h1.z;
        acc[r][7] = e_q * h1.w;
      }
      if (!last) {
#pragma unroll 4
        for (int j = 0; j < kQ; ++j) {
          const float* brow = b_s + j * NS;
          const float4 b0 = reinterpret_cast<const float4*>(brow)[tn];
          const float4 b1 = reinterpret_cast<const float4*>(brow + N / 2)[tn];
          const float wj = dt_s[j] * w_s[j];
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const float xw = x_s[j * PS + tp + PT * r] * wj;
            acc[r][0] = fmaf(xw, b0.x, acc[r][0]);
            acc[r][1] = fmaf(xw, b0.y, acc[r][1]);
            acc[r][2] = fmaf(xw, b0.z, acc[r][2]);
            acc[r][3] = fmaf(xw, b0.w, acc[r][3]);
            acc[r][4] = fmaf(xw, b1.x, acc[r][4]);
            acc[r][5] = fmaf(xw, b1.y, acc[r][5]);
            acc[r][6] = fmaf(xw, b1.z, acc[r][6]);
            acc[r][7] = fmaf(xw, b1.w, acc[r][7]);
          }
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          float* hrow = h_s + (tp + PT * r) * NS;
          reinterpret_cast<float4*>(hrow)[tn] =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          reinterpret_cast<float4*>(hrow + N / 2)[tn] =
              make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      }
    }
  }

  // ---- pass 2: chunks in reverse, the adjoint state g in shared memory
  const float* dho = p.dh_out == nullptr ? nullptr : p.dh_out + bh * P * N;
  for (int i = tid; i < P * NS; i += kThreads) {
    const int r = i / NS, n = i % NS;
    g_s[i] = dho != nullptr && n < N ? dho[r * N + n] : 0.f;
  }
  float da_acc = 0.f;  // warp 0: this block's da, in a fixed order
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int l0 = ch * kQ;
    __syncthreads();  // the previous chunk is done with every buffer
    stage(l0, true);
    const float* st = stg + static_cast<long long>(ch) * P * N;
    for (int i = tid; i < P * N; i += kThreads)
      h_s[(i / N) * NS + i % N] = st[i];
    __syncthreads();

    // B. M = S o E and dS = dM o E with S = C B^T, dM = dy (x dt)^T, both
    //    causal; rows ti + 16 r, columns tj + 16 c.  Row sums of
    //    G = dM o M by half-warp sums, column sums as 16 partials.
    {
      const int ti = tid / 16, tj = tid % 16;
      float s[4][4], d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[r][cc] = d[r][cc] = 0.f;
#pragma unroll 4
      for (int n4 = 0; n4 < N / 4; ++n4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = reinterpret_cast<const float4*>(c_s + (ti + 16 * r) * NS)[n4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          bv[cc] =
              reinterpret_cast<const float4*>(b_s + (tj + 16 * cc) * NS)[n4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) s[r][cc] = dot4(cv[r], bv[cc], s[r][cc]);
      }
#pragma unroll 4
      for (int p4 = 0; p4 < P / 4; ++p4) {
        float4 yv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          yv[r] =
              reinterpret_cast<const float4*>(dy_s + (ti + 16 * r) * PS)[p4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          xv[cc] =
              reinterpret_cast<const float4*>(x_s + (tj + 16 * cc) * PS)[p4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) d[r][cc] = dot4(yv[r], xv[cc], d[r][cc]);
      }
      float colg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        float rowg = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int j = tj + 16 * cc;
          const bool causal = j <= i;
          const float e = causal ? expf(la_s[i] - la_s[j]) : 0.f;
          const float m = s[r][cc] * e;
          const float dm = causal ? d[r][cc] * dt_s[j] : 0.f;
          m_s[i * kQS + j] = m;
          ds_s[i * kQS + j] = dm * e;
          const float g = dm * m;
          rowg += g;
          colg[cc] += g;
        }
        rowg = half_warp_sum(rowg);
        if (tj == 0) dla_s[i] = rowg;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) cp_s[ti * kQ + tj + 16 * cc] = colg[cc];
    }
    __syncthreads();

    // C1. du = M^T dy + w o (B g^T); rows j = 4 ti + r, columns
    //     p = tp + 16 c.  dx = dt du; d dt (through u) = x . du;
    //     dw = dt x . (B g^T).
    {
      constexpr int TP = P / 16;
      const int ti = tid / 16, tp = tid % 16;
      float acc[4][TP], bgt[4][TP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < TP; ++cc) acc[r][cc] = bgt[r][cc] = 0.f;
      // M is zero above the diagonal: rows i < 4 ti add nothing
      for (int i = 4 * ti; i < kQ; ++i) {
        const float4 mv =
            reinterpret_cast<const float4*>(m_s + i * kQS)[ti];
        float yv[TP];
#pragma unroll
        for (int cc = 0; cc < TP; ++cc) yv[cc] = dy_s[i * PS + tp + 16 * cc];
#pragma unroll
        for (int cc = 0; cc < TP; ++cc) {
          acc[0][cc] = fmaf(mv.x, yv[cc], acc[0][cc]);
          acc[1][cc] = fmaf(mv.y, yv[cc], acc[1][cc]);
          acc[2][cc] = fmaf(mv.z, yv[cc], acc[2][cc]);
          acc[3][cc] = fmaf(mv.w, yv[cc], acc[3][cc]);
        }
      }
#pragma unroll 4
      for (int n4 = 0; n4 < N / 4; ++n4) {
        float4 bv[4], gv[TP];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          bv[r] = reinterpret_cast<const float4*>(b_s + (4 * ti + r) * NS)[n4];
#pragma unroll
        for (int cc = 0; cc < TP; ++cc)
          gv[cc] =
              reinterpret_cast<const float4*>(g_s + (tp + 16 * cc) * NS)[n4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < TP; ++cc)
            bgt[r][cc] = dot4(bv[r], gv[cc], bgt[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * ti + r, l = l0 + j;
        const float dtj = dt_s[j], wj = w_s[j];
        float dd = 0.f, dw = 0.f;
#pragma unroll
        for (int cc = 0; cc < TP; ++cc) {
          const int pp = tp + 16 * cc;
          const float du = fmaf(wj, bgt[r][cc], acc[r][cc]);
          const float xv = x_s[j * PS + pp];
          if (l < p.L) store(dxg + l * p.dx_sl + pp, dtj * du);
          dd = fmaf(du, xv, dd);
          dw = fmaf(xv, bgt[r][cc], dw);
        }
        dd = half_warp_sum(dd);
        dw = half_warp_sum(dw);
        if (tp == 0) {
          dd_s[j] = dd;
          dw_s[j] = dtj * dw;
        }
      }
    }

    // C2. dC = dS B + el o (dy h_prev); rows i = 4 ti + r, columns
    //     n = tn + 16 k; el term of d la = el_i C_i . (dy h_prev)_i.
    constexpr int TN = N / 16;
    {
      const int ti = tid / 16, tn = tid % 16;
      float acc[4][TN], dyh[4][TN];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < TN; ++k) acc[r][k] = dyh[r][k] = 0.f;
      // dS is zero above the diagonal: rows up to 4 ti + 3 need j4 <= ti
      for (int j4 = 0; j4 <= ti; ++j4) {
        float4 dsv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dsv[r] = reinterpret_cast<const float4*>(ds_s + (4 * ti + r) * kQS)[j4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float bv[TN];
#pragma unroll
          for (int k = 0; k < TN; ++k)
            bv[k] = b_s[(4 * j4 + jj) * NS + tn + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < TN; ++k)
              acc[r][k] = fmaf(comp(dsv[r], jj), bv[k], acc[r][k]);
        }
      }
#pragma unroll 2
      for (int p4 = 0; p4 < P / 4; ++p4) {
        float4 yv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          yv[r] =
              reinterpret_cast<const float4*>(dy_s + (4 * ti + r) * PS)[p4];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          float hv[TN];
#pragma unroll
          for (int k = 0; k < TN; ++k)
            hv[k] = h_s[(4 * p4 + pp) * NS + tn + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < TN; ++k)
              dyh[r][k] = fmaf(comp(yv[r], pp), hv[k], dyh[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r, l = l0 + i;
        const float e = el_s[i];
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < TN; ++k) {
          const int n = tn + 16 * k;
          if (l < p.L) dcg[static_cast<long long>(l) * N + n] =
              fmaf(e, dyh[r][k], acc[r][k]);
          t = fmaf(c_s[i * NS + n], dyh[r][k], t);
        }
        t = half_warp_sum(t);
        if (tn == 0) et_s[i] = e * t;
      }
    }

    // C3. dB = dS^T C + (w dt) o (x g); rows j = 4 ti + r, columns
    //     n = tn + 16 k.
    {
      const int ti = tid / 16, tn = tid % 16;
      float acc[4][TN], xdh[4][TN];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < TN; ++k) acc[r][k] = xdh[r][k] = 0.f;
      for (int i = 4 * ti; i < kQ; ++i) {
        const float4 dsv =
            reinterpret_cast<const float4*>(ds_s + i * kQS)[ti];
        float cv[TN];
#pragma unroll
        for (int k = 0; k < TN; ++k) cv[k] = c_s[i * NS + tn + 16 * k];
#pragma unroll
        for (int k = 0; k < TN; ++k) {
          acc[0][k] = fmaf(dsv.x, cv[k], acc[0][k]);
          acc[1][k] = fmaf(dsv.y, cv[k], acc[1][k]);
          acc[2][k] = fmaf(dsv.z, cv[k], acc[2][k]);
          acc[3][k] = fmaf(dsv.w, cv[k], acc[3][k]);
        }
      }
#pragma unroll 2
      for (int p4 = 0; p4 < P / 4; ++p4) {
        float4 xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          xv[r] = reinterpret_cast<const float4*>(x_s + (4 * ti + r) * PS)[p4];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          float gv[TN];
#pragma unroll
          for (int k = 0; k < TN; ++k)
            gv[k] = g_s[(4 * p4 + pp) * NS + tn + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < TN; ++k)
              xdh[r][k] = fmaf(comp(xv[r], pp), gv[k], xdh[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * ti + r, l = l0 + j;
        const float wd = w_s[j] * dt_s[j];
        if (l < p.L) {
#pragma unroll
          for (int k = 0; k < TN; ++k)
            dbg[static_cast<long long>(l) * N + tn + 16 * k] =
                fmaf(wd, xdh[r][k], acc[r][k]);
        }
      }
    }
    __syncthreads();  // C1 and C3 are done reading g

    // C4. g <- el_Q g + (el o dy)^T C, and <h_prev, g> before the update;
    //     rows tp + 16 r, columns tn + 16 k.
    {
      constexpr int RP = P / 16;
      const int tp = tid / 16, tn = tid % 16;
      float acc[RP][TN];
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int k = 0; k < TN; ++k) acc[r][k] = 0.f;
#pragma unroll 2
      for (int i = 0; i < kQ; ++i) {
        const float e = el_s[i];
        float yv[RP], cv[TN];
#pragma unroll
        for (int r = 0; r < RP; ++r) yv[r] = e * dy_s[i * PS + tp + 16 * r];
#pragma unroll
        for (int k = 0; k < TN; ++k) cv[k] = c_s[i * NS + tn + 16 * k];
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int k = 0; k < TN; ++k) acc[r][k] = fmaf(yv[r], cv[k], acc[r][k]);
      }
      const float e_q = el_s[kQ - 1];
      float hg = 0.f;
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int k = 0; k < TN; ++k) {
          const int idx = (tp + 16 * r) * NS + tn + 16 * k;
          const float gv = g_s[idx];
          hg = fmaf(h_s[idx], gv, hg);
          g_s[idx] = fmaf(e_q, gv, acc[r][k]);
        }
      hg = warp_sum(hg);
      if (lane == 0) red_s[tid / 32] = hg;
    }
    __syncthreads();

    // D. d la, its reverse cumsum d l within the chunk, d dt and da;
    //    warp 0, lane owns positions 2 lane and 2 lane + 1.
    if (tid < 32) {
      float hg = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) hg += red_s[w];
      const int j0 = 2 * lane;
      float v[2], wdw = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = j0 + q;
        float col = 0.f;
#pragma unroll
        for (int t = 0; t < 16; ++t) col += cp_s[t * kQ + j];
        const float wd = w_s[j] * dw_s[j];
        v[q] = dla_s[j] - col + et_s[j] - wd;
        wdw += wd;
      }
      wdw = warp_sum(wdw);
      if (lane == 31) v[1] += el_s[kQ - 1] * hg + wdw;
      // suffix sums: pair sum, then an inclusive scan from the top lane
      const float pair = v[0] + v[1];
      float incl = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += u;
      }
      float next = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) next = 0.f;
      const float dl1 = next + v[1];
      const float dl0 = dl1 + v[0];
      if (l0 + j0 < p.L) ddtg[(l0 + j0) * p.ddt_sl] = fmaf(a, dl0, dd_s[j0]);
      if (l0 + j0 + 1 < p.L)
        ddtg[(l0 + j0 + 1) * p.ddt_sl] = fmaf(a, dl1, dd_s[j0 + 1]);
      da_acc = fmaf(dt_s[j0], dl0, da_acc);
      da_acc = fmaf(dt_s[j0 + 1], dl1, da_acc);
    }
  }

  if (tid < 32) {
    da_acc = warp_sum(da_acc);
    if (lane == 0) p.da[bh] = da_acc;
  }
  if (p.dh_in != nullptr) {
    __syncthreads();
    float* dh = p.dh_in + bh * P * N;
    for (int i = tid; i < P * N; i += kThreads) dh[i] = g_s[(i / N) * NS + i % N];
  }
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// device, once per device: `done` is the caller's own flag word.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const size_t smem = sizeof(float) * smem_floats<P, N>();
  static_assert(sizeof(float) * smem_floats<P, N>() <= 232448,
                "shared memory of a block");
  cudaError_t err = allow_smem(ssd_scan_bwd_kernel<T, P, N>,
                               static_cast<int>(smem), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_scan_bwd_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(int n, const Params& p, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, P, 16>(p, stream);
    case 32: return launch<T, P, 32>(p, stream);
    case 64: return launch<T, P, 64>(p, stream);
    case 128: return launch<T, P, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int pdim, int n, const Params& p, cudaStream_t stream) {
  switch (pdim) {
    case 32: return dispatch_n<T, 32>(n, p, stream);
    case 64: return dispatch_n<T, 64>(n, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x, b, c, dy and dx): 0 = float32, 1 = bfloat16; everything
// else is float32.  x, dy, dx (B, H, L, P), dt, ddt (B, H, L), a (H,),
// b and c (B, L, N): strides in elements, the last stride of x, b, c, dy
// and dx must be 1.  h_in (null for a zero initial state), dh_out (the
// cotangent of the final state; null for zero) and dh_in (written when
// h_in is not null) are contiguous (B, H, P, N); states is a contiguous
// (B, H, ceil(L / 64), P, N) scratch; da (B, H) and db, dc (B, H, L, N)
// are contiguous per-block partials (the caller sums da over B and db, dc
// over H).  Returns the CUDA error code of the launch (0 = launched).
extern "C" int ssd_scan_bwd(
    const void* x, const float* dt, const float* a, const void* b,
    const void* c, const float* h_in, const void* dy, const float* dh_out,
    float* states, void* dx, float* ddt, float* da, float* db, float* dc,
    float* dh_in, int dtype, int B, int H, int L, int P, int N,
    long long x_sb, long long x_sh, long long x_sl, long long dt_sb,
    long long dt_sh, long long dt_sl, long long b_sb, long long b_sl,
    long long c_sb, long long c_sl, long long dy_sb, long long dy_sh,
    long long dy_sl, long long dx_sb, long long dx_sh, long long dx_sl,
    long long ddt_sb, long long ddt_sh, long long ddt_sl, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || B > 65535) return cudaErrorInvalidValue;
  if ((h_in == nullptr) != (dh_in == nullptr)) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dt = dt;
  p.a = a;
  p.b = b;
  p.c = c;
  p.h_in = h_in;
  p.dy = dy;
  p.dh_out = dh_out;
  p.states = states;
  p.dx = dx;
  p.ddt = ddt;
  p.da = da;
  p.db = db;
  p.dc = dc;
  p.dh_in = dh_in;
  p.B = B;
  p.H = H;
  p.L = L;
  p.x_sb = x_sb;
  p.x_sh = x_sh;
  p.x_sl = x_sl;
  p.dt_sb = dt_sb;
  p.dt_sh = dt_sh;
  p.dt_sl = dt_sl;
  p.b_sb = b_sb;
  p.b_sl = b_sl;
  p.c_sb = c_sb;
  p.c_sl = c_sl;
  p.dy_sb = dy_sb;
  p.dy_sh = dy_sh;
  p.dy_sl = dy_sl;
  p.dx_sb = dx_sb;
  p.dx_sh = dx_sh;
  p.dx_sl = dx_sl;
  p.ddt_sb = ddt_sb;
  p.ddt_sh = ddt_sh;
  p.ddt_sl = ddt_sl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(P, N, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(P, N, p, s);
  return cudaErrorInvalidValue;
}
