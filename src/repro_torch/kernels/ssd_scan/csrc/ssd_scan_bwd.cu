// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), built by
// kernels/build.py into a shared library with a plain C interface and
// called through ctypes from kernels/ssd_scan/ops.py (SSDScan.backward).
//
// Differentiates the function of the TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:72 ssd_scan_kernel
// (and of this port's forward, csrc/ssd_scan.cu).  The JAX package has no
// backward kernel: its training path takes the gradient by autodiff
// through src/repro/models/layers/ssd.py::ssd_chunked.  These kernels
// compute that gradient in the same chunked form.  Per head, with the
// forward h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t, y_t = h_t C_t, they
// take dy (the cotangent of y) and dh_T (of the final state, or zero) and
// write dx, d dt, and per-block partials of da, dB and dC (B and C are
// shared by all heads, a by all batch rows: the wrapper sums the partials
// in a fixed order, so no float atomics are used and runs repeat bit for
// bit), and dh0 when an initial state was given.
//
// Per (head, batch) one block makes two passes over chunks of Q = 64
// positions:
//   pass 1, in order: the state at the start of each chunk, h <- exp(la_Q) h
//     + (x dt o exp(la_Q - la))^T B as the forward does, each chunk's start
//     state written to a scratch of P N fp32 per chunk that the wrapper
//     allocates;
//   pass 2, in reverse: with la = cumsum(dt a) within the chunk,
//     E_ij = causal exp(la_i - la_j), M = (C B^T) o E, u = x dt,
//     el = exp(la), w = exp(la_Q - la), h_prev from the scratch and the
//     adjoint state g (P x N fp32, from dh_T):
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
// Two kernels, chosen by the dtype (the wrapper counts launches of each):
//
// ssd_scan_bwd_kernel_mma (bf16, "bf16-mma": the training path).  8 warps;
// every product on mma.sync.m16n8k16 tensor cores (bf16 in, fp32 sums).
// x, dy, B and C are staged as bf16 by cp.async and enter exactly; the six
// fp32 operands are split into bf16 hi + lo (two MMAs each): B' of the
// state update, M (in M^T dy), dS (in dS B and dS^T C), g (in B g^T and
// x g), h_prev (in dy h_prev) and el o dy (in g's update).  Rounding any
// one of them to bf16 alone misses the bf16 tolerance on some case
// (tests/test_torch_ssd_scan.py emulates the design on the CPU).  h and g
// are held transposed in registers as MMA accumulators (warp w owns
// columns 16 w .. 16 w + 15 of N): the layout is also h's B fragment for
// dy h_prev and g^T's A fragment for (x g)^T, and the scratch keeps it, so
// pass 2 reads each start state back as coalesced float4.  Pass 1 loads
// the next chunk while the current one's products run and forms B' in
// registers.  Pass 2, per chunk: 1a, du = w o (B g^T) from g's planes;
// 1b, the 10 tiles of S^T = B C^T and dM^T (16 x 16, at or right of the
// diagonal) formed once across the warps, M^T and dS^T written as hi + lo
// planes over g's (dead after 1a), with the row and column sums of G and
// el o dy's planes; 1c, du += M^T dy, dx; 2, per 16 columns of N: dC, dB
// and g's update, then g's planes by stmatrix.  The next chunk's x, dy,
// B, C and scalars load while warp 0 turns this chunk's d la into d dt and
// da.  113 KB of shared memory a block: 2 blocks an SM, 128 registers.
//
// ssd_scan_bwd_kernel (fp32, "fp32-fma": the parity path).  One block of
// 256 threads; every product a scalar fp32 FMA on fp32 operands staged in
// shared memory, which holds h_prev and g too (206 KB: one block an SM).
//
// What bounds it.  At the training shape of the largest rank call of
// mamba2-370m's Cluster A plan (B 10, H 32, L 2048, P 64, N 128, bf16) the
// function moves ~270 MB (x, dt, B, C, dy read once; dx, d dt, da, dB, dC
// written once): 83 us at 3.35 TB/s; the chunked form's products (C B^T,
// dy u^T, M^T dy, dS B, dS^T C over causal pairs; B g^T, dy h_prev, x g,
// the adjoint and the state update over Q x P x N) are ~75 GFLOP, 76 us at
// 989 TFLOP/s of bf16 tensor cores.  The bf16 kernel executes ~161 GFLOP
// of MMAs (the hi + lo halves, full tiles) and moves ~1.6 GB: the scratch
// written and read (671 MB), the per-head dB and dC partials (671 MB),
// and x, dy twice.  Its time goes to latency more than to either (a copy
// of an earlier version with every MMA taken out ran nearly as long;
// PERF.md): each chunk is a chain of dependent phases between barriers,
// with 16 warps an SM to hide them.  What is left: the chunk states kept from the forward (no pass 1,
// no scratch), B and C staged once for the heads of a batch row, the dB,
// dC reduction across heads in a cluster, a chunk-parallel split that
// fills the card at small B, and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

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
  float* states;        // scratch, P N per chunk and (batch, head)
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
  int vec;  // elements per copy of the bf16 kernel: 8, 4, 2 or 1
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---- ssd_scan_bwd_kernel_mma: bf16 on mma.sync tensor cores ----

constexpr int kWarpsMma = 8;
constexpr int kThreadsMma = 32 * kWarpsMma;
// the 16 x 16 tiles of a chunk at or right of the diagonal (rows j,
// columns i >= j), numbered by rows: row group r's first tile is
// tile_base(r), its tiles cover column tiles r .. 3
constexpr int kTiles = 10;
__host__ __device__ constexpr int tile_base(int r) { return r * (9 - r) / 2; }
using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
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

// A bf16 pair scaled by (s0, s1), then split into hi + lo.
__device__ __forceinline__ void scale_split(uint32_t v, float s0, float s1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split(f.x * s0, f.y * s1, hi, lo);
}

// Stage rows l0 .. l0 + kQ - 1 of a (L, COLS) bf16 matrix with row stride
// `ld` into shared memory rows of `lds` elements; rows past L are zeros.
// VEC elements per copy: cp.async of 2 VEC bytes, or plain loads at 1.
template <int COLS, int VEC>
__device__ __forceinline__ void stage(bf16* dst, int lds, const bf16* src,
                                      long long ld, int l0, int L, int tid) {
  constexpr int kPerRow = COLS / VEC;
  for (int i = tid; i < kQ * kPerRow; i += kThreadsMma) {
    const int j = i / kPerRow, col = (i % kPerRow) * VEC, l = l0 + j;
    const bool in = l < L;
    if constexpr (VEC == 1) {
      dst[j * lds + col] = in ? src[l * ld + col] : __float2bfloat16(0.f);
    } else {
      cp_async<2 * VEC>(smem_u32(dst + j * lds + col),
                        src + (in ? l * ld + col : 0), in);
    }
  }
}

template <int COLS>
__device__ __forceinline__ void stage_any(int vec, bf16* dst, int lds,
                                          const bf16* src, long long ld,
                                          int l0, int L, int tid) {
  switch (vec) {
    case 8: stage<COLS, 8>(dst, lds, src, ld, l0, L, tid); break;
    case 4: stage<COLS, 4>(dst, lds, src, ld, l0, L, tid); break;
    case 2: stage<COLS, 2>(dst, lds, src, ld, l0, L, tid); break;
    default: stage<COLS, 1>(dst, lds, src, ld, l0, L, tid); break;
  }
}

// Fragments by ldmatrix from bf16 tiles in shared memory with row stride
// `ld` (elements).  The lane's row within an 8 x 8 matrix, and which of
// the four matrices of an x4 it addresses:
struct Lanes {
  int lr, m_lo, m_hi;
};

// A (16 x 16) at rows m0.., columns k0.. of a row-major [m][k] tile.
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* s, int ld,
                                     int m0, int k0, Lanes q) {
  ldsm_x4(a, smem_u32(s + (m0 + q.lr + 8 * q.m_lo) * ld + k0 + 8 * q.m_hi));
}
// A = the transpose of a row-major [k][m] tile.
__device__ __forceinline__ void ld_a_t(uint32_t (&a)[4], const bf16* s,
                                       int ld, int m0, int k0, Lanes q) {
  ldsm_x4_t(a,
            smem_u32(s + (k0 + 8 * q.m_hi + q.lr) * ld + m0 + 8 * q.m_lo));
}
// B (16 x 8) of the two n-tiles n0.. and n0 + 8.. at k0.. of a row-major
// [n][k] tile: b[0], b[1] for the first, b[2], b[3] for the second.
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const bf16* s, int ld,
                                     int k0, int n0, Lanes q) {
  ldsm_x4(b, smem_u32(s + (n0 + 8 * q.m_hi + q.lr) * ld + k0 + 8 * q.m_lo));
}
// ... of a row-major [k][n] tile.
__device__ __forceinline__ void ld_b_t(uint32_t (&b)[4], const bf16* s,
                                       int ld, int k0, int n0, Lanes q) {
  ldsm_x4_t(b,
            smem_u32(s + (k0 + 8 * q.m_lo + q.lr) * ld + n0 + 8 * q.m_hi));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Elements of the g region: g^T's planes, or M^T's and el o dy's, or (in
// pass 1) one chunk's B.
template <int P, int N>
__host__ __device__ constexpr int g_region() {
  constexpr int g = 2 * N * (P + 8), me = 2 * kQ * (kQ + 8) + 2 * kQ * (P + 8);
  constexpr int m = g > me ? g : me;
  return m > kQ * (N + 8) ? m : kQ * (N + 8);
}

// Shared memory in bytes.  Rows of every bf16 tile are padded by 16 B, so
// the 8 rows an ldmatrix reads fall in 8 different 16 B bank groups.
template <int P, int N>
constexpr int smem_bytes_mma() {
  return 2 * (2 * kQ * (P + 8)       // x, dy
              + 2 * kQ * (N + 8)     // B, C
              + g_region<P, N>()     // the g region
              + 2 * kQ * (kQ + 8))   // dS^T hi, lo
         + 4 * (8 * kQ               // dt, la, exp(la), exp(la_Q - la) x 2
                + 2 * kTiles * 16    // row and column sums of G by tile
                + kWarpsMma * kQ     // C . (dy h_prev) by n-slice
                + 4 * kQ             // x . (B g^T), x . du by half of P
                + kWarpsMma);        // <h_prev, g> by n-slice
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `n` committed groups of this thread are pending.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* ptr) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(ptr));
}

template <int P, int N>
__global__ void __launch_bounds__(kThreadsMma, 2)
    ssd_scan_bwd_kernel_mma(const __grid_constant__ Params p) {
  constexpr int XS = P + 8;    // row stride of x_s, dy_s, el o dy
  constexpr int NS = N + 8;    // of b_s, c_s
  constexpr int GS = P + 8;    // of the g^T planes
  constexpr int QS = kQ + 8;   // of the M^T and dS^T planes
  constexpr int NSL = N / 16;  // warps that own a 16-column slice of N
  constexpr int PQ = P / 8;    // 8-wide tiles of the head dim
  constexpr int PHT = P / 16;  // 8-wide tiles of a half of the head dim
  static_assert(P % 32 == 0 && N % 16 == 0 && NSL <= kWarpsMma, "P, N");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // [kQ][XS]
  bf16* dy_s = x_s + kQ * XS;     // [kQ][XS]
  bf16* b_s = dy_s + kQ * XS;     // [kQ][NS]: B
  bf16* c_s = b_s + kQ * NS;      // [kQ][NS]: C
  // The g region: g^T's hi and lo planes ([N][GS]), read in phase 1a;
  // then M^T's planes ([kQ][QS], rows j) and el o dy's ([kQ][XS]), and at
  // the chunk's end g's planes again.  Pass 1: B of odd chunks.
  bf16* gh_s = c_s + kQ * NS;
  bf16* gl_s = gh_s + N * GS;
  bf16* mh_s = gh_s;
  bf16* ml_s = mh_s + kQ * QS;
  bf16* eh_s = ml_s + kQ * QS;
  bf16* el2_s = eh_s + kQ * XS;
  bf16* dsh_s = gh_s + g_region<P, N>();  // [kQ][QS]: dS^T hi, rows j
  bf16* dsl_s = dsh_s + kQ * QS;    // [kQ][QS]: dS^T lo
  // by chunk parity: dt, la = cumsum(dt a), exp(la), exp(la_Q - la)
  float* sc_s = reinterpret_cast<float*>(dsl_s + kQ * QS);  // [2][4][kQ]
  float* rp_s = sc_s + 8 * kQ;          // [kTiles][16] row sums of G
  float* cp_s = rp_s + kTiles * 16;     // [kTiles][16] column sums of G
  float* et_s = cp_s + kTiles * 16;     // [kWarpsMma][kQ] C . (dy h_prev)
  float* dw_s = et_s + kWarpsMma * kQ;  // [2][kQ] x_j . (B g^T)_j
  float* dd_s = dw_s + 2 * kQ;          // [2][kQ] x_j . du_j
  float* hg_s = dd_s + 2 * kQ;          // [kWarpsMma] <h_prev, g>

  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const Lanes ln{lane & 7, (lane >> 3) & 1, lane >> 4};
  const float a = p.a[hh];

  const bf16* xg = static_cast<const bf16*>(p.x) + bb * p.x_sb + hh * p.x_sh;
  const float* dtg = p.dt + bb * p.dt_sb + hh * p.dt_sh;
  const bf16* bgl = static_cast<const bf16*>(p.b) + bb * p.b_sb;
  const bf16* cgl = static_cast<const bf16*>(p.c) + bb * p.c_sb;
  const bf16* dyg =
      static_cast<const bf16*>(p.dy) + bb * p.dy_sb + hh * p.dy_sh;
  bf16* dxg = static_cast<bf16*>(p.dx) + bb * p.dx_sb + hh * p.dx_sh;
  float* ddtg = p.ddt + bb * p.ddt_sb + hh * p.ddt_sh;
  const long long bh = static_cast<long long>(bb) * p.H + hh;
  float* dbg = p.db + bh * p.L * N;
  float* dcg = p.dc + bh * p.L * N;
  const int n_chunks = (p.L + kQ - 1) / kQ;
  float* stg = p.states + bh * n_chunks * P * N;

  // The state h and the adjoint g are held transposed, as the accumulator
  // of a (16 x P) tile per warp: warp w < NSL owns columns n0 = 16 w ..
  // n0 + 15 of N, and value (q, e) of a lane is at row p = 8 q + 2 t +
  // (e & 1), column n = n0 + g + 8 (e >> 1).  That layout is also the B
  // fragment of h for dy h_prev, and the A fragment of g^T for (x g)^T.
  const bool nrole = warp < NSL;
  const int n0 = 16 * warp;
  auto at_pn = [&](int q, int e) {
    return (8 * q + 2 * t + (e & 1)) * N + n0 + g + 8 * (e >> 1);
  };
  // The scratch keeps each chunk's start state in the same layout: the
  // four values (q, 0..3) of thread tid as float4 q 32 NSL + tid, so each
  // access is one coalesced 16 B load or store a lane.
  auto at_st = [&](int q) { return q * 32 * NSL + tid; };

  // dt of the chunk at l0 for lane's positions 2 lane and 2 lane + 1 (0
  // past L), loaded a chunk ahead of the scan that reads it
  auto load_dt = [&](int l0, float& d0, float& d1) {
    const int j0 = 2 * lane;
    d0 = l0 >= 0 && l0 + j0 < p.L ? dtg[(l0 + j0) * p.dt_sl] : 0.f;
    d1 = l0 >= 0 && l0 + j0 + 1 < p.L ? dtg[(l0 + j0 + 1) * p.dt_sl] : 0.f;
  };
  // dt, la = cumsum(dt a), exp(la), exp(la_Q - la) of a chunk into scalar
  // buffer `sb`, by one warp from its lanes' dt (d0, d1)
  auto scan = [&](float d0, float d1, int sb) {
    float* s = sc_s + 4 * kQ * sb;
    const int j0 = 2 * lane;
    const float s0 = d0 * a;
    const float s1 = s0 + d1 * a;
    float incl = s1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    float prev = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) prev = 0.f;
    const float la0 = prev + s0, la1 = prev + s1;
    const float la_q = __shfl_sync(0xffffffffu, la1, 31);
    s[j0] = d0;
    s[j0 + 1] = d1;
    s[kQ + j0] = la0;
    s[kQ + j0 + 1] = la1;
    s[2 * kQ + j0] = expf(la0);
    s[2 * kQ + j0 + 1] = expf(la1);
    s[3 * kQ + j0] = expf(la_q - la0);
    s[3 * kQ + j0 + 1] = expf(la_q - la1);
  };
  // x (and dy) rows and dt of the chunk at l0 into L2, ahead of staging
  auto prefetch_chunk = [&](int l0, bool with_dy) {
    const int j = tid % kQ, l = l0 + j;
    if (l0 < 0 || l >= p.L) return;
    switch (tid / kQ) {
      case 0: prefetch_l2(xg + l * p.x_sl); break;
      case 1: prefetch_l2(dtg + l * p.dt_sl); break;
      case 2: if (with_dy) prefetch_l2(dyg + l * p.dy_sl); break;
      default: break;
    }
  };

  // ---- pass 1: the state at the start of every chunk, into the scratch;
  //      h^T <- exp(la_Q) h^T + B'^T x with B' = B o dt exp(la_Q - la),
  //      B' formed from B in registers (A fragments, hi and lo).  Chunks
  //      alternate between two buffers (x in x_s or dy_s, B in b_s or the
  //      g region, the scalars in buffer 0 or 1): the next chunk loads
  //      while this one's products run.
  float hs[PQ][4];
  {
    const float* hin = p.h_in == nullptr ? nullptr : p.h_in + bh * P * N;
#pragma unroll
    for (int q = 0; q < PQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hs[q][e] = nrole && hin != nullptr ? hin[at_pn(q, e)] : 0.f;
  }
  float dq0, dq1;  // warp 0: dt of the next chunk to scan
  load_dt(0, dq0, dq1);
  auto stage1 = [&](int ch) {
    const int k = ch & 1;
    stage_any<P>(p.vec, k ? dy_s : x_s, XS, xg, p.x_sl, ch * kQ, p.L, tid);
    stage_any<N>(p.vec, k ? gh_s : b_s, NS, bgl, p.b_sl, ch * kQ, p.L, tid);
    cp_async_commit();
    prefetch_chunk((ch + 1) * kQ, false);
    if (warp == 0) {
      scan(dq0, dq1, k);
      load_dt((ch + 1) * kQ, dq0, dq1);
    }
  };
  if (n_chunks > 1) stage1(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (nrole) {
      float* st = stg + static_cast<long long>(ch) * P * N;
#pragma unroll
      for (int q = 0; q < PQ; ++q)
#pragma unroll
        reinterpret_cast<float4*>(st)[at_st(q)] =
            make_float4(hs[q][0], hs[q][1], hs[q][2], hs[q][3]);
    }
    if (ch == n_chunks - 1) break;
    if (ch + 1 < n_chunks - 1) {
      stage1(ch + 1);
      cp_async_wait<1>();  // this chunk's copies are in, the next may fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (nrole) {
      const int k = ch & 1;
      const bf16* xk = k ? dy_s : x_s;
      const bf16* bk = k ? gh_s : b_s;
      const float* s = sc_s + 4 * kQ * k;
      const float e_q = s[2 * kQ + kQ - 1];
#pragma unroll
      for (int q = 0; q < PQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[q][e] *= e_q;
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        // A = B'^T (rows n, k = positions j): B by ldmatrix.trans, each
        // column j scaled by dt_j exp(la_Q - la_j), split hi + lo
        const int j = 16 * ks + 2 * t;
        const float w0 = s[j] * s[3 * kQ + j];
        const float w1 = s[j + 1] * s[3 * kQ + j + 1];
        const float w8 = s[j + 8] * s[3 * kQ + j + 8];
        const float w9 = s[j + 9] * s[3 * kQ + j + 9];
        uint32_t bt[4], ah[4], al[4];
        ld_a_t(bt, bk, NS, n0, 16 * ks, ln);
        scale_split(bt[0], w0, w1, ah[0], al[0]);
        scale_split(bt[1], w0, w1, ah[1], al[1]);
        scale_split(bt[2], w8, w9, ah[2], al[2]);
        scale_split(bt[3], w8, w9, ah[3], al[3]);
#pragma unroll
        for (int qq = 0; qq < PQ; qq += 2) {
          uint32_t xb[4];
          ld_b_t(xb, xk, XS, 16 * ks, 8 * qq, ln);
          mma(hs[qq], ah, xb[0], xb[1]);
          mma(hs[qq], al, xb[0], xb[1]);
          mma(hs[qq + 1], ah, xb[2], xb[3]);
          mma(hs[qq + 1], al, xb[2], xb[3]);
        }
      }
    }
    __syncthreads();  // this chunk's buffers are free for chunk ch + 2
  }

  // ---- pass 2: chunks in reverse with the adjoint g (registers, and its
  //      hi + lo planes for B g^T)
  float gs[PQ][4];
  {
    const float* dho = p.dh_out == nullptr ? nullptr : p.dh_out + bh * P * N;
#pragma unroll
    for (int q = 0; q < PQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gs[q][e] = nrole && dho != nullptr ? dho[at_pn(q, e)] : 0.f;
  }
  // g^T's hi and lo planes by stmatrix: the accumulator of 8 x 8 block
  // (q, r) (rows n0 + 8 r.., columns 8 q..) is an 8 x 8 fragment; one x4
  // stores blocks (q, 0), (q, 1), (q + 1, 0), (q + 1, 1), lane 8 i + rr
  // addressing row rr of block i
  const int st_at = (n0 + 8 * ((lane >> 3) & 1) + (lane & 7)) * GS +
                    8 * (lane >> 4);
  auto store_g = [&]() {
    if (!nrole) return;
#pragma unroll
    for (int q = 0; q < PQ; q += 2) {
      uint32_t hi[4], lo[4];
      split(gs[q][0], gs[q][1], hi[0], lo[0]);
      split(gs[q][2], gs[q][3], hi[1], lo[1]);
      split(gs[q + 1][0], gs[q + 1][1], hi[2], lo[2]);
      split(gs[q + 1][2], gs[q + 1][3], hi[3], lo[3]);
      stsm_x4(smem_u32(gh_s + st_at + 8 * q), hi);
      stsm_x4(smem_u32(gl_s + st_at + 8 * q), lo);
    }
  };
  store_g();

  // Row role of phases 1a and 1c: rows j0r .. j0r + 15 of the chunk,
  // head-dim columns p0r .. p0r + P / 2 - 1 of du
  const int rg = warp & 3, ph = warp >> 2;
  const int j0r = 16 * rg, p0r = (P / 2) * ph;
  const int ja = j0r + g, jb = ja + 8;
  // x, dy, B, C of chunk ch, and its scalars by warp 1 into buffer ch & 1
  auto stage2 = [&](int ch) {
    const int l0 = ch * kQ;
    stage_any<P>(p.vec, x_s, XS, xg, p.x_sl, l0, p.L, tid);
    stage_any<P>(p.vec, dy_s, XS, dyg, p.dy_sl, l0, p.L, tid);
    stage_any<N>(p.vec, b_s, NS, bgl, p.b_sl, l0, p.L, tid);
    stage_any<N>(p.vec, c_s, NS, cgl, p.c_sl, l0, p.L, tid);
    cp_async_commit();
    if (warp == 1) {
      float d0, d1;
      load_dt(l0, d0, d1);
      scan(d0, d1, ch & 1);
    }
  };
  __syncthreads();  // pass 1 is done with every buffer
  stage2(n_chunks - 1);
  float da_acc = 0.f;  // warp 0: this block's da, in a fixed order
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int l0 = ch * kQ;
    const float* st = stg + static_cast<long long>(ch) * P * N;
    if (nrole && 32 * tid < P * N)  // the start state, read in phase 2
      prefetch_l2(st + 32 * tid);
    prefetch_chunk(l0 - kQ, true);
    const float* dt_s = sc_s + 4 * kQ * (ch & 1);
    const float* la_s = dt_s + kQ;
    const float* el_s = la_s + kQ;
    const float* w_s = el_s + kQ;
    cp_async_wait<0>();
    __syncthreads();  // the chunk is staged

    // Phase 1a, rows j: du = w o (B g^T), g^T's planes as B fragments;
    // the row sums of x o (B g^T).
    float du[PHT][4];
#pragma unroll
    for (int pt = 0; pt < PHT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) du[pt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t ba[4];
      ld_a(ba, b_s, NS, j0r, 16 * ks, ln);
#pragma unroll
      for (int pt = 0; pt < PHT; pt += 2) {
        uint32_t gh[4], gl[4];
        ld_b_t(gh, gh_s, GS, 16 * ks, p0r + 8 * pt, ln);
        ld_b_t(gl, gl_s, GS, 16 * ks, p0r + 8 * pt, ln);
        mma(du[pt], ba, gh[0], gh[1]);
        mma(du[pt], ba, gl[0], gl[1]);
        mma(du[pt + 1], ba, gh[2], gh[3]);
        mma(du[pt + 1], ba, gl[2], gl[3]);
      }
    }
    {
      float dwa = 0.f, dwb = 0.f;
#pragma unroll
      for (int pt = 0; pt < PHT; ++pt) {
        const int pc = p0r + 8 * pt + 2 * t;
        const float2 xa = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x_s + ja * XS + pc));
        const float2 xb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x_s + jb * XS + pc));
        dwa += xa.x * du[pt][0] + xa.y * du[pt][1];
        dwb += xb.x * du[pt][2] + xb.y * du[pt][3];
      }
      dwa = quad_sum(dwa);
      dwb = quad_sum(dwb);
      if (t == 0) {
        dw_s[ph * kQ + ja] = dwa;
        dw_s[ph * kQ + jb] = dwb;
      }
      const float wa = w_s[ja], wb = w_s[jb];
#pragma unroll
      for (int pt = 0; pt < PHT; ++pt) {
        du[pt][0] *= wa;
        du[pt][1] *= wa;
        du[pt][2] *= wb;
        du[pt][3] *= wb;
      }
    }
    __syncthreads();  // g's planes are read: their region is free

    // Phase 1b: the 16 x 16 tiles (rows j, columns i >= j) of S^T = B C^T
    // and dM^T = dt_j x dy^T, formed once, tile k by warp k % 8:
    // M^T = S^T o E^T, dS^T = dM^T o E^T, G^T = dS^T o S^T; M^T and dS^T
    // to shared memory as hi + lo planes, the sums of G by tile.  Then
    // el o dy as hi + lo planes, by every thread.
    for (int tile = warp; tile < kTiles; tile += kWarpsMma) {
      // tile -> (row group tr, column tile it), rows first: 4, 3, 2, 1
      const int tr = tile < 4 ? 0 : tile < 7 ? 1 : tile < 9 ? 2 : 3;
      const int it = tr + tile - tile_base(tr);
      const int j0 = 16 * tr, ta = j0 + g, tb = ta + 8;
      float s[2][4], d[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[h][e] = d[h][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t ba[4], cb[4];
        ld_a(ba, b_s, NS, j0, 16 * ks, ln);
        ld_b(cb, c_s, NS, 16 * ks, 16 * it, ln);
        mma(s[0], ba, cb[0], cb[1]);
        mma(s[1], ba, cb[2], cb[3]);
      }
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t xa[4], yb[4];
        ld_a(xa, x_s, XS, j0, 16 * ks, ln);
        ld_b(yb, dy_s, XS, 16 * ks, 16 * it, ln);
        mma(d[0], xa, yb[0], yb[1]);
        mma(d[1], xa, yb[2], yb[3]);
      }
      // the exponent is masked before exp, so there is no inf * 0
      const float la_a = la_s[ta], la_b = la_s[tb];
      const float dt_a = dt_s[ta], dt_b = dt_s[tb];
      float cga = 0.f, cgb = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m[4], ds[4], gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * it + 8 * h + 2 * t + (e & 1);
          const bool lo_row = e < 2;
          const bool causal = i >= (lo_row ? ta : tb);
          const float ex =
              causal ? expf(la_s[i] - (lo_row ? la_a : la_b)) : 0.f;
          const float dm = d[h][e] * (lo_row ? dt_a : dt_b);
          m[e] = s[h][e] * ex;
          ds[e] = dm * ex;
          gv[e] = dm * m[e];
        }
        cga += gv[0] + gv[1];
        cgb += gv[2] + gv[3];
        const int col = 16 * it + 8 * h + 2 * t;
        uint32_t hi, lo;
        split(m[0], m[1], hi, lo);
        *reinterpret_cast<uint32_t*>(mh_s + ta * QS + col) = hi;
        *reinterpret_cast<uint32_t*>(ml_s + ta * QS + col) = lo;
        split(m[2], m[3], hi, lo);
        *reinterpret_cast<uint32_t*>(mh_s + tb * QS + col) = hi;
        *reinterpret_cast<uint32_t*>(ml_s + tb * QS + col) = lo;
        split(ds[0], ds[1], hi, lo);
        *reinterpret_cast<uint32_t*>(dsh_s + ta * QS + col) = hi;
        *reinterpret_cast<uint32_t*>(dsl_s + ta * QS + col) = lo;
        split(ds[2], ds[3], hi, lo);
        *reinterpret_cast<uint32_t*>(dsh_s + tb * QS + col) = hi;
        *reinterpret_cast<uint32_t*>(dsl_s + tb * QS + col) = lo;
        // sums over this tile's 16 rows j, per column i
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = gv[c] + gv[2 + c];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) rp_s[tile * 16 + 8 * h + 2 * t + c] = v;
        }
      }
      cga = quad_sum(cga);
      cgb = quad_sum(cgb);
      if (t == 0) {
        cp_s[tile * 16 + g] = cga;
        cp_s[tile * 16 + g + 8] = cgb;
      }
    }
    for (int i2 = tid; i2 < kQ * P / 2; i2 += kThreadsMma) {
      const int i = i2 / (P / 2), at = i * XS + 2 * (i2 % (P / 2));
      const float e = el_s[i];
      uint32_t hi, lo;
      scale_split(*reinterpret_cast<const uint32_t*>(dy_s + at), e, e, hi,
                  lo);
      *reinterpret_cast<uint32_t*>(eh_s + at) = hi;
      *reinterpret_cast<uint32_t*>(el2_s + at) = lo;
    }
    __syncthreads();

    // Phase 1c, rows j: du += M^T dy (M^T's planes as A fragments) over
    // the tiles at or right of the diagonal; dx = dt du; x . du.
    for (int it = rg; it < kQ / 16; ++it) {
      uint32_t mh[4], ml[4];
      ld_a(mh, mh_s, QS, j0r, 16 * it, ln);
      ld_a(ml, ml_s, QS, j0r, 16 * it, ln);
#pragma unroll
      for (int pt = 0; pt < PHT; pt += 2) {
        uint32_t yb[4];
        ld_b_t(yb, dy_s, XS, 16 * it, p0r + 8 * pt, ln);
        mma(du[pt], mh, yb[0], yb[1]);
        mma(du[pt], ml, yb[0], yb[1]);
        mma(du[pt + 1], mh, yb[2], yb[3]);
        mma(du[pt + 1], ml, yb[2], yb[3]);
      }
    }
    {
      const float dt_a = dt_s[ja], dt_b = dt_s[jb];
      float dda = 0.f, ddb = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = half ? jb : ja, l = l0 + j;
        const float dtj = half ? dt_b : dt_a;
        float dd = 0.f;
#pragma unroll
        for (int pt = 0; pt < PHT; ++pt) {
          const int pc = p0r + 8 * pt + 2 * t;
          const float u0 = du[pt][2 * half], u1 = du[pt][2 * half + 1];
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x_s + j * XS + pc));
          dd += xv.x * u0 + xv.y * u1;
          if (l < p.L)
            *reinterpret_cast<__nv_bfloat162*>(dxg + l * p.dx_sl + pc) =
                __floats2bfloat162_rn(dtj * u0, dtj * u1);
        }
        if (half)
          ddb = dd;
        else
          dda = dd;
      }
      dda = quad_sum(dda);
      ddb = quad_sum(ddb);
      if (t == 0) {
        dd_s[ph * kQ + ja] = dda;
        dd_s[ph * kQ + jb] = ddb;
      }
    }
    // (phase 2 reads nothing that 1c writes: no barrier)

    // Phase 2, the n-slice n0 .. n0 + 15 of warp w < NSL: <h_prev, g>;
    // dC = el o (dy h_prev) + dS B (rows i); dB^T = (w dt) o (x g)^T +
    // C^T dS (columns j); g^T <- el_Q g^T + C^T (el o dy), el o dy's
    // planes as B fragments.  Then g's planes over the region.
    if (nrole) {
      // dC, with h_prev from the scratch as B fragments (hi and lo)
      float acc[4][2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][r][e] = 0.f;
      float hg = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        float hv[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 v = reinterpret_cast<const float4*>(st)[at_st(2 * ks + q)];
          hv[q][0] = v.x;
          hv[q][1] = v.y;
          hv[q][2] = v.z;
          hv[q][3] = v.w;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hg = fmaf(hv[q][e], gs[2 * ks + q][e], hg);
        }
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            split(hv[q][2 * r], hv[q][2 * r + 1], bh[r][q], bl[r][q]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t ya[4];
          ld_a(ya, dy_s, XS, 16 * mt, 16 * ks, ln);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mma(acc[mt][r], ya, bh[r][0], bh[r][1]);
            mma(acc[mt][r], ya, bl[r][0], bl[r][1]);
          }
        }
      }
      hg = warp_sum(hg);
      if (lane == 0) hg_s[warp] = hg;
      // C_i . (dy h_prev)_i over this slice, then el_i times the row
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 16 * mt + g + 8 * half;
          float v = 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 cv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    c_s + i * NS + n0 + 8 * r + 2 * t));
            v += cv.x * acc[mt][r][2 * half] + cv.y * acc[mt][r][2 * half + 1];
          }
          v = quad_sum(v);
          if (t == 0) et_s[warp * kQ + i] = v;
          const float e = el_s[i];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            acc[mt][r][2 * half] *= e;
            acc[mt][r][2 * half + 1] *= e;
          }
        }
      // + dS B: dS (rows i, k = j) by ldmatrix.trans of the dS^T planes;
      // dS is zero above the diagonal: k-steps ks <= mt
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        uint32_t bb2[4];
        ld_b_t(bb2, b_s, NS, 16 * ks, n0, ln);
#pragma unroll
        for (int mt = ks; mt < 4; ++mt) {
          uint32_t dh[4], dl[4];
          ld_a_t(dh, dsh_s, QS, 16 * mt, 16 * ks, ln);
          ld_a_t(dl, dsl_s, QS, 16 * mt, 16 * ks, ln);
          mma(acc[mt][0], dh, bb2[0], bb2[1]);
          mma(acc[mt][0], dl, bb2[0], bb2[1]);
          mma(acc[mt][1], dh, bb2[2], bb2[3]);
          mma(acc[mt][1], dl, bb2[2], bb2[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int l = l0 + 16 * mt + g + 8 * half;
          if (l < p.L) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<float2*>(dcg + static_cast<long long>(l) * N +
                                         n0 + 8 * r + 2 * t) =
                  make_float2(acc[mt][r][2 * half], acc[mt][r][2 * half + 1]);
          }
        }
    }
    if (nrole) {
      // dB^T: (x g)^T with g^T's accumulator as the A fragment (hi, lo)
      float acc[kQ / 8][4];
#pragma unroll
      for (int jt = 0; jt < kQ / 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t ah[4], al[4];
        split(gs[2 * ks][0], gs[2 * ks][1], ah[0], al[0]);
        split(gs[2 * ks][2], gs[2 * ks][3], ah[1], al[1]);
        split(gs[2 * ks + 1][0], gs[2 * ks + 1][1], ah[2], al[2]);
        split(gs[2 * ks + 1][2], gs[2 * ks + 1][3], ah[3], al[3]);
#pragma unroll
        for (int jq = 0; jq < kQ / 16; ++jq) {
          uint32_t xb[4];
          ld_b(xb, x_s, XS, 16 * ks, 16 * jq, ln);
          mma(acc[2 * jq], ah, xb[0], xb[1]);
          mma(acc[2 * jq], al, xb[0], xb[1]);
          mma(acc[2 * jq + 1], ah, xb[2], xb[3]);
          mma(acc[2 * jq + 1], al, xb[2], xb[3]);
        }
      }
#pragma unroll
      for (int jt = 0; jt < kQ / 8; ++jt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * jt + 2 * t + c;
          const float wd = w_s[j] * dt_s[j];
          acc[jt][c] *= wd;
          acc[jt][2 + c] *= wd;
        }
      // + C^T dS, and g^T <- el_Q g^T + C^T (el o dy): one A fragment of
      // C^T per k-step; dS (k = i, columns j) is zero for j > i
      const float e_q = el_s[kQ - 1];
#pragma unroll
      for (int q = 0; q < PQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) gs[q][e] *= e_q;
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        uint32_t ca[4];
        ld_a_t(ca, c_s, NS, n0, 16 * ks, ln);
#pragma unroll
        for (int jq = 0; jq <= ks; ++jq) {
          uint32_t dh[4], dl[4];
          ld_b(dh, dsh_s, QS, 16 * ks, 16 * jq, ln);
          ld_b(dl, dsl_s, QS, 16 * ks, 16 * jq, ln);
          mma(acc[2 * jq], ca, dh[0], dh[1]);
          mma(acc[2 * jq], ca, dl[0], dl[1]);
          mma(acc[2 * jq + 1], ca, dh[2], dh[3]);
          mma(acc[2 * jq + 1], ca, dl[2], dl[3]);
        }
#pragma unroll
        for (int qq = 0; qq < PQ; qq += 2) {
          uint32_t bh[4], bl[4];
          ld_b_t(bh, eh_s, XS, 16 * ks, 8 * qq, ln);
          ld_b_t(bl, el2_s, XS, 16 * ks, 8 * qq, ln);
          mma(gs[qq], ca, bh[0], bh[1]);
          mma(gs[qq], ca, bl[0], bl[1]);
          mma(gs[qq + 1], ca, bh[2], bh[3]);
          mma(gs[qq + 1], ca, bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int jt = 0; jt < kQ / 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = l0 + 8 * jt + 2 * t + (e & 1);
          if (l < p.L)
            dbg[static_cast<long long>(l) * N + n0 + g + 8 * (e >> 1)] =
                acc[jt][e];
        }
    }
    __syncthreads();  // every warp is done with the chunk's buffers
    store_g();        // read by the next chunk's phase 1a
    if (ch > 0) stage2(ch - 1);  // loads while warp 0 finishes this chunk

    // D. d la, its reverse cumsum d l within the chunk, d dt and da;
    //    warp 0, lane owns positions 2 lane and 2 lane + 1.
    if (warp == 0) {
      float hg = 0.f;
#pragma unroll
      for (int w = 0; w < NSL; ++w) hg += hg_s[w];
      const int j0 = 2 * lane;
      float v[2], dd[2], wdw = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = j0 + q;
        // G's row sums from the tiles of column tile j / 16, its column
        // sums from those of row group j / 16
        const int blk = j / 16, jj = j % 16;
        float row = 0.f, col = 0.f;
        for (int r = 0; r <= blk; ++r)
          row += rp_s[(tile_base(r) + blk - r) * 16 + jj];
        for (int c = blk; c < kQ / 16; ++c)
          col += cp_s[(tile_base(blk) + c - blk) * 16 + jj];
        float et = 0.f;
#pragma unroll
        for (int w = 0; w < NSL; ++w) et += et_s[w * kQ + j];
        const float wd = w_s[j] * dt_s[j] * (dw_s[j] + dw_s[kQ + j]);
        v[q] = row - col + el_s[j] * et - wd;
        wdw += wd;
        dd[q] = dd_s[j] + dd_s[kQ + j];
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
      if (l0 + j0 < p.L) ddtg[(l0 + j0) * p.ddt_sl] = fmaf(a, dl0, dd[0]);
      if (l0 + j0 + 1 < p.L)
        ddtg[(l0 + j0 + 1) * p.ddt_sl] = fmaf(a, dl1, dd[1]);
      da_acc = fmaf(dt_s[j0], dl0, da_acc);
      da_acc = fmaf(dt_s[j0 + 1], dl1, da_acc);
    }
  }

  if (warp == 0) {
    da_acc = warp_sum(da_acc);
    if (lane == 0) p.da[bh] = da_acc;
  }
  if (p.dh_in != nullptr && nrole) {
    float* dh = p.dh_in + bh * P * N;
#pragma unroll
    for (int q = 0; q < PQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[at_pn(q, e)] = gs[q][e];
  }
}

template <int P, int N>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  constexpr int smem = smem_bytes_mma<P, N>();
  static_assert(smem <= 232448 / 2 - 1024, "two blocks an SM");
  cudaError_t err = allow_smem(ssd_scan_bwd_kernel_mma<P, N>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_scan_bwd_kernel_mma<P, N><<<grid, kThreadsMma, smem, stream>>>(p);
  return cudaGetLastError();
}

// fp32 takes the FMA kernel, bf16 the tensor-core kernel
template <typename T, int P, int N>
cudaError_t launch_for(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>)
    return launch<T, P, N>(p, stream);
  else
    return launch_mma<P, N>(p, stream);
}

template <typename T, int P>
cudaError_t dispatch_n(int n, const Params& p, cudaStream_t stream) {
  switch (n) {
    case 16: return launch_for<T, P, 16>(p, stream);
    case 32: return launch_for<T, P, 32>(p, stream);
    case 64: return launch_for<T, P, 64>(p, stream);
    case 128: return launch_for<T, P, 128>(p, stream);
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

// Dynamic shared memory a block and blocks an SM of the kernel that a
// launch at (P, N) in dtype T takes.
template <typename T, int P, int N>
cudaError_t occupancy_of(int* smem, int* blocks) {
  if constexpr (std::is_same_v<T, float>) {
    *smem = static_cast<int>(sizeof(float) * smem_floats<P, N>());
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_bwd_kernel<T, P, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ssd_scan_bwd_kernel<T, P, N>, kThreads, *smem);
  } else {
    *smem = smem_bytes_mma<P, N>();
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_bwd_kernel_mma<P, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ssd_scan_bwd_kernel_mma<P, N>, kThreadsMma, *smem);
  }
}

template <typename T>
cudaError_t occupancy_any(int pdim, int n, int* smem, int* blocks) {
  switch (pdim * 1000 + n) {
    case 32016: return occupancy_of<T, 32, 16>(smem, blocks);
    case 32032: return occupancy_of<T, 32, 32>(smem, blocks);
    case 32064: return occupancy_of<T, 32, 64>(smem, blocks);
    case 32128: return occupancy_of<T, 32, 128>(smem, blocks);
    case 64016: return occupancy_of<T, 64, 16>(smem, blocks);
    case 64032: return occupancy_of<T, 64, 32>(smem, blocks);
    case 64064: return occupancy_of<T, 64, 64>(smem, blocks);
    case 64128: return occupancy_of<T, 64, 128>(smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The dynamic shared memory (bytes) a block of the backward kernel for
// dtype (0 = float32, 1 = bfloat16) at head dim P and state dim N takes,
// and how many such blocks fit an SM of the current device.  Returns the
// CUDA error code (0 = success).
extern "C" int ssd_scan_bwd_occupancy(int dtype, int P, int N, int* smem,
                                      int* blocks) {
  if (dtype == 0) return occupancy_any<float>(P, N, smem, blocks);
  if (dtype == 1) return occupancy_any<__nv_bfloat16>(P, N, smem, blocks);
  return cudaErrorInvalidValue;
}

// dtype (of x, b, c, dy and dx): 0 = float32, 1 = bfloat16; everything
// else is float32.  x, dy, dx (B, H, L, P), dt, ddt (B, H, L), a (H,),
// b and c (B, L, N): strides in elements, the last stride of x, b, c, dy
// and dx must be 1.  h_in (null for a zero initial state), dh_out (the
// cotangent of the final state; null for zero) and dh_in (written when
// h_in is not null) are contiguous (B, H, P, N); states is a contiguous
// scratch of B H ceil(L / 64) P N floats, in a layout of the kernel's own;
// da (B, H) and db, dc (B, H, L, N)
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
  // the bf16 kernel's copy width: the largest of 8, 4, 2 elements that
  // divides the pointers and the B/H/L strides of x, b, c and dy
  unsigned long long vbits = 0;
  for (const void* ptr : {x, b, c, dy})
    vbits |= reinterpret_cast<uintptr_t>(ptr) / 2;
  for (long long st : {x_sb, x_sh, x_sl, b_sb, b_sl, c_sb, c_sl, dy_sb,
                       dy_sh, dy_sl})
    vbits |= static_cast<unsigned long long>(st);
  p.vec = vbits % 8 == 0 ? 8 : vbits % 4 == 0 ? 4 : vbits % 2 == 0 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(P, N, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(P, N, p, s);
  return cudaErrorInvalidValue;
}
