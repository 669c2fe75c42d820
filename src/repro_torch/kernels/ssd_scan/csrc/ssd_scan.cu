// Mamba2 SSD chunked scan for Hopper (sm_90a), built by kernels/build.py
// into a shared library with a plain C interface and called through ctypes
// from kernels/ssd_scan/ops.py.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py:72 ssd_scan_kernel
//   (pl.pallas_call over the body _kernel; wrapper ops.py::ssd_scan).
// It computes the same function, not the same blocks: per head, the
// recurrence h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t, y_t = h_t C_t,
// in chunked form with fp32 arithmetic for fp32 and bf16 inputs, and it
// also writes the state after the last position (the TPU kernel keeps it in
// VMEM scratch and drops it).
//
// Design.  One block of 256 threads per (head, batch); the TPU kernel's
// sequential chunk axis becomes a loop inside the block, and the state
// h (P x N fp32, 32 KB at P 64, N 128) lives in shared memory for the whole
// sequence.  It starts at zero, or at a given initial state (a prefill that
// continues a cached one); the TPU kernel always starts at zero.  The tile length is Q = 64: a Q x Q fp32 score tile at the
// model's chunk of 256 would be 256 KB, more than a block's 227 KB.  The
// function depends on Q only through the order of fp32 sums.  Per chunk:
//   1. stage x, B, C in shared memory as fp32 (rows past L are zero), and
//      in warp 0 dt, la = cumsum(dt a) (warp scan), exp(la) and
//      exp(la_Q - la); positions past L count as dt = 0, so the final
//      state is the state at L;
//   2. M = (C B^T) o exp(la_i - la_j) on causal pairs (the exponent is
//      masked to 0 before exp elsewhere, so no inf * 0), and x <- x dt;
//   3. y = M (x dt) + exp(la) o (C h^T), written in x's type; the intra
//      product runs only over the causal columns of each thread's rows;
//   4. h <- exp(la_Q) h + (x dt o exp(la_Q - la))^T B.
// Every product is a scalar fp32 FMA from shared memory, each thread
// accumulating a 4 x 4 (steps 2, 3) or rows x 8 (step 4) register tile.
// Inputs are read through the strides they come with (last stride 1): in the
// model x, B and C are column slices of the conv output and dt is a
// transposed (B, L, H) tensor, so nothing is copied.  Ragged L is masked
// here; nothing is padded.
//
// What bounds it.  At the serving shape of mamba2-370m (B 8, H 32, L 2048,
// P 64, N 128, bf16) the function moves 153 MB (x, dt, B, C read once, y
// and the final state written once): 46 us at 3.35 TB/s, against ~24 GFLOP
// of the chunked form at Q 64 over causal pairs, 24 us at 989 TFLOP/s of
// bf16 tensor cores.  So the function is bound by bytes.  This kernel is
// not: it does ~28 GFLOP as scalar fp32 FMAs (the full Q x Q score tile
// included), at least 0.42 ms on the 67 TFLOP/s fp32 pipe, re-reads shared
// memory for every few FMAs, runs one block of 8 warps per SM (136 KB of
// shared memory) in about two waves of 132 SMs, and does not overlap a
// chunk's loads with the previous chunk's compute.
//
// What the simple design leaves on the table: tensor cores (C B^T, the
// intra product and the state update are small GEMMs: mma.sync or wgmma on
// bf16 tiles), B and C staged once for all heads of a batch row (they do
// not depend on the head), cp.async / TMA double buffering of the next
// chunk, and 16-byte global loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;        // positions per chunk
constexpr int kQS = kQ + 4;   // row stride of the score tile

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* h_in;  // initial state, contiguous (B, H, P, N), or null
  void* y;
  float* h_out;
  int B, H, L;
  long long x_sb, x_sh, x_sl;
  long long dt_sb, dt_sh, dt_sl;
  long long b_sb, b_sl;
  long long c_sb, c_sl;
  long long y_sb, y_sh, y_sl;
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

// Shared memory in floats.  Rows of B, C and h are padded by 4 floats so
// that float4 reads of 8 different rows hit 8 different bank quads.
template <int P, int N>
constexpr int smem_floats() {
  return P * (N + 4)        // h
         + kQ * P           // x, then x dt
         + 2 * kQ * (N + 4)  // B, C
         + kQ * kQS         // masked scores M
         + 4 * kQ;          // dt, la, exp(la), exp(la_Q - la)
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(Params p) {
  static_assert(P % 16 == 0 && N % 8 == 0, "P, N");
  constexpr int NS = N + 4;
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;             // [P][NS]
  float* x_s = h_s + P * NS;     // [kQ][P]
  float* b_s = x_s + kQ * P;     // [kQ][NS]
  float* c_s = b_s + kQ * NS;    // [kQ][NS]
  float* m_s = c_s + kQ * NS;    // [kQ][kQS]
  float* dt_s = m_s + kQ * kQS;  // [kQ]
  float* la_s = dt_s + kQ;       // cumsum(dt a) within the chunk
  float* el_s = la_s + kQ;       // exp(la)
  float* w_s = el_s + kQ;        // exp(la_Q - la)

  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = p.a[hh];

  const T* xg = static_cast<const T*>(p.x) + bb * p.x_sb + hh * p.x_sh;
  const float* dtg = p.dt + bb * p.dt_sb + hh * p.dt_sh;
  const T* bg = static_cast<const T*>(p.b) + bb * p.b_sb;
  const T* cg = static_cast<const T*>(p.c) + bb * p.c_sb;
  T* yg = static_cast<T*>(p.y) + bb * p.y_sb + hh * p.y_sh;

  const float* hin = p.h_in == nullptr
      ? nullptr
      : p.h_in + (static_cast<long long>(bb) * p.H + hh) * P * N;
  for (int i = tid; i < P * NS; i += kThreads) {
    const int r = i / NS, n = i % NS;
    h_s[i] = hin != nullptr && n < N ? hin[r * N + n] : 0.f;
  }

  const int n_chunks = (p.L + kQ - 1) / kQ;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int l0 = ch * kQ;
    __syncthreads();  // the previous chunk is done with x_s, b_s and h_s

    // 1. stage the chunk; rows past L are zero
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int j = i / P, pp = i % P, l = l0 + j;
      x_s[i] = l < p.L ? to_float(xg[l * p.x_sl + pp]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int j = i / N, n = i % N, l = l0 + j;
      const bool in = l < p.L;
      b_s[j * NS + n] = in ? to_float(bg[l * p.b_sl + n]) : 0.f;
      c_s[j * NS + n] = in ? to_float(cg[l * p.c_sl + n]) : 0.f;
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
    __syncthreads();

    // 2. M = (C B^T) o causal exp(la_i - la_j); rows ti + 16 r, columns
    //    tj + 16 c
    {
      const int ti = tid / 16, tj = tid % 16;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[r][cc] = 0.f;
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
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int j = tj + 16 * cc;
          const bool causal = j <= i;
          const float gap = causal ? la_s[i] - la_s[j] : 0.f;
          m_s[i * kQS + j] = causal ? s[r][cc] * expf(gap) : 0.f;
        }
      }
    }
    for (int i = tid; i < kQ * P; i += kThreads) x_s[i] *= dt_s[i / P];
    __syncthreads();

    // 3. y = M (x dt) + exp(la) o (C h^T); rows 4 ti .. 4 ti + 3, columns
    //    tp + 16 c
    {
      constexpr int TP = P / 16;
      const int ti = tid / 16, tp = tid % 16;
      float acc[4][TP], inter[4][TP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < TP; ++cc) acc[r][cc] = inter[r][cc] = 0.f;
      // M is zero above the diagonal: rows up to 4 ti + 3 need j4 <= ti
      for (int j4 = 0; j4 <= ti; ++j4) {
        float m[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v =
              reinterpret_cast<const float4*>(m_s + (4 * ti + r) * kQS)[j4];
          m[r][0] = v.x;
          m[r][1] = v.y;
          m[r][2] = v.z;
          m[r][3] = v.w;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float xv[TP];
#pragma unroll
          for (int cc = 0; cc < TP; ++cc)
            xv[cc] = x_s[(4 * j4 + jj) * P + tp + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < TP; ++cc)
              acc[r][cc] = fmaf(m[r][jj], xv[cc], acc[r][cc]);
        }
      }
#pragma unroll 4
      for (int n4 = 0; n4 < N / 4; ++n4) {
        float4 cv[4], hv[TP];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = reinterpret_cast<const float4*>(c_s + (4 * ti + r) * NS)[n4];
#pragma unroll
        for (int cc = 0; cc < TP; ++cc)
          hv[cc] =
              reinterpret_cast<const float4*>(h_s + (tp + 16 * cc) * NS)[n4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < TP; ++cc)
            inter[r][cc] = dot4(cv[r], hv[cc], inter[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r, l = l0 + i;
        if (l < p.L) {
          const float e = el_s[i];
#pragma unroll
          for (int cc = 0; cc < TP; ++cc)
            store(yg + l * p.y_sl + tp + 16 * cc,
                  fmaf(e, inter[r][cc], acc[r][cc]));
        }
      }
    }
    __syncthreads();

    // 4. h <- exp(la_Q) h + (x dt o exp(la_Q - la))^T B; rows tp + PT r,
    //    columns 4 tn .. 4 tn + 3 and N / 2 + 4 tn .. N / 2 + 4 tn + 3
    {
      constexpr int NT = N / 8;
      constexpr int PT = kThreads / NT;
      constexpr int RP = PT < P ? P / PT : 1;
      static_assert(PT >= P || P % PT == 0, "rows per thread");
      const int tn = tid % NT, tp = tid / NT;
      if (tp < P) {
        const float e_q = el_s[kQ - 1];
        float acc[RP][8];
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float* hrow = h_s + (tp + PT * r) * NS;
          const float4 h0 = reinterpret_cast<const float4*>(hrow)[tn];
          const float4 h1 = reinterpret_cast<const float4*>(hrow + N / 2)[tn];
          acc[r][0] = e_q * h0.x;
          acc[r][1] = e_q * h0.y;
          acc[r][2] = e_q * h0.z;
          acc[r][3] = e_q * h0.w;
          acc[r][4] = e_q * h1.x;
          acc[r][5] = e_q * h1.y;
          acc[r][6] = e_q * h1.z;
          acc[r][7] = e_q * h1.w;
        }
#pragma unroll 4
        for (int j = 0; j < kQ; ++j) {
          const float* brow = b_s + j * NS;
          const float4 b0 = reinterpret_cast<const float4*>(brow)[tn];
          const float4 b1 = reinterpret_cast<const float4*>(brow + N / 2)[tn];
          const float wj = w_s[j];
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const float xw = x_s[j * P + tp + PT * r] * wj;
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
  __syncthreads();

  float* hg = p.h_out + (static_cast<long long>(bb) * p.H + hh) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    hg[i] = h_s[(i / N) * NS + i % N];
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(p);
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

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16; dt and a are
// float32.  x (B, H, L, P), dt (B, H, L), a (H,), b and c (B, L, N),
// y (B, H, L, P): strides in elements, the last stride of x, b, c and y
// must be 1.  h_in (the initial state; null for zero) and h_out are
// contiguous (B, H, P, N) float32 buffers, and must not overlap.  Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int ssd_scan_fwd(
    const void* x, const float* dt, const float* a, const void* b,
    const void* c, const float* h_in, void* y, float* h_out, int dtype,
    int B, int H, int L, int P, int N, long long x_sb, long long x_sh,
    long long x_sl, long long dt_sb, long long dt_sh, long long dt_sl, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, long long y_sb,
    long long y_sh, long long y_sl, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || B > 65535) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dt = dt;
  p.a = a;
  p.b = b;
  p.c = c;
  p.h_in = h_in;
  p.y = y;
  p.h_out = h_out;
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
  p.y_sb = y_sb;
  p.y_sh = y_sh;
  p.y_sl = y_sl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(P, N, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(P, N, p, s);
  return cudaErrorInvalidValue;
}
