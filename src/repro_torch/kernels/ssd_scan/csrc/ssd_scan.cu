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
// VMEM scratch and drops it).  The state starts at zero, or at a given
// initial state (a prefill that continues a cached one); the TPU kernel
// always starts at zero.  Inputs are read through the strides they come
// with (last stride 1): in the model x, B and C are column slices of the
// conv output and dt is a transposed (B, L, H) tensor, so nothing is
// copied.  Ragged L is masked here (positions past L count as dt = 0, so
// the final state is the state at L); nothing is padded.
//
// What bounds it.  At the serving shape of mamba2-370m (B 8, H 32, L 2048,
// P 64, N 128, bf16) the function moves 153 MB (x, dt, B, C read once, y
// and the final state written once): 46 us at 3.35 TB/s, against ~24 GFLOP
// of the chunked form at Q 64 over causal pairs, 24 us at 989 TFLOP/s of
// bf16 tensor cores.  So the function is bound by bytes.
//
// Two kernels, chosen by the dtype (the wrapper counts launches of each):
//
// ssd_scan_kernel_mma (bf16: the serving path).  One block of 4 warps per
// (head, batch) loops over chunks of Q = 64 positions in order; warp w owns
// chunk rows 16 w .. 16 w + 15.  Every product runs on tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 accumulate).  Per chunk:
//   1. x, B and C are staged in shared memory as bf16 by cp.async (16 B
//      copies where pointers and strides allow, else 8, 4 or 2 B; rows
//      past L are zero-filled); warp 0 reads dt and scans la = cumsum(dt a)
//      as the fp32 kernel does;
//   2. y = exp(la) o (C h^T) + M' x, with C's A fragments loaded once by
//      ldmatrix, h read as two bf16 planes hi + lo (two MMAs), S = C B^T
//      per 16 x 16 tile at or below the diagonal, and M' = S o causal
//      exp(la_i - la_j) o dt_j built in registers from S's accumulators
//      (the C fragment of two n-tiles is the A fragment of one k-step, as
//      in FlashAttention-2), split into bf16 hi + lo (two MMAs) against x
//      by ldmatrix.trans;
//   3. B is rewritten in place as B' = B o dt exp(la_Q - la) hi, and C's
//      buffer takes B' lo (C is in registers by then);
//   4. h <- exp(la_Q) h + x^T B' (hi and lo: two MMAs), with h (P x N fp32)
//      held in registers across chunks as the MMA's accumulator (warp w:
//      16 of the P rows, N / (4 / (P / 16)) of the columns), then written
//      to shared memory as the hi and lo planes step 2 reads.
// x, B and C enter every product exactly (bf16 x bf16, fp32 sums); the
// three fp32 operands (M', h, B') are split into hi + lo, which keeps
// them to ~2^-17 and costs twice the tensor work on those three products
// (~45 GFLOP at the serving shape, skipped tiles above the diagonal not
// counted).  A plain bf16 rounding (2^-9) of any of them is ~2^-9 of its
// term, too coarse for the state's tolerance of 1e-4 of its max.  78 KB of
// shared memory a block at P 64, N 128, so 2 blocks fit an SM and the 256
// blocks of the serving grid run at once.  The function depends on Q only
// through the order of fp32 sums.
//
// ssd_scan_kernel (fp32).  One block of 256 threads per (head, batch) with
// the state in shared memory; every product a scalar fp32 FMA on fp32
// operands (nothing is rounded to bf16).  Per chunk: stage x, B, C as
// fp32; M = (C B^T) o causal exp(la_i - la_j), x <- x dt; y = M (x dt) +
// exp(la) o (C h^T); h <- exp(la_Q) h + (x dt o exp(la_Q - la))^T B.  One
// block of 8 warps fits an SM (136 KB of shared memory).
//
// What is left: wgmma (the four products are small chained GEMMs of 64
// rows, a warpgroup's tile), prefetch of the next chunk under the
// current chunk's products, B and C staged once for all heads of a batch
// row (they do not depend on the head, so the 32 heads each re-read them
// from L2), and a backward pass for training.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

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
  int vec;  // elements per copy of the bf16 kernel: 8, 4, 2 or 1
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
  cudaError_t err = allow_smem(ssd_scan_kernel<T, P, N>,
                               static_cast<int>(smem), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- ssd_scan_kernel_mma: bf16 on mma.sync tensor cores ----

constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
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

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// Shared memory in bytes.  Rows of x (P + 8), B, C and the h planes
// (N + 8 elements) are padded by 16 B, so the 8 rows an ldmatrix reads
// fall in 8 different 16 B bank groups.
template <int P, int N>
constexpr int smem_bytes_mma() {
  return 2 * (kQ * (P + 8) + 2 * kQ * (N + 8) + 2 * P * (N + 8))
         + 4 * 4 * kQ;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreadsMma, 2)
    ssd_scan_kernel_mma(const __grid_constant__ Params p) {
  constexpr int XS = P + 8;               // row stride of x_s
  constexpr int NS = N + 8;               // of b_s, c_s and the h planes
  constexpr int KN = N / 16;              // k-steps over the state dim
  constexpr int PT = P / 8;               // 8-wide tiles of the head dim
  constexpr int RG = P / 16;              // 16-row groups of the state
  constexpr int NW = N * RG / kWarpsMma;  // state columns a warp holds
  constexpr int NTW = NW / 8;             // ... in 8-wide tiles
  static_assert(P % 16 == 0 && N % 16 == 0 && kWarpsMma % RG == 0 &&
                    NW % 8 == 0 && (NTW % 2 == 0 || NTW == 1),
                "P, N");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // [kQ][XS]
  bf16* b_s = x_s + kQ * XS;     // [kQ][NS]: B, then B' hi
  bf16* c_s = b_s + kQ * NS;     // [kQ][NS]: C, then B' lo
  bf16* hh_s = c_s + kQ * NS;    // [P][NS]: bf16(h)
  bf16* hl_s = hh_s + P * NS;    // [P][NS]: bf16(h - bf16(h))
  float* la_s = reinterpret_cast<float*>(hl_s + P * NS);  // cumsum(dt a)
  float* el_s = la_s + kQ;       // exp(la)
  float* dt_s = el_s + kQ;       // dt
  float* w_s = dt_s + kQ;        // dt exp(la_Q - la)

  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float a = p.a[hh];

  const bf16* xg = static_cast<const bf16*>(p.x) + bb * p.x_sb + hh * p.x_sh;
  const float* dtg = p.dt + bb * p.dt_sb + hh * p.dt_sh;
  const bf16* bg = static_cast<const bf16*>(p.b) + bb * p.b_sb;
  const bf16* cg = static_cast<const bf16*>(p.c) + bb * p.c_sb;
  bf16* yg = static_cast<bf16*>(p.y) + bb * p.y_sb + hh * p.y_sh;
  const long long hoff = (static_cast<long long>(bb) * p.H + hh) * P * N;

  // The state this warp holds: rows pr0 + g (+ 8), columns nc0 + 8 nt + 2 t
  // (+ 1), in the MMA's accumulator layout.
  const int pr0 = 16 * (warp % RG), nc0 = NW * (warp / RG);
  float hacc[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = pr0 + g + 8 * (e / 2);
      const int col = nc0 + 8 * nt + 2 * t + e % 2;
      hacc[nt][e] = p.h_in != nullptr ? p.h_in[hoff + row * N + col] : 0.f;
    }
  auto store_planes = [&]() {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int at = (pr0 + g + 8 * half) * NS + nc0 + 8 * nt + 2 * t;
        uint32_t hi, lo;
        split(hacc[nt][2 * half], hacc[nt][2 * half + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(hh_s + at) = hi;
        *reinterpret_cast<uint32_t*>(hl_s + at) = lo;
      }
  };
  store_planes();

  // ldmatrix lane roles: the lane's row within an 8 x 8 matrix, and which
  // of the four matrices of an x4 it addresses
  const int lr = lane & 7, m_lo = (lane >> 3) & 1, m_hi = lane >> 4;
  const int r0 = 16 * warp;  // this warp's chunk rows
  const int n_chunks = (p.L + kQ - 1) / kQ;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int l0 = ch * kQ;
    __syncthreads();  // the last chunk is done with x_s, b_s, c_s, scalars

    // 1. stage the chunk; dt, la, exp(la), dt exp(la_Q - la) in warp 0
    stage_any<P>(p.vec, x_s, XS, xg, p.x_sl, l0, p.L, tid);
    stage_any<N>(p.vec, b_s, NS, bg, p.b_sl, l0, p.L, tid);
    stage_any<N>(p.vec, c_s, NS, cg, p.c_sl, l0, p.L, tid);
    if (warp == 0) {
      // lane owns positions 2 lane and 2 lane + 1: sum its pair, then an
      // inclusive scan of the pair sums across the warp
      const int j0 = 2 * lane;
      const float d0 = l0 + j0 < p.L ? dtg[(l0 + j0) * p.dt_sl] : 0.f;
      const float d1 = l0 + j0 + 1 < p.L ? dtg[(l0 + j0 + 1) * p.dt_sl]
                                         : 0.f;
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
      la_s[j0] = la0;
      la_s[j0 + 1] = la1;
      el_s[j0] = expf(la0);
      el_s[j0 + 1] = expf(la1);
      dt_s[j0] = d0;
      dt_s[j0 + 1] = d1;
      w_s[j0] = d0 * expf(la_q - la0);
      w_s[j0 + 1] = d1 * expf(la_q - la1);
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. y = exp(la) o (C h^T) + M' x on this warp's 16 rows
    uint32_t cf[KN][4];  // C's A fragments: rows r0.., k-step ks
#pragma unroll
    for (int ks = 0; ks < KN; ++ks)
      ldsm_x4(cf[ks], smem_u32(c_s + (r0 + lr + 8 * m_lo) * NS + 16 * ks +
                               8 * m_hi));
    float yacc[PT][4];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KN; ++ks)
#pragma unroll
      for (int pt = 0; pt < PT; pt += 2) {
        const int at = (8 * (pt + m_hi) + lr) * NS + 16 * ks + 8 * m_lo;
        uint32_t hb[4], hl[4];
        ldsm_x4(hb, smem_u32(hh_s + at));
        ldsm_x4(hl, smem_u32(hl_s + at));
        mma(yacc[pt], cf[ks], hb[0], hb[1]);
        mma(yacc[pt], cf[ks], hl[0], hl[1]);
        mma(yacc[pt + 1], cf[ks], hb[2], hb[3]);
        mma(yacc[pt + 1], cf[ks], hl[2], hl[3]);
      }
    const int i0 = r0 + g, i1 = i0 + 8;
    {
      const float e0 = el_s[i0], e1 = el_s[i1];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        yacc[pt][0] *= e0;
        yacc[pt][1] *= e0;
        yacc[pt][2] *= e1;
        yacc[pt][3] *= e1;
      }
    }
    const float la_i0 = la_s[i0], la_i1 = la_s[i1];
    // 16-column tiles at or below the diagonal: kt <= warp
#pragma unroll
    for (int kt = 0; kt < kWarpsMma; ++kt) {
      if (kt > warp) break;
      float s[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[h][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(b_s + (16 * kt + 8 * m_hi + lr) * NS + 16 * ks +
                             8 * m_lo));
        mma(s[0], cf[ks], bf[0], bf[1]);
        mma(s[1], cf[ks], bf[2], bf[3]);
      }
      // M' = S o causal exp(la_i - la_j) o dt_j; the exponent is 0 off the
      // causal pairs, so there is no inf * 0
      uint32_t mh[4], ml[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 16 * kt + 8 * h + 2 * t;
        const float la_j0 = la_s[j], la_j1 = la_s[j + 1];
        const float dt_j0 = dt_s[j], dt_j1 = dt_s[j + 1];
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1;
          const int jj = j + e % 2;
          const bool causal = jj <= i;
          const float gap = causal ? (e < 2 ? la_i0 : la_i1) -
                                         (e % 2 ? la_j1 : la_j0)
                                   : 0.f;
          m[e] = causal ? s[h][e] * expf(gap) * (e % 2 ? dt_j1 : dt_j0) : 0.f;
        }
        split(m[0], m[1], mh[2 * h], ml[2 * h]);
        split(m[2], m[3], mh[2 * h + 1], ml[2 * h + 1]);
      }
#pragma unroll
      for (int pt = 0; pt < PT; pt += 2) {
        uint32_t xb[4];
        ldsm_x4_t(xb, smem_u32(x_s + (16 * kt + 8 * m_lo + lr) * XS +
                               8 * (pt + m_hi)));
        mma(yacc[pt], mh, xb[0], xb[1]);
        mma(yacc[pt], ml, xb[0], xb[1]);
        mma(yacc[pt + 1], mh, xb[2], xb[3]);
        mma(yacc[pt + 1], ml, xb[2], xb[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = l0 + (half ? i1 : i0);
      if (l < p.L) {
#pragma unroll
        for (int pt = 0; pt < PT; ++pt)
          *reinterpret_cast<__nv_bfloat162*>(yg + l * p.y_sl + 8 * pt +
                                             2 * t) =
              __floats2bfloat162_rn(yacc[pt][2 * half],
                                    yacc[pt][2 * half + 1]);
      }
    }
    __syncthreads();  // every warp is done with B, C and the h planes

    // 3. B' = B o dt exp(la_Q - la): hi over B in b_s, lo into c_s
    for (int i = tid; i < kQ * N / 2; i += kThreadsMma) {
      const int j = i / (N / 2), at = j * NS + 2 * (i % (N / 2));
      const float w = w_s[j];
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b_s + at));
      uint32_t hi, lo;
      split(bv.x * w, bv.y * w, hi, lo);
      *reinterpret_cast<uint32_t*>(b_s + at) = hi;
      *reinterpret_cast<uint32_t*>(c_s + at) = lo;
    }
    __syncthreads();

    // 4. h <- exp(la_Q) h + x^T B' on this warp's part of the state
    {
      const float e_q = el_s[kQ - 1];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[nt][e] *= e_q;
#pragma unroll
      for (int kt = 0; kt < kQ / 16; ++kt) {
        uint32_t xa[4];  // A = x^T: rows pr0.., k = positions 16 kt..
        ldsm_x4_t(xa, smem_u32(x_s + (16 * kt + 8 * m_hi + lr) * XS + pr0 +
                               8 * m_lo));
        const int jrow = 16 * kt + 8 * m_lo + lr;
        if constexpr (NTW == 1) {
          uint32_t bhi[2], blo[2];
          ldsm_x2_t(bhi, smem_u32(b_s + jrow * NS + nc0));
          ldsm_x2_t(blo, smem_u32(c_s + jrow * NS + nc0));
          mma(hacc[0], xa, bhi[0], bhi[1]);
          mma(hacc[0], xa, blo[0], blo[1]);
        } else {
#pragma unroll
          for (int nt = 0; nt < NTW; nt += 2) {
            const int at = jrow * NS + nc0 + 8 * (nt + m_hi);
            uint32_t bhi[4], blo[4];
            ldsm_x4_t(bhi, smem_u32(b_s + at));
            ldsm_x4_t(blo, smem_u32(c_s + at));
            mma(hacc[nt], xa, bhi[0], bhi[1]);
            mma(hacc[nt], xa, blo[0], blo[1]);
            mma(hacc[nt + 1], xa, bhi[2], bhi[3]);
            mma(hacc[nt + 1], xa, blo[2], blo[3]);
          }
        }
      }
    }
    store_planes();  // read by the next chunk's C h^T, after its barrier
  }

  float* hg = p.h_out + hoff;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hg[(pr0 + g + 8 * (e / 2)) * N + nc0 + 8 * nt + 2 * t + e % 2] =
          hacc[nt][e];
}

template <int P, int N>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  constexpr int smem = smem_bytes_mma<P, N>();
  cudaError_t err = allow_smem(ssd_scan_kernel_mma<P, N>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_scan_kernel_mma<P, N><<<grid, kThreadsMma, smem, stream>>>(p);
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

}  // namespace

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16; dt and a are
// float32.  x (B, H, L, P), dt (B, H, L), a (H,), b and c (B, L, N),
// y (B, H, L, P): strides in elements, the last stride of x, b, c and y
// must be 1.  h_in (the initial state; null for zero) and h_out are
// contiguous (B, H, P, N) float32 buffers, and must not overlap.  vec is
// the bf16 kernel's copy width in elements (8, 4, 2 or 1): it must divide
// the pointers of x, b, c and their B/H/L strides.  Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int ssd_scan_fwd(
    const void* x, const float* dt, const float* a, const void* b,
    const void* c, const float* h_in, void* y, float* h_out, int dtype,
    int B, int H, int L, int P, int N, long long x_sb, long long x_sh,
    long long x_sl, long long dt_sb, long long dt_sh, long long dt_sl, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, long long y_sb,
    long long y_sh, long long y_sl, int vec, void* stream) {
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
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(P, N, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(P, N, p, s);
  return cudaErrorInvalidValue;
}
