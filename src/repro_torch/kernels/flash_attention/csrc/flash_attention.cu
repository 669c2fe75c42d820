// Flash attention forward for Hopper (sm_90a), built by kernels/build.py
// into a shared library with a plain C interface and called through ctypes
// from kernels/flash_attention/ops.py.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
//   (pl.pallas_call over the body _kernel; wrapper ops.py::flash_attention).
// It computes the same function, not the same blocks: online-softmax
// attention over KV tiles with the running max, sum and accumulator in
// fp32; causal mask, sliding window, tanh softcap; GQA (q-head h reads KV
// head h / (H / KV)); the finite -1e30 mask sentinel and the max(l, 1e-30)
// clamp of the reference; scale fixed at D ** -0.5.
//
// Design.  The TPU kernel's sequential grid axis over KV tiles becomes a
// loop inside one thread block.  One block per (q tile of 64 rows, q head,
// batch); 4 warps of 16 query rows each.  Per KV tile of 32 keys the block
// stages Q (once), K and V in shared memory as fp32; lane j of a warp owns
// key j of the tile for the scores and the softmax (row max and sum by warp
// shuffles), and output dims lane + 32 c for P V.  The running m, l and acc
// live in registers.  Ragged Sq/Sk edges are masked in the kernel (no
// padding copy); the loop runs only over the live tiles of the causal and
// window masks.  Inputs are read through the (B, H, S, D) strides they come
// with (last stride 1), so transposed views need no copy.  bf16 or fp32 in,
// output in the input's type.  q tiles are walked longest-first so the
// causal tail does not straggle.
//
// What bounds it.  At the serving shape (B 8, H 32, S 512, D 128, causal,
// bf16) the function moves ~134 MB (q, k, v read once, o written once) and
// does ~17 GFLOP: ~40 us at 3.35 TB/s against ~17 us at 989 TFLOP/s of bf16
// tensor cores, so the function is memory-bound.  This kernel is not: it
// does its products as scalar fp32 FMAs (67 TFLOP/s peak, ~0.3 ms for the
// same work) and re-reads shared memory for every FMA pair, so the FMA
// pipe and shared-memory bandwidth bound it, many times above the bound.
//
// What the simple design leaves on the table: tensor cores (mma.sync or
// wgmma on bf16 tiles), TMA / cp.async loads double-buffered under compute,
// bf16 tiles in shared memory (half the bytes), one K/V tile feeding the
// whole GQA group, and 16-byte global loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 64 query rows per block
constexpr int kBlockKV = 32;                    // one key per lane
constexpr float kNegInf = -1e30f;               // finite, as the reference

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KVH, Sq, Sk;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // q [kBlockQ][D], k [kBlockKV][D + 4], v [kBlockKV][D],
  // p [kWarps][kRowsPerWarp][kBlockKV]; all fp32
  return sizeof(float) * (kBlockQ * D + kBlockKV * (D + 4) + kBlockKV * D +
                          kWarps * kRowsPerWarp * kBlockKV);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  // K rows padded by 4 floats: lanes reading float4s of 8 different rows
  // hit 8 different bank quads.
  constexpr int KS = D + 4;
  constexpr int NC = D / 32;  // output dims per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * D;
  float* v_s = k_s + kBlockKV * KS;
  float* p_s = v_s + kBlockKV * D;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_start = qt * kBlockQ;
  const int q_end = q_start + kBlockQ - 1;
  const int row0 = warp * kRowsPerWarp;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q_start + r;
    q_s[i] = s < p.Sq ? to_float(qg[s * p.q_ss + d]) : 0.f;
  }

  // Live KV range of this q tile: the same tiles the reference's liveness
  // test keeps (kv_start < Sk, kv_start <= q_end, q_start - kv_end < window).
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_end + 1);
  const int kv_lo = p.window > 0 ? max(0, q_start - p.window + 1) : 0;
  const int t_lo = kv_lo / kBlockKV;
  const int t_hi = (kv_hi + kBlockKV - 1) / kBlockKV;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int kv_start = t * kBlockKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBlockKV * D; i += kThreads) {
      const int r = i / D, d = i % D, s = kv_start + r;
      const bool in = s < p.Sk;  // zero the ragged edge: 0 * garbage = NaN
      k_s[r * KS + d] = in ? to_float(kg[s * p.k_ss + d]) : 0.f;
      v_s[i] = in ? to_float(vg[s * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores: lane owns key kv_start + lane, for the warp's 16 rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(q_s + (row0 + r) * D)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // mask and online softmax, one row at a time across the warp
    const int kp = kv_start + lane;
    float* p_w = p_s + row0 * kBlockKV;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qp = q_start + row0 + r;
      float x = s[r] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      bool live = kp < p.Sk;
      if (p.causal) live = live && kp <= qp;
      if (p.window > 0) live = live && qp - kp < p.window;
      x = live ? x : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float pr = expf(x - m_new);
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      p_w[r * kBlockKV + lane] = pr;
    }
    __syncwarp();

    // acc += P V: lane owns output dims lane + 32 c
#pragma unroll 2
    for (int j4 = 0; j4 < kBlockKV / 4; ++j4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[jj][c] = v_s[(j4 * 4 + jj) * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pp =
            reinterpret_cast<const float4*>(p_w + r * kBlockKV)[j4];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[r][c] = fmaf(pp.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(pp.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(pp.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(pp.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qp = q_start + row0 + r;
    if (qp < p.Sq) {
      const float lv = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        store(og + qp * p.o_ss + lane + 32 * c, acc[r][c] / lv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// (head-dim) stride of q, k, v and o must be 1.  scale is D ** -0.5 as the
// caller rounds it to fp32.  Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KVH, int Sq, int Sk, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float softcap,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(D, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, p, s);
  return cudaErrorInvalidValue;
}
