// Flash attention forward for Hopper (sm_90a), built by kernels/build.py
// into a shared library with a plain C interface and called through ctypes
// from kernels/flash_attention/ops.py.  The backward is in
// flash_attention_bwd.cu.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
//   (pl.pallas_call over the body _kernel; wrapper ops.py::flash_attention).
// It computes the same function, not the same blocks: online-softmax
// attention over KV tiles with the running max, sum and accumulator in
// fp32; causal mask, sliding window, tanh softcap; GQA (q-head h reads KV
// head h / (H / KV)); the finite -1e30 mask sentinel and the max(l, 1e-30)
// clamp of the reference; scale fixed at D ** -0.5.  Any head dim D from 8
// to 256 that is a multiple of 4.
//
// Two kernels, chosen by dtype.  Both run the TPU kernel's sequential KV
// axis as a loop inside one block per (q tile of 64 rows, q head, batch),
// mask ragged Sq/Sk edges themselves (nothing is padded in memory), read
// q, k, v through the (B, H, S, D) strides they come with (the model's
// transposed views are not copied), skip the KV tiles that the causal and
// window masks kill, and walk q tiles longest-first so the causal tail
// does not straggle.
//
// What bounds it.  At the serving shape (B 8, H 32, S 512, D 128, causal,
// bf16) the function moves ~134 MB (q, k, v read once, o written once) and
// does ~17.2 GFLOP: ~40 us at 3.35 TB/s against ~17 us at 989 TFLOP/s of
// bf16 tensor cores, so bytes bound it.
//
// flash_fwd_kernel_mma (bf16: the serving path).  One warpgroup of 4 warps
// (16 query rows each) runs warpgroup MMAs (wgmma, bf16 in, fp32
// accumulate).  Q's A fragments are loaded once by ldmatrix and stay in
// registers; S = Q K^T takes K from shared memory, and its accumulator
// layout is the A operand of P V, so P stays in registers too.  K and V
// tiles (64 keys; 32 above D 128) are double-buffered in shared memory in
// the 128 B swizzled layout wgmma reads, 64-dim panels padded with zeros
// past D; q passes through the second stage on its way to registers.  They come by TMA (one thread asks, an mbarrier says the tile
// landed; rows past Sk and dims past D arrive as zeros) where q, k, v allow
// 16 B copies, else by cp.async (8 B at D 100); tile t + 1 loads while
// tile t is multiplied, one __syncthreads per tile.  The softmax runs on
// the fragments, a row's max and sum across the 4 lanes of a quad.  P is
// kept in fp32 as in the reference: split into P_hi = bf16(P) and P_lo =
// bf16(P - P_hi), both through P V (P is then exact to ~2^-17; Q K^T of
// bf16 operands is exact in fp32 accumulation); without P_lo the result
// misses the bf16 tolerance by 2.3x at the serving shape.  That is 1.5x
// the tensor work of one bf16 P V.  Masks are computed only on tiles that
// need them; the epilogue divides by l and stores bf16 rows through shared
// memory with 16 B (8 B) stores.
//
// flash_fwd_kernel_fma (fp32: the fp32 tests and the fp32 consistency
// run).  Scalar fp32 FMAs: TF32 tensor cores cannot meet 2e-5.  Per KV
// tile of 32 keys the block stages Q (once), K and V in shared memory as
// fp32; lane j of a warp owns key j of the tile for the scores and the
// softmax (row max and sum by warp shuffles), and output dims lane + 32 c
// for P V.  D is padded to a multiple of 32 with zeros.
//
// What is left (PERF.md has the numbers): the softmax does not overlap the
// same warpgroup's wgmma (doing so rewrites S's registers inside an open
// wgmma stage, and ptxas then serializes every wgmma), S's 8 chained
// wgmma wait on each other, and 3 blocks an SM (65 KB of shared memory
// a block at D 128: two K/V stages, q borrowing the second; 165
// registers a thread) hide only part of that: warp specialisation (a
// producer warp, two consumer warpgroups taking turns at the softmax) is
// the next step.  Also left: one K/V tile feeding a whole GQA group
// (tiny-llama KV 4, gemma-2b KV 1; not on the measured path), and the
// backward (flash_attention_bwd.cu) on tensor cores.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // finite, as the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;  // both kernels: 4 warps of 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // 64 query rows per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // (B, H, Sq) fp32: each row's log-sum-exp of its logits (after the scale
  // and the softcap, natural log; -inf where no key is live), for the
  // backward; null when not wanted (serving)
  float* lse;
  int B, H, KVH, Sq, Sk, D;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;
  float softcap, scale;
  int vec;  // bf16 kernel: elements per copy, 8 (16 B) or 4 (8 B)
  // bf16 kernel, vec 8: K and V tiles come by TMA through these maps
  int use_tma;
  CUtensorMap tk, tv;
};

// ---------------------------------------------------------------------------
// fp32: scalar FMA kernel
// ---------------------------------------------------------------------------

constexpr int kFmaRows = 16;     // query rows per warp
constexpr int kFmaBlockKV = 32;  // one key per lane

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

template <int DP>
constexpr size_t fma_smem_bytes() {
  // q [kBlockQ][DP], k [kFmaBlockKV][DP + 4], v [kFmaBlockKV][DP],
  // p [kWarps][kFmaRows][kFmaBlockKV]; all fp32
  return sizeof(float) * (kBlockQ * DP + kFmaBlockKV * (DP + 4) +
                          kFmaBlockKV * DP + kBlockQ * kFmaBlockKV);
}

// DP: D rounded up to a multiple of 32; dims D..DP-1 are zero in shared
// memory and never stored.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel_fma(Params p) {
  // K rows padded by 4 floats: lanes reading float4s of 8 different rows
  // hit 8 different bank quads.
  constexpr int KS = DP + 4;
  constexpr int NC = DP / 32;  // output dims per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * DP;
  float* v_s = k_s + kFmaBlockKV * KS;
  float* p_s = v_s + kFmaBlockKV * DP;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int D = p.D;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_start = qt * kBlockQ;
  const int q_end = q_start + kBlockQ - 1;
  const int row0 = warp * kFmaRows;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, s = q_start + r;
    q_s[i] = s < p.Sq && d < D ? qg[s * p.q_ss + d] : 0.f;
  }

  // Live KV range of this q tile: the same tiles the reference's liveness
  // test keeps (kv_start < Sk, kv_start <= q_end, q_start - kv_end < window).
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_end + 1);
  const int kv_lo = p.window > 0 ? max(0, q_start - p.window + 1) : 0;
  const int t_lo = kv_lo / kFmaBlockKV;
  const int t_hi = (kv_hi + kFmaBlockKV - 1) / kFmaBlockKV;

  float m[kFmaRows], l[kFmaRows], acc[kFmaRows][NC];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int kv_start = t * kFmaBlockKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kFmaBlockKV * DP; i += kThreads) {
      const int r = i / DP, d = i % DP, s = kv_start + r;
      // zero the ragged edge and the padded dims: 0 * garbage = NaN
      const bool in = s < p.Sk && d < D;
      k_s[r * KS + d] = in ? kg[s * p.k_ss + d] : 0.f;
      v_s[i] = in ? vg[s * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // scores: lane owns key kv_start + lane, for the warp's 16 rows
    float s[kFmaRows];
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(q_s + (row0 + r) * DP)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // mask and online softmax, one row at a time across the warp
    const int kp = kv_start + lane;
    float* p_w = p_s + row0 * kFmaBlockKV;
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
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
      p_w[r * kFmaBlockKV + lane] = pr;
    }
    __syncwarp();

    // acc += P V: lane owns output dims lane + 32 c
#pragma unroll 2
    for (int j4 = 0; j4 < kFmaBlockKV / 4; ++j4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[jj][c] = v_s[(j4 * 4 + jj) * DP + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        const float4 pp =
            reinterpret_cast<const float4*>(p_w + r * kFmaBlockKV)[j4];
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
  for (int r = 0; r < kFmaRows; ++r) {
    const int qp = q_start + row0 + r;
    if (qp < p.Sq) {
      const float lv = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < D) og[qp * p.o_ss + lane + 32 * c] = acc[r][c] / lv;
      if (p.lse != nullptr && lane == 0)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] =
            m[r] == kNegInf ? -INFINITY : m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

// DP: D rounded up to a multiple of 16.  The block's 4 warps are one
// warpgroup.
template <int DP>
struct Mma {
  static constexpr int kBlockKV = DP <= 128 ? 64 : 32;
  static constexpr int kDSteps = DP / 16;       // k-steps of Q K^T
  static constexpr int kKeyTiles = kBlockKV / 8;  // 8-key column tiles of S
  static constexpr int kKeySteps = kBlockKV / 16;  // k-steps of P V
  static constexpr int kDimTiles = DP / 8;       // 8-dim column tiles of O
  static constexpr int kPanels = (DP + 63) / 64;  // 64-dim panels
  static constexpr int kPanel = kBlockKV * 64;   // elements of a K/V panel
  static constexpr int kTile = kPanels * kPanel;  // one K or V buffer
  // 2 stages of (K, V) in swizzled panels, and the slack that aligns them
  // to 1 KB (the swizzle's period).  q (64 rows) is read only before the
  // first tile of stage 1 lands and after the last one: it borrows stage
  // 1, and so does the epilogue's staging.
  static_assert(kBlockQ * kPanels * 64 <= 2 * kTile, "q fits stage 1");
  static constexpr size_t kSmemBytes = sizeof(bf16) * 4 * kTile + 1024;
};

// 2^x, flushing results below 2^-126 to zero (P terms that small vanish
// against the row's largest term, which is 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16 or 8) from global to shared memory, or zeros if !in.
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool in, int vec) {
  const int n = in ? 2 * vec : 0;
  if (vec == 8)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) = hi + lo to ~2^-17: hi = bf16(x, y), lo = bf16((x, y) - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// --- warpgroup MMA (wgmma): D (64 x N, fp32, registers) += A (64 x 16,
// bf16, registers: each warp's 16 rows in mma.sync's A fragment layout) *
// B (16 x N, bf16, shared memory through a descriptor).  kTransB = 1 when
// B is stored N-contiguous (V), 0 when K-contiguous (K for Q K^T).

template <int kTransB>
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}

// Shared-memory matrix descriptor, 128 B swizzle: start address, the byte
// offset between 64-wide panels (lbo; read when N crosses a panel) and
// between 8-row groups (sbo, 1 KB).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers that an asynchronous wgmma reads or writes: no use of them
// moves across this point.
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// --- TMA: a tile by one thread's request, completion on an mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// box (64 dims, rows) at (d, s, head, batch) of the map into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(s), "r"(h), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy writes (cp.async, st.shared) seen by wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Tiles in shared memory as wgmma reads them with the 128 B swizzle:
// panels of 64 dims; in a panel each row is 128 B, and its 16 B chunk j
// lies at chunk j ^ (row % 8).
template <int kRows>
__device__ __forceinline__ int sw_offset(int r, int c) {
  return (c >> 6) * (kRows * 64) + r * 64 +
         ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// This thread's walk over the copies of a tile: copy i = tid + threads n
// of a row of cpr copies is (row r0 + dr n + carry, copy c0 + dc n - carry
// cpr); computed once, so the loads divide by nothing.
struct CopyWalk {
  int cpr, r0, c0, dr, dc;
  __device__ CopyWalk(int D, int vec, int tid, int threads) {
    cpr = D / vec;
    r0 = tid / cpr;
    c0 = tid - r0 * cpr;
    dr = threads / cpr;
    dc = threads - dr * cpr;
  }
};

// Rows [0, nvalid) of a kRows x D tile from global (row stride ss) into
// the swizzled panels; rows past nvalid are zero-filled.  Neighbouring
// threads take neighbouring 16 B (8 B) of a row: coalesced reads, and
// every 128 B of shared memory written at once hits each bank once.
template <int kRows>
__device__ __forceinline__ void load_tile_sw(bf16* dst, const bf16* src,
                                             long long ss, int nvalid,
                                             const CopyWalk& w, int vec) {
  int r = w.r0, c = w.c0;
  while (r < kRows) {
    const bool in = r < nvalid;
    const int col = c * vec;
    cp_async(smem_u32(dst + sw_offset<kRows>(r, col)),
             in ? src + r * ss + col : src, in, vec);
    r += w.dr;
    c += w.dc;
    if (c >= w.cpr) {
      c -= w.cpr;
      ++r;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel_mma(const __grid_constant__ Params p) {
  using T = Mma<DP>;
  constexpr int kBlockKV = T::kBlockKV;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // stage s: K at 2 s, V at 2 s + 1; 1 KB aligned in the shared window
  bf16* kv_s = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* q_s = kv_s + 2 * T::kTile;  // stage 1

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int D = p.D;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t4 = lane % 4;  // fragment column pair
  const int q_start = qt * kBlockQ;
  const int q_last = min(q_start + kBlockQ, p.Sq) - 1;
  const int w_first = q_start + warp * 16;  // this warp's rows

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Live KV range of this q tile: the tiles the reference's liveness test
  // keeps (kv_start < Sk, kv_start <= q_last, q_start - kv_end < window).
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  const int kv_lo = p.window > 0 ? max(0, q_start - p.window + 1) : 0;
  const int t_lo = kv_lo / kBlockKV;
  const int t_hi = (kv_hi + kBlockKV - 1) / kBlockKV;

  const CopyWalk walk(D, p.vec, tid, kThreads);

  // K and V of tile t into stage: by TMA from one thread (rows past Sk and
  // dims past D come as zeros), or by every thread's cp.async
  __shared__ uint64_t landed[2];  // TMA: the stage's tile has landed
  const bool tma = p.use_tma;
  if (tma && tid == 0) {
    mbar_init(&landed[0]);
    mbar_init(&landed[1]);
  }
  auto load_kv = [&](int t, int stage) {
    const int kv_start = t * kBlockKV;
    bf16* k_dst = kv_s + 2 * stage * T::kTile;
    bf16* v_dst = k_dst + T::kTile;
    if (tma) {
      if (tid == 0) {
        mbar_expect(&landed[stage], 2 * T::kTile * sizeof(bf16));
#pragma unroll
        for (int pi = 0; pi < T::kPanels; ++pi) {
          tma_load(k_dst + pi * T::kPanel, &p.tk, &landed[stage], pi * 64,
                   kv_start, kvh, b);
          tma_load(v_dst + pi * T::kPanel, &p.tv, &landed[stage], pi * 64,
                   kv_start, kvh, b);
        }
      }
      return;
    }
    const int n = p.Sk - kv_start;
    load_tile_sw<kBlockKV>(k_dst, kg + kv_start * p.k_ss, p.k_ss, n, walk,
                           p.vec);
    load_tile_sw<kBlockKV>(v_dst, vg + kv_start * p.v_ss, p.v_ss, n, walk,
                           p.vec);
  };

  load_tile_sw<kBlockQ>(q_s, qg + q_start * p.q_ss, p.q_ss, p.Sq - q_start,
                        walk, p.vec);
  cp_async_commit();
  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();
  // The padded dims D..DP-1: zeros (cp.async never touches them), in q
  // now, in the K/V stages once q is in registers; TMA writes its own.
  const int pad = DP - D;
  for (int i = tid; i < kBlockQ * pad; i += kThreads) {
    const int r = i / pad;
    q_s[sw_offset<kBlockQ>(r, D + (i - r * pad))] = __float2bfloat16(0.f);
  }
  cp_async_wait<1>();  // q has landed
  __syncthreads();

  // Q's A fragments, by ldmatrix: lane l names row (l % 8) + 8 ((l / 8) % 2)
  // of the warp's 16, column 8 (l / 16) of each 16-wide k-step
  const int a_row = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_col = 8 * (lane / 16);
  uint32_t qf[T::kDSteps][4];
#pragma unroll
  for (int kk = 0; kk < T::kDSteps; ++kk)
    ldmatrix_x4(qf[kk],
                smem_u32(q_s + sw_offset<kBlockQ>(a_row, kk * 16 + a_col)));
  if (pad > 0 && !tma) {
    __syncthreads();  // every warp holds its q
    for (int i = tid; i < 4 * kBlockKV * pad; i += kThreads) {
      const int r = i / pad;  // row of the 4 stacked tiles
      kv_s[(r / kBlockKV) * T::kTile +
           sw_offset<kBlockKV>(r % kBlockKV, D + (i - r * pad))] =
          __float2bfloat16(0.f);
    }
  }

  float acc[T::kDimTiles][4];
#pragma unroll
  for (int n = 0; n < T::kDimTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  const float scale_log2 = p.scale * kLog2e;
  // keys live for rows g, g + 8: key_lo[r] <= key <= key_hi[r]
  int key_lo[2], key_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = w_first + g + 8 * r;
    key_hi[r] = p.causal ? min(p.Sk - 1, qp) : p.Sk - 1;
    key_lo[r] = p.window > 0 ? qp - p.window + 1 : 0;
  }
  const uint32_t kv_addr = smem_u32(kv_s);

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    const int kv_start = t * kBlockKV;
    if (tma) {
      mbar_wait(&landed[stage], ((t - t_lo) >> 1) & 1);  // tile t landed
    } else {
      cp_async_wait<0>();  // tile t has landed
      fence_proxy_async();
    }
    __syncthreads();  // ... for every thread; stage ^ 1 is free again
    if (t + 1 < t_hi) load_kv(t + 1, stage ^ 1);
    cp_async_commit();

    const uint32_t k_addr = kv_addr + 2 * stage * T::kTile * sizeof(bf16);
    const uint32_t v_addr = k_addr + T::kTile * sizeof(bf16);

    // S = Q K^T, fp32: 64 rows x kBlockKV keys per warpgroup
    float s[T::kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < T::kKeyTiles; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kDSteps; ++kk) {
      // K-major B: 16 dims = 32 B of a panel's 128 B rows
      const uint64_t desc = smem_desc(
          k_addr + (kk / 4) * T::kPanel * 2 + (kk % 4) * 32, 16);
      if constexpr (kBlockKV == 64)
        wgmma_n64<0>(&s[0][0], qf[kk], desc, kk > 0);
      else
        wgmma_n32<0>(&s[0][0], qf[kk], desc, kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    hold<T::kKeyTiles * 4>(&s[0][0]);

    // scale to log2 units (through the softcap where asked), then mask;
    // element e of s[j] is row g + 8 (e / 2), key kv_start + 8 j + 2 t4 +
    // e % 2.  Each choice is made once per tile, so the element loops
    // have no branches.
    if (p.softcap > 0.f) {
      const float to_cap = p.scale / p.softcap;
      const float from_cap = p.softcap * kLog2e;
#pragma unroll
      for (int j = 0; j < T::kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = from_cap * tanhf(s[j][e] * to_cap);
    } else {
#pragma unroll
      for (int j = 0; j < T::kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    }
    bool need_mask = kv_start + kBlockKV > p.Sk;  // for this warp's rows
    if (p.causal) need_mask = need_mask || kv_start + kBlockKV - 1 > w_first;
    if (p.window > 0)
      need_mask = need_mask || w_first + 15 - kv_start >= p.window;
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < T::kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const int kp = kv_start + 8 * j + 2 * t4 + (e % 2);
          const bool in = kp >= key_lo[r] && kp <= key_hi[r];
          s[j][e] = in ? s[j][e] : kNegInf;
        }
    }

    // online softmax on the fragments: a row lives in the 4 lanes of a quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < T::kKeyTiles; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // x - m, not x * c - m * c: -1e30 - -1e30 must be exactly 0
      alpha[r] = exp2_ftz(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < T::kKeyTiles; ++j) {
        s[j][2 * r] = exp2_ftz(s[j][2 * r] - mx);
        s[j][2 * r + 1] = exp2_ftz(s[j][2 * r + 1] - mx);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int n = 0; n < T::kDimTiles; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P_hi V + P_lo V.  S's accumulator tiles 2 kk, 2 kk + 1 are the
    // A fragment of k-step kk (16 keys); V is N-contiguous (kTransB 1), 64
    // or 16 dims per wgmma.
    uint32_t ph[T::kKeySteps][4], pl[T::kKeySteps][4];
#pragma unroll
    for (int kk = 0; kk < T::kKeySteps; ++kk) {
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    hold<T::kDimTiles * 4>(&acc[0][0]);  // rescaled before the fence
    hold<T::kKeySteps * 4>(&ph[0][0]);
    hold<T::kKeySteps * 4>(&pl[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kKeySteps; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t(&a)[4] = half ? pl[kk] : ph[kk];
        // N-contiguous B: 16 keys = 2 groups of 8 rows (sbo apart); dims
        // n0.. in panel n0 / 64, at n0 % 64 in its rows
        auto desc = [&](int n0) {
          return smem_desc(v_addr + (n0 / 64) * T::kPanel * 2 +
                               kk * 16 * 128 + (n0 % 64) * 2,
                           T::kPanel * 2);
        };
        // 64-wide pieces, the rest 16 wide; D 64 as two 32-wide pieces
        // (one 64-wide piece chained on one accumulator summed wrongly)
        constexpr int kWide = DP == 64 ? 0 : DP / 64 * 64;
        constexpr int kMid = DP == 64 ? 64 : kWide;
#pragma unroll
        for (int n0 = 0; n0 < kWide; n0 += 64)
          wgmma_n64<1>(&acc[n0 / 8][0], a, desc(n0), 1);
#pragma unroll
        for (int n0 = kWide; n0 < kMid; n0 += 32)
          wgmma_n32<1>(&acc[n0 / 8][0], a, desc(n0), 1);
#pragma unroll
        for (int n0 = kMid; n0 < DP; n0 += 16)
          wgmma_n16<1>(&acc[n0 / 8][0], a, desc(n0), 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
    hold<T::kDimTiles * 4>(&acc[0][0]);
    hold<T::kKeySteps * 4>(&ph[0][0]);
    hold<T::kKeySteps * 4>(&pl[0][0]);
  }

  // epilogue: o = acc / l in bf16, staged through this warp's own 16 rows
  // of q_s (stage 1, which every wgmma has finished reading), stored as
  // 16 B (8 B) rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qp = w_first + g + 8 * r;
    // m and l are in log2 units: the natural-log LSE is ln 2 (m + log2 l)
    if (p.lse != nullptr && t4 == 0 && qp < p.Sq)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] =
          m[r] == kNegInf ? -INFINITY : (m[r] + log2f(l[r])) * kLn2;
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const int row0 = warp * 16;
#pragma unroll
  for (int n = 0; n < T::kDimTiles; ++n) {
    const int c = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(
        q_s + sw_offset<kBlockQ>(row0 + g, c)) =
        __floats2bfloat162_rn(acc[n][0] * l[0], acc[n][1] * l[0]);
    *reinterpret_cast<__nv_bfloat162*>(
        q_s + sw_offset<kBlockQ>(row0 + g + 8, c)) =
        __floats2bfloat162_rn(acc[n][2] * l[1], acc[n][3] * l[1]);
  }
  __syncwarp();
  const int vec = p.vec;
  const int cpr = D / vec;
  for (int i = lane; i < 16 * cpr; i += 32) {
    const int r = i / cpr;
    const int c = (i - r * cpr) * vec;
    const int qp = w_first + r;
    if (qp >= p.Sq) break;  // rows grow with i
    const bf16* src = q_s + sw_offset<kBlockQ>(row0 + r, c);
    bf16* dst = og + qp * p.o_ss + c;
    if (vec == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  }
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, const Params& p,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (the library links no libcuda); nullptr where it is missing.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const auto fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault,
                                            &found) == cudaSuccess &&
                    found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
              : nullptr;
  }();
  return fn;
}

// The (D, S, heads, batch) bf16 tensor at ptr as a TMA map of boxes of 64
// dims x rows, 128 B swizzle, zeros outside the tensor.
bool encode_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
                int batch, long long ss, long long sh, long long sb,
                int rows) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_mma(Params p, cudaStream_t s) {
  using T = Mma<DP>;
  // 16 B copies: pointers and strides 16 B aligned, as TMA needs
  p.use_tma = p.vec == 8;
  if (p.use_tma &&
      !(encode_map(&p.tk, p.k, p.D, p.Sk, p.KVH, p.B, p.k_ss, p.k_sh,
                   p.k_sb, T::kBlockKV) &&
        encode_map(&p.tv, p.v, p.D, p.Sk, p.KVH, p.B, p.v_ss, p.v_sh,
                   p.v_sb, T::kBlockKV)))
    return cudaErrorInvalidValue;
  return launch_kernel(flash_fwd_kernel_mma<DP>, T::kSmemBytes, p, s);
}

template <int DP>
cudaError_t launch_fma(const Params& p, cudaStream_t s) {
  return launch_kernel(flash_fwd_kernel_fma<DP>, fma_smem_bytes<DP>(), p, s);
}

// D padded to a multiple of 16 (bf16) or 32 (fp32).
cudaError_t dispatch_mma(const Params& p, cudaStream_t s) {
  switch ((p.D + 15) / 16 * 16) {
    case 16: return launch_mma<16>(p, s);
    case 32: return launch_mma<32>(p, s);
    case 48: return launch_mma<48>(p, s);
    case 64: return launch_mma<64>(p, s);
    case 80: return launch_mma<80>(p, s);
    case 96: return launch_mma<96>(p, s);
    case 112: return launch_mma<112>(p, s);
    case 128: return launch_mma<128>(p, s);
    case 144: return launch_mma<144>(p, s);
    case 160: return launch_mma<160>(p, s);
    case 176: return launch_mma<176>(p, s);
    case 192: return launch_mma<192>(p, s);
    case 208: return launch_mma<208>(p, s);
    case 224: return launch_mma<224>(p, s);
    case 240: return launch_mma<240>(p, s);
    case 256: return launch_mma<256>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_fma(const Params& p, cudaStream_t s) {
  switch ((p.D + 31) / 32 * 32) {
    case 32: return launch_fma<32>(p, s);
    case 64: return launch_fma<64>(p, s);
    case 96: return launch_fma<96>(p, s);
    case 128: return launch_fma<128>(p, s);
    case 160: return launch_fma<160>(p, s);
    case 192: return launch_fma<192>(p, s);
    case 224: return launch_fma<224>(p, s);
    case 256: return launch_fma<256>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (scalar FMA kernel), 1 = bfloat16 (tensor cores).
// lse: (B, H, Sq) fp32, contiguous, or null: each row's log-sum-exp, for
// the backward.
// D: a multiple of 4 in [8, 256].  Strides are in elements; the last
// (head-dim) stride of q, k, v and o must be 1.  vec (bf16 only): elements
// per copy, 8 or 4; D, the base pointers and the B/H/S strides of q, k, v
// and o must be multiples of it (the caller checks).  scale is D ** -0.5 as
// the caller rounds it to fp32.  Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B,
    int H, int KVH, int Sq, int Sk, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float softcap,
    float scale, int vec, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 ||
      D < 8 || D > 256 || D % 4 != 0)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
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
  p.vec = vec;
  p.use_tma = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fma(p, s);
  if (dtype == 1) {
    if ((vec != 8 && vec != 4) || D % vec != 0) return cudaErrorInvalidValue;
    return dispatch_mma(p, s);
  }
  return cudaErrorInvalidValue;
}
