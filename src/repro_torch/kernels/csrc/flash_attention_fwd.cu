// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`_attn_kernel`, launched by `flash_attention` through pl.pallas_call).
// It computes the same function: an online softmax over KV tiles with the
// running (m, l, acc) statistics in f32, GQA by kv_head = h / (Hq / Hkv),
// causal, sliding-window and tail-padding masks, scale 1/sqrt(D) applied
// to the scores, and the output in q's dtype. KV tiles that every query of
// the tile masks are skipped. A key that is masked contributes p = 0, so a
// query row that every key masks comes out as 0 (acc = 0, l clamped to
// 1e-30), whatever the tiling.
//
// Design. One thread block per (q tile of BQ = 64 rows, query head,
// batch row); 4 warps, each owning 16 query rows. The Q tile stays in
// shared memory for the whole block; K and V tiles of BK = 32 keys are
// staged through shared memory in f32. In the score phase lane j of a warp
// computes the scores of key j against the warp's 16 rows (Q reads are
// broadcasts, the K tile is padded to D + 1 floats a row so the 32 lanes
// hit 32 banks). The probabilities go through a per-warp slice of shared
// memory to the PV phase, where lane c accumulates output columns
// c, c + 32, ... for the warp's 16 rows in registers.
//
// What bounds it on this card: causal prefill does
// 4 * B * H * D * S * (S + 1) / 2 operations on 4 * B * S * H * D * 2
// bytes (bf16), about S / 4 operations a byte. The H100's ridge is about
// 295, so at S = 1024 the memory bounds it and from S = 2048 the
// tensor-core rate; the two bounds are within a factor of two there.
// This first kernel does its products with f32 FMAs on the CUDA cores
// (no wgmma, no TMA), which keeps the f32 path within 2e-5 of the
// reference and leaves a large factor to either bound for a later change.
//
// The kernel takes strides for the batch, head and sequence dimensions
// (the head dimension must be contiguous), so the model's (B, S, H, D)
// tensors are read in place as (B, H, S, D) without a copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Shape {
  int hq, hkv, sq, sk;
  long long qsb, qsh, qss;     // q strides (batch, head, seq)
  long long ksb, ksh, kss;
  long long vsb, vsh, vss;
  long long osb, osh, oss;
  float scale;
  int causal, window;
};

template <int D>
constexpr int smem_floats() {
  // sQ (BQ x D) + sK (BK x (D + 1)) + sV (BK x D) + sP (BQ x BK)
  return kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Shape sh) {
  constexpr int DP = D + 1;
  constexpr int NC = (D + 31) / 32;      // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * D;
  float* sV = sK + kBK * DP;
  float* sP = sV + kBK * D;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (sh.hq / sh.hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * kRows;

  const T* qb = q + b * sh.qsb + h * sh.qsh;
  const T* kb = k + b * sh.ksb + hk * sh.ksh;
  const T* vb = v + b * sh.vsb + hk * sh.vsh;
  T* ob = o + b * sh.osb + h * sh.osh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    sQ[i] = qi < sh.sq ? to_f32(qb[qi * sh.qss + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int q_last = q0 + kBQ - 1;
  const int n_tiles = (sh.sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // Same liveness test as the TPU kernel, per (q tile, kv tile); it is
    // uniform over the block, so the barriers below stay uniform too.
    if (sh.causal && q_last < k0) break;
    if (sh.window && (q0 - (k0 + kBK - 1)) >= sh.window) continue;

    __syncthreads();   // the previous tile is no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      const bool ok = kj < sh.sk;
      sK[r * DP + c] = ok ? to_f32(kb[kj * sh.kss + c]) : 0.f;
      sV[i] = ok ? to_f32(vb[kj * sh.vss + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = sK + lane * DP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float k0v = krow[d], k1v = krow[d + 1], k2v = krow[d + 2], k3v = krow[d + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sQ + (r0 + r) * D + d);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }

    const int kpos = k0 + lane;
    float* prow = sP + r0 * kBK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + r0 + r;
      bool allow = kpos < sh.sk;
      if (sh.causal) allow = allow && (qpos >= kpos);
      if (sh.window) allow = allow && (qpos - kpos < sh.window);
      const float sv = allow ? s[r] * sh.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = allow ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      prow[r * kBK + lane] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = lane + 32 * c;
          vv[jj][c] = col < D ? sV[(j + jj) * D + col] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(prow + r * kBK + j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[r][c] = fmaf(pv.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(pv.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(pv.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(pv.w, vv[3][c], acc[r][c]);
        }
      }
    }
    __syncwarp();   // sP is rewritten by this warp on the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= sh.sq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) from_f32(ob + qi * sh.oss + col, acc[r][c] / lr);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, const Shape& sh, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sh.sq + kBQ - 1) / kBQ, sh.hq, batch);
  flash_fwd_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
                       int batch, const Shape& sh, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, o, batch, sh, stream);
    case 32: return launch<32, T>(q, k, v, o, batch, sh, stream);
    case 64: return launch<64, T>(q, k, v, o, batch, sh, stream);
    case 128: return launch<128, T>(q, k, v, o, batch, sh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: q, k, v, o, each as
// (batch, head, seq) in elements. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int hq, int hkv, int sq, int sk, int d,
    const long long* strides, float scale, int causal, int window,
    void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  Shape sh{hq, hkv, sq, sk,
           strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
           scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, q, k, v, o, batch, sh, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(d, q, k, v, o, batch, sh, st);
  return cudaErrorInvalidValue;
}
