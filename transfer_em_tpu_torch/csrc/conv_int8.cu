// int8 x int8 -> int32 stride-1 VALID conv, channels last, with the
// dequantizing epilogue of the JAX package's int8 serving path.
//
// Replaces: not a Pallas kernel.  transfer_em_tpu/ops/quant.py:56-95
// (conv_nd_int8, conv_transpose_nd_int8) leaves the integer conv to XLA
// (lax.conv_general_dilated(..., preferred_element_type=int32)); PyTorch has
// no int8 conv on CUDA, so the port writes it by hand.
//
// Function: x (B, D, H, W, C) int8 codes, C % 4 == 0 (the wrapper pads C
// with zero codes), weights packed by the wrapper as wt[n][k] (Opad, Kpad),
// k = ((td * KH + th) * KW + tw) * C + c, zero beyond K = KD*KH*KW*C and O;
//   acc[m, n] = sum_k x[m @ tap(k), c(k)] * wt[n][k]          (exact int32)
// and, by out_mode, y = acc (int32), or y = float(acc) * (sx * sk[n]) with
// the product sx * sk[n] taken first in f32 (JAX's order), rounded to f32 or
// bf16, then the optional LeakyReLU(slope) on that rounded value
// (common.cuh conv_leaky).  Every conv of the int8 generator reduces to this
// one (ops/cuda_int8.py): k4 stride-2 VALID by space-to-depth into a k2
// conv, the stride-2 SAME transposed conv by its phase decomposition (a k3
// conv with 2^n * Cout outputs), 2D as D = 1.  Integer sums are exact, so
// each rearrangement gives JAX's accumulators bit for bit.
//
// Bound on the H100: bytes (3.35 TB/s) at every layer of the wf=8
// generator (8-32 channels), operations (1,979 TOPS int8 dense on the
// tensor cores) at most layers of the wf=1 one (64-256).  Design: an implicit GEMM on mma.sync
// m16n8k32.s32.s8.s8.s32.  A block of 4 warps takes 128 output voxels
// (M, flattened over b, d, h, w) by NF * 8 output channels; each warp 32
// voxels (two m16 fragments) by NF n8 fragments.  The im2col A fragments are
// read straight from device memory (L1 / L2 serve the 27-fold reuse) through
// a per-block table in shared memory of each 4-byte K word's input offset
// (no divisions in the K loop); B fragments are 4-byte words of the packed
// weights.  A simple kernel that is right comes first: no shared-memory
// staging, no TMA, no wgmma (a later PR's).

#include <type_traits>

#include "common.cuh"

namespace tem {
namespace int8 {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 32;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 128

enum OutMode : int { kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2 };

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void store_out(T* y, long long idx, float v) {
  y[idx] = from_f32<T>(v);
}

template <int NF, typename T>
__device__ __forceinline__ void epilogue(
    const int (&acc)[2][NF][4], T* __restrict__ y, const float* __restrict__ sx,
    const float* __restrict__ sk, long long M, int O, long long row0,
    int nbase, int group, int tig, int act, float slope) {
  const float s_x = *sx;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long m = row0 + mf * 16 + group + (r >= 2 ? 8 : 0);
        const int n = nbase + nf * 8 + tig * 2 + (r & 1);
        if (m >= M || n >= O) continue;
        const long long idx = m * O + n;
        if constexpr (std::is_same<T, int>::value) {
          y[idx] = acc[mf][nf][r];  // int32 accumulators
        } else {
          const float s = __fmul_rn(s_x, sk[n]);
          float v = __fmul_rn(__int2float_rn(acc[mf][nf][r]), s);
          if (act) v = conv_leaky<T>(v, slope);
          store_out<T>(y, idx, v);
        }
      }
    }
  }
}

template <int NF, typename T>
__global__ void __launch_bounds__(kWarps * 32)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 T* __restrict__ y, const float* __restrict__ sx,
                 const float* __restrict__ sk, int B, int D, int H, int W,
                 int C, int KD, int KH, int KW, int O, int Kpad, int act,
                 float slope) {
  extern __shared__ int koff[];  // input offset of each 4-byte K word
  const int Do = D - KD + 1, Ho = H - KH + 1, Wo = W - KW + 1;
  const long long M = (long long)B * Do * Ho * Wo;
  const int cw = C / 4;
  const int kwords = KD * KH * KW * cw;
  const int nwords = Kpad / 4;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) {
    int off = -1;  // past K: a zero word
    if (w < kwords) {
      const int tap = w / cw, c4 = w - tap * cw;
      const int tw = tap % KW, th = (tap / KW) % KH, td = tap / (KW * KH);
      off = ((td * H + th) * W + tw) * C + c4 * 4;
    }
    koff[w] = off;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / 4, tig = lane % 4;
  const long long row0 =
      (long long)blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int nbase = blockIdx.y * NF * 8;

  // input base offsets of this thread's 4 rows (two m16 fragments, rows
  // group and group + 8 of each); rows past M read row M - 1 and are not
  // stored
  long long base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long long m = row0 + (i / 2) * 16 + group + (i % 2) * 8;
    if (m >= M) m = M - 1;
    const int ow = (int)(m % Wo);
    long long t = m / Wo;
    const int oh = (int)(t % Ho);
    t /= Ho;
    const int od = (int)(t % Do);
    const long long b = t / Do;
    base[i] = (((b * D + od) * H + oh) * (long long)W + ow) * C;
  }

  int acc[2][NF][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mf][nf][r] = 0;

  const int8_t* wrow[NF];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
    wrow[nf] = wt + (long long)(nbase + nf * 8 + group) * Kpad + tig * 4;

  for (int ks = 0; ks < Kpad / 32; ++ks) {
    const int o0 = koff[ks * 8 + tig], o1 = koff[ks * 8 + 4 + tig];
    int a[2][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf) {
      // a0: row group, k words tig; a1: row group + 8; a2 / a3: k + 16
      a[mf][0] = o0 < 0 ? 0 : __ldg((const int*)(x + base[mf * 2] + o0));
      a[mf][1] = o0 < 0 ? 0 : __ldg((const int*)(x + base[mf * 2 + 1] + o0));
      a[mf][2] = o1 < 0 ? 0 : __ldg((const int*)(x + base[mf * 2] + o1));
      a[mf][3] = o1 < 0 ? 0 : __ldg((const int*)(x + base[mf * 2 + 1] + o1));
    }
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      // b0: column group, k tig*4..+3; b1: k + 16
      const int b0 = __ldg((const int*)(wrow[nf] + ks * 32));
      const int b1 = __ldg((const int*)(wrow[nf] + ks * 32 + 16));
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
        mma_s8(acc[mf][nf], a[mf][0], a[mf][1], a[mf][2], a[mf][3], b0, b1);
    }
  }
  epilogue<NF, T>(acc, y, sx, sk, M, O, row0, nbase, group, tig, act, slope);
}

template <int NF, typename T>
cudaError_t launch_nf(const int8_t* x, const int8_t* wt, void* y,
                      const float* sx, const float* sk, int B, int D, int H,
                      int W, int C, int KD, int KH, int KW, int O, int Opad,
                      int Kpad, int act, float slope, cudaStream_t stream) {
  const long long M =
      (long long)B * (D - KD + 1) * (H - KH + 1) * (W - KW + 1);
  dim3 grid((unsigned)((M + kRowsPerBlock - 1) / kRowsPerBlock),
            (unsigned)(Opad / (NF * 8)));
  const size_t smem = (size_t)(Kpad / 4) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_int8_kernel<NF, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  conv_int8_kernel<NF, T><<<grid, kWarps * 32, smem, stream>>>(
      x, wt, static_cast<T*>(y), sx, sk, B, D, H, W, C, KD, KH, KW, O, Kpad,
      act, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const int8_t* x, const int8_t* wt, void* y,
                     const float* sx, const float* sk, int B, int D, int H,
                     int W, int C, int KD, int KH, int KW, int O, int Opad,
                     int Kpad, int act, float slope, cudaStream_t stream) {
#define TEM_NF(nf)                                                          \
  return launch_nf<nf, T>(x, wt, y, sx, sk, B, D, H, W, C, KD, KH, KW, O,  \
                          Opad, Kpad, act, slope, stream)
  if (Opad % 64 == 0) TEM_NF(8);
  if (Opad == 32) TEM_NF(4);
  if (Opad == 16) TEM_NF(2);
  if (Opad == 8) TEM_NF(1);
#undef TEM_NF
  return cudaErrorInvalidValue;
}

}  // namespace int8
}  // namespace tem

// out_mode: 0 float32, 1 bfloat16 (both dequantized), 2 int32 accumulators.
// Opad: O rounded up to 8, 16, 32 or a multiple of 64; Kpad: a multiple of
// 32; C % 4 == 0.  sx (1 value) and sk (O values) are device pointers.
extern "C" int tem_conv_int8(const void* x, const void* wt, void* y,
                             const void* sx, const void* sk, int out_mode,
                             int B, int D, int H, int W, int C, int KD,
                             int KH, int KW, int O, int Opad, int Kpad,
                             int act, float slope, void* stream) {
  if (C % 4 != 0 || Kpad % 32 != 0 || KD > D || KH > H || KW > W)
    return cudaErrorInvalidValue;
  using namespace tem::int8;
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const int8_t*>(x);
  auto wi = static_cast<const int8_t*>(wt);
  auto sxf = static_cast<const float*>(sx);
  auto skf = static_cast<const float*>(sk);
  switch (out_mode) {
    case kOutF32:
      return launch_t<float>(xi, wi, y, sxf, skf, B, D, H, W, C, KD, KH, KW,
                             O, Opad, Kpad, act, slope, s);
    case kOutBF16:
      return launch_t<__nv_bfloat16>(xi, wi, y, sxf, skf, B, D, H, W, C, KD,
                                     KH, KW, O, Opad, Kpad, act, slope, s);
    case kOutI32:
      return launch_t<int>(xi, wi, y, sxf, skf, B, D, H, W, C, KD, KH, KW, O,
                           Opad, Kpad, 0, 0.f, s);
    default:
      return cudaErrorInvalidValue;
  }
}
