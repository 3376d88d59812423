// Per-tensor symmetric int8 quantization of a channels-last activation,
// written straight into the layout the int8 conv reads.
//
// Replaces: not a Pallas kernel.  The XLA quantization of the JAX
// package's int8 convs, transfer_em_tpu/ops/quant.py quantize_sym :43-53
// (called per activation at :64 and :88), with the rearrangements the port
// needs before its conv (ops/quant.py Layout: SAME / transposed-conv zero
// padding, the stride-2 convs' cut and space-to-depth, channels padded to
// whole 4-byte words, the stem's kw taps in the channel word).
//
// Function (bit for bit that of ops/quant.py quantize_int8_plain):
//   amax  = max |x| over the whole tensor (batch and padded tiles included)
//   scale = max(amax, 1e-12) / 127                       (true division)
//   q     = clip(round_half_even(x / scale), -127, 127)  (true division)
// each code written where the layout puts it, zeros where the layout pads.
// x / scale is __fdiv_rn, never x * (1 / scale) (a reciprocal flips codes),
// and rounding is __float2int_rn (half to even), never roundf.  The max does
// not depend on the order of its terms, so the cross-block reduction by
// atomicMax on the bits of non-negative floats (which order as the floats
// do) is exact, and the codes equal the plain version's.
//
// Bound on the H100: bytes (3.35 TB/s).  The tensor is read twice (once for
// the max, once for the codes: the scale needs the whole max first) and the
// codes written once.  Design: three stream operations and no host wait:
// a 4-byte memset of the max, absmax_kernel (16-byte loads, a warp-shuffle
// and block reduction, one atomicMax a block), then codes_kernel: each
// thread a 4-byte word of codes, one voxel's 4 channels read as one 16-byte
// float or 8-byte bfloat16 load where the channels are whole words, the
// source index of the layout computed in the store by multiply-shift
// divisions (one kernel for every layout).  The scale is written
// to the device by the code pass (block 0), where the conv's epilogue reads
// it.  A NaN anywhere in x is carried into amax (NaN's bits order above
// +inf's as unsigned), hence into the scale and the outputs, as the plain
// version and jnp.max carry it.

#include "common.cuh"

namespace tem {
namespace quant {

constexpr int kThreads = 256;

// max(m, v) for v >= 0 or NaN, carrying a NaN of either (fmaxf drops it)
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;
}

template <typename T>
struct Vec;  // 16 bytes of T
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const T* __restrict__ x, long long n, int aligned,
                  unsigned int* __restrict__ amax) {
  float m = 0.f;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  constexpr int kN = Vec<T>::kN;
  long long done = 0;
  if (aligned) {
    const long long nv = n / kN;
    for (long long i = tid; i < nv; i += stride) {
      float v[8];
      Vec<T>::load(x + i * kN, v);
#pragma unroll
      for (int j = 0; j < kN; ++j) m = max_nan(m, fabsf(v[j]));
    }
    done = nv * kN;
  }
  for (long long i = done + tid; i < n; i += stride) {
    m = max_nan(m, fabsf(to_f32<T>(x[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = max_nan(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  }
  __shared__ float part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) m = max_nan(m, part[i]);
    // non-negative floats (and NaN, above them all) order as their bits do
    atomicMax(amax, __float_as_uint(m));
  }
}

// TEM_QUANT_FAULT (planted faults, built only by chip_smoke.py to show
// that its bit-equality check catches them): 1 rounds half away from zero
// (roundf), 2 multiplies by the scale's reciprocal, 3 takes the max over
// the first half of the tensor.
#ifndef TEM_QUANT_FAULT
#define TEM_QUANT_FAULT 0
#endif

__device__ __forceinline__ uint32_t code(float v, float scale) {
#if TEM_QUANT_FAULT == 1
  int q = static_cast<int>(roundf(__fdiv_rn(v, scale)));
#elif TEM_QUANT_FAULT == 2
  int q = __float2int_rn(__fmul_rn(v, __frcp_rn(scale)));
#else
  int q = __float2int_rn(__fdiv_rn(v, scale));  // half to even
#endif
  q = q < -127 ? -127 : (q > 127 ? 127 : q);
  return static_cast<uint32_t>(q) & 0xFFu;
}

// n / d and n % d for 0 <= n < 2^31 by a multiply-high, an add and a shift
// (the divisors are runtime values: a 32-bit division by one costs some 20
// instructions, and a word of codes a thread needs four of them).
struct Div {
  uint32_t d, mul, shift;
};

inline Div make_div(uint32_t d) {
  Div v{d, 0, 0};
  while ((1u << v.shift) < d) ++v.shift;
  v.mul = static_cast<uint32_t>(((1ull << 32) * ((1ull << v.shift) - d)) / d +
                                1);
  return v;
}

__device__ __forceinline__ uint32_t quo(uint32_t n, const Div& v) {
  return (__umulhi(n, v.mul) + n) >> v.shift;
}

// The layout (ops/quant.py Layout) of codes (B, Dq, Hq, Wq, Cq) from x
// (B, D, H, W, C), 2D as D = Dq = 1: a code at (vd, vh, vw, cq) reads
//   wtaps > 1 (C == 1):  x[vd - ld, vh - lh, vw + cq - lw, 0] for cq < wtaps
//   else: phase p = cq / C, c = cq % C (p < s^nd), offsets (pd, ph, pw) of
//         p with the first spatial axis most significant,
//         x[s*vd + pd - ld, s*vh + ph - lh, s*vw + pw - lw, c]
// and is zero where that lies outside x or past the channels it fills.
// One batch item of x and of the codes holds fewer than 2^31 values (the
// entry checks), so offsets within an item are 32-bit.
struct Layout {
  int D, H, W, C, Dq, Hq, Wq, Cq, ld, lh, lw, s, nd, wtaps;
  Div cw_div, wq_div, hq_div, c_div, s_div;  // by Cq / 4, Wq, Hq, C, s
};

template <typename T>
__device__ __forceinline__ float at(const T* xb, const Layout& L, int d,
                                    int h, int w, int c, bool& ok) {
  ok = d >= 0 && d < L.D && h >= 0 && h < L.H && w >= 0 && w < L.W;
  if (!ok) return 0.f;
  return to_f32<T>(xb[((d * L.H + h) * L.W + w) * L.C + c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    codes_kernel(const T* __restrict__ x, uint32_t* __restrict__ q,
                 const unsigned int* __restrict__ amax,
                 float* __restrict__ scale_out, Layout L, int vec) {
  const float m = __uint_as_float(*amax);
  const float scale = __fdiv_rn(m != m ? m : fmaxf(m, 1e-12f), 127.f);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    *scale_out = scale;
  }
  const int b = blockIdx.y;
  const int cw = L.Cq / 4;
  const unsigned int words =
      static_cast<unsigned int>(L.Dq) * L.Hq * L.Wq * cw;
  const int phases = L.s == 1 ? 1 : (L.nd == 3 ? L.s * L.s * L.s : L.s * L.s);
  const T* const xb =
      x + static_cast<long long>(b) * L.D * L.H * L.W * L.C;
  uint32_t* const qb = q + static_cast<long long>(b) * words;
  for (unsigned int i = blockIdx.x * blockDim.x + threadIdx.x; i < words;
       i += gridDim.x * blockDim.x) {
    const uint32_t t0 = quo(i, L.cw_div);
    const int c4 = static_cast<int>(i - t0 * cw) * 4;
    const uint32_t t1 = quo(t0, L.wq_div);
    const int vw = static_cast<int>(t0 - t1 * L.Wq);
    const int vd = static_cast<int>(quo(t1, L.hq_div));
    const int vh = static_cast<int>(t1) - vd * L.Hq;
    uint32_t word = 0;
    if (L.wtaps > 1) {
      for (int j = 0; j < 4 && j < L.wtaps; ++j) {
        bool ok;
        const float v = at(xb, L, vd - L.ld, vh - L.lh, vw + j - L.lw, 0, ok);
        if (ok) word |= code(v, scale) << (8 * j);
      }
    } else {
      // the word's channels: phase p = cq / C, channel c = cq % C, the
      // phase's offsets (pd, ph, pw); with vec (C % 4 == 0) the 4 are
      // consecutive channels of one voxel, read as one load
      for (int e = 0; e < (vec ? 1 : 4); ++e) {
        const int cq = c4 + e;
        const int p = static_cast<int>(quo(cq, L.c_div)), c = cq - p * L.C;
        if (p >= phases) break;
        const int p1 = static_cast<int>(quo(p, L.s_div));
        const int pw = p - p1 * L.s;
        const int pd = L.nd == 3 ? static_cast<int>(quo(p1, L.s_div)) : 0;
        const int ph = p1 - pd * L.s;
        const int d = L.s * vd + pd - L.ld, h = L.s * vh + ph - L.lh,
                  w = L.s * vw + pw - L.lw;
        if (!vec) {
          bool ok;
          const float v = at(xb, L, d, h, w, c, ok);
          if (ok) word |= code(v, scale) << (8 * e);
          continue;
        }
        if (d < 0 || d >= L.D || h < 0 || h >= L.H || w < 0 || w >= L.W) {
          break;
        }
        const T* src = xb + ((d * L.H + h) * L.W + w) * L.C + c;
        float v[4];
        if constexpr (sizeof(T) == 4) {
          const float4 a = *reinterpret_cast<const float4*>(src);
          v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        } else {
          const uint2 a = *reinterpret_cast<const uint2*>(src);
          v[0] = __uint_as_float(a.x << 16);
          v[1] = __uint_as_float(a.x & 0xFFFF0000u);
          v[2] = __uint_as_float(a.y << 16);
          v[3] = __uint_as_float(a.y & 0xFFFF0000u);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) word |= code(v[k], scale) << (8 * k);
      }
    }
    qb[i] = word;
  }
}

template <typename T>
cudaError_t run(const void* x, void* q, float* scratch, int B, Layout L,
                cudaStream_t s) {
  const long long n = static_cast<long long>(B) * L.D * L.H * L.W * L.C;
  long long n_max = n;  // the values the max runs over
#if TEM_QUANT_FAULT == 3
  n_max /= 2;
#endif
  auto* amax = reinterpret_cast<unsigned int*>(scratch);
  cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(unsigned int), s);
  if (e != cudaSuccess) return e;
  const T* xt = static_cast<const T*>(x);
  const int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  absmax_kernel<T><<<grid_for(n_max, Vec<T>::kN * 4), kThreads, 0, s>>>(
      xt, n_max, aligned, amax);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long words = static_cast<long long>(L.Dq) * L.Hq * L.Wq *
                          (L.Cq / 4);
  long long bx = (words + kThreads * 4 - 1) / (kThreads * 4);
  if (bx < 1) bx = 1;
  if (bx > 65535) bx = 65535;
  const int vec = L.C % 4 == 0 && L.wtaps == 1 &&
                  reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  codes_kernel<T><<<dim3(static_cast<unsigned>(bx), B), kThreads, 0, s>>>(
      xt, static_cast<uint32_t*>(q), amax, scratch + 1, L, vec);
  return cudaGetLastError();
}

}  // namespace quant
}  // namespace tem

// x (B, D, H, W, C) float32 (dtype 0) or bfloat16 (1), 2D as D = 1; q the
// codes (B, Dq, Hq, Wq, Cq), Cq % 4 == 0; scratch 2 floats: [0] the max's
// bits, [1] the scale written for the conv.  (ld, lh, lw) the low pads, s
// the space-to-depth factor, nd the spatial rank (2 or 3), wtaps the kw taps
// packed in a channel word (C == 1) or 1.
extern "C" int tem_quantize_int8(const void* x, int dtype, void* q,
                                 void* scratch, int B, int D, int H, int W,
                                 int C, int Dq, int Hq, int Wq, int Cq,
                                 int ld, int lh, int lw, int s, int nd,
                                 int wtaps, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || Cq < 4 || Cq % 4 != 0 || s < 1 ||
      Wq < 1 || Hq < 1 || (wtaps > 1 && (C != 1 || s != 1 || wtaps > 4)) ||
      static_cast<long long>(Dq) * Hq * Wq * Cq >= (1LL << 31) ||
      static_cast<long long>(D) * H * W * C >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using tem::quant::make_div;
  const tem::quant::Layout L{D, H, W, C, Dq, Hq, Wq, Cq, ld, lh, lw,
                             s, nd, wtaps, make_div(Cq / 4), make_div(Wq),
                             make_div(Hq), make_div(C), make_div(s)};
  auto st = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<float*>(scratch);
  cudaError_t e;
  if (dtype == tem::kF32) {
    e = tem::quant::run<float>(x, q, sc, B, L, st);
  } else if (dtype == tem::kBF16) {
    e = tem::quant::run<__nv_bfloat16>(x, q, sc, B, L, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
