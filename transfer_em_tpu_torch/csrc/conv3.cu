// 3x3x3 stride-1 VALID convolution, channels-last, with an optional fused
// LeakyReLU epilogue: the Hopper counterpart of the Pallas Toeplitz-GEMM
// kernel _tconv3_kernel (transfer_em_tpu/ops/pallas_conv.py:69-114, called
// at :174 from _tconv3_call 162-193 through tconv3 / tconv3_op /
// tconv3_act_op).
//
//   x (B, D, H, W, C)  *  w (3, 3, 3, C, O)  ->  y (B, D-2, H-2, W-2, O)
//
// T is float or __nv_bfloat16; products are summed in f32 and the result is
// rounded once to T after the epilogue.
//
// What bounds it on the H100: at the generator's widths (C, O <= 32) each
// output voxel needs 27*C*O multiply-adds against a few bytes of input, so
// the work is operations, not bytes.  The TPU kernel's Toeplitz strips exist
// to fill a 128-lane MXU at 8-32 channels; that layout is not carried over.
// This first version is a direct convolution on the CUDA cores (f32 FMA,
// no tensor cores), kept simple and exact:
//   * one block stages the whole 27*C*OT weight slab of its OT output
//     channels in shared memory as f32 (up to 27*32*16*4 = 55 KB, above the
//     48 KB static limit, hence dynamic shared memory and
//     cudaFuncAttributeMaxDynamicSharedMemorySize); all threads read the same
//     weight address at once, a broadcast;
//   * one thread computes kVW = 4 neighbouring outputs along W for OT output
//     channels, so each input value loaded into a register serves up to
//     3 taps * 4 outputs * OT channels, and each weight read serves 4 outputs;
//   * O is split across blockIdx.y in chunks of OT (16, 8, 4, 2 or 1: the
//     largest that divides O and fits the 227 KB shared-memory limit).
// Making it fast (wgmma on bf16, TMA-fed tiles) is later work.
#include "common.cuh"

namespace tem {

constexpr int kVW = 4;         // neighbouring outputs along W per thread
constexpr int kThreads = 256;  // threads per block
constexpr long long kMaxSmem = 227LL * 1024;  // H100 dynamic shared memory

template <typename T, int OT>
__global__ void __launch_bounds__(kThreads)
    conv3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int D, int H, int W, int C, int O,
                 long long total, int act, float slope) {
  extern __shared__ float ws[];  // [27][C][OT], f32
  const int o0 = blockIdx.y * OT;
  const int nw = 27 * C * OT;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int o = i % OT;
    const int tc = i / OT;  // tap * C + c
    ws[i] = to_f32<T>(w[(long long)tc * O + o0 + o]);
  }
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int OD = D - 2, OH = H - 2, OW = W - 2;
  const int NWV = (OW + kVW - 1) / kVW;
  const int wv = static_cast<int>(idx % NWV);
  long long r = idx / NWV;
  const int oh = static_cast<int>(r % OH);
  r /= OH;
  const int od = static_cast<int>(r % OD);
  const long long b = r / OD;
  const int ow0 = wv * kVW;

  float acc[kVW][OT];
#pragma unroll
  for (int v = 0; v < kVW; ++v) {
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[v][o] = 0.f;
  }

  for (int kd = 0; kd < 3; ++kd) {
    for (int kh = 0; kh < 3; ++kh) {
      const T* row =
          x + (((b * D + od + kd) * H + oh + kh) * (long long)W + ow0) * C;
      const float* wk = ws + (kd * 3 + kh) * 3 * C * OT;
      for (int c = 0; c < C; ++c) {
        float xr[kVW + 2];
#pragma unroll
        for (int j = 0; j < kVW + 2; ++j) {
          xr[j] = (ow0 + j < W) ? to_f32<T>(row[(long long)j * C + c]) : 0.f;
        }
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float* wp = wk + (kw * C + c) * OT;
#pragma unroll
          for (int o = 0; o < OT; ++o) {
            const float wo = wp[o];
#pragma unroll
            for (int v = 0; v < kVW; ++v) {
              acc[v][o] = fmaf(xr[v + kw], wo, acc[v][o]);
            }
          }
        }
      }
    }
  }

  T* out = y + (((b * OD + od) * OH + oh) * (long long)OW + ow0) * O + o0;
#pragma unroll
  for (int v = 0; v < kVW; ++v) {
    if (ow0 + v < OW) {
#pragma unroll
      for (int o = 0; o < OT; ++o) {
        float a = acc[v][o];
        if (act) a = leaky(a, slope);
        out[(long long)v * O + o] = from_f32<T>(a);
      }
    }
  }
}

template <typename T, int OT>
cudaError_t launch_conv3(const void* x, const void* w, void* y, int B, int D,
                         int H, int W, int C, int O, int act, float slope,
                         cudaStream_t s) {
  const int OD = D - 2, OH = H - 2, OW = W - 2;
  const long long total =
      (long long)B * OD * OH * ((OW + kVW - 1) / kVW);
  const size_t smem = static_cast<size_t>(27) * C * OT * sizeof(float);
  auto kern = conv3_kernel<T, OT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned int>((total + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(O / OT));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      D, H, W, C, O, total, act, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_conv3(int ot, const void* x, const void* w, void* y,
                           int B, int D, int H, int W, int C, int O, int act,
                           float slope, cudaStream_t s) {
  switch (ot) {
    case 16:
      return launch_conv3<T, 16>(x, w, y, B, D, H, W, C, O, act, slope, s);
    case 8:
      return launch_conv3<T, 8>(x, w, y, B, D, H, W, C, O, act, slope, s);
    case 4:
      return launch_conv3<T, 4>(x, w, y, B, D, H, W, C, O, act, slope, s);
    case 2:
      return launch_conv3<T, 2>(x, w, y, B, D, H, W, C, O, act, slope, s);
    case 1:
      return launch_conv3<T, 1>(x, w, y, B, D, H, W, C, O, act, slope, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Output channels per block: the largest of 16, 8, 4, 2, 1 that divides O
// and whose weight slab fits in shared memory; 0 if none does.
int pick_out_tile(int C, int O) {
  const int cands[] = {16, 8, 4, 2, 1};
  for (int ot : cands) {
    if (O % ot == 0 && 27LL * C * ot * (long long)sizeof(float) <= kMaxSmem) {
      return ot;
    }
  }
  return 0;
}

}  // namespace tem

extern "C" {

int tem_conv3(const void* x, const void* w, void* y, int dtype, int B, int D,
              int H, int W, int C, int O, int act, float slope, void* stream) {
  if (B <= 0 || D < 3 || H < 3 || W < 3 || C <= 0 || O <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ot = tem::pick_out_tile(C, O);
  if (ot == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == tem::kF32) {
    e = tem::dispatch_conv3<float>(ot, x, w, y, B, D, H, W, C, O, act, slope,
                                   s);
  } else if (dtype == tem::kBF16) {
    e = tem::dispatch_conv3<__nv_bfloat16>(ot, x, w, y, B, D, H, W, C, O, act,
                                           slope, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
