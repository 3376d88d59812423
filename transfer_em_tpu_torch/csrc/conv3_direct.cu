// 3x3x3 stride-1 VALID convolution on the CUDA cores, channels-last, with an
// optional fused LeakyReLU epilogue, for the shapes the tensor-core kernel
// (conv3_tc.cu) does not take: C < 4 input or O < 8 output channels (at
// wf=8 the C=1 stem and the O=1 out layer).  Same Pallas kernel replaced:
// _tconv3_kernel (transfer_em_tpu/ops/pallas_conv.py:69-114, pallas_call at
// :174).
//
//   x (B, D, H, W, C)  *  w (3, 3, 3, C, O)  ->  y (B, D-2, H-2, W-2, O)
//
// What bounds it on the H100: bytes.  With C or O this small, each output
// voxel costs 27*C*O multiply-adds against (C + O) values moved, far below
// the card's ~20 f32 operations per byte.  So the design moves each byte
// once per block and keeps the arithmetic in f32 FMAs:
//   * one block (256 threads) owns a 4 x 8 x 32 (D, H, W) output tile for
//     OT output channels (OT = O rounded up to 1, 2, 4 or 8; O > 8 is split
//     across blockIdx.y);
//   * the 6 x 10 x 34 input tile with its halo is copied into shared memory
//     as f32, 4 channels at a time, by coalesced loads (neighbouring threads
//     on neighbouring addresses), beside the 27 x 4 x OT weights; all of a
//     thread's loads of a pass are in flight together;
//   * each thread computes 4 outputs along H at one W (the lane) for all OT
//     channels: every input value it reads from shared memory serves up to
//     3 taps x 4 outputs x OT channels, and the lanes of a warp read
//     neighbouring words (no bank conflicts);
//   * the results go through shared memory and leave as contiguous rows.
// T is float or __nv_bfloat16; products are summed in f32 and rounded once.
#include "common.cuh"

namespace tem {
namespace direct {

constexpr int kTD = 4, kTH = 8, kTW = 32;  // output tile
constexpr int kID = kTD + 2, kIH = kTH + 2, kIW = kTW + 2;
constexpr int kIWP = 36;  // padded input row (floats)
constexpr int kCB = 4;    // input channels per pass
constexpr int kThreads = 256;
constexpr int kInFloats = kCB * kID * kIH * kIWP;
constexpr int kInVox = kID * kIH * kIW;                      // 2040
constexpr int kInIters = (kInVox + kThreads - 1) / kThreads;  // loads/thread

template <int OT>
constexpr int smem_bytes() {
  constexpr int out_floats = kTD * kTH * kTW * OT;
  return (27 * kCB * OT + (kInFloats > out_floats ? kInFloats : out_floats)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int OT>
__global__ void __launch_bounds__(kThreads)
    conv3_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ y, int D, int H, int W, int C, int O,
                        int nTD, int nTH, int nTW, int act, float slope) {
  constexpr int kWIters = (27 * kCB * OT + kThreads - 1) / kThreads;
  extern __shared__ float sm[];
  float* s_w = sm;                     // [27][kCB][OT]
  float* s_in = sm + 27 * kCB * OT;    // [kCB][kID][kIH][kIWP]
  float* s_out = s_in;                 // [kTD][kTH][kTW][OT], after compute

  int bid = blockIdx.x;
  const int ow0 = (bid % nTW) * kTW;
  bid /= nTW;
  const int oh0 = (bid % nTH) * kTH;
  bid /= nTH;
  const int od0 = (bid % nTD) * kTD;
  const long long b = bid / nTD;
  const int o0 = blockIdx.y * OT;
  const int OD = D - 2, OH = H - 2, OW = W - 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dd = warp >> 1, h0 = (warp & 1) * 4;

  float acc[4][OT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[i][o] = 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += kCB) {
    const int cn = min(kCB, C - c0);
    // Every load of the pass is issued before the first is used (unrolled
    // into registers), so the pass waits for memory once, not once per
    // element.  Weights: element i of [27][kCB][OT].
    float wv[kWIters];
#pragma unroll
    for (int it = 0; it < kWIters; ++it) {
      const int i = tid + it * kThreads;
      const int o = i % OT, ci = (i / OT) % kCB, tap = i / (OT * kCB);
      wv[it] = (i < 27 * kCB * OT && ci < cn && o0 + o < O)
                   ? to_f32<T>(w[(static_cast<long long>(tap) * C + c0 + ci) *
                                     O + o0 + o])
                   : 0.f;
    }
    // Input: one voxel per thread and step (neighbouring threads on
    // neighbouring voxels), its cn channels.
    float xin[kInIters][kCB];
#pragma unroll
    for (int it = 0; it < kInIters; ++it) {
      const int i = tid + it * kThreads;
      const int xx = i % kIW, yy = (i / kIW) % kIH, z = i / (kIW * kIH);
      const int d = od0 + z, h = oh0 + yy, ww = ow0 + xx;
      const bool ok = i < kInVox && d < D && h < H && ww < W;
      const T* src =
          x + (((b * D + d) * H + h) * static_cast<long long>(W) + ww) * C +
          c0;
#pragma unroll
      for (int ci = 0; ci < kCB; ++ci) {
        xin[it][ci] = ok && ci < cn ? to_f32<T>(src[ci]) : 0.f;
      }
    }
    __syncthreads();  // the previous pass's reads are done
#pragma unroll
    for (int it = 0; it < kWIters; ++it) {
      const int i = tid + it * kThreads;
      if (i < 27 * kCB * OT) s_w[i] = wv[it];
    }
#pragma unroll
    for (int it = 0; it < kInIters; ++it) {
      const int i = tid + it * kThreads;
      if (i < kInVox) {
        const int xx = i % kIW, yy = (i / kIW) % kIH, z = i / (kIW * kIH);
        float* dst = s_in + (z * kIH + yy) * kIWP + xx;
#pragma unroll
        for (int ci = 0; ci < kCB; ++ci) {
          if (ci < cn) dst[ci * kID * kIH * kIWP] = xin[it][ci];
        }
      }
    }
    __syncthreads();

    for (int ci = 0; ci < cn; ++ci) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const float* col =
            s_in + ((ci * kID + dd + kd) * kIH + h0) * kIWP + lane;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float xv[6];
#pragma unroll
          for (int j = 0; j < 6; ++j) xv[j] = col[j * kIWP + kw];
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            const float* wt = s_w + (((kd * 3 + kh) * 3 + kw) * kCB + ci) * OT;
            float wr[OT];
            if constexpr (OT % 4 == 0) {  // 16-byte broadcast reads
#pragma unroll
              for (int o = 0; o < OT; o += 4) {
                const float4 q = *reinterpret_cast<const float4*>(wt + o);
                wr[o] = q.x;
                wr[o + 1] = q.y;
                wr[o + 2] = q.z;
                wr[o + 3] = q.w;
              }
            } else {
#pragma unroll
              for (int o = 0; o < OT; ++o) wr[o] = wt[o];
            }
#pragma unroll
            for (int o = 0; o < OT; ++o) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[i][o] = fmaf(xv[i + kh], wr[o], acc[i][o]);
              }
            }
          }
        }
      }
    }
  }

  __syncthreads();  // s_in is reused as s_out
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 0; o < OT; ++o) {
      const float a = acc[i][o];
      s_out[((dd * kTH + h0 + i) * kTW + lane) * OT + o] =
          act ? conv_leaky<T>(a, slope) : a;
    }
  }
  __syncthreads();
  const int nw = min(kTW, OW - ow0), no = min(OT, O - o0);
  if (no == OT) {
    // all OT channels: each (z, h) row of the tile is nw * OT contiguous
    // values in both s_out and y; one warp writes one row at a time
    for (int row = warp; row < kTD * kTH; row += kThreads / 32) {
      const int od = od0 + row / kTH, oh = oh0 + row % kTH;
      if (od >= OD || oh >= OH) continue;
      T* dst = y + (((b * OD + od) * OH + oh) * static_cast<long long>(OW) +
                    ow0) * O + o0;
      const float* src = s_out + row * kTW * OT;
      for (int e = lane; e < nw * OT; e += 32) {
        dst[(e / OT) * O + e % OT] = from_f32<T>(src[e]);
      }
    }
    return;
  }
  for (int i = tid; i < kTD * kTH * nw * no; i += kThreads) {
    const int o = i % no;
    int r = i / no;
    const int ww = r % nw;
    r /= nw;
    const int hh = r % kTH, z = r / kTH;
    const int od = od0 + z, oh = oh0 + hh;
    if (od < OD && oh < OH) {
      y[(((b * OD + od) * OH + oh) * static_cast<long long>(OW) + ow0 + ww) *
            O + o0 + o] =
          from_f32<T>(s_out[((z * kTH + hh) * kTW + ww) * OT + o]);
    }
  }
}

template <typename T, int OT>
cudaError_t launch(const void* x, const void* w, void* y, int B, int D, int H,
                   int W, int C, int O, int act, float slope, cudaStream_t s) {
  const int nTD = (D - 2 + kTD - 1) / kTD;
  const int nTH = (H - 2 + kTH - 1) / kTH;
  const int nTW = (W - 2 + kTW - 1) / kTW;
  const long long blocks = static_cast<long long>(B) * nTD * nTH * nTW;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>((O + OT - 1) / OT));
  conv3_direct_kernel<T, OT><<<grid, kThreads, smem_bytes<OT>(), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      D, H, W, C, O, nTD, nTH, nTW, act, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* y, int B, int D,
                     int H, int W, int C, int O, int act, float slope,
                     cudaStream_t s) {
  // output channels per block: O rounded up to a power of two, at most 8
  if (O <= 1) return launch<T, 1>(x, w, y, B, D, H, W, C, O, act, slope, s);
  if (O <= 2) return launch<T, 2>(x, w, y, B, D, H, W, C, O, act, slope, s);
  if (O <= 4) return launch<T, 4>(x, w, y, B, D, H, W, C, O, act, slope, s);
  return launch<T, 8>(x, w, y, B, D, H, W, C, O, act, slope, s);
}

}  // namespace direct
}  // namespace tem

extern "C" {

int tem_conv3_direct(const void* x, const void* w, void* y, int dtype, int B,
                     int D, int H, int W, int C, int O, int act, float slope,
                     void* stream) {
  if (B <= 0 || D < 3 || H < 3 || W < 3 || C <= 0 || O <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == tem::kF32) {
    e = tem::direct::dispatch<float>(x, w, y, B, D, H, W, C, O, act, slope, s);
  } else if (dtype == tem::kBF16) {
    e = tem::direct::dispatch<__nv_bfloat16>(x, w, y, B, D, H, W, C, O, act,
                                             slope, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
