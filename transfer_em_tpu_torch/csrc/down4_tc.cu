// 4x4x4 stride-2 VALID convolution on Hopper's tensor cores, channels-last,
// float32 as 3xTF32, with an optional fused LeakyReLU epilogue: the U-Net's
// k4 down convs (models/blocks.py DownBlock) in float32 inference.
//
//   x (B, D, H, W, C)  *  w (4, 4, 4, C, O)
//       ->  y (B, D/2 - 1, H/2 - 1, W/2 - 1, O)
//
// It replaces no TPU kernel: the JAX package leaves these convs to XLA
// (transfer_em_tpu/ops/convs.py conv_nd).  The port first ran them on
// cuDNN's CUDA-core f32 engine, then as a space-to-depth copy of x and a
// 3x3x3 conv on conv3_tc.cu whose kernel was zero in 19 of its 27 taps.
// This kernel reads x in place at stride 2 and multiplies only the 64 real
// taps.
//
// What bounds it on the H100: each output needs 64*C*O multiply-adds and
// reads 8*C input values of its own, so at the wf=8 generator's widths
// (8 -> 8, 16 -> 16) the bound is bytes (down1.down at B=128 reads 1.4 GB
// of x, 0.42 ms at 3.35 TB/s, for 41 GFLOP, 0.25 ms at 165 TFLOP/s of
// 3xTF32); from 64 channels (wf=1) it is operations.  Float32 must stay
// float32-accurate (the served path is held against a reference with TF32
// off), so the products run as 3xTF32, split and summed as conv3_tc.cu
// does: x_lo*w_hi + x_hi*w_lo + x_hi*w_hi in f32.
//
// Design: an implicit GEMM, M = output voxels, N = O, K = 64*C, every term
// of K a real tap.
//   * One block is one warpgroup (128 threads).  An m64 tile is 4x4x4
//     outputs (warp w: output plane w of the tile; lane group g: row g/4,
//     column g%4, and rows g/4 + 2 for the MMA's second row set), so a
//     34^3 output wastes 1 - (34/36)^3 of the products, not the
//     1 - (34/40)^2 of 8x8 planes.  A block owns P such tiles side by side
//     along W (P = 1 at N = 8, 2 from 16: ``launch``) and one chunk of NC
//     output channels (blockIdx.y); tiles wholly past the edge are skipped.
//   * Its input patch, 10 x 10 x (8P + 2) voxels of 8 channels (one TF32
//     k-step a tap; C zero-padded to a multiple of 8), is copied from x
//     in place by 16-byte cp.async (zero-fill past the edge; element
//     copies where C is not a multiple of 4), in x's order, and stored
//     with the two parities of W apart: lane group g's voxels at tap kw
//     are then 8 words apart, so its 64-bit A reads are free of bank
//     conflicts though they step by 2 in x.  No space-to-depth copy and no
//     pad block: the bytes read are x's.
//   * Weights are packed once per parameter by the Python wrapper
//     (ops/cuda_down.py pack_down4_weights) into the B layout conv3_tc.cu
//     uses (K-major core matrices of 8 output channels x 16 bytes, TF32 hi
//     and lo parts), in 16 stages of one (kd, kh) tap row: 4 kw taps of one
//     k-step each.  They stream through two stage buffers, the next in
//     flight while one is used, one barrier a stage.
//   * A is gathered from the patch into registers and split into TF32 hi
//     and lo there; two register sets alternate so that one k-step's loads
//     overlap the previous k-step's products on wgmma (m64nNCk8, B from
//     shared memory).
//   * Epilogue: LeakyReLU on the f32 sums, ragged tiles and channels
//     masked, stored channels-last.
// At N = 8 the tensor cores' rate with A from registers is 142 TFLOP/s of
// TF32 (kernels/wgmma_probe.py), 47 of 3xTF32: at the generator's
// down1.down that, not the bytes, is what the kernel runs up against.
#include "common.cuh"
#include "wgmma.cuh"

namespace tem {
namespace down4 {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::fence_operands;
using tc::fence_proxy_async;
using tc::make_desc;
using tc::mma_tf32;
using tc::smem_u32;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait;

constexpr int kT = 4;            // an m64 tile is kT^3 outputs
constexpr int kIn = 2 * kT + 2;  // its input extent along an axis
constexpr int kCB = 8;           // channels per channel block: one k-step
constexpr int kThreads = 128;    // one warpgroup
constexpr int kStages = 16;      // (kd, kh) tap rows

template <int NC, int P>
struct Cfg {
  static constexpr int kIW = 2 * kT * P + 2;  // patch extent along W
  static constexpr int kWB = kIW / 2;         // voxels of one W parity
  static constexpr int kVox = kIn * kIn * kIW;
  static constexpr int kInBytes = kVox * kCB * 4;
  static constexpr int kStepBytes = NC * 32;  // one part of one k-step
  static constexpr int kStageBytes = 4 * 2 * kStepBytes;  // 4 kw, hi and lo
  static constexpr int kAcc = NC / 2;         // accumulators per tile
  // words from a voxel of row set g to the one of row set g + 8 (4 rows on)
  static constexpr int kRow8 = 4 * 2 * kWB * kCB;
};

// The patch slot of input voxel (sd, sh, sw): W's parities apart.
template <int NC, int P>
__device__ __forceinline__ int slot(int sd, int sh, int sw) {
  return ((sd * kIn + sh) * 2 + (sw & 1)) * Cfg<NC, P>::kWB + (sw >> 1);
}

// The input patch of the tile group whose patch starts at (d0, h0, w0) of
// sample b, channels [c0, c0 + 8), into s_in: copied in x's order (16-byte
// cp.async of consecutive voxels along W, zero-filled past the edge, or
// element copies where C is not a multiple of 4), stored in its slots.
template <int NC, int P>
__device__ __forceinline__ void load_patch(uint8_t* s_in,
                                           const float* __restrict__ x,
                                           long long b, int d0, int h0,
                                           int w0, int c0, int D, int H,
                                           int W, int C, int aligned,
                                           int tid) {
  using K = Cfg<NC, P>;
  if (aligned) {
    for (int i = tid; i < K::kVox * 2; i += kThreads) {
      const int half = i & 1;  // two 16-byte copies a voxel
      int v = i >> 1;
      const int sw = v % K::kIW;
      v /= K::kIW;
      const int sh = v % kIn, sd = v / kIn;
      const int d = d0 + sd, h = h0 + sh, w = w0 + sw, c = c0 + 4 * half;
      const bool ok = d < D && h < H && w < W && c < C;
      const float* src =
          ok ? x + (((b * D + d) * H + h) * static_cast<long long>(W) + w) *
                           C + c
             : x;
      cp_async16(
          smem_u32(s_in + slot<NC, P>(sd, sh, sw) * kCB * 4 + half * 16),
          src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < K::kVox * kCB; i += kThreads) {
      const int e = i % kCB;
      int v = i / kCB;
      const int sw = v % K::kIW;
      v /= K::kIW;
      const int sh = v % kIn, sd = v / kIn;
      const int d = d0 + sd, h = h0 + sh, w = w0 + sw, c = c0 + e;
      const bool ok = d < D && h < H && w < W && c < C;
      reinterpret_cast<float*>(s_in)[slot<NC, P>(sd, sh, sw) * kCB + e] =
          ok ? x[(((b * D + d) * H + h) * static_cast<long long>(W) + w) * C +
                 c]
             : 0.f;
    }
  }
}

// The products of one (kd, kh) stage: its 4 kw k-steps for the live tiles,
// A from the patch words at in_w (this thread's tap (0, 0, 0) of tile 0),
// B from the stage's weights at ``stage`` in shared memory.
template <int NC, int P>
__device__ __forceinline__ void stage_products(float (&acc)[P][NC / 2],
                                               const uint32_t* in_w,
                                               const uint8_t* stage, int kd,
                                               int kh, int live) {
  using K = Cfg<NC, P>;
  uint32_t a[2][P][2][4];
#pragma unroll
  for (int kw = 0; kw < 4; ++kw) {
    const int buf = kw & 1;
    const uint32_t* src0 =
        in_w + (((kd * kIn + kh) * 2 + (kw & 1)) * K::kWB + (kw >> 1)) * kCB;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      // tile p is kT voxels of each parity on along W
      const uint32_t* src = src0 + p * kT * kCB;
      const uint2 row0 = *reinterpret_cast<const uint2*>(src);
      const uint2 row1 = *reinterpret_cast<const uint2*>(src + K::kRow8);
      const uint32_t r[4] = {row0.x, row1.x, row0.y, row1.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t hi = r[i] & 0xFFFFE000u;  // TF32 by truncation
        a[buf][p][0][i] = hi;
        a[buf][p][1][i] = __float_as_uint(
            __fsub_rn(__uint_as_float(r[i]), __uint_as_float(hi)));
      }
    }
    const uint32_t step = smem_u32(stage + kw * 2 * K::kStepBytes);
    const uint64_t d_hi = make_desc(step);
    const uint64_t d_lo = make_desc(step + K::kStepBytes);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p < live) {
        mma_tf32(acc[p], a[buf][p][1], d_hi);  // x_lo * w_hi
        mma_tf32(acc[p], a[buf][p][0], d_lo);  // x_hi * w_lo
        mma_tf32(acc[p], a[buf][p][0], d_hi);  // x_hi * w_hi
      }
    }
    wgmma_commit();
    // k-step kw - 1 is done, so its register set may be reloaded
    if (kw < 3) wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < P; ++p) fence_operands(acc[p]);
}

template <int NC, int P>
__global__ void __launch_bounds__(kThreads)
    down4_tc_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                    float* __restrict__ y, int D, int H, int W, int C, int O,
                    int n_cb, int nTD, int nTH, int nTW, int aligned, int act,
                    float slope) {
  using K = Cfg<NC, P>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_in = smem;
  uint8_t* s_w = smem + K::kInBytes;  // two stage buffers

  int bid = blockIdx.x;
  const int ow0 = (bid % nTW) * kT * P;
  bid /= nTW;
  const int oh0 = (bid % nTH) * kT;
  bid /= nTH;
  const int od0 = (bid % nTD) * kT;
  const long long b = bid / nTD;
  const int OD = D / 2 - 1, OH = H / 2 - 1, OW = W / 2 - 1;
  const int live = min(P, (OW - ow0 + kT - 1) / kT);  // tiles with outputs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* wchunk = wp + static_cast<size_t>(blockIdx.y) * n_cb *
                                   kStages * K::kStageBytes;
  // this thread's A words at tap (0, 0, 0) of tile 0: row set g's voxel
  // (2 warp, 2 (g / 4), 2 (g % 4)), words 2t and 2t + 1 (channels 2t and
  // 2t + 1, K indices t and t + 4: pack_down4_weights permutes K so)
  const uint32_t* in_w =
      reinterpret_cast<const uint32_t*>(s_in) +
      slot<NC, P>(2 * warp, 2 * (g >> 2), 2 * (g & 3)) * kCB + 2 * t;

  float acc[P][K::kAcc];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int i = 0; i < K::kAcc; ++i) acc[p][i] = 0.f;
  }
  for (int cbi = 0; cbi < n_cb; ++cbi) {
    if (cbi > 0) __syncthreads();  // the previous block's reads are done
    load_patch<NC, P>(s_in, x, b, 2 * od0, 2 * oh0, 2 * ow0, cbi * kCB, D, H,
                      W, C, aligned, tid);
    const uint8_t* wblk =
        wchunk + static_cast<size_t>(cbi) * kStages * K::kStageBytes;
    auto load_stage = [&](int st) {
      const uint8_t* src = wblk + static_cast<size_t>(st) * K::kStageBytes;
      const uint32_t dst = smem_u32(s_w + (st & 1) * K::kStageBytes);
      for (int i = tid; i < K::kStageBytes / 16; i += kThreads) {
        cp_async16(dst + i * 16, src + i * 16, 16);
      }
      cp_async_commit();
    };
    load_stage(0);  // with the patch
    for (int st = 0; st < kStages; ++st) {
      cp_async_wait<0>();  // stage st (and the patch) have landed
      fence_proxy_async();
      // ... for every thread, and every thread is done with stage st - 1,
      // whose buffer takes stage st + 1 while stage st's products run
      __syncthreads();
      if (st + 1 < kStages) load_stage(st + 1);
      stage_products<NC, P>(acc, in_w, s_w + (st & 1) * K::kStageBytes,
                            st >> 2, st & 3, live);
    }
  }

  // -- epilogue: LeakyReLU on the f32 sums, ragged tiles and channels
  // masked, stored channels-last ---------------------------------------------
  const int nbase = blockIdx.y * NC + 2 * t;
  const int od = od0 + warp;
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int oh = oh0 + (g >> 2) + 2 * half;
      const int ow = ow0 + p * kT + (g & 3);
      if (od < OD && oh < OH && ow < OW) {
        float* out =
            y + (((b * OD + od) * OH + oh) * static_cast<long long>(OW) + ow) *
                    O;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int n = nbase + 8 * j;
          float v0 = acc[p][4 * j + 2 * half];
          float v1 = acc[p][4 * j + 2 * half + 1];
          if (act) {
            v0 = leaky(v0, slope);
            v1 = leaky(v1, slope);
          }
          if (n + 1 < O) {
            out[n] = v0;
            out[n + 1] = v1;
          } else if (n < O) {
            out[n] = v0;
          }
        }
      }
    }
  }
}

// P: a block owns one tile at N = 8, where its products are cheap beside its
// patch and more resident blocks pay most, and two from N = 16, where the
// second tile's products reuse the patch and the weight stages.
template <int NC, int P = NC == 8 ? 1 : 2>
cudaError_t launch(const void* x, const void* wp, void* y, int B, int D, int H,
                   int W, int C, int O, int act, float slope, cudaStream_t s) {
  using K = Cfg<NC, P>;
  const int nTD = (D / 2 - 1 + kT - 1) / kT;
  const int nTH = (H / 2 - 1 + kT - 1) / kT;
  const int nTW = (W / 2 - 1 + kT * P - 1) / (kT * P);
  const int n_cb = (C + kCB - 1) / kCB;
  const long long blocks = static_cast<long long>(B) * nTD * nTH * nTW;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const bool aligned =
      C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int smem = K::kInBytes + 2 * K::kStageBytes;
  auto kern = down4_tc_kernel<NC, P>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>((O + NC - 1) / NC));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(wp),
      static_cast<float*>(y), D, H, W, C, O, n_cb, nTD, nTH, nTW,
      aligned ? 1 : 0, act, slope);
  return cudaGetLastError();
}

}  // namespace down4
}  // namespace tem

extern "C" {

// wp: the weights packed by ops/cuda_down.py pack_down4_weights for this
// (C, O); nc is its output-channel chunk (8, 16, 32 or 64).
int tem_down4_tc(const void* x, const void* wp, void* y, int B, int D, int H,
                 int W, int C, int O, int nc, int act, float slope,
                 void* stream) {
  if (B <= 0 || D < 4 || H < 4 || W < 4 || C <= 0 || O <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nc) {
    case 8:
      e = tem::down4::launch<8>(x, wp, y, B, D, H, W, C, O, act, slope, s);
      break;
    case 16:
      e = tem::down4::launch<16>(x, wp, y, B, D, H, W, C, O, act, slope, s);
      break;
    case 32:
      e = tem::down4::launch<32>(x, wp, y, B, D, H, W, C, O, act, slope, s);
      break;
    case 64:
      e = tem::down4::launch<64>(x, wp, y, B, D, H, W, C, O, act, slope, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
