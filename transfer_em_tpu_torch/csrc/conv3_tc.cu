// 3x3x3 stride-1 VALID convolution on Hopper's tensor cores, channels-last,
// with an optional fused LeakyReLU epilogue: the Hopper counterpart of the
// Pallas Toeplitz-GEMM kernel _tconv3_kernel (transfer_em_tpu/ops/
// pallas_conv.py:69-114, called at :174 from _tconv3_call 162-193 through
// tconv3 / tconv3_op / tconv3_act_op) for C >= 4 input and O >= 8 output
// channels.  conv3_direct.cu takes the other shapes.
//
//   x (B, D, H, W, C)  *  w (3, 3, 3, C, O)  ->  y (B, D-2, H-2, W-2, O)
//
// What bounds it on the H100: at the generator's widths each output voxel
// needs 27*C*O multiply-adds against C + O values moved, so above C = 8 the
// work is operations.  Float32 must stay float32-accurate (the served path
// is held against the JAX reference with TF32 off), so the f32 products run
// as 3xTF32 on the tensor cores: x = x_hi + x_lo and w = w_hi + w_lo with
// the hi parts rounded to TF32, and x_lo*w_hi + x_hi*w_lo + x_hi*w_hi summed
// in f32 (up to 495/3 = 165 TFLOP/s of f32-accurate products, against 67 on
// the CUDA cores).  bfloat16 is one bf16 product summed in f32.
//
// Design: an implicit GEMM, M = output voxels, N = O, K = 27*C.
//   * One block is one warpgroup (128 threads).  It owns an 8x8 (H, W)
//     patch of P consecutive output planes (P m64 tiles; P = 4, or 2 at
//     NC = 64) and one chunk of NC output channels (blockIdx.y).
//   * Its P+2 input planes of the 10x10 patch with halo sit in shared memory
//     for one block of CB channels at a time (32 or 64 bytes of a voxel; C is
//     zero-padded to a multiple of CB), filled by 16-byte cp.async copies
//     (zero-fill past the volume's edge) or, where C is not a multiple of 16
//     bytes, by element copies.
//   * Weights are packed once by the Python wrapper (ops/cuda_conv.py
//     pack_conv3_weights) into the wgmma B layout (K-major, no swizzle: core
//     matrices of 8 output channels x 16 bytes; LBO 128 B between the two K
//     halves, SBO 256 B between groups of 8 channels), f32 as TF32 hi and lo
//     parts, in stages of one (kd, kh) tap row (3 kw taps x CB channels).
//     Where the 9 stages of a channel block fit beside the input (the host
//     decides: ``resident``), they arrive together with the input and the
//     block computes all 27 taps after one wait.  Otherwise they stream
//     through two stage buffers by cp.async, the next stage in flight while
//     the current one is used; so any C and O of UNetGenerator(wf), wf
//     1..32, fits.
//   * A is gathered from the input patch into registers (the im2col is
//     implicit) and fed to wgmma.mma_async with A from registers and B from
//     shared memory (m64nNCk8 .tf32, m64nNCk16 .bf16).  The packing permutes
//     K inside each k-step so that a thread's A words (k t and k t+4) are
//     neighbours in shared memory: one 64-bit read per row.  For f32 the
//     thread splits x into hi = x truncated to TF32 and lo = x - hi (exact)
//     in registers.  Two register sets of A alternate so that one k-step's
//     loads overlap the previous k-step's products.
//   * Epilogue: LeakyReLU on the f32 accumulators (in bf16 on the value
//     rounded to bf16 first, as JAX's default path and not its Pallas
//     kernel computes it: common.cuh conv_leaky), rounded to T, ragged
//     rows, planes and channels masked, stored channels-last.
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace tem {
namespace tc {

constexpr int kTH = 8, kTW = 8;  // output patch of one m64 tile
constexpr int kIW = kTW + 2;     // input patch row, with halo
constexpr int kVox = (kTH + 2) * kIW;  // 100 input voxels per plane

template <typename T, int NC, int CS>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kEs = sizeof(T);
  static constexpr int kKK = kF32 ? 8 : 16;   // MMA depth in elements
  static constexpr int kCB = CS * kKK;        // channels per channel block
  static constexpr int kParts = kF32 ? 2 : 1; // hi, lo
  static constexpr int kP = NC <= 32 ? 4 : 2; // output planes per block
  static constexpr int kThreads = 128;        // one warpgroup
  static constexpr int kSlots = kP + 2;       // input planes per block
  // words per voxel in smem: a channel block is 8 * CS words; CS = 2 gets
  // 8 words of padding so that the 64-bit A reads below are free of bank
  // conflicts (4 voxels x 8 words of one k-step fall on distinct banks)
  static constexpr int kVSW = CS == 1 ? 8 : 24;
  static constexpr int kVSB = kVSW * 4;
  static constexpr int kInBytes = kSlots * kVox * kVSB;
  static constexpr int kKSteps = 3 * CS;      // k-steps per stage
  static constexpr int kStepBytes = NC * 32;  // one part of one k-step
  static constexpr int kStageBytes = kKSteps * kParts * kStepBytes;
  static constexpr int kAcc = NC / 2;         // accumulators per tile
  // shared memory: input patch, then 9 (resident) or 2 stage buffers
  static constexpr int smem(bool resident) {
    return kInBytes + (resident ? 9 : 2) * kStageBytes;
  }
};

template <typename T, int NC, int CS>
__global__ void __launch_bounds__(Cfg<T, NC, CS>::kThreads)
    conv3_tc_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wp,
                    T* __restrict__ y, int D, int H, int W, int C, int O,
                    int n_cb, int nTD, int nTH, int nTW, int aligned,
                    int resident, int act, float slope) {
  using K = Cfg<T, NC, CS>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_in = smem;
  uint8_t* s_w = smem + K::kInBytes;

  int bid = blockIdx.x;
  const int tw = bid % nTW;
  bid /= nTW;
  const int th = bid % nTH;
  bid /= nTH;
  const int od0 = (bid % nTD) * K::kP;
  const long long b = bid / nTD;
  const int oh0 = th * kTH, ow0 = tw * kTW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int OD = D - 2, OH = H - 2, OW = W - 2;
  const uint8_t* wchunk =
      wp + static_cast<size_t>(blockIdx.y) * n_cb * 9 * K::kStageBytes;

  float acc[K::kP][K::kAcc];
#pragma unroll
  for (int p = 0; p < K::kP; ++p) {
#pragma unroll
    for (int i = 0; i < K::kAcc; ++i) acc[p][i] = 0.f;
  }

  for (int cbi = 0; cbi < n_cb; ++cbi) {
    if (cbi > 0) __syncthreads();  // the previous block's reads are done
    const int c0 = cbi * K::kCB;
    // -- input patch, channels [c0, c0 + CB), P+2 planes ------------------
    if (aligned) {
      constexpr int kChunks = K::kCB * K::kEs / 16;  // 16 B per copy
      for (int i = tid; i < K::kSlots * kVox * kChunks; i += K::kThreads) {
        const int ch = i % kChunks;
        const int v = (i / kChunks) % kVox;
        const int s = i / (kChunks * kVox);
        const int d = od0 + s, h = oh0 + v / kIW, w = ow0 + v % kIW;
        const int c = c0 + ch * (16 / K::kEs);
        const bool ok = d < D && h < H && w < W && c < C;
        const T* src =
            ok ? x + (((b * D + d) * H + h) * static_cast<long long>(W) + w) *
                             C + c
               : x;
        cp_async16(smem_u32(s_in + (s * kVox + v) * K::kVSB + ch * 16), src,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < K::kSlots * kVox * K::kCB; i += K::kThreads) {
        const int e = i % K::kCB;
        const int v = (i / K::kCB) % kVox;
        const int s = i / (K::kCB * kVox);
        const int d = od0 + s, h = oh0 + v / kIW, w = ow0 + v % kIW;
        const int c = c0 + e;
        const bool ok = d < D && h < H && w < W && c < C;
        reinterpret_cast<T*>(s_in + (s * kVox + v) * K::kVSB)[e] =
            ok ? x[(((b * D + d) * H + h) * static_cast<long long>(W) + w) *
                       C + c]
               : from_f32<T>(0.f);
      }
    }
    // -- weight stages: one (kd, kh) tap row each ---------------------------
    const uint8_t* wblk = wchunk + static_cast<size_t>(cbi) * 9 *
                                       K::kStageBytes;
    auto load_stages = [&](int st0, int n, int buf) {
      const uint8_t* src = wblk + static_cast<size_t>(st0) * K::kStageBytes;
      const uint32_t dst = smem_u32(s_w + buf * K::kStageBytes);
      for (int i = tid; i < n * K::kStageBytes / 16; i += K::kThreads) {
        cp_async16(dst + i * 16, src + i * 16, 16);
      }
      cp_async_commit();
    };
    if (resident) {
      load_stages(0, 9, 0);  // the whole channel block, with the input
    } else {
      load_stages(0, 1, 0);
    }

    for (int st = 0; st < 9; ++st) {
      if (!resident && st + 1 < 9) {
        load_stages(st + 1, 1, (st + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      if (!resident || st == 0) {
        fence_proxy_async();
        __syncthreads();
      }

      const int kd = st / 3, kh = st % 3;
      const uint32_t* in_w =
          reinterpret_cast<const uint32_t*>(s_in) +
          (kd * kVox + (2 * warp + kh) * kIW + g) * K::kVSW + 2 * t;
      const uint32_t w_addr =
          smem_u32(s_w + (resident ? st : st & 1) * K::kStageBytes);
      uint32_t a[2][K::kP][K::kParts][4];
#pragma unroll
      for (int ks = 0; ks < K::kKSteps; ++ks) {
        const int kw = ks / CS, cs = ks % CS, buf = ks & 1;
#pragma unroll
        for (int p = 0; p < K::kP; ++p) {
          // words 2t, 2t+1 of the k-step hold (a0, a2) of row g, the same
          // words one input row on hold (a1, a3): the packed weights permute
          // K so (pack_conv3_weights)
          const uint32_t* src = in_w + (p * kVox + kw) * K::kVSW + cs * 8;
          const uint2 row0 = *reinterpret_cast<const uint2*>(src);
          const uint2 row1 =
              *reinterpret_cast<const uint2*>(src + kIW * K::kVSW);
          const uint32_t r[4] = {row0.x, row1.x, row0.y, row1.y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (K::kF32) {
              const uint32_t hi = r[i] & 0xFFFFE000u;  // TF32 by truncation
              a[buf][p][0][i] = hi;
              a[buf][p][K::kParts - 1][i] = __float_as_uint(
                  __fsub_rn(__uint_as_float(r[i]), __uint_as_float(hi)));
            } else {
              a[buf][p][0][i] = r[i];
            }
          }
        }
        wgmma_fence();
        const uint32_t step = w_addr + ks * K::kParts * K::kStepBytes;
#pragma unroll
        for (int p = 0; p < K::kP; ++p) {
          if constexpr (K::kF32) {
            const uint64_t d_hi = make_desc(step);
            const uint64_t d_lo = make_desc(step + K::kStepBytes);
            mma_tf32(acc[p], a[buf][p][1], d_hi);  // x_lo * w_hi
            mma_tf32(acc[p], a[buf][p][0], d_lo);  // x_hi * w_lo
            mma_tf32(acc[p], a[buf][p][0], d_hi);  // x_hi * w_hi
          } else {
            mma_bf16(acc[p], a[buf][p][0], make_desc(step));
          }
        }
        wgmma_commit();
        // k-step ks - 1 is done, so its register set may be reloaded
        if (ks + 1 < K::kKSteps) wgmma_wait<1>();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < K::kP; ++p) fence_operands(acc[p]);
      // a streamed stage buffer is reloaded next iteration
      if (!resident) __syncthreads();
    }
  }

  // -- epilogue --------------------------------------------------------------
  const int nbase = blockIdx.y * NC + 2 * t;
#pragma unroll
  for (int p = 0; p < K::kP; ++p) {
    const int od = od0 + p;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int oh = oh0 + 2 * warp + half, ow = ow0 + g;
      if (od < OD && oh < OH && ow < OW) {
        T* out = y + (((b * OD + od) * OH + oh) * static_cast<long long>(OW) +
                      ow) * O;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int n = nbase + 8 * j;
          float v0 = acc[p][4 * j + 2 * half];
          float v1 = acc[p][4 * j + 2 * half + 1];
          if (act) {
            v0 = conv_leaky<T>(v0, slope);
            v1 = conv_leaky<T>(v1, slope);
          }
          if (n + 1 < O) {
            out[n] = from_f32<T>(v0);
            out[n + 1] = from_f32<T>(v1);
          } else if (n < O) {
            out[n] = from_f32<T>(v0);
          }
        }
      }
    }
  }
}

template <typename T, int NC, int CS>
cudaError_t launch(const void* x, const void* wp, void* y, int B, int D, int H,
                   int W, int C, int O, int resident, int act, float slope,
                   cudaStream_t s) {
  using K = Cfg<T, NC, CS>;
  const int nTD = (D - 2 + K::kP - 1) / K::kP;
  const int nTH = (H - 2 + kTH - 1) / kTH;
  const int nTW = (W - 2 + kTW - 1) / kTW;
  const int n_cb = (C + K::kCB - 1) / K::kCB;
  const long long blocks = static_cast<long long>(B) * nTD * nTH * nTW;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const bool aligned = C % (16 / K::kEs) == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int smem = K::smem(resident != 0);
  auto kern = conv3_tc_kernel<T, NC, CS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>((O + NC - 1) / NC));
  kern<<<grid, K::kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(wp),
      static_cast<T*>(y), D, H, W, C, O, n_cb, nTD, nTH, nTW, aligned ? 1 : 0,
      resident, act, slope);
  return cudaGetLastError();
}

template <typename T, int CS>
cudaError_t dispatch_nc(int nc, const void* x, const void* wp, void* y, int B,
                        int D, int H, int W, int C, int O, int resident,
                        int act, float slope, cudaStream_t s) {
  switch (nc) {
    case 8:
      return launch<T, 8, CS>(x, wp, y, B, D, H, W, C, O, resident, act,
                              slope, s);
    case 16:
      return launch<T, 16, CS>(x, wp, y, B, D, H, W, C, O, resident, act,
                               slope, s);
    case 32:
      return launch<T, 32, CS>(x, wp, y, B, D, H, W, C, O, resident, act,
                               slope, s);
    case 64:
      return launch<T, 64, CS>(x, wp, y, B, D, H, W, C, O, resident, act,
                               slope, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int cb, int nc, const void* x, const void* wp, void* y,
                     int B, int D, int H, int W, int C, int O, int resident,
                     int act, float slope, cudaStream_t s) {
  constexpr int kk = std::is_same<T, float>::value ? 8 : 16;
  if (cb == kk) {
    return dispatch_nc<T, 1>(nc, x, wp, y, B, D, H, W, C, O, resident, act,
                             slope, s);
  }
  if (cb == 2 * kk) {
    return dispatch_nc<T, 2>(nc, x, wp, y, B, D, H, W, C, O, resident, act,
                             slope, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace tem

extern "C" {

// wp: the weights packed by ops/cuda_conv.py pack_conv3_weights for this
// (C, O, dtype); cb and nc are its channel block and output-channel chunk,
// resident whether a channel block's 9 weight stages are loaded at once.
int tem_conv3_tc(const void* x, const void* wp, void* y, int dtype, int B,
                 int D, int H, int W, int C, int O, int cb, int nc,
                 int resident, int act, float slope, void* stream) {
  if (B <= 0 || D < 3 || H < 3 || W < 3 || C <= 0 || O <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == tem::kF32) {
    e = tem::tc::dispatch<float>(cb, nc, x, wp, y, B, D, H, W, C, O,
                                 resident, act, slope, s);
  } else if (dtype == tem::kBF16) {
    e = tem::tc::dispatch<__nv_bfloat16>(cb, nc, x, wp, y, B, D, H, W, C, O,
                                         resident, act, slope, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
