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
// What bounds the narrow layers (O <= 32, wf=8's 8-32 channels) in the tap
// form is the MMA's rate at small N, not bytes: with O on wgmma's N, tf32
// wgmma runs at 143 TFLOP/s at N = 8 and 295 at N = 16 against 481 at
// N = 64 (kernels/wgmma_probe.py), and at N = 8 even that ceiling is several
// times the layer's byte bound.  So f32 at O <= 32 takes the kw form
// (conv3_tc_kernel_kw, below): the three kw taps' weights side by side in
// N = 3*O, K = 9*C (the (kd, kh) taps), M = input voxels along w, each
// output the sum of three rows shifted along w (warp shuffles in the
// epilogue).  Its products then run at the rate of N = 24, 48 or 96 (386,
// 455, 487 TFLOP/s for the three 3xTF32 wgmmas of a k-step); it pays 64
// rows for 56 outputs a tile.  What bounds the kw form in turn is
// instruction issue: a first version with the tap form's loop ran its
// narrowest layer at 37% of that rate and took half its time with the
// MMAs taken out.  So it spends few instructions a product: each A
// fragment is loaded and split once an input plane and feeds the three kd
// taps, a block walks d with its weights loaded once and its input planes
// in a ring, and its registers are capped so that more blocks share an SM.
//
// Design of the tap form: an implicit GEMM, M = output voxels, N = O,
// K = 27*C.
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

// -- the kw form: f32 at O <= 32 ----------------------------------------------
// One m64 tile is 4 output rows (h, a warp each) by 16 input columns (w):
// the GEMM's rows are input voxels along w, its N the three kw taps'
// weights side by side (n = kw * NC + o), its K the (kd, kh) taps by the
// channels, and an output is the sum of three rows shifted along w:
// y[h, w, o] = D[(h, w), o] + D[(h, w + 1), NC + o] + D[(h, w + 2), 2 NC + o],
// so a tile gives 4 x 14 outputs.
//
// TEM_CONV3_KW_FAULT (a planted fault, built only by chip_smoke.py to show
// that its checks catch it): 1 leaves the row shifted by two columns out of
// the epilogue's sum.
#ifndef TEM_CONV3_KW_FAULT
#define TEM_CONV3_KW_FAULT 0
#endif
constexpr int kKwTH = 4;                     // output rows of one m64 tile
constexpr int kKwIW = 16;                    // its input columns
constexpr int kKwOW = kKwIW - 2;             // its output columns
constexpr int kKwVox = (kKwTH + 2) * kKwIW;  // 96 input voxels per plane

template <int NC, int CS>
struct CfgKw {
  static constexpr int kKK = 8;                // tf32 MMA depth in elements
  static constexpr int kCB = CS * kKK;         // channels per channel block
  static constexpr int kParts = 2;             // hi, lo
  static constexpr int kN = 3 * NC;            // wgmma N: kw taps x NC
  static constexpr int kP = NC <= 16 ? 4 : 2;  // output planes per chunk
  static constexpr int kThreads = 128;         // one warpgroup
  static constexpr int kSlots = kP + 2;        // input planes of one chunk
  static constexpr int kRing = 2 * kP + 2;     // a chunk's and the next's
  // words per voxel in smem, no padding: at CS = 2 the two 8-word halves
  // of a voxel swap where bit 1 of its column is set, so that the 64-bit A
  // reads of 4 neighbouring voxels fall on distinct banks
  static constexpr int kVSW = 8 * CS;
  static constexpr int kVSB = kVSW * 4;
  static constexpr int kPlaneBytes = kKwVox * kVSB;
  static constexpr int kStepBytes = kN * 32;   // one part of one k-step
  static constexpr int kStageBytes = CS * kParts * kStepBytes;
  static constexpr int kAcc = kN / 2;          // accumulators per tile
  static constexpr int kASets = 3;             // A register sets in flight
  // blocks an SM keeps at least, so registers a thread at most 128 (NC 8),
  // 168 (16) or 255 (32): more blocks hide more of each block's copies and
  // epilogue (on the H100, 4 blocks at NC 8 ran down1.conv 22% faster than
  // 3, and 3 at NC 16 beat 2)
  static constexpr int kMinBlocks = NC == 8 ? 4 : NC == 16 ? 3 : 2;
  // shared memory: the input planes (a ring of two chunks' planes, or one
  // chunk's), then every channel block's 9 stages (resident) or two kh
  // rows of 3 stages
  static constexpr int smem(int n_cb, bool resident, bool ring) {
    return (ring ? kRing : kSlots) * kPlaneBytes +
           (resident ? 9 * n_cb : 6) * kStageBytes;
  }
};

// Word of channel word e (0 .. 8 CS - 1) of input voxel v in its smem slot.
template <int CS>
__device__ __forceinline__ int kw_word(int v, int e) {
  return CS == 2 ? e ^ (((v >> 1) & 1) << 3) : e;
}

// A block walks ``chunks`` chunks of P output planes along d (blockIdx.y
// picks which) of one column of tiles (4 output rows x 14 output columns),
// so that the weights are loaded once a block where they stay resident,
// and, with ``ring`` (one channel block, resident weights), each input
// plane is copied once: the next chunk's P new planes stream into the ring
// while the current chunk computes.  Otherwise each (chunk, channel block)
// copies its P+2 planes after the previous one is done, and the weights
// stream one kh row (the 3 kd stages) at a time through 2 buffers.
//
// The products walk the input planes, not the output planes: the A
// fragment of input plane s at (kh, k-step) is loaded and split once and
// feeds output plane s - kd for each kd that lands in the chunk (one group
// of up to 9 wgmmas), so a chunk loads (P+2) * 3 fragments a k-step for
// its P * 9 tap products.  What bounds the form is instruction issue (the
// loads, splits and copies beside each wgmma), so that is what it saves.
template <int NC, int CS>
__global__ void __launch_bounds__(CfgKw<NC, CS>::kThreads,
                                  CfgKw<NC, CS>::kMinBlocks)
    conv3_tc_kernel_kw(const float* __restrict__ x,
                       const uint8_t* __restrict__ wp, float* __restrict__ y,
                       int D, int H, int W, int C, int O, int n_cb, int nTD,
                       int nTH, int nTW, int chunks, int aligned,
                       int resident, int ring, int act, float slope) {
  using K = CfgKw<NC, CS>;
  constexpr int P = K::kP;
  extern __shared__ __align__(128) uint8_t smem[];
  const int n_slots = ring ? K::kRing : K::kSlots;
  uint8_t* s_in = smem;
  uint8_t* s_w = smem + n_slots * K::kPlaneBytes;

  int bid = blockIdx.x;
  const int tw = bid % nTW;
  bid /= nTW;
  const int th = bid % nTH;
  const long long b = bid / nTH;
  const int dc0 = blockIdx.y * chunks;
  const int dc1 = min(nTD, dc0 + chunks);
  // ow0 is the tile's first output column and its first input column
  const int oh0 = th * kKwTH, ow0 = tw * kKwOW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int OD = D - 2, OH = H - 2, OW = W - 2;
  const long long plane_elems = static_cast<long long>(H) * W * C;

  // A thread's 16-byte copies of one plane (aligned C): item k = tid +
  // 128 m of the plane's 96 voxels x kCB / 4 pieces, its offset in the
  // plane of x and in the smem slot, and whether it lies in the volume
  constexpr int kPieces = K::kCB / 4;
  constexpr int kItems = kKwVox * kPieces;
  constexpr int kPer = (kItems + K::kThreads - 1) / K::kThreads;
  long long src_off[kPer];
  uint32_t dst_off[kPer];
  int piece_c[kPer];
  bool inside[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int k = tid + m * K::kThreads;
    const int ch = k % kPieces, v = k / kPieces;
    const int h = oh0 + v / kKwIW, w = ow0 + v % kKwIW;
    inside[m] = k < kItems && h < H && w < W;
    src_off[m] = (static_cast<long long>(h) * W + w) * C + ch * 4;
    dst_off[m] = v * K::kVSB + kw_word<CS>(v, ch * 4) * 4;
    piece_c[m] = ch * 4;
  }
  const uint32_t s_in_u32 = smem_u32(s_in);
  // planes [z0, z1) of channel block cbi into the slots from slot0 on,
  // wrapping at n_slots (no commit)
  auto load_planes = [&](int z0, int z1, int slot0, int cbi) {
    const int c0 = cbi * K::kCB;
    if (aligned) {
      for (int j = 0; j < z1 - z0; ++j) {
        const int d = z0 + j;
        int sl = slot0 + j;
        if (sl >= n_slots) sl -= n_slots;
        const float* base = x + (b * D + d) * plane_elems + c0;
        const uint32_t dst = s_in_u32 + sl * K::kPlaneBytes;
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          if (m * K::kThreads + tid < kItems) {
            const bool ok = inside[m] && d < D && c0 + piece_c[m] < C;
            cp_async16(dst + dst_off[m], ok ? base + src_off[m] : x,
                       ok ? 16 : 0);
          }
        }
      }
    } else {
      for (int i = tid; i < (z1 - z0) * kKwVox * K::kCB; i += K::kThreads) {
        const int e = i % K::kCB;
        const int v = (i / K::kCB) % kKwVox;
        const int j = i / (K::kCB * kKwVox);
        int sl = slot0 + j;
        if (sl >= n_slots) sl -= n_slots;
        const int d = z0 + j, h = oh0 + v / kKwIW, w = ow0 + v % kKwIW;
        const int c = c0 + e;
        const bool ok = d < D && h < H && w < W && c < C;
        reinterpret_cast<float*>(s_in + sl * K::kPlaneBytes + v * K::kVSB)
            [kw_word<CS>(v, e)] =
            ok ? x[(((b * D + d) * H + h) * static_cast<long long>(W) + w) *
                       C + c]
               : 0.f;
      }
    }
  };
  // n weight stages from stage st0 (of all channel blocks' 9 each, kh
  // major) into the stage buffers from buf on, then commit
  auto load_stages = [&](int st0, int n, int buf) {
    const uint8_t* src = wp + static_cast<size_t>(st0) * K::kStageBytes;
    const uint32_t dst = smem_u32(s_w + buf * K::kStageBytes);
    for (int i = tid; i < n * K::kStageBytes / 16; i += K::kThreads) {
      cp_async16(dst + i * 16, src + i * 16, 16);
    }
    cp_async_commit();
  };

  load_planes(dc0 * P, dc0 * P + P + 2, ring ? dc0 * P % n_slots : 0, 0);
  load_stages(0, resident ? 9 * n_cb : 3, 0);  // with the first planes

  // this thread's A words: row (warp + kh) of a plane, column g; column
  // g + 8 is 8 voxels on, with the same swizzle
  const uint32_t a_off = ((warp * kKwIW + g) * K::kVSW) * 4;
  float acc[P][K::kAcc];
  uint32_t a[K::kASets][2][4];
  for (int dc = dc0; dc < dc1; ++dc) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < K::kAcc; ++i) acc[p][i] = 0.f;
    }
    const int slot0 = ring ? dc * P % n_slots : 0;
    for (int cbi = 0; cbi < n_cb; ++cbi) {
      if (!ring && (dc > dc0 || cbi > 0)) {
        __syncthreads();  // every warp is done with the previous planes
        load_planes(dc * P, dc * P + P + 2, 0, cbi);
        if (resident) {
          cp_async_commit();
        } else {
          load_stages(cbi * 9, 3, 0);
        }
      }
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        if (!resident || kh == 0) {
          cp_async_wait<0>();  // this kh row or these planes have landed
          fence_proxy_async();
          __syncthreads();
          // The next kh row streams in while this one is used; its buffer
          // was drained at the end of kh - 1.
          if (!resident && kh < 2) {
            load_stages(cbi * 9 + (kh + 1) * 3, 3, ((kh + 1) & 1) * 3);
          }
          // The next chunk's P new planes stream into the ring slots of
          // the previous chunk's first P, which every warp is done with.
          if (ring && kh == 0 && dc + 1 < dc1) {
            const int z = dc * P + P + 2;
            load_planes(z, z + P, z % n_slots, 0);
            cp_async_commit();
          }
        }
        // stage (kh, kd) of this channel block: kd's 3 stages follow
        const uint32_t w_kh = smem_u32(
            s_w + (resident ? cbi * 9 + kh * 3 : (kh & 1) * 3) *
                      K::kStageBytes);
#pragma unroll
        for (int cs = 0; cs < CS; ++cs) {
          const uint32_t a_word =
              a_off + (kh * kKwIW * K::kVSW + kw_word<CS>(g, cs * 8) +
                       2 * t) * 4;
#pragma unroll
          for (int s = 0; s < P + 2; ++s) {
            // the A register sets rotate over the planes of all k-steps
            const int q = ((kh * CS + cs) * (P + 2) + s) % K::kASets;
            int sl = slot0 + s;
            if (sl >= n_slots) sl -= n_slots;
            // words 2t, 2t+1 of the k-step hold (a0, a2) of column g, the
            // same words of column g + 8 hold (a1, a3): the packed weights
            // permute K so (pack_conv3_weights)
            const uint8_t* src = s_in + sl * K::kPlaneBytes + a_word;
            const uint2 row0 = *reinterpret_cast<const uint2*>(src);
            const uint2 row1 =
                *reinterpret_cast<const uint2*>(src + 8 * K::kVSB);
            const uint32_t r[4] = {row0.x, row1.x, row0.y, row1.y};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint32_t hi = r[i] & 0xFFFFE000u;  // TF32 by truncation
              a[q][0][i] = hi;
              a[q][1][i] = __float_as_uint(
                  __fsub_rn(__uint_as_float(r[i]), __uint_as_float(hi)));
            }
            wgmma_fence();
#pragma unroll
            for (int kd = 0; kd < 3; ++kd) {
              const int p = s - kd;  // the output plane this tap feeds
              if (p < 0 || p >= P) continue;
              const uint32_t step = w_kh + kd * K::kStageBytes +
                                    cs * K::kParts * K::kStepBytes;
              const uint64_t d_hi = make_desc(step);
              const uint64_t d_lo = make_desc(step + K::kStepBytes);
              mma_tf32(acc[p], a[q][1], d_hi);  // x_lo * w_hi
              mma_tf32(acc[p], a[q][0], d_lo);  // x_hi * w_lo
              mma_tf32(acc[p], a[q][0], d_hi);  // x_hi * w_hi
            }
            wgmma_commit();
            // the group kASets - 1 back is done: its A set may be reloaded
            wgmma_wait<K::kASets - 1>();
          }
        }
        if (!resident) wgmma_wait<0>();  // this kh row's buffer is reloaded
      }
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) fence_operands(acc[p]);
    }

    // -- epilogue: the three shifted rows summed in f32 ----------------------
    // Thread (g, t) holds columns g (half 0) and g + 8 (half 1) of its
    // warp's row at n = 8j + 2t, + 1.  Column g + kw is held by lane
    // (g + kw) % 8 * 4 + t: in its half 0 where g + kw < 8, else in its
    // half 1.  Output column g + 8 exists where g + 8 < 14 and then reads
    // half 1 of the same lanes.
    constexpr int kGroups = NC / 8;  // 8-channel groups of one kw tap
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int od = dc * P + p, oh = oh0 + warp;
      float v[2][kGroups][2];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[0][j][e] = acc[p][4 * j + e];
          v[1][j][e] = acc[p][4 * j + 2 + e];
        }
      }
#pragma unroll
      for (int kw = 1; kw < 3 - TEM_CONV3_KW_FAULT; ++kw) {
        const int src = (lane + 4 * kw) & 31;
        const bool low = g + kw < 8;
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
          const int jn = kw * kGroups + j;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float h0 =
                __shfl_sync(0xFFFFFFFFu, acc[p][4 * jn + e], src);
            const float h1 =
                __shfl_sync(0xFFFFFFFFu, acc[p][4 * jn + 2 + e], src);
            v[0][j][e] += low ? h0 : h1;
            v[1][j][e] += h1;  // used only where g + 8 + kw < 16
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = g + 8 * half, ow = ow0 + col;
        if (col < kKwOW && od < OD && oh < OH && ow < OW) {
          float* out = y + (((b * OD + od) * OH + oh) *
                                static_cast<long long>(OW) + ow) * O;
#pragma unroll
          for (int j = 0; j < kGroups; ++j) {
            const int n = 8 * j + 2 * t;
            float v0 = v[half][j][0], v1 = v[half][j][1];
            if (act) {
              v0 = conv_leaky<float>(v0, slope);
              v1 = conv_leaky<float>(v1, slope);
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

template <int NC, int CS>
cudaError_t launch_kw(const void* x, const void* wp, void* y, int B, int D,
                      int H, int W, int C, int O, int resident, int ring,
                      int act, float slope, cudaStream_t s) {
  using K = CfgKw<NC, CS>;
  const int n_cb = (C + K::kCB - 1) / K::kCB;
  // one chunk of outputs; the ring holds one channel block's planes beside
  // resident weights
  if (O > NC || (ring && (n_cb != 1 || !resident))) {
    return cudaErrorInvalidValue;
  }
  const int nTD = (D - 2 + K::kP - 1) / K::kP;
  const int nTH = (H - 2 + kKwTH - 1) / kKwTH;
  const int nTW = (W - 2 + kKwOW - 1) / kKwOW;
  const long long columns = static_cast<long long>(B) * nTH * nTW;
  if (columns > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  // Split the d walk where there are too few columns to give every SM
  // four blocks.  (The SM count a device, read once.)
  static int sms_of[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms_of[dev] = n;
  }
  const int sms = sms_of[dev];
  const long long want = (4LL * sms + columns - 1) / columns;
  const int segments = static_cast<int>(want < nTD ? want : nTD);
  const int chunks = (nTD + segments - 1) / segments;
  const bool aligned =
      C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int smem = K::smem(n_cb, resident != 0, ring != 0);
  auto kern = conv3_tc_kernel_kw<NC, CS>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned int>(columns),
                  static_cast<unsigned int>((nTD + chunks - 1) / chunks));
  kern<<<grid, K::kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(wp),
      static_cast<float*>(y), D, H, W, C, O, n_cb, nTD, nTH, nTW, chunks,
      aligned ? 1 : 0, resident, ring, act, slope);
  return cudaGetLastError();
}

template <int CS>
cudaError_t dispatch_kw(int nc, const void* x, const void* wp, void* y,
                        int B, int D, int H, int W, int C, int O,
                        int resident, int ring, int act, float slope,
                        cudaStream_t s) {
  switch (nc) {
    case 8:
      return launch_kw<8, CS>(x, wp, y, B, D, H, W, C, O, resident, ring,
                              act, slope, s);
    case 16:
      return launch_kw<16, CS>(x, wp, y, B, D, H, W, C, O, resident, ring,
                               act, slope, s);
    case 32:
      return launch_kw<32, CS>(x, wp, y, B, D, H, W, C, O, resident, ring,
                               act, slope, s);
    default:
      return cudaErrorInvalidValue;
  }
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
// kw whether it is the kw form's pack (f32 only), resident whether a
// channel block's 9 weight stages (the kw form: every block's) are loaded
// at once, ring whether the kw form keeps its input planes in a ring.
int tem_conv3_tc(const void* x, const void* wp, void* y, int dtype, int B,
                 int D, int H, int W, int C, int O, int cb, int nc, int kw,
                 int resident, int ring, int act, float slope,
                 void* stream) {
  if (B <= 0 || D < 3 || H < 3 || W < 3 || C <= 0 || O <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (kw) {
    if (dtype != tem::kF32) {
      e = cudaErrorInvalidValue;
    } else if (cb == 8) {
      e = tem::tc::dispatch_kw<1>(nc, x, wp, y, B, D, H, W, C, O, resident,
                                  ring, act, slope, s);
    } else if (cb == 16) {
      e = tem::tc::dispatch_kw<2>(nc, x, wp, y, B, D, H, W, C, O, resident,
                                  ring, act, slope, s);
    } else {
      e = cudaErrorInvalidValue;
    }
  } else if (dtype == tem::kF32) {
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
