// int8 x int8 -> int32 stride-1 VALID conv on Hopper's tensor cores,
// channels last, with the dequantizing epilogue of the JAX package's int8
// serving path.
//
// Replaces: not a Pallas kernel.  transfer_em_tpu/ops/quant.py:56-95
// (conv_nd_int8, conv_transpose_nd_int8) leaves the integer conv to XLA
// (lax.conv_general_dilated(..., preferred_element_type=int32)); PyTorch has
// no int8 conv on CUDA, so the port writes it by hand.
//
// Function: x (B, D, H, W, C) int8 codes, C % 4 == 0 (ops/quant.py
// quantize_int8 writes them so), weights packed once per parameter by
// ops/cuda_int8.py pack_int8_weights; per channel block of CB bytes, K word
// j holds tap j / (CB/4) and channels (j % (CB/4)) * 4 .. + 3;
//   acc[m, n] = sum_k x[m @ tap(k), c(k)] * w[tap(k), c(k), n]   (exact)
// and, by out_mode, y = acc (int32), or y = float(acc) * (sx * sk[n]) with
// the product sx * sk[n] taken first in f32 (JAX's order), rounded to f32 or
// bf16, then the optional LeakyReLU(slope) on that rounded value
// (common.cuh conv_leaky).  With phases (4 in 2D, 8 in 3D) the outputs n =
// p * Cout + c of the transposed conv's phase decomposition are stored
// interleaved, y (B, 2D', 2H', 2W', Cout) at (2d + pd, 2h + ph, 2w + pw).
// Every conv of the int8 generator reduces to this one (ops/quant.py): k4
// stride-2 VALID by space-to-depth into a k2 conv, the stride-2 SAME
// transposed conv by its phase decomposition (a k3 conv with 2^n * Cout
// outputs), the one-channel stem as a (3, 3, 1) conv of its kw taps packed
// in 4 channels, 2D as D = 1.  Integer sums are exact, so each
// rearrangement gives JAX's accumulators bit for bit.
//
// Bound on the H100: bytes (3.35 TB/s) at every layer of the wf=8
// generator (8-32 channels), operations (1,979 TOPS int8 dense on the
// tensor cores) at most layers of the wf=1 one (64-256).  Design, after
// conv3_tc.cu's: an implicit GEMM, M = output voxels, N = O, K = taps * C.
//   * One block is one warpgroup (128 threads) and one chunk of NC output
//     channels (blockIdx.y), NC = 8, 16, 32 or 64, the smallest wgmma N
//     that holds O (the out layer's O = 1 takes N = 8: a CUDA-core dot
//     product was not built).  Its tile is an 8x8 (H, W) patch of P
//     consecutive output planes (P m64 tiles: 8 at N = 8 with at most 16
//     channels in, where a k-step's few products leave the wgmma latency
//     bare; else 4, 2 at N = 64; 1 in 2D).
//     Blocks are persistent: as many as fit on the card at once, each
//     walking the tiles blockIdx.x, + gridDim.x, ... (so the blocks in
//     flight cover neighbouring tiles, whose halos meet in L2).
//   * A stage is one channel block of one tile: its input brick with the
//     halo ((P + KD - 1) planes of (8 + KH - 1) x (8 + KW - 1) voxels, CB
//     bytes each, at a voxel pitch VS = CB + 16 for CB >= 32 to spread the
//     banks, rows 16-byte aligned), staged in shared memory by cp.async (whole brick rows 16
//     bytes a copy where the voxels are unpadded, else 16, 8 or 4 bytes a
//     voxel; zero-fill past the volume and past C), with the weights of that
//     channel block beside it, already in the wgmma B layout (K-major, no
//     swizzle: core matrices of 8 outputs x 16 bytes, LBO 128 B, SBO
//     256 B).  Two stage buffers alternate: the next stage's copies fly
//     while this one computes and stores (a ring of 3-4 buffers measured
//     no faster).  With one channel block (every layer at wf=8 but
//     down2.down) the weights are loaded once a block and stay.  make_plan
//     picks CB so that a block fits two to an SM; ops/cuda_int8.py asks it
//     (tem_conv_int8_plan) for the packing, and tem_conv_int8 makes the
//     same plan from the same shapes.
//   * A table in shared memory gives each K word's offset in the brick
//     (-1 past the taps: a zero word), so the im2col of A is a 32-bit
//     shared-memory read a word, gathered into registers and fed to
//     wgmma.mma_async m64nNCk32 .s32.s8.s8 with B from shared memory.  Two
//     register sets of A alternate, so one k-step's gathers overlap the
//     previous k-step's products.
//   * Epilogue from the s32 accumulators after a tile's last channel
//     block: dequantize, LeakyReLU, round, mask the ragged rows, planes and
//     channels, store channels-last (or interleaved), two channels a store.

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace tem {
namespace int8 {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::fence_operands;
using tc::fence_proxy_async;
using tc::make_desc;
using tc::mma_s8;
using tc::smem_u32;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait;

constexpr int kThreads = 128;
constexpr int kTH = 8, kTW = 8;  // output patch of one m64 tile
constexpr int kIW = 10;  // brick rows and columns (8 + halo 2)

// A brick row's pitch in bytes: 10 voxels at pitch VS, rounded up to 16 so
// that every row starts 16-byte aligned (whole-row copies); a plane is 10
// rows.
__host__ __device__ inline int row_pitch(int VS) {
  return (kIW * VS + 15) / 16 * 16;
}

enum OutMode : int { kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2 };

struct Args {
  const int8_t* x;
  const uint8_t* wp;
  void* y;
  const float* sx;
  const float* sk;
  int B, D, H, W, C, KD, KH, KW, O;
  int CB, VS, unit, n_cb, ksteps;
  int rowcopy;  // brick rows copied whole, 16 bytes a copy
  int nTD, nTH, nTW;
  int phases, act;
  float slope;
};

// 4- or 8-byte global -> shared copy (16 bytes: tc::cp_async16); src_bytes
// 0 fills with zeros.
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src,
                                               int bytes, bool ok) {
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

template <typename T>
__device__ __forceinline__ void store(void* y, long long idx, int acc,
                                      float s, int act, float slope) {
  if constexpr (std::is_same<T, int>::value) {
    static_cast<int*>(y)[idx] = acc;  // int32 accumulators
  } else {
    float v = __fmul_rn(__int2float_rn(acc), s);
    if (act) v = conv_leaky<T>(v, slope);
    static_cast<T*>(y)[idx] = from_f32<T>(v);
  }
}

template <typename T>
__device__ __forceinline__ void store2(void* y, long long idx, int acc0,
                                       int acc1, float s0, float s1, int act,
                                       float slope) {
  if constexpr (std::is_same<T, int>::value) {
    *reinterpret_cast<int2*>(static_cast<int*>(y) + idx) =
        make_int2(acc0, acc1);
  } else {
    float v0 = __fmul_rn(__int2float_rn(acc0), s0);
    float v1 = __fmul_rn(__int2float_rn(acc1), s1);
    if (act) {
      v0 = conv_leaky<T>(v0, slope);
      v1 = conv_leaky<T>(v1, slope);
    }
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(static_cast<float*>(y) + idx) =
          make_float2(v0, v1);
    } else {
      __nv_bfloat162 v;
      v.x = from_f32<T>(v0);
      v.y = from_f32<T>(v1);
      *reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(y) + idx) = v;
    }
  }
}

// Bytes of one input brick (planes x 10 rows), rounded up to 128 so that
// the next buffer stays aligned.
__host__ __device__ inline int brick_bytes(int planes, int VS) {
  return (planes * kIW * row_pitch(VS) + 127) / 128 * 128;
}

// Shared memory of a block: the weights (one buffer when a single channel
// block stays resident, else two), two input bricks, the K-word table.
__host__ __device__ inline int smem_bytes(int NC, int P, int KD, int VS,
                                          int n_cb, int ksteps) {
  const int wbytes = ksteps * NC * 32;
  return (n_cb == 1 ? 1 : 2) * wbytes + 2 * brick_bytes(P + KD - 1, VS) +
         4 * 8 * ksteps;
}

// Blocks an SM the registers are cut for: 5 for the narrowest tile (N = 8,
// 8 planes), whose latencies want warps more than registers (measured
// faster at the stem and down1.conv), 1 (the compiler's choice) else, where
// the accumulators need them (5 or 8 there measured slower).
template <int NC, int P>
constexpr int min_blocks() {
  return NC == 8 && P == 8 ? 5 : 1;
}

// A block's shape for one conv: NC output channels (the wgmma N) of P
// output planes, the input channels CB bytes a stage (voxel pitch VS in
// shared memory, copies of `unit` bytes), `ksteps` k-steps of 32 bytes a
// channel block, `smem` bytes of shared memory.
struct Plan {
  int nc, p, cb, vs, unit, ksteps, smem;
};

constexpr int kSmemBudget = 110 * 1024;  // two blocks an SM (227 KB)

// The plan for a (KD, KH, KW, C, O) kernel, C % 4 == 0, of spatial rank nd:
// the smallest wgmma N that holds O (64 above 64, in chunks); 8 planes a
// tile at N = 8 with at most 16 channels in (few products a k-step: more
// tiles to cover wgmma's latency), else 4, 2 at N = 64, 1 in 2D; the widest
// channel block (all of C up to 64 bytes, else 64, 32, 16, ...) whose
// shared memory fits two blocks an SM.
inline Plan make_plan(int KD, int KH, int KW, int C, int O, int nd) {
  Plan pl;
  pl.nc = O <= 8 ? 8 : (O <= 16 ? 16 : (O <= 32 ? 32 : 64));
  pl.p = nd == 2 ? 1 : (pl.nc == 8 && C <= 16 ? 8 : (pl.nc <= 32 ? 4 : 2));
  const int taps = KD * KH * KW;
  int cb = C < 64 ? C : 64;
  for (;;) {
    pl.cb = cb;
    pl.vs = cb % 16 == 0 && cb >= 32 ? cb + 16 : cb;
    pl.ksteps = (taps * cb / 4 + 7) / 8;
    pl.smem = smem_bytes(pl.nc, pl.p, KD, pl.vs, (C + cb - 1) / cb,
                         pl.ksteps);
    if (pl.smem <= kSmemBudget || cb <= 4) break;
    cb = cb / 2 / 4 * 4;
    if (cb < 4) cb = 4;
  }
  pl.unit = C % 16 == 0 && cb % 16 == 0 ? 16
            : (C % 8 == 0 && cb % 8 == 0 ? 8 : 4);
  return pl;
}

inline bool plan_args_ok(int KD, int KH, int KW, int C, int O, int nd) {
  return C > 0 && C % 4 == 0 && O > 0 && KD >= 1 && KH >= 1 && KW >= 1 &&
         KD <= 3 && KH <= 3 && KW <= 3 && (nd == 3 || (nd == 2 && KD == 1));
}

template <int NC, int P, typename T>
__global__ void __launch_bounds__(kThreads, (min_blocks<NC, P>()))
    conv_int8_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int wbytes = a.ksteps * NC * 32;
  const int planes = P + a.KD - 1;
  const int bbytes = brick_bytes(planes, a.VS);
  const int RP = row_pitch(a.VS);
  const bool wres = a.n_cb == 1;  // one channel block: weights loaded once
  // stage buffer k (0, 1): weights at s_w + k * wstride (one buffer when
  // resident), the brick at s_in + k * bbytes
  uint8_t* const s_w = smem;
  const int wstride = wres ? 0 : wbytes;
  uint8_t* const s_in = smem + (wres ? 1 : 2) * wbytes;
  int* s_off = reinterpret_cast<int*>(s_in + 2 * bbytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int OD = a.D - a.KD + 1, OH = a.H - a.KH + 1, OW = a.W - a.KW + 1;
  const int rows = kTH + a.KH - 1, cols = kTW + a.KW - 1;
  const int taps = a.KD * a.KH * a.KW;
  // tiles < 2^31 (the host checks): 32-bit tile arithmetic, whose
  // divisions cost a fraction of 64-bit ones
  const int tiles = a.B * a.nTD * a.nTH * a.nTW;
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  const int my_tiles =
      (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int stages = my_tiles * a.n_cb;

  // each K word's byte offset in the brick, -1 past the taps
  const int cwn = a.CB / 4;
  for (int j = tid; j < a.ksteps * 8; j += kThreads) {
    const int tap = j / cwn, cw = j - tap * cwn;
    int off = -1;
    if (tap < taps) {
      const int tw_ = tap % a.KW, th_ = (tap / a.KW) % a.KH,
                td_ = tap / (a.KW * a.KH);
      off = (td_ * kIW + th_) * RP + tw_ * a.VS + cw * 4;
    }
    s_off[j] = off;
  }

  // the output patch of this block's k-th tile
  struct Tile {
    long long b;
    int od0, oh0, ow0;
  };
  auto tile_of = [&](int k) {
    int id = blockIdx.x + k * gridDim.x;
    Tile tl;
    int q = id / a.nTW;
    tl.ow0 = (id - q * a.nTW) * kTW;
    id = q / a.nTH;
    tl.oh0 = (q - id * a.nTH) * kTH;
    q = id / a.nTD;
    tl.od0 = (id - q * a.nTD) * P;
    tl.b = q;
    return tl;
  };

  // stage s: channel block s % n_cb of tile s / n_cb, into buffer s & 1
  const uint8_t* wchunk =
      a.wp + static_cast<size_t>(blockIdx.y) * a.n_cb * wbytes;
  auto load_stage = [&](int s) {
    const Tile tl = tile_of(s / a.n_cb);
    const int cbi = s % a.n_cb, buf = s & 1;
    const int c0 = cbi * a.CB;
    const int chunks = a.CB / a.unit;
    const int total = a.rowcopy ? 0 : planes * rows * cols * chunks;
    if (a.rowcopy) {
      // the brick's rows are whole 16-byte chunks in both memories; a chunk
      // past the volume's last column is cut (zero-filled) by its byte count
      const int rchunks = cols * a.C / 16;
      const long long row_bytes = static_cast<long long>(a.W) * a.C;
      const int left = (a.W - tl.ow0) * a.C;  // bytes from ow0 to the edge
      uint8_t* dbase = s_in + buf * bbytes;
      for (int i = tid; i < planes * rows * rchunks; i += kThreads) {
        const int r = i / rchunks, k = i - r * rchunks;
        const int sl = r / rows, row = r - sl * rows;
        const int d = tl.od0 + sl, h = tl.oh0 + row;
        int bytes = left - k * 16;
        bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
        if (d >= a.D || h >= a.H) bytes = 0;
        const int8_t* src =
            bytes ? a.x + ((tl.b * a.D + d) * a.H + h) * row_bytes +
                        static_cast<long long>(tl.ow0) * a.C + k * 16
                  : a.x;
        cp_async16(smem_u32(dbase + (sl * kIW + row) * RP + k * 16), src,
                   bytes);
      }
    }
    for (int i = tid; i < total; i += kThreads) {
      int r = i / chunks;
      const int ch = i - r * chunks;
      const int col = r % cols;
      r /= cols;
      const int row = r % rows, sl = r / rows;
      const int d = tl.od0 + sl, h = tl.oh0 + row, w = tl.ow0 + col;
      const int c = c0 + ch * a.unit;
      const bool ok = d < a.D && h < a.H && w < a.W && c < a.C;
      const int8_t* src =
          ok ? a.x + (((tl.b * a.D + d) * a.H + h) *
                          static_cast<long long>(a.W) + w) * a.C + c
             : a.x;
      const uint32_t dst =
          smem_u32(s_in + buf * bbytes + (sl * kIW + row) * RP + col * a.VS +
                   ch * a.unit);
      if (a.unit == 16) {
        cp_async16(dst, src, ok ? 16 : 0);
      } else {
        cp_async_small(dst, src, a.unit, ok);
      }
    }
    if (!wres || s == 0) {
      const uint8_t* wsrc = wchunk + static_cast<size_t>(cbi) * wbytes;
      const uint32_t wdst = smem_u32(s_w + buf * wstride);
      for (int i = tid; i < wbytes / 16; i += kThreads) {
        cp_async16(wdst + i * 16, wsrc + i * 16, 16);
      }
    }
    cp_async_commit();
  };

  int acc[P][NC / 2];
  // brick offsets of this thread's two rows of warp `warp` (output rows
  // 2 * warp and 2 * warp + 1 of the patch, column g)
  const int row0 = 2 * warp * RP + g * a.VS;
  const int row1 = row0 + RP;
  const int nbase = blockIdx.y * NC + 2 * t;
  // this thread's output scales sx * sk[n] (n = nbase + 8j + e), in
  // registers: y is not restrict, so reads of sk between the stores would
  // be made again after each one
  float scl[NC / 8][2];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = nbase + 8 * j + e;
      scl[j][e] = std::is_same<T, int>::value || n >= a.O
                      ? 0.f
                      : __fmul_rn(*a.sx, a.sk[n]);
    }
  }
  const int cout = a.phases ? a.O / a.phases : a.O;
  const bool pairs = cout % 2 == 0;  // n, n + 1 adjacent in memory

  load_stage(0);
  for (int s = 0; s < stages; ++s) {
    // the next stage's copies fly while this one computes
    if (s + 1 < stages) {
      load_stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // the weights, read by wgmma through the async proxy: fenced after the
    // stage that loads them (the bricks are read by plain loads)
    if (!wres || s == 0) fence_proxy_async();
    __syncthreads();  // stage s (and the table) visible to all

    const int cbi = s % a.n_cb, buf = s & 1;
    if (cbi == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) acc[p][i] = 0;
      }
    }
    const uint8_t* brick = s_in + buf * bbytes;
    const uint32_t w_addr = smem_u32(s_w + buf * wstride);
    // -- the k-steps: gather A, wgmma -------------------------------------
    uint32_t ra[P][4], rb[P][4];
    auto gather = [&](int ks, uint32_t (&r)[P][4]) {
      const int o0 = s_off[ks * 8 + t], o1 = s_off[ks * 8 + 4 + t];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint8_t* base = brick + p * kIW * RP;
        r[p][0] = o0 < 0 ? 0u : *reinterpret_cast<const uint32_t*>(
                                    base + row0 + o0);
        r[p][1] = o0 < 0 ? 0u : *reinterpret_cast<const uint32_t*>(
                                    base + row1 + o0);
        r[p][2] = o1 < 0 ? 0u : *reinterpret_cast<const uint32_t*>(
                                    base + row0 + o1);
        r[p][3] = o1 < 0 ? 0u : *reinterpret_cast<const uint32_t*>(
                                    base + row1 + o1);
      }
    };
    auto issue = [&](int ks, const uint32_t (&r)[P][4]) {
      wgmma_fence();
      const uint64_t desc = make_desc(w_addr + ks * NC * 32);
#pragma unroll
      for (int p = 0; p < P; ++p) mma_s8(acc[p], r[p], desc);
      wgmma_commit();
    };
    for (int ks = 0; ks < a.ksteps; ks += 2) {
      gather(ks, ra);
      issue(ks, ra);
      wgmma_wait<1>();  // k-step ks - 1 is done: rb may be reloaded
      if (ks + 1 < a.ksteps) {
        gather(ks + 1, rb);
        issue(ks + 1, rb);
        wgmma_wait<1>();  // k-step ks is done: ra may be reloaded
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < P; ++p) fence_operands(acc[p]);

    // -- epilogue, after the tile's last channel block ---------------------
    if (cbi == a.n_cb - 1) {
      const Tile tl = tile_of(s / a.n_cb);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int od = tl.od0 + p;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int oh = tl.oh0 + 2 * warp + half, ow = tl.ow0 + g;
          if (od >= OD || oh >= OH || ow >= OW) continue;
          // where output channel m of this voxel goes (interleaved by its
          // phase for the transposed conv)
          auto index = [&](int m) -> long long {
            if (a.phases) {
              const int ph = m / cout, c = m - ph * cout;
              const int pw = ph & 1, phh = (ph >> 1) & 1,
                        pd = a.phases == 8 ? (ph >> 2) & 1 : 0;
              const int d2 = a.phases == 8 ? 2 * od + pd : od;
              const int D2 = a.phases == 8 ? 2 * OD : OD;
              return (((tl.b * D2 + d2) * (2 * OH) + 2 * oh + phh) *
                          static_cast<long long>(2 * OW) +
                      2 * ow + pw) * cout + c;
            }
            return (((tl.b * OD + od) * OH + oh) * static_cast<long long>(OW) +
                    ow) * a.O + m;
          };
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) {
            const int n = nbase + 8 * j;
            if (n >= a.O) continue;
            const long long idx = index(n);
            const int v0 = acc[p][4 * j + 2 * half];
            const int v1 = acc[p][4 * j + 2 * half + 1];
            const float s0 = scl[j][0], s1 = scl[j][1];
            if (pairs && n + 1 < a.O) {
              store2<T>(a.y, idx, v0, v1, s0, s1, a.act, a.slope);
            } else {
              store<T>(a.y, idx, v0, s0, a.act, a.slope);
              if (n + 1 < a.O) {
                store<T>(a.y, index(n + 1), v1, s1, a.act, a.slope);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // buffer s & 1 is free for stage s + 2
  }
}

template <int NC, int P, typename T>
cudaError_t launch(const Args& a, int smem, int blocks_y, long long tiles,
                   cudaStream_t s) {
  auto kern = conv_int8_kernel<NC, P, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // persistent blocks: as many as fit at once, each walking its tiles
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms /
                     blocks_y;
  if (blocks < 1) blocks = 1;
  if (blocks > tiles) blocks = tiles;
  kern<<<dim3(static_cast<unsigned>(blocks), blocks_y), kThreads, smem, s>>>(
      a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int nc, int p, int smem, int blocks_y,
                     long long tiles, cudaStream_t s) {
#define TEM_CASE(NC_, P_) \
  if (nc == NC_ && p == P_) return launch<NC_, P_, T>(a, smem, blocks_y, tiles, s)
  TEM_CASE(8, 8);
  TEM_CASE(8, 4);
  TEM_CASE(16, 4);
  TEM_CASE(32, 4);
  TEM_CASE(64, 2);
  TEM_CASE(8, 1);
  TEM_CASE(16, 1);
  TEM_CASE(32, 1);
  TEM_CASE(64, 1);
#undef TEM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace int8
}  // namespace tem

// The plan (nc, p, cb, vs, unit, ksteps, smem) tem_conv_int8 makes for a
// (KD, KH, KW, C, O) kernel of spatial rank nd, written to plan[0..6]: the
// block shape ops/cuda_int8.py pack_int8_weights packs the weights for.
extern "C" int tem_conv_int8_plan(int KD, int KH, int KW, int C, int O,
                                  int nd, int* plan) {
  using namespace tem::int8;
  if (!plan_args_ok(KD, KH, KW, C, O, nd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = make_plan(KD, KH, KW, C, O, nd);
  const int v[7] = {pl.nc, pl.p, pl.cb, pl.vs, pl.unit, pl.ksteps, pl.smem};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return 0;
}

// out_mode: 0 float32, 1 bfloat16 (both dequantized), 2 int32 accumulators.
// nd: the spatial rank (2: D = KD = 1).  wp: pack_int8_weights' operand for
// tem_conv_int8_plan's plan of these shapes; sx (1 value) and sk (O values)
// are device pointers; phases 0, or 4 / 8 for an interleaved store.
extern "C" int tem_conv_int8(const void* x, const void* wp, void* y,
                             const void* sx, const void* sk, int out_mode,
                             int nd, int B, int D, int H, int W, int C,
                             int KD, int KH, int KW, int O, int phases,
                             int act, float slope, void* stream) {
  using namespace tem::int8;
  if (B <= 0 || !plan_args_ok(KD, KH, KW, C, O, nd) || KD > D || KH > H ||
      KW > W || (nd == 2 && D != 1) ||
      (phases != 0 && (O % phases != 0 || phases != (nd == 3 ? 8 : 4))) ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = make_plan(KD, KH, KW, C, O, nd);
  if (reinterpret_cast<uintptr_t>(x) % pl.unit != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const int8_t*>(x), static_cast<const uint8_t*>(wp), y,
         static_cast<const float*>(sx), static_cast<const float*>(sk),
         B, D, H, W, C, KD, KH, KW, O,
         pl.cb, pl.vs, pl.unit, (C + pl.cb - 1) / pl.cb, pl.ksteps, 0,
         (D - KD + 1 + pl.p - 1) / pl.p, (H - KH + 1 + kTH - 1) / kTH,
         (W - KW + 1 + kTW - 1) / kTW, phases, act, slope};
  // whole brick rows: one channel block without padding, rows of whole
  // 16-byte chunks, each row's start 16-byte aligned in device memory
  a.rowcopy = pl.vs == C && pl.cb == C && ((kTW + KW - 1) * C) % 16 == 0 &&
              (static_cast<long long>(W) * C) % 16 == 0 &&
              (kTW * C) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long tiles = static_cast<long long>(B) * a.nTD * a.nTH * a.nTW;
  const int blocks_y = (O + pl.nc - 1) / pl.nc;
  if (tiles > 0x7FFFFFFFLL || blocks_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = pl.nc, p = pl.p, smem = pl.smem;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (out_mode) {
    case kOutF32:
      e = dispatch<float>(a, nc, p, smem, blocks_y, tiles, s);
      break;
    case kOutBF16:
      e = dispatch<__nv_bfloat16>(a, nc, p, smem, blocks_y, tiles, s);
      break;
    case kOutI32:
      a.act = 0;
      e = dispatch<int>(a, nc, p, smem, blocks_y, tiles, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
