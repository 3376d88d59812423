// Elementwise kernels of the tile step: the Hopper counterparts of the three
// Pallas kernels in transfer_em_tpu/ops/pallas_kernels.py.
//
//  * tem_preprocess_u8  replaces preprocess_u8 (pallas_kernels.py:60-85,
//    kernel _affine_u8_to_f32_kernel :53-57): uint8 -> f32 a*x + b.
//  * tem_postprocess_u8 replaces postprocess_u8 (pallas_kernels.py:97-124,
//    kernel _affine_f32_to_u8_kernel :88-94), but computes the MAIN path's
//    order of operations (ops/normalize.py:94-102): y*std + mean, + 1,
//    * 127.5, round half to even, clip [0, 255].  The Pallas kernel's folded
//    a*y + b can move a voxel by one level at a tie.  It reads the tpad-trimmed
//    window straight out of the untrimmed (B, D, H, W, 1) model output
//    (strided read, no copy of the trimmed view); a 2D (B, H, W, 1) output
//    comes as D = 1 with no trim on that axis (dtpad = 0).
//  * tem_leaky_relu     replaces leaky_relu_kernel_call (pallas_kernels.py:
//    127-151): where(v >= 0, v, v * slope), f32 and bf16.
//
// Bound on the H100: all three are pure streams, bound by device-memory bytes
// (1 B in + 4 B out per voxel for pre, 4 B in + 1 B out for post, 2x the
// element size for LeakyReLU) at 3.35 TB/s.  The design reads and writes each
// element exactly once, with neighbouring threads on neighbouring addresses
// (4 voxels per thread with 4-byte/16-byte vector accesses in preprocess).
// Postprocess walks output rows (grid over (b, od) planes, a few rows per
// warp) so that its index arithmetic is 32-bit and free of divisions inside
// the loop (a flat index split by 64-bit divisions made the first version
// bound by issued instructions), and moves 4 outputs a thread: two 8-byte
// loads and one 4-byte store.
// LeakyReLU moves 16-byte vectors (4 f32 or 8 bf16), kLeakyUnroll of them in
// flight per thread before the first store, over a grid that covers the
// tensor in one pass (on the H100 at the main path's four shapes this beat a
// grid-stride loop capped at 4 waves, and 4 or 8 vectors per thread); the
// < 16-byte tail is one element per thread, and tensors whose pointers are
// not 16-byte aligned take a scalar grid-stride loop.
// Arithmetic uses the non-contracting __fmul_rn/__fadd_rn intrinsics so the
// results are bit-identical to the plain PyTorch versions, which round after
// every operation.
#include "common.cuh"

namespace tem {

__global__ void preprocess_u8_vec4(const uchar4* __restrict__ x,
                                   float4* __restrict__ y, long long n4,
                                   float a, float b) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const uchar4 v = x[i];
    float4 o;
    o.x = __fadd_rn(__fmul_rn(static_cast<float>(v.x), a), b);
    o.y = __fadd_rn(__fmul_rn(static_cast<float>(v.y), a), b);
    o.z = __fadd_rn(__fmul_rn(static_cast<float>(v.z), a), b);
    o.w = __fadd_rn(__fmul_rn(static_cast<float>(v.w), a), b);
    y[i] = o;
  }
}

__global__ void preprocess_u8_scalar(const uint8_t* __restrict__ x,
                                     float* __restrict__ y, long long n,
                                     float a, float b) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = __fadd_rn(__fmul_rn(static_cast<float>(x[i]), a), b);
  }
}

// One model output value -> one uint8 grey level, in the main path's order.
__device__ __forceinline__ uint8_t post_u8(float v, int has_ms, float mean,
                                           float std) {
  if (has_ms) v = __fadd_rn(__fmul_rn(v, std), mean);
  v = __fmul_rn(__fadd_rn(v, 1.0f), 127.5f);
  v = rintf(v);  // round half to even (never roundf)
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  return static_cast<uint8_t>(v);
}

constexpr int kPostMaxWarps = 4;

// Output rows of the trimmed window, one block per output (b, od) plane;
// the window starts dtpad planes into D and tpad rows / columns into H / W
// (dtpad = tpad for a 3D batch, 0 for a 2D one seen as D = 1).
// A row is Q = OW / V units of V outputs.  Where Q <= 32 a warp covers
// R = 32 / Q rows at once (lane -> (row, unit), worked out once, before the
// loop), else one row in steps of 32 units; the warps of the block step
// down the plane's OH rows.  All index arithmetic inside the loop is 32-bit
// and division-free: the one 64-bit offset is the plane's base pointer.
// V = 4: two 8-byte float2 loads and one uchar4 store a thread (needs OW % 4
// == 0 and, for the loads' alignment, even W and even tpad); V = 1: one
// float and one byte a thread (every other shape).
template <int V>
__global__ void __launch_bounds__(kPostMaxWarps * 32)
    postprocess_u8_rows(const float* __restrict__ y, uint8_t* __restrict__ out,
                        int D, int H, int W, int OD, int OH, int OW,
                        int dtpad, int tpad, int has_ms, float mean,
                        float std) {
  const int plane = blockIdx.x;
  const int b = plane / OD, od = plane - b * OD;
  const float* src =
      y + ((static_cast<size_t>(b) * D + od + dtpad) * H + tpad) * W + tpad;
  uint8_t* dst = out + static_cast<size_t>(plane) * OH * OW;
  const int Q = OW / V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = Q <= 32 ? 32 / Q : 1;
  const int rl = Q <= 32 ? lane / Q : 0;
  const int q0 = Q <= 32 ? lane - rl * Q : lane;
  if (rl >= R) return;  // the lanes left over past R whole rows
  const int row_step = (blockDim.x >> 5) * R;
  for (int r = warp * R + rl; r < OH; r += row_step) {
    const float* s = src + r * W;
    uint8_t* d = dst + r * OW;
    for (int q = q0; q < Q; q += 32) {
      if (V == 4) {
        const float2 a = *reinterpret_cast<const float2*>(s + 4 * q);
        const float2 c = *reinterpret_cast<const float2*>(s + 4 * q + 2);
        uchar4 o;
        o.x = post_u8(a.x, has_ms, mean, std);
        o.y = post_u8(a.y, has_ms, mean, std);
        o.z = post_u8(c.x, has_ms, mean, std);
        o.w = post_u8(c.y, has_ms, mean, std);
        *reinterpret_cast<uchar4*>(d + 4 * q) = o;
      } else {
        d[q] = post_u8(s[q], has_ms, mean, std);
      }
    }
  }
}

template <int V>
void launch_postprocess(const float* y, uint8_t* out, int B, int D, int H,
                        int W, int dtpad, int tpad, int has_ms, float mean,
                        float std, cudaStream_t s) {
  const int OD = D - 2 * dtpad, OH = H - 2 * tpad, OW = W - 2 * tpad;
  const int Q = OW / V;
  const int R = Q <= 32 ? 32 / Q : 1;
  int warps = (OH + R - 1) / R;
  warps = warps > kPostMaxWarps ? kPostMaxWarps : warps;
  postprocess_u8_rows<V><<<static_cast<unsigned int>(B * OD), warps * 32, 0,
                           s>>>(y, out, D, H, W, OD, OH, OW, dtpad, tpad,
                                has_ms, mean, std);
}

constexpr int kLeakyThreads = 256;
constexpr int kLeakyUnroll = 2;  // 16-byte vectors in flight per thread

// LeakyReLU of the elements packed in one 16-byte vector.
template <typename T>
__device__ __forceinline__ uint4 leaky_vec(uint4 v, float slope);
template <>
__device__ __forceinline__ uint4 leaky_vec<float>(uint4 v, float slope) {
  v.x = __float_as_uint(leaky(__uint_as_float(v.x), slope));
  v.y = __float_as_uint(leaky(__uint_as_float(v.y), slope));
  v.z = __float_as_uint(leaky(__uint_as_float(v.z), slope));
  v.w = __float_as_uint(leaky(__uint_as_float(v.w), slope));
  return v;
}
__device__ __forceinline__ uint32_t leaky_bf16x2(uint32_t u, float slope) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  const float lo = leaky(__low2float(h), slope);
  const float hi = leaky(__high2float(h), slope);
  h = __halves2bfloat162(from_f32<__nv_bfloat16>(lo),
                         from_f32<__nv_bfloat16>(hi));
  return *reinterpret_cast<uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint4 leaky_vec<__nv_bfloat16>(uint4 v,
                                                          float slope) {
  v.x = leaky_bf16x2(v.x, slope);
  v.y = leaky_bf16x2(v.y, slope);
  v.z = leaky_bf16x2(v.z, slope);
  v.w = leaky_bf16x2(v.w, slope);
  return v;
}

// nvec 16-byte vectors, kLeakyUnroll per thread (both loads before the
// first store), then the n - nvec * (16 / sizeof(T)) tail elements, one per
// thread of the first block.
template <typename T>
__global__ void __launch_bounds__(kLeakyThreads)
    leaky_relu_vec(const T* __restrict__ x, T* __restrict__ y, long long n,
                   long long nvec, float slope) {
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const long long base =
      (long long)blockIdx.x * (kLeakyThreads * kLeakyUnroll) + threadIdx.x;
  uint4 v[kLeakyUnroll];
#pragma unroll
  for (int u = 0; u < kLeakyUnroll; ++u) {
    const long long i = base + u * kLeakyThreads;
    if (i < nvec) v[u] = xv[i];
  }
#pragma unroll
  for (int u = 0; u < kLeakyUnroll; ++u) {
    const long long i = base + u * kLeakyThreads;
    if (i < nvec) yv[i] = leaky_vec<T>(v[u], slope);
  }
  const long long t = nvec * static_cast<long long>(16 / sizeof(T)) +
                      static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t < n) y[t] = from_f32<T>(leaky(to_f32<T>(x[t]), slope));
}

template <typename T>
__global__ void leaky_relu_scalar(const T* __restrict__ x, T* __restrict__ y,
                                  long long n, float slope) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = from_f32<T>(leaky(to_f32<T>(x[i]), slope));
  }
}

template <typename T>
void launch_leaky_relu(const void* xp, void* yp, long long n, float slope,
                       cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (!vec) {
    leaky_relu_scalar<T><<<grid_for(n), 256, 0, s>>>(x, y, n, slope);
    return;
  }
  const long long nvec = n / static_cast<long long>(16 / sizeof(T));
  long long blocks =
      (nvec + kLeakyThreads * kLeakyUnroll - 1) / (kLeakyThreads * kLeakyUnroll);
  blocks = blocks < 1 ? 1 : blocks;  // the tail needs the first block
  leaky_relu_vec<T><<<static_cast<unsigned int>(blocks), kLeakyThreads, 0, s>>>(
      x, y, n, nvec, slope);
}

}  // namespace tem

extern "C" {

int tem_preprocess_u8(const void* x, void* y, long long n, float a, float b,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (vec) {
    tem::preprocess_u8_vec4<<<tem::grid_for(n / 4), 256, 0, s>>>(
        static_cast<const uchar4*>(x), static_cast<float4*>(y), n / 4, a, b);
  } else {
    tem::preprocess_u8_scalar<<<tem::grid_for(n), 256, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<float*>(y), n, a, b);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtpad: the trim of the D axis, tpad of H and W (a 2D batch: D = 1,
// dtpad = 0).  The vector path's alignment depends on W and tpad alone: the
// window's base offset is (..) * W + tpad floats.
int tem_postprocess_u8(const void* y, void* out, int B, int D, int H, int W,
                       int dtpad, int tpad, int has_ms, float mean, float std,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int OW = W - 2 * tpad;
  if (B <= 0 || D <= 2 * dtpad || H <= 2 * tpad || OW <= 0)
    return static_cast<int>(cudaGetLastError());
  const float* yf = static_cast<const float*>(y);
  uint8_t* o = static_cast<uint8_t*>(out);
  const bool vec = OW % 4 == 0 && W % 2 == 0 && tpad % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (vec) {
    tem::launch_postprocess<4>(yf, o, B, D, H, W, dtpad, tpad, has_ms, mean,
                               std, s);
  } else {
    tem::launch_postprocess<1>(yf, o, B, D, H, W, dtpad, tpad, has_ms, mean,
                               std, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int tem_leaky_relu(const void* x, void* y, int dtype, long long n, float slope,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == tem::kF32) {
    tem::launch_leaky_relu<float>(x, y, n, slope, s);
  } else if (dtype == tem::kBF16) {
    tem::launch_leaky_relu<__nv_bfloat16>(x, y, n, slope, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
