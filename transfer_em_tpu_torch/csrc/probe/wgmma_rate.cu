// Throughput of wgmma.mma_async with A from registers, as conv3_tc.cu issues
// it: each warpgroup keeps P accumulator tiles of 64 x N and, per step,
// issues one wgmma into each (one commit group), then waits until at most
// one group is in flight.  B is one zeroed k-step in shared memory.  The
// tensor cores' rate depends on N; this measures what the conv's widths can
// reach (tf32 also at the kw form's N = 24, 48, 96, 192); wgmma_kstep times
// the kw form's f32 k-step.  Built and run by
// transfer_em_tpu_torch/kernels/wgmma_probe.py, not part of the kernel
// library.
#include <cuda_runtime.h>

#include "../wgmma.cuh"

namespace tem {
namespace tc {

template <int N, int P, bool BF16>
__global__ void __launch_bounds__(128) wgmma_rate(float* out, int iters) {
  __shared__ __align__(128) uint8_t s_b[N * 32];
  for (int i = threadIdx.x; i < N * 8; i += blockDim.x) {
    reinterpret_cast<float*>(s_b)[i] = 0.f;
  }
  fence_proxy_async();
  __syncthreads();
  float acc[P][N / 2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[p][i] = 0.f;
  }
  const uint32_t a[4] = {threadIdx.x, 3u * threadIdx.x, 7u, 9u};
  const uint64_t desc = make_desc(smem_u32(s_b));
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if constexpr (BF16) {
        mma_bf16(acc[p], a, desc);
      } else {
        mma_tf32(acc[p], a, desc);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    fence_operands(acc[p]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum += acc[p][i];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// The same issue pattern on int8 (.s8 x .s8 -> .s32, m64nNk32), as
// conv_int8.cu issues it.
template <int N, int P>
__global__ void __launch_bounds__(128) wgmma_rate_s8(float* out, int iters) {
  __shared__ __align__(128) uint8_t s_b[N * 32];
  for (int i = threadIdx.x; i < N * 8; i += blockDim.x) {
    reinterpret_cast<int*>(s_b)[i] = 0;
  }
  fence_proxy_async();
  __syncthreads();
  int acc[P][N / 2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[p][i] = 0;
  }
  const uint32_t a[4] = {threadIdx.x, 3u * threadIdx.x, 7u, 9u};
  const uint64_t desc = make_desc(smem_u32(s_b));
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) mma_s8(acc[p], a, desc);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  int sum = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    fence_operands(acc[p]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum += acc[p][i];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<float>(sum);
}

// One f32 k-step of conv3_tc.cu's kw form on each of P tiles, 3xTF32 as
// the kernel can issue it: ``three`` wgmmas of width N into one accumulator
// (x_lo * w_hi, x_hi * w_lo, x_hi * w_hi), or the ``pair`` of one wgmma of
// width 2N (x_hi * [w_hi | w_lo]) and one of width N (x_lo * w_hi) into an
// accumulator of its own.  One commit group a step, at most one in flight
// behind it, as the kernel issues them.
template <int N, int P, bool PAIR>
__global__ void __launch_bounds__(128) wgmma_kstep(float* out, int iters) {
  __shared__ __align__(128) uint8_t s_b[2 * N * 32];
  for (int i = threadIdx.x; i < 2 * N * 8; i += blockDim.x) {
    reinterpret_cast<float*>(s_b)[i] = 0.f;
  }
  fence_proxy_async();
  __syncthreads();
  constexpr int kWide = PAIR ? N : N / 2;  // registers of the first sum
  float acc[P][kWide];
  float acc1[P][N / 2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int i = 0; i < kWide; ++i) acc[p][i] = 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc1[p][i] = 0.f;
  }
  const uint32_t a[4] = {threadIdx.x, 3u * threadIdx.x, 7u, 9u};
  const uint32_t b[4] = {5u * threadIdx.x, 11u, threadIdx.x, 13u};
  const uint64_t d_hi = make_desc(smem_u32(s_b));
  const uint64_t d_lo = make_desc(smem_u32(s_b + N * 32));
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if constexpr (PAIR) {
        mma_tf32(acc[p], a, d_hi);
        mma_tf32(acc1[p], b, d_hi);
      } else {
        mma_tf32(acc[p], b, d_hi);
        mma_tf32(acc[p], a, d_lo);
        mma_tf32(acc[p], a, d_hi);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    fence_operands(acc[p]);
    fence_operands(acc1[p]);
#pragma unroll
    for (int i = 0; i < kWide; ++i) sum += acc[p][i];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum += acc1[p][i];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// dtype: 0 tf32, 1 bf16, 2 s8
template <int N, int P>
cudaError_t launch(int dtype, int blocks, int iters, float* out) {
  if (dtype == 2) {
    wgmma_rate_s8<N, P><<<blocks, 128>>>(out, iters);
  } else if (dtype == 1) {
    wgmma_rate<N, P, true><<<blocks, 128>>>(out, iters);
  } else {
    wgmma_rate<N, P, false><<<blocks, 128>>>(out, iters);
  }
  return cudaGetLastError();
}

template <int N, int P>
cudaError_t launch_tf32(int blocks, int iters, float* out) {
  wgmma_rate<N, P, false><<<blocks, 128>>>(out, iters);
  return cudaGetLastError();
}

template <int N, int P, bool PAIR>
cudaError_t launch_kstep(int blocks, int iters, float* out) {
  wgmma_kstep<N, P, PAIR><<<blocks, 128>>>(out, iters);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace tem

extern "C" int tem_wgmma_rate(int n, int dtype, int blocks, int iters,
                              float* out) {
  const bool tf32 = dtype == 0;  // the kw form's widths are tf32 only
  switch (n) {  // P as conv3_tc.cu uses it: 4 tiles, 2 at N = 64 and 96,
                // 1 at 192
    case 8:
      return tem::tc::launch<8, 4>(dtype, blocks, iters, out);
    case 16:
      return tem::tc::launch<16, 4>(dtype, blocks, iters, out);
    case 32:
      return tem::tc::launch<32, 4>(dtype, blocks, iters, out);
    case 64:
      return tem::tc::launch<64, 2>(dtype, blocks, iters, out);
    case 24:
      return tf32 ? tem::tc::launch_tf32<24, 4>(blocks, iters, out)
                  : static_cast<int>(cudaErrorInvalidValue);
    case 48:
      return tf32 ? tem::tc::launch_tf32<48, 4>(blocks, iters, out)
                  : static_cast<int>(cudaErrorInvalidValue);
    case 96:
      return tf32 ? tem::tc::launch_tf32<96, 2>(blocks, iters, out)
                  : static_cast<int>(cudaErrorInvalidValue);
    case 192:
      return tf32 ? tem::tc::launch_tf32<192, 1>(blocks, iters, out)
                  : static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One 3xTF32 k-step of the kw form at width n on p tiles, as three wgmmas
// (pair 0) or as the 2n + n pair (pair 1).
extern "C" int tem_wgmma_kstep(int n, int pair, int p, int blocks, int iters,
                               float* out) {
  const int key = n * 100 + pair * 10 + p;
  switch (key) {
    case 2404:
      return tem::tc::launch_kstep<24, 4, false>(blocks, iters, out);
    case 2414:
      return tem::tc::launch_kstep<24, 4, true>(blocks, iters, out);
    case 2412:
      return tem::tc::launch_kstep<24, 2, true>(blocks, iters, out);
    case 4804:
      return tem::tc::launch_kstep<48, 4, false>(blocks, iters, out);
    case 4802:
      return tem::tc::launch_kstep<48, 2, false>(blocks, iters, out);
    case 4812:
      return tem::tc::launch_kstep<48, 2, true>(blocks, iters, out);
    case 9602:
      return tem::tc::launch_kstep<96, 2, false>(blocks, iters, out);
    case 9611:
      return tem::tc::launch_kstep<96, 1, true>(blocks, iters, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
