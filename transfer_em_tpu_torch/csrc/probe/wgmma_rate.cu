// Throughput of wgmma.mma_async with A from registers, as conv3_tc.cu issues
// it: each warpgroup keeps P accumulator tiles of 64 x N and, per step,
// issues one wgmma into each (one commit group), then waits until at most
// one group is in flight.  B is one zeroed k-step in shared memory.  The
// tensor cores' rate depends on N; this measures what the conv's widths can
// reach.  Built and run by transfer_em_tpu_torch/kernels/wgmma_probe.py, not
// part of the kernel library.
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

}  // namespace tc
}  // namespace tem

extern "C" int tem_wgmma_rate(int n, int dtype, int blocks, int iters,
                              float* out) {
  switch (n) {  // P as conv3_tc.cu uses it: 4 tiles, 2 at N = 64
    case 8:
      return tem::tc::launch<8, 4>(dtype, blocks, iters, out);
    case 16:
      return tem::tc::launch<16, 4>(dtype, blocks, iters, out);
    case 32:
      return tem::tc::launch<32, 4>(dtype, blocks, iters, out);
    case 64:
      return tem::tc::launch<64, 2>(dtype, blocks, iters, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
