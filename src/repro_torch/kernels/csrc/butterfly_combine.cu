// butterfly_combine: the d -> (d - 1, C(d, 2)) contribution transform.
//   dm1[i] = d[i] - 1                 where valid[i] && d[i] > 0, else 0
//   c2[i]  = d[i] * (d[i] - 1) / 2    where also rep[i], else 0 (int64)
//
// Replaces the Pallas TPU kernel butterfly_combine.butterfly_combine_pallas
// (src/repro/kernels/butterfly_combine.py). The TPU kernel had no 64-bit
// integers, so it built C(d, 2) as two int32 limbs from a 16-bit-limb
// multiply, and it also reduced a float32 total that the counting path
// never reads. Here C(d, 2) is one exact 64-bit multiply for every int32
// d, and the diagnostic float total is dropped.
//
// What bounds it on an H100: bytes. Per entry it reads 6 B (d, rep,
// valid) and writes 12 B (dm1, c2); the arithmetic is a few integer
// operations. One grid-stride elementwise pass.
#include "common.cuh"

namespace {

__global__ void butterfly_combine_kernel(const int32_t* __restrict__ d,
                                         const uint8_t* __restrict__ rep,
                                         const uint8_t* __restrict__ valid,
                                         long long n,
                                         int32_t* __restrict__ dm1,
                                         long long* __restrict__ c2) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int32_t di = d[i];
    const bool live = valid[i] && di > 0;
    dm1[i] = live ? di - 1 : 0;
    const long long dd = di;
    c2[i] = (live && rep[i]) ? dd * (dd - 1) / 2 : 0;
  }
}

}  // namespace

BF_EXPORT int bf_butterfly_combine(const int32_t* d, const uint8_t* rep,
                                   const uint8_t* valid, long long n,
                                   int32_t* dm1, long long* c2,
                                   void* stream) {
  if (n > 0) {
    butterfly_combine_kernel<<<bf::grid_for(n), bf::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        d, rep, valid, n, dm1, c2);
  }
  return static_cast<int>(cudaGetLastError());
}
