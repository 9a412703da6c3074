// Row pass of the exact Euclidean distance transform, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel csbsr_tpu/ops/pallas/minplus.py
// (minplus_rows_pallas / _minplus_kernel). For every row r of a
// (rows, W) float32 map g of column-pass distances it writes
//
//     out[r, j] = min_k ( min(g[r, k]^2, 1e9) + (j - k)^2 )
//
// (squared distances; the caller takes the square root). The cap of 1e9 is
// the XLA path's (csbsr_tpu/ops/edt.py), not the Pallas kernel's 1e18: it is
// the value the CPU tests can check, and every caller masks slices that
// hold no True pixel, where the two caps differ.
//
// What bounds it: operations. Each output does W candidates of one fused
// multiply-add and one min; the bytes are one read of g and one write of
// out. At the HD-bank shape (99*449 rows of 449) that is about 9e9
// candidates for 160 MB of traffic, far on the compute side of the card's
// balance point.
//
// Design (simple first): one block of 256 threads owns ROWS rows. The
// block sweeps its output columns in chunks of 256 (one column j per
// thread per chunk) and, for each chunk, sweeps k in chunks of KCHUNK,
// staging the rows' g^2 for that k-chunk in shared memory, so any W works.
// Inside a k-chunk every thread reads the same shared word per row
// (a broadcast, no bank conflicts) and keeps ROWS running minima in
// registers. (j - k) is an exact small integer in float32, so d*d and the
// sum with an integer g^2 are exact for H, W <= 2896; the result then
// equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kChunk = 256;
constexpr float kCap = 1e9f;

__global__ void __launch_bounds__(kThreads)
minplus_rows_kernel(const float* __restrict__ g, float* __restrict__ out,
                    long long rows, int w) {
  __shared__ float s_g2[kChunk][kRows];
  const long long r0 = (long long)blockIdx.x * kRows;
  const int n_rows = (int)min((long long)kRows, rows - r0);

  for (int j0 = 0; j0 < w; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = __int_as_float(0x7f800000);  // +inf

    for (int k0 = 0; k0 < w; k0 += kChunk) {
      const int kn = min(kChunk, w - k0);
      __syncthreads();  // the previous chunk's readers are done
      for (int idx = threadIdx.x; idx < kRows * kChunk; idx += kThreads) {
        const int r = idx / kChunk;
        const int kk = idx - r * kChunk;
        float v = 0.0f;
        if (r < n_rows && kk < kn) {
          const float x = g[(r0 + r) * (long long)w + k0 + kk];
          v = fminf(x * x, kCap);
        }
        s_g2[kk][r] = v;
      }
      __syncthreads();

      float d = (float)(j - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float dd = d * d;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fminf(acc[r], s_g2[kk][r] + dd);
        d -= 1.0f;
      }
    }
    if (j < w) {
      for (int r = 0; r < n_rows; ++r) out[(r0 + r) * (long long)w + j] = acc[r];
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. g and out are device pointers to
// contiguous (rows, w) float32 arrays; stream is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int csbsr_minplus_rows(const float* g, float* out, long long rows,
                                  int w, void* stream) {
  if (rows <= 0 || w <= 0) return 0;
  const long long blocks = (rows + kRows - 1) / kRows;
  minplus_rows_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g, out, rows, w);
  return (int)cudaGetLastError();
}
