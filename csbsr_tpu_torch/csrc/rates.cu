// Dispatch-rate microkernels for Hopper (sm_90a): how many of one instruction
// (or of one instruction mix) an SM completes per clock, measured rather
// than assumed. chip_smoke.py's phase_rates times each at full occupancy and
// derives the min-plus kernel's operations bound from the rates
// (ops/rates.py, csrc/minplus.cu).
//
// Each thread runs kChains independent dependency chains for `iters` trips
// of a loop unrolled kUnroll times, so a trip executes kChains * kUnroll of
// the measured operation. The operands rotate through the chains (never a
// chain with itself), which keeps the compiler from folding or hoisting
// them; `cuobjdump -sass` of the built library shows what each became. The
// result is stored so that nothing is dead.
//
//   0 fmnmx    a = fminf(a, a')                     FMNMX
//   1 fadd     a = a + b                            FADD
//   2 ffma     a = a * m + b                        FFMA
//   3 pair     a = fminf(a', b + a)                 FADD + FMNMX: one float candidate
//   4 viaddmin a = __viaddmin_s32(a, b, a')         VIADDMNMX: one int32 candidate
//   5 vimin3   a = __vimin3_s32(a, a', a'')         VIMNMX3
//   6 pair3    a = vimin3(a, bits(a' + b), bits(a'' + b))
//                                                  2 FADD + VIMNMX3: two float candidates
//   7 minmix   ops 0, 4 and 5 on chains c = 0, 1, 2 (mod 3) of one thread
//                                                  FMNMX, VIADDMNMX, VIMNMX3
//
// Op 6 counts candidates, so a trip executes 2 * kChains * kUnroll of them.
// Op 7 counts instructions: if the three share one pipe it runs at the rate
// of each alone, if not at up to the dispatch rate.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kUnroll = 16;

template <int kOp>
__global__ void __launch_bounds__(256) rate_kernel(int iters, int seed, int* sink) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kOp <= 3) {
    float a[kChains], b[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      a[c] = (float)(seed + t + c);
      b[c] = (float)(seed - c);
    }
    const float m = 1.0f + (float)seed * 1e-9f;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          if constexpr (kOp == 0) a[c] = fminf(a[c], a[(c + 1 + u % 7) % kChains]);
          if constexpr (kOp == 1) a[c] = a[c] + b[c];
          if constexpr (kOp == 2) a[c] = fmaf(a[c], m, b[c]);
          if constexpr (kOp == 3) a[c] = fminf(a[(c + 1 + u % 7) % kChains], b[c] + a[c]);
        }
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kChains; ++c) s += a[c];
    if (s == 1.2345f) sink[t] = 1;
  } else if constexpr (kOp == 6) {
    int a[kChains];
    float b[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      a[c] = __float_as_int((float)(seed + t + c));
      b[c] = (float)(seed + c);
    }
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          const float x = __int_as_float(a[(c + 1 + u % 7) % kChains]) + b[c];
          const float y = __int_as_float(a[(c + 1 + (u + 3) % 7) % kChains]) + b[c];
          a[c] = __vimin3_s32(a[c], __float_as_int(x), __float_as_int(y));
        }
      }
    }
    int s = 0;
#pragma unroll
    for (int c = 0; c < kChains; ++c) s ^= a[c];
    if (s == 12345) sink[t] = 1;
  } else if constexpr (kOp == 7) {
    int a[kChains], b[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      a[c] = __float_as_int((float)(seed + t + c));
      b[c] = seed - c;
    }
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          const int x = a[(c + 1 + u % 7) % kChains], y = a[(c + 1 + (u + 3) % 7) % kChains];
          if (c % 3 == 0) a[c] = __float_as_int(fminf(__int_as_float(a[c]), __int_as_float(x)));
          if (c % 3 == 1) a[c] = __viaddmin_s32(a[c], b[c], x);
          if (c % 3 == 2) a[c] = __vimin3_s32(a[c], x, y);
        }
      }
    }
    int s = 0;
#pragma unroll
    for (int c = 0; c < kChains; ++c) s ^= a[c];
    if (s == 12345) sink[t] = 1;
  } else {
    int a[kChains], b[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      a[c] = seed + t + c;
      b[c] = seed - c;
    }
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          if constexpr (kOp == 4) a[c] = __viaddmin_s32(a[c], b[c], a[(c + 1 + u % 7) % kChains]);
          if constexpr (kOp == 5)
            a[c] = __vimin3_s32(a[c], a[(c + 1 + u % 7) % kChains],
                                a[(c + 1 + (u + 3) % 7) % kChains]);
        }
      }
    }
    int s = 0;
#pragma unroll
    for (int c = 0; c < kChains; ++c) s ^= a[c];
    if (s == 12345) sink[t] = 1;
  }
}

template <int kOp>
int launch(int blocks, int iters, int seed, int* sink, cudaStream_t stream) {
  rate_kernel<kOp><<<blocks, 256, 0, stream>>>(iters, seed, sink);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: launch microkernel `op` (0-7, above) on `blocks`
// blocks of 256 threads for `iters` loop trips; each thread then has executed
// iters * csbsr_rate_ops_per_trip(op) of the operation. sink is a device
// buffer of blocks * 256 ints (written only on an impossible value).
// Returns the cudaError_t of the launch; 1 for an unknown op.
extern "C" int csbsr_rate_ops_per_trip(int op) { return (op == 6 ? 2 : 1) * kChains * kUnroll; }

extern "C" int csbsr_rate(int op, int blocks, int iters, int seed, int* sink, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0: return launch<0>(blocks, iters, seed, sink, s);
    case 1: return launch<1>(blocks, iters, seed, sink, s);
    case 2: return launch<2>(blocks, iters, seed, sink, s);
    case 3: return launch<3>(blocks, iters, seed, sink, s);
    case 4: return launch<4>(blocks, iters, seed, sink, s);
    case 5: return launch<5>(blocks, iters, seed, sink, s);
    case 6: return launch<6>(blocks, iters, seed, sink, s);
    case 7: return launch<7>(blocks, iters, seed, sink, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
