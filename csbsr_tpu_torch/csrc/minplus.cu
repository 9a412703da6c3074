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
// What bounds it: operations. Each output takes the min over W candidates
// G[r, k] + (j - k)^2, G = min(g^2, 1e9); the bytes are one read of g and
// one write of out. At the HD-bank shape (99*449 rows of 449) that is
// 9.0e9 candidates for 160 MB of traffic. Measured on an H100 (700 W) by
// csrc/rates.cu: FMNMX, VIADDMNMX and VIMNMX3 each run at about 62 per SM
// per clock and share one pipe (16 lanes per scheduler), FADD and FFMA at
// about 124, and the SM dispatches 128 thread-instructions per clock. A
// candidate costs FADD + FMNMX, or one DPX VIADDMNMX (integer G only), or
// one FADD and half a VIMNMX3 (a three-way min over two candidates and the
// running minimum). The cheapest mix of the three under the dispatch rate
// and the two pipes' rates, about 2 VIMNMX3 pairs per VIADDMNMX, reaches
// about 95 candidates per SM per clock: the bound, 0.36 ms at the bank
// shape (ops/rates.py solves the mix from the measured rates; chip_smoke.py
// prints the bound beside the time).
//
// Design, for the SM and not the Pallas blocks:
//   - Candidates by VIMNMX3 alone, about 85 per SM per clock at the
//     dispatch rate: two candidates' float sums, then one VIMNMX3 over their
//     bit patterns and the running minimum; non-negative floats order as
//     their bits do, so this is the float min. It is exact for any float
//     input; adding VIADDMNMX for the last 11% would need integer G in a
//     second staged copy.
//   - Work items of R=8 rows x J=4 columns, numbered row group by row group
//     (item = row_group * col_groups + col_group) and dealt to blocks in runs
//     of `items_per_block`: only the last warp of the grid has idle lanes,
//     whatever W is (the simple kernel left 63 of 512 lanes idle at 449).
//   - Each block stages G of all the rows its items touch, for all k, into
//     dynamic shared memory in one pass and one barrier (no k-chunks). The
//     square and cap are applied on the way, once per element, so the copy
//     goes through registers (a copy engine, cp.async or TMA, cannot apply
//     them), eight loads in flight per thread. Layout [k][rb] with rb = 4
//     (mod 8): a warp stages a tile of 8 k x 4 rows, which lands in 32
//     distinct banks; compute reads 8 rows of one k as two 16-byte
//     broadcast loads.
//   - Register blocking: a thread keeps 8 x 4 running minima. For
//     consecutive columns the squares (j - k)^2 of one k are those of the
//     previous k shifted by one column, so each k costs one new square, two
//     LDS.128 and 32 candidates: about 1.66 instructions per candidate,
//     against about 2.6 in the simple kernel.
//   - Where there are few rows (the GT border, the training SDF), the plan
//     splits k over `split` warp groups of the block; each group keeps its
//     partial minima, and a min over the groups in shared memory finishes
//     the band (min is exact and associative). The plan is computed on the
//     host (ops/minplus.launch_plan), which the CPU tests check covers every
//     (row, column) once with every k range whole.
//
// Exactness: (j - k) and its square are exact small integers in float32,
// and each candidate is the same float32 sum the plain version forms, so
// the min over candidates is bit for bit that of the plain PyTorch version
// for H, W <= 2896.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;              // rows per thread
constexpr int kJ = 4;              // columns per thread
constexpr int kMaxThreads = 512;   // threads per block: 256 or 512
constexpr int kUnroll = 8;         // k steps per unrolled loop trip (even)
constexpr int kStageBatch = 8;     // staging loads in flight per thread
constexpr float kCap = 1e9f;
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use

struct Plan {  // see csbsr_minplus_rows; rows and items are below 2^31
  int rows, items, w, col_groups, split, kslice, items_per_block, rb;
};

// One candidate pair: the float sums G + (j - k)^2 of two candidates, then
// one VIMNMX3 over their bit patterns and the running minimum acc (the bits
// of a non-negative float). Non-negative floats order as their bits do, so
// this is the float min.
__device__ __forceinline__ int min3(int acc, float g1, float s1, float g2, float s2) {
  return __vimin3_s32(acc, __float_as_int(g1 + s1), __float_as_int(g2 + s2));
}

__global__ void __launch_bounds__(kMaxThreads)
minplus_rows_kernel(const float* __restrict__ g, float* __restrict__ out, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_g = reinterpret_cast<float*>(smem_raw);

  const int w = plan.w, rb = plan.rb, tj = plan.col_groups;
  const int per_block = plan.items_per_block;
  const int item0 = blockIdx.x * per_block;
  const int item_last = min(item0 + per_block, plan.items) - 1;
  const int row_lo = (item0 / tj) * kR;
  const int n_rows = min((item_last / tj + 1) * kR, plan.rows) - row_lo;

  // stage G for the block's rows, all k: a warp stages tiles of 8 k x 4
  // rows, lane = (row in tile) * 8 + (k in tile), kStageBatch tiles at a
  // time so that as many loads are in flight; tiles are dealt to the warps
  // k-chunk fastest, stepped without a division
  {
    const int n_k8 = (w + 7) >> 3, n_r4 = (n_rows + 3) >> 2;
    const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    const int kl = lane & 7, rl = lane >> 3;
    const float* src = g + (long long)row_lo * w;
    int tr = (threadIdx.x >> 5) / n_k8, tk = (threadIdx.x >> 5) - tr * n_k8;
    while (tr < n_r4) {
      float v[kStageBatch];
      int dst[kStageBatch];
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b) {
        const int k = tk * 8 + kl, r = tr * 4 + rl;
        const bool in = tr < n_r4 && k < w;
        dst[b] = in ? k * rb + r : -1;
        v[b] = in && r < n_rows ? src[(long long)r * w + k] : 0.0f;
        for (tk += warps; tk >= n_k8; tk -= n_k8) ++tr;
      }
#pragma unroll
      for (int b = 0; b < kStageBatch; ++b)
        if (dst[b] >= 0) s_g[dst[b]] = fminf(v[b] * v[b], kCap);
    }
  }
  __syncthreads();

  // this thread's item and k range
  const int slice = threadIdx.x / per_block;
  const int p = threadIdx.x - slice * per_block;
  const int item = min(item0 + p, item_last);  // idle lanes redo the last item
  const int rg = item / tj;
  const int lr = rg * kR - row_lo;
  const int jb = (item - rg * tj) * kJ;
  const int k_lo = min(slice * plan.kslice, w);
  const int k_hi = min(k_lo + plan.kslice, w);

  int acc[kR][kJ];  // the bits of the running minima, +inf at first
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kJ; ++c) acc[r][c] = 0x7f800000;

  // sq[c] = (jb + c - k)^2 for the current k; the next k's squares are
  // these shifted by one column, with one new square in front
  float sq[kJ];
  float e = (float)(jb - k_lo);
#pragma unroll
  for (int c = 0; c < kJ; ++c) sq[c] = (e + (float)c) * (e + (float)c);

  const float* sp = s_g + (long long)k_lo * rb + lr;
  auto load8 = [&](const float* at, float* gv) {
    const float4 lo = *reinterpret_cast<const float4*>(at);
    const float4 hi = *reinterpret_cast<const float4*>(at + 4);
    gv[0] = lo.x; gv[1] = lo.y; gv[2] = lo.z; gv[3] = lo.w;
    gv[4] = hi.x; gv[5] = hi.y; gv[6] = hi.z; gv[7] = hi.w;
  };
  auto one_k = [&]() {
    float gv[kR];
    load8(sp, gv);
    sp += rb;
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kJ; ++c) acc[r][c] = min(acc[r][c], __float_as_int(gv[r] + sq[c]));
#pragma unroll
    for (int c = kJ - 1; c > 0; --c) sq[c] = sq[c - 1];
    e -= 1.0f;
    sq[0] = e * e;
  };
  auto two_k = [&]() {
    float ga[kR], gb[kR], sq1[kJ];
    load8(sp, ga);
    load8(sp + rb, gb);
    sp += 2 * rb;
    e -= 1.0f;
    sq1[0] = e * e;
#pragma unroll
    for (int c = 1; c < kJ; ++c) sq1[c] = sq[c - 1];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kJ; ++c) acc[r][c] = min3(acc[r][c], ga[r], sq[c], gb[r], sq1[c]);
#pragma unroll
    for (int c = kJ - 1; c > 0; --c) sq[c] = sq1[c - 1];
    e -= 1.0f;
    sq[0] = e * e;
  };
  int k = k_lo;
  for (; k + kUnroll <= k_hi; k += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; u += 2) two_k();
  }
#pragma unroll 1
  for (; k < k_hi; ++k) one_k();

  const bool live = item0 + p <= item_last;
  float* const row_out = out + (long long)(row_lo + lr) * w + jb;
  if (plan.split == 1) {
    if (!live) return;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (row_lo + lr + r >= plan.rows) break;
#pragma unroll
      for (int c = 0; c < kJ; ++c)
        if (jb + c < w) row_out[r * w + c] = __int_as_float(acc[r][c]);
    }
    return;
  }

  // k was split over the block's warp groups: min over the groups, in the
  // staging buffer once every group is done reading it. Output rc = r * kJ
  // + c of item p sits at red[(s * kR * kJ + rc) * per_block + p]; the
  // thread of group s finishes outputs s, s + split, ... of its own item.
  float* red = reinterpret_cast<float*>(smem_raw);
  __syncthreads();
#pragma unroll
  for (int rc = 0; rc < kR * kJ; ++rc)
    red[(slice * kR * kJ + rc) * per_block + p] = __int_as_float(acc[rc / kJ][rc % kJ]);
  __syncthreads();
  if (!live) return;
  for (int rc = slice; rc < kR * kJ; rc += plan.split) {
    float v = red[rc * per_block + p];
    for (int s = 1; s < plan.split; ++s) v = fminf(v, red[(s * kR * kJ + rc) * per_block + p]);
    const int r = rc / kJ, c = rc % kJ;
    if (row_lo + lr + r < plan.rows && jb + c < w) row_out[r * w + c] = v;
  }
}

}  // namespace

// Plain C entry point for ctypes. g and out are device pointers to
// contiguous (rows, w) float32 arrays; stream is a cudaStream_t. The launch
// plan comes from csbsr_tpu_torch/ops/minplus.launch_plan: col_groups =
// ceil(w / 4), k split over `split` warp groups of `kslice` k each,
// `items_per_block` items per group (a multiple of 32), the shared row
// stride rb (4 mod 8), threads (256 or 512) = split * items_per_block, the
// grid and the dynamic shared memory in bytes. Returns the cudaError_t of
// the launch (0 = success); 1 (cudaErrorInvalidValue) for a plan it does
// not take.
extern "C" int csbsr_minplus_rows(const float* g, float* out, long long rows, int w,
                                  int col_groups, int split, int kslice, int items_per_block,
                                  int rb, int threads, int blocks, int smem, void* stream) {
  if (rows <= 0 || w <= 0) return 0;
  const long long items = ((rows + kR - 1) / kR) * col_groups;
  if (rows >= (1LL << 31) || items >= (1LL << 31) - kMaxThreads ||
      (threads != 256 && threads != 512) || split * items_per_block != threads ||
      items_per_block % 32 != 0 || smem > kMaxSmem || rb % 8 != 4 ||
      col_groups != (w + kJ - 1) / kJ)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // one attribute call per process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        minplus_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  Plan plan{(int)rows, (int)items, w, col_groups, split, kslice, items_per_block, rb};
  minplus_rows_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(g, out, plan);
  return (int)cudaGetLastError();
}
