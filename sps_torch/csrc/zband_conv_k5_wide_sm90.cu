// z-band stem convolution (k = 5) at C = 48 on Hopper's warpgroup tensor
// cores (sm_90a, wgmma): the stem of DIST_FEATURE, whose two input
// channels make the z-folded halo 12 z x 2 slots x 2 channels = 48 wide.
// Plain C entry point sps_zband_conv_k5_wide_sm90 (below);
// zband_conv_op.cpp binds it to PyTorch as route 4 ("wgmma_k5_wide") and
// sps_torch/ops/zband_conv.py routes a call here when its shape qualifies
// (zband_conv.route). C <= 24 stays on zband_conv_k5_sm90.cu. Device helpers
// in sm90_wgmma.cuh.
//
// Replaces, at the shapes it takes, the Pallas TPU kernel zband_conv of
// sps_tpu/ops/pallas_conv.py:218 (_zmm_kernel_onepass, :74) at the stem of
// MinkUNet14 with DIST_FEATURE in the z-folded layout (conv0p1s1, k = 5,
// once per scan under STEM_ZBAND or CONV_MODE zband).
//
// Function, with k = 5, bs = 8, h = 12 (one brick's halo side):
//   out[b, xo, yo, n] = sum_{kx, ky < 5} sum_{c < C} hz[b, xo+kx, yo+ky, c] * wz[kx, ky, c, n]
// summed in f32, stored as bf16, for any wz. Shapes taken: bf16, C = 48,
// N % 128 == 0 (the rule of every wgmma route: two column tiles of 64),
// any B, 16-byte aligned operands; anything else is refused
// (error -1). The stem's call: hz (11264, 12, 12, 48), wz (5, 5, 48, 128).
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s): the
// call's 221.5 GFLOP (band zeros counted) against 0.341 GB moved, so
// operations, 0.224 ms. zband_conv_k5_sm90.cu (C <= 24) keeps all 25 taps of
// a 128-column tile resident and reads them again in each block: at C = 48
// they would take 307,200 bytes, more than a block's 232,448, and staged a
// row at a time they would cross L2 once per 6 bricks (1878 x 307,200 bytes
// = 0.58 GB a call).
//
// Design: weight-stationary, persistent, 64 columns.
//   * A block holds one 64-column tile of wz (gridDim.y walks N) for all 25
//     taps, resident for its whole life: 25 taps x 6 8-channel groups x
//     1024 bytes = 153,600 bytes, as MN-major core matrices [8-channel
//     group][8-column group][8][8] (SBO 128 bytes: next 8 columns; LBO 1024:
//     next 8 channels). gridDim.x is the SMs / tiles (66 at N = 128; one
//     block an SM), so the weight crosses L2 132 times a call.
//   * The block's two warpgroups work apart: warpgroup w of block x takes
//     bricks 2x + w, 2x + w + 2 gridDim.x, ... Each stages its brick's
//     whole halo (144 pixels x 48 channels, 13,824 bytes) in a ring of two
//     slots, as K-major core matrices [8-channel group][pixel][8 channels]:
//     the next brick's copies (cp.async) run while this one's wgmmas do. A
//     brick is one wgmma M-tile (row m = b*64 + xo*8 + yo); the A operand of
//     tap (kx, ky) and k-step ks is a descriptor into the halo: start at
//     pixel kx*12 + ky and group 2*ks, SBO 192 bytes (next xo), LBO 2304
//     bytes (next 8 channels). A warpgroup waits only on its own barrier
//     (bar.sync 1 + w, 128), so one's epilogue runs beside the other's
//     wgmmas. hz is read once a column tile (twice at N = 128); the two
//     blocks of a brick range walk it together, so the second read finds it
//     in L2.
//   * The band's zeros. At 64 columns (4 output z of 16 channels) one of the
//     three k16 steps (4 halo z each) faces an all-zero block of the band's
//     weight at every tap: output z zo reads halo z zo..zo+4. The block
//     finds such k-steps from the call's own wz, once, after its weight lands
//     (a k-step none of whose 25 16 x 64 blocks holds a value other than +-0
//     is skipped), and runs the brick loop instantiated for its mask of
//     k-steps (run_bricks<KMASK>, 8 instances): each brick's wgmma.m64n64k16
//     sequence is straight-line code, 50 of 75 at the stem, 147.7 of the
//     call's 221.5 GFLOP (a 0.149 ms floor). A branch before each wgmma on a
//     finer (tap, k-step) mask made ptxas inject a warpgroup.arrive before
//     each (C7519): 0.334 ms against this form's 0.268 (the variants script,
//     one call, H100 80GB HBM3, 700 W). Every skipped product is +-0 times a
//     halo value; where the halo holds an Inf or a NaN there the plain
//     version's NaN does not reach the output.
//   * Epilogue: the warpgroup stages its brick's 64 x 64 bf16 results in its
//     own rows of shared memory (144-byte rows: a warp's 8 rows hit distinct
//     banks) and stores them as 16-byte pieces of contiguous rows.
//   * Shared memory: the weight, 2 warpgroups x 2 halo slots (55,296 bytes),
//     2 x 64 staging rows (18,432) and 3 flags: 227,340 bytes.
//
// Why not the row-staged layout: zband_conv_k5_sm90.cu's design at 128
// columns, 6 bricks a block, the weight in two buffers of one row of 5 taps
// beside the 6 halos (205,824 bytes), every k-step multiplied
// (sps_torch/scripts/variants/k5_wide_rowstaged.cu). Timed beside this
// kernel in one call on an H100 80GB HBM3 at 700 W
// (sps_torch/scripts/zband_sm90_variants.py --k5-wide, the stem's shape):
// 0.492 ms against 0.268 on the band's weight, 0.489 against 0.361 on a
// random one (F.conv2d 0.461 / 0.474). It reads the whole weight from L2
// once per 6 bricks and multiplies the band's zero blocks. Neither an L2
// prefetch of the next halos nor stores straight from the accumulators
// helped; two accumulator sets (the next brick's wgmmas beside this one's
// stores) spilled and ptxas serialized the wgmmas (C7518).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

constexpr int KS = 5;             // taps per side
constexpr int BS = 8;             // brick side: 8 x 8 outputs = 64 wgmma rows
constexpr int H = BS + KS - 1;    // halo side
constexpr int HP = H * H;         // halo pixels
constexpr int TAPS = KS * KS;
constexpr int C = 48;             // channels: 12 halo z x 2 time slots x 2 features
constexpr int GROUPS = C / 8;     // 8-channel groups of a halo and a tap
constexpr int KSTEPS = GROUPS / 2;
constexpr int BN = 64;            // columns per block (wgmma N)
constexpr int WGS = 2;            // warpgroups, one brick each at a time
constexpr int NT = 128 * WGS;
constexpr int SLOTS = 2;          // halo slots per warpgroup

constexpr int A_SBO = H * 16;                        // next xo: 8-row group along M
constexpr int A_LBO = HP * 16;                       // next 8-channel group along K
constexpr int HALO_BYTES = GROUPS * A_LBO;           // one brick's halo
constexpr int B_SBO = 8 * 16;                        // next 8-column group along N
constexpr int B_LBO = (BN / 8) * B_SBO;              // next 8-channel group along K
constexpr int W_TAP_BYTES = GROUPS * B_LBO;          // one tap's weight
constexpr int HALO_OFFSET = TAPS * W_TAP_BYTES;      // the weight first
constexpr int SROW = BN * 2 + 16;                    // padded staging row
constexpr int STAGE_OFFSET = HALO_OFFSET + WGS * SLOTS * HALO_BYTES;
constexpr int FLAG_OFFSET = STAGE_OFFSET + WGS * BS * BS * SROW;
constexpr int SMEM_BYTES = FLAG_OFFSET + KSTEPS * 4;
static_assert(SMEM_BYTES <= 232448, "weight, halos and staging must fit the 227 KB of a block");

struct Params {
  const __nv_bfloat16* hz;
  const __nv_bfloat16* wz;
  __nv_bfloat16* out;
  long long B;
  int N;
};

// Stage the block's 64-column tile of all 25 taps: piece e of a tap is
// column group j = e % 8 of channel row c = e / 8 (group c / 8, row c % 8),
// so 8 neighbouring threads read a row's 128 contiguous bytes.
__device__ __forceinline__ void load_weights(const Params& p, uint32_t s, int n0, int tid) {
  constexpr int per_tap = C * (BN / 8);
  for (int i = tid; i < TAPS * per_tap; i += NT) {
    const int tap = i / per_tap, e = i - tap * per_tap;
    const int c = e >> 3, j = e & 7;
    const __nv_bfloat16* src = p.wz + static_cast<long long>(tap * C + c) * p.N + n0 + j * 8;
    cp_async16(s + tap * W_TAP_BYTES + (c >> 3) * B_LBO + j * B_SBO + (c & 7) * 16, src, true);
  }
}

// Stage brick b's halo into a slot: piece i is channel group g = i % 6 of
// pixel i / 6, i.e. the brick's i-th 16 bytes of hz (t: the thread's index
// in its warpgroup).
__device__ __forceinline__ void load_halo(const Params& p, uint32_t s, long long b, int t) {
  const __nv_bfloat16* src = p.hz + b * HP * C;
  for (int i = t; i < HP * GROUPS; i += 128) {
    const int pix = i / GROUPS, g = i - pix * GROUPS;
    cp_async16(s + g * A_LBO + pix * 16, src + i * 8, true);
  }
}

// Queue the brick's wgmmas for the k-steps in KMASK (bit ks) into acc.
template <int KMASK>
__device__ __forceinline__ void issue_brick(float (&acc)[32], uint32_t a0, uint32_t sbase) {
#pragma unroll
  for (int kx = 0; kx < KS; ++kx)
#pragma unroll
    for (int ky = 0; ky < KS; ++ky)
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        if ((KMASK >> ks) & 1)
          wgmma_m64n64k16(acc, make_desc(a0 + ks * 2 * A_LBO + (kx * H + ky) * 16, A_LBO, A_SBO),
                          make_desc(sbase + (kx * KS + ky) * W_TAP_BYTES + ks * 2 * B_LBO,
                                    B_LBO, B_SBO));
}

// Stage the brick's 64 x 64 results (bf16) in the warpgroup's rows and
// store them as 16-byte pieces of contiguous rows. Accumulator layout of
// wgmma m64nN (f32): warp w of the warpgroup holds rows 16w + lane/4 (+8 for
// the odd register pair), columns 8j + 2*(lane%4) and the next one in
// registers 4j .. 4j+3.
__device__ __forceinline__ void store_brick(const Params& p, const float (&acc)[32],
                                            uint8_t* stage, long long b, int n0, int tid) {
  const int wg = tid >> 7, t = tid & 127, warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint8_t* srow = stage + (warp * 16 + (lane >> 2) + 8 * i) * SROW;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(srow + (2 * (lane & 3) + jn * 8) * 2) =
          __floats2bfloat162_rn(acc[4 * jn + 2 * i], acc[4 * jn + 2 * i + 1]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
  for (int e = t; e < BS * BS * (BN / 8); e += 128) {
    const int r = e / (BN / 8), ch = e % (BN / 8);
    *reinterpret_cast<uint4*>(p.out + (b * (BS * BS) + r) * p.N + n0 + ch * 8) =
        *reinterpret_cast<const uint4*>(stage + r * SROW + ch * 16);
  }
}

// A warpgroup's bricks b, b + stride, ...: the next brick's copies, this
// brick's wgmmas (the k-steps in KMASK), their results.
template <int KMASK>
__device__ __forceinline__ void run_bricks(const Params& p, uint8_t* smem, uint32_t sbase,
                                           uint32_t halo0, long long b, long long stride, int n0,
                                           int tid) {
  const int wg = tid >> 7, t = tid & 127;
  uint8_t* stage = smem + STAGE_OFFSET + wg * BS * BS * SROW;
#pragma unroll 1
  for (int it = 0; b < p.B; ++it, b += stride) {
    // The next brick's copies into the other slot (its last reader, the
    // previous brick's wgmmas, completed before store_brick's barrier).
    const long long nb = b + stride;
    if (nb < p.B) load_halo(p, halo0 + ((it + 1) & 1) * HALO_BYTES, nb, t);
    asm volatile("cp.async.commit_group;\n" ::);
    // This brick's halo has landed once at most the newest group is in
    // flight; fenced for wgmma's async proxy, then the warpgroup's barrier.
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    issue_brick<KMASK>(acc, halo0 + (it & 1) * HALO_BYTES, sbase);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    store_brick(p, acc, stage, b, n0, tid);
  }
}

__global__ void __launch_bounds__(NT, 1) zband_k5_wide_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int n0 = blockIdx.y * BN;
  const uint32_t sbase = smem_addr(smem);
  int* flags = reinterpret_cast<int*>(smem + FLAG_OFFSET);
  const uint32_t halo0 = sbase + HALO_OFFSET + wg * SLOTS * HALO_BYTES;
  const long long stride = static_cast<long long>(gridDim.x) * WGS;
  const long long b = static_cast<long long>(blockIdx.x) * WGS + wg;

  // Copy group 0: the weight (every thread); group 1: the warpgroup's first halo.
  if (tid < KSTEPS) flags[tid] = 0;
  load_weights(p, sbase, n0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  if (b < p.B) load_halo(p, halo0, b, t);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // Flag each k-step whose 16 x 64 blocks hold, at some tap, a value other
  // than +-0: 128 pieces of 16 bytes a block.
  for (int i = tid; i < TAPS * KSTEPS * 128; i += NT) {
    const int tap = i / (KSTEPS * 128), rest = i - tap * KSTEPS * 128;
    const int ks = rest >> 7;
    const uint4 v = *reinterpret_cast<const uint4*>(smem + tap * W_TAP_BYTES +
                                                    ks * 2 * B_LBO + (rest & 127) * 16);
    if (((v.x | v.y | v.z | v.w) & 0x7FFF7FFFu) != 0u) flags[ks] = 1;
  }
  __syncthreads();
  const int kmask = (flags[0] != 0 ? 1 : 0) | (flags[1] != 0 ? 2 : 0) | (flags[2] != 0 ? 4 : 0);
  switch (kmask) {
    case 0: run_bricks<0>(p, smem, sbase, halo0, b, stride, n0, tid); break;
    case 1: run_bricks<1>(p, smem, sbase, halo0, b, stride, n0, tid); break;
    case 2: run_bricks<2>(p, smem, sbase, halo0, b, stride, n0, tid); break;
    case 3: run_bricks<3>(p, smem, sbase, halo0, b, stride, n0, tid); break;
    case 4: run_bricks<4>(p, smem, sbase, halo0, b, stride, n0, tid); break;
    case 5: run_bricks<5>(p, smem, sbase, halo0, b, stride, n0, tid); break;
    case 6: run_bricks<6>(p, smem, sbase, halo0, b, stride, n0, tid); break;
    default: run_bricks<7>(p, smem, sbase, halo0, b, stride, n0, tid); break;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace

// The shapes this kernel takes (the "wgmma_k5_wide" route of
// sps_torch/ops/zband_conv.py): bf16 operands, k = 5, bs = 8, C = 48,
// N % 128 == 0, 16-byte aligned. Returns -1 when the call does not qualify,
// else the cudaError_t of the launch.
extern "C" int sps_zband_conv_k5_wide_sm90(const void* hz, const void* wz, void* out,
                                           long long batch, int k, int bs, int channels,
                                           int N, void* stream) {
  if (k != KS || bs != BS || channels != C || N <= 0 || N % 128 != 0) return -1;
  if (!aligned16(hz) || !aligned16(wz) || !aligned16(out)) return -1;
  Params p;
  p.hz = static_cast<const __nv_bfloat16*>(hz);
  p.wz = static_cast<const __nv_bfloat16*>(wz);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = batch;
  p.N = N;
  if (batch == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(zband_k5_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  // One block an SM: the SMs shared among the column tiles, and no more
  // blocks than warpgroups have bricks.
  const int tiles = N / BN;
  long long blocks = sms / tiles > 1 ? sms / tiles : 1;
  const long long needed = (batch + WGS - 1) / WGS;
  if (blocks > needed) blocks = needed;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  zband_k5_wide_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
