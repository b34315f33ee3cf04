// z-band stem convolution (k = 5) on Hopper's warpgroup tensor cores
// (sm_90a, wgmma). Plain C entry point sps_zband_conv_k5_sm90 (below);
// zband_conv_op.cpp binds it to PyTorch as route 2 ("wgmma_k5") and
// sps_torch/ops/zband_conv.py routes a call here when its shape qualifies
// (zband_conv.route). Device helpers in sm90_wgmma.cuh, shared with
// zband_conv_sm90.cu (k = 3).
//
// Replaces, at the shapes it takes, the Pallas TPU kernel zband_conv of
// sps_tpu/ops/pallas_conv.py:218 (_zmm_kernel_onepass, :74) at the stem of
// MinkUNet14 in the z-folded layout (conv0p1s1, k = 5, once per scan).
//
// Function, with k = 5, bs = 8, h = 12 (one brick's halo side):
//   out[b, xo, yo, n] = sum_{kx, ky < 5} sum_{c < C} hz[b, xo+kx, yo+ky, c] * wz[kx, ky, c, n]
// summed in f32, stored as bf16, for any wz (the band's zeros are
// multiplied, not assumed). Shapes taken: bf16, C % 8 == 0 with C <= 24,
// N % 128 == 0, any B, 16-byte aligned operands; anything else is refused
// (error -1). The stem's call: hz (11264, 12, 12, 24), wz (5, 5, 24, 128).
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s): the
// stem's 110.7 GFLOP (band zeros counted, C = 24) against 0.263 GB moved,
// so operations, 0.112 ms. Its WMMA predecessor (zband_conv.cu) re-read
// the halo once per tap through 128 x 32 tiles (~2.25 GB through L2), padded
// C = 24 to 32 and ran mma.sync with a barrier per tap.
//
// Design (zband_conv_sm90.cu's, changed where k = 5 differs):
//   * One 8 x 8 brick is one wgmma M-tile: its outputs are the 64 rows of
//     wgmma.m64n128k16 (row m = b*64 + xo*8 + yo, the output layout).
//   * Each brick's whole halo, 144 pixels x C channels, is staged in shared
//     memory once, as K-major core matrices [8-channel group][pixel][8
//     channels] with 4 group slots. The A operand of tap (kx, ky) and k-step
//     ks is a descriptor into it: start at pixel kx*12 + ky and group 2*ks,
//     8-row groups (the next xo) 12*16 = 192 bytes apart (SBO), 8-channel
//     groups 144*16 = 2304 bytes apart (LBO). So hz crosses device memory
//     once, for all 25 taps.
//   * C = 24 is three 8-channel groups: each tap takes two k16 steps,
//     groups 0-1 and then group 2 beside a 4th slot that is zeroed once in
//     shared memory and never copied (hz keeps its layout). The weight rows
//     that face the zero slot are a zeroed pad of one 8-channel group: the
//     second k-step's B descriptor reaches it through its K offset (LBO).
//     So every product is finite x 0 = 0. Slots beyond C (C = 8 or 16) are
//     zeroed the same way. This executes 32/24 of the band's FLOPs, as the
//     WMMA kernel did, at wgmma's rate.
//   * The weight wz[kx, ky, c, n0:n0+128] is N-contiguous, so 16-byte copies
//     land as MN-major core matrices [8-channel group][8-column group][8][8]
//     (transpose-B). All 25 taps stay resident: 25 x 3 groups x 2048 bytes
//     = 153,600 bytes, beside the 6 halos' 55,296 and the 2,048-byte pad,
//     210,944 bytes in all (one block per SM). The copies are committed in
//     five groups, the halos with the kx = 0 row of taps and then one row
//     each, and the block multiplies each row as it lands: one barrier per
//     row, 5 taps x 2 k-steps x 2 bricks = 20 wgmmas per warpgroup per
//     barrier, the previous row's wgmmas still in flight.
//   * Block: three warpgroups (384 threads), each with 2 bricks' 64 x 128
//     f32 accumulators in registers (128 per thread; 168 registers a
//     thread at most). N is walked in 128-wide tiles over gridDim.y. The
//     weight is read from L2 once per block: 1878 blocks x 153,600 bytes
//     = 0.29 GB per stem call. The copies, not the tensor cores, bound
//     the kernel (the weight's most of all), so 6 bricks share each copy
//     of the weight rather than 4 (0.38 -> 0.32 ms at the stem's shape
//     on an H100, sps_torch/scripts/zband_sm90_variants.py --k5).
//   * Epilogue (zband_conv_sm90.cu's unfused one): the bf16 results are
//     staged in the freed shared memory in row order and stored as 16-byte
//     pieces of contiguous rows.
//   * Ragged B: a missing brick's halo is zero-filled and its rows are not
//     stored.

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
constexpr int GROUPS = 3;         // 8-channel groups staged per tap: C <= 24
constexpr int A_GROUPS = 4;       // a halo's group slots: two k16 steps
constexpr int BN = 128;           // columns per block (wgmma N)
constexpr int BRICKS = 6;         // bricks per block, 2 per warpgroup
constexpr int NT = 384;           // three warpgroups
constexpr int C_MAX = GROUPS * 8;

constexpr int A_SBO = H * 16;                        // next xo: 8-row group along M
constexpr int A_LBO = HP * 16;                       // next 8-channel group along K
constexpr int HALO_BYTES = A_GROUPS * A_LBO;         // one brick's halo
constexpr int B_SBO = 8 * 16;                        // next 8-column group along N
constexpr int B_LBO = (BN / 8) * B_SBO;              // next 8-channel group along K
constexpr int W_TAP_BYTES = GROUPS * B_LBO;          // one tap's weight
constexpr int W_OFFSET = BRICKS * HALO_BYTES;
constexpr int PAD_OFFSET = W_OFFSET + TAPS * W_TAP_BYTES;  // the zero group facing slot 3
constexpr int SMEM_BYTES = PAD_OFFSET + B_LBO;
static_assert(SMEM_BYTES <= 232448, "halos and weights must fit the 227 KB of a block");
static_assert(2 * A_GROUPS == 8 && A_GROUPS == GROUPS + 1, "two k16 steps cover the groups");
static_assert(BRICKS == 2 * (NT / 128), "each warpgroup holds two bricks");

struct Params {
  const __nv_bfloat16* hz;
  const __nv_bfloat16* wz;
  __nv_bfloat16* out;
  long long B;
  int C, N;
};

// Zero what no copy writes: each halo's group slots cg..3, each tap's weight
// groups cg..2 (none at C = 24) and the pad, with 16-byte stores.
__device__ __forceinline__ void zero_slots(uint8_t* smem, int cg, int tid) {
  const uint4 z = make_uint4(0, 0, 0, 0);
  const int a_pieces = (A_GROUPS - cg) * (A_LBO / 16);
  for (int i = tid; i < BRICKS * a_pieces; i += NT) {
    const int brick = i / a_pieces, rest = i - brick * a_pieces;
    *reinterpret_cast<uint4*>(smem + brick * HALO_BYTES + cg * A_LBO + rest * 16) = z;
  }
  const int w_pieces = (GROUPS - cg) * (B_LBO / 16);
  for (int i = tid; i < TAPS * w_pieces; i += NT) {
    const int tap = i / w_pieces, rest = i - tap * w_pieces;
    *reinterpret_cast<uint4*>(smem + W_OFFSET + tap * W_TAP_BYTES + cg * B_LBO + rest * 16) = z;
  }
  for (int i = tid; i < B_LBO / 16; i += NT)
    *reinterpret_cast<uint4*>(smem + PAD_OFFSET + i * 16) = z;
}

// Stage the block's 6 halos: 16-byte piece i of a brick is channel group
// g = i % cg of pixel i / cg, i.e. the brick's i-th 16 bytes of hz, so
// neighbouring threads read contiguous bytes.
__device__ __forceinline__ void load_halos(const Params& p, uint32_t s, long long b0, int cg,
                                           int tid) {
  const int per_brick = HP * cg;
  for (int i = tid; i < BRICKS * per_brick; i += NT) {
    const int brick = i / per_brick, rest = i - brick * per_brick;
    const int pix = rest / cg, g = rest - pix * cg;
    const long long b = b0 + brick;
    const bool ok = b < p.B;
    const __nv_bfloat16* src = ok ? p.hz + b * HP * p.C + rest * 8 : p.hz;
    cp_async16(s + brick * HALO_BYTES + g * A_LBO + pix * 16, src, ok);
  }
}

// Stage row kx of taps (kx, 0..4), columns n0 .. n0+127: piece e of a tap
// is row r = e % 8 (channel within the group) of column group j = e / 8 % 16
// of channel group kg = e / 128, so a tap's pieces are contiguous in the
// order of the [kg][j][r] core-matrix layout.
__device__ __forceinline__ void load_weight_row(const Params& p, uint32_t s, int kx, int n0,
                                                int cg, int tid) {
  const int per_tap = cg * BN;
  for (int e = tid; e < KS * per_tap; e += NT) {
    const int ky = e / per_tap, rest = e - ky * per_tap;
    const int kg = rest >> 7, j = (rest >> 3) & 15, r = rest & 7;
    const int tap = kx * KS + ky;
    const __nv_bfloat16* src =
        p.wz + static_cast<long long>(tap * p.C + kg * 8 + r) * p.N + n0 + j * 8;
    cp_async16(s + W_OFFSET + tap * W_TAP_BYTES + rest * 16, src, true);
  }
}

// Wait until at most n of this thread's copy groups are in flight (n < 5).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

__global__ void __launch_bounds__(NT, 1) zband_k5_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroup: bricks 2*wg and 2*wg + 1 of the block
  const long long b0 = static_cast<long long>(blockIdx.x) * BRICKS;
  const int n0 = blockIdx.y * BN;
  const uint32_t sbase = smem_addr(smem);
  const int cg = p.C / 8;

  // Copy group kx: the halos (with kx = 0) and row kx of weight taps.
  for (int kx = 0; kx < KS; ++kx) {
    if (kx == 0) load_halos(p, sbase, b0, cg, tid);
    load_weight_row(p, sbase, kx, n0, cg, tid);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  zero_slots(smem, cg, tid);

  float acc[2][64];
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[bb][i] = 0.0f;

#pragma unroll 1
  for (int kx = 0; kx < KS; ++kx) {
    // Row kx has landed once at most the KS-1-kx newer copy groups are in
    // flight. After each thread has seen its own copies land and made them
    // (and its zero stores) visible to wgmma's async proxy, the barrier
    // says that every thread's have.
    cp_async_wait(KS - 1 - kx);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) fence_acc(acc[bb]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
      const int tap = kx * KS + ky;
      const uint32_t w_tap = W_OFFSET + tap * W_TAP_BYTES;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        // k-step 1's second group is slot 3: its weight rows are the pad.
        const uint32_t lbo = ks == 0 ? B_LBO : PAD_OFFSET - (w_tap + 2 * B_LBO);
        const uint64_t db = make_desc(sbase + w_tap + ks * 2 * B_LBO, lbo, B_SBO);
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const uint64_t da = make_desc(
              sbase + (2 * wg + bb) * HALO_BYTES + ks * 2 * A_LBO + (kx * H + ky) * 16, A_LBO,
              A_SBO);
          wgmma_m64n128k16(acc[bb], da, db);
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // Row kx-1 done; row kx stays queued on the tensor cores across the
    // next barrier.
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) fence_acc(acc[bb]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int bb = 0; bb < 2; ++bb) fence_acc(acc[bb]);

  // Accumulator layout of wgmma m64nN (f32): warp w of the warpgroup holds
  // rows 16w + lane/4 (+8 for the odd register pair), columns 8j + 2*(lane%4)
  // and the next one in registers 4j .. 4j+3. Each warpgroup stages its two
  // bricks' bf16 results in the freed shared memory, row by row, then
  // stores them as 16-byte pieces of contiguous rows.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  constexpr int SROW = BN * 2 + 16;  // padded staging row: 8 rows of a warp hit distinct banks
  static_assert(BRICKS * BS * BS * SROW <= SMEM_BYTES, "the staging rows fit the freed buffer");
  __syncthreads();  // both warpgroups' last wgmmas have read the buffer
  uint8_t* stage = smem + wg * (2 * BS * BS) * SROW;
#pragma unroll
  for (int bb = 0; bb < 2; ++bb) {
    if (b0 + 2 * wg + bb >= p.B) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint8_t* srow = stage + (bb * 64 + warp * 16 + (lane >> 2) + 8 * i) * SROW;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(srow + (2 * (lane & 3) + jn * 8) * 2) =
            __floats2bfloat162_rn(acc[bb][4 * jn + 2 * i], acc[bb][4 * jn + 2 * i + 1]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's rows
  const int t = tid & 127;
#pragma unroll 4
  for (int e = t; e < 2 * BS * BS * (BN / 8); e += 128) {
    const int r = e / (BN / 8), ch = e % (BN / 8);
    const long long b = b0 + 2 * wg + r / (BS * BS);
    if (b < p.B) {
      const long long m = b0 * (BS * BS) + wg * 2 * BS * BS + r;
      *reinterpret_cast<uint4*>(p.out + m * p.N + n0 + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * SROW + ch * 16);
    }
  }
}

}  // namespace

// The shapes this kernel takes (the "wgmma_k5" route of
// sps_torch/ops/zband_conv.py): bf16 operands, k = 5, bs = 8, C % 8 == 0
// with 0 < C <= 24, N % 128 == 0, 16-byte aligned. Returns -1 when the call
// does not qualify, else the cudaError_t of the launch.
extern "C" int sps_zband_conv_k5_sm90(const void* hz, const void* wz, void* out, long long batch,
                                      int k, int bs, int C, int N, void* stream) {
  if (k != KS || bs != BS || C <= 0 || C % 8 != 0 || C > C_MAX || N <= 0 || N % BN != 0)
    return -1;
  if (!aligned16(hz) || !aligned16(wz) || !aligned16(out)) return -1;
  Params p;
  p.hz = static_cast<const __nv_bfloat16*>(hz);
  p.wz = static_cast<const __nv_bfloat16*>(wz);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = batch;
  p.C = C;
  p.N = N;
  if (batch == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      zband_k5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((batch + BRICKS - 1) / BRICKS),
                  static_cast<unsigned>(N / BN));
  zband_k5_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
