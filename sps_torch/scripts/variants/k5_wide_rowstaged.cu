// Layout (a) of the wgmma_k5_wide kernel (sps_torch/csrc/zband_conv_k5_wide_sm90.cu
// is layout (b)), kept to be timed beside it: python3 -m
// sps_torch.scripts.zband_sm90_variants --k5-wide builds and times it with every
// run. zband_conv_k5_sm90.cu's design at C = 32 or 48 with 128 columns a block,
// 6 bricks, the weight staged one row of 5 taps at a time in two buffers (the
// next row's copies run while this row's wgmmas do), every k-step multiplied
// (no band skip): 6 halos of 13,824 bytes and 2 x 5 taps x 6 groups x 2048
// bytes of weight make 205,824 bytes. It reads the whole weight from L2 once
// per 6 bricks (1878 x 307,200 bytes = 0.58 GB a call at the stem).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

constexpr int KS = 5;             // taps per side
constexpr int BS = 8;             // brick side: 8 x 8 outputs = 64 wgmma rows
constexpr int H = BS + KS - 1;    // halo side
constexpr int HP = H * H;         // halo pixels
constexpr int GROUPS = 6;         // 8-channel groups staged per tap: C <= 48
constexpr int A_GROUPS = 6;       // a halo's group slots: three k16 steps
constexpr int BN = 128;           // columns per block (wgmma N)
constexpr int BRICKS = 6;         // bricks per block, 2 per warpgroup
constexpr int NT = 384;           // three warpgroups

constexpr int A_SBO = H * 16;                        // next xo: 8-row group along M
constexpr int A_LBO = HP * 16;                       // next 8-channel group along K
constexpr int HALO_BYTES = A_GROUPS * A_LBO;         // one brick's halo
constexpr int B_SBO = 8 * 16;                        // next 8-column group along N
constexpr int B_LBO = (BN / 8) * B_SBO;              // next 8-channel group along K
constexpr int W_TAP_BYTES = GROUPS * B_LBO;          // one tap's weight
constexpr int W_OFFSET = BRICKS * HALO_BYTES;
constexpr int W_ROW = KS * W_TAP_BYTES;                    // one row of 5 taps
constexpr int SMEM_BYTES = W_OFFSET + 2 * W_ROW;
static_assert(SMEM_BYTES <= 232448, "halos and weights must fit the 227 KB of a block");
static_assert(BRICKS == 2 * (NT / 128), "each warpgroup holds two bricks");

struct Params {
  const __nv_bfloat16* hz;
  const __nv_bfloat16* wz;
  __nv_bfloat16* out;
  long long B;
  int C, N;
};

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
    cp_async16(s + W_OFFSET + (kx & 1) * W_ROW + ky * W_TAP_BYTES + rest * 16, src, true);
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

  load_halos(p, sbase, b0, cg, tid);
  load_weight_row(p, sbase, 0, n0, cg, tid);
  asm volatile("cp.async.commit_group;\n" ::);

  float acc[2][64];
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[bb][i] = 0.0f;

#pragma unroll 1
  for (int kx = 0; kx < KS; ++kx) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kx + 1 < KS) load_weight_row(p, sbase, kx + 1, n0, cg, tid);
    asm volatile("cp.async.commit_group;\n" ::);
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) fence_acc(acc[bb]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
      const uint32_t w_tap = W_OFFSET + (kx & 1) * W_ROW + ky * W_TAP_BYTES;
#pragma unroll
      for (int ks = 0; ks < GROUPS / 2; ++ks) {
        if (2 * ks >= cg) continue;
        const uint64_t db = make_desc(sbase + w_tap + ks * 2 * B_LBO, B_LBO, B_SBO);
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
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) fence_acc(acc[bb]);
  }

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

// The shapes this variant takes: bf16 operands, k = 5, bs = 8, C = 32 or 48,
// N % 128 == 0, 16-byte aligned. Returns -1 when the call
// does not qualify, else the cudaError_t of the launch.
extern "C" int sps_zband_conv_k5_wide_sm90(const void* hz, const void* wz, void* out,
                                           long long batch, int k, int bs, int C, int N,
                                           void* stream) {
  if (k != KS || bs != BS || (C != 32 && C != 48) || N <= 0 || N % BN != 0) return -1;
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
