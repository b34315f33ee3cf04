// z-band brick convolution on Hopper's warpgroup tensor cores (sm_90a,
// wgmma). Plain C entry point sps_zband_conv_sm90 (below); zband_conv_op.cpp
// binds it to PyTorch and sps_torch/ops/zband_conv.py routes a k = 3 call
// here when its shape qualifies (zband_conv.route); the k = 5 stem goes to
// zband_conv_k5_sm90.cu, every other call to zband_conv.cu. The device
// helpers (copies, descriptors, wgmma) are in sm90_wgmma.cuh.
//
// Replaces, at the shapes it takes, the Pallas TPU kernels of
// sps_tpu/ops/pallas_conv.py:
//   * zband_conv_fused  (_fused_kernel_onepass, :282) - both block8 convs of L0;
//   * zband_conv        (_zmm_kernel_onepass, :74) at k = 3 - the probe of
//     scripts/microbench_pallas.py (K3).
//
// Function, with k = 3, bs = 8, h = 10 (one brick's halo side):
//   acc[b, xo, yo, n] = sum_{kx, ky < 3} sum_{c < C} hz[b, xo+kx, yo+ky, c] * wz[kx, ky, c, n]
// in f32; the plain kernel stores acc cast to bf16, the fused one applies
//   out = occ * [relu](acc * scale + bias [+ res])
// in f32 before the one cast. Shapes taken: bf16, C % 32 == 0, N % 128 == 0,
// any B, 16-byte aligned operands; anything else is refused (error -1).
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s), at the
// main path's L0 shapes (B = 11264): block8_0.conv1 (C = 320) by operations,
// 0.537 ms; block8_0.conv2 (C = 160, with residual) by bytes and operations
// alike, 0.273 / 0.269 ms. So the tensor cores must run near their rate and
// each byte of hz, occ and res must cross device memory once.
//
// Design:
//   * One brick is one wgmma M-tile: its 8 x 8 outputs are the 64 rows of
//     wgmma.m64n128k16 (row m = b*64 + xo*8 + yo, the output layout).
//   * Each brick's halo chunk, 100 pixels x 16 channels, is staged in shared
//     memory once, as K-major core matrices [8-channel group][pixel][8
//     channels] (16 bytes per pixel and group). The A operand of tap (kx, ky)
//     is then a descriptor into that buffer with no re-staging: start at pixel
//     kx*h + ky, 8-row groups (the next xo) h*16 = 160 bytes apart (SBO),
//     8-channel groups h*h*16 = 1600 bytes apart (LBO), because the 8 rows of
//     a core matrix are 8 consecutive yo, i.e. 8 consecutive halo pixels. So
//     hz is read from device memory once, as by the TPU's one-pass kernel,
//     not k*k times through an im2col tile.
//   * The weight wz[kx, ky, c, n0:n0+128] is N-contiguous, so 16-byte copies
//     land as MN-major core matrices [8-channel group][8-column group][8][8];
//     the descriptor sets wgmma's transpose-B bit. All 9 taps of a chunk are
//     staged together and shared by the block's 4 bricks.
//   * Block: two warpgroups (256 threads), each with 2 bricks' 64 x 128 f32
//     accumulators in registers (128 per thread): 256 rows x 128 columns.
//     N is walked in 128-wide tiles over gridDim.y.
//   * A ring of 4 stages of 49,664 bytes (4 halo chunks of 3,200 + 9 weight
//     tiles of 4,096) for 16-channel chunks: chunk q+2 is copied (16-byte
//     cp.async) into the stage chunk q-2 used while the wgmmas of chunks q-1
//     and q run (wait_group 1), so the tensor cores have a chunk queued
//     across each barrier. 16-channel chunks at 4 stages rather than
//     32-channel ones at 2 (the same 199 KB) because the ring must hold
//     two chunks in flight beside the two being multiplied; each barrier
//     then covers 9 taps x 2 bricks = 18 wgmmas per warpgroup.
//   * The epilogue applies occ * [relu](acc * scale + bias [+ res]) in f32
//     from the accumulator registers (occ and res, prefetched to L2 during
//     the last chunk, are loaded for a row's 16 column pairs before its
//     first result), stages the bf16 results in the freed ring in row order,
//     and stores them as 16-byte pieces of contiguous rows.
//   * Ragged B: a missing brick's halo is zero-filled and its rows are not
//     stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90_wgmma.cuh"

namespace {

constexpr int KS = 3;             // taps per side
constexpr int BS = 8;             // brick side: 8 x 8 outputs = 64 wgmma rows
constexpr int H = BS + KS - 1;    // halo side
constexpr int HP = H * H;         // halo pixels
constexpr int TAPS = KS * KS;
constexpr int CK = 16;            // channels per stage: one k16 step
constexpr int BN = 128;           // columns per block (wgmma N)
constexpr int BRICKS = 4;         // bricks per block, 2 per warpgroup
constexpr int NT = 256;           // two warpgroups
constexpr int STAGES = 4;         // chunk q+2 loads while q and q-1 multiply
constexpr int C_MULTIPLE = 32;    // channels: the route's rule (zband_conv.route)

constexpr int A_SBO = H * 16;                      // next xo: 8-row group along M
constexpr int A_LBO = HP * 16;                     // next 8-channel group along K
constexpr int HALO_BYTES = (CK / 8) * A_LBO;       // one brick's halo chunk
constexpr int B_SBO = 8 * 16;                      // next 8-column group along N
constexpr int B_LBO = (BN / 8) * B_SBO;            // next 8-channel group along K
constexpr int W_TAP_BYTES = CK * BN * 2;           // one tap's weight chunk
constexpr int W_OFFSET = BRICKS * HALO_BYTES;
constexpr int STAGE_BYTES = W_OFFSET + TAPS * W_TAP_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
static_assert(SMEM_BYTES <= 232448, "the stages must fit the 227 KB of a block");
constexpr int W_SWEEPS = CK * BN / 8 / NT;         // 16-byte copies per thread and tap
static_assert(W_SWEEPS * NT * 8 == CK * BN, "a weight tap is whole sweeps of the block");
static_assert(STAGES >= 3, "the loop keeps two chunks of wgmma in flight");

struct Params {
  const __nv_bfloat16* hz;
  const __nv_bfloat16* wz;
  const float* scale;
  const float* bias;
  const __nv_bfloat16* occ;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;
  long long B;
  int C, N;
  int relu;
};

// Stage chunk q (channels q*CK ..) of the block's 4 halos and of the 9
// weight taps into stage buffer s.
__device__ __forceinline__ void load_chunk(const Params& p, uint32_t s, long long b0, int n0,
                                           int q, int tid) {
  const int c0 = q * CK;
  // Halo: 16-byte piece i is channel group g = i % (CK/8) of pixel i / (CK/8),
  // so neighbouring threads read one pixel's CK contiguous channels.
  for (int i = tid; i < BRICKS * (CK / 8) * HP; i += NT) {
    const int g = i % (CK / 8);
    const int rest = i / (CK / 8);
    const int brick = rest / HP, pix = rest - brick * HP;
    const long long b = b0 + brick;
    const bool ok = b < p.B;
    const __nv_bfloat16* src = ok ? p.hz + (b * HP + pix) * p.C + c0 + g * 8 : p.hz;
    cp_async16(s + brick * HALO_BYTES + g * A_LBO + pix * 16, src, ok);
  }
  // Weight: thread tid is row r (channel within the group) of column group j
  // of channel group kg (+2 on each further sweep); a tap's pieces are then
  // contiguous in the order of the [kg][j][r] core-matrix layout.
  const int r = tid & 7, j = (tid >> 3) & 15, kg = tid >> 7;
  const uint32_t sw = s + W_OFFSET + tid * 16;
#pragma unroll
  for (int it = 0; it < W_SWEEPS * TAPS; ++it) {
    const int tap = it / W_SWEEPS, sweep = it % W_SWEEPS, kgi = kg + 2 * sweep;
    const __nv_bfloat16* src =
        p.wz + static_cast<long long>(tap * p.C + c0 + kgi * 8 + r) * p.N + n0 + j * 8;
    cp_async16(sw + tap * W_TAP_BYTES + sweep * NT * 16, src, true);
  }
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  __nv_bfloat162 h;
  memcpy(&h, &v, 4);
  return __bfloat1622float2(h);
}

// The epilogue of this thread's share of output row m: the column pairs
// c2 + 8*jn (jn < 16), whose f32 sums are v[4*jn], v[4*jn + 1]. The bf16
// results go to the staging row srow at columns cl + 8*jn. occ and res are
// loaded for all 16 pairs before the first result, so their latencies
// overlap.
template <bool FUSED>
__device__ __forceinline__ void store_row(const Params& p, long long m, int c2, const float* v,
                                          uint8_t* srow, int cl) {
  const long long o = m * p.N + c2;
  uint32_t oc[BN / 8], rs[BN / 8];
  if (FUSED) {
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      oc[jn] = __ldg(reinterpret_cast<const unsigned*>(p.occ + o + jn * 8));
      rs[jn] = p.res != nullptr ? __ldg(reinterpret_cast<const unsigned*>(p.res + o + jn * 8)) : 0u;
    }
  }
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    float v0 = v[4 * jn], v1 = v[4 * jn + 1];
    if (FUSED) {
      const int col = c2 + jn * 8;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(p.scale + col));
      const float2 bi = __ldg(reinterpret_cast<const float2*>(p.bias + col));
      v0 = __fadd_rn(__fmul_rn(v0, sc.x), bi.x);
      v1 = __fadd_rn(__fmul_rn(v1, sc.y), bi.y);
      if (p.res != nullptr) {
        const float2 r2 = bf2_to_f2(rs[jn]);
        v0 = __fadd_rn(v0, r2.x);
        v1 = __fadd_rn(v1, r2.y);
      }
      if (p.relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      const float2 o2 = bf2_to_f2(oc[jn]);
      v0 = __fmul_rn(v0, o2.x);
      v1 = __fmul_rn(v1, o2.y);
    }
    *reinterpret_cast<__nv_bfloat162*>(srow + (cl + jn * 8) * 2) = __floats2bfloat162_rn(v0, v1);
  }
}

template <bool FUSED>
__global__ void __launch_bounds__(NT, 1) zband_sm90_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroup: bricks 2*wg and 2*wg + 1 of the block
  const long long b0 = static_cast<long long>(blockIdx.x) * BRICKS;
  const int n0 = blockIdx.y * BN;
  const uint32_t sbase = smem_addr(smem);
  const int nq = p.C / CK;

  float acc[2][64];
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[bb][i] = 0.0f;

  for (int q = 0; q < STAGES - 2; ++q) {
    if (q < nq) load_chunk(p, sbase + q * STAGE_BYTES, b0, n0, q, tid);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int q = 0; q < nq; ++q) {
    const uint32_t s = sbase + (q % STAGES) * STAGE_BYTES;
    // Chunk q has landed once at most the STAGES-3 newer copy groups are in
    // flight. After each thread has seen its own copies land (and made them
    // visible to wgmma's async proxy), the barrier also says that both
    // warpgroups finished chunk q-2: each waited for it before the barrier.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 3) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) fence_acc(acc[bb]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int kx = tap / KS, ky = tap % KS;
#pragma unroll
      for (int ks = 0; ks < CK / 16; ++ks) {
        const uint64_t db =
            make_desc(s + W_OFFSET + tap * W_TAP_BYTES + ks * 2 * B_LBO, B_LBO, B_SBO);
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const uint64_t da = make_desc(
              s + (2 * wg + bb) * HALO_BYTES + ks * 2 * A_LBO + (kx * H + ky) * 16, A_LBO, A_SBO);
          wgmma_m64n128k16(acc[bb], da, db);
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // The stage of chunk q-2 is free: load chunk q+STAGES-2 into it while
    // chunks q-1 and q multiply. On the last chunk, bring this thread's
    // output row of occ and res into L2 for the epilogue instead.
    const int qn = q + STAGES - 2;
    if (qn < nq) load_chunk(p, sbase + (qn % STAGES) * STAGE_BYTES, b0, n0, qn, tid);
    asm volatile("cp.async.commit_group;\n" ::);
    if (FUSED && q == nq - 1) {
      const long long m = b0 * (BS * BS) + tid;
      if (m < p.B * (BS * BS)) {
        const __nv_bfloat16* rows[2] = {p.occ, p.res};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (rows[t] == nullptr) continue;
          const __nv_bfloat16* row = rows[t] + m * p.N + n0;
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row));
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + 64));
        }
      }
    }
    // Chunk q-1 done, so both warpgroups pass the next barrier with it done.
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
  // bricks' bf16 results in the freed ring, row by row, then stores them as
  // 16-byte pieces of contiguous rows.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  constexpr int SROW = BN * 2 + 16;  // padded staging row: 8 rows of a warp hit distinct banks
  __syncthreads();  // both warpgroups' last wgmmas have read the stages
  uint8_t* stage = smem + wg * (2 * BS * BS) * SROW;
#pragma unroll
  for (int bb = 0; bb < 2; ++bb) {
    if (b0 + 2 * wg + bb >= p.B) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = bb * 64 + warp * 16 + (lane >> 2) + 8 * i;
      store_row<FUSED>(p, (b0 + 2 * wg + bb) * (BS * BS) + warp * 16 + (lane >> 2) + 8 * i,
                       n0 + 2 * (lane & 3), acc[bb] + 2 * i, stage + r * SROW, 2 * (lane & 3));
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

template <bool FUSED>
int launch(const Params& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      zband_sm90_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((p.B + BRICKS - 1) / BRICKS),
                  static_cast<unsigned>(p.N / BN));
  zband_sm90_kernel<FUSED><<<grid, NT, SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The shapes this kernel takes (the route of sps_torch/ops/zband_conv.py):
// bf16 operands, k = 3, bs = 8, C % 32 == 0, N % 128 == 0, 16-byte aligned.
// Returns -1 when the call does not qualify, else the cudaError_t of the
// launch. scale/bias (f32) and occ/res are read only when fused; res may be
// null.
extern "C" int sps_zband_conv_sm90(int fused, const void* hz, const void* wz, const float* scale,
                                   const float* bias, const void* occ, const void* res, void* out,
                                   long long batch, int k, int bs, int C, int N, int relu,
                                   void* stream) {
  if (k != KS || bs != BS || C <= 0 || C % C_MULTIPLE != 0 || N <= 0 || N % BN != 0) return -1;
  if (!aligned16(hz) || !aligned16(wz) || !aligned16(out)) return -1;
  if (fused && (!aligned16(scale) || !aligned16(bias) || !aligned16(occ) ||
                (res != nullptr && !aligned16(res))))
    return -1;
  Params p;
  p.hz = static_cast<const __nv_bfloat16*>(hz);
  p.wz = static_cast<const __nv_bfloat16*>(wz);
  p.scale = scale;
  p.bias = bias;
  p.occ = static_cast<const __nv_bfloat16*>(occ);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = batch;
  p.C = C;
  p.N = N;
  p.relu = relu;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fused ? launch<true>(p, s) : launch<false>(p, s);
}
