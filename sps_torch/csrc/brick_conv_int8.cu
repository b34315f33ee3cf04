// Int8 brick convolution for Hopper (sm_90a). The kernel has two forms,
// each with a plain C entry point (below): the gather form
// (sps_brick_conv_int8_gather), which the shipping path runs, and the halo
// form (sps_brick_conv_int8), which takes an assembled halo tensor.
// zband_conv_op.cpp binds them to PyTorch as
// torch.ops.sps_torch.brick_conv_int8_gather and brick_conv_int8, and
// sps_torch/ops/brick_conv_int8.py builds and calls them.
//
// Replaces the int8 conv of sps_tpu/ops/brick.py::brick_conv_int8 (an XLA
// int8 conv with int32 accumulation, lax.conv_general_dilated(...,
// preferred_element_type=int32)); it has no Pallas source. The
// quantization around it stays in PyTorch (sps_torch/ops/brick.py).
//
// Function: the VALID 3x3x3 conv of the int8 halo h8 (B, 10, 10, 10, C) by
// the int8 weight w8 (3, 3, 3, C, N), summed in int32, then dequantized:
//   acc[b, x, y, z, n] = sum_{kx, ky, kz < 3} sum_{c < C}
//                        h8[b, x+kx, y+ky, z+kz, c] * w8[kx, ky, kz, c, n]
//   out[b, x, y, z, n] = (float(acc) * scale[n])  as bf16 (round to nearest
//                        even) or f32,
// with scale = s_in * s_w the f32 product the caller formed. The gather
// form computes the same from the codes q8 (Bq, 8, 8, 8, C) and the
// neighbour table nbr27 (27, B) (OFFS27 order, x slowest, -1 where
// absent): h8[b] is brick b's halo, the 26 neighbours' border voxels
// around the centre brick, zeros where a row is absent; and a slot whose
// centre row is absent (the atlas's slots past num_bricks, all of whose
// rows are -1) gives +0.0. Every step is
// exact or one IEEE rounding (int32 -> f32, one multiply, one cast), so the
// output is bit-equal to the plain version (brick_conv_int8_ref).
// The kernel takes the weight transposed, wt (3, 3, 3, N, C): each output
// column's C channels of a tap are contiguous, the B operand's layout.
//
// The math, both forms: an implicit GEMM per brick on the tensor cores,
// mma.sync with s8 operands and s32 accumulators, 256 threads a block: M =
// the brick's 512 output voxels, N the columns, K = 27 taps x C channels.
// The brick's halo (1000 voxels) sits in shared memory, each voxel's C
// bytes at a row stride S = C or C + 16 (S / 16 odd), so that the 8 rows
// of an ldmatrix land in 8 different bank groups; the weight's columns sit
// at the same stride. Warp w computes output plane x = w: four m16 tiles
// (y = 2i, 2i+1; z = 0..7). A tap's A rows are addressed per lane by
// ldmatrix (no im2col): the row of output voxel (x, y, z) for tap
// (kx, ky, kz) is halo voxel (x+kx, y+ky, z+kz). Columns go 32 a pass (16
// when N = 16), channels in k32 steps (m16n8k32) and, when C % 32 == 16,
// one k16 step (m16n8k16). The epilogue dequantizes from the int32
// registers and stores column pairs.
//
// The gather form's schedule (brick_int8_gather_kernel, C a template
// argument): persistent blocks, as many as fit on the card (occupancy x
// SMs), each walking the bricks b = blockIdx.x, + gridDim.x, ... For each
// pass, a block copies all 27 taps of the pass's columns into shared
// memory once, so its tap loop waits on nothing and has no barrier. Each
// brick's halo is gathered with 16-byte cp.async copies straight from the
// codes of the neighbour that nbr27 names (an absent neighbour's pieces
// zero-filled by the copy itself). gather_plan (below; mirrored in
// sps_torch/ops/brick_conv_int8.py) picks the halo buffers: with two (C =
// 16, and 64 -> 64 on the path), the copy of brick i+1 is issued right
// after the barrier that opens brick i and lands while brick i is
// multiplied, one barrier a brick; with one (C = 32, 48, where two would
// leave room for one block an SM and one leaves room for two or three; C
// = 96, where two do not fit), the next brick's copy follows the brick's
// math behind a second barrier while the SM's other blocks compute. The
// 27 rows of the brick after next are loaded a brick ahead. A slot whose
// centre row is absent stores +0.0 in the first pass and copies nothing.
// The tap loop unrolls as far as its fragments fit the registers
// (FRAGMENT_REGS), so that loads and products of neighbouring taps
// interleave.
//
// The halo form (brick_int8_kernel, the first schedule, off the path): one
// block a brick, its halo copied from the halo tensor, the weight streamed
// by tap through a two-slot ring (two barriers a tap), a second pass over
// the resident halo for N = 64.
//
// What bounds it on this card: at the path's shapes the int8 input read (the
// codes once in the gather form, the 1.95x larger halo tensor in the halo
// form) and the output write (bytes over 3.35 TB/s), except at block6_0 (C =
// 96 and 64 -> 64), where the int8 operations over 1979 TOP/s bound it.
// Diagnostic copies (sps_torch/scripts/int8_variants.py) showed the gather
// form's earlier schedule (the halo form's, one block a brick, commit c6325b3)
// spending about half its time in per-tap weight waits and barriers and the
// other half in the math, in series; the schedule above removes the waits.
// What is left is about two thirds the copy and store skeleton (the halo
// gathers' latency, the 4-byte output stores) and one third the mma.sync math,
// which reads every A fragment from shared memory once a tap; wgmma is not
// used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 8;           // brick side
constexpr int H = BS + 2;       // halo side
constexpr int HALO_VOXELS = H * H * H;
constexpr int TAPS = 27;
constexpr int THREADS = 256;    // 8 warps; warp w computes output plane x = w
constexpr int MT = 4;           // m16 tiles per warp
constexpr int C_MAX = 128;      // channels it takes: C % 16 == 0, 16 <= C <= C_MAX
constexpr int PASS_COLS = 32;   // columns a pass (N % 32 == 0); N = 16 runs one pass of 16
constexpr int SMEM_MAX = 1000 * (C_MAX + 16) + 2 * PASS_COLS * (C_MAX + 16);
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on Hopper
static_assert(SMEM_MAX <= 232448, "SMEM_BYTES <= 232448");
// The gather form's static shared memory: two slots of 27 staged rows.
constexpr int ROWS_BYTES = 2 * TAPS * 4;

// Bytes between neighbouring voxels (and weight columns) in shared memory:
// an odd number of 16-byte units.
__host__ __device__ constexpr int row_stride(int c) { return (c / 16) % 2 == 1 ? c : c + 16; }

// Blocks of `smem` dynamic bytes that an SM's 228 KB hold (1 KB of it
// reserved per block).
constexpr int SM_SMEM = 233472;
__host__ __device__ constexpr int blocks_fit(int smem) {
  return SM_SMEM / (smem + ROWS_BYTES + 1024);
}

// The gather form's shared memory: `bufs` halo buffers, then the 27 taps
// of one pass's columns. A pass is 32 columns (16 when N = 16, or when 32
// do not fit beside one buffer: C = 128). Two buffers (the next brick's
// copy overlaps this brick's math inside the block) where two such blocks
// fit on an SM, or where one buffer would fit no more blocks; else one
// buffer, and the blocks of an SM overlap each other's copies.
struct GatherPlan {
  int stride, halo_bytes, pass_cols, weight_bytes, bufs, smem_bytes;
};
__host__ __device__ constexpr GatherPlan gather_plan(int c, int n) {
  const int s = row_stride(c);
  const int halo = HALO_VOXELS * s;
  const int cols =
      n == 16 || halo + TAPS * PASS_COLS * s + ROWS_BYTES > SMEM_LIMIT ? 16 : PASS_COLS;
  const int weight = TAPS * cols * s;
  const int one = halo + weight, two = 2 * halo + weight;
  const int bufs = two + ROWS_BYTES <= SMEM_LIMIT &&
                           (blocks_fit(two) >= 2 || blocks_fit(two) >= blocks_fit(one))
                       ? 2
                       : 1;
  return {s, halo, cols, weight, bufs, bufs * halo + weight};
}
static_assert(gather_plan(C_MAX, 64).smem_bytes + ROWS_BYTES <= SMEM_LIMIT,
              "GATHER_SMEM_BYTES <= 232448");

// The gather form unrolls its tap loop as far as the A and B fragments of
// the unrolled k steps fit in FRAGMENT_REGS registers (with the 64
// accumulators and the loop's state, within 128 and no spill): a tap's
// fragments take tap_fragment_regs (4 MT + 2 NT a k32 step, 2 MT + NT the
// k16 step). The three taps of a kz row are unrolled together where they
// fit (C <= 32), a tap's k steps where one tap fits (C <= 96 at NT = 4).
constexpr int FRAGMENT_REGS = 72;
__host__ __device__ constexpr int tap_fragment_regs(int c, int nt) {
  return c / 32 * (4 * MT + 2 * nt) + (c % 32 != 0 ? 2 * MT + nt : 0);
}
__host__ __device__ constexpr int gather_kz_unroll(int c, int nt) {
  return 3 * tap_fragment_regs(c, nt) <= FRAGMENT_REGS ? 3 : 1;
}
__host__ __device__ constexpr int gather_k_unroll(int c, int nt) {
  return tap_fragment_regs(c, nt) <= FRAGMENT_REGS && c >= 64 ? c / 32 : 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g));
}
// The same copy, zero-filling the 16 bytes instead when `pred` is false
// (src-size 0: nothing is read from g, which must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(uint32_t s, const void* g, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait(bool last) {
  if (last)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, uint32_t s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s));
}

__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void store2(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
}

// Stage columns n0 .. n0 + 8*NT - 1 of tap `tap` into slot `w_s`: piece i
// is 16-byte group q = i % (C/16) of column r = i / (C/16), the tap's
// contiguous bytes in order.
template <int NT>
__device__ __forceinline__ void load_weight(const int8_t* wt, uint32_t w_s, int tap, int n0,
                                            int C, int N, int S, int tid) {
  const int cg = C / 16;
  for (int i = tid; i < NT * 8 * cg; i += THREADS) {
    const int r = i / cg, q = i - r * cg;
    cp_async16(w_s + r * S + q * 16, wt + (static_cast<long long>(tap) * N + n0 + r) * C + q * 16);
  }
}

// Lane's A rows for its m16 tiles at tap (0, 0, 0): row r = lane % 16 of
// tile i is output voxel (warp, 2i + r / 8, r % 8); lanes 16..31 address
// the upper 16 bytes of a k32 step.
__device__ __forceinline__ void a_rows(uint32_t (&a_row)[MT], uint32_t halo_s, int warp, int lane,
                                       int S) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = lane & 15;
    a_row[i] = halo_s + ((warp * H + 2 * i + (r >> 3)) * H + (r & 7)) * S + (lane >> 4) * 16;
  }
}

// One k32 step (channels c0 .. c0 + 31) of a tap: acc += the tap's A rows
// (from the halo at a_row + a_tap) times its weight slot w_tap (the pass's
// columns at stride S). Lane's B row in a slot: ldmatrix.x4 reads tiles
// j, j+1 (matrices 0, 1: tile j, bytes 0-15 and 16-31; 2, 3: tile j+1).
template <int NT>
__device__ __forceinline__ void k32_step(int (&acc)[MT][NT][4], const uint32_t (&a_row)[MT],
                                         uint32_t a_tap, uint32_t w_tap, int lane, int S, int c0) {
  const int m4 = lane >> 3;
  const uint32_t b_row32 = ((m4 >> 1) * 8 + (lane & 7)) * S + (m4 & 1) * 16;
  uint32_t bf[NT][2];
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t r[4];
    ldmatrix_x4(r, w_tap + j * 8 * S + b_row32 + c0);
    bf[j][0] = r[0];
    bf[j][1] = r[1];
    bf[j + 1][0] = r[2];
    bf[j + 1][1] = r[3];
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    uint32_t af[4];
    ldmatrix_x4(af, a_row[i] + a_tap + c0);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_k32(acc[i][j], af, bf[j][0], bf[j][1]);
  }
}

// The k16 step (channels c0 .. c0 + 15) that ends a tap when C % 32 == 16:
// ldmatrix.x2 reads tiles j, j+1 from lanes 0..15.
template <int NT>
__device__ __forceinline__ void k16_step(int (&acc)[MT][NT][4], const uint32_t (&a_row)[MT],
                                         uint32_t a_tap, uint32_t w_tap, int lane, int S, int c0) {
  const uint32_t b_row16 = (((lane >> 3) & 1) * 8 + (lane & 7)) * S;
  uint32_t bf[NT];
#pragma unroll
  for (int j = 0; j < NT; j += 2) ldmatrix_x2(bf[j], bf[j + 1], w_tap + j * 8 * S + b_row16 + c0);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    uint32_t a0, a1;
    ldmatrix_x2(a0, a1, a_row[i] + a_tap + c0);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_k16(acc[i][j], a0, a1, bf[j]);
  }
}

// One tap's products, C channels: C / 32 k32 steps, then a k16 step when
// C % 32 == 16.
template <int NT>
__device__ __forceinline__ void tap_mma(int (&acc)[MT][NT][4], const uint32_t (&a_row)[MT],
                                        uint32_t a_tap, uint32_t w_tap, int lane, int C, int S) {
#pragma unroll 1
  for (int c0 = 0; c0 + 32 <= C; c0 += 32) k32_step(acc, a_row, a_tap, w_tap, lane, S, c0);
  if ((C & 31) != 0) k16_step(acc, a_row, a_tap, w_tap, lane, S, C - 16);
}

template <int NT>
__device__ __forceinline__ void zero_acc(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// Dequantize: accumulator e of tile (i, j) is output voxel
// (warp, 2i + e / 2, lane / 4), column n0 + 8j + 2 (lane % 4) + e % 2.
template <int NT, typename OutT>
__device__ __forceinline__ void store_brick(OutT* out, const int (&acc)[MT][NT][4],
                                            const float* scale, long long b, int warp, int lane,
                                            int n0, int N) {
  const int z = lane >> 2;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + j * 8 + (lane & 3) * 2;
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = 2 * i + h;
        const long long o = (((b * BS + warp) * BS + y) * BS + z) * N + n;
        store2(out + o, __fmul_rn(__int2float_rn(acc[i][j][2 * h]), s0),
               __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s1));
      }
    }
  }
}

// The halo form. NT: n8 tiles a pass (2 when N = 16, else 4).
template <int NT, typename OutT>
__global__ void __launch_bounds__(THREADS) brick_int8_kernel(const int8_t* __restrict__ h8,
                                                             const int8_t* __restrict__ wt,
                                                             const float* __restrict__ scale,
                                                             OutT* __restrict__ out, int C,
                                                             int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int S = row_stride(C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long b = blockIdx.x;
  const uint32_t halo_s = smem_addr(smem);
  const uint32_t w_s = halo_s + HALO_VOXELS * S;
  const int w_slot = NT * 8 * S;

  // The brick's halo: piece i is 16-byte group q = i % (C/16) of voxel
  // v = i / (C/16), the brick's i-th 16 bytes of h8.
  const int cg = C / 16;
  const int8_t* src = h8 + b * HALO_VOXELS * C;
  for (int i = tid; i < HALO_VOXELS * cg; i += THREADS) {
    const int v = i / cg, q = i - v * cg;
    cp_async16(halo_s + v * S + q * 16, src + i * 16);
  }
  uint32_t a_row[MT];
  a_rows(a_row, halo_s, warp, lane, S);

  for (int n0 = 0; n0 < N; n0 += NT * 8) {
    int acc[MT][NT][4];
    zero_acc(acc);
    // Copy group 0 holds the halo (first pass) and tap 0's weight.
    load_weight<NT>(wt, w_s, 0, n0, C, N, S, tid);
    cp_async_commit();
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const bool last = tap + 1 == TAPS;
      if (!last) {
        load_weight<NT>(wt, w_s + ((tap + 1) & 1) * w_slot, tap + 1, n0, C, N, S, tid);
        cp_async_commit();
      }
      cp_async_wait(last);
      __syncthreads();
      const int kx = tap / 9, ky = (tap / 3) % 3, kz = tap % 3;
      tap_mma<NT>(acc, a_row, ((kx * H + ky) * H + kz) * S, w_s + (tap & 1) * w_slot, lane, C, S);
      __syncthreads();  // the slot is refilled two taps on
    }
    store_brick<NT>(out, acc, scale, b, warp, lane, n0, N);
  }
}

// Issue the 16-byte copies of one brick's halo from the codes q8 into the
// buffer at halo_s, rows27 its 27 neighbour rows (staged in shared
// memory): piece i is group q = i % (C/16) of halo voxel v = i / (C/16),
// v = (hx * 10 + hy) * 10 + hz. On each axis, h = 0 is local 7 of
// neighbour -1, h = 1..8 local h - 1 of the centre and h = 9 local 0 of
// neighbour +1: neighbour index (h + 7) / 8 in {0, 1, 2}, local
// (h + 7) % 8. An absent neighbour's pieces are zero-filled.
__device__ __forceinline__ void gather_halo(const int8_t* q8, const int* rows27, uint32_t halo_s,
                                            int C, int S, int tid) {
  const int cg = C / 16;
  for (int i = tid; i < HALO_VOXELS * cg; i += THREADS) {
    const int v = i / cg, q = i - v * cg;
    const int hx = v / (H * H), hy = v / H - hx * H, hz = v - (v / H) * H;
    const int ax = hx + BS - 1, ay = hy + BS - 1, az = hz + BS - 1;
    const int r = rows27[((ax / BS) * 3 + ay / BS) * 3 + az / BS];
    const int8_t* src = q8;  // a valid address for the zero-fill
    if (r >= 0)
      src += ((((static_cast<long long>(r) * BS + ax % BS) * BS + ay % BS) * BS + az % BS) * C +
              q * 16);
    cp_async16_zfill(halo_s + v * S + q * 16, src, r >= 0);
  }
}

// The gather form: q8 the codes (Bq, 8, 8, 8, C), nbr27 the (27, B)
// neighbour table (row k of brick b at nbr27[k * B + b]). C is a template
// argument, so that a tap's k steps unroll and the three taps of a kz row
// are scheduled together. Shared memory as gather_plan(C, 8 NT) lays it
// out: `bufs` halo buffers, then the weight, tap t's column r at
// (t * 8 NT + r) * S.
template <int C, int NT, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
    brick_int8_gather_kernel(const int8_t* __restrict__ q8, const int* __restrict__ nbr27,
                             const int8_t* __restrict__ wt, const float* __restrict__ scale,
                             OutT* __restrict__ out, int B, int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int rows[2][TAPS];  // the 27 rows of the brick and of the next
  constexpr GatherPlan plan = gather_plan(C, NT * 8);
  constexpr int S = plan.stride, COLS = NT * 8, CG = C / 16;
  static_assert(plan.pass_cols == COLS, "a pass of 8 NT columns");
  const int G = gridDim.x;
  if (static_cast<int>(blockIdx.x) >= B) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t halo0 = smem_addr(smem);
  const uint32_t w_s = halo0 + plan.bufs * plan.halo_bytes;

  for (int n0 = 0; n0 < N; n0 += COLS) {
    // Every warp is done with the previous pass's weight, buffers and rows.
    if (n0 > 0) __syncthreads();
    // The pass's weight, all 27 taps: piece i is group q = i % (C/16) of
    // row r = i / (C/16) = tap * COLS + column.
    for (int i = tid; i < TAPS * COLS * CG; i += THREADS) {
      const int r = i / CG, q = i - r * CG;
      const int tap = r / COLS, col = r - tap * COLS;
      cp_async16(w_s + r * S + q * 16,
                 wt + (static_cast<long long>(tap) * N + n0 + col) * C + q * 16);
    }
    int b = blockIdx.x;
    // The rows of the block's first two bricks.
    if (tid < TAPS) rows[0][tid] = nbr27[tid * B + b];
    if (tid < TAPS && b + G < B) rows[1][tid] = nbr27[tid * B + b + G];
    __syncthreads();
    if (rows[0][TAPS / 2] >= 0) gather_halo(q8, rows[0], halo0, C, S, tid);
    cp_async_commit();  // the weight and the first brick's halo

#pragma unroll 1
    for (int it = 0; b < B; b += G, ++it) {
      const int cur = it & 1;
      const int bn = b + G;
      const uint32_t halo_cur = halo0 + (plan.bufs == 2 ? cur : 0) * plan.halo_bytes;
      const uint32_t halo_next = halo0 + (plan.bufs == 2 ? cur ^ 1 : 0) * plan.halo_bytes;
      // The rows of the brick after next, loaded now and stored into
      // rows[cur] after the barrier below (no thread reads rows[cur] after
      // it), so that the load's latency hides behind the copy's wait.
      const bool ahead = tid < TAPS && bn + G < B;
      const int row_ahead = ahead ? nbr27[tid * B + bn + G] : 0;
      const bool busy = rows[cur][TAPS / 2] >= 0;
      cp_async_wait(true);
      // This brick's halo has landed for every thread, and every warp is
      // done with the previous brick (the buffer the next copy fills).
      __syncthreads();
      if (ahead) rows[cur][tid] = row_ahead;
      const bool next = bn < B && rows[cur ^ 1][TAPS / 2] >= 0;
      if (next && (plan.bufs == 2 || !busy))
        gather_halo(q8, rows[cur ^ 1], halo_next, C, S, tid);
      cp_async_commit();
      if (busy) {
        uint32_t a_row[MT];
        a_rows(a_row, halo_cur, warp, lane, S);
        int acc[MT][NT][4];
        zero_acc(acc);
#pragma unroll 1
        for (int kxy = 0; kxy < 9; ++kxy) {
          const int kx = kxy / 3, ky = kxy - kx * 3;
#pragma unroll(gather_kz_unroll(C, NT))
          for (int kz = 0; kz < 3; ++kz) {
            const uint32_t a_tap = ((kx * H + ky) * H + kz) * S;
            const uint32_t w_tap = w_s + (kxy * 3 + kz) * COLS * S;
#pragma unroll(gather_k_unroll(C, NT))
            for (int c0 = 0; c0 + 32 <= C; c0 += 32)
              k32_step(acc, a_row, a_tap, w_tap, lane, S, c0);
            if constexpr (C % 32 != 0) k16_step(acc, a_row, a_tap, w_tap, lane, S, C - 16);
          }
        }
        if constexpr (plan.bufs == 1) {
          __syncthreads();  // every warp is done with the one buffer
          if (next) gather_halo(q8, rows[cur ^ 1], halo_next, C, S, tid);
          cp_async_commit();
        }
        store_brick<NT>(out, acc, scale, b, warp, lane, n0, N);
      } else if (n0 == 0) {
        // An empty slot (the same for the whole block): +0.0, as the plain
        // version's 0.0f * scale gives; out is 16-byte aligned and a
        // brick's 512 * N outputs fill whole 16-byte pieces.
        int4* o = reinterpret_cast<int4*>(out + static_cast<long long>(b) * (BS * BS * BS) * N);
        const int pieces = BS * BS * BS * N * static_cast<int>(sizeof(OutT)) / 16;
        for (int i = tid; i < pieces; i += THREADS) o[i] = make_int4(0, 0, 0, 0);
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int NT, typename OutT>
int launch(const int8_t* h8, const int8_t* wt, const float* scale, void* out, long long batch,
           int C, int N, cudaStream_t stream) {
  const int S = row_stride(C);
  const int smem = HALO_VOXELS * S + 2 * NT * 8 * S;
  const cudaError_t e = cudaFuncSetAttribute(
      brick_int8_kernel<NT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  brick_int8_kernel<NT, OutT><<<static_cast<unsigned>(batch), THREADS, smem, stream>>>(
      h8, wt, scale, static_cast<OutT*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}

// The gather form's launch: as many blocks as fit on the card at once.
template <int C, int NT, typename OutT>
int launch_gather(const int8_t* q8, const int* nbr27, const int8_t* wt, const float* scale,
                  void* out, int batch, int N, cudaStream_t stream) {
  constexpr int smem = gather_plan(C, NT * 8).smem_bytes;
  cudaError_t e = cudaFuncSetAttribute(brick_int8_gather_kernel<C, NT, OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, brick_int8_gather_kernel<C, NT, OutT>, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  brick_int8_gather_kernel<C, NT, OutT><<<static_cast<unsigned>(sms * per_sm), THREADS, smem,
                                          stream>>>(q8, nbr27, wt, scale, static_cast<OutT*>(out),
                                                    batch, N);
  return static_cast<int>(cudaGetLastError());
}

// The gather form's instance for C: 32 columns a pass where they fit and
// N != 16, else 16.
template <int C>
int dispatch_gather(const int8_t* q8, const int* nbr27, const int8_t* wt, const float* scale,
                    void* out, int batch, int N, int out_bf16, cudaStream_t s) {
  if constexpr (gather_plan(C, PASS_COLS).pass_cols == PASS_COLS) {
    if (N != 16)
      return out_bf16 ? launch_gather<C, 4, __nv_bfloat16>(q8, nbr27, wt, scale, out, batch, N, s)
                      : launch_gather<C, 4, float>(q8, nbr27, wt, scale, out, batch, N, s);
  }
  return out_bf16 ? launch_gather<C, 2, __nv_bfloat16>(q8, nbr27, wt, scale, out, batch, N, s)
                  : launch_gather<C, 2, float>(q8, nbr27, wt, scale, out, batch, N, s);
}

// The shape rule both forms share: whether they take (C, N) and the
// operands' alignment.
bool takes(const void* x8, const void* wt, const void* out, int C, int N) {
  return C >= 16 && C <= C_MAX && C % 16 == 0 && (N == 16 || (N > 0 && N % PASS_COLS == 0)) &&
         aligned16(x8) && aligned16(wt) && aligned16(out);
}

}  // namespace

// h8 (batch, 10, 10, 10, C) and wt (3, 3, 3, N, C) int8, scale (N,) f32,
// out (batch, 8, 8, 8, N) bf16 (out_bf16 = 1) or f32, all contiguous.
// Returns -1 for a shape it does not take (C % 16 != 0, C < 16, C > 128,
// N not 16 and not a multiple of 32, or operands not 16-byte aligned),
// else the CUDA error of the launch (0 on success).
extern "C" int sps_brick_conv_int8(const void* h8, const void* wt, const float* scale, void* out,
                                   long long batch, int C, int N, int out_bf16, void* stream) {
  if (!takes(h8, wt, out, C, N)) return -1;
  if (batch == 0) return 0;
  const auto* x = static_cast<const int8_t*>(h8);
  const auto* w = static_cast<const int8_t*>(wt);
  const auto s = static_cast<cudaStream_t>(stream);
  if (N == 16)
    return out_bf16 ? launch<2, __nv_bfloat16>(x, w, scale, out, batch, C, N, s)
                    : launch<2, float>(x, w, scale, out, batch, C, N, s);
  return out_bf16 ? launch<4, __nv_bfloat16>(x, w, scale, out, batch, C, N, s)
                  : launch<4, float>(x, w, scale, out, batch, C, N, s);
}

// The gather form: q8 (Bq, 8, 8, 8, C) int8 and nbr27 (27, batch) int32,
// both contiguous, every row -1 or in [0, Bq) (the caller's guarantee: the
// kernel reads row r's codes unchecked); wt, scale and out as above, one
// output brick per column of nbr27. Returns -1 for a shape it does not
// take (the same rule), else the CUDA error of the launch.
extern "C" int sps_brick_conv_int8_gather(const void* q8, const int* nbr27, const void* wt,
                                          const float* scale, void* out, long long batch, int C,
                                          int N, int out_bf16, void* stream) {
  if (!takes(q8, wt, out, C, N) || batch >= (1LL << 31) / 27) return -1;
  if (batch == 0) return 0;
  const auto* x = static_cast<const int8_t*>(q8);
  const auto* w = static_cast<const int8_t*>(wt);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return dispatch_gather<16>(x, nbr27, w, scale, out, batch, N, out_bf16, s);
    case 32: return dispatch_gather<32>(x, nbr27, w, scale, out, batch, N, out_bf16, s);
    case 48: return dispatch_gather<48>(x, nbr27, w, scale, out, batch, N, out_bf16, s);
    case 64: return dispatch_gather<64>(x, nbr27, w, scale, out, batch, N, out_bf16, s);
    case 80: return dispatch_gather<80>(x, nbr27, w, scale, out, batch, N, out_bf16, s);
    case 96: return dispatch_gather<96>(x, nbr27, w, scale, out, batch, N, out_bf16, s);
    case 112: return dispatch_gather<112>(x, nbr27, w, scale, out, batch, N, out_bf16, s);
    default: return dispatch_gather<128>(x, nbr27, w, scale, out, batch, N, out_bf16, s);
  }
}
