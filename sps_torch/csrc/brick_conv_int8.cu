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
// Design: an implicit GEMM per brick on the tensor cores, mma.sync with s8
// operands and s32 accumulators. One block is one brick: M = its 512
// output voxels, N the columns, K = 27 taps x C channels. The brick's
// halo (1000 x C bytes) is staged in shared memory once with 16-byte
// cp.async copies: in the gather form each piece straight from the codes
// of the neighbour brick that nbr27 names (the block stages the brick's 27
// rows first; an absent neighbour's pieces are zero-filled by the copy
// itself, and a block whose centre row is absent stores zeros and
// returns), in the halo form from the halo tensor; each voxel's C bytes
// at a row stride S = C or C + 16
// (S / 16 odd), so that the 8 rows of an ldmatrix land in 8 different
// bank groups. Warp w computes output plane x = w: four m16 tiles
// (y = 2i, 2i+1; z = 0..7). A tap's A rows are addressed per lane by
// ldmatrix (no im2col): the row of output voxel (x, y, z) for tap
// (kx, ky, kz) is halo voxel (x+kx, y+ky, z+kz). The weight streams by
// tap through a two-slot ring of 16-byte cp.async copies (tap t+1 lands
// while tap t is multiplied), 32 columns a pass (16 when N = 16); a
// second pass over the resident halo serves N = 64. Channels go in k32
// steps (m16n8k32) and, when C % 32 == 16, one k16 step (m16n8k16). The
// epilogue dequantizes from the int32 registers and stores column pairs.
//
// What bounds it on this card: at the path's shapes the int8 input read
// (the codes once in the gather form, the 1.95x larger halo tensor in the
// halo form) and the output write (bytes over 3.35 TB/s), except at
// block6_0 (C = 96 and 64 -> 64), where the int8 operations over
// 1979 TOP/s bound it. The kernel uses mma.sync rather than wgmma, copies
// each tap's weight into every block from L2 and overlaps a block's halo
// copy with no math, so it stays below the bound.

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
static_assert(SMEM_MAX <= 232448, "SMEM_BYTES <= 232448");

// Bytes between neighbouring voxels (and weight columns) in shared memory:
// an odd number of 16-byte units.
__host__ __device__ constexpr int row_stride(int c) { return (c / 16) % 2 == 1 ? c : c + 16; }

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

// GATHER: x8 is the codes q8 (Bq, 8, 8, 8, C) and nbr27 the (27, B)
// neighbour table (row k of brick b at nbr27[k * B + b]); else x8 is the
// halo tensor h8 (B, 10, 10, 10, C) and nbr27 is unused.
// NT: n8 tiles a pass (2 when N = 16, else 4).
template <bool GATHER, int NT, typename OutT>
__global__ void __launch_bounds__(THREADS) brick_int8_kernel(const int8_t* __restrict__ x8,
                                                             const int* __restrict__ nbr27,
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

  // The brick's halo: piece i is 16-byte group q = i % (C/16) of halo
  // voxel v = i / (C/16), v = (hx * 10 + hy) * 10 + hz.
  const int cg = C / 16;
  if constexpr (GATHER) {
    __shared__ int rows[TAPS];
    if (tid < TAPS) rows[tid] = nbr27[tid * static_cast<long long>(gridDim.x) + b];
    __syncthreads();
    if (rows[TAPS / 2] < 0) {
      // An empty slot (the same for the whole block): +0.0, as the plain
      // version's 0.0f * scale gives; out is 16-byte aligned and a brick's
      // 512 * N outputs fill whole 16-byte pieces.
      int4* o = reinterpret_cast<int4*>(out + b * (BS * BS * BS) * N);
      const int pieces = BS * BS * BS * N * static_cast<int>(sizeof(OutT)) / 16;
      for (int i = tid; i < pieces; i += THREADS) o[i] = make_int4(0, 0, 0, 0);
      return;
    }
    // On each axis, h = 0 is local 7 of neighbour -1, h = 1..8 local h - 1
    // of the centre and h = 9 local 0 of neighbour +1: neighbour index
    // (h + 7) / 8 in {0, 1, 2}, local (h + 7) % 8.
    for (int i = tid; i < HALO_VOXELS * cg; i += THREADS) {
      const int v = i / cg, q = i - v * cg;
      const int hx = v / (H * H), hy = v / H - hx * H, hz = v - (v / H) * H;
      const int ax = hx + BS - 1, ay = hy + BS - 1, az = hz + BS - 1;
      const int r = rows[((ax / BS) * 3 + ay / BS) * 3 + az / BS];
      const int8_t* src = x8;  // a valid address for the zero-fill
      if (r >= 0)
        src += ((((static_cast<long long>(r) * BS + ax % BS) * BS + ay % BS) * BS + az % BS) * C +
                q * 16);
      cp_async16_zfill(halo_s + v * S + q * 16, src, r >= 0);
    }
  } else {
    // The brick's i-th 16 bytes of h8.
    const int8_t* src = x8 + b * HALO_VOXELS * C;
    for (int i = tid; i < HALO_VOXELS * cg; i += THREADS) {
      const int v = i / cg, q = i - v * cg;
      cp_async16(halo_s + v * S + q * 16, src + i * 16);
    }
  }

  // Lane's A row for m16 tile i at tap (0, 0, 0): row r = lane % 16 of the
  // tile is output voxel (warp, 2i + r / 8, r % 8); lanes 16..31 address
  // the upper 16 bytes of a k32 step.
  uint32_t a_row[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = lane & 15;
    a_row[i] = halo_s + ((warp * H + 2 * i + (r >> 3)) * H + (r & 7)) * S + (lane >> 4) * 16;
  }
  // Lane's B row in a weight slot: ldmatrix.x4 of a k32 step reads tiles
  // j, j+1 (matrices 0, 1: tile j, bytes 0-15 and 16-31; 2, 3: tile j+1);
  // ldmatrix.x2 of a k16 step reads tiles j, j+1 from lanes 0..15.
  const int m4 = lane >> 3;
  const uint32_t b_row32 = ((m4 >> 1) * 8 + (lane & 7)) * S + (m4 & 1) * 16;
  const uint32_t b_row16 = (((lane >> 3) & 1) * 8 + (lane & 7)) * S;
  const int k32_steps = C / 32;
  const bool k16_tail = (C & 31) != 0;

  for (int n0 = 0; n0 < N; n0 += NT * 8) {
    int acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
      const uint32_t a_tap = ((kx * H + ky) * H + kz) * S;
      const uint32_t w_tap = w_s + (tap & 1) * w_slot;
#pragma unroll 1
      for (int ks = 0; ks < k32_steps; ++ks) {
        const int c0 = ks * 32;
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
      if (k16_tail) {
        const int c0 = k32_steps * 32;
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
      __syncthreads();  // the slot is refilled two taps on
    }

    // Dequantize: accumulator e of tile (i, j) is output voxel
    // (warp, 2i + e / 2, lane / 4), column n0 + 8j + 2 (lane % 4) + e % 2.
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
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool GATHER, int NT, typename OutT>
int launch(const int8_t* x8, const int* nbr27, const int8_t* wt, const float* scale, void* out,
           long long batch, int C, int N, cudaStream_t stream) {
  const int S = row_stride(C);
  const int smem = HALO_VOXELS * S + 2 * NT * 8 * S;
  const cudaError_t e = cudaFuncSetAttribute(
      brick_int8_kernel<GATHER, NT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  brick_int8_kernel<GATHER, NT, OutT><<<static_cast<unsigned>(batch), THREADS, smem, stream>>>(
      x8, nbr27, wt, scale, static_cast<OutT*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}

// The shape rule both forms share (-1 for a call they do not take), then
// the launch on `batch` bricks.
template <bool GATHER>
int dispatch(const void* x8, const int* nbr27, const void* wt, const float* scale, void* out,
             long long batch, int C, int N, int out_bf16, void* stream) {
  if (C < 16 || C > C_MAX || C % 16 != 0 || !(N == 16 || (N > 0 && N % PASS_COLS == 0)))
    return -1;
  if (!aligned16(x8) || !aligned16(wt) || !aligned16(out)) return -1;
  if (batch == 0) return 0;
  const auto* x = static_cast<const int8_t*>(x8);
  const auto* w = static_cast<const int8_t*>(wt);
  const auto s = static_cast<cudaStream_t>(stream);
  if (N == 16)
    return out_bf16 ? launch<GATHER, 2, __nv_bfloat16>(x, nbr27, w, scale, out, batch, C, N, s)
                    : launch<GATHER, 2, float>(x, nbr27, w, scale, out, batch, C, N, s);
  return out_bf16 ? launch<GATHER, 4, __nv_bfloat16>(x, nbr27, w, scale, out, batch, C, N, s)
                  : launch<GATHER, 4, float>(x, nbr27, w, scale, out, batch, C, N, s);
}

}  // namespace

// h8 (batch, 10, 10, 10, C) and wt (3, 3, 3, N, C) int8, scale (N,) f32,
// out (batch, 8, 8, 8, N) bf16 (out_bf16 = 1) or f32, all contiguous.
// Returns -1 for a shape it does not take (C % 16 != 0, C < 16, C > 128,
// N not 16 and not a multiple of 32, or operands not 16-byte aligned),
// else the CUDA error of the launch (0 on success).
extern "C" int sps_brick_conv_int8(const void* h8, const void* wt, const float* scale, void* out,
                                   long long batch, int C, int N, int out_bf16, void* stream) {
  return dispatch<false>(h8, nullptr, wt, scale, out, batch, C, N, out_bf16, stream);
}

// The gather form: q8 (Bq, 8, 8, 8, C) int8 and nbr27 (27, batch) int32,
// both contiguous, every row -1 or in [0, Bq) (the caller's guarantee: the
// kernel reads row r's codes unchecked); wt, scale and out as above, one
// output brick per column of nbr27. Returns -1 for a shape it does not
// take (the same rule), else the CUDA error of the launch.
extern "C" int sps_brick_conv_int8_gather(const void* q8, const int* nbr27, const void* wt,
                                          const float* scale, void* out, long long batch, int C,
                                          int N, int out_bf16, void* stream) {
  return dispatch<true>(q8, nbr27, wt, scale, out, batch, C, N, out_bf16, stream);
}
