// z-band brick convolution for Hopper (sm_90a). The kernel has a plain C
// entry point (sps_zband_conv, below); zband_conv_op.cpp binds it to
// PyTorch as torch.ops.sps_torch.* and sps_torch/ops/zband_conv.py builds
// and calls it.
//
// Replaces the two Pallas TPU kernels of sps_tpu/ops/pallas_conv.py:
//   * zband_conv        (_zmm_kernel_onepass / _zmm_kernel)
//   * zband_conv_fused  (_fused_kernel_onepass / _fused_kernel)
//
// Function: the VALID 2-D conv of the z-folded halo hz (B, h, h, C), with
// h = bs + k - 1 and C = h * TCin, by the band-packed weight wz (k, k, C, N),
// N = bs * TCout:
//   acc[b, xo, yo, n] = sum_{kx, ky < k} sum_{c < C} hz[b, xo+kx, yo+ky, c] * wz[kx, ky, c, n]
// accumulated in f32. The plain kernel writes acc cast to the input type;
// the fused kernel applies the inference epilogue in f32 first:
//   out = occ * [relu](acc * scale + bias [+ res])
//
// Design: an implicit GEMM with M = B*bs*bs output rows,
// N columns and K = k*k*C. The A operand is read straight from hz at
// (b, xo+kx, yo+ky, c) — no im2col is materialised: each row's base offset
// is computed once per block, and each (kx, ky) tap adds a constant. One
// block computes a 128 x 128 output tile; K is walked tap by tap in chunks
// of 32 channels staged through shared memory, with zero fill at the
// ragged M, N and C edges (any B, any N). bf16 runs on the tensor cores
// through WMMA (16x16x16, f32 accumulators) and, when C and N are
// multiples of 8, loads its tiles as 16-byte cp.async copies into a
// two-stage ring, so chunk q+1 is in flight while chunk q is multiplied;
// other shapes take scalar loads. f32 runs as a single-stage shared-memory
// FMA loop. The epilogue goes through a per-warp shared scratch tile so
// that it reads and writes global memory in row order.
//
// Which calls it serves: those that sps_torch/ops/zband_conv.route sends to
// none of the wgmma kernels (zband_conv_sm90.cu: bf16 at k = 3, bs = 8,
// C % 32 == 0, N % 128 == 0; zband_conv_k5_sm90.cu: the unfused bf16 stem,
// k = 5, bs = 8, C % 8 == 0 with C <= 24; zband_conv_k5_wide_sm90.cu: the same
// at C = 48, the stem of DIST_FEATURE; zband_conv_tf32x3_sm90.cu: f32
// at k = 3 as the first and at the unfused k = 5 stem with C <= 48): the f32
// stem at narrow widths (N < 128, as in the training pin), and every small
// or ragged shape (bs = 4, C or N off the wgmma kernels' multiples,
// misaligned operands) in f32 and bf16. Its f32 FMA loop is the yardstick
// for those ragged shapes. chip_smoke.py also times it beside the wgmma
// kernels on their operands.
//
// What bounds it on this card: at the stem's shape (hz (11264, 12, 12, 24),
// wz (5, 5, 24, 128)) 110.7 GFLOP against 0.263 GB moved, i.e. the tensor
// cores (0.112 ms). This version uses WMMA rather than wgmma, re-reads the
// halo once per tap and computes the band's zeros, so it stays well below
// that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 32;   // reduction chunk (channels of one tap)
constexpr int PAD = 8;   // smem row padding (keeps WMMA ldm a multiple of 8)
constexpr int LDA = BK + PAD;
constexpr int LDB = BN + PAD;
constexpr int NT = 256;  // 8 warps

struct Params {
  const void* hz;
  const void* wz;
  const float* scale;
  const float* bias;
  const void* occ;
  const void* res;
  void* out;
  long long M;  // B * bs * bs
  int k, bs, h, C, N;
  int relu;
  int vec;  // bf16 only: 16-byte cp.async tile loads (C, N multiples of 8, aligned)
};

template <typename T>
struct Stages {
  static constexpr int value = 1;
};
template <>
struct Stages<__nv_bfloat16> {
  static constexpr int value = 2;
};

// 16-byte global -> shared async copy; pred false zero-fills the 16 bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most the newest committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One output element: f32 accumulator -> (epilogue) -> output type.
template <typename T, bool FUSED>
__device__ __forceinline__ void store_out(const Params& p, long long m, int col, float v) {
  const long long o = m * p.N + col;
  if (FUSED) {
    v = __fadd_rn(__fmul_rn(v, p.scale[col]), p.bias[col]);
    if (p.res != nullptr) v = __fadd_rn(v, to_f(static_cast<const T*>(p.res)[o]));
    if (p.relu) v = fmaxf(v, 0.0f);
    v = __fmul_rn(v, to_f(static_cast<const T*>(p.occ)[o]));
  }
  static_cast<T*>(p.out)[o] = from_f<T>(v);
}

// Stage chunk q of the reduction (tap q / ncpt, channels from
// (q % ncpt) * BK) into the shared tiles As (BM x BK) and Bs (BK x BN).
template <typename T>
__device__ __forceinline__ void load_chunk(const Params& p, const long long* rowbase, T* As,
                                           T* Bs, int q, int ncpt, int n0, int tid) {
  const T* hz = static_cast<const T*>(p.hz);
  const T* wz = static_cast<const T*>(p.wz);
  const int tap = q / ncpt;
  const int c0 = (q - tap * ncpt) * BK;
  const int kx = tap / p.k, ky = tap - kx * p.k;
  const long long tap_a = static_cast<long long>(kx * p.h + ky) * p.C;
  const long long tap_b = static_cast<long long>(tap) * p.C;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (p.vec) {
      // c < C implies c + 8 <= C (C % 8 == 0), and likewise for N.
      constexpr int AV = BK / 8, BV = BN / 8;
      for (int i = tid; i < BM * AV; i += NT) {
        const int r = i / AV, c = c0 + (i % AV) * 8;
        const long long base = rowbase[r];
        const bool ok = base >= 0 && c < p.C;
        cp_async16(As + r * LDA + (i % AV) * 8, ok ? hz + base + tap_a + c : hz, ok);
      }
      for (int i = tid; i < BK * BV; i += NT) {
        const int kc = i / BV, col = n0 + (i % BV) * 8;
        const int c = c0 + kc;
        const bool ok = c < p.C && col < p.N;
        cp_async16(Bs + kc * LDB + (i % BV) * 8, ok ? wz + (tap_b + c) * p.N + col : wz, ok);
      }
      return;
    }
  }
  const T zero = from_f<T>(0.0f);
  for (int i = tid; i < BM * BK; i += NT) {
    const int r = i / BK, c = c0 + i % BK;
    const long long base = rowbase[r];
    As[r * LDA + i % BK] = (base >= 0 && c < p.C) ? hz[base + tap_a + c] : zero;
  }
  for (int i = tid; i < BK * BN; i += NT) {
    const int kc = i / BN, n = i % BN;
    const int c = c0 + kc, col = n0 + n;
    Bs[kc * LDB + n] = (c < p.C && col < p.N) ? wz[(tap_b + c) * p.N + col] : zero;
  }
}

template <typename T, bool FUSED>
__global__ void __launch_bounds__(NT) zband_kernel(const Params p) {
  constexpr int S = Stages<T>::value;
  __shared__ __align__(128) T As[S * BM * LDA];
  __shared__ __align__(128) T Bs[S * BK * LDB];
  __shared__ __align__(128) float Cs[(NT / 32) * 16 * 16];
  __shared__ long long rowbase[BM];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int bs2 = p.bs * p.bs;

  for (int r = tid; r < BM; r += NT) {
    const long long m = m0 + r;
    long long base = -1;
    if (m < p.M) {
      const long long b = m / bs2;
      const int rem = static_cast<int>(m - b * bs2);
      const int xo = rem / p.bs, yo = rem % p.bs;
      base = ((b * p.h + xo) * p.h + yo) * p.C;
    }
    rowbase[r] = base;
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;

  // bf16: warp (wm, wn) owns rows wm*32 .. +32 and columns wn*64 .. +64.
  const int wm = warp / 2, wn = warp % 2;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc_tc[2][4];
  // f32: thread (ty, tx) owns rows ty*8 .. +8 and columns tx + 16*j.
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc_tc[i][j], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  const int ncpt = (p.C + BK - 1) / BK;
  const int nq = p.k * p.k * ncpt;
  if constexpr (S == 2) {
    load_chunk<T>(p, rowbase, As, Bs, 0, ncpt, n0, tid);
    cp_async_commit();
  }
  for (int q = 0; q < nq; ++q) {
    int st = 0;
    if constexpr (S == 2) {
      // Stage st^1 was last read in iteration q-1, which ended in a barrier.
      st = q & 1;
      if (q + 1 < nq)
        load_chunk<T>(p, rowbase, As + (st ^ 1) * BM * LDA, Bs + (st ^ 1) * BK * LDB, q + 1,
                      ncpt, n0, tid);
      cp_async_commit();
      cp_async_wait_prev();
    } else {
      load_chunk<T>(p, rowbase, As, Bs, q, ncpt, n0, tid);
    }
    __syncthreads();
    const T* as = As + st * BM * LDA;
    const T* bs = Bs + st * BK * LDB;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               nvcuda::wmma::row_major> fa[2];
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               nvcuda::wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          nvcuda::wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          nvcuda::wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            nvcuda::wmma::mma_sync(acc_tc[i][j], fa[i], fb[j], acc_tc[i][j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f(as[(ty * 8 + i) * LDA + kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = to_f(bs[kk * LDB + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    float* scratch = Cs + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nvcuda::wmma::store_matrix_sync(scratch, acc_tc[i][j], 16, nvcuda::wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const long long m = m0 + wm * 32 + i * 16 + e / 16;
          const int col = n0 + wn * 64 + j * 16 + e % 16;
          if (m < p.M && col < p.N) store_out<T, FUSED>(p, m, col, scratch[e]);
        }
        __syncwarp();
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + ty * 8 + i;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < p.N) store_out<T, FUSED>(p, m, col, acc[i][j]);
      }
    }
  }
}

template <typename T>
void launch(const Params& p, bool fused, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.M + BM - 1) / BM),
                  static_cast<unsigned>((p.N + BN - 1) / BN));
  if (fused)
    zband_kernel<T, true><<<grid, NT, 0, stream>>>(p);
  else
    zband_kernel<T, false><<<grid, NT, 0, stream>>>(p);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hz, wz, occ, res and out share that
// type; scale/bias are f32 and, like occ and res, read only when fused
// (res may be null). Returns the cudaError_t of the launch.
extern "C" int sps_zband_conv(int dtype, int fused, const void* hz, const void* wz,
                              const float* scale, const float* bias, const void* occ,
                              const void* res, void* out, long long batch, int k, int bs,
                              int C, int N, int relu, void* stream) {
  Params p;
  p.hz = hz;
  p.wz = wz;
  p.scale = scale;
  p.bias = bias;
  p.occ = occ;
  p.res = res;
  p.out = out;
  p.M = batch * bs * bs;
  p.k = k;
  p.bs = bs;
  p.h = bs + k - 1;
  p.C = C;
  p.N = N;
  p.relu = relu;
  p.vec = dtype == 1 && C % 8 == 0 && N % 8 == 0 &&
          reinterpret_cast<uintptr_t>(hz) % 16 == 0 && reinterpret_cast<uintptr_t>(wz) % 16 == 0;
  if (p.M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(p, fused != 0, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(p, fused != 0, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
