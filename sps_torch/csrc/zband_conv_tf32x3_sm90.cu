// z-band brick convolution in f32 on Hopper's warpgroup tensor cores
// (sm_90a, wgmma on TF32 operands, each product split three ways).
// Plain C entry point sps_zband_conv_tf32x3_sm90 (below); zband_conv_op.cpp
// binds it to PyTorch as route 3 ("wgmma_f32") and
// sps_torch/ops/zband_conv.py routes an f32 call here when its shape
// qualifies (zband_conv.route): k = 3 at zband_conv_sm90.cu's shapes, and the
// unfused k = 5 stem at C % 8 == 0 with C <= 48 (zband_conv_k5_sm90.cu's
// C <= 24 and the C = 48 stem of DIST_FEATURE). Device helpers in
// sm90_wgmma.cuh.
//
// Replaces, in f32 and at the shapes it takes, the Pallas TPU kernels of
// sps_tpu/ops/pallas_conv.py (the BF16: false configurations):
//   * zband_conv        (:218; _zmm_kernel_onepass :74) - the k = 5 stem and
//     the k = 3 probe of scripts/microbench_pallas.py (K3);
//   * zband_conv_fused  (:310; _fused_kernel_onepass :282) - both block8
//     convs of L0.
//
// Function, with bs = 8, h = 8 + k - 1:
//   acc[b, xo, yo, n] = sum_{kx, ky < k} sum_{c < C} hz[b, xo+kx, yo+ky, c] * wz[kx, ky, c, n]
// in f32; the plain kernel stores acc, the fused one
//   out = occ * [relu](acc * scale + bias [+ res])
// computed in f32 (no contraction), as zband_conv.cu does. Every operand is f32.
//
// Precision (3xTF32). TF32 keeps 10 mantissa bits; at K = 9 * 160 the sum
// of single TF32 products misses the f32 bar (rtol 1e-4 / atol 1e-4 against
// the plain version). So each operand is split into x_hi = tf32(x) and
// x_lo = tf32(x - x_hi), both rounded to nearest (cvt.rna.tf32.f32;
// x - x_hi is exact in f32), and
//   acc += A_lo * B_hi;  acc += A_hi * B_lo;  acc += A_hi * B_hi
// in that order (small terms first), all three on
// wgmma.m64n128k8.f32.tf32.tf32 with f32 accumulators. The dropped A_lo * B_lo
// and the rounding of x_lo are ~2^-22 of a product, below f32's own sum.
//
// What bounds it on this card (H100 SXM: 495 TFLOP/s TF32, 67 TFLOP/s f32
// outside the tensor cores, 3.35 TB/s): three TF32 products per multiply-add,
// so at K3's f32 shape (hz (11264, 10, 10, 160), wz (3, 3, 160, 128); 265.8
// GFLOP of band, zeros counted) 3 x 265.8 / 495 = 1.61 ms of tensor cores,
// against 1.09 GB / 3.35 TB/s = 0.33 ms of bytes and 3.97 ms for an FMA loop
// at the f32 peak: operations. The design keeps the tensor cores fed and
// reads hz from device memory once.
//
// Design (zband_conv_sm90.cu's, changed where TF32 differs):
//   * One 8 x 8 brick is one wgmma M-tile (row m = b*64 + xo*8 + yo); a
//     block holds 4 bricks, 2 per warpgroup (two warpgroups, 256 threads),
//     with 64 x 128 f32 accumulators in registers (128 a thread), and one
//     128-column tile of N (gridDim.y walks N).
//   * TF32 wgmma reads both operands K-major from shared memory and cannot
//     transpose them. hz is channel-minor, so a brick's halo chunk (8
//     channels, one k8 step) lands as K-major core matrices [4-channel
//     group][pixel][4 channels], 16 bytes a pixel and group: the A operand
//     of tap (kx, ky) starts at pixel kx*h + ky, 8-row groups (the next xo)
//     h*16 bytes apart (SBO), the two 4-channel groups h*h*16 apart (LBO).
//     The halo is read from device memory into registers (16-byte loads),
//     split into hi and lo and stored as two such buffers, once per chunk:
//     hz crosses device memory once.
//   * wz (k, k, C, N) is N-minor. A first small kernel
//     (zband_tf32x3_split_kernel) writes it once per call as K-major,
//     pre-split hi and lo, in the order the main kernel stages it:
//     [hi|lo][tap][8-channel chunk][n][8 channels], and flags each 8 x 8
//     block of wz that holds a value other than 0 (the caller's scratch:
//     2 k^2 C N floats, then the flags). One tap's chunk for 128 columns
//     is then 4 KB contiguous in device memory, copied with 16-byte
//     cp.async into K-major core matrices [4-channel group][8-column
//     group][8][4] (SBO 128 bytes: next 8 columns;
//     LBO 2048 bytes: next 4 channels). The pieces of an all-zero block are
//     zero-filled without a read: the band's zeros, 70% of K2's weight and a
//     third of the C = 24 stem's, half of the C = 48 one's. Each thread loads its column group's flags for a
//     step's taps together, before its copies. The weight's copies cost more
//     than its tensor-core work at first: at K3's shape on an H100 a version
//     that read every block took 4.99 ms, one that checked a flag before
//     each copy 3.77, this one 2.80 (sps_torch/scripts/zband_sm90_variants.py
//     --f32, band-packed weights).
//   * A step is one 8-channel chunk q and a group of taps: all 9 at k = 3,
//     one row of 5 at k = 5 (all 25 would not fit twice in shared memory):
//     C / 8 x 5 steps at k = 5, 30 at the C = 48 stem.
//     Two halo buffers (chunk q % 2) and two weight buffers (step % 2), each
//     hi and lo: k = 3 2 x 25,600 + 2 x 73,728 = 198,656 bytes, k = 5
//     2 x 36,864 + 2 x 40,960 = 155,648. After step s's barrier the block
//     starts step s+1's weight copies (cp.async) and, at a chunk's last step,
//     the next chunk's halo loads into registers; then it starts step s's
//     wgmmas (k = 3: 9 taps x 2 bricks x 3 products = 54 per warpgroup;
//     k = 5: 30), splits and stores the loaded halo while they run, and
//     waits for them: the barrier of step s+1 says both buffers are ready
//     and every wgmma of step s has read its operands. The tensor cores
//     idle across each barrier (three buffer sets would not fit).
//   * The epilogue applies the fused epilogue in f32 from the accumulators,
//     stages the results in the freed buffers row by row and stores them as
//     16-byte pieces of contiguous rows.
//   * Ragged B: a missing brick's halo is zero and its rows are not stored.
//   * The band's zeros are still multiplied: every wgmma spans all 128
//     columns, the zero-filled blocks included.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

constexpr int BS = 8;       // brick side: 8 x 8 outputs = 64 wgmma rows
constexpr int BN = 128;     // columns per block (wgmma N)
constexpr int BRICKS = 4;   // bricks per block, 2 per warpgroup
constexpr int NT = 256;     // two warpgroups
constexpr int CK = 8;       // channels per chunk: one k8 step of TF32 wgmma
constexpr int B_SBO = 8 * 16;             // next 8-column group along N
constexpr int B_LBO = (BN / 8) * B_SBO;   // next 4-channel group along K
constexpr int W_TAP = (CK / 4) * B_LBO;   // one tap's chunk, hi or lo: 4096 bytes

// The geometry at k taps a side (k = 3 or 5); zband_conv.py's f32_smem_plan
// mirrors it.
template <int KS>
struct Geo {
  static constexpr int H = BS + KS - 1;                     // halo side
  static constexpr int HP = H * H;                          // halo pixels
  static constexpr int TAPS = KS * KS;
  static constexpr int STEP_TAPS = KS == 3 ? TAPS : KS;     // taps a step
  static constexpr int STEPS = TAPS / STEP_TAPS;            // steps a chunk
  static constexpr int A_SBO = H * 16;                      // next xo: 8-row group along M
  static constexpr int A_LBO = HP * 16;                     // next 4-channel group along K
  static constexpr int HALO = (CK / 4) * A_LBO;             // one brick's chunk, hi or lo
  static constexpr int HALO_SET = 2 * BRICKS * HALO;        // hi then lo, the block's bricks
  static constexpr int W_SET = 2 * STEP_TAPS * W_TAP;       // hi then lo, a step's taps
  static constexpr int W_OFFSET = 2 * HALO_SET;             // two halo sets, then two weight sets
  static constexpr int SMEM = W_OFFSET + 2 * W_SET;
  static constexpr int H_PIECES = BRICKS * HP * (CK / 4);   // 16-byte pieces of a halo chunk
  static constexpr int H_REGS = (H_PIECES + NT - 1) / NT;   // a thread's pieces
  static constexpr int W_PIECES = 2 * STEP_TAPS * (W_TAP / 16);
  static_assert(SMEM <= 232448, "the buffers must fit the 227 KB of a block");
  static_assert(W_PIECES % NT == 0, "a step's weight is whole sweeps of the block");
  static_assert(TAPS % STEP_TAPS == 0, "a chunk is whole steps");
};

struct Params {
  const float* hz;
  const float* wsplit;  // zband_tf32x3_split_kernel's output
  const int* nonzero;   // its block flags: [tap][8-channel chunk][8-column group]
  const float* scale;
  const float* bias;
  const float* occ;
  const float* res;
  float* out;
  long long B;
  int C, N;
  int relu;
};

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// wsplit[part][tap][q][n][j] = part 0: tf32(w), part 1: tf32(w - tf32(w)),
// with w = wz[tap][8q + j][n]; one thread an element of wz (n fastest).
// nonzero[(tap * C/8 + q) * N/8 + n/8] becomes 1 where the 8 x 8 block
// holding w has a value other than 0 (the caller zeroes it first).
__global__ void zband_tf32x3_split_kernel(const float* __restrict__ wz, float* __restrict__ wsplit,
                                          int* __restrict__ nonzero, int taps, int C, int N) {
  const long long total = static_cast<long long>(taps) * C * N;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(e % N);
    const long long tc = e / N;
    const int c = static_cast<int>(tc % C), tap = static_cast<int>(tc / C);
    const float x = wz[e];
    const float hi = tf32_rna(x);
    const long long o = ((static_cast<long long>(tap) * (C / CK) + c / CK) * N + n) * CK + c % CK;
    wsplit[o] = hi;
    wsplit[total + o] = tf32_rna(x - hi);
    if (x != 0.0f) nonzero[(static_cast<long long>(tap) * (C / CK) + c / CK) * (N / 8) + n / 8] = 1;
  }
}

// Copy the weights of step s (chunk q, taps t0 .. t0 + STEP_TAPS - 1) for
// columns n0 .. n0 + 127, hi then lo, into weight set `w`: piece i is part
// i / (STEP_TAPS * 256) (hi, lo), tap i / 256 of the step, column n = e / 2
// and 4-channel group g = e % 2 with e = i % 256 = tid % 256, so neighbouring
// threads read contiguous 16 bytes. A piece of an all-zero 8 x 8 block is
// zero-filled without reading device memory (most of a band: 70% of K2's).
template <int KS>
__device__ __forceinline__ void load_weights(const Params& p, uint32_t w, int q, int t0, int n0,
                                             int tid) {
  using G = Geo<KS>;
  const int e = tid & 255, n = e >> 1, g = e & 1;
  const long long tap_stride = static_cast<long long>(p.C / CK) * p.N * CK;
  const long long part_stride = G::TAPS * tap_stride;
  const float* src0 = p.wsplit + (t0 * tap_stride + (static_cast<long long>(q) * p.N + n0 + n) * CK
                                  + g * 4);
  const int* nz = p.nonzero + (static_cast<long long>(t0) * (p.C / CK) + q) * (p.N / 8) +
                  (n0 + n) / 8;
  const uint32_t dst0 = w + g * B_LBO + n * 16;
  // The step's flags of this thread's column group, one load each, all in
  // flight together: bit tl for tap t0 + tl.
  uint32_t nonzero = 0;
#pragma unroll
  for (int tl = 0; tl < G::STEP_TAPS; ++tl)
    nonzero |= (__ldg(nz + tl * (p.C / CK) * (p.N / 8)) != 0 ? 1u : 0u) << tl;
#pragma unroll 1
  for (int it = 0; it < G::W_PIECES / NT; ++it) {
    const int i = tid + it * NT;
    const int part = i / (G::STEP_TAPS * 256), tl = (i >> 8) % G::STEP_TAPS;
    cp_async16(dst0 + (part * G::STEP_TAPS + tl) * W_TAP, src0 + part * part_stride + tl * tap_stride,
               (nonzero >> tl) & 1u);
  }
}

// Load chunk q of the block's halos into registers (16-byte loads): piece i
// is 4-channel group g = i % 2 of pixel (i / 2) % HP of brick i / (2 HP).
template <int KS>
__device__ __forceinline__ void load_halo(const Params& p, float4 (&v)[Geo<KS>::H_REGS],
                                          long long b0, int q, int tid) {
  using G = Geo<KS>;
#pragma unroll
  for (int j = 0; j < G::H_REGS; ++j) {
    const int i = tid + j * NT;
    const int g = i & 1, rest = i >> 1;
    const int brick = rest / G::HP, pix = rest - brick * G::HP;
    const long long b = b0 + brick;
    v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < G::H_PIECES && b < p.B)
      v[j] = __ldg(reinterpret_cast<const float4*>(p.hz + (b * G::HP + pix) * p.C + q * CK +
                                                   g * 4));
  }
}

// Split the loaded pieces and store hi and lo into halo set `h`.
template <int KS>
__device__ __forceinline__ void store_halo(const float4 (&v)[Geo<KS>::H_REGS], uint8_t* h,
                                           int tid) {
  using G = Geo<KS>;
#pragma unroll
  for (int j = 0; j < G::H_REGS; ++j) {
    const int i = tid + j * NT;
    if (i >= G::H_PIECES) continue;
    const int g = i & 1, rest = i >> 1;
    const int brick = rest / G::HP, pix = rest - brick * G::HP;
    float4 hi, lo;
    hi.x = tf32_rna(v[j].x);
    hi.y = tf32_rna(v[j].y);
    hi.z = tf32_rna(v[j].z);
    hi.w = tf32_rna(v[j].w);
    lo.x = tf32_rna(v[j].x - hi.x);
    lo.y = tf32_rna(v[j].y - hi.y);
    lo.z = tf32_rna(v[j].z - hi.z);
    lo.w = tf32_rna(v[j].w - hi.w);
    const int off = brick * G::HALO + g * G::A_LBO + pix * 16;
    *reinterpret_cast<float4*>(h + off) = hi;
    *reinterpret_cast<float4*>(h + BRICKS * G::HALO + off) = lo;
  }
}

// The epilogue of this thread's share of output row m: the column pairs
// c2 + 8*jn (jn < 16), whose sums are v[4*jn], v[4*jn + 1]; results to the
// staging row srow at columns cl + 8*jn.
template <bool FUSED>
__device__ __forceinline__ void store_row(const Params& p, long long m, int c2, const float* v,
                                          uint8_t* srow, int cl) {
  const long long o = m * p.N + c2;
  float2 oc[BN / 8], rs[BN / 8];
  if (FUSED) {
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      oc[jn] = __ldg(reinterpret_cast<const float2*>(p.occ + o + jn * 8));
      rs[jn] = p.res != nullptr ? __ldg(reinterpret_cast<const float2*>(p.res + o + jn * 8))
                                : make_float2(0.f, 0.f);
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
        v0 = __fadd_rn(v0, rs[jn].x);
        v1 = __fadd_rn(v1, rs[jn].y);
      }
      if (p.relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      v0 = __fmul_rn(v0, oc[jn].x);
      v1 = __fmul_rn(v1, oc[jn].y);
    }
    *reinterpret_cast<float2*>(srow + (cl + jn * 8) * 4) = make_float2(v0, v1);
  }
}

template <int KS, bool FUSED>
__global__ void __launch_bounds__(NT, 1) zband_tf32x3_kernel(const Params p) {
  using G = Geo<KS>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroup: bricks 2*wg and 2*wg + 1 of the block
  const long long b0 = static_cast<long long>(blockIdx.x) * BRICKS;
  const int n0 = blockIdx.y * BN;
  const uint32_t sbase = smem_addr(smem);
  const int nsteps = p.C / CK * G::STEPS;

  float acc[2][64];
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[bb][i] = 0.0f;

  float4 v[G::H_REGS];
  load_weights<KS>(p, sbase + G::W_OFFSET, 0, 0, n0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  load_halo<KS>(p, v, b0, 0, tid);
  store_halo<KS>(v, smem, tid);

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    const int q = s / G::STEPS, r = s - q * G::STEPS;
    // Step s's weights have landed; with this thread's halo stores, made
    // visible to wgmma's async proxy. After the barrier every thread's
    // copies and stores are, and every wgmma of step s-1 has completed.
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // Start staging step s+1 before step s multiplies: its weights into the
    // other weight set (last read by step s-1) and, at a chunk's last step,
    // the next chunk's halo into registers, split and stored into the other
    // halo set (last read by chunk q-1) once the wgmmas are queued.
    const int q1 = (s + 1) / G::STEPS;
    const bool next_halo = s + 1 < nsteps && q1 != q;
    if (s + 1 < nsteps) {
      load_weights<KS>(p, sbase + G::W_OFFSET + ((s + 1) & 1) * G::W_SET, q1,
                       (s + 1 - q1 * G::STEPS) * G::STEP_TAPS, n0, tid);
      asm volatile("cp.async.commit_group;\n" ::);
      if (next_halo) load_halo<KS>(p, v, b0, q1, tid);
    }
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) fence_acc(acc[bb]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t hs = sbase + (q & 1) * G::HALO_SET;
    const uint32_t ws = sbase + G::W_OFFSET + (s & 1) * G::W_SET;
#pragma unroll
    for (int tl = 0; tl < G::STEP_TAPS; ++tl) {
      const int tap = r * G::STEP_TAPS + tl;
      const int kx = tap / KS, ky = tap - kx * KS;
      const uint64_t b_hi = make_desc(ws + tl * W_TAP, B_LBO, B_SBO);
      const uint64_t b_lo = make_desc(ws + (G::STEP_TAPS + tl) * W_TAP, B_LBO, B_SBO);
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const uint32_t a = hs + (2 * wg + bb) * G::HALO + (kx * G::H + ky) * 16;
        const uint64_t a_hi = make_desc(a, G::A_LBO, G::A_SBO);
        const uint64_t a_lo = make_desc(a + BRICKS * G::HALO, G::A_LBO, G::A_SBO);
        wgmma_m64n128k8_tf32(acc[bb], a_lo, b_hi);
        wgmma_m64n128k8_tf32(acc[bb], a_hi, b_lo);
        wgmma_m64n128k8_tf32(acc[bb], a_hi, b_hi);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (next_halo) store_halo<KS>(v, smem + (q1 & 1) * G::HALO_SET, tid);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) fence_acc(acc[bb]);
  }

  // Accumulator layout of wgmma m64nN (f32): warp w of the warpgroup holds
  // rows 16w + lane/4 (+8 for the odd register pair), columns 8j + 2*(lane%4)
  // and the next one in registers 4j .. 4j+3. Each warpgroup stages its two
  // bricks' results in the freed buffers, row by row, then stores them as
  // 16-byte pieces of contiguous rows.
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  constexpr int SROW = BN * 4 + 16;  // padded staging row
  static_assert(BRICKS * BS * BS * SROW <= G::SMEM, "the staging rows fit the freed buffers");
  __syncthreads();  // both warpgroups' last wgmmas have read the buffers
  uint8_t* stage = smem + wg * (2 * BS * BS) * SROW;
#pragma unroll
  for (int bb = 0; bb < 2; ++bb) {
    if (b0 + 2 * wg + bb >= p.B) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = bb * 64 + warp * 16 + (lane >> 2) + 8 * i;
      store_row<FUSED>(p, (b0 + 2 * wg + bb) * (BS * BS) + warp * 16 + (lane >> 2) + 8 * i,
                       n0 + 2 * (lane & 3), acc[bb] + 2 * i, stage + rr * SROW, 2 * (lane & 3));
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's rows
  const int t = tid & 127;
#pragma unroll 4
  for (int e = t; e < 2 * BS * BS * (BN / 4); e += 128) {
    const int rr = e / (BN / 4), ch = e % (BN / 4);
    const long long b = b0 + 2 * wg + rr / (BS * BS);
    if (b < p.B) {
      const long long m = b0 * (BS * BS) + wg * 2 * BS * BS + rr;
      *reinterpret_cast<float4*>(p.out + m * p.N + n0 + ch * 4) =
          *reinterpret_cast<const float4*>(stage + rr * SROW + ch * 16);
    }
  }
}

template <int KS, bool FUSED>
int launch(const Params& p, cudaStream_t stream) {
  using G = Geo<KS>;
  const cudaError_t e = cudaFuncSetAttribute(
      zband_tf32x3_kernel<KS, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((p.B + BRICKS - 1) / BRICKS),
                  static_cast<unsigned>(p.N / BN));
  zband_tf32x3_kernel<KS, FUSED><<<grid, NT, G::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The shapes this kernel takes (the "wgmma_f32" route of
// sps_torch/ops/zband_conv.py): f32 operands, bs = 8, N % 128 == 0, 16-byte
// aligned, and k = 3 with C % 32 == 0, or the unfused call at k = 5 with
// C % 8 == 0 and 0 < C <= 48. wsplit is the caller's scratch of
// 2 k^2 C N floats and then k^2 (C / 8) (N / 8) ints (the block flags),
// written by zband_tf32x3_split_kernel before the conv reads it (all on
// `stream`). Returns -1 when the call does not qualify, else the
// cudaError_t of the launches. scale/bias/occ/res are read only when fused;
// res may be null.
extern "C" int sps_zband_conv_tf32x3_sm90(int fused, const float* hz, const float* wz,
                                          const float* scale, const float* bias, const float* occ,
                                          const float* res, float* out, float* wsplit,
                                          long long batch, int k, int bs, int C, int N, int relu,
                                          void* stream) {
  const bool k3 = k == 3 && C > 0 && C % 32 == 0;
  const bool k5 = k == 5 && !fused && C > 0 && C % 8 == 0 && C <= 48;
  if (bs != BS || !(k3 || k5) || N <= 0 || N % BN != 0) return -1;
  if (!aligned16(hz) || !aligned16(wz) || !aligned16(out) || !aligned16(wsplit)) return -1;
  if (fused && (!aligned16(scale) || !aligned16(bias) || !aligned16(occ) ||
                (res != nullptr && !aligned16(res))))
    return -1;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(k) * k * C * N;
  int* nonzero = reinterpret_cast<int*>(wsplit + 2 * total);
  cudaError_t e = cudaMemsetAsync(nonzero, 0, sizeof(int) * k * k * (C / CK) * (N / 8), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (total + 255) / 256;
  zband_tf32x3_split_kernel<<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048), 256, 0, s>>>(
      wz, wsplit, nonzero, k * k, C, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p;
  p.hz = hz;
  p.wsplit = wsplit;
  p.nonzero = nonzero;
  p.scale = scale;
  p.bias = bias;
  p.occ = occ;
  p.res = res;
  p.out = out;
  p.B = batch;
  p.C = C;
  p.N = N;
  p.relu = relu;
  if (k == 3) return fused ? launch<3, true>(p, s) : launch<3, false>(p, s);
  return launch<5, false>(p, s);
}
