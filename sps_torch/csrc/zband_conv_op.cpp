// PyTorch binding of the port's CUDA kernels: the z-band kernels in
// zband_conv.cu (route 0, WMMA), zband_conv_sm90.cu (route 1, wgmma at
// k = 3), zband_conv_k5_sm90.cu (route 2, wgmma at the k = 5 stem,
// unfused only), zband_conv_tf32x3_sm90.cu (route 3, f32 on 3xTF32 wgmma
// at both) and zband_conv_k5_wide_sm90.cu (route 4, wgmma at the k = 5 stem
// at C = 48, unfused only), and the int8 brick conv in brick_conv_int8.cu (its gather
// and halo forms): registers torch.ops.sps_torch.zband_conv,
// zband_conv_fused, brick_conv_int8_gather and brick_conv_int8 for CUDA
// tensors. The kernel files
// have plain C entry points and no PyTorch headers; this file includes only
// the operator registry and one ATen operator, so all build in seconds
// (sps_torch/ops/zband_conv.py).
//
// The caller passes the route (zband_conv.route picks it from the shape), the
// CUDA stream to launch on (the current stream, as an integer handle) and
// makes the tensors' device current. A route that does not take the call's
// shape raises; nothing reroutes.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <torch/library.h>

extern "C" int sps_zband_conv(int dtype, int fused, const void* hz, const void* wz,
                              const float* scale, const float* bias, const void* occ,
                              const void* res, void* out, long long batch, int k, int bs,
                              int C, int N, int relu, void* stream);
extern "C" int sps_zband_conv_sm90(int fused, const void* hz, const void* wz, const float* scale,
                                   const float* bias, const void* occ, const void* res, void* out,
                                   long long batch, int k, int bs, int C, int N, int relu,
                                   void* stream);
extern "C" int sps_zband_conv_k5_sm90(const void* hz, const void* wz, void* out, long long batch,
                                      int k, int bs, int C, int N, void* stream);
extern "C" int sps_zband_conv_k5_wide_sm90(const void* hz, const void* wz, void* out,
                                           long long batch, int k, int bs, int C, int N,
                                           void* stream);
extern "C" int sps_zband_conv_tf32x3_sm90(int fused, const float* hz, const float* wz,
                                          const float* scale, const float* bias, const float* occ,
                                          const float* res, float* out, float* wsplit,
                                          long long batch, int k, int bs, int C, int N, int relu,
                                          void* stream);
extern "C" int sps_brick_conv_int8(const void* h8, const void* wt, const float* scale, void* out,
                                   long long batch, int C, int N, int out_bf16, void* stream);
extern "C" int sps_brick_conv_int8_gather(const void* q8, const int* nbr27, const void* wt,
                                          const float* scale, void* out, long long batch, int C,
                                          int N, int out_bf16, void* stream);

namespace {

void check_operand(const at::Tensor& t, const at::Tensor& hz, const char* name) {
  TORCH_CHECK(t.device() == hz.device(), name, " is not on hz's device");
  TORCH_CHECK(t.is_contiguous(), name, " is not contiguous");
}

at::Tensor launch(const at::Tensor& hz, const at::Tensor& wz, const at::Tensor* scale,
                  const at::Tensor* bias, const at::Tensor* occ, const at::Tensor* res,
                  int64_t k, int64_t bs, bool relu, int64_t route, int64_t stream) {
  TORCH_CHECK(route >= 0 && route <= 4,
              "route must be 0 (wmma), 1 (wgmma), 2 (wgmma_k5), 3 (wgmma_f32) or 4 "
              "(wgmma_k5_wide)");
  TORCH_CHECK(hz.is_cuda(), "zband kernels take CUDA tensors");
  const bool bf16 = hz.scalar_type() == at::kBFloat16;
  TORCH_CHECK(bf16 || hz.scalar_type() == at::kFloat, "hz must be float32 or bfloat16");
  const int64_t h = bs + k - 1;
  TORCH_CHECK(hz.dim() == 4 && hz.size(1) == h && hz.size(2) == h, "hz must be (B, h, h, C)");
  const int64_t b = hz.size(0), c = hz.size(3);
  TORCH_CHECK(wz.dim() == 4 && wz.size(0) == k && wz.size(1) == k && wz.size(2) == c,
              "wz must be (k, k, C, N)");
  const int64_t n = wz.size(3);
  TORCH_CHECK(n % bs == 0, "wz's N must be a multiple of bs");
  check_operand(hz, hz, "hz");
  check_operand(wz, hz, "wz");
  TORCH_CHECK(wz.scalar_type() == hz.scalar_type(), "wz's dtype differs from hz's");
  const bool fused = scale != nullptr;
  if (fused) {
    for (const at::Tensor* t : {scale, bias}) {
      check_operand(*t, hz, "scale/bias");
      TORCH_CHECK(t->scalar_type() == at::kFloat && t->dim() == 1 && t->size(0) == n,
                  "scale/bias must be f32 (N,)");
    }
    for (const at::Tensor* t : {occ, res}) {
      if (t == nullptr) continue;
      check_operand(*t, hz, "occ/res");
      TORCH_CHECK(t->scalar_type() == hz.scalar_type(), "occ/res dtype differs from hz's");
      TORCH_CHECK(t->dim() == 4 && t->size(0) == b && t->size(1) == bs && t->size(2) == bs &&
                      t->size(3) == n,
                  "occ/res must be (B, bs, bs, N)");
    }
  }
  at::Tensor out = at::empty({b, bs, bs, n}, hz.options());
  const float* sc = fused ? scale->data_ptr<float>() : nullptr;
  const float* bi = fused ? bias->data_ptr<float>() : nullptr;
  const void* oc = fused ? occ->data_ptr() : nullptr;
  const void* rs = res != nullptr ? res->data_ptr() : nullptr;
  int err;
  if (route == 1) {
    TORCH_CHECK(bf16, "route wgmma takes bfloat16 only");
    err = sps_zband_conv_sm90(fused ? 1 : 0, hz.data_ptr(), wz.data_ptr(), sc, bi, oc, rs,
                              out.data_ptr(), b, static_cast<int>(k), static_cast<int>(bs),
                              static_cast<int>(c), static_cast<int>(n), relu ? 1 : 0,
                              reinterpret_cast<void*>(stream));
    TORCH_CHECK(err != -1, "route wgmma does not take this call: it needs k = 3, bs = 8, ",
                "C % 32 == 0, N % 128 == 0 and 16-byte aligned operands");
  } else if (route == 2) {
    TORCH_CHECK(bf16, "route wgmma_k5 takes bfloat16 only");
    TORCH_CHECK(!fused, "route wgmma_k5 takes the unfused conv only");
    err = sps_zband_conv_k5_sm90(hz.data_ptr(), wz.data_ptr(), out.data_ptr(), b,
                                 static_cast<int>(k), static_cast<int>(bs), static_cast<int>(c),
                                 static_cast<int>(n), reinterpret_cast<void*>(stream));
    TORCH_CHECK(err != -1, "route wgmma_k5 does not take this call: it needs k = 5, bs = 8, ",
                "C % 8 == 0 with C <= 24, N % 128 == 0 and 16-byte aligned operands");
  } else if (route == 3) {
    TORCH_CHECK(!bf16, "route wgmma_f32 takes float32 only");
    // The kernel's scratch: the weight split into TF32 hi and lo, K-major,
    // then one int flag per 8 x 8 block of the weight (its all-zero blocks
    // are not read).
    at::Tensor wsplit = at::empty({2 * k * k * c * n + k * k * (c / 8) * (n / 8)}, hz.options());
    err = sps_zband_conv_tf32x3_sm90(
        fused ? 1 : 0, hz.data_ptr<float>(), wz.data_ptr<float>(), sc, bi,
        fused ? occ->data_ptr<float>() : nullptr,
        res != nullptr ? res->data_ptr<float>() : nullptr, out.data_ptr<float>(),
        wsplit.data_ptr<float>(), b, static_cast<int>(k), static_cast<int>(bs),
        static_cast<int>(c), static_cast<int>(n), relu ? 1 : 0, reinterpret_cast<void*>(stream));
    TORCH_CHECK(err != -1, "route wgmma_f32 does not take this call: it needs bs = 8, ",
                "N % 128 == 0, 16-byte aligned operands and k = 3 with C % 32 == 0, or the ",
                "unfused call at k = 5 with C % 8 == 0 and C <= 48");
  } else if (route == 4) {
    TORCH_CHECK(bf16, "route wgmma_k5_wide takes bfloat16 only");
    TORCH_CHECK(!fused, "route wgmma_k5_wide takes the unfused conv only");
    err = sps_zband_conv_k5_wide_sm90(hz.data_ptr(), wz.data_ptr(), out.data_ptr(), b,
                                      static_cast<int>(k), static_cast<int>(bs),
                                      static_cast<int>(c), static_cast<int>(n),
                                      reinterpret_cast<void*>(stream));
    TORCH_CHECK(err != -1, "route wgmma_k5_wide does not take this call: it needs k = 5, ",
                "bs = 8, C = 48, N % 128 == 0 and 16-byte aligned operands");
  } else {
    err = sps_zband_conv(bf16 ? 1 : 0, fused ? 1 : 0, hz.data_ptr(), wz.data_ptr(), sc, bi, oc,
                         rs, out.data_ptr(), b, static_cast<int>(k), static_cast<int>(bs),
                         static_cast<int>(c), static_cast<int>(n), relu ? 1 : 0,
                         reinterpret_cast<void*>(stream));
  }
  TORCH_CHECK(err == 0, "zband kernel launch failed (route ", route, "): cudaError ", err);
  return out;
}

at::Tensor zband_conv(const at::Tensor& hz, const at::Tensor& wz, int64_t k, int64_t bs,
                      int64_t route, int64_t stream) {
  return launch(hz, wz, nullptr, nullptr, nullptr, nullptr, k, bs, false, route, stream);
}

at::Tensor zband_conv_fused(const at::Tensor& hz, const at::Tensor& wz, const at::Tensor& scale,
                            const at::Tensor& bias, const at::Tensor& occ,
                            const std::optional<at::Tensor>& res, int64_t k, int64_t bs,
                            bool relu, int64_t route, int64_t stream) {
  return launch(hz, wz, &scale, &bias, &occ, res.has_value() ? &*res : nullptr, k, bs, relu,
                route, stream);
}

// h8 (B, 10, 10, 10, C) and wt (3, 3, 3, N, C) int8, scale (N,) f32; returns
// (B, 8, 8, 8, N) in bf16 or f32. A shape the kernel does not take raises.
at::Tensor brick_conv_int8(const at::Tensor& h8, const at::Tensor& wt, const at::Tensor& scale,
                           bool out_bf16, int64_t stream) {
  TORCH_CHECK(h8.is_cuda(), "brick_conv_int8 takes CUDA tensors");
  TORCH_CHECK(h8.scalar_type() == at::kChar && wt.scalar_type() == at::kChar,
              "h8 and wt must be int8");
  TORCH_CHECK(h8.dim() == 5 && h8.size(1) == 10 && h8.size(2) == 10 && h8.size(3) == 10,
              "h8 must be (B, 10, 10, 10, C)");
  const int64_t b = h8.size(0), c = h8.size(4);
  TORCH_CHECK(wt.dim() == 5 && wt.size(0) == 3 && wt.size(1) == 3 && wt.size(2) == 3 &&
                  wt.size(4) == c,
              "wt must be (3, 3, 3, N, C)");
  const int64_t n = wt.size(3);
  check_operand(h8, h8, "h8");
  check_operand(wt, h8, "wt");
  check_operand(scale, h8, "scale");
  TORCH_CHECK(scale.scalar_type() == at::kFloat && scale.dim() == 1 && scale.size(0) == n,
              "scale must be f32 (N,)");
  at::Tensor out =
      at::empty({b, 8, 8, 8, n}, h8.options().dtype(out_bf16 ? at::kBFloat16 : at::kFloat));
  const int err = sps_brick_conv_int8(h8.data_ptr(), wt.data_ptr(), scale.data_ptr<float>(),
                                      out.data_ptr(), b, static_cast<int>(c),
                                      static_cast<int>(n), out_bf16 ? 1 : 0,
                                      reinterpret_cast<void*>(stream));
  TORCH_CHECK(err != -1, "brick_conv_int8 does not take this call: it needs C % 16 == 0 with ",
              "16 <= C <= 128, N == 16 or N % 32 == 0, and 16-byte aligned operands");
  TORCH_CHECK(err == 0, "brick_conv_int8 launch failed: cudaError ", err);
  return out;
}

// q8 (Bq, 8, 8, 8, C) int8 codes, nbr27 (27, B) int32 neighbour rows (-1
// where absent; every row below Bq, unchecked: checking would wait for the
// device), wt (3, 3, 3, N, C) int8, scale (N,) f32; returns
// (B, 8, 8, 8, N) in bf16 or f32. A shape the kernel does not take raises.
at::Tensor brick_conv_int8_gather(const at::Tensor& q8, const at::Tensor& nbr27,
                                  const at::Tensor& wt, const at::Tensor& scale, bool out_bf16,
                                  int64_t stream) {
  TORCH_CHECK(q8.is_cuda(), "brick_conv_int8_gather takes CUDA tensors");
  TORCH_CHECK(q8.scalar_type() == at::kChar && wt.scalar_type() == at::kChar,
              "q8 and wt must be int8");
  TORCH_CHECK(nbr27.scalar_type() == at::kInt, "nbr27 must be int32");
  TORCH_CHECK(q8.dim() == 5 && q8.size(1) == 8 && q8.size(2) == 8 && q8.size(3) == 8,
              "q8 must be (Bq, 8, 8, 8, C)");
  TORCH_CHECK(nbr27.dim() == 2 && nbr27.size(0) == 27, "nbr27 must be (27, B)");
  const int64_t b = nbr27.size(1), c = q8.size(4);
  TORCH_CHECK(wt.dim() == 5 && wt.size(0) == 3 && wt.size(1) == 3 && wt.size(2) == 3 &&
                  wt.size(4) == c,
              "wt must be (3, 3, 3, N, C)");
  const int64_t n = wt.size(3);
  check_operand(q8, q8, "q8");
  check_operand(nbr27, q8, "nbr27");
  check_operand(wt, q8, "wt");
  check_operand(scale, q8, "scale");
  TORCH_CHECK(scale.scalar_type() == at::kFloat && scale.dim() == 1 && scale.size(0) == n,
              "scale must be f32 (N,)");
  at::Tensor out =
      at::empty({b, 8, 8, 8, n}, q8.options().dtype(out_bf16 ? at::kBFloat16 : at::kFloat));
  const int err = sps_brick_conv_int8_gather(
      q8.data_ptr(), nbr27.data_ptr<int>(), wt.data_ptr(), scale.data_ptr<float>(),
      out.data_ptr(), b, static_cast<int>(c), static_cast<int>(n), out_bf16 ? 1 : 0,
      reinterpret_cast<void*>(stream));
  TORCH_CHECK(err != -1, "brick_conv_int8_gather does not take this call: it needs C % 16 == 0 ",
              "with 16 <= C <= 128, N == 16 or N % 32 == 0, and 16-byte aligned operands");
  TORCH_CHECK(err == 0, "brick_conv_int8_gather launch failed: cudaError ", err);
  return out;
}

}  // namespace

TORCH_LIBRARY(sps_torch, m) {
  m.def("zband_conv(Tensor hz, Tensor wz, int k, int bs, int route, int stream) -> Tensor");
  m.def(
      "zband_conv_fused(Tensor hz, Tensor wz, Tensor scale, Tensor bias, Tensor occ, "
      "Tensor? res, int k, int bs, bool relu, int route, int stream) -> Tensor");
  m.def("brick_conv_int8(Tensor h8, Tensor wt, Tensor scale, bool out_bf16, int stream) -> Tensor");
  m.def(
      "brick_conv_int8_gather(Tensor q8, Tensor nbr27, Tensor wt, Tensor scale, bool out_bf16, "
      "int stream) -> Tensor");
}

TORCH_LIBRARY_IMPL(sps_torch, CUDA, m) {
  m.impl("zband_conv", &zband_conv);
  m.impl("zband_conv_fused", &zband_conv_fused);
  m.impl("brick_conv_int8", &brick_conv_int8);
  m.impl("brick_conv_int8_gather", &brick_conv_int8_gather);
}
