// Kernel B5: every layer of the encoder in one call (sm_90a).
//
//   vpt_vit_encoder_forward  replaces vit_pruning_tpu/ops/pallas/model.py
//                            ::fused_vit_encoder
//
// The TPU kernel kept the activation block and all L layers' weights
// resident in VMEM (DeiT-S: 42.5 MB in bf16) and read x from HBM once and
// wrote it once. An SM has 227 KB, so here the layer loop runs on the host
// side of one C call, with no Python between layers: each layer is B1's
// sequence of launches (LN -> QKV GEMM -> attention -> O GEMM -> LN -> fc1
// GEMM -> fc2 GEMM, each GEMM with its bias / GELU / residual / cast in the
// epilogue), and the residual stream stays in an f32 buffer from the first
// layer to the last, as it stayed f32 in VMEM. x is read in its dtype once
// (layer 0's LN and its O-GEMM residual) and the output written once (the
// last fc2 GEMM's epilogue).
//
// What bounds it on an H100: at batch 512 the layer products are well above
// the bf16 ridge, so tensor-core throughput; the f32 residual adds 8 bytes a
// value per layer of traffic (read and write) that B1's bf16 x does not.
//
// Numerics kept from the TPU kernel, where they differ from B1's: the
// softmax is normalised, P = exp(l - max) / rowsum rounded to x's dtype
// before PV (B1 rounds the unnormalised numerators and scales after PV);
// GELU is the erf form in every dtype (B1 takes tanh in bf16); the residual
// is never rounded between layers. LN in f32, QKV and ctx rounded to x's
// dtype, products accumulated in f32 with the bias added before the cast,
// masked keys at -1e30, as in B1. The TPU kernel's erf is a polynomial
// (|err| <= 1.5e-7); this one is the device's erff.
//
// Limits: B1's (head dim 16, 32, 64 or 80, any S, D and M multiples of 8); one
// key mask [B, S] or none, the same at every layer. A persistent one-launch
// kernel is later work.

#include "common.cuh"

namespace vpt {

template <typename T>
cudaError_t encoder_forward(const T* x, const unsigned char* mask, const T* ln1g, const T* ln1b,
                            const T* wqkv, const T* bqkv, const T* wo, const T* bo, const T* ln2g,
                            const T* ln2b, const T* w1, const T* b1, const T* w2, const T* b2,
                            T* out, T* h, T* qkv, T* ctx, float* x1, T* m1, float* xr, int L, int B,
                            int S, int D, int H, int HD, int M, float eps, cudaStream_t st) {
  const int rows = B * S, KW = H * HD;
  for (int l = 0; l < L; ++l) {
    const bool first = l == 0, last = l == L - 1;
    const long ld = (long)l * D, lm = (long)l * M, lq = (long)l * 3 * KW;
    if (first)
      VPT_TRY(layer_norm<T, T>(x, D, ln1g, ln1b, h, D, rows, D, eps, st));
    else
      VPT_TRY(layer_norm<float, T>(xr, D, ln1g + ld, ln1b + ld, h, D, rows, D, eps, st));
    VPT_TRY(gemm(h, D, wqkv + lq * D, rows, 3 * KW, D,
                 epi(bqkv + lq, ACT_NONE, nullptr, 0, false, qkv, 3 * KW, false), st));
    VPT_TRY(attention(qkv, mask, nullptr, ctx, B, S, H, KW, st, true));
    // x1 = (ctx @ wo + bo) + x: the residual is x itself (T) at layer 0, the
    // f32 stream after it
    const void* res = first ? static_cast<const void*>(x) : static_cast<const void*>(xr);
    VPT_TRY(gemm(ctx, KW, wo + (long)l * KW * D, rows, D, KW,
                 epi(bo + ld, ACT_NONE, res, D, !first, x1, D, true), st));
    VPT_TRY(layer_norm<float, T>(x1, D, ln2g + ld, ln2b + ld, h, D, rows, D, eps, st));
    VPT_TRY(gemm(h, D, w1 + lm * D, rows, M, D,
                 epi(b1 + lm, ACT_GELU_ERF, nullptr, 0, false, m1, M, false), st));
    // x = (m1 @ w2 + b2) + x1, into the f32 stream, or cast once into out
    void* dst = last ? static_cast<void*>(out) : static_cast<void*>(xr);
    VPT_TRY(gemm(m1, M, w2 + lm * D, rows, D, M, epi(b2 + ld, ACT_NONE, x1, D, true, dst, D, !last),
                 st));
  }
  return cudaSuccess;
}

}  // namespace vpt

using namespace vpt;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mask: [B, S] bytes (torch.bool) or null,
// applied at every layer. Weights stacked on a leading [L] axis: ln1/ln2
// g, b [L, D]; wqkv [L, D, 3KW], bqkv [L, 3KW]; wo [L, KW, D], bo [L, D];
// w1 [L, D, M], b1 [L, M]; w2 [L, M, D], b2 [L, D], all in the dtype.
// Workspaces: h [B*S, D], qkv [B*S, 3KW], ctx [B*S, KW], m1 [B*S, M] in the
// dtype; x1 and xr [B*S, D] float32. out [B, S, D] in the dtype.
int vpt_vit_encoder_forward(int dtype, const void* x, const void* mask, const void* ln1g,
                            const void* ln1b, const void* wqkv, const void* bqkv, const void* wo,
                            const void* bo, const void* ln2g, const void* ln2b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* out, void* h,
                            void* qkv, void* ctx, void* x1, void* m1, void* xr, int L, int B, int S,
                            int D, int H, int HD, int M, float eps, void* stream) {
  if (!shapes_ok(dtype, B, S, D, H, HD, M) || L < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
#define VPT_ENCODER(T)                                                                            \
  encoder_forward<T>((const T*)x, mk, (const T*)ln1g, (const T*)ln1b, (const T*)wqkv,             \
                     (const T*)bqkv, (const T*)wo, (const T*)bo, (const T*)ln2g, (const T*)ln2b,  \
                     (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (T*)out, (T*)h,      \
                     (T*)qkv, (T*)ctx, (float*)x1, (T*)m1, (float*)xr, L, B, S, D, H, HD, M, eps, st)
  return dtype == 0 ? VPT_ENCODER(float) : VPT_ENCODER(bf16);
#undef VPT_ENCODER
}

}  // extern "C"
