// Kernel B6: multi-head attention on q, k, v [B, H, S, hd], all in f32
// (sm_90a).
//
//   vpt_attention_forward  replaces vit_pruning_tpu/ops/pallas/attention.py
//                          ::fused_attention
//
// out = softmax(q k^T / sqrt(hd), masked keys at -1e30) v: q, k and v are
// read in their dtype (f32 or bf16) and upcast, the logits, the softmax (max,
// exp, sum, then P normalised) and PV are f32, and the output is cast once to
// q's dtype. The TPU kernel took one image per grid step and every head of
// it in VMEM; here common.cuh's attention_f32 (B1's f32 attention, with the
// head dim read at run time) takes one (head, image) per block.
//
// What bounds it on an H100: the contract is f32 arithmetic. At DeiT-S width
// (hd 64, S 197) the two products are ~2 S^2 hd FMAs per head against 4 S hd
// values moved, far above the ridge. The first product's inputs are exact
// in bf16 when q and k are bf16, so bf16 tensor cores with f32 accumulation
// could take it; P is unrounded f32, so PV needs the FP32 rate (67 TFLOP/s)
// or a 3xTF32 split. FMA tiles from shared memory are the simple first
// version; both of those are later work.

#include "common.cuh"

namespace vpt {
constexpr int kAttnMaxSeq = 257;   // ViT-H at 224 (16 x 16 patches + CLS)
constexpr int kAttnMaxHD = 128;
}  // namespace vpt

using namespace vpt;

extern "C" {

int vpt_attention_max_seq_len() { return kAttnMaxSeq; }

int vpt_attention_max_head_dim() { return kAttnMaxHD; }

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out [B, H, S, HD] contiguous
// in the dtype; mask [B, S] bytes (torch.bool) or null.
int vpt_attention_forward(int dtype, const void* q, const void* k, const void* v, const void* mask,
                          void* out, int B, int H, int S, int HD, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || B > 65535 || H < 1 || S < 1 || S > kAttnMaxSeq ||
      HD < 1 || HD > kAttnMaxHD)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  const AttnLayout lay{(long)H * S * HD, (long)S * HD, HD};
  if (dtype == 0)
    return attention_f32<float, 0, true>((const float*)q, (const float*)k, (const float*)v, lay, mk,
                                         nullptr, (float*)out, lay, B, H, S, HD, st);
  return attention_f32<bf16, 0, true>((const bf16*)q, (const bf16*)k, (const bf16*)v, lay, mk,
                                      nullptr, (bf16*)out, lay, B, H, S, HD, st);
}

}  // extern "C"
