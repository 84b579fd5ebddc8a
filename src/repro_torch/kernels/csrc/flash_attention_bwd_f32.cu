// The attention gradient's kernel (flash_attention_bwd.h) for float32
// inputs: every product on the SIMT units. bfloat16 inputs take
// flash_attention_bwd_bf16.cu.

#include "flash_attention_bwd.h"

extern "C" int flash_attention_bwd_f32_launch(
    int device, const void* q, const void* k, const void* v,
    const void* dout, void* dq, void* dk, void* dv, float* stats, int B,
    int H, int K, int Sq, int Sk, int D, const long long* strides, int causal,
    int window, int prefix, float scale, float cap, void* stream) {
  return bwd_entry<float>(device, q, k, v, dout, dq, dk, dv, stats, B, H, K,
                          Sq, Sk, D, strides, causal, window, prefix, scale,
                          cap, stream);
}
