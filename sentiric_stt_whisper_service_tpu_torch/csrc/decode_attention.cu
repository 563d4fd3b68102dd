// K3: single-token (q_len = 1) attention over a KF-layout slab
// [S, H, 64, F], one templated kernel for two slab forms:
//   * bf16 slab, optional causal bound pos[s]  (plain form)
//   * int8 slab with per-position scales       (int8 form)
// K4, the packed int4 form, is csrc/decode_attention_i4.cu.
//
// Replaces the Pallas TPU kernels ops/decode_attention.py:_plain_kernel and
// _quant_kernel, launched by decode_attention (pallas_call at
// ops/decode_attention.py:146). The plain PyTorch version is
// ops/decode_attention.py:decode_attention_reference in this package, which
// is also what the JAX production path calls for this step.
//
// The kernel is csrc/slab_attention.cuh's slab_attention_kernel with one
// query row (M = 1): what it computes, what bounds it on the H100 and how it
// is laid out are written there. Per (item s, head h):
//   score[f] = (q . k[:, f]) * scale * k_scale[f]    (f <= pos[s] if given)
//   w[f]     = softmax(score)[f] * v_scale[f]
//   out[d]   = sum_f w[f] * v[d, f]                  (fp32, stored as bf16)

#include "slab_attention.cuh"

extern "C" int sstw_decode_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* pos, void* out, int S, int H, int F,
                                          float scale, void* stream) {
  return slab::launch<slab::kBf16, 1>(q, k, v, nullptr, nullptr, pos, out, S, H, F, 1, scale,
                                      stream);
}

extern "C" int sstw_decode_attention_i8(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* pos, void* out, int S, int H, int F,
                                        float scale, void* stream) {
  return slab::launch<slab::kInt8, 1>(q, k, v, k_scale, v_scale, pos, out, S, H, F, 1, scale,
                                      stream);
}
