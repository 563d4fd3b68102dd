// Constants and slab forms shared by the kernels that read KF-layout slabs
// [S, H, 64, F] or slot caches with 64-channel heads: K3
// (csrc/decode_attention.cu), K5 (csrc/beam_attention.cu) and K6
// (csrc/beam_cross_attention.cu). K4 (csrc/decode_attention_i4.cu) keeps its
// own. The slab forms:
//   * kBf16: bf16 elements (K3, K5, K6);
//   * kInt8: int8 elements with per-position (K3, K6) or per-row (K5) scales;
//   * kInt4: the packed int4 carrier with per-position scales (K6; K4 reads
//     it too): byte j of a row holds position j in its low nibble and
//     position j + F/2 in its high nibble (ops/quant._pack_nibbles).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slab {
namespace {  // internal linkage: each .cu that includes this has its own copy

constexpr int HD = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;  // the JAX package's mask value
constexpr int MAX_DYNAMIC_SMEM = 200 * 1024;  // of the 227 KB a block may use

enum Form { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

}  // namespace
}  // namespace slab
