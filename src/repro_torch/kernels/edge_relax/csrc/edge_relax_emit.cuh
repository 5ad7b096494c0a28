// The emit forms and combine monoids shared by every edge_relax kernel:
// K1 (edge_relax_tables.cu), K3 (through edge_relax_block_body.cuh) and
// K2 (edge_relax_scan.cu).  One definition, so the kernels cannot drift from
// each other or from the builtins' `emit` (repro_torch/core/programs.py,
// EMIT_FORMS).  This header defines nothing outside an anonymous
// namespace.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

// What an edge emits from its source's state (`x` = field[src]):
//   kAddWeight  x + w                 (sssp)
//   kAddConst   x + c                 (bfs: c = 1)
//   kCopy       x                     (cc, reach)
//   kMinWeight  min(x, w)             (widest)
//   kPushShare  (c * x) / divisor     (ppr, pagerank: c = 1 - alpha)
enum EmitForm : int {
  kAddWeight = 0,
  kAddConst = 1,
  kCopy = 2,
  kMinWeight = 3,
  kPushShare = 4,
};

// The scatter class of a program's monoid.
enum CombineOp : int { kMin = 0, kMax = 1, kSum = 2 };

template <typename T, int OP>
struct Combine;

template <>
struct Combine<float, kMin> {
  static __device__ __forceinline__ float ident() { return INFINITY; }
  static __device__ __forceinline__ float op(float a, float b) { return fminf(a, b); }
};
template <>
struct Combine<float, kMax> {
  static __device__ __forceinline__ float ident() { return -INFINITY; }
  static __device__ __forceinline__ float op(float a, float b) { return fmaxf(a, b); }
};
template <>
struct Combine<float, kSum> {
  static __device__ __forceinline__ float ident() { return 0.0f; }
  static __device__ __forceinline__ float op(float a, float b) { return a + b; }
};
template <>
struct Combine<int, kMin> {
  static __device__ __forceinline__ int ident() { return INT_MAX; }
  static __device__ __forceinline__ int op(int a, int b) { return min(a, b); }
};
template <>
struct Combine<int, kMax> {
  static __device__ __forceinline__ int ident() { return INT_MIN; }
  static __device__ __forceinline__ int op(int a, int b) { return max(a, b); }
};
template <>
struct Combine<int, kSum> {
  static __device__ __forceinline__ int ident() { return 0; }
  static __device__ __forceinline__ int op(int a, int b) { return a + b; }
};

// The argbest payload of combining (va, pa) on the left with (vb, pb): the
// side whose value strictly improves wins; a tie keeps the max payload.
template <typename T, int OP>
__device__ __forceinline__ int pay_rule(T va, int pa, T vb, int pb) {
  if (OP == kMin ? vb < va : vb > va) return pb;
  if (OP == kMin ? va < vb : va > vb) return pa;
  return max(pa, pb);
}

// The message of an edge from its source's state x, its weight w (read
// only by kAddWeight and kMinWeight) and its source's divisor d (read only
// by kPushShare).  Only the forms a kernel instantiates are compiled (int
// messages: kCopy only).
template <typename T, int EMIT>
__device__ __forceinline__ T emit_value(T x, float w, float d, float c) {
  if constexpr (EMIT == kAddWeight) {
    return x + w;
  } else if constexpr (EMIT == kAddConst) {
    return x + c;
  } else if constexpr (EMIT == kMinWeight) {
    return fminf(x, w);
  } else if constexpr (EMIT == kPushShare) {
    return (c * x) / d;
  } else {
    return x;
  }
}

// Whether an emit form reads the edge weight.
template <int EMIT>
constexpr bool kEmitReadsWeight = EMIT == kAddWeight || EMIT == kMinWeight;

// The message of an edge whose source vertex sits at `v` of the field
// (and divisor) and whose weight sits at `e`.
template <typename T, int EMIT>
__device__ __forceinline__ T emit_message(const T* __restrict__ field,
                                          const float* __restrict__ divisor,
                                          long long v,
                                          const float* __restrict__ weight,
                                          long long e, float c) {
  float w = 0.0f, d = 1.0f;
  if constexpr (kEmitReadsWeight<EMIT>) w = weight[e];
  if constexpr (EMIT == kPushShare) d = divisor[v];
  return emit_value<T, EMIT>(field[v], w, d, c);
}

}  // namespace
