// The emit forms and combine monoids shared by every edge_relax kernel:
// K1 (edge_relax_tables.cu), K3 (through edge_relax_block_body.cuh) and
// K2 (edge_relax_scan.cu).  One definition, so the kernels cannot drift from
// each other or from the builtins' `emit` (repro_torch/core/programs.py,
// EMIT_FORMS).  This header defines nothing outside an anonymous
// namespace.
//
// The generic instance (kGeneric, kGenComb): a library built with
// -DREPRO_GENERIC -DREPRO_GEN_HEADER="<file>" includes the header that
// kernels/edge_relax/emitgen.py generated for one program — GenPtrs (the
// pointers of the state fields it reads) and namespace gen: its message
// type (float for 16-bit messages, held widened and exact) and the
// tensors' element type (Store), monoid class, record layouts, identity,
// combine op, pack() (a source vertex's record: the values emit's
// edge-dependent part reads, the payload) and emit() (an edge's message
// from that record, its weight and dst_gid).  Other builds see the stub
// below, which no instance they compile reaches.

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
  kGeneric = 5,      // the generated gen::emit
};

// The scatter class of a program's monoid; kGenComb is the generated
// combine (gen::op and gen::ident) of the class gen::kKind.
enum CombineOp : int { kMin = 0, kMax = 1, kSum = 2, kGenComb = 3 };

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

}  // namespace

#ifdef REPRO_GENERIC
#include REPRO_GEN_HEADER
#else
#define REPRO_GEN_HAS_EMIT 0
namespace {
constexpr int kGenFields = 1;
struct GenPtrs {
  const void* f[kGenFields];
};
namespace gen {
using Msg = float;
using Store = float;
__device__ __forceinline__ Store to_store(Msg v) { return v; }
__device__ __forceinline__ Msg from_store(Store v) { return v; }
constexpr int kKind = kMin;
constexpr bool kNativeIdent = true;
constexpr bool kPay = false;
constexpr int kWords = 0;
constexpr int kPayWord = -1;
constexpr int kRecK1 = 2;
constexpr int kGroupK2 = 4;
constexpr int kRecK2 = 8;
constexpr bool kReadsWeight = false;
constexpr bool kReadsDstGid = false;
__device__ __forceinline__ Msg ident() { return 0.0f; }
__device__ __forceinline__ Msg op(Msg a, Msg) { return a; }
__device__ __forceinline__ void pack(const GenPtrs&, long long, int, int*) {}
__device__ __forceinline__ Msg emit(const int*, float, int) { return 0.0f; }
}  // namespace gen
}  // namespace
#endif

namespace {

template <typename T>
struct Combine<T, kGenComb> {
  static __device__ __forceinline__ T ident() { return gen::ident(); }
  static __device__ __forceinline__ T op(T a, T b) { return gen::op(a, b); }
};

// A message tensor's element and the conversions to and from the working
// type T: T itself for the fixed instances, gen::Store for the generic one
// (GEN), whose 16-bit messages are exact in T and narrow exactly.
template <typename T, bool GEN>
struct MsgStore {
  using S = T;
  static __device__ __forceinline__ S put(T v) { return v; }
  static __device__ __forceinline__ T get(S v) { return v; }
};
template <typename T>
struct MsgStore<T, true> {
  using S = gen::Store;
  static __device__ __forceinline__ S put(T v) { return gen::to_store(v); }
  static __device__ __forceinline__ T get(S v) { return gen::from_store(v); }
};

// The argbest payload of combining (va, pa) on the left with (vb, pb): the
// side whose value strictly improves wins; a tie keeps the max payload.
template <typename T, int OP>
__device__ __forceinline__ int pay_rule(T va, int pa, T vb, int pb) {
  constexpr int K = OP == kGenComb ? gen::kKind : OP;
  if (K == kMin ? vb < va : vb > va) return pb;
  if (K == kMin ? va < vb : va > vb) return pa;
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
constexpr bool kEmitReadsWeight = EMIT == kAddWeight || EMIT == kMinWeight ||
                                  (EMIT == kGeneric && gen::kReadsWeight);

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
