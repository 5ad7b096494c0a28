// edge_relax_scan (K2): the emit over each compute cell's destination-sorted
// stream, then a deterministic segmented inclusive scan of (value, sending
// count[, argbest payload]) that resets wherever the structural key
// changes.  Element e of the output holds the combine of its destination's
// run up to e; the run-end gather (phase 2) happens outside.
//
// Replaces the Pallas TPU kernel repro/kernels/edge_relax/kernel.py
// :: edge_relax_scan (body _scan_kernel, scan ref.stream_scan), for the
// whole function it computes: every monoid class (sum, min, max), f32
// messages under the five emit forms of edge_relax_emit.cuh and i32
// messages under the copy form, the argbest payload, and multi-query
// lanes.
//
// Rows.  The grid's y axis walks the rows (cell, lane) of the
// lane-stacked layout: vertex state and senders are [S, L, Np], outputs
// [S, L, E]; the edge streams key/skey/src/weight/gid are [S, ...] and
// shared by a cell's L lanes (each lane re-reads them; reading the stream
// once for all lanes is later work).  A solo query is L = 1.
//
// Association order — fixed by the stream length and kTile alone, never by
// lanes, launch order or frontier (so a sum is reproducible bit for bit, a
// lane equals the same query run solo, and the plain version
// ref.stream_scan runs the same order):
//   (a) scan_tiles: per tile of kTile = 1024 elements, one CTA of 1024
//       threads runs a Hillis–Steele tree in shared memory (step d combines
//       element i with i - d, the left operand first);
//   (b) carry: one warp per row folds the tile aggregates sequentially in
//       tile order (carry_j = agg_{j-1} if tile j-1 holds a run start,
//       else carry_{j-1} (+) agg_{j-1});
//   (c) apply_carry: each tile's leading open run (the elements before its
//       first run start) combines the carry on the left.
// Every combine takes the right operand at a run start; the payload follows
// pay_rule (the strictly better value wins, a tie keeps the max payload).
// No float atomics anywhere.
//
// Bound: memory.  Per edge and row it reads key, skey, src (12 B; weight
// 4 B more for the forms that read it) and writes the scanned value, count
// and payload (8-12 B); the gathers of senders / the emit fields / gid hit
// the vertex block, Np * 9-13 B per row.  Time >= bytes / 3.35 TB/s.  The
// in-tile tree keeps the partials in shared memory; pass (b) reads one
// aggregate per tile and pass (c) touches only the leading open runs.
//
// Input modes (template MODE of scan_tiles, same tile/tree/carry order, so
// each is bitwise ref.stream_scan of its messages):
//   * emit (edge_relax_scan_launch; MODE = the EmitForm): gathers the
//     senders and the emit fields at src and emits the message itself —
//     the dense pull sweep;
//   * pre-emitted (edge_relax_scan_pre_launch; MODE = kPre): reads the
//     message, send and payload streams that the push sweep scattered back
//     into the destination-sorted layout (ref.edge_relax_push_stream).
//
// Compile without fast math: push_share's division must be IEEE.

#include <cuda_runtime.h>

#include "edge_relax_emit.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kPre = -1;  // MODE of the pre-emitted input

struct ScanArgs {
  // emit mode: the vertex block ([S, L, Np] field/divisor/senders, [S, Np]
  // gid) and the edge streams ([S, stride] rows: key, src, weight)
  const void* field;
  const float* divisor;
  const bool* senders;
  const int* gid;
  const int* key;
  const int* src;
  const float* weight;
  // pre-emitted mode: [S * L, msg_stride] rows of cand / send / pay
  const void* cand;
  const bool* send;
  const int* pay_in;
  // both: the structural key ([S, stride] rows) and the outputs
  // ([S * L, es]) and scratch ([S * L, nt] each)
  const int* skey;
  void* v_out;
  int* c_out;
  int* p_out;
  void* agg_v;
  int* agg_c;
  int* agg_p;
  int* first;
  void* carry_v;
  int* carry_c;
  int* carry_p;
  int lanes;
  int np;
  long long stride;
  long long msg_stride;
  int es;
  float emit_const;
};

template <typename T, int OP, int MODE, bool PAY>
__global__ void __launch_bounds__(kTile) scan_tiles(ScanArgs a) {
  using C = Combine<T, OP>;
  __shared__ T sv[kTile];
  __shared__ int sc[kTile];
  __shared__ int sf[kTile];
  __shared__ int sp[PAY ? kTile : 1];
  __shared__ int s_first;

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int row = blockIdx.y;  // cell * lanes + lane
  const int cell = row / a.lanes;
  const int nt = gridDim.x;
  const int i = tile * kTile + t;
  const long long e = cell * a.stride + i;

  T v = C::ident();
  int c = 0;
  int p = -1;
  int f = 1;  // padding past the region counts as a run start
  if (i < a.es) {
    f = (i == 0) || (a.skey[e] != a.skey[e - 1]);
    if constexpr (MODE == kPre) {
      const long long m = row * a.msg_stride + i;
      v = static_cast<const T*>(a.cand)[m];
      c = a.send[m] ? 1 : 0;
      if constexpr (PAY) p = a.pay_in[m];
    } else if (a.key[e] >= 0) {
      const int s = a.src[e];
      const long long vb = (long long)row * a.np + s;
      if (a.senders[vb]) {
        v = emit_message<T, MODE>(static_cast<const T*>(a.field), a.divisor,
                                  vb, a.weight, e, a.emit_const);
        c = 1;
        if constexpr (PAY) p = a.gid[(long long)cell * a.np + s];
      }
    }
  }
  if (t == 0) s_first = kTile;
  sv[t] = v;
  sc[t] = c;
  sf[t] = f;
  if constexpr (PAY) sp[t] = p;
  __syncthreads();
  if (f) atomicMin(&s_first, t);

  for (int d = 1; d < kTile; d <<= 1) {
    if (t >= d) {
      const T lv = sv[t - d];
      const int lc = sc[t - d];
      const int lf = sf[t - d];
      if (!f) {
        if constexpr (PAY) p = pay_rule<T, OP>(lv, sp[t - d], v, p);
        v = C::op(lv, v);
        c = lc + c;
      }
      f |= lf;
    }
    __syncthreads();
    sv[t] = v;
    sc[t] = c;
    sf[t] = f;
    if constexpr (PAY) sp[t] = p;
    __syncthreads();
  }

  const long long o = (long long)row * a.es + i;
  if (i < a.es) {
    static_cast<T*>(a.v_out)[o] = v;
    a.c_out[o] = c;
    if constexpr (PAY) a.p_out[o] = p;
  }
  const long long g = (long long)row * nt + tile;
  if (t == kTile - 1) {
    static_cast<T*>(a.agg_v)[g] = v;
    a.agg_c[g] = c;
    if constexpr (PAY) a.agg_p[g] = p;
  }
  if (t == 0) a.first[g] = s_first;
}

template <typename T, int OP, bool PAY>
__global__ void carry(ScanArgs a, int nt) {
  using C = Combine<T, OP>;
  const T* agg_v = static_cast<const T*>(a.agg_v);
  T* carry_v = static_cast<T*>(a.carry_v);
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * nt;
  T cv = C::ident();
  int cc = 0;
  int cp = -1;
  for (int base = 0; base < nt; base += 32) {
    const int j = base + lane;
    T av = C::ident();
    int ac = 0;
    int ap = -1;
    int af = 1;
    if (j < nt) {
      av = agg_v[row + j];
      ac = a.agg_c[row + j];
      if constexpr (PAY) ap = a.agg_p[row + j];
      af = a.first[row + j] < kTile;
    }
    T mine_v = C::ident();
    int mine_c = 0;
    int mine_p = -1;
    // every lane folds the same 32 aggregates in tile order
    for (int l = 0; l < 32; ++l) {
      const T bv = __shfl_sync(0xffffffffu, av, l);
      const int bc = __shfl_sync(0xffffffffu, ac, l);
      const int bp = __shfl_sync(0xffffffffu, ap, l);
      const int bf = __shfl_sync(0xffffffffu, af, l);
      if (l == lane) {
        mine_v = cv;
        mine_c = cc;
        mine_p = cp;
      }
      if (bf) {
        cv = bv;
        cc = bc;
        cp = bp;
      } else {
        if constexpr (PAY) cp = pay_rule<T, OP>(cv, cp, bv, bp);
        cv = C::op(cv, bv);
        cc = cc + bc;
      }
    }
    if (j < nt) {
      carry_v[row + j] = mine_v;
      a.carry_c[row + j] = mine_c;
      if constexpr (PAY) a.carry_p[row + j] = mine_p;
    }
  }
}

template <typename T, int OP, bool PAY>
__global__ void __launch_bounds__(kTile) apply_carry(ScanArgs a) {
  using C = Combine<T, OP>;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const long long row = blockIdx.y;
  const long long g = row * gridDim.x + tile;
  const int i = tile * kTile + t;
  if (t < a.first[g] && i < a.es) {
    T* v_out = static_cast<T*>(a.v_out);
    const T cv = static_cast<const T*>(a.carry_v)[g];
    const long long o = row * a.es + i;
    const T v = v_out[o];
    if constexpr (PAY) a.p_out[o] = pay_rule<T, OP>(cv, a.carry_p[g], v,
                                                     a.p_out[o]);
    v_out[o] = C::op(cv, v);
    a.c_out[o] = a.carry_c[g] + a.c_out[o];
  }
}

// The three passes of one scan over rows = n_cells * lanes.
template <typename T, int OP, int MODE, bool PAY>
int scan_passes(const ScanArgs& a, int n_cells, cudaStream_t s) {
  if (n_cells <= 0 || a.lanes <= 0 || a.es < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.es == 0) return 0;
  const long long rows = (long long)n_cells * a.lanes;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  const int nt = (a.es + kTile - 1) / kTile;
  const dim3 grid((unsigned)nt, (unsigned)rows);
  scan_tiles<T, OP, MODE, PAY><<<grid, kTile, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry<T, OP, PAY><<<(unsigned)rows, 32, 0, s>>>(a, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_carry<T, OP, PAY><<<grid, kTile, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// combine is a CombineOp; with_payload only for min/max.
template <typename T, int MODE>
int dispatch_op(int combine, int with_payload, const ScanArgs& a,
                int n_cells, cudaStream_t s) {
  switch (combine) {
    case kMin:
      return with_payload ? scan_passes<T, kMin, MODE, true>(a, n_cells, s)
                          : scan_passes<T, kMin, MODE, false>(a, n_cells, s);
    case kMax:
      return with_payload ? scan_passes<T, kMax, MODE, true>(a, n_cells, s)
                          : scan_passes<T, kMax, MODE, false>(a, n_cells, s);
    case kSum:
      if (with_payload) return (int)cudaErrorInvalidValue;
      return scan_passes<T, kSum, MODE, false>(a, n_cells, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).  The emit mode: field (f32, or i32
// for the copy form) and divisor (f32, push_share only) are [S, L, np],
// senders [S, L, np], gid [S, np]; key/skey/src/weight are [S, stride]
// rows of which the first `es` elements are scanned.  Outputs v_out (the
// message dtype), c_out and p_out (payload programs only) are [S, L, es];
// agg_v/agg_c/agg_p/first/carry_v/carry_c/carry_p are [S, L, ceil(es /
// 1024)] scratch.  emit_form is an EmitForm, combine a CombineOp.
extern "C" int edge_relax_scan_launch(
    const void* field, const float* divisor, const bool* senders,
    const int* gid, const int* key, const int* skey, const int* src,
    const float* weight, void* v_out, int* c_out, int* p_out, void* agg_v,
    int* agg_c, int* agg_p, int* first, void* carry_v, int* carry_c,
    int* carry_p, int n_cells, int lanes, int np, long long stride, int es,
    int msg_is_int, int combine, int emit_form, int with_payload,
    float emit_const, void* stream) {
  const ScanArgs a{field,   divisor, senders, gid,     key,     src,
                   weight,  nullptr, nullptr, nullptr, skey,    v_out,
                   c_out,   p_out,   agg_v,   agg_c,   agg_p,   first,
                   carry_v, carry_c, carry_p, lanes,   np,      stride,
                   0,       es,      emit_const};
  const auto s = static_cast<cudaStream_t>(stream);
  if (msg_is_int) {
    if (emit_form != kCopy) return (int)cudaErrorInvalidValue;
    return dispatch_op<int, kCopy>(combine, with_payload, a, n_cells, s);
  }
  switch (emit_form) {
    case kAddWeight:
      return dispatch_op<float, kAddWeight>(combine, with_payload, a,
                                            n_cells, s);
    case kAddConst:
      return dispatch_op<float, kAddConst>(combine, with_payload, a, n_cells,
                                           s);
    case kCopy:
      return dispatch_op<float, kCopy>(combine, with_payload, a, n_cells, s);
    case kMinWeight:
      return dispatch_op<float, kMinWeight>(combine, with_payload, a,
                                            n_cells, s);
    case kPushShare:
      return dispatch_op<float, kPushShare>(combine, with_payload, a,
                                            n_cells, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The pre-emitted mode: cand (f32 or i32), send (bool) and pay (i32,
// payload programs only) are [S * L, msg_stride] rows (the first `es`
// scanned) in place of the emit; skey is [S, stride] rows shared by a
// cell's lanes.  Same outputs and scratch as edge_relax_scan_launch.
extern "C" int edge_relax_scan_pre_launch(
    const void* cand, const bool* send, const int* pay, const int* skey,
    void* v_out, int* c_out, int* p_out, void* agg_v, int* agg_c, int* agg_p,
    int* first, void* carry_v, int* carry_c, int* carry_p, int n_cells,
    int lanes, long long stride, long long msg_stride, int es,
    int msg_is_int, int combine, int with_payload, void* stream) {
  const ScanArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, cand,    send,    pay,     skey,    v_out,
                   c_out,   p_out,   agg_v,   agg_c,   agg_p,   first,
                   carry_v, carry_c, carry_p, lanes,   0,       stride,
                   msg_stride, es,   0.0f};
  const auto s = static_cast<cudaStream_t>(stream);
  if (msg_is_int) {
    return dispatch_op<int, kPre>(combine, with_payload, a, n_cells, s);
  }
  return dispatch_op<float, kPre>(combine, with_payload, a, n_cells, s);
}
