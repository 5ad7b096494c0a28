// edge_relax_scan (K2): the push_share emit over each compute cell's
// destination-sorted stream, then a deterministic segmented inclusive scan
// of (value, sending count) that resets wherever the structural key
// changes.  Element e of the output holds the sum of its destination's run
// up to e; the run-end gather (phase 2) happens outside.
//
// Replaces the Pallas TPU kernel repro/kernels/edge_relax/kernel.py
// :: edge_relax_scan (body _scan_kernel, scan ref.stream_scan).
//
// Association order — fixed by the stream length and kTile alone, never by
// lanes, launch order or frontier (so the sum is reproducible bit for bit,
// and the plain version ref.stream_scan runs the same order):
//   (a) scan_tiles: per tile of kTile = 1024 elements, one CTA of 1024
//       threads runs a Hillis–Steele tree in shared memory (step d combines
//       element i with i - d, the left operand first);
//   (b) carry: one warp per cell folds the tile aggregates sequentially in
//       tile order (carry_j = agg_{j-1} if tile j-1 holds a run start,
//       else carry_{j-1} + agg_{j-1});
//   (c) apply_carry: each tile's leading open run (the elements before its
//       first run start) adds the carry on the left.
// No float atomics anywhere.
//
// Bound: memory.  Per edge it reads key, skey, src (12 B) and writes the
// scanned value and count (8 B); the gathers of senders/residual/deg hit
// the vertex block, Np * 9 B per cell.  Time >= bytes / 3.35 TB/s.  The
// in-tile tree keeps the partial sums in shared memory; pass (b) reads one
// aggregate per tile and pass (c) touches only the leading open runs.
//
// Input modes (template flag PRE of scan_tiles, same tile/tree/carry
// order, so each is bitwise ref.stream_scan of its messages):
//   * emit (edge_relax_scan_launch): gathers senders/residual/deg at src
//     and computes push_share itself — the dense pull sweep;
//   * pre-emitted (edge_relax_scan_pre_launch): reads the message and send
//     streams (cand f32, send bool, [S, E]) that the push sweep scattered
//     back into the destination-sorted layout (ref.edge_relax_push_stream).
//
// Compile without fast math: push_share's division must be IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;

template <bool PRE>
__global__ void __launch_bounds__(kTile)
scan_tiles(const float* __restrict__ residual, const float* __restrict__ deg,
           const bool* __restrict__ senders, const int* __restrict__ key,
           const int* __restrict__ skey, const int* __restrict__ src,
           const float* __restrict__ cand, const bool* __restrict__ send,
           float* __restrict__ v_out, int* __restrict__ c_out,
           float* __restrict__ agg_v, int* __restrict__ agg_c,
           int* __restrict__ first, int np, long long stride,
           long long msg_stride, int es, float scale) {
  __shared__ float sv[kTile];
  __shared__ int sc[kTile];
  __shared__ int sf[kTile];
  __shared__ int s_first;

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int cell = blockIdx.y;
  const int nt = gridDim.x;
  const int i = tile * kTile + t;
  const long long e = cell * stride + i;

  float v = 0.0f;
  int c = 0;
  int f = 1;  // padding past the region counts as a run start
  if (i < es) {
    f = (i == 0) || (skey[e] != skey[e - 1]);
    if constexpr (PRE) {
      const long long m = cell * msg_stride + i;
      v = cand[m];
      c = send[m] ? 1 : 0;
    } else if (key[e] >= 0) {
      const long long vb = (long long)cell * np + src[e];
      if (senders[vb]) {
        v = (scale * residual[vb]) / deg[vb];
        c = 1;
      }
    }
  }
  if (t == 0) s_first = kTile;
  sv[t] = v;
  sc[t] = c;
  sf[t] = f;
  __syncthreads();
  if (f) atomicMin(&s_first, t);

  for (int d = 1; d < kTile; d <<= 1) {
    if (t >= d) {
      const float lv = sv[t - d];
      const int lc = sc[t - d];
      const int lf = sf[t - d];
      if (!f) {
        v = lv + v;
        c = lc + c;
      }
      f |= lf;
    }
    __syncthreads();
    sv[t] = v;
    sc[t] = c;
    sf[t] = f;
    __syncthreads();
  }

  if (i < es) {
    v_out[(long long)cell * es + i] = v;
    c_out[(long long)cell * es + i] = c;
  }
  const long long a = (long long)cell * nt + tile;
  if (t == kTile - 1) {
    agg_v[a] = v;
    agg_c[a] = c;
  }
  if (t == 0) first[a] = s_first;
}

__global__ void carry(const float* __restrict__ agg_v,
                      const int* __restrict__ agg_c,
                      const int* __restrict__ first,
                      float* __restrict__ carry_v, int* __restrict__ carry_c,
                      int nt) {
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * nt;
  float cv = 0.0f;
  int cc = 0;
  for (int base = 0; base < nt; base += 32) {
    const int j = base + lane;
    float av = 0.0f;
    int ac = 0;
    int af = 1;
    if (j < nt) {
      av = agg_v[row + j];
      ac = agg_c[row + j];
      af = first[row + j] < kTile;
    }
    float mine_v = 0.0f;
    int mine_c = 0;
    // every lane folds the same 32 aggregates in tile order
    for (int l = 0; l < 32; ++l) {
      const float bv = __shfl_sync(0xffffffffu, av, l);
      const int bc = __shfl_sync(0xffffffffu, ac, l);
      const int bf = __shfl_sync(0xffffffffu, af, l);
      if (l == lane) {
        mine_v = cv;
        mine_c = cc;
      }
      if (bf) {
        cv = bv;
        cc = bc;
      } else {
        cv = cv + bv;
        cc = cc + bc;
      }
    }
    if (j < nt) {
      carry_v[row + j] = mine_v;
      carry_c[row + j] = mine_c;
    }
  }
}

__global__ void __launch_bounds__(kTile)
apply_carry(float* __restrict__ v_out, int* __restrict__ c_out,
            const float* __restrict__ carry_v, const int* __restrict__ carry_c,
            const int* __restrict__ first, int es) {
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int cell = blockIdx.y;
  const long long a = (long long)cell * gridDim.x + tile;
  const int i = tile * kTile + t;
  if (t < first[a] && i < es) {
    const long long o = (long long)cell * es + i;
    v_out[o] = carry_v[a] + v_out[o];
    c_out[o] = carry_c[a] + c_out[o];
  }
}

// The three passes of one scan; scratch agg_v/agg_c/first/carry_v/carry_c
// is [S, ceil(es / 1024)].
template <bool PRE>
int scan_passes(const float* residual, const float* deg, const bool* senders,
                const int* key, const int* skey, const int* src,
                const float* cand, const bool* send, float* v_out, int* c_out,
                float* agg_v, int* agg_c, int* first, float* carry_v,
                int* carry_c, int n_cells, int np, long long stride,
                long long msg_stride, int es, float scale, cudaStream_t s) {
  if (n_cells <= 0 || es < 0) return (int)cudaErrorInvalidValue;
  if (es == 0) return 0;
  const int nt = (es + kTile - 1) / kTile;
  const dim3 grid((unsigned)nt, (unsigned)n_cells);
  scan_tiles<PRE><<<grid, kTile, 0, s>>>(
      residual, deg, senders, key, skey, src, cand, send, v_out, c_out, agg_v,
      agg_c, first, np, stride, msg_stride, es, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry<<<n_cells, 32, 0, s>>>(agg_v, agg_c, first, carry_v, carry_c, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_carry<<<grid, kTile, 0, s>>>(v_out, c_out, carry_v, carry_c, first,
                                     es);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).  Inputs key/skey/src are [S, stride]
// rows of which the first `es` elements are scanned; residual/deg/senders
// are [S, np]; outputs v_out/c_out are [S, es]; agg_v/agg_c/first/
// carry_v/carry_c are [S, ceil(es / 1024)] scratch.
extern "C" int edge_relax_scan_launch(
    const float* residual, const float* deg, const bool* senders,
    const int* key, const int* skey, const int* src, float* v_out, int* c_out,
    float* agg_v, int* agg_c, int* first, float* carry_v, int* carry_c,
    int n_cells, int np, long long stride, int es, float scale,
    void* stream) {
  return scan_passes<false>(residual, deg, senders, key, skey, src, nullptr,
                            nullptr, v_out, c_out, agg_v, agg_c, first,
                            carry_v, carry_c, n_cells, np, stride, 0, es,
                            scale, static_cast<cudaStream_t>(stream));
}

// The pre-emitted mode: cand [S, msg_stride] f32 and send [S, msg_stride]
// bool rows (the first `es` scanned) replace the emit; skey is [S, stride]
// rows as above.  Same outputs and scratch as edge_relax_scan_launch.
extern "C" int edge_relax_scan_pre_launch(
    const float* cand, const bool* send, const int* skey, float* v_out,
    int* c_out, float* agg_v, int* agg_c, int* first, float* carry_v,
    int* carry_c, int n_cells, long long stride, long long msg_stride, int es,
    void* stream) {
  return scan_passes<true>(nullptr, nullptr, nullptr, nullptr, skey, nullptr,
                           cand, send, v_out, c_out, agg_v, agg_c, first,
                           carry_v, carry_c, n_cells, 0, stride, msg_stride,
                           es, 0.0f, static_cast<cudaStream_t>(stream));
}
