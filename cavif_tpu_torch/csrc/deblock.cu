// One deblock edge pass (AV1 loop filter, spec 7.14) over one plane at B
// levels at once: every vertical edge, or every horizontal edge, filtered
// and scored in one launch.
//
// Replaces no TPU kernel: the JAX package's deblock
// (cavif_tpu/ops/device_filters.py _deblock_axis) is XLA code, and the
// port's plain version of it (ops/device_filters.py _deblock_axis, kept for
// the CPU and as this kernel's counterpart in the tests) issues about 750
// eager PyTorch kernels per pass. This kernel computes exactly what that
// plain version computes, in the same integers:
//   - per (line, edge): the filter size from min(tx_l2 left, right) (luma
//     4/8/14, chroma 4/6), whether the edge fires (edge map, and in the
//     level search the superblock-row subsample `row_sub`), the limits of
//     the level (make_ctx, sharpness 0), the mask / flat / flat2 / hev
//     tests, and the narrow, 6-, 8- or 14-tap filter: a mirror of
//     native/tilecoder.cpp filter_line; level 0 writes nothing;
//   - the filtered plane per level: a pixel two edges could write takes the
//     write of the larger offset k (the plain composition applies the
//     writers in ascending k; maps from build_filter_maps never overlap);
//   - the SSE delta per level over the visible crop, written pixels only:
//     sum of (new - src)^2 - (old - src)^2, an exact integer sum in any
//     order.
//
// What bounds it on an H100: bytes. Per pass it reads the plane once per
// input level and src once, and writes B planes; a fired (line, edge,
// level) costs about 200 integer instructions (the tests, the widest
// filter, the window's loads, the writes and the deltas), under a tenth of
// the bytes' time at 64 INT32 lanes per SM (chip_smoke.py [deblock]).
//
// Design. A block owns a tile of LINES lines x 4*CELLS positions along the
// edge axis (the lines are pixel rows in the vertical pass, pixel columns in
// the horizontal one, read through strides, never transposed). One thread
// takes one (line, edge): the tile's CELLS edges plus the three around it
// whose writes reach into the tile (two to the left, one to the right), so
// every output pixel is complete inside its block. The thread reads its
// 16-pixel window (clamped to the plane) once for every level when the
// levels share an input plane (the search's vertical pass) and filters it
// in registers for each level; its writes land in a shared-memory tile per
// level as (k + 7) << 24 | value under atomicMax, which keeps the larger k.
// Then the tile goes out, unwritten pixels copied from the input. The
// vertical pass takes 4 lines x 61 cells (threads along the edges), the
// horizontal 32 lines x 13 cells (threads along the lines, so a warp reads
// 32 neighbouring pixels of a row). Each edge's delta is counted by the one
// block whose cells hold it: int64 per thread, a warp reduction, one
// int64 atomicAdd per block and level (unscored, block (0, 0) writes the
// zero deltas). Integer sums are exact in any order, so the result is
// bit-exact and deterministic.
//
// Measured (chip_smoke.py, CUDA events, NVIDIA H100 80GB HBM3 at 700 W), per
// frame over 3 planes x 2 axes: 1 MP search 0.42 ms, apply 0.33 ms; 8K 7.56
// and 4.06 ms: 13%, 4.5%, 24% and 12% of the bytes' time, 78-190x faster
// than the plain pass. At 128 registers a thread an SM holds 16 warps, and
// a pixel is read about four times (overlapping windows) and once more for
// the copy-out; the pass is under 1% of the filter chain's device time.

#include <cuda_runtime.h>

namespace {

constexpr int MAXB = 4;  // levels per launch (the search's candidates)

struct Lim {
  int limit, blimit, thresh, lo, hi, maxv, flat;
};

__device__ __forceinline__ Lim make_lim(int lvl, int bit_depth) {
  const int s = bit_depth - 8;
  const int limit = max(lvl, 1);
  Lim L;
  L.limit = limit << s;
  L.blimit = (2 * (lvl + 2) + limit) << s;
  L.thresh = (lvl >> 4) << s;
  L.lo = -(1 << (bit_depth - 1));
  L.hi = (1 << (bit_depth - 1)) - 1;
  L.maxv = (1 << bit_depth) - 1;
  L.flat = 1 << s;
  return L;
}

__device__ __forceinline__ int rnd2(int v, int n) {
  return (v + (1 << (n - 1))) >> n;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// filter_line on one 16-pixel window w[k + 8], k in [-8, 8) (q_i = w[8 + i],
// p_i = w[7 - i]). Returns the written offsets as a mask, bit k + 6 for k
// in [-6, 6), and their values in v[k + 6].
__device__ __forceinline__ unsigned filter_line(const int* w, int size,
                                                const Lim& L, int* v) {
  const int p0 = w[7], p1 = w[6], p2 = w[5], p3 = w[4];
  const int p4 = w[3], p5 = w[2], p6 = w[1];
  const int q0 = w[8], q1 = w[9], q2 = w[10], q3 = w[11];
  const int q4 = w[12], q5 = w[13], q6 = w[14];
  bool mask = abs(p1 - p0) <= L.limit && abs(q1 - q0) <= L.limit &&
              2 * abs(p0 - q0) + (abs(p1 - q1) >> 1) <= L.blimit;
  if (size >= 8)
    mask = mask && abs(p2 - p1) <= L.limit && abs(q2 - q1) <= L.limit &&
           abs(p3 - p2) <= L.limit && abs(q3 - q2) <= L.limit;
  else if (size == 6)
    mask = mask && abs(p2 - p1) <= L.limit && abs(q2 - q1) <= L.limit;
  if (!mask) return 0u;
  const int F = L.flat;
  const bool flat_base = abs(p1 - p0) <= F && abs(q1 - q0) <= F &&
                         abs(p2 - p0) <= F && abs(q2 - q0) <= F;
  const bool flat8 = flat_base && abs(p3 - p0) <= F && abs(q3 - q0) <= F;
  if (size == 14 && flat8 && abs(p6 - p0) <= F && abs(q6 - q0) <= F &&
      abs(p5 - p0) <= F && abs(q5 - q0) <= F && abs(p4 - p0) <= F &&
      abs(q4 - q0) <= F) {
    v[0] = rnd2(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4);
    v[1] = rnd2(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1,
                4);
    v[2] = rnd2(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 +
                    q2, 4);
    v[3] = rnd2(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 +
                    q2 + q3, 4);
    v[4] = rnd2(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 +
                    q2 + q3 + q4, 4);
    v[5] = rnd2(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 +
                    q3 + q4 + q5, 4);
    v[6] = rnd2(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 +
                    q4 + q5 + q6, 4);
    v[7] = rnd2(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 +
                    q5 + q6 * 2, 4);
    v[8] = rnd2(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 +
                    q6 * 3, 4);
    v[9] = rnd2(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 +
                    q6 * 4, 4);
    v[10] = rnd2(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5,
                 4);
    v[11] = rnd2(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7, 4);
    return 0xfffu;  // k = -6 .. 5
  }
  if (size >= 8 && flat8) {
    v[3] = rnd2(p3 * 3 + p2 * 2 + p1 + p0 + q0, 3);
    v[4] = rnd2(p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1, 3);
    v[5] = rnd2(p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2, 3);
    v[6] = rnd2(p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3, 3);
    v[7] = rnd2(p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2, 3);
    v[8] = rnd2(p0 + q0 + q1 + q2 * 2 + q3 * 3, 3);
    return 0x1f8u;  // k = -3 .. 2
  }
  if (size == 6 && flat_base) {
    v[4] = rnd2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3);
    v[5] = rnd2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3);
    v[6] = rnd2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3);
    v[7] = rnd2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3);
    return 0xf0u;  // k = -2 .. 1
  }
  // narrow (filter4): p0 / q0 always, p1 / q1 without high edge variance
  const bool hev = abs(p1 - p0) > L.thresh || abs(q1 - q0) > L.thresh;
  int f = hev ? clampi(p1 - q1, L.lo, L.hi) : 0;
  f = clampi(f + 3 * (q0 - p0), L.lo, L.hi);
  const int f1 = clampi(f + 4, L.lo, L.hi) >> 3;
  const int f2 = clampi(f + 3, L.lo, L.hi) >> 3;
  v[5] = clampi(p0 + f2, 0, L.maxv);
  v[6] = clampi(q0 - f1, 0, L.maxv);
  if (hev) return 0x60u;  // k = -1, 0
  const int f3 = (f1 + 1) >> 1;
  v[4] = clampi(p1 + f3, 0, L.maxv);
  v[7] = clampi(q1 - f3, 0, L.maxv);
  return 0xf0u;  // k = -2 .. 1
}

struct Args {
  const int* plane;   // (in_b, H, W): in_b = 1 (shared by the levels) or B
  long long in_bstride;
  const int* src;     // (H, W) or null: no scoring
  const int* tx;      // (mi_rows, mi_cols) log2 transform size across the edge
  const int* edge;    // (mi_rows, mi_cols) nonzero: an edge at the mi's start
  const int* lvl;     // (B,)
  int* out;           // (B, H, W)
  long long* delta;   // (B,): zeroed by the caller where src is given
  int B, H, W, mi_rows, mi_cols, luma, bit_depth, vis_w, vis_h, row_sub;
};

template <int LINES, int CELLS, bool HOR>
__global__ void __launch_bounds__(LINES * (CELLS + 3))
deblock_kernel(const Args a) {
  constexpr int NT = LINES * (CELLS + 3);
  constexpr int POS = 4 * CELLS;
  constexpr int PIX = LINES * POS;
  __shared__ int key[MAXB * PIX];
  __shared__ long long wsum[NT / 32][MAXB];

  // lines run across the edge axis, positions along it
  const int n_lines = HOR ? a.W : a.H;
  const int len = HOR ? a.H : a.W;
  const long long ls = HOR ? 1 : a.W;
  const long long ps = HOR ? a.W : 1;
  const int mi_lines = HOR ? a.mi_cols : a.mi_rows;
  const int n_edges = (HOR ? a.mi_rows : a.mi_cols) - 1;
  const int vis_pos = HOR ? a.vis_h : a.vis_w;
  const int vis_line = HOR ? a.vis_w : a.vis_h;
  const int j0 = blockIdx.x * CELLS;  // the tile's first 4-pixel cell
  const int l0 = blockIdx.y * LINES;
  const int tid = threadIdx.x;
  const int B = a.B;

  for (int i = tid; i < B * PIX; i += NT) key[i] = 0;
  __syncthreads();

  const int li = HOR ? tid % LINES : tid / (CELLS + 3);
  const int e = j0 - 2 + (HOR ? tid / LINES : tid % (CELLS + 3));
  const int line = l0 + li;
  long long acc[MAXB] = {0, 0, 0, 0};
  const int m = line >> 2;  // the line's mi index
  if (line < n_lines && m < mi_lines && e >= 0 && e < n_edges) {
    int txl, txr;
    bool fire;
    if (HOR) {
      txl = a.tx[(long long)e * a.mi_cols + m];
      txr = a.tx[(long long)(e + 1) * a.mi_cols + m];
      fire = a.edge[(long long)(e + 1) * a.mi_cols + m] != 0 &&
             ((e + 1) >> 4) % a.row_sub == 0;
    } else {
      txl = a.tx[(long long)m * a.mi_cols + e];
      txr = a.tx[(long long)m * a.mi_cols + e + 1];
      fire = a.edge[(long long)m * a.mi_cols + e + 1] != 0 &&
             (m >> 4) % a.row_sub == 0;
    }
    if (fire) {
      const int mw = 1 << min(txl, txr);
      const int size = a.luma ? (mw >= 16 ? 14 : (mw >= 8 ? 8 : 4))
                              : (mw >= 8 ? 6 : 4);
      const int x = 4 * (e + 1);
      const long long lbase = line * ls;
      // the block holding the edge's cell scores it
      const bool score = a.src != nullptr && e + 1 >= j0 &&
                         e + 1 < j0 + CELLS && line < vis_line;
      int sw[12];
      if (score) {
#pragma unroll
        for (int k = 0; k < 12; ++k)
          sw[k] = a.src[lbase + clampi(x + k - 6, 0, len - 1) * ps];
      }
      int w[16];
      // unrolled over MAXB so that acc[] stays in registers
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b >= B) break;
        if (b == 0 || a.in_bstride != 0) {
          const int* pl = a.plane + b * a.in_bstride + lbase;
#pragma unroll
          for (int k = 0; k < 16; ++k)
            w[k] = pl[clampi(x + k - 8, 0, len - 1) * ps];
        }
        const int lv = a.lvl[b];
        if (lv <= 0) continue;
        int v[12];
        const unsigned wm = filter_line(w, size, make_lim(lv, a.bit_depth), v);
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          if (!((wm >> k) & 1u)) continue;
          const int pos = x + k - 6;
          const int t = pos - 4 * j0;
          if (pos < len && t >= 0 && t < POS)
            atomicMax(&key[b * PIX + li * POS + t],
                      ((k + 1) << 24) | (v[k] & 0xffffff));
          if (score && pos >= 0 && pos < vis_pos) {
            const int dn = v[k] - sw[k], od = w[k + 2] - sw[k];
            acc[b] += dn * dn - od * od;
          }
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < B * PIX; i += NT) {
    const int b = i / PIX, r = i % PIX;
    const int lt = HOR ? r % LINES : r / POS;
    const int t = HOR ? r / LINES : r % POS;
    const int ln = l0 + lt, pos = 4 * j0 + t;
    if (ln >= n_lines || pos >= len) continue;
    const long long off = ln * ls + pos * ps;
    const int kv = key[b * PIX + lt * POS + t];
    a.out[b * (long long)a.H * a.W + off] =
        kv ? static_cast<int>(static_cast<unsigned>(kv) << 8) >> 8
           : a.plane[b * a.in_bstride + off];
  }

  if (a.src == nullptr) {  // unscored: the deltas are zero
    if (blockIdx.x == 0 && blockIdx.y == 0 && tid < B) a.delta[tid] = 0;
    return;
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b >= B) break;
    long long s = acc[b];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) wsum[warp][b] = s;
  }
  __syncthreads();
  if (tid < B) {
    long long s = 0;
    for (int i = 0; i < NT / 32; ++i) s += wsum[i][tid];
    if (s != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.delta + tid),
                static_cast<unsigned long long>(s));
  }
}

template <int LINES, int CELLS, bool HOR>
int launch(const Args& a, cudaStream_t stream) {
  const int len = HOR ? a.H : a.W;
  const int n_lines = HOR ? a.W : a.H;
  const int n_edges = (HOR ? a.mi_rows : a.mi_cols) - 1;
  // every cell of the plane, and every edge's cell (scored even where it
  // lies past the plane)
  const int cells = max((len + 3) / 4, n_edges + 1);
  const dim3 grid((cells + CELLS - 1) / CELLS,
                  (n_lines + LINES - 1) / LINES);
  deblock_kernel<LINES, CELLS, HOR>
      <<<grid, LINES * (CELLS + 3), 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One pass; returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for B outside 1..4 or in_b neither 1 nor B).
extern "C" int deblock_pass(const int* plane, int in_b, const int* src,
                            const int* tx_l2, const int* edge, const int* lvl,
                            int* out, long long* delta, int B, int H, int W,
                            int mi_rows, int mi_cols, int luma, int horizontal,
                            int bit_depth, int vis_w, int vis_h, int row_sub,
                            cudaStream_t stream) {
  if (B < 1 || B > MAXB || (in_b != 1 && in_b != B) || row_sub < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{plane, in_b == 1 ? 0LL : (long long)H * W, src, tx_l2, edge,
               lvl, out, delta, B, H, W, mi_rows, mi_cols, luma, bit_depth,
               vis_w, vis_h, row_sub};
  if (horizontal) return launch<32, 13, true>(a, stream);
  return launch<4, 61, false>(a, stream);
}

// info = {threads per block, registers per thread, static shared memory
// bytes per block} of the pass's kernel
extern "C" int deblock_pass_info(int horizontal, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      horizontal ? cudaFuncGetAttributes(&attr, deblock_kernel<32, 13, true>)
                 : cudaFuncGetAttributes(&attr, deblock_kernel<4, 61, false>);
  info[0] = horizontal ? 32 * 16 : 4 * 64;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(err);
}
