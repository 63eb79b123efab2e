// 13-candidate intra RD costs of the whole-plane block search (kernel K3).
//
// Replaces the TPU kernel `_pallas_kernel` of
// cavif_tpu/ops/pallas_search.py (pallas_call at l.252). For every aligned
// n x n block (n in {4, 8, 16, 32}) it builds the 13 candidates in the
// CAND_MODES order (DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, D45, D135,
// D113, D157, D203, D67 at delta 0) exactly in integers, takes each
// residual through the separable f32 DCT
//   coef = D (blk - pred) D^T
// and prices it with the deadzone quantizer
//   l = floor(|coef| * inv + bias),  e = |coef| - l * scale
//   cost = sum e^2 + lam * (sum l + 2 * #(l != 0))  (+ 7 lam for diagonals)
// with the DC coefficient [0, 0] at its own inv / scale / bias. Output:
// (NB, 13) f32 costs; argmin and min run in torch.
//
// What bounds it on an H100: operations. Per block and candidate the two
// DCT passes are 2 n^3 multiply-adds (about 13 (4 n^3 + 10 n^2) flops per
// block with the quantizer), about 5.6 GFLOP per tier over three 10-bit
// 1024x1024 planes, against a read of the planes once (12.6 MB). The TPU
// kernel ran the DCT as MXU matmuls and the diagonals as one matmul with a
// constant (4n+1, 6 n^2) matrix followed by a Kronecker DCT, to stay in flat
// lanes; here each pixel of a diagonal is its two-tap gather from a
// (6, n^2) table in shared memory, and the DCT is separable, so the only
// constants are that table and D (4 KB at n = 32). The design keeps every
// candidate's residual, its half-transformed tile and its coefficients in
// shared memory and registers: a thread block reads its blocks' pixels and
// neighbours once and loops over the 13 candidates. The two DCT passes run
// on the CUDA cores in f32, four outputs per thread; tensor cores, TMA and
// a persistent grid are later work.
//
// Numerics. IEEE f32 at every n. The TPU's n = 32 tier rounded ext, the
// directional matrix, the residual and the Kronecker matrix to bf16 because
// 7.2 MB of f32 constants did not fit its VMEM (pallas_search.py:210-214);
// the separable form needs only D, so f32 costs nothing here. The
// predictors are integer sums, exact. Every float operation is a separate
// IEEE multiply or add (__fmul_rn / __fadd_rn, no FMA contraction) in a
// fixed order: each DCT output a sequential sum over i (then j) from 0;
// each thread's four squared errors summed in order; a fixed warp-shuffle
// butterfly; the warps of a block in order. The plain version
// (ops/search_kernels.mode_cost_ref) performs the same operations in the
// same order, so the two agree bit for bit: exact mathematical ties
// between candidates (flat blocks where every AC level is 0 and two
// residuals have the same energy are common at n = 4) are then broken
// the same way by both, not by rounding noise. |coef| * inv rounds as
// sign(t) * |t| does, so the levels equal the plain version's
// sign(t) floor(|t| + bias). The rate is an exact integer count. No
// atomics: deterministic.
//
// Layout. 256 threads own 1024 pixel slots: 1 block at n = 32, 4 at 16,
// 16 at 8, 64 at 4 (G = 1024 / n^2). For the DCT passes thread t serves
// block g = t / (n^2/4), column j = t % n and rows 4 * ug .. 4 * ug + 3 of
// its block (ug = (t % (n^2/4)) / n).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int SLOTS = 1024; // pixels per thread block
constexpr int NC = 13;      // candidates
constexpr int NND = 7;      // nondirectional candidates

template <int N>
__global__ void __launch_bounds__(NT)
mode_cost_kernel(const int* __restrict__ blocks,
                 const int* __restrict__ above, const int* __restrict__ left,
                 const int* __restrict__ scal, const int* __restrict__ ext,
                 const int* __restrict__ taps, const int* __restrict__ smw,
                 const float* __restrict__ dct, float inv_ac, float scale_ac,
                 float bias_ac, float inv_dc, float scale_dc, float bias_dc,
                 float lam, float* __restrict__ out, int NB) {
  constexpr int N2 = N * N;
  constexpr int G = SLOTS / N2;   // blocks per thread block
  constexpr int E = 4 * N + 1;    // extended-neighbour vector length
  constexpr int BS = N2 + 4;      // padded block stride in shared memory
  constexpr int TPB = N2 / 4;     // threads per block in the DCT passes
  constexpr int NW = NT / 32;

  __shared__ float Ds[N][N + 1];  // D, padded: rows and columns conflict-free
  __shared__ float Rs[G * BS];    // residual of the current candidate
  __shared__ float Ts[G * BS];    // D * residual
  __shared__ int exts[G * E];
  __shared__ int abv[G * N];
  __shared__ int lft[G * N];
  __shared__ int scs[G * 2];
  __shared__ int tps[6 * N2];
  __shared__ int sw[N];
  __shared__ float red_e[NW][NC];
  __shared__ int red_r[NW][NC];

  const int t = threadIdx.x;
  const long long blk0 = (long long)blockIdx.x * G;
  const int nb_here = (int)min((long long)G, (long long)NB - blk0);

  for (int idx = t; idx < N2; idx += NT) Ds[idx / N][idx % N] = dct[idx];
  for (int idx = t; idx < 6 * N2; idx += NT) tps[idx] = taps[idx];
  for (int idx = t; idx < N; idx += NT) sw[idx] = smw[idx];
  for (int idx = t; idx < G * E; idx += NT)
    exts[idx] = idx < nb_here * E ? ext[blk0 * E + idx] : 0;
  for (int idx = t; idx < G * N; idx += NT) {
    const bool ok = idx < nb_here * N;
    abv[idx] = ok ? above[blk0 * N + idx] : 0;
    lft[idx] = ok ? left[blk0 * N + idx] : 0;
  }
  for (int idx = t; idx < G * 2; idx += NT)
    scs[idx] = idx < nb_here * 2 ? scal[blk0 * 2 + idx] : 0;

  // this thread's four pixel slots p = t + 256 k, read once
  int px[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = t + NT * k;
    px[k] = p < nb_here * N2 ? blocks[blk0 * N2 + p] : 0;
  }

  // DCT-pass coordinates
  const int g = t / TPB;
  const int rem = t % TPB;
  const int col = rem % N;
  const int ug = rem / N;

  float err[NC];
  int rate[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    err[c] = 0.0f;
    rate[c] = 0;
  }
  __syncthreads();

  // unrolled, so that each candidate's branch and accumulator resolve at
  // compile time (err / rate stay in registers)
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    // 1. residual of candidate c at the thread's pixel slots
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = t + NT * k;
      const int gb = p / N2, q = p % N2, i = q / N, j = q % N;
      const int* a = abv + gb * N;
      const int* l = lft + gb * N;
      int pred;
      if (c == 0) {
        pred = scs[2 * gb + 1];
      } else if (c == 1) {
        pred = a[j];
      } else if (c == 2) {
        pred = l[i];
      } else if (c <= 5) {
        const int wh = sw[i], ww = sw[j];
        const int below = l[N - 1], right = a[N - 1];
        if (c == 3)
          pred = (wh * a[j] + (256 - wh) * below + ww * l[i] +
                  (256 - ww) * right + 256) >> 9;
        else if (c == 4)
          pred = (wh * a[j] + (256 - wh) * below + 128) >> 8;
        else
          pred = (ww * l[i] + (256 - ww) * right + 128) >> 8;
      } else if (c == 6) {
        const int al = scs[2 * gb];
        const int b = l[i] + a[j] - al;
        const int pl = abs(b - l[i]), pt = abs(b - a[j]), ptl = abs(b - al);
        pred = (pl <= pt && pl <= ptl) ? l[i] : (pt <= ptl ? a[j] : al);
      } else {
        const int tap = tps[(c - NND) * N2 + q];
        const int* x = exts + gb * E;
        pred = (x[tap & 255] * ((tap >> 8) & 255) +
                x[(tap >> 16) & 255] * ((tap >> 24) & 255) + 16) >> 5;
      }
      Rs[gb * BS + q] = (float)(px[k] - pred);
    }
    __syncthreads();

    // 2. row pass: T[u][col] = sum_i D[u][i] R[i][col]
    {
      const float* r = Rs + g * BS + col;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float rv = r[i * N];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(Ds[4 * ug + k][i], rv));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) Ts[g * BS + (4 * ug + k) * N + col] = acc[k];
    }
    __syncthreads();

    // 3. column pass: C[u][v] = sum_j T[u][j] D[v][j] (v = col), then the
    //    quantizer; no barrier needed before the next candidate's residual
    //    (Rs was last read before the barrier above)
    {
      const float* tr = Ts + g * BS + 4 * ug * N;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dv = Ds[col][j];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(tr[k * N + j], dv));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool isdc = (ug == 0 && k == 0 && col == 0);
        const float inv = isdc ? inv_dc : inv_ac;
        const float scale = isdc ? scale_dc : scale_ac;
        const float bias = isdc ? bias_dc : bias_ac;
        const float av = fabsf(acc[k]);
        const float lv = floorf(__fadd_rn(__fmul_rn(av, inv), bias));
        const float e = __fsub_rn(av, __fmul_rn(lv, scale));
        err[c] = __fadd_rn(err[c], __fmul_rn(e, e));
        const int li = (int)lv;
        rate[c] += li + (li != 0 ? 2 : 0);
      }
    }
  }

  // per-block sums: butterfly inside the TPB threads of a block (within a
  // warp when TPB <= 32), then a fixed order across a block's warps
  constexpr int WIDTH = TPB < 32 ? TPB : 32;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int off = WIDTH / 2; off >= 1; off >>= 1) {
      err[c] = __fadd_rn(err[c], __shfl_xor_sync(0xffffffffu, err[c], off));
      rate[c] += __shfl_xor_sync(0xffffffffu, rate[c], off);
    }
  }
  const float lam7 = __fmul_rn(lam, 7.0f);
  if constexpr (TPB <= 32) {
    if (rem == 0 && g < nb_here) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float cost = __fadd_rn(err[c], __fmul_rn(lam, (float)rate[c]));
        if (c >= NND) cost = __fadd_rn(cost, lam7);
        out[(blk0 + g) * NC + c] = cost;
      }
    }
  } else {
    const int warp = t / 32, lane = t % 32;
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        red_e[warp][c] = err[c];
        red_r[warp][c] = rate[c];
      }
    }
    __syncthreads();
    constexpr int WPB = TPB / 32;  // warps per block
    for (int idx = t; idx < G * NC; idx += NT) {
      const int gb = idx / NC, c = idx % NC;
      if (gb >= nb_here) continue;
      float e = 0.0f;
      int r = 0;
      for (int w = 0; w < WPB; ++w) {
        e = __fadd_rn(e, red_e[gb * WPB + w][c]);
        r += red_r[gb * WPB + w][c];
      }
      float cost = __fadd_rn(e, __fmul_rn(lam, (float)r));
      if (c >= NND) cost = __fadd_rn(cost, lam7);
      out[(blk0 + gb) * NC + c] = cost;
    }
  }
}

template <int N>
int launch(const int* blocks, const int* above, const int* left,
           const int* scal, const int* ext, const int* taps, const int* smw,
           const float* dct, float inv_ac, float scale_ac, float bias_ac,
           float inv_dc, float scale_dc, float bias_dc, float lam,
           float* out, int NB, cudaStream_t stream) {
  constexpr int G = SLOTS / (N * N);
  const dim3 grid((NB + G - 1) / G);
  mode_cost_kernel<N><<<grid, NT, 0, stream>>>(
      blocks, above, left, scal, ext, taps, smw, dct, inv_ac, scale_ac,
      bias_ac, inv_dc, scale_dc, bias_dc, lam, out, NB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mode_search_cost(const int* blocks, const int* above,
                                const int* left, const int* scal,
                                const int* ext, const int* taps,
                                const int* smw, const float* dct,
                                float inv_ac, float scale_ac, float bias_ac,
                                float inv_dc, float scale_dc, float bias_dc,
                                float lam, float* out, int NB, int n,
                                cudaStream_t stream) {
  switch (n) {
    case 4:
      return launch<4>(blocks, above, left, scal, ext, taps, smw, dct, inv_ac,
                       scale_ac, bias_ac, inv_dc, scale_dc, bias_dc, lam, out,
                       NB, stream);
    case 8:
      return launch<8>(blocks, above, left, scal, ext, taps, smw, dct, inv_ac,
                       scale_ac, bias_ac, inv_dc, scale_dc, bias_dc, lam, out,
                       NB, stream);
    case 16:
      return launch<16>(blocks, above, left, scal, ext, taps, smw, dct,
                        inv_ac, scale_ac, bias_ac, inv_dc, scale_dc, bias_dc,
                        lam, out, NB, stream);
    case 32:
      return launch<32>(blocks, above, left, scal, ext, taps, smw, dct,
                        inv_ac, scale_ac, bias_ac, inv_dc, scale_dc, bias_dc,
                        lam, out, NB, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
