// Nondirectional-predictor costs of the device pass 1 (kernel K2).
//
// Replaces the TPU kernel `_fused_nd_cost` of
// cavif_tpu/ops/device_pass1.py (_cost_body). For every block row r it
// builds the five nondirectional predictors in the NONDIR5 order (DC,
// SMOOTH, SMOOTH_V, SMOOTH_H, PAETH) exactly, as the reference's
// integer-valued f32 expressions, takes each residual through the
// Kronecker DCT,
//   coef[p, j] = sum_k bf16(block[r, k] - pred_p[k]) * KT[k, j]   (f32)
// and prices it with the shared quantizer chain
//   l = floor(|coef| * inv[j] + bias[j]),  e = |coef| - l * scale[j]
//   u = e * e + lam * (l + 2 * [l != 0]),   out[r, p] = sum_j u.
// The (R, 5, n2) predictor, residual and coefficient tensors exist only in
// shared memory and registers.
//
// What bounds it on an H100: operations, 5 * 2 * R * n2^2 flops (about
// 0.085 TFLOP per 1 MP frame) against a read of the blocks and neighbours
// once. The TPU kernel built the above row / left column onto the pixel
// grid with 0/1 replication matmuls (a lane-layout device); here each
// thread indexes the neighbours directly. The block loops over the five
// predictors inside, so every KT tile it loads from device memory feeds
// five products. The product runs on the CUDA cores in f32 (bf16 x bf16 is
// exact in f32); tensor cores are a later step.
//
// Layout. A block owns 64 rows; it walks the n2 output lanes 64 at a time
// and the contraction 16 pixels at a time. Thread (ty, tx) of the 16 x 16
// threads holds rows ty + 16 i and columns 4 tx + j for all five
// predictors. A row's lane sum is the thread's four columns, then a fixed
// butterfly of warp shuffles over the 16 tx threads, then a running sum
// over lane tiles: deterministic, no atomics.
//
// Rounding. The predictors are sums of integer products below 2^24, exact
// in f32 whatever the order; PAETH keeps the reference's <= tie order. The
// epilogue uses __fmul_rn / __fadd_rn so that no FMA contraction moves
// floor() at a level boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // rows per block
constexpr int TN = 64;   // output lanes per tile
constexpr int TK = 16;   // contraction chunk (pixels)
constexpr int NT = 256;  // threads per block
constexpr int NP = 5;    // predictors

__device__ __forceinline__ float lane_cost(float a, float inv, float scale,
                                           float bias, float lam) {
  const float l = floorf(__fadd_rn(__fmul_rn(a, inv), bias));
  const float e = __fsub_rn(a, __fmul_rn(l, scale));
  const float r = __fadd_rn(l, l != 0.0f ? 2.0f : 0.0f);
  return __fadd_rn(__fmul_rn(e, e), __fmul_rn(lam, r));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(NT)
nd_cost_kernel(const float* __restrict__ above,
               const float* __restrict__ left, const float* __restrict__ sc,
               const float* __restrict__ blocks,
               const __nv_bfloat16* __restrict__ kt,
               const float* __restrict__ whv, const float* __restrict__ wwv,
               const float* __restrict__ inv, const float* __restrict__ scale,
               const float* __restrict__ bias, float lam,
               float* __restrict__ out, int R, int bw, int bh, int lbw) {
  __shared__ float As[NP][TK][TM + 1];         // residuals, [p][k][row]
  __shared__ __align__(16) float Bs[TK][TN];   // KT tile, [k][col]

  const int n2 = bw * bh;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * TM;

  float run[NP][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) run[p][i] = 0.0f;

  for (int c0 = 0; c0 < n2; c0 += TN) {
    float acc[NP][4][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.0f;

    for (int k0 = 0; k0 < n2; k0 += TK) {
      for (int idx = tid; idx < TM * TK; idx += NT) {
        const int r = idx / TK, k = idx % TK;
        const int gr = row0 + r, gk = k0 + k;
        float res[NP] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (gr < R) {
          const int y = gk >> lbw, x = gk & (bw - 1);
          const float* ab = above + (size_t)gr * bw;
          const float* lf = left + (size_t)gr * bh;
          const float a = ab[x], l = lf[y];
          const float below = lf[bh - 1], right = ab[bw - 1];
          const float al = sc[2 * (size_t)gr], dcv = sc[2 * (size_t)gr + 1];
          const float wh = whv[gk], ww = wwv[gk];
          const float vh = __fadd_rn(__fmul_rn(wh, a),
                                     __fmul_rn(__fsub_rn(256.0f, wh), below));
          const float hh = __fadd_rn(__fmul_rn(ww, l),
                                     __fmul_rn(__fsub_rn(256.0f, ww), right));
          const float tsm = __fadd_rn(
              __fadd_rn(vh, __fmul_rn(ww, l)),
              __fmul_rn(__fsub_rn(256.0f, ww), right));
          const float p1 = floorf(__fmul_rn(__fadd_rn(tsm, 256.0f),
                                            1.0f / 512.0f));
          const float p2 = floorf(__fmul_rn(__fadd_rn(vh, 128.0f),
                                            1.0f / 256.0f));
          const float p3 = floorf(__fmul_rn(__fadd_rn(hh, 128.0f),
                                            1.0f / 256.0f));
          const float b = __fsub_rn(__fadd_rn(l, a), al);
          const float pl = fabsf(__fsub_rn(b, l));
          const float pt = fabsf(__fsub_rn(b, a));
          const float ptl = fabsf(__fsub_rn(b, al));
          const float p4 = (pl <= pt && pl <= ptl) ? l
                           : (pt <= ptl ? a : al);
          const float px = blocks[(size_t)gr * n2 + gk];
          res[0] = bf16_round(__fsub_rn(px, dcv));
          res[1] = bf16_round(__fsub_rn(px, p1));
          res[2] = bf16_round(__fsub_rn(px, p2));
          res[3] = bf16_round(__fsub_rn(px, p3));
          res[4] = bf16_round(__fsub_rn(px, p4));
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) As[p][k][r] = res[p];
      }
      for (int idx = tid; idx < TK * TN; idx += NT) {
        const int k = idx / TN, c = idx % TN;
        const int gc = c0 + c;
        Bs[k][c] = gc < n2
                       ? __bfloat162float(kt[(size_t)(k0 + k) * n2 + gc])
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < TK; ++k) {
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int p = 0; p < NP; ++p) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = As[p][k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[p][i][j] = fmaf(a, b[j], acc[p][i][j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gr = row0 + ty + 16 * i;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gc = c0 + tx * 4 + j;
          if (gr < R && gc < n2)
            s = __fadd_rn(s, lane_cost(fabsf(acc[p][i][j]), inv[gc],
                                       scale[gc], bias[gc], lam));
        }
        for (int off = 8; off >= 1; off >>= 1)
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
        run[p][i] = __fadd_rn(run[p][i], s);
      }
    }
  }

  if (tx != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= R) continue;
#pragma unroll
    for (int p = 0; p < NP; ++p) out[(size_t)gr * NP + p] = run[p][i];
  }
}

}  // namespace

extern "C" int pass1_nd_cost(const float* above, const float* left,
                             const float* sc, const float* blocks,
                             const void* kt, const float* whv,
                             const float* wwv, const float* inv,
                             const float* scale, const float* bias, float lam,
                             float* out, int R, int bw, int bh,
                             cudaStream_t stream) {
  int lbw = 0;
  while ((1 << lbw) < bw) ++lbw;
  const dim3 grid((R + TM - 1) / TM);
  nd_cost_kernel<<<grid, NT, 0, stream>>>(
      above, left, sc, blocks, static_cast<const __nv_bfloat16*>(kt), whv,
      wwv, inv, scale, bias, lam, out, R, bw, bh, lbw);
  return static_cast<int>(cudaGetLastError());
}
