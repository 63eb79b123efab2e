// Nondirectional-predictor costs of the device pass 1 (kernel K2), on the
// bf16 tensor cores.
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
// What bounds it on an H100: operations, 5 * 2 * R * n2^2 tensor-core flops
// (0.085 TFLOP per 1 MP frame) beside about 12 FP32 instructions per (row,
// predictor, lane) for the quantizer and 47 per pixel for the predictors;
// the predictors' CUDA-core work sets the bound at every shape but the
// three 32-wide ones (chip_smoke.py prints both terms).
//
// Design (in brackets, the faults of the earlier CUDA-core version).
// - The product runs on the tensor cores [it ran on the CUDA cores in f32]:
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix. The
//   residuals are bf16 by construction and KT is bf16, so the products are
//   the same; only the order of the f32 sum differs from the plain version.
//   mma.sync rather than wgmma: the five predictors of 16 rows make five
//   16-row slabs, not the 64-row warpgroup tile wgmma needs, and the bound
//   sits on the CUDA cores (predictors, quantizer), not on the product.
// - A block owns TM rows and one chunk of LT output lanes. It builds the
//   residuals of its rows once, for every pixel, into shared memory as five
//   bf16 slabs [p][row][pixel] [rebuilt for every 64-lane tile], and its
//   eight warps walk the chunk's lanes against KT tiles. Each warp holds
//   all five predictors of 16 rows for 8 * NTW lanes, so each B fragment
//   feeds five products.
// - Tiles follow n2 [64-lane tiles with 48 or 32 zero lanes at n2 16, 32]:
//     n2     LT   KC  warps (rows x lanes)  TM   chunks  residual smem
//     16     16   16  8 x 1 (16 lanes)      128  1       30 KB
//     32     32   32  8 x 1 (32 lanes)      128  1       50 KB
//     64     64   32  4 x 2                 64   1       45 KB
//     128    128  32  2 x 4                 32   1       42 KB
//     256+   256  32  1 x 8                 16   n2/256  41 / 81 / 161 KB
//   Blocks per 1 MP three-plane frame: 1536 at 4x4, 768 at every other
//   shape [48 at 32x32, 96 at 32x16 / 16x32, one block of 183 registers
//   per SM]. The residuals of a row are built n2 / 256 times at 32x16 and
//   32x32 (2 and 4 times), once elsewhere [n2 / 64 times]: 2 * 5 * n2 bytes
//   of shared memory per row and build.
// - KT streams through a three-stage ring of 16-byte cp.async copies [one
//   buffer, loads widened to f32, a barrier between load and compute]. It
//   is laid out once per ShapeCost (ops/pass1_kernels.pack_kt) as
//   (chunk, k-chunk, LT, KC + 8) bf16 tiles, each a ring stage in the order
//   the ldmatrix loads want, zero-padded by 8 so that rows land in distinct
//   bank groups; the kernel converts nothing.
// - Chunks of a row's lanes (n2 > 256) are summed by a second small kernel
//   in chunk order; inside a block a row's lane sum is the thread's own
//   lanes, a quad butterfly, then the warps in lane order. Deterministic,
//   no atomics.
// - Rounding: the predictors are sums of integer products below 2^24, exact
//   in f32 whatever the order, and PAETH keeps the reference's <= tie order;
//   the epilogue keeps __fmul_rn / __fadd_rn (pass1_tc.cuh lane_cost).
//
// Registers: 80 (n2 = 16), 128 (NTW = 4); shared memory 35 KB (n2 = 16) to
// 229 KB (n2 = 1024, one block per SM) per block.
//
// Measured (chip_smoke.py, CUDA events, NVIDIA H100 80GB HBM3 at 700 W):
// 0.878 ms per 1 MP frame over the ten shapes, against a bound of 0.136 ms
// and 0.345 ms for one torch.matmul of the bf16 product alone (the
// CUDA-core version: 7.05 ms). At n2 <= 256 (0.036-0.061 ms a shape) the
// host's time to issue a wrapper call is 74-97% of it: those calls are
// bound by the host, not the card. At 32x16 / 16x32 (0.137 ms, bound
// 0.016) and 32x32 (0.254 ms, bound 0.033) they are not: there a block of
// eight warps fills an SM's shared memory alone (147 / 229 KB), builds its
// residuals before its first product and meets a barrier every two
// k-steps, and mma.sync reaches at most half the bf16 peak the bound
// counts.

#include "pass1_tc.cuh"

namespace {

using namespace pass1;

constexpr int NP = 5;  // predictors

struct Cfg {
  int LT, KC, NTW, WN, TM, nk, nch;
  size_t smem;
};

Cfg config(int n2) {
  Cfg c;
  c.LT = n2 < 256 ? n2 : 256;
  const int wc = c.LT < 32 ? c.LT : 32;  // lanes per warp
  c.NTW = wc / 8;
  c.WN = c.LT / wc;
  c.TM = 16 * (8 / c.WN);
  c.KC = n2 < 32 ? n2 : 32;
  c.nk = n2 / c.KC;
  c.nch = n2 / c.LT;
  c.smem = size_t(NS) * c.LT * (c.KC + PAD) * 2 +
           size_t(NP) * c.TM * (n2 + PAD) * 2 + size_t(c.WN) * NP * c.TM * 4;
  return c;
}

struct Args {
  const float* above;
  const float* left;
  const float* sc;
  const float* blocks;
  const __nv_bfloat16* kt;  // packed tiles (pack_kt)
  const float* whv;
  const float* wwv;
  const float* inv;
  const float* scale;
  const float* bias;
  float lam;
  float* out;
  float* part;
  int R, bw, bh, lbw, n2, LT, KC, WN, TM, nk, nch;
};

// The five residuals of pixel k of row gr, each rounded to bf16, exactly
// as the plain version nd_preds builds them.
__device__ __forceinline__ void residuals(const Args& p, long long gr, int k,
                                          float (&res)[NP]) {
  const int y = k >> p.lbw, x = k & (p.bw - 1);
  const float* ab = p.above + gr * p.bw;
  const float* lf = p.left + gr * p.bh;
  const float a = ab[x], l = lf[y];
  const float below = lf[p.bh - 1], right = ab[p.bw - 1];
  const float al = p.sc[2 * gr], dcv = p.sc[2 * gr + 1];
  const float wh = __ldg(p.whv + k), ww = __ldg(p.wwv + k);
  const float vh = __fadd_rn(__fmul_rn(wh, a),
                             __fmul_rn(__fsub_rn(256.0f, wh), below));
  const float hh = __fadd_rn(__fmul_rn(ww, l),
                             __fmul_rn(__fsub_rn(256.0f, ww), right));
  const float tsm = __fadd_rn(__fadd_rn(vh, __fmul_rn(ww, l)),
                              __fmul_rn(__fsub_rn(256.0f, ww), right));
  const float p1 = floorf(__fmul_rn(__fadd_rn(tsm, 256.0f), 1.0f / 512.0f));
  const float p2 = floorf(__fmul_rn(__fadd_rn(vh, 128.0f), 1.0f / 256.0f));
  const float p3 = floorf(__fmul_rn(__fadd_rn(hh, 128.0f), 1.0f / 256.0f));
  const float b = __fsub_rn(__fadd_rn(l, a), al);
  const float pl = fabsf(__fsub_rn(b, l));
  const float pt = fabsf(__fsub_rn(b, a));
  const float ptl = fabsf(__fsub_rn(b, al));
  const float p4 = (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? a : al);
  const float px = p.blocks[gr * p.n2 + k];
  res[0] = __fsub_rn(px, dcv);
  res[1] = __fsub_rn(px, p1);
  res[2] = __fsub_rn(px, p2);
  res[3] = __fsub_rn(px, p3);
  res[4] = __fsub_rn(px, p4);
}

template <int NTW>
__global__ void __launch_bounds__(NT) nd_cost_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n2 = p.n2, TM = p.TM, WN = p.WN;
  const int SB = p.KC + PAD, SA = n2 + PAD;
  const int stage = p.LT * SB;  // bf16 elements per ring stage
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [NS][LT][SB]
  __nv_bfloat16* res = ring + NS * stage;             // [NP][TM][SA]
  float* red = reinterpret_cast<float*>(res + NP * TM * SA);  // [WN][NP][TM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / WN, wn = warp - wm * WN;
  const long long row0 = (long long)blockIdx.x * TM;
  const int ch = blockIdx.y;
  const __nv_bfloat16* kt = p.kt + (size_t)ch * p.nk * stage;

  // the ring's first stages load while the residuals are built
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < p.nk) stage_copy(ring + s * stage, kt + (size_t)s * stage,
                             stage * 2, tid);
    cp_async_commit();
  }

  const int half = n2 >> 1;
  for (int idx = tid; idx < TM * half; idx += NT) {
    const int r = idx / half, k = 2 * (idx - r * half);
    const long long gr = row0 + r;
    float v0[NP] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float v1[NP] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (gr < p.R) {
      residuals(p, gr, k, v0);
      residuals(p, gr, k + 1, v1);
    }
#pragma unroll
    for (int q = 0; q < NP; ++q)
      *reinterpret_cast<__nv_bfloat162*>(res + (q * TM + r) * SA + k) =
          __floats2bfloat162_rn(v0[q], v1[q]);
  }

  float acc[NP][NTW][4];
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.0f;

  const __nv_bfloat16* slab = res + wm * 16 * SA;  // predictor q at + q*TM*SA
  const int n0 = wn * NTW * 8;                     // warp's first lane in LT
  for (int kc = 0; kc < p.nk; ++kc) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage kc landed; stage kc - 1 is free again
    const int nx = kc + NS - 1;
    if (nx < p.nk) stage_copy(ring + (nx % NS) * stage,
                              kt + (size_t)nx * stage, stage * 2, tid);
    cp_async_commit();
    const __nv_bfloat16* bt = ring + (kc % NS) * stage;
    for (int ks = 0; ks < p.KC; ks += 16) {
      uint32_t b[NTW][2];
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        uint32_t t[4];
        load_b2(t, bt, SB, n0 + jp * 16, ks, lane);
        b[2 * jp][0] = t[0];
        b[2 * jp][1] = t[1];
        b[2 * jp + 1][0] = t[2];
        b[2 * jp + 1][1] = t[3];
      }
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        uint32_t a[4];
        load_a(a, slab + q * TM * SA, SA, kc * p.KC + ks, lane);
#pragma unroll
        for (int j = 0; j < NTW; ++j) mma_bf16(acc[q][j], a, b[j][0], b[j][1]);
      }
    }
  }

  // epilogue on the fragments: element (q, j, 2h + e) is row
  // wm * 16 + g + 8h, lane ch * LT + n0 + j * 8 + tig * 2 + e
  const int c0 = ch * p.LT + n0 + tig * 2;
  float inv[NTW][2], scl[NTW][2], bia[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      inv[j][e] = __ldg(p.inv + c0 + j * 8 + e);
      scl[j][e] = __ldg(p.scale + c0 + j * 8 + e);
      bia[j][e] = __ldg(p.bias + c0 + j * 8 + e);
    }
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s = __fadd_rn(s, lane_cost(fabsf(acc[q][j][2 * h + e]), inv[j][e],
                                     scl[j][e], bia[j][e], p.lam));
      s = quad_sum(s);
      if (tig == 0) red[(wn * NP + q) * TM + wm * 16 + g + 8 * h] = s;
    }
  __syncthreads();
  for (int t = tid; t < NP * TM; t += NT) {
    const int r = t / NP, q = t - r * NP;
    float s = red[q * TM + r];
    for (int w = 1; w < WN; ++w) s = __fadd_rn(s, red[(w * NP + q) * TM + r]);
    const long long gr = row0 + r;
    if (gr >= p.R) continue;
    if (p.nch == 1)
      p.out[gr * NP + q] = s;
    else
      p.part[((long long)ch * p.R + gr) * NP + q] = s;
  }
}

template <int NTW>
int launch(const Args& p, const Cfg& c, cudaStream_t stream) {
  auto kern = nd_cost_kernel<NTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.R + c.TM - 1) / c.TM, c.nch);
  kern<<<grid, NT, c.smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || c.nch == 1) return static_cast<int>(err);
  const long long n = (long long)p.R * NP;
  sum_chunks<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
      p.part, p.out, n, n, c.nch, p.R, NP, 0);
  return static_cast<int>(cudaGetLastError());
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace

// part: nch * R * 5 floats of scratch when n2 > 256 (else unused).
extern "C" int pass1_nd_cost(const float* above, const float* left,
                             const float* sc, const float* blocks,
                             const void* kt_tiles, const float* whv,
                             const float* wwv, const float* inv,
                             const float* scale, const float* bias, float lam,
                             float* out, float* part, int R, int bw, int bh,
                             cudaStream_t stream) {
  const int n2 = bw * bh;
  const Cfg c = config(n2);
  const Args p{above, left, sc, blocks,
               static_cast<const __nv_bfloat16*>(kt_tiles), whv, wwv, inv,
               scale, bias, lam, out, part, R, bw, bh, log2i(bw), n2, c.LT,
               c.KC, c.WN, c.TM, c.nk, c.nch};
  if (c.NTW == 2) return launch<2>(p, c, stream);
  return launch<4>(p, c, stream);
}

// info = {blocks of the main grid, registers per thread, dynamic shared
// memory bytes per block, blocks of the chunk-sum pass (0 if none)}
extern "C" int pass1_nd_cost_info(int R, int bw, int bh, int* info) {
  const Cfg c = config(bw * bh);
  cudaFuncAttributes attr;
  const cudaError_t err = c.NTW == 2
                              ? cudaFuncGetAttributes(&attr, nd_cost_kernel<2>)
                              : cudaFuncGetAttributes(&attr, nd_cost_kernel<4>);
  const long long n = (long long)R * NP;
  info[0] = (R + c.TM - 1) / c.TM * c.nch;
  info[1] = attr.numRegs;
  info[2] = (int)c.smem;
  info[3] = c.nch > 1 ? (int)((n + NT - 1) / NT) : 0;
  return static_cast<int>(err);
}
