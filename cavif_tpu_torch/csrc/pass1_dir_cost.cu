// Directional-candidate costs of the device pass 1 (kernel K1).
//
// Replaces the TPU kernel `_fused_dir_cost` of
// cavif_tpu/ops/device_pass1.py (_cost_body). For every block row r and
// directional candidate c it computes, per coefficient lane k < n2,
//   cp   = sum_e bf16(ext[r, e]) * MK[e, c*n2 + k]          (f32 accumulate)
//   a    = |bkt[r, k] - (cp * (1/32) + cc[k])|
//   l    = floor(a * inv[k] + bias[k]),  e = a - l * scale[k]
//   u    = e * e + lam * (l + 2 * [l != 0])
// and writes out[r, c] = sum_k u. MK is the prediction matrix folded into
// the Kronecker DCT (bfloat16), so the (R, cdir * n2) coefficient tensor
// exists only in registers.
//
// What bounds it on an H100: operations. The product is 2 * R * E * cdir *
// n2 flops (0.186 TFLOP per 1 MP frame over the ten block shapes) against
// 15-32 MB read per launch, far above the card's ~295 flops per byte. This
// first version runs the product on the CUDA cores in f32 (the products of
// two bf16 values are exact in f32, so the sum differs from a tensor-core
// sum only in its order) with 4x4 register tiles from shared memory; the
// tensor cores (wgmma) are a later step. What the design does about the
// bound: the epilogue and the per-candidate reduction are fused behind the
// product, so no byte of the candidate tensor reaches device memory.
//
// Layout. A block owns 64 rows and one candidate (n2 >= 64, looping over the
// candidate's lanes 64 at a time) or 64 / n2 whole candidates (n2 < 64).
// Thread (ty, tx) of the 16 x 16 threads holds rows ty + 16 i and the four
// neighbouring columns 4 tx + j. A row's lane sum is the thread's four
// columns, then a fixed butterfly of warp shuffles over the threads that
// hold the same candidate, then a running sum over lane tiles in one
// thread: deterministic, no atomics.
//
// Rounding. The epilogue uses __fmul_rn / __fadd_rn so that nvcc cannot
// contract a * inv + bias (or e * e + lam * r) into an FMA, which would move
// floor() at level boundaries away from the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // rows per block
constexpr int TN = 64;   // columns per tile
constexpr int TK = 16;   // contraction chunk
constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float lane_cost(float a, float inv, float scale,
                                           float bias, float lam) {
  const float l = floorf(__fadd_rn(__fmul_rn(a, inv), bias));
  const float e = __fsub_rn(a, __fmul_rn(l, scale));
  const float r = __fadd_rn(l, l != 0.0f ? 2.0f : 0.0f);
  return __fadd_rn(__fmul_rn(e, e), __fmul_rn(lam, r));
}

__global__ void __launch_bounds__(NT)
dir_cost_kernel(const float* __restrict__ ext, const float* __restrict__ bkt,
                const __nv_bfloat16* __restrict__ mk,
                const float* __restrict__ cc, const float* __restrict__ inv,
                const float* __restrict__ scale,
                const float* __restrict__ bias, float lam,
                float* __restrict__ out, int R, int E, int n2, int cdir) {
  __shared__ float As[TK][TM + 1];             // ext tile, [k][row]
  __shared__ __align__(16) float Bs[TK][TN];   // MK tile, [k][col]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * TM;
  const int ncols = cdir * n2;
  const bool whole = n2 < TN;  // the tile holds TN / n2 whole candidates
  const int col_begin = whole ? blockIdx.y * TN : blockIdx.y * n2;
  const int col_end = whole ? min(col_begin + TN, ncols) : col_begin + n2;
  // threads sharing one candidate's columns within a tile row
  const int seg = whole ? n2 / 4 : 16;

  float run[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = col_begin; c0 < col_end; c0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < E; k0 += TK) {
      for (int idx = tid; idx < TM * TK; idx += NT) {
        const int r = idx / TK, k = idx % TK;
        const int gr = row0 + r, gk = k0 + k;
        float v = 0.0f;
        if (gr < R && gk < E)
          v = __bfloat162float(
              __float2bfloat16_rn(ext[(size_t)gr * E + gk]));
        As[k][r] = v;
      }
      for (int idx = tid; idx < TK * TN; idx += NT) {
        const int k = idx / TN, c = idx % TN;
        const int gk = k0 + k, gc = c0 + c;
        float v = 0.0f;
        if (gk < E && gc < col_end)
          v = __bfloat162float(mk[(size_t)gk * ncols + gc]);
        Bs[k][c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = As[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + ty + 16 * i;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gc = c0 + tx * 4 + j;
        if (gr < R && gc < col_end) {
          const int lane = gc & (n2 - 1);
          const float t = __fadd_rn(__fmul_rn(acc[i][j], 0.03125f), cc[lane]);
          const float a = fabsf(__fsub_rn(bkt[(size_t)gr * n2 + lane], t));
          s = __fadd_rn(s, lane_cost(a, inv[lane], scale[lane], bias[lane],
                                     lam));
        }
      }
      for (int off = seg / 2; off >= 1; off >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      run[i] = __fadd_rn(run[i], s);
    }
  }

  if (tx % seg != 0) return;
  const int cand = (col_begin + tx * 4) / n2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr < R && cand < cdir) out[(size_t)gr * cdir + cand] = run[i];
  }
}

}  // namespace

extern "C" int pass1_dir_cost(const float* ext, const float* bkt,
                              const void* mk, const float* cc,
                              const float* inv, const float* scale,
                              const float* bias, float lam, float* out,
                              int R, int E, int n2, int cdir,
                              cudaStream_t stream) {
  const int ncols = cdir * n2;
  const int gy = n2 < TN ? (ncols + TN - 1) / TN : cdir;
  const dim3 grid((R + TM - 1) / TM, gy);
  dir_cost_kernel<<<grid, NT, 0, stream>>>(
      ext, bkt, static_cast<const __nv_bfloat16*>(mk), cc, inv, scale, bias,
      lam, out, R, E, n2, cdir);
  return static_cast<int>(cudaGetLastError());
}
