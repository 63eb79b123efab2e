// The directional-cost kernel on the bf16 tensor cores, one template for
// K1 (pass1_dir_cost.cu, the encoder's pass 1) and K4/K5 (dir_cost_tc.cu,
// the prototype harnesses). For every row r and candidate c, per lane
// k < n2,
//   cp   = sum_e bf16(ext[r, e]) * MK[e, c*n2 + k]          (f32 accumulate)
//   coef = bkt[r, k] - (cp * (1/32) + cc[k])
// and out[r, c] = sum_k u, the lane value u set by the variant V:
//   FULL      lane_cost(|coef|) (pass1_tc.cuh): K1's and K4's function
//   MM_ONLY   bf16(cp): no /32, no cc, no bkt
//   NO_QUANT  coef^2
//   NO_SIGN   l = floor(|coef * inv| + bias), e = coef - l * scale (coef's
//             sign kept, not the |coef| form), u = e^2 + lam (l + 2 [l != 0])
//   RED_BF16  bf16(lane_cost(|coef|))
// MM_ONLY and RED_BF16 round u to bf16 (nearest even) before the f32 sum,
// as the TPU's default-precision segment matmul did.
//
// Layout. A block of nt = 2 * TM threads owns TM rows (16 per warp, TM a
// launch parameter) and one chunk ch of LT = 8 * NTW lanes, and loops over
// all C candidates. It rounds and zero-pads its rows' ext to bf16 once in
// shared memory ([TM][SA], SA = 16 KS + PAD); each warp then holds its 16
// rows' A fragments in registers for every candidate, and each thread its
// 2 rows' bkt and its lanes' cc, inv, scale, bias. MK comes as pack_mk's
// (n2 / LT, C, LT, SA) tiles (ops/pass1_kernels.py): a candidate's tile is
// one stage of a three-stage ring of 16-byte cp.async copies, loaded while
// the block works on the candidate before it.
//
// The two reduce modes sum a (row, candidate) over the chunk's lanes:
//   REGS    each thread adds its 2 * NTW lanes in order, then the quad
//           butterfly (quad_sum);
//   STAGED  the counterpart of the TPU's 0/1 segment matmul: each warp
//           writes u to its own shared-memory slab of 16 rows x (LT + 8)
//           f32 (8-byte stores), then two threads per row each add
//           alternate groups of four lanes (16-byte loads; half 0 lanes
//           0-3, 8-11, ..., half 1 lanes 4-7, 12-15, ..., in that order),
//           then the two halves (a warp-level exchange: no block barrier).
// Each warp stages its 16 rows' sums of eight candidates at a time in
// shared memory and writes them out as whole 32-byte runs of a row (16-byte
// stores when C % 4 == 0): one sector per row and group, not eight
// scattered 4-byte stores. With n2 > LT the chunk partials go to part
// (chunk, row, candidate), laid out as out, and sum_chunks adds them in
// chunk order, element by element. Deterministic, no atomics; 64-bit
// offsets.
//
// Rounding: __fmul_rn / __fadd_rn around floor() so that nvcc cannot
// contract across it (pass1_tc.cuh lane_cost). The order of the tensor
// cores' f32 accumulation is not IEEE-defined, so costs differ from a
// CUDA-core or CPU sum in the last bits of cp.

#pragma once

#include "pass1_tc.cuh"

namespace pass1 {

enum Variant { FULL = 0, MM_ONLY = 1, NO_QUANT = 2, NO_SIGN = 3, RED_BF16 = 4 };
enum Reduce { STAGED = 0, REGS = 1 };

struct DirArgs {
  const float* ext;
  const float* bkt;
  const __nv_bfloat16* mk;  // packed tiles (pack_mk)
  const float* cc;
  const float* inv;
  const float* scale;
  const float* bias;
  float lam;
  float* out;
  float* part;  // (nch, R, C) chunk partials when nch > 1
  int R, E, n2, C, nch;
};

struct DirCfg {
  int TM, LT, NTW, KS, Ep, nch;
  size_t smem;
};

// TM rows per block, LT = min(n2, lt) lanes per chunk, E rounded up to
// KS k-steps of 16
inline DirCfg dir_config(int E, int n2, int tm, int lt, bool staged) {
  DirCfg c;
  c.TM = tm;
  c.LT = n2 < lt ? n2 : lt;
  c.NTW = c.LT / 8;
  c.KS = (E + 15) / 16;
  c.Ep = 16 * c.KS;
  c.nch = n2 / c.LT;
  c.smem = (size_t(NS) * c.LT + tm) * (c.Ep + PAD) * 2 + size_t(tm) * 8 * 4 +
           (staged ? size_t(tm) * (c.LT + 8) * 4 : 0);
  return c;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int V>
__device__ __forceinline__ float lane_value(float cp, float bkt, float cc,
                                            float inv, float scale,
                                            float bias, float lam) {
  if (V == MM_ONLY) return bf16_round(cp);
  const float coef = __fsub_rn(bkt, __fadd_rn(__fmul_rn(cp, 0.03125f), cc));
  if (V == NO_QUANT) return __fmul_rn(coef, coef);
  if (V == NO_SIGN) {
    const float l = floorf(__fadd_rn(fabsf(__fmul_rn(coef, inv)), bias));
    const float e = __fsub_rn(coef, __fmul_rn(l, scale));
    const float r = __fadd_rn(l, l != 0.0f ? 2.0f : 0.0f);
    return __fadd_rn(__fmul_rn(e, e), __fmul_rn(lam, r));
  }
  const float u = lane_cost(fabsf(coef), inv, scale, bias, lam);
  return V == RED_BF16 ? bf16_round(u) : u;
}

// Write a warp's staged sums os ([16][8]) of candidates cb .. cb + nb - 1
// for its rows r0 .. r0 + 15 of chunk ch to out (nch == 1) or part: lane l
// writes four of row l / 2.
__device__ __forceinline__ void flush_sums(const DirArgs& p, const float* os,
                                           long long r0, int cb, int nb,
                                           int ch, int lane) {
  const long long gr = r0 + (lane >> 1);
  if (gr >= p.R) return;
  float* dst = (p.nch == 1 ? p.out : p.part + (long long)ch * p.R * p.C) +
               gr * p.C + cb;
  const float* src = os + (lane >> 1) * 8;
  const int k0 = (lane & 1) * 4;
  if (nb == 8 && (p.C & 3) == 0) {
    *reinterpret_cast<float4*>(dst + k0) =
        *reinterpret_cast<const float4*>(src + k0);
  } else {
    for (int k = k0; k < k0 + 4 && k < nb; ++k) dst[k] = src[k];
  }
}

template <int KS, int NTW, int V, int RED>
__global__ void __launch_bounds__(NT) dir_tc_kernel(DirArgs p) {
  constexpr int LT = NTW * 8;
  constexpr int SA = KS * 16 + PAD;  // row stride of ext and MK tiles
  constexpr int stage = LT * SA;     // bf16 elements per ring stage
  // row stride of a warp's u slab: 8-byte stores of a quad's 16 lanes and
  // 16-byte loads of 8 (row, half) pairs each fall on distinct banks
  constexpr int SU = LT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nt = blockDim.x, tm = nt / 2;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [NS][LT][SA]
  __nv_bfloat16* xs = ring + NS * stage;                          // [tm][SA]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const long long row0 = (long long)blockIdx.x * tm;
  const int ch = blockIdx.y;
  const int C = p.C, n2 = p.n2;
  const __nv_bfloat16* mk = p.mk + (size_t)ch * C * stage;
  // after the ext tile: the warp's [16][8] slab of sums, then (STAGED) its
  // [16][SU] slab of lane values
  float* os = reinterpret_cast<float*>(xs + tm * SA) + warp * 16 * 8;
  float* us = reinterpret_cast<float*>(xs + tm * SA) + tm * 8 + warp * 16 * SU;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < C) stage_copy(ring + s * stage, mk + (size_t)s * stage,
                          stage * 2, tid, nt);
    cp_async_commit();
  }

  // ext of the block's rows, rounded to bf16 and zero-padded, once
  for (int idx = tid; idx < tm * (SA / 2); idx += nt) {
    const int r = idx / (SA / 2), k = 2 * (idx - r * (SA / 2));
    const long long gr = row0 + r;
    const float* x = p.ext + gr * p.E;
    const bool in = gr < p.R;
    const float v0 = in && k < p.E ? x[k] : 0.0f;
    const float v1 = in && k + 1 < p.E ? x[k + 1] : 0.0f;
    *reinterpret_cast<__nv_bfloat162*>(xs + r * SA + k) =
        __floats2bfloat162_rn(v0, v1);
  }

  // the thread's lanes ch * LT + j * 8 + tig * 2 + e and rows
  // warp * 16 + g + 8h: bkt and the lane constants, kept for every
  // candidate
  const int c0 = ch * LT + tig * 2;
  float bk[2][NTW][2], cc[NTW][2], inv[NTW][2], scl[NTW][2], bia[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = c0 + j * 8 + e;
      cc[j][e] = __ldg(p.cc + k);
      inv[j][e] = __ldg(p.inv + k);
      scl[j][e] = __ldg(p.scale + k);
      bia[j][e] = __ldg(p.bias + k);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        long long gr = row0 + warp * 16 + g + 8 * h;
        gr = gr < p.R ? gr : p.R - 1;
        bk[h][j][e] = __ldg(p.bkt + gr * n2 + k);
      }
    }

  __syncthreads();  // ext staged
  uint32_t a[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    load_a(a[ks], xs + warp * 16 * SA, SA, ks * 16, lane);

  for (int c = 0; c < C; ++c) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // candidate c's tile landed; c - 1's is free again
    const int nx = c + NS - 1;
    if (nx < C) stage_copy(ring + (nx % NS) * stage,
                           mk + (size_t)nx * stage, stage * 2, tid, nt);
    cp_async_commit();
    const __nv_bfloat16* bt = ring + (c % NS) * stage;

    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        uint32_t b[4];
        load_b2(b, bt, SA, jp * 16, ks * 16, lane);
        mma_bf16(acc[2 * jp], a[ks], b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a[ks], b[2], b[3]);
      }

    // element (j, 2h + e) of the fragments is row warp * 16 + g + 8h of
    // the block, lane c0 + j * 8 + e
    if (RED == REGS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s = __fadd_rn(s, lane_value<V>(acc[j][2 * h + e], bk[h][j][e],
                                           cc[j][e], inv[j][e], scl[j][e],
                                           bia[j][e], p.lam));
        s = quad_sum(s);
        if (tig == 0) os[(g + 8 * h) * 8 + (c & 7)] = s;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          float u[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            u[e] = lane_value<V>(acc[j][2 * h + e], bk[h][j][e], cc[j][e],
                                 inv[j][e], scl[j][e], bia[j][e], p.lam);
          *reinterpret_cast<float2*>(us + (g + 8 * h) * SU + j * 8 +
                                     tig * 2) = make_float2(u[0], u[1]);
        }
      __syncwarp();
      // row lane / 2; half lane & 1 adds lanes 8q + 4 half + (0..3), q in
      // order
      const float* up = us + (lane >> 1) * SU + (lane & 1) * 4;
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < LT / 8; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(up + 8 * q);
        s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, v.x), v.y), v.z),
                      v.w);
      }
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      if ((lane & 1) == 0) os[(lane >> 1) * 8 + (c & 7)] = s;
      __syncwarp();  // the slab is written again for the next candidate
    }
    if ((c & 7) == 7 || c == C - 1) {
      __syncwarp();
      flush_sums(p, os, row0 + warp * 16, c & ~7, (c & 7) + 1, ch, lane);
    }
  }
}

// Launch dir_tc_kernel on (R / TM, nch) blocks of 2 TM threads, then (nch
// > 1) sum_chunks; returns the first launch error.
template <int KS, int NTW, int V, int RED>
int dir_tc_launch(const DirArgs& p, const DirCfg& c, cudaStream_t stream) {
  auto kern = dir_tc_kernel<KS, NTW, V, RED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.R + c.TM - 1) / c.TM, c.nch);
  kern<<<grid, 2 * c.TM, c.smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || c.nch == 1) return static_cast<int>(err);
  const long long n = (long long)p.R * p.C;
  sum_chunks<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(p.part, p.out,
                                                                n, c.nch);
  return static_cast<int>(cudaGetLastError());
}

// info = {blocks of the main grid, registers per thread, dynamic shared
// memory bytes per block, blocks of the chunk-sum pass (0 if none)} of the
// configuration c on R rows and C candidates, whose kernel's attributes
// (attr) were read with error err
inline int dir_tc_info(const DirCfg& c, int R, int C, int err,
                       const cudaFuncAttributes& attr, int* info) {
  const long long n = (long long)R * C;
  info[0] = (R + c.TM - 1) / c.TM * c.nch;
  info[1] = err == 0 ? attr.numRegs : 0;
  info[2] = (int)c.smem;
  info[3] = c.nch > 1 ? (int)((n + NT - 1) / NT) : 0;
  return err;
}

}  // namespace pass1
