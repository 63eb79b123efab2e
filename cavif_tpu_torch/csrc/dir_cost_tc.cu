// Directional-candidate costs on the bf16 tensor cores (kernels K4, K5).
//
// Replaces the TPU kernels of the pass-1 prototype harnesses:
//   K4 `pallas_fused` of tools/pallas_proto.py  (entry point dir_cost_tc)
//   K5 `make` of tools/pallas_proto2.py         (entry point dir_ablation_tc)
// Both compute K1's function (csrc/pass1_dir_cost.cu) as one fused tile:
// for every row r and candidate c, per coefficient lane k < n2,
//   cp   = sum_e bf16(ext[r, e]) * MK[e, c*n2 + k]    (mma.sync, f32 acc)
//   coef = bkt[r, k] - (cp * (1/32) + cc[k])
//   lv   = sign(t) floor(|t| + bias[k]),  t = coef * inv[k]
//   u    = (coef - lv * scale[k])^2 + lam (|lv| + 2 [lv != 0])
// and out[r, c] = sum_k u. K5's variants change the lane value u:
//   full      u as above (K4's function)
//   mm_only   bf16(cp): no /32, no cc, no bkt
//   no_quant  coef^2
//   no_sign   lv = floor(|t| + bias) with no sign, so coef - lv * scale
//             keeps coef's sign (not K1's |coef| form)
//   red_bf16  bf16(u)
// mm_only and red_bf16 round their lane value to bf16 (round to nearest
// even) before the f32 sum, as the TPU's default-precision segment matmul
// did.
//
// The two reduce modes of K4 give the same value up to summation order:
//   STAGED ("matmul", the TPU's 0/1 segment matmul at HIGHEST precision):
//     u goes to shared memory, one thread sums each (row, candidate)
//     segment of the tile in lane order;
//   REGS ("loop"): each thread sums its own columns, then a fixed butterfly
//     over the four threads of a quad that share a row.
// Both are deterministic (no atomics). K5 always reduces STAGED.
//
// What bounds it on an H100: the epilogue. The product is 2 E flops per
// (row, column) element on the tensor cores (E <= 129), the epilogue about
// 16 CUDA-core FP32 instructions per element; at 989 TFLOP/s bf16 against
// 132 SMs x 128 lanes x ~1.98 GHz that is 0.26 us against 0.52 us per
// million elements (for E = 129), and more so at smaller E. This first
// version is simple: mma.sync m16n8k16 from shared memory, no wgmma, TMA
// or pipelining; the fused epilogue keeps the (R, C*n2) coefficient tensor
// out of device memory, which is what bounds the unfused XLA formulation.
//
// Layout. A block of four warps owns TM rows (each warp TM/4 rows as
// 16-row mma slabs) and TN columns of MK: TN / n2 whole candidates when
// n2 < TN, else one candidate whose n2 / TN column tiles it walks in order
// with a running sum. The ext tile (TM x Ep) is rounded to bf16 and padded
// with zeros to Ep = E rounded up to 16 in shared memory; the MK tile is
// stored transposed ([column][k]) so every fragment is one 32-bit load.
// Rows past R and columns past C*n2 are zero and never written.
//
// Rounding. The epilogue uses __fmul_rn / __fadd_rn so that nvcc cannot
// contract across a floor() boundary, as in pass1_dir_cost.cu. The order
// of the tensor cores' f32 accumulation is not IEEE-defined, so costs
// differ from a CUDA-core or CPU sum in the last bits of cp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block: four warps
constexpr int PAD = 8;   // bf16 elements of padding per shared-memory row

enum Variant { FULL = 0, MM_ONLY = 1, NO_QUANT = 2, NO_SIGN = 3, RED_BF16 = 4 };
enum Reduce { STAGED = 0, REGS = 1 };

struct Args {
  const float* ext;
  const float* bkt;
  const __nv_bfloat16* mk;
  const float* cc;
  const float* inv;
  const float* scale;
  const float* bias;
  float lam;
  float* out;
  int R, E, Ep, n2, C;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// sum over the four threads of a quad (the threads holding one row)
__device__ __forceinline__ float quad_sum(float s) {
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  return __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
}

// The lane value u of variant V from the product cp of one element.
template <int V>
__device__ __forceinline__ float lane_value(float cp, float bkt, float cc,
                                            float inv, float scale,
                                            float bias, float lam) {
  if (V == MM_ONLY) return bf16_round(cp);
  const float coef = __fsub_rn(bkt, __fadd_rn(__fmul_rn(cp, 0.03125f), cc));
  if (V == NO_QUANT) return __fmul_rn(coef, coef);
  float l, e;
  if (V == NO_SIGN) {
    l = floorf(__fadd_rn(fabsf(__fmul_rn(coef, inv)), bias));
    e = __fsub_rn(coef, __fmul_rn(l, scale));
  } else {
    // inv > 0, so |t| = |coef| * inv and coef - lv * scale is
    // sign(coef) (|coef| - l * scale): its square is bitwise the same
    const float a = fabsf(coef);
    l = floorf(__fadd_rn(__fmul_rn(a, inv), bias));
    e = __fsub_rn(a, __fmul_rn(l, scale));
  }
  const float r = __fadd_rn(l, l != 0.0f ? 2.0f : 0.0f);
  const float u = __fadd_rn(__fmul_rn(e, e), __fmul_rn(lam, r));
  return V == RED_BF16 ? bf16_round(u) : u;
}

template <int TM, int TN, int V, int RED>
__global__ void __launch_bounds__(NT) dir_cost_tc_kernel(Args p) {
  static_assert(TM % 64 == 0 && TN % 8 == 0, "tile shape");
  constexpr int MI = TM / 64;  // 16-row mma slabs per warp
  constexpr int NJ = TN / 8;   // 8-column mma tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = p.Ep + PAD;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [TM][lda]
  __nv_bfloat16* Bs = As + TM * lda;                            // [TN][lda]
  float* Us = reinterpret_cast<float*>(Bs + TN * lda);  // [TM][TN + 1]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * TM;
  const int n2 = p.n2, ncols = p.C * n2;
  const bool whole = n2 < TN;  // the tile holds TN / n2 whole candidates
  const int col_begin = whole ? blockIdx.y * TN : blockIdx.y * n2;
  const int ntiles = whole ? 1 : n2 / TN;

  for (int idx = tid; idx < TM * p.Ep; idx += NT) {
    const int r = idx / p.Ep, k = idx - r * p.Ep;
    const int gr = row0 + r;
    const float v = (gr < p.R && k < p.E) ? p.ext[(size_t)gr * p.E + k] : 0.0f;
    As[r * lda + k] = __float2bfloat16_rn(v);
  }

  float run[MI][2];  // REGS, one candidate: running row sums over tiles
  float srun = 0.0f;  // STAGED, one candidate: row tid's running sum
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) run[mi][0] = run[mi][1] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = col_begin + t * TN;
    if (t > 0) __syncthreads();  // the last tile's Bs and Us are read
    for (int idx = tid; idx < p.Ep * TN; idx += NT) {
      const int k = idx / TN, c = idx - k * TN;
      const int gc = c0 + c;
      Bs[c * lda + k] = (k < p.E && gc < ncols)
                            ? p.mk[(size_t)k * ncols + gc]
                            : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();

    float acc[MI][NJ][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.0f;

    for (int k0 = 0; k0 < p.Ep; k0 += 16) {
      uint32_t b[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* bp = Bs + (j * 8 + g) * lda + k0 + tig * 2;
        b[j][0] = ld32(bp);
        b[j][1] = ld32(bp + 8);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const __nv_bfloat16* ap =
            As + ((warp * MI + mi) * 16 + g) * lda + k0 + tig * 2;
        const uint32_t a0 = ld32(ap), a1 = ld32(ap + 8 * lda);
        const uint32_t a2 = ld32(ap + 8), a3 = ld32(ap + 8 * lda + 8);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16(acc[mi][j], a0, a1, a2, a3, b[j][0], b[j][1]);
      }
    }

    // epilogue on the fragments: element (mi, j, 2h + e) is row
    // (warp * MI + mi) * 16 + g + 8h, column j * 8 + tig * 2 + e
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = (warp * MI + mi) * 16 + g + 8 * h;
        const int gr = row0 + rl;
        const float* bk = p.bkt + (size_t)min(gr, p.R - 1) * n2;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = j * 8 + tig * 2 + e;
            const int gc = c0 + c;
            const int k = gc & (n2 - 1);
            const float u =
                gc < ncols ? lane_value<V>(acc[mi][j][2 * h + e], __ldg(bk + k),
                                           __ldg(p.cc + k), __ldg(p.inv + k),
                                           __ldg(p.scale + k),
                                           __ldg(p.bias + k), p.lam)
                           : 0.0f;
            if (RED == STAGED) {
              Us[rl * (TN + 1) + c] = u;
            } else {
              s = __fadd_rn(s, u);
            }
          }
          // REGS: a segment of whole candidates ends after this 8-column
          // tile (uniform over the warp, so every lane shuffles)
          if (RED == REGS && whole && (((j + 1) * 8) & (n2 - 1)) == 0) {
            s = quad_sum(s);
            const int cand = (c0 + j * 8) / n2;
            if (tig == 0 && gr < p.R && cand < p.C)
              p.out[(size_t)gr * p.C + cand] = s;
            s = 0.0f;
          }
        }
        if (RED == REGS && !whole) run[mi][h] = __fadd_rn(run[mi][h],
                                                          quad_sum(s));
      }
    }

    if (RED == STAGED) {
      __syncthreads();
      if (whole) {
        const int nseg = TN / n2;
        for (int q = tid; q < TM * nseg; q += NT) {
          const int r = q / nseg, sg = q - r * nseg;
          const float* up = Us + r * (TN + 1) + sg * n2;
          float s = 0.0f;
          for (int k = 0; k < n2; ++k) s = __fadd_rn(s, up[k]);
          const int gr = row0 + r, cand = (c0 + sg * n2) / n2;
          if (gr < p.R && cand < p.C) p.out[(size_t)gr * p.C + cand] = s;
        }
      } else if (tid < TM) {
        const float* up = Us + tid * (TN + 1);
        float s = 0.0f;
        for (int k = 0; k < TN; ++k) s = __fadd_rn(s, up[k]);
        srun = __fadd_rn(srun, s);
      }
    }
  }

  if (whole) return;
  const int cand = blockIdx.y;
  if (RED == STAGED) {
    if (tid < TM && row0 + tid < p.R)
      p.out[(size_t)(row0 + tid) * p.C + cand] = srun;
    return;
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + (warp * MI + mi) * 16 + g + 8 * h;
      if (tig == 0 && gr < p.R) p.out[(size_t)gr * p.C + cand] = run[mi][h];
    }
}

template <int TM, int TN, int V, int RED>
int launch(const Args& p, cudaStream_t stream) {
  auto kern = dir_cost_tc_kernel<TM, TN, V, RED>;
  const size_t smem = size_t(TM + TN) * (p.Ep + PAD) * 2 +
                      (RED == STAGED ? size_t(TM) * (TN + 1) * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncols = p.C * p.n2;
  const dim3 grid((p.R + TM - 1) / TM,
                  p.n2 < TN ? (ncols + TN - 1) / TN : p.C);
  kern<<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int V, int RED>
int dispatch_tile(const Args& p, int tm, int tn, cudaStream_t stream) {
  if (tm == 64 && tn == 64) return launch<64, 64, V, RED>(p, stream);
  if (tm == 128 && tn == 64) return launch<128, 64, V, RED>(p, stream);
  if (tm == 64 && tn == 128) return launch<64, 128, V, RED>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const float* ext, const float* bkt, const void* mk,
               const float* cc, const float* inv, const float* scale,
               const float* bias, float lam, float* out, int R, int E,
               int n2, int C) {
  return Args{ext, bkt, static_cast<const __nv_bfloat16*>(mk), cc, inv,
              scale, bias, lam, out, R, E, (E + 15) / 16 * 16, n2, C};
}

}  // namespace

// K4: reduce 0 = "matmul" (staged segment sum), 1 = "loop" (registers).
extern "C" int dir_cost_tc(const float* ext, const float* bkt, const void* mk,
                           const float* cc, const float* inv,
                           const float* scale, const float* bias, float lam,
                           float* out, int R, int E, int n2, int C, int tm,
                           int tn, int reduce, cudaStream_t stream) {
  const Args p = make_args(ext, bkt, mk, cc, inv, scale, bias, lam, out, R,
                           E, n2, C);
  if (reduce == 0) return dispatch_tile<FULL, STAGED>(p, tm, tn, stream);
  if (reduce == 1) return dispatch_tile<FULL, REGS>(p, tm, tn, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5: variant 0..4 = full, mm_only, no_quant, no_sign, red_bf16.
extern "C" int dir_ablation_tc(const float* ext, const float* bkt,
                               const void* mk, const float* cc,
                               const float* inv, const float* scale,
                               const float* bias, float lam, float* out,
                               int R, int E, int n2, int C, int variant,
                               int tm, int tn, cudaStream_t stream) {
  const Args p = make_args(ext, bkt, mk, cc, inv, scale, bias, lam, out, R,
                           E, n2, C);
  switch (variant) {
    case FULL: return dispatch_tile<FULL, STAGED>(p, tm, tn, stream);
    case MM_ONLY: return dispatch_tile<MM_ONLY, STAGED>(p, tm, tn, stream);
    case NO_QUANT: return dispatch_tile<NO_QUANT, STAGED>(p, tm, tn, stream);
    case NO_SIGN: return dispatch_tile<NO_SIGN, STAGED>(p, tm, tn, stream);
    case RED_BF16: return dispatch_tile<RED_BF16, STAGED>(p, tm, tn, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
