// 13-candidate intra RD costs of the whole-plane block search (kernel K3),
// on the f16 tensor cores in split precision.
//
// Replaces the TPU kernel `_pallas_kernel` of
// cavif_tpu/ops/pallas_search.py (pallas_call at l.252). For every aligned
// n x n block (n in {4, 8, 16, 32}) it builds the 13 candidates in the
// CAND_MODES order (DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, D45, D135,
// D113, D157, D203, D67 at delta 0) exactly in integers, takes each
// residual through the 2-D DCT
//   coef = D (blk - pred) D^T
// and prices it with the deadzone quantizer
//   l = floor(|coef| * inv + bias),  e = |coef| - l * scale
//   cost = sum e^2 + lam * (sum l + 2 * #(l != 0))  (+ 7 lam for diagonals)
// with the DC coefficient [0, 0] at its own inv / scale / bias. Output:
// (NB, 13) f32 costs, each block's 13 as one contiguous run; argmin and min
// run in torch.
//
// What bounds it on an H100: operations, and not the products. Per tier
// over three 1024x1024 planes (3.1 M pixels) the quantizer alone is about
// 11 FP32 instructions per (block, candidate, coefficient), 0.0134 ms at
// the CUDA cores' issue rate; the predictors add about as much again. The
// separable DCT's 13 * NB * 4 n^3 flops take 0.0013-0.0053 ms at the
// tensor cores' fp16 rate and run beside them; the bytes (planes once, the
// costs once) 0.0045-0.0075 ms. The design puts the products on the
// tensor cores, keeps every residual, coefficient and sum in registers (no
// shared-memory round trip, no block barrier after the constants land) and
// leaves the CUDA cores to the predictors and the quantizer, in FP32 and
// integer instructions only: the conversion unit issues 16 instructions
// per clock per SM against 128 FP32 ones, so no integer enters f16, no
// float is floored and no level becomes an integer through it (opair,
// quant); only the split of T in the separable form packs f32 pairs to
// f16 (one F2FP per pair).
//
// Numerics: split fp16. mma.sync.m16n8k16 takes f16 operands and sums in
// f32. Pixels and predictions lie in [0, 1023] at 8 and 10 bits; as the
// f16 values 1024 + v their differences, the residuals, are exact. Each
// constant is split once on the host (ops/search_kernels.pack_split) as
// C = C_hi + 2^-12 C_lo, both f16, about 22 bits together; each half has
// its own f32 accumulator, combined as acc_hi + 2^-12 acc_lo. In the
// separable form the intermediate T = D R is split the same way before the
// second product, and
//   coef = T_hi D_hi^T + 2^-12 (T_lo D_hi^T + T_hi D_lo^T)
// (T_lo D_lo^T, at 2^-24, is dropped). One f16 product per pass, without
// the lo halves, puts more than 1e-3 of the costs beyond rtol 2e-4 of the
// f32 plain version at n >= 8 (tests/test_torch_search_tc.py), and bf16
// far more; the split puts none there at n <= 16 and a few level flips at
// n = 32, with no argmin difference beyond the float64 oracle's near-ties.
//
// Ties. The kernel no longer repeats the plain version's (mode_cost_ref)
// f32 operations in its order: the tensor cores sum in their own order.
// Exact mathematical ties between candidates (two predictors with equal
// residual energy, common on flat 4x4 blocks) are then broken by rounding
// noise, differently from the plain version, whose own f32 sums break such
// ties against a float64 oracle about as often. So kernel and plain version
// are held to a tie-aware rule (chip_smoke.py, search_kernels.near_ties):
// an argmin difference counts only where the float64 oracle prices the two
// picks more than rtol 1e-5 apart. Every float operation outside the
// tensor cores is a separate IEEE multiply or add (no FMA contraction
// around floor(), as pass1_tc.cuh lane_cost; the one FMA, hi + 2^-12 lo,
// has an exact product), sums run in a fixed order (thread, then quad or
// warp butterfly), no atomics: two launches are bit-equal, and so are the
// rows of a launch over fewer blocks.
//
// Form per tier.
// - Kronecker (n = 4, 8): vec(C) = vec(R) (D(x)D)^T, one product with
//   K = n^2 and no hand-off between passes. A warp owns 16 blocks; an A
//   fragment is 16 blocks' residual rows of one candidate (m16 = blocks,
//   k = pixels), held in registers across the candidates, the B operand
//   the split (D(x)D)^T in mma fragment order (16 bytes per lane per
//   (k-step, 8 coefficients): hi b0, b1, lo b0, b1), resident in shared
//   memory (1 and 16 KB).
// - Separable (n = 16, 32): a warp owns one block. Pass 1 T = D R (A = D
//   from shared memory by ldmatrix, B = residuals built in registers), two
//   accumulators; pass 2 C = T D^T. The pass-1 accumulators of two
//   neighbouring 8-column tiles are, element for element, the A fragment of
//   one 16-deep k-step of pass 2 (row g, columns 2t, 2t+1 and 2t+8, 2t+9),
//   so T moves to pass 2 in registers, split into f16 pairs, with no
//   shuffle and no shared memory. The Kronecker matrix would be 2 MB at
//   n = 32; at n = 16 (256 KB, read through L1 from device memory, 224
//   registers, one CTA per SM) it measured 4.0-4.2x slower than this form
//   (PERF.md) and is not built.
// - The quantizer runs on each f32 coefficient where the mma leaves it. The
//   DC coefficient sits in lane 0 (separable) or in the lanes t = 0 of the
//   first 8-coefficient tile (Kronecker), element 0 (and 2): those
//   elements take per-lane parameters chosen once, every other element the
//   AC ones, with no per-element test.
// Candidates are a compile-time loop: each candidate's predictor is
// straight-line integer code. A block's pixels (as f16 pairs) and its
// neighbours (in the warp's slice of shared memory) are read once for all
// 13 candidates.
//
// Grid: persistent. Every CTA of eight warps loads the taps table, the
// SMOOTH weights and the split constants once, and its warps stride over
// the units of the whole grid (16 blocks; one block; at n = 32 half a
// block's candidates): min(units / 8, the CTAs that fit on the SMs at
// once). No barrier after the constants: the warps run independently
// (__syncwarp around their neighbour slices).
//
// Precondition: 0 <= pixels, neighbours <= 1023 (bit depths 8 and 10, the
// only ones the port encodes); not checked on the device, but the block
// search's entry points refuse deeper planes (block_search.search_inputs).
//
// Measured: chip_smoke.py's [k3] lines time every tier on the card beside
// its bound and the CUDA-core version's time (PERF.md section 6 keeps
// them). Without the predictors or without the quantizer (a scratch
// ablation) each tier lost similar shares of its time, both together about
// half: the rest is the products, their operand loads and the hand-offs.

#include "pass1_tc.cuh"

#include <type_traits>

namespace {

using namespace pass1;

constexpr int NC = 13;   // candidates
constexpr int NND = 7;   // nondirectional candidates
constexpr int NW = NT / 32;
constexpr int GB = 16;   // blocks per warp unit in the Kronecker form
constexpr float LO = 1.0f / 4096.0f;  // 2^-12, the lo halves' scale

struct Args {
  const int* blocks;
  const int* above;
  const int* left;
  const int* scal;
  const int* ext;
  const int* taps;
  const int* smw;
  const void* tiles;  // pack_split(dct)
  float inv_ac, scale_ac, bias_ac, inv_dc, scale_dc, bias_dc, lam;
  float* out;
  int NB;
};

// ints of one block's neighbours in a warp's slice: above (n), left (n),
// scal (2), ext (4n + 1), padded to 16 bytes
template <int N>
__host__ __device__ constexpr int nb_ints() {
  return (2 * N + 2 + 4 * N + 1 + 3) / 4 * 4;
}

// The warp's slice of `cnt` consecutive blocks from b0 (zeros past NB).
template <int N>
__device__ __forceinline__ void stage_neighbours(const Args& p, long long b0,
                                                 int cnt, int nb, int* w,
                                                 int lane) {
  constexpr int E = 4 * N + 1;
  int* abv = w;
  int* lft = abv + cnt * N;
  int* scs = lft + cnt * N;
  int* ext = scs + cnt * 2;
  for (int i = lane; i < cnt * N; i += 32) {
    const bool ok = i < nb * N;
    abv[i] = ok ? p.above[b0 * N + i] : 0;
    lft[i] = ok ? p.left[b0 * N + i] : 0;
  }
  for (int i = lane; i < cnt * 2; i += 32)
    scs[i] = i < nb * 2 ? p.scal[b0 * 2 + i] : 0;
  for (int i = lane; i < cnt * E; i += 32)
    ext[i] = i < nb * E ? p.ext[b0 * E + i] : 0;
}

// Predictor of candidate C at pixel (i, j) of a block whose neighbours
// start at a (above), l (left), s (scal = [al, dc]), x (ext); the
// reference's integer rounding.
template <int N, int C>
__device__ __forceinline__ int pred(const int* a, const int* l, const int* s,
                                    const int* x, const int* tps,
                                    const int* sw, int i, int j) {
  if constexpr (C == 0) {
    return s[1];
  } else if constexpr (C == 1) {
    return a[j];
  } else if constexpr (C == 2) {
    return l[i];
  } else if constexpr (C <= 5) {
    const int wh = sw[i], ww = sw[j];
    const int below = l[N - 1], right = a[N - 1];
    if constexpr (C == 3)
      return (wh * a[j] + (256 - wh) * below + ww * l[i] +
              (256 - ww) * right + 256) >> 9;
    else if constexpr (C == 4)
      return (wh * a[j] + (256 - wh) * below + 128) >> 8;
    else
      return (ww * l[i] + (256 - ww) * right + 128) >> 8;
  } else if constexpr (C == 6) {
    const int al = s[0], li = l[i], aj = a[j];
    const int b = li + aj - al;
    const int pl = abs(b - li), pt = abs(b - aj), ptl = abs(b - al);
    return (pl <= pt && pl <= ptl) ? li : (pt <= ptl ? aj : al);
  } else {
    const int tap = tps[(C - NND) * N * N + i * N + j];
    return (x[tap & 255] * ((tap >> 8) & 255) +
            x[(tap >> 16) & 255] * ((tap >> 24) & 255) + 16) >> 5;
  }
}

__device__ __forceinline__ uint32_t h2bits(__half2 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (1024 + v0, 1024 + v1) as an f16 pair, for 0 <= v < 1024: the f16 bit
// pattern of 1024 + v is 0x6400 | v, so integers enter the tensor cores'
// operand type by a byte permute and an OR, not by the conversion unit
// (16 instructions per clock per SM against 128 for FP32). The difference
// of two such pairs is the exact integer difference.
__device__ __forceinline__ __half2 opair(int v0, int v1) {
  const uint32_t b = __byte_perm(v0, v1, 0x5410) | 0x64006400u;
  return *reinterpret_cast<const __half2*>(&b);
}

// Deadzone quantizer of one coefficient: lane_cost's rounding (no FMA
// around floor), the squared error and the rate accumulated apart. For
// 0 <= x < 2^23, adding 2^23 rounded toward zero drops x's fraction, so
// floor is two FP32 adds (not FRND), and the rate stays a float: sums of
// small integers, exact below 2^24, with no F2I.
__device__ __forceinline__ void quant(float c, float inv, float scale,
                                      float bias, float& err, float& rate) {
  const float a = fabsf(c);
  const float x = __fadd_rn(__fmul_rn(a, inv), bias);
  const float l = __fsub_rn(__fadd_rz(x, 8388608.0f), 8388608.0f);
  const float e = __fsub_rn(a, __fmul_rn(l, scale));
  err = __fadd_rn(err, __fmul_rn(e, e));
  rate = __fadd_rn(rate, __fadd_rn(l, l != 0.0f ? 2.0f : 0.0f));
}

// hi + 2^-12 lo: the product is exact, so the FMA rounds as the add alone
__device__ __forceinline__ float combine(float hi, float lo) {
  return __fmaf_rn(lo, LO, hi);
}

template <int C>
__device__ __forceinline__ float cost_of(const Args& p, float err,
                                         float rate) {
  float c = __fadd_rn(err, __fmul_rn(p.lam, rate));
  if constexpr (C >= NND) c = __fadd_rn(c, __fmul_rn(p.lam, 7.0f));
  return c;
}

// f(integral_constant<int, C>) for C = 0 .. NC - 1, in order
template <int C = 0, class F>
__device__ __forceinline__ void each_candidate(F&& f) {
  if constexpr (C < NC) {
    f(std::integral_constant<int, C>{});
    each_candidate<C + 1>(f);
  }
}

// shared memory of one CTA: [B tiles][taps 6 n^2][smw n][warp slices]
template <int N>
__host__ __device__ constexpr int consts_ints() {
  return 6 * N * N + (N + 3) / 4 * 4;
}

__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes,
                                       int tid) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (int i = tid; i < bytes / 16; i += NT) d[i] = s[i];
}

// ---------------------------------------------------------------- Kronecker

template <int N>
__host__ __device__ constexpr int kron_tile_bytes() {
  return N * N * N * N * 4;  // hi and lo, f16
}

template <int N>
__host__ __device__ constexpr size_t kron_smem() {
  return kron_tile_bytes<N>() + 4 * consts_ints<N>() + 4 * NW * (GB * nb_ints<N>() + GB * NC);
}

// CTAs per SM that the register budget must allow: at n = 8 three (80
// registers; two at the compiler's own 94 ran slower), at n = 4 five (48).
template <int N>
__global__ void __launch_bounds__(NT, N == 4 ? 5 : 3) kron_kernel(Args p) {
  constexpr int N2 = N * N;
  constexpr int KS = N2 / 16;  // k-steps over pixels
  constexpr int NTL = N2 / 8;  // 8-coefficient tiles
  extern __shared__ __align__(16) unsigned char smem[];
  copy16(smem, p.tiles, kron_tile_bytes<N>(), threadIdx.x);
  const uint4* kt = reinterpret_cast<const uint4*>(smem);
  int* tps = reinterpret_cast<int*>(smem + kron_tile_bytes<N>());
  int* sw = tps + 6 * N2;
  for (int i = threadIdx.x; i < 6 * N2; i += NT) tps[i] = p.taps[i];
  for (int i = threadIdx.x; i < N; i += NT) sw[i] = p.smw[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* wsl = tps + consts_ints<N>() + warp * (GB * nb_ints<N>() + GB * NC);
  int* abv = wsl;
  int* lft = abv + GB * N;
  int* scs = lft + GB * N;
  int* ext = scs + GB * 2;
  float* stage = reinterpret_cast<float*>(wsl + GB * nb_ints<N>());
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  // DC parameters of this lane's first coefficient column (column 0 when
  // t == 0)
  const float inv0 = t == 0 ? p.inv_dc : p.inv_ac;
  const float scale0 = t == 0 ? p.scale_dc : p.scale_ac;
  const float bias0 = t == 0 ? p.bias_dc : p.bias_ac;
  const int units = (p.NB + GB - 1) / GB;
  for (int u = blockIdx.x * NW + warp; u < units; u += gridDim.x * NW) {
    const long long b0 = static_cast<long long>(u) * GB;
    const int nb = min(GB, static_cast<int>(p.NB - b0));
    __syncwarp();
    stage_neighbours<N>(p, b0, GB, nb, wsl, lane);
    __syncwarp();

    // pixel pairs of the A fragments: rows g, g + 8 (blocks), pixels
    // k = 16 ks + 8 h + 2 t (+1)
    auto load_px = [&](int ks, int h, int r) -> __half2 {
      const int row = g + 8 * r;
      const int k = 16 * ks + 8 * h + 2 * t;
      if (row >= nb) return opair(0, 0);
      const int2 v = *reinterpret_cast<const int2*>(
          p.blocks + (b0 + row) * N2 + k);
      return opair(v.x, v.y);
    };
    __half2 px[KS][2][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) px[ks][h][r] = load_px(ks, h, r);

    each_candidate([&](auto cc) {
      constexpr int C = decltype(cc)::value;
      uint32_t A[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = g + 8 * r;
            const int k = 16 * ks + 8 * h + 2 * t;
            const int i = k / N, j = k % N;
            const int* a = abv + row * N;
            const int* l = lft + row * N;
            const int* s = scs + row * 2;
            const int* x = ext + row * (4 * N + 1);
            const __half2 pr = opair(pred<N, C>(a, l, s, x, tps, sw, i, j),
                                     pred<N, C>(a, l, s, x, tps, sw, i, j + 1));
            A[ks][r + 2 * h] = h2bits(__hsub2(px[ks][h][r], pr));
          }
      float err[2] = {0.0f, 0.0f};
      float rate[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        float ch[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float cl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const uint4 b = kt[(ks * NTL + nt) * 32 + lane];
          mma_f16(ch, A[ks], b.x, b.y);
          mma_f16(cl, A[ks], b.z, b.w);
        }
        // element e: block g + 8 (e >> 1), coefficient 8 nt + 2 t + (e & 1)
        const bool first = nt == 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float c = combine(ch[e], cl[e]);
          if ((e & 1) == 0)
            quant(c, first ? inv0 : p.inv_ac, first ? scale0 : p.scale_ac,
                  first ? bias0 : p.bias_ac, err[e >> 1], rate[e >> 1]);
          else
            quant(c, p.inv_ac, p.scale_ac, p.bias_ac, err[e >> 1],
                  rate[e >> 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float e = quad_sum(err[r]);
        const float q = quad_sum(rate[r]);
        if (t == 0) stage[(g + 8 * r) * NC + C] = cost_of<C>(p, e, q);
      }
    });
    __syncwarp();
    float* o = p.out + b0 * NC;
    for (int i = lane; i < nb * NC; i += 32) o[i] = stage[i];
  }
}

// ---------------------------------------------------------------- separable

template <int N>
__host__ __device__ constexpr int sep_ld() {
  return N + PAD;  // f16 elements per row of the D tiles
}

template <int N>
__host__ __device__ constexpr size_t sep_smem() {
  return 2 * N * sep_ld<N>() * 2 + 4 * consts_ints<N>() +
         4 * NW * nb_ints<N>();
}

// CTAs per SM that the register budget must allow: at n = 32 two (128
// registers, no spills; one at the compiler's own 152 ran slower), at
// n = 16 four (64).
template <int N>
__global__ void __launch_bounds__(NT, N == 32 ? 2 : 4) sep_kernel(Args p) {
  constexpr int N2 = N * N;
  constexpr int LD = sep_ld<N>();
  constexpr int KS = N / 16;   // 16-deep k-steps (both passes)
  constexpr int NTN = N / 8;   // 8-column tiles
  constexpr int MT = N / 16;   // 16-row tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __half* dhi = reinterpret_cast<__half*>(smem);
  __half* dlo = dhi + N * LD;
  copy16(dhi, p.tiles, 2 * N * LD * 2, threadIdx.x);
  int* tps = reinterpret_cast<int*>(dlo + N * LD);
  int* sw = tps + 6 * N2;
  for (int i = threadIdx.x; i < 6 * N2; i += NT) tps[i] = p.taps[i];
  for (int i = threadIdx.x; i < N; i += NT) sw[i] = p.smw[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* wsl = tps + consts_ints<N>() + warp * nb_ints<N>();
  const int* abv = wsl;
  const int* lft = abv + N;
  const int* scs = lft + N;
  const int* ext = scs + 2;
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const float inv0 = lane == 0 ? p.inv_dc : p.inv_ac;
  const float scale0 = lane == 0 ? p.scale_dc : p.scale_ac;
  const float bias0 = lane == 0 ? p.bias_dc : p.bias_ac;
  // a unit is one block's candidates c0 .. c1 - 1: all 13, or at n = 32
  // the nondirectional seven and the six diagonals on two warps, so that
  // 3,072 blocks spread over more warps than fit at once with no tail
  constexpr int PARTS = N == 32 ? 2 : 1;
  const long long units = static_cast<long long>(p.NB) * PARTS;
  for (long long u = blockIdx.x * NW + warp; u < units;
       u += gridDim.x * NW) {
    const long long b = u / PARTS;
    const int c0 = PARTS == 1 || u % PARTS == 0 ? 0 : NND;
    const int c1 = PARTS == 1 || u % PARTS == 1 ? NC : NND;
    __syncwarp();
    stage_neighbours<N>(p, b, 1, 1, wsl, lane);
    __syncwarp();

    // pass-1 B fragments: residual pairs (i, j), (i + 1, j) with
    // i = 16 ks + 8 h + 2 t, j = 8 nt + g
    const int* blk = p.blocks + b * N2;
    __half2 px[KS][NTN][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * ks + 8 * h + 2 * t, j = 8 * nt + g;
          px[ks][nt][h] = opair(blk[i * N + j], blk[(i + 1) * N + j]);
        }

    float mine = 0.0f;  // lane c keeps candidate c's cost
    each_candidate([&](auto cc) {
      constexpr int C = decltype(cc)::value;
      if (C < c0 || C >= c1) return;  // the warp's part only (uniform)
      uint32_t B[KS][NTN][2];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 16 * ks + 8 * h + 2 * t, j = 8 * nt + g;
            const __half2 pr =
                opair(pred<N, C>(abv, lft, scs, ext, tps, sw, i, j),
                      pred<N, C>(abv, lft, scs, ext, tps, sw, i + 1, j));
            B[ks][nt][h] = h2bits(__hsub2(px[ks][nt][h], pr));
          }

      // pass 1: T = D R, then T split into the A fragments of pass 2
      uint32_t th[MT][KS][4], tl[MT][KS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float ah[NTN][4], al[NTN][4];
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) ah[nt][e] = al[nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t fh[4], fl[4];
          load_a(fh, dhi + 16 * mt * LD, LD, 16 * ks, lane);
          load_a(fl, dlo + 16 * mt * LD, LD, 16 * ks, lane);
#pragma unroll
          for (int nt = 0; nt < NTN; ++nt) {
            mma_f16(ah[nt], fh, B[ks][nt][0], B[ks][nt][1]);
            mma_f16(al[nt], fl, B[ks][nt][0], B[ks][nt][1]);
          }
        }
        // accumulator (row g + 8 (e >> 1), column 8 nt + 2 t + (e & 1)) of
        // tiles 2m, 2m + 1 = A fragment of k-step m: a[2 (nt & 1) + (e >> 1)]
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float v0 = combine(ah[nt][2 * hr], al[nt][2 * hr]);
            const float v1 = combine(ah[nt][2 * hr + 1], al[nt][2 * hr + 1]);
            const __half2 hi = __floats2half2_rn(v0, v1);  // one F2FP
            const float2 hf = __half22float2(hi);
            const __half2 lo = __floats2half2_rn(
                __fmul_rn(__fsub_rn(v0, hf.x), 4096.0f),
                __fmul_rn(__fsub_rn(v1, hf.y), 4096.0f));
            th[mt][nt >> 1][2 * (nt & 1) + hr] = h2bits(hi);
            tl[mt][nt >> 1][2 * (nt & 1) + hr] = h2bits(lo);
          }
      }

      // pass 2: C = T D^T = T_hi D_hi^T + 2^-12 (T_lo D_hi^T + T_hi D_lo^T)
      float err = 0.0f;
      float rate = 0.0f;
#pragma unroll
      for (int np = 0; np < NTN / 2; ++np) {
        uint32_t bh[KS][4], bl[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          load_b2(bh[ks], dhi, LD, 16 * np, 16 * ks, lane);
          load_b2(bl[ks], dlo, LD, 16 * np, 16 * ks, lane);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float cm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            float cl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              mma_f16(cm, th[mt][ks], bh[ks][2 * q], bh[ks][2 * q + 1]);
              mma_f16(cl, tl[mt][ks], bh[ks][2 * q], bh[ks][2 * q + 1]);
              mma_f16(cl, th[mt][ks], bl[ks][2 * q], bl[ks][2 * q + 1]);
            }
            // element 0 of the first tile is C[0][0] in lane 0
            const bool first = mt == 0 && np == 0 && q == 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float c = combine(cm[e], cl[e]);
              if (first && e == 0)
                quant(c, inv0, scale0, bias0, err, rate);
              else
                quant(c, p.inv_ac, p.scale_ac, p.bias_ac, err, rate);
            }
          }
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        err = __fadd_rn(err, __shfl_xor_sync(0xffffffffu, err, off));
        rate = __fadd_rn(rate, __shfl_xor_sync(0xffffffffu, rate, off));
      }
      if (lane == C) mine = cost_of<C>(p, err, rate);
    });
    if (lane >= c0 && lane < c1) p.out[b * NC + lane] = mine;
  }
}

// ------------------------------------------------------------------ launch

// the form per block size: Kronecker at n = 4, 8, separable at 16, 32
template <int N>
constexpr bool is_kron() {
  return N <= 8;
}

template <int N>
auto kernel_fn() {
  if constexpr (is_kron<N>())
    return kron_kernel<N>;
  else
    return sep_kernel<N>;
}

template <int N>
constexpr size_t smem_bytes() {
  if constexpr (is_kron<N>())
    return kron_smem<N>();
  else
    return sep_smem<N>();
}

// {grid blocks, CTAs per SM} of a launch over NB blocks: one unit (GB
// blocks, or one) per warp, or fewer CTAs, each looping, where the units
// outnumber the warps that fit on the card at once
template <int N>
cudaError_t geometry(int NB, int* grid, int* per_sm) {
  const auto fn = kernel_fn<N>();
  constexpr size_t smem = smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, NT, smem);
  if (err != cudaSuccess) return err;
  // units: GB blocks (Kronecker), one block, or half a block at n = 32
  const int units =
      is_kron<N>() ? (NB + GB - 1) / GB : (N == 32 ? 2 * NB : NB);
  const int want = (units + NW - 1) / NW;
  *grid = min(want, max(*per_sm, 1) * sms);
  return cudaSuccess;
}

template <int N>
int launch(const Args& p, cudaStream_t stream) {
  int grid = 0, per_sm = 0;
  cudaError_t err = geometry<N>(p.NB, &grid, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (is_kron<N>())
    kron_kernel<N><<<grid, NT, smem_bytes<N>(), stream>>>(p);
  else
    sep_kernel<N><<<grid, NT, smem_bytes<N>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int info(int NB, int* out) {
  int grid = 0, per_sm = 0;
  cudaError_t err = geometry<N>(NB, &grid, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel_fn<N>());
  out[0] = grid;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(smem_bytes<N>());
  out[3] = per_sm;
  return static_cast<int>(err);
}

template <class Fn>
int dispatch(int n, Fn&& fn) {
  switch (n) {
    case 4: return fn(std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// tiles: pack_split(dct) (f16), in the form of n.
extern "C" int mode_search_cost(const int* blocks, const int* above,
                                const int* left, const int* scal,
                                const int* ext, const int* taps,
                                const int* smw, const void* tiles,
                                float inv_ac, float scale_ac, float bias_ac,
                                float inv_dc, float scale_dc, float bias_dc,
                                float lam, float* out, int NB, int n,
                                cudaStream_t stream) {
  const Args p{blocks, above, left, scal, ext, taps, smw, tiles,
               inv_ac, scale_ac, bias_ac, inv_dc, scale_dc, bias_dc,
               lam, out, NB};
  return dispatch(n, [&](auto nn) {
    return launch<decltype(nn)::value>(p, stream);
  });
}

// info = {grid blocks, registers per thread, dynamic shared memory bytes per
// block, blocks resident per SM}
extern "C" int mode_search_cost_info(int NB, int n, int* out) {
  return dispatch(n, [&](auto nn) {
    return info<decltype(nn)::value>(NB, out);
  });
}
