// RGB -> YCbCr conversion, own translation unit: compiled with
// -ffp-contract=off so no FMA contraction changes the float32 rounding
// relative to the numpy host pipeline it mirrors bit-for-bit
// (ops/colorspace.rgb_to_ycbcr_host; reference formulas
// av1encoder.rs:504-512). Threaded over 64K-pixel chunks.

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {
void run_chunks(int chunks, int n_threads,
                void (*fn)(void*, int, int), void* ctx) {
  if (n_threads <= 1 || chunks < 4) {
    fn(ctx, 0, chunks);
    return;
  }
  std::vector<std::thread> ths;
  int per = (chunks + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int b0 = t * per, b1 = b0 + per < chunks ? b0 + per : chunks;
    if (b0 >= b1) break;
    ths.emplace_back(fn, ctx, b0, b1);
  }
  for (auto& th : ths) th.join();
}

struct Ctx {
  const uint8_t* rgb;
  long long n_px;
  float max_value, scale, shift, c0, c1, c2, wb, wr;
  int32_t* out;
};

void convert_chunks(void* vctx, int q0, int q1) {
  const Ctx& C = *(const Ctx*)vctx;
  long long i0 = (long long)q0 << 16, i1 = (long long)q1 << 16;
  if (i1 > C.n_px) i1 = C.n_px;
  for (long long i = i0; i < i1; i++) {
    float r = (float)C.rgb[3 * i], g = (float)C.rgb[3 * i + 1],
          b = (float)C.rgb[3 * i + 2];
    float y = C.c0 * r + C.c1 * g + C.c2 * b;
    float cb = (b * C.scale - y) * C.wb + C.shift;
    float cr = (r * C.scale - y) * C.wr + C.shift;
    float vy = std::floor(y + 0.5f);
    float vb = std::floor(cb + 0.5f);
    float vr = std::floor(cr + 0.5f);
    vy = vy < 0.0f ? 0.0f : (vy > C.max_value ? C.max_value : vy);
    vb = vb < 0.0f ? 0.0f : (vb > C.max_value ? C.max_value : vb);
    vr = vr < 0.0f ? 0.0f : (vr > C.max_value ? C.max_value : vr);
    C.out[3 * i] = (int32_t)vy;
    C.out[3 * i + 1] = (int32_t)vb;
    C.out[3 * i + 2] = (int32_t)vr;
  }
}
}  // namespace

extern "C" int cs_rgb_to_ycbcr(const uint8_t* rgb, long long n_px, int depth,
                               double kr, double kb, int n_threads,
                               int32_t* out) {
  Ctx C;
  C.rgb = rgb;
  C.n_px = n_px;
  C.out = out;
  C.max_value = (float)((1 << depth) - 1);
  C.scale = C.max_value / 255.0f;
  C.shift = std::nearbyintf(C.max_value * 0.5f);
  const double kg = 1.0 - kr - kb;
  C.c0 = (float)((double)C.scale * kr);
  C.c1 = (float)((double)C.scale * kg);
  C.c2 = (float)((double)C.scale * kb);
  C.wb = (float)(0.5 / (1.0 - kb));
  C.wr = (float)(0.5 / (1.0 - kr));
  int chunks = (int)((n_px + 65535) >> 16);
  run_chunks(chunks, n_threads, convert_chunks, &C);
  return 0;
}
