// Fused motion estimation + motion compensation for the H.264 P-frame step.
//
// Replaces the TPU kernel selkies_tpu/models/h264/pallas_me.py
// (_me_mc_kernel, launched by pl.pallas_call in _me_mc_call). Python side,
// plain version and wrapper: selkies_tpu_torch/models/h264/me_mc.py.
//
// One thread block per 16x16 macroblock, 256 threads, one per luma pixel.
// Each thread keeps its current pixel in a register and walks the candidate
// list from device memory; a candidate's SAD is a __sad per thread, a
// warp-shuffle sum and an 8-entry shared-memory sum that every thread reads,
// so all threads hold the same running minimum. A strict '<' keeps the first
// minimum in candidate order, which is the winner of the JAX version's
// cost = SAD*scale + rank. The winner's luma prediction is written by all
// 256 threads, its half-pel bilinear U and V predictions by 64 threads each.
//
// The SAD is exact integer arithmetic (the TPU kernel's bf16/f32 tricks are
// not needed here). Bound: see me_mc.py. A candidate beyond MV_PAD traps
// (see the wrapper's error contract in me_mc.py).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMvPad = 40;  // numpy_ref.MV_PAD: edge padding of every reference plane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// floor(x / 2) for negative x too (the chroma offset of a luma MV, 8.4.1.4)
__device__ __forceinline__ int floor_half(int x) { return (x - (x & 1)) / 2; }

__global__ void __launch_bounds__(kThreads)
me_mc_kernel(const int32_t* __restrict__ cands, int ncand,
             const int32_t* __restrict__ cur, int h, int w,
             const uint8_t* __restrict__ ry, const uint8_t* __restrict__ ru,
             const uint8_t* __restrict__ rv,
             int32_t* __restrict__ mvs, int32_t* __restrict__ pred_y,
             int32_t* __restrict__ pred_u, int32_t* __restrict__ pred_v) {
  // double-buffered by candidate parity: one barrier per candidate suffices
  __shared__ int warp_sad[2][kWarps];

  const int mbx = blockIdx.x, mby = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int y0 = mby * 16 + (t >> 4);
  const int x0 = mbx * 16 + (t & 15);
  const int wp = w + 2 * kMvPad;

  const int a = cur[y0 * w + x0];
  const uint8_t* base = ry + (size_t)(y0 + kMvPad) * wp + (x0 + kMvPad);

  int best = INT_MAX;
  int best_k = 0;
  for (int k = 0; k < ncand; ++k) {
    const int dx = cands[2 * k], dy = cands[2 * k + 1];
    if (dx < -kMvPad || dx > kMvPad || dy < -kMvPad || dy > kMvPad) __trap();
    int d = (int)__sad(a, (int)base[dy * wp + dx], 0u);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) warp_sad[k & 1][warp] = d;
    __syncthreads();
    int sad = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sad += warp_sad[k & 1][i];
    if (sad < best) {
      best = sad;
      best_k = k;
    }
  }

  const int dx = cands[2 * best_k], dy = cands[2 * best_k + 1];
  pred_y[y0 * w + x0] = base[dy * wp + dx];
  if (t == 0) {
    const int m = mby * (w / 16) + mbx;
    mvs[2 * m] = dx;
    mvs[2 * m + 1] = dy;
  }
  if (t < 128) {
    // chroma (8.4.2.2.2): threads 0-63 predict U, 64-127 V, one pixel each
    const uint8_t* plane = t < 64 ? ru : rv;
    int32_t* out = t < 64 ? pred_u : pred_v;
    const int q = t & 63;
    const int cy0 = mby * 8 + (q >> 3), cx0 = mbx * 8 + (q & 7);
    const int cw = w / 2, cwp = cw + 2 * kMvPad;
    const int xf = 4 * (dx & 1), yf = 4 * (dy & 1);
    const uint8_t* p = plane + (size_t)(cy0 + kMvPad + floor_half(dy)) * cwp
                       + (cx0 + kMvPad + floor_half(dx));
    const int pa = p[0], pb = p[1], pc = p[cwp], pd = p[cwp + 1];
    out[cy0 * cw + cx0] = ((8 - xf) * (8 - yf) * pa + xf * (8 - yf) * pb
                           + (8 - xf) * yf * pc + xf * yf * pd + 32) >> 6;
  }
}

}  // namespace

// Launch on `stream` of `device`. Pointers are device memory: cands (ncand, 2)
// int32 (dx, dy) in rank order, cur (h, w) int32, ry (h+80, w+80) and ru/rv
// (h/2+80, w/2+80) uint8 edge-padded references; outputs mvs (h/16, w/16, 2),
// pred_y (h, w), pred_u/pred_v (h/2, w/2) int32. Returns cudaGetLastError().
extern "C" int selkies_me_mc(int device, void* stream, const void* cands, int ncand,
                             const void* cur, int h, int w, const void* ry,
                             const void* ru, const void* rv, void* mvs, void* pred_y,
                             void* pred_u, void* pred_v) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(w / 16, h / 16);
  me_mc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cands, ncand, (const int32_t*)cur, h, w, (const uint8_t*)ry,
      (const uint8_t*)ru, (const uint8_t*)rv, (int32_t*)mvs, (int32_t*)pred_y,
      (int32_t*)pred_u, (int32_t*)pred_v);
  return (int)cudaGetLastError();
}

extern "C" const char* selkies_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
