// BGRx -> I420 (BT.601 limited range) as one hand-written kernel.
//
// Replaces no Pallas kernel. On the batched serving tick it stands in for the
// XLA conversion of selkies_tpu/ops/colorspace.py (bgrx_to_i420) and for the
// host's native/frameprep.cc, which the service ran per session on the host's
// cores. Python side, contract and plain version: selkies_tpu_torch/ops/
// colorspace.py (bgrx_to_i420, bgrx_to_i420_plain).
//
// What bounds it on an H100: its bytes. Every input byte is read once and every
// output byte written once, with ~15 integer operations a pixel: 8 x 1088 x
// 1920 BGRx frames are 66,846,720 bytes in and 25,067,520 bytes of planes out,
// 0.0274 ms at 3.35 TB/s. The design is a single streaming pass:
//
// - One thread owns a run of kRun = 8 pixels (4 2x2 quads) along a row pair:
//   two 16-byte loads from each of the two rows, then an 8-byte store of Y per
//   row and a 4-byte store each of U and V. Adjacent threads take adjacent
//   runs, so a warp's loads cover 1 KiB of one row pair in full lines.
// - The grid is column runs x row pairs flattened (x) by sessions (y); nothing
//   goes through shared memory and nothing is reused, so loads and stores
//   carry the streaming cache hint (read once, written once).
// - A geometry whose width is not a multiple of kRun, or a buffer not aligned
//   for the vector accesses, takes the same arithmetic one quad a thread with
//   byte accesses.
//
// Arithmetic: int32, the fixed-point matrix of the plain version, Y clipped to
// 16..235 and U/V to 16..240 at full resolution, then the rounded 2x2 mean
// (sum + 2) >> 2 of U and V; equal to the plain version byte for byte.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRun = 8;  // pixels a thread owns along a row pair
constexpr int kThreads = 256;

__device__ __forceinline__ int clip(int x, int lo, int hi) { return min(max(x, lo), hi); }

// One BGRx pixel, as a little-endian word (B in the low byte).
__device__ __forceinline__ void mix(uint32_t px, int& y, int& u, int& v) {
  const int b = px & 0xFF, g = (px >> 8) & 0xFF, r = (px >> 16) & 0xFF;
  y = clip(((66 * r + 129 * g + 25 * b + 128) >> 8) + 16, 16, 235);
  u = clip(((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128, 16, 240);
  v = clip(((112 * r - 94 * g - 18 * b + 128) >> 8) + 128, 16, 240);
}

// One 2x2 quad: pixels a0 a1 over b0 b1 -> their four Y and the quad's U, V.
__device__ __forceinline__ void quad(uint32_t a0, uint32_t a1, uint32_t b0, uint32_t b1,
                                     int ya[2], int yb[2], int& u, int& v) {
  int u0, u1, u2, u3, v0, v1, v2, v3;
  mix(a0, ya[0], u0, v0);
  mix(a1, ya[1], u1, v1);
  mix(b0, yb[0], u2, v2);
  mix(b1, yb[1], u3, v3);
  u = (u0 + u1 + u2 + u3 + 2) >> 2;
  v = (v0 + v1 + v2 + v3 + 2) >> 2;
}

struct Args {
  const uint8_t* bgrx;  // (n, h, w, 4)
  uint8_t* y;           // (n, h, w)
  uint8_t* u;           // (n, h/2, w/2)
  uint8_t* v;
  int h, w;
};

// The vector pass: a thread a run of kRun pixels over a row pair.
__global__ void __launch_bounds__(kThreads) bgrx_i420_runs(Args a) {
  const int runs = a.w / kRun;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= runs * (a.h / 2)) return;
  const int pair = t / runs, x = (t % runs) * kRun;
  const int64_t n = blockIdx.y;
  const int64_t hw = int64_t(a.h) * a.w, cw = a.w / 2;
  const int64_t row0 = n * hw + int64_t(2 * pair) * a.w + x;  // pixel index
  const uint4* p0 = reinterpret_cast<const uint4*>(a.bgrx + 4 * row0);
  const uint4* p1 = reinterpret_cast<const uint4*>(a.bgrx + 4 * (row0 + a.w));
  const uint4 r0a = __ldcs(p0), r0b = __ldcs(p0 + 1), r1a = __ldcs(p1), r1b = __ldcs(p1 + 1);
  const uint32_t top[kRun] = {r0a.x, r0a.y, r0a.z, r0a.w, r0b.x, r0b.y, r0b.z, r0b.w};
  const uint32_t bot[kRun] = {r1a.x, r1a.y, r1a.z, r1a.w, r1b.x, r1b.y, r1b.z, r1b.w};
  uint32_t ytop[2] = {0, 0}, ybot[2] = {0, 0}, us = 0, vs = 0;
#pragma unroll
  for (int q = 0; q < kRun / 2; ++q) {
    int ya[2], yb[2], u, v;
    quad(top[2 * q], top[2 * q + 1], bot[2 * q], bot[2 * q + 1], ya, yb, u, v);
    const int word = q / 2, shift = 16 * (q % 2);
    ytop[word] |= uint32_t(ya[0] | ya[1] << 8) << shift;
    ybot[word] |= uint32_t(yb[0] | yb[1] << 8) << shift;
    us |= uint32_t(u) << (8 * q);
    vs |= uint32_t(v) << (8 * q);
  }
  __stcs(reinterpret_cast<uint2*>(a.y + row0), make_uint2(ytop[0], ytop[1]));
  __stcs(reinterpret_cast<uint2*>(a.y + row0 + a.w), make_uint2(ybot[0], ybot[1]));
  const int64_t c = n * (hw / 4) + int64_t(pair) * cw + x / 2;
  __stcs(reinterpret_cast<uint32_t*>(a.u + c), us);
  __stcs(reinterpret_cast<uint32_t*>(a.v + c), vs);
}

__device__ __forceinline__ uint32_t pixel(const uint8_t* p) {
  return p[0] | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
}

// The byte pass: a thread a quad, any even geometry, any alignment.
__global__ void __launch_bounds__(kThreads) bgrx_i420_quads(Args a) {
  const int cw = a.w / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cw * (a.h / 2)) return;
  const int pair = t / cw, x = 2 * (t % cw);
  const int64_t n = blockIdx.y;
  const int64_t hw = int64_t(a.h) * a.w;
  const int64_t row0 = n * hw + int64_t(2 * pair) * a.w + x, row1 = row0 + a.w;
  int ya[2], yb[2], u, v;
  quad(pixel(a.bgrx + 4 * row0), pixel(a.bgrx + 4 * row0 + 4), pixel(a.bgrx + 4 * row1),
       pixel(a.bgrx + 4 * row1 + 4), ya, yb, u, v);
  a.y[row0] = ya[0];
  a.y[row0 + 1] = ya[1];
  a.y[row1] = yb[0];
  a.y[row1 + 1] = yb[1];
  const int64_t c = n * (hw / 4) + int64_t(pair) * cw + x / 2;
  a.u[c] = u;
  a.v[c] = v;
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

}  // namespace

// n frames of h x w (both even) -> their planes, on ``stream`` of ``device``.
// Returns the CUDA error of the launch (0 on success).
extern "C" int selkies_bgrx_to_i420(int device, void* stream, int n, int h, int w,
                                    const void* bgrx, void* y, void* u, void* v) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const uint8_t*)bgrx, (uint8_t*)y, (uint8_t*)u, (uint8_t*)v, h, w};
  // the vector pass's accesses: 16 bytes of BGRx, 8 of Y, 4 of U and V, at
  // every run of every row (w % kRun == 0 keeps each row's start aligned)
  const bool runs = w % kRun == 0 && aligned(bgrx, 16) && aligned(y, 8) && aligned(u, 4) &&
                    aligned(v, 4);
  const int per_frame = runs ? (w / kRun) * (h / 2) : (w / 2) * (h / 2);
  const dim3 grid((per_frame + kThreads - 1) / kThreads, n);
  if (runs)
    bgrx_i420_runs<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    bgrx_i420_quads<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* selkies_bgrx_to_i420_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
