// Fused motion estimation + motion compensation for the H.264 P-frame step.
//
// Replaces the TPU kernel selkies_tpu/models/h264/pallas_me.py
// (_me_mc_kernel, launched by pl.pallas_call in _me_mc_call). Python side,
// plain version and wrapper: selkies_tpu_torch/models/h264/me_mc.py.
//
// What bounds it on an H100: per MB and candidate, 256 absolute differences
// of bytes. With 4-way byte SIMD that is 64 instructions (the SASS shows one
// VABSDIFF4.U8.ACC per 4 pixels on sm_90a, see me_mc.py), and at 1920x1088
// with 76 candidates the operations take less time than the 24.6 MB of
// input and output, so the bytes set the bound. The design keeps the rest of
// the work within a few times the SAD instructions and pays no barrier per
// candidate:
//
// - A block holds a strip of kStrip MBs of one MB row, one warp per MB. It
//   loads the reference window every candidate within +-MV_PAD can reach
//   (96 rows x 208 bytes, as the TPU kernel's 96-row VMEM window) with
//   16-byte cp.async, and the strip's current pixels packed to bytes, into
//   shared memory once. The candidate list is staged there in chunks.
// - Each lane takes whole candidates (lane, lane + 32, ...) and sums the SAD
//   of its candidate over the 16x16 block itself: per row one broadcast
//   16-byte read of the current row, five reference words, four funnel
//   shifts for the byte offset and four accumulating 4-way byte SADs.
// - The winner is the minimum of key = SAD << 16 | rank (SAD <= 65280,
//   rank < 2^15), so one warp min-reduction per MB gives the first minimum
//   in candidate order, the winner of the JAX version's SAD*scale + rank,
//   in any order of evaluation.
// - One barrier, then the block writes the strip's luma prediction from the
//   window with coalesced 16-byte stores, and its half-pel bilinear chroma
//   predictions (8.4.2.2.2) in exact integer arithmetic from ru/rv.
// - 32 registers and 24 KB of shared memory let 8 blocks share an SM, so a
//   1080p frame's 1020 strips run in one wave.
// - Sessions (the multi-session tick): blockIdx.z is the session, and every
//   pointer moves by that session's slab. Each session has its own candidate
//   list (its own coarse votes). A solo frame is the launch with one session.
//
// A candidate beyond MV_PAD traps (see the wrapper's error contract).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMvPad = 40;                            // numpy_ref.MV_PAD
constexpr int kStrip = 8;                             // MBs per block, one warp each
constexpr int kThreads = 32 * kStrip;
constexpr int kWinRows = 16 + 2 * kMvPad;             // 96
constexpr int kWinBytes = 16 * kStrip + 2 * kMvPad;   // 208
constexpr int kWinWords = kWinBytes / 4;              // 52
constexpr int kChunk = 256;                           // candidates staged at a time

// floor(x / 2) for negative x too (the chroma offset of a luma MV, 8.4.1.4)
__device__ __forceinline__ int floor_half(int x) { return (x - (x & 1)) / 2; }

// sum of the four byte |a - b|, plus c: __vsadu4 with its accumulate
__device__ __forceinline__ uint32_t sad4_add(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// kVec: cur and ry are 16-byte aligned (padded rows are w + 80 bytes, a
// multiple of 16), so the window and the current pixels are read 16 bytes at
// a time; otherwise by plain byte and int loads. A session's slabs (h*w int32
// and (h+80)*(w+80) bytes, w a multiple of 16) are multiples of 16 bytes, so
// every session is aligned when the first is.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 8)
me_mc_kernel(const int32_t* __restrict__ cands, int ncand,
             const int32_t* __restrict__ cur, int w,
             const uint8_t* __restrict__ ry, const uint8_t* __restrict__ ru,
             const uint8_t* __restrict__ rv,
             int32_t* __restrict__ mvs, int32_t* __restrict__ pred_y,
             int32_t* __restrict__ pred_u, int32_t* __restrict__ pred_v) {
  // +4 words: a lane reads 5 words per row, the 5th past the row end only at
  // a zero byte offset, where the funnel shift ignores it
  __shared__ __align__(16) uint32_t win[kWinRows * kWinWords + 4];
  __shared__ __align__(16) uint32_t cur_s[kStrip][16][4];
  __shared__ int2 cand_s[kChunk];
  __shared__ int2 mv_s[kStrip];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int mbw = w / 16, mby = blockIdx.y, mbx0 = blockIdx.x * kStrip;
  const int nmb = min(kStrip, mbw - mbx0);  // ragged last strip
  const int wp = w + 2 * kMvPad;

  // this block's session: every input and output moves by its slab
  const size_t z = blockIdx.z, h = 16 * (size_t)gridDim.y;
  const size_t cslab = (h / 2 + 2 * kMvPad) * (size_t)(w / 2 + 2 * kMvPad);
  cands += z * 2 * ncand;
  cur += z * h * w;
  ry += z * (h + 2 * kMvPad) * wp;
  ru += z * cslab;
  rv += z * cslab;
  mvs += z * (h / 16) * mbw * 2;
  pred_y += z * h * w;
  pred_u += z * (h / 2) * (w / 2);
  pred_v += z * (h / 2) * (w / 2);

  // reference window: padded rows [16*mby, +96), columns [16*mbx0, +16*nmb+80)
  const uint8_t* src = ry + (size_t)(16 * mby) * wp + 16 * mbx0;
  if (kVec) {
    const int vecs = nmb + 5;
    for (int i = t; i < kWinRows * vecs; i += kThreads) {
      const int r = i / vecs, c = i - r * vecs;
      cp_async16(win + r * kWinWords + 4 * c, src + (size_t)r * wp + 16 * c);
    }
    asm volatile("cp.async.commit_group;\n");
  } else {
    uint8_t* wb = reinterpret_cast<uint8_t*>(win);
    const int cols = 16 * nmb + 2 * kMvPad;
    for (int i = t; i < kWinRows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      wb[r * kWinBytes + c] = src[(size_t)r * wp + c];
    }
  }
  // current pixels (0..255 in int32) packed 4 to a word, little-endian
  for (int i = t; i < kStrip * 16 * 4; i += kThreads) {
    const int j = i >> 6, r = (i >> 2) & 15, q = i & 3;
    if (j >= nmb) continue;
    const int32_t* p = cur + (size_t)(16 * mby + r) * w + 16 * (mbx0 + j) + 4 * q;
    const int4 v = kVec ? __ldg(reinterpret_cast<const int4*>(p))
                        : make_int4(p[0], p[1], p[2], p[3]);
    cur_s[j][r][q] = (uint32_t)v.x | (uint32_t)v.y << 8 | (uint32_t)v.z << 16
                     | (uint32_t)v.w << 24;
  }

  uint32_t best = 0xFFFFFFFFu;
  for (int c0 = 0; c0 < ncand; c0 += kChunk) {
    const int cnt = min(kChunk, ncand - c0);
    if (c0) __syncthreads();  // every warp is done with the previous chunk
    for (int i = t; i < cnt; i += kThreads) {
      const int dx = cands[2 * (c0 + i)], dy = cands[2 * (c0 + i) + 1];
      if (dx < -kMvPad || dx > kMvPad || dy < -kMvPad || dy > kMvPad) __trap();
      cand_s[i] = make_int2(dx, dy);
    }
    if (kVec && !c0) asm volatile("cp.async.wait_all;\n");
    __syncthreads();
    if (warp >= nmb) continue;
    for (int i = lane; i < cnt; i += 32) {
      const int2 d = cand_s[i];
      const int b0 = 16 * warp + kMvPad + d.x;  // window column of the MB's pixel 0
      const uint32_t* p = win + (kMvPad + d.y) * kWinWords + (b0 >> 2);
      const unsigned sh = 8 * (b0 & 3);
      uint32_t sad = 0;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const uint4 a = *reinterpret_cast<const uint4*>(cur_s[warp][r]);
        const uint32_t* q = p + r * kWinWords;
        const uint32_t w0 = q[0], w1 = q[1], w2 = q[2], w3 = q[3], w4 = q[4];
        sad = sad4_add(a.x, __funnelshift_r(w0, w1, sh), sad);
        sad = sad4_add(a.y, __funnelshift_r(w1, w2, sh), sad);
        sad = sad4_add(a.z, __funnelshift_r(w2, w3, sh), sad);
        sad = sad4_add(a.w, __funnelshift_r(w3, w4, sh), sad);
      }
      best = min(best, sad << 16 | (uint32_t)(c0 + i));
    }
  }
  if (warp < nmb) {
    best = __reduce_min_sync(0xFFFFFFFFu, best);
    if (lane == 0) {
      const int k = best & 0xFFFF;
      const int2 d = ncand <= kChunk ? cand_s[k] : make_int2(cands[2 * k], cands[2 * k + 1]);
      mv_s[warp] = d;
      *reinterpret_cast<int2*>(mvs + 2 * (mby * mbw + mbx0 + warp)) = d;
    }
  }
  __syncthreads();

  // luma: the strip's 16 rows, 4 pixels per 16-byte store
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(win);
  const int row4 = 4 * nmb;
  for (int i = t; i < 16 * row4; i += kThreads) {
    const int r = i / row4, c4 = i - r * row4, j = c4 >> 2;
    const int2 d = mv_s[j];
    const uint8_t* b = wb + (r + kMvPad + d.y) * kWinBytes + 16 * j + 4 * (c4 & 3) + kMvPad + d.x;
    *reinterpret_cast<int4*>(pred_y + (size_t)(16 * mby + r) * w + 16 * mbx0 + 4 * c4) =
        make_int4(b[0], b[1], b[2], b[3]);
  }

  // chroma (8.4.2.2.2): the strip's 8 rows of U then V, 4 pixels a thread
  // (one pass for a full strip), all 10 source bytes loaded before the blend
  const int cw = w / 2, cwp = cw + 2 * kMvPad, quads = 2 * nmb, nq = 8 * quads;
  for (int i = t; i < 2 * nq; i += kThreads) {
    const bool is_v = i >= nq;
    const int k = i - (is_v ? nq : 0);
    const int r = k / quads, g = k - r * quads;
    const int2 d = mv_s[g >> 1];
    const int cy = 8 * mby + r, cx = 8 * mbx0 + 4 * g;
    const int xf = 4 * (d.x & 1), yf = 4 * (d.y & 1);
    const int w00 = (8 - xf) * (8 - yf), w01 = xf * (8 - yf), w10 = (8 - xf) * yf, w11 = xf * yf;
    const uint8_t* p = (is_v ? rv : ru) + (size_t)(cy + kMvPad + floor_half(d.y)) * cwp
                       + (cx + kMvPad + floor_half(d.x));
    int a[5], c[5];
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      a[u] = __ldg(p + u);
      c[u] = __ldg(p + cwp + u);
    }
    int o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      o[u] = (w00 * a[u] + w01 * a[u + 1] + w10 * c[u] + w11 * c[u + 1] + 32) >> 6;
    *reinterpret_cast<int4*>((is_v ? pred_v : pred_u) + (size_t)cy * cw + cx) =
        make_int4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// Launch on `stream` of `device` for `nsess` sessions (1 <= nsess <= 65535),
// each array holding one slab per session back to back. Pointers are device
// memory: cands (nsess, ncand, 2) int32 (dx, dy) in rank order,
// 1 <= ncand <= 32768; cur (nsess, h, w) int32 luma in 0..255; ry
// (nsess, h+80, w+80) and ru/rv (nsess, h/2+80, w/2+80) uint8 edge-padded
// references; outputs mvs (nsess, h/16, w/16, 2), pred_y (nsess, h, w),
// pred_u/pred_v (nsess, h/2, w/2) int32, 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int selkies_me_mc(int device, void* stream, int nsess, const void* cands,
                             int ncand, const void* cur, int h, int w, const void* ry,
                             const void* ru, const void* rv, void* mvs, void* pred_y,
                             void* pred_u, void* pred_v) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w / 16 + kStrip - 1) / kStrip, h / 16, nsess);
  const bool vec = (((uintptr_t)cur | (uintptr_t)ry) & 15) == 0;
  auto kernel = vec ? me_mc_kernel<true> : me_mc_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cands, ncand, (const int32_t*)cur, w, (const uint8_t*)ry,
      (const uint8_t*)ru, (const uint8_t*)rv, (int32_t*)mvs, (int32_t*)pred_y,
      (int32_t*)pred_u, (int32_t*)pred_v);
  return (int)cudaGetLastError();
}

extern "C" const char* selkies_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
