// The H.264 IDR step (all Intra16x16) as two launches of hand-written kernels.
//
// Replaces no Pallas kernel: it replaces the lax.scan intra loops of
// selkies_tpu/models/h264/encoder_core.py (_encode_row0, encode_frame_planes),
// which the port ran as Python loops of tensor ops. Python side, contract and
// plain version: selkies_tpu_torch/models/h264/intra.py and
// encoder_core._encode_intra_plain.
//
// What bounds it on an H100: not its bytes. A 1080p frame reads 3.1 MB of
// planes and writes ~16 MB of int32 levels and 3.1 MB of recon, ~6 us at
// 3.35 TB/s. It is bound by its serial chain: row 0 predicts each MB from the
// recon of its left neighbour (DC), every later row from the recon row above
// (vertical), so an MB of column c in row r waits on c + r earlier MB steps
// of its session, 120 + 67 = 187 at 1920x1088. The design keeps each step on
// chip and short:
//
// - One warp is one MB step: lanes 0-15 take the 16 luma 4x4 blocks, lanes
//   16-23 the 2 x 4 chroma blocks of U and V, each block's residual, core
//   transform, quantisation, dequantisation, inverse transform and clamp in
//   registers. The DC Hadamards (4x4 luma, 2x2 chroma) go across lanes by
//   shuffles, and the next step's prediction comes from this step's recon by
//   shuffles too: nothing of the chain passes through memory.
// - Launch 1 (intra_row0_kernel): one warp per session walks row 0 left to
//   right. Launch 2 (intra_rows_kernel): one warp per (session, MB column)
//   walks rows 1.. down, its first prediction read from launch 1's recon.
//   Every column of every session runs at once (960 warps at 8 x 1080p).
// - Each lane loads its next MB's pixels before it works on this one, so the
//   load's latency hides behind a step.
//
// All arithmetic is int32 and equal to the plain version element for element.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kMask = 0x00FFFFFFu;  // lanes 0-23; 24-31 leave at once
constexpr int kLanes = 24;

// one QP's constants, a half row of encoder_core._qp_table (_QP_COLS)
constexpr int kQpHalf = 44;
constexpr int kMf = 0, kVs = 16, kQbits = 32, kFi = 33, kMf00 = 35, kF2i = 36, kQb1 = 38,
              kV00 = 39, kDcA = 40, kDcR = 41, kDcB = 42, kQper = 43;

struct Args {
  const void* y;
  const void* u;
  const void* v;
  const int32_t* qp;  // (1 or nsess, 2 * kQpHalf): luma constants, then chroma
  int qp_stride;      // 0 for one row shared by every session
  int h, w;           // luma plane
  int32_t* luma_mode;
  int32_t* chroma_mode;
  int32_t* luma_dc;    // (nsess, mbh, mbw, 4, 4)
  int32_t* luma_ac;    // (nsess, mbh, mbw, 4, 4, 4, 4)
  int32_t* chroma_dc;  // (nsess, mbh, mbw, 2, 2, 2)
  int32_t* chroma_ac;  // (nsess, mbh, mbw, 2, 2, 2, 4, 4)
  uint8_t* ry;
  uint8_t* ru;
  uint8_t* rv;
};

// A lane's block: its plane, its place in the MB, its quantiser constants.
struct Lane {
  int lane;
  bool luma;
  int by, bx, k;  // k: the block's index among its MB's luma (0-15) or chroma (0-7) blocks
  int size;       // MB size in this plane: 16 or 8
  int pitch;      // plane width
  int mf[3], vs[3];  // by position class: (even, even), (odd, odd), mixed
  int qbits, f, mf00, f2, qb1, v00, dca, dcr, dcb;
};

__device__ __forceinline__ Lane make_lane(int lane, const Args& a, int s) {
  Lane l;
  l.lane = lane;
  l.luma = lane < 16;
  if (l.luma) {
    l.k = lane;
    l.by = lane >> 2;
    l.bx = lane & 3;
  } else {
    l.k = lane - 16;
    l.by = (l.k >> 1) & 1;
    l.bx = l.k & 1;
  }
  l.size = l.luma ? 16 : 8;
  l.pitch = l.luma ? a.w : a.w / 2;
  const int32_t* q = a.qp + (size_t)s * a.qp_stride + (l.luma ? 0 : kQpHalf);
  // the 4x4 tables hold one value per position class: entries 0, 5 and 1
  l.mf[0] = q[kMf];
  l.mf[1] = q[kMf + 5];
  l.mf[2] = q[kMf + 1];
  l.vs[0] = q[kVs];
  l.vs[1] = q[kVs + 5];
  l.vs[2] = q[kVs + 1];
  l.qbits = q[kQbits];
  l.f = q[kFi];
  l.mf00 = q[kMf00];
  l.f2 = q[kF2i];
  l.qb1 = q[kQb1];
  l.v00 = q[kV00];
  if (l.luma) {  // dequant_luma_dc: ((f << dc_a) + dc_r) >> dc_b
    l.dca = q[kDcA];
    l.dcr = q[kDcR];
    l.dcb = q[kDcB];
  } else {  // dequant_chroma_dc: (f << qper) >> 1
    l.dca = q[kQper];
    l.dcr = 0;
    l.dcb = 1;
  }
  return l;
}

__host__ __device__ constexpr int pos_class(int i, int j) {
  return (i % 2 == 0 && j % 2 == 0) ? 0 : (i % 2 && j % 2) ? 1 : 2;
}

// A block's 16 pixels as loaded: 4 rows of 4 bytes, or of 4 int32.
template <typename T>
struct Raw;
template <>
struct Raw<uint8_t> {
  uint32_t r[4];
  __device__ __forceinline__ void load(const uint8_t* p, int pitch) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = __ldg(reinterpret_cast<const uint32_t*>(p + i * pitch));
  }
  __device__ __forceinline__ int at(int i, int j) const { return (r[i] >> (8 * j)) & 0xFF; }
};
template <>
struct Raw<int32_t> {
  int4 r[4];
  __device__ __forceinline__ void load(const int32_t* p, int pitch) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = __ldg(reinterpret_cast<const int4*>(p + i * pitch));
  }
  __device__ __forceinline__ int at(int i, int j) const {
    return j == 0 ? r[i].x : j == 1 ? r[i].y : j == 2 ? r[i].z : r[i].w;
  }
};

// The lane's block of MB (s, r, c) in its source plane.
template <typename T>
__device__ __forceinline__ const T* block_src(const Lane& l, const Args& a, int s, int r, int c) {
  const int ph = l.luma ? a.h : a.h / 2;
  const T* base = static_cast<const T*>(l.luma ? a.y : (l.k < 4 ? a.u : a.v));
  return base + (size_t)s * ph * l.pitch + (size_t)(l.size * r + 4 * l.by) * l.pitch
         + l.size * c + 4 * l.bx;
}

__device__ __forceinline__ uint8_t* block_recon(const Lane& l, const Args& a, int s, int r,
                                                int c) {
  const int ph = l.luma ? a.h : a.h / 2;
  uint8_t* base = l.luma ? a.ry : (l.k < 4 ? a.ru : a.rv);
  return base + (size_t)s * ph * l.pitch + (size_t)(l.size * r + 4 * l.by) * l.pitch
         + l.size * c + 4 * l.bx;
}

__device__ __forceinline__ int sgn_like(int level, int like) { return like < 0 ? -level : level; }

// One stage of the DC Hadamard across the lanes of one MB: luma along one
// axis of its 4x4 DC grid (encoder_core._had1d's output order), chroma along
// one axis of each 2x2 grid. `axis` 0 runs along bx, 1 along by.
__device__ __forceinline__ int dc_stage(const Lane& l, int x, int axis) {
  int v[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int src;
    if (l.luma)
      src = axis == 0 ? ((l.lane & ~3) | m) : ((m << 2) | (l.lane & 3));
    else
      src = axis == 0 ? ((l.lane & ~1) | (m & 1)) : ((l.lane & ~2) | ((m & 1) << 1));
    v[m] = __shfl_sync(kMask, x, src);
  }
  const int idx = axis == 0 ? l.bx : l.by;
  if (!l.luma) return idx ? v[0] - v[1] : v[0] + v[1];
  const int s0 = v[0] + v[1], s1 = v[2] + v[3], d0 = v[0] - v[1], d1 = v[2] - v[3];
  return idx == 0 ? s0 + s1 : idx == 1 ? s0 - s1 : idx == 2 ? d0 - d1 : d0 + d1;
}

__device__ __forceinline__ int dc_hadamard(const Lane& l, int x) {
  return dc_stage(l, dc_stage(l, x, 0), 1);
}

// One MB step of the lane's block: pred[j] is the prediction of column j (the
// same down every row, for DC and vertical alike). Writes the block's levels
// and recon; leaves the recon in rec.
template <typename T>
__device__ __forceinline__ void mb_step(const Lane& l, const Args& a, const Raw<T>& raw,
                                        const int pred[4], size_t mb, int row,
                                        uint8_t* recon, int rec[4][4]) {
  int x[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = raw.at(i, j) - pred[j];

  // forward core transform: along each row, then along each column
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s0 = x[i][0] + x[i][3], s1 = x[i][1] + x[i][2];
    const int d0 = x[i][0] - x[i][3], d1 = x[i][1] - x[i][2];
    x[i][0] = s0 + s1;
    x[i][1] = 2 * d0 + d1;
    x[i][2] = s0 - s1;
    x[i][3] = d0 - 2 * d1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s0 = x[0][j] + x[3][j], s1 = x[1][j] + x[2][j];
    const int d0 = x[0][j] - x[3][j], d1 = x[1][j] - x[2][j];
    x[0][j] = s0 + s1;
    x[1][j] = 2 * d0 + d1;
    x[2][j] = s0 - s1;
    x[3][j] = d0 - 2 * d1;
  }

  // DC: Hadamard across the MB's blocks (luma halved), quantised
  int t = dc_hadamard(l, x[0][0]);
  if (l.luma) t >>= 1;
  const int dc_level = sgn_like((abs(t) * l.mf00 + l.f2) >> l.qb1, t);

  // every coefficient, [0][0] included, quantised as AC (quant4, intra)
  int lev[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      lev[i][j] = sgn_like((abs(x[i][j]) * l.mf[pos_class(i, j)] + l.f) >> l.qbits, x[i][j]);

  // DC dequantised: the Hadamard again, then ((g * v00) << dca + dcr) >> dcb
  const int g = dc_hadamard(l, dc_level) * l.v00;
  const int dc_deq = (g * (1 << l.dca) + l.dcr) >> l.dcb;

  // the levels out: 16 int32 a block, then the DC level
  int32_t* ac = (l.luma ? a.luma_ac + (mb * 16 + l.k) * 16 : a.chroma_ac + (mb * 8 + l.k) * 16);
  int4* ac4 = reinterpret_cast<int4*>(ac);
#pragma unroll
  for (int i = 0; i < 4; ++i) ac4[i] = make_int4(lev[i][0], lev[i][1], lev[i][2], lev[i][3]);
  if (l.luma)
    a.luma_dc[mb * 16 + l.k] = dc_level;
  else
    a.chroma_dc[mb * 8 + l.k] = dc_level;
  if (l.lane == 0) a.luma_mode[mb] = row == 0 ? 2 : 0;     // DC / vertical
  if (l.lane == 16) a.chroma_mode[mb] = row == 0 ? 0 : 2;  // DC / vertical

  // dequantise; inverse transform along each row, then along each column
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = lev[i][j] * l.vs[pos_class(i, j)];
  x[0][0] = dc_deq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e0 = x[i][0] + x[i][2], e1 = x[i][0] - x[i][2];
    const int e2 = (x[i][1] >> 1) - x[i][3], e3 = x[i][1] + (x[i][3] >> 1);
    x[i][0] = e0 + e3;
    x[i][1] = e1 + e2;
    x[i][2] = e1 - e2;
    x[i][3] = e0 - e3;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e0 = x[0][j] + x[2][j], e1 = x[0][j] - x[2][j];
    const int e2 = (x[1][j] >> 1) - x[3][j], e3 = x[1][j] + (x[3][j] >> 1);
    x[0][j] = e0 + e3;
    x[1][j] = e1 + e2;
    x[2][j] = e1 - e2;
    x[3][j] = e0 - e3;
  }

  // recon = clamp(idct + pred), out as 4 rows of 4 bytes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rec[i][j] = min(max(((x[i][j] + 32) >> 6) + pred[j], 0), 255);
      word |= (uint32_t)rec[i][j] << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(recon + i * l.pitch) = word;
  }
}

// Row 0: one warp per session (blockIdx.x) walks the MB columns left to
// right; each MB's DC prediction is its left neighbour's recon right column.
template <typename T>
__global__ void __launch_bounds__(32) intra_row0_kernel(Args a) {
  const int lane = threadIdx.x;
  if (lane >= kLanes) return;
  const int s = blockIdx.x, mbw = a.w / 16, mbh = a.h / 16;
  const Lane l = make_lane(lane, a, s);
  Raw<T> raw, next;
  raw.load(block_src<T>(l, a, s, 0, 0), l.pitch);
  int dc = 128;  // no left neighbour
  for (int c = 0; c < mbw; ++c) {
    if (c + 1 < mbw) next.load(block_src<T>(l, a, s, 0, c + 1), l.pitch);
    const int pred[4] = {dc, dc, dc, dc};
    int rec[4][4];
    mb_step<T>(l, a, raw, pred, (size_t)s * mbh * mbw + c, 0, block_recon(l, a, s, 0, c), rec);
    // the next MB's DC from this one's right column: luma the sum of blocks
    // (0..3, 3); chroma block (by, 1) of its plane
    const int col = rec[0][3] + rec[1][3] + rec[2][3] + rec[3][3];
    int sum[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) sum[m] = __shfl_sync(kMask, col, l.luma ? (m << 2) | 3 : lane | 1);
    dc = l.luma ? (sum[0] + sum[1] + sum[2] + sum[3] + 8) >> 4 : (sum[0] + 2) >> 2;
    raw = next;
  }
}

// Rows 1..mbh-1: one warp per (session, MB column) walks down its column;
// each MB's vertical prediction is the recon row above it.
template <typename T>
__global__ void __launch_bounds__(32) intra_rows_kernel(Args a) {
  const int lane = threadIdx.x;
  if (lane >= kLanes) return;
  const int mbw = a.w / 16, mbh = a.h / 16;
  const int s = blockIdx.x / mbw, c = blockIdx.x - s * mbw;
  const Lane l = make_lane(lane, a, s);
  Raw<T> raw, next;
  raw.load(block_src<T>(l, a, s, 1, c), l.pitch);
  // row 0's bottom recon row over this lane's columns (launch 1 wrote it)
  const uint8_t* above = block_recon(l, a, s, 0, c) + (l.size - 1 - 4 * l.by) * l.pitch;
  const uint32_t word = *reinterpret_cast<const uint32_t*>(above);
  int pred[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) pred[j] = (word >> (8 * j)) & 0xFF;
  // the block of this lane's column in the MB's bottom block row
  const int src = l.luma ? 12 | (lane & 3) : lane | 2;
  for (int r = 1; r < mbh; ++r) {
    if (r + 1 < mbh) next.load(block_src<T>(l, a, s, r + 1, c), l.pitch);
    int rec[4][4];
    mb_step<T>(l, a, raw, pred, ((size_t)s * mbh + r) * mbw + c, r, block_recon(l, a, s, r, c),
               rec);
#pragma unroll
    for (int j = 0; j < 4; ++j) pred[j] = __shfl_sync(kMask, rec[3][j], src);
    raw = next;
  }
}

template <typename T>
int launch(const Args& a, int nsess, cudaStream_t stream) {
  intra_row0_kernel<T><<<nsess, 32, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.h == 16) return (int)err;
  intra_rows_kernel<T><<<nsess * (a.w / 16), 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` of `device` for `nsess` sessions (nsess * w / 16 below
// 2^31), each array holding one slab per session back to back. Pointers are
// device memory: y (nsess, h, w) and u, v (nsess, h/2, w/2), uint8 when u8
// (4-byte aligned) else int32 (16-byte aligned), h and w multiples of 16;
// qp_rows int32, qp_stride 0 (one row for every session) or 88 (a row each);
// outputs as Args lists them, 16-byte aligned. Returns cudaGetLastError().
extern "C" int selkies_intra(int device, void* stream, int nsess, int h, int w, int u8,
                             const void* y, const void* u, const void* v, const void* qp_rows,
                             int qp_stride, void* luma_mode, void* chroma_mode, void* luma_dc,
                             void* luma_ac, void* chroma_dc, void* chroma_ac, void* recon_y,
                             void* recon_u, void* recon_v) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{y, u, v, (const int32_t*)qp_rows, qp_stride, h, w,
               (int32_t*)luma_mode, (int32_t*)chroma_mode, (int32_t*)luma_dc,
               (int32_t*)luma_ac, (int32_t*)chroma_dc, (int32_t*)chroma_ac,
               (uint8_t*)recon_y, (uint8_t*)recon_u, (uint8_t*)recon_v};
  return u8 ? launch<uint8_t>(a, nsess, (cudaStream_t)stream)
            : launch<int32_t>(a, nsess, (cudaStream_t)stream);
}

extern "C" const char* selkies_intra_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
