// CAVLC I slices packed as MB-row chunks on several host threads, then
// spliced into one slice.
//
// This file compiles `native/cavlc_pack.cc` into its own translation unit
// (the library keeps every symbol of that file) and adds two entries:
//
//   pack_mb_rows_bits  codes MB rows [r0, r1) of an all-Intra16x16 slice,
//                      exactly as pack_slice_rbsp's loop codes them, into a
//                      bit string of its own (no header, no trailing bits);
//   splice_bits        joins the header and the chunks' bit strings in
//                      order, then writes the RBSP trailing bits.
//
// Only three things carry from one MB to the next in pack_slice_rbsp: the
// bit position, the TotalCoeff grids the nC context reads (left and top
// neighbours) and mb_qp_delta, which is always 0. The grids follow from the
// coefficients alone, so a chunk rebuilds row r0-1's counts and codes its
// rows without the rows before it, and the spliced bits equal the single
// pass bit for bit. pack_slice_rbsp stays the oracle (tests/test_torch_host.py).

#include "cavlc_pack.cc"

namespace {

// Nonzero levels among AC scan positions 1..15 of a 4x4 block: the count
// pack_slice_rbsp stores for it. Its cbp gate needs no test here: a block
// with a nonzero AC level makes cbp_luma 15 (cbp_chroma 2) for its MB, and
// a block without one stores 0 either way.
inline int32_t AcCount(const int16_t* blk) {
  int32_t n = 0;
  for (int i = 1; i < 16; i++) n += blk[kZigzag[i]] != 0;
  return n;
}

// One Intra16x16 MB, pack_slice_rbsp's loop body. `mby` indexes the
// caller's TotalCoeff grids, whose MB-row height is `grid_mbh`.
void PackIntraMb(BitWriter& w, int mb, int mbx, int mby, int grid_mbh, int mbw,
                 const int16_t* luma_mode, const int16_t* chroma_mode,
                 const int16_t* luma_dc, const int16_t* luma_ac,
                 const int16_t* chroma_dc, const int16_t* chroma_ac,
                 int32_t* luma_tc_buf, int32_t* chroma_tc_buf) {
  const int lstride = mbw * 4, cstride = mbw * 2;
  const int16_t* ldc = luma_dc + (int64_t)mb * 16;
  const int16_t* lac = luma_ac + (int64_t)mb * 256;
  const int16_t* cdc = chroma_dc + (int64_t)mb * 8;
  const int16_t* cac = chroma_ac + (int64_t)mb * 128;
  int32_t scan[16];

  int cbp_luma = 0;
  for (int b = 0; b < 16 && !cbp_luma; b++) {
    const int16_t* blk = lac + b * 16;
    for (int i = 1; i < 16; i++) {
      if (blk[kZigzag[i]]) { cbp_luma = 15; break; }
    }
  }
  int cbp_chroma = 0;
  for (int b = 0; b < 8 && cbp_chroma < 2; b++) {
    const int16_t* blk = cac + b * 16;
    for (int i = 1; i < 16; i++) {
      if (blk[kZigzag[i]]) { cbp_chroma = 2; break; }
    }
  }
  if (cbp_chroma == 0) {
    for (int i = 0; i < 8; i++) {
      if (cdc[i]) { cbp_chroma = 1; break; }
    }
  }

  int mb_type = 1 + luma_mode[mb] + 4 * cbp_chroma + 12 * (cbp_luma ? 1 : 0);
  w.PutUe((uint32_t)mb_type);
  w.PutUe((uint32_t)chroma_mode[mb]);
  w.PutSe(0);  // mb_qp_delta

  for (int i = 0; i < 16; i++) scan[i] = ldc[kZigzag[i]];
  int nc = NcContext(luma_tc_buf, lstride, mbx * 4, mby * 4);
  ResidualBlock(w, scan, 16, nc);

  if (cbp_luma) {
    for (int blk = 0; blk < 16; blk++) {
      const int x4 = kLumaBlockOrder[blk][0], y4 = kLumaBlockOrder[blk][1];
      const int16_t* src = lac + (y4 * 4 + x4) * 16;
      for (int i = 1; i < 16; i++) scan[i - 1] = src[kZigzag[i]];
      const int bx = mbx * 4 + x4, by = mby * 4 + y4;
      nc = NcContext(luma_tc_buf, lstride, bx, by);
      luma_tc_buf[by * lstride + bx] = ResidualBlock(w, scan, 15, nc);
    }
  }

  if (cbp_chroma) {
    for (int comp = 0; comp < 2; comp++) {
      for (int i = 0; i < 4; i++) scan[i] = cdc[comp * 4 + i];
      ResidualBlock(w, scan, 4, -1);
    }
  }
  if (cbp_chroma == 2) {
    for (int comp = 0; comp < 2; comp++) {
      int32_t* ctc = chroma_tc_buf + (int64_t)comp * (grid_mbh * 2) * cstride;
      for (int blk = 0; blk < 4; blk++) {
        const int x4 = kChromaBlockOrder[blk][0], y4 = kChromaBlockOrder[blk][1];
        const int16_t* src = cac + (comp * 4 + y4 * 2 + x4) * 16;
        for (int i = 1; i < 16; i++) scan[i - 1] = src[kZigzag[i]];
        const int bx = mbx * 2 + x4, by = mby * 2 + y4;
        nc = NcContext(ctc, cstride, bx, by);
        ctc[by * cstride + bx] = ResidualBlock(w, scan, 15, nc);
      }
    }
  }
}

// Appends bit strings to a byte buffer 64 bits at a time, MSB first.
class BitSplicer {
 public:
  BitSplicer(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}

  // The first `nbits` bits of `src`.
  void Append(const uint8_t* src, int64_t nbits) {
    const int64_t words = nbits >> 6;
    for (int64_t i = 0; i < words; i++) {
      uint64_t v;
      memcpy(&v, src + 8 * i, 8);
      Put(__builtin_bswap64(v), 64);
    }
    const int rem = (int)(nbits & 63);
    if (rem) {
      const uint8_t* p = src + 8 * words;
      uint64_t v = 0;
      for (int j = 0; j < (rem + 7) >> 3; j++) v |= (uint64_t)p[j] << (56 - 8 * j);
      Put(v >> (64 - rem), rem);
    }
  }

  // rbsp_stop_one_bit, alignment zeros, and the last bytes out.
  // Returns the byte length, or -1 past the capacity.
  int64_t Finish() {
    Put(1, 1);
    if (fill_ % 8) Put(0, 8 - fill_ % 8);
    for (int shift = fill_ - 8; shift >= 0; shift -= 8) {
      if (pos_ < cap_) out_[pos_] = (uint8_t)(acc_ >> shift);
      pos_++;
    }
    return pos_ > cap_ ? -1 : pos_;
  }

 private:
  // The low `n` bits of `v` (1 <= n <= 64; v < 2^n).
  void Put(uint64_t v, int n) {
    const int space = 64 - fill_;
    if (n < space) {
      acc_ = (acc_ << n) | v;
      fill_ += n;
      return;
    }
    const int rest = n - space;  // 0..63
    const uint64_t word = (space == 64 ? 0 : acc_ << space) | (v >> rest);
    if (pos_ + 8 <= cap_) {
      const uint64_t be = __builtin_bswap64(word);
      memcpy(out_ + pos_, &be, 8);
    }
    pos_ += 8;
    acc_ = rest ? v & ((1ull << rest) - 1) : 0;
    fill_ = rest;
  }

  uint8_t* out_;
  int64_t cap_;
  int64_t pos_ = 0;
  uint64_t acc_ = 0;
  int fill_ = 0;  // bits held in acc_, 0..63
};

}  // namespace

extern "C" {

// Code MB rows [r0, r1) of the all-Intra16x16 slice whose FrameCoeffs arrays
// (pack_slice_rbsp's layout, the whole slice) are given, as pack_slice_rbsp's
// loop codes them, into `out` as a bit string: no header, no trailing bits.
// luma_tc_buf holds (rows * 4) x (mbw * 4) and chroma_tc_buf 2 x (rows * 2)
// x (mbw * 2) int32, rows = r1 - r0 + (r0 > 0): the grids start at row
// r0 - 1, whose counts are rebuilt from its coefficients, so the top
// neighbour of row r0 reads what the single pass reads there.
// Returns the bit length, -1 on overflow, -2 on a bad row range.
int64_t pack_mb_rows_bits(
    int r0, int r1,
    const int16_t* luma_mode, const int16_t* chroma_mode,
    const int16_t* luma_dc, const int16_t* luma_ac,
    const int16_t* chroma_dc, const int16_t* chroma_ac,
    int mbh, int mbw,
    uint8_t* out, int64_t out_cap, int32_t* luma_tc_buf, int32_t* chroma_tc_buf) {
  if (r0 < 0 || r1 <= r0 || r1 > mbh || mbw <= 0) return -2;
  const int top = r0 > 0 ? r0 - 1 : 0;  // the grids' first MB row
  const int rows = r1 - top;
  const int lstride = mbw * 4, cstride = mbw * 2;
  memset(luma_tc_buf, 0, sizeof(int32_t) * (size_t)(rows * 4) * (size_t)lstride);
  memset(chroma_tc_buf, 0, sizeof(int32_t) * 2 * (size_t)(rows * 2) * (size_t)cstride);

  if (r0 > 0) {  // row r0 - 1's bottom counts, the only ones row r0 reads
    for (int mbx = 0; mbx < mbw; mbx++) {
      const int64_t mb = (int64_t)top * mbw + mbx;
      for (int x4 = 0; x4 < 4; x4++) {
        luma_tc_buf[3 * lstride + mbx * 4 + x4] = AcCount(luma_ac + mb * 256 + (12 + x4) * 16);
      }
      for (int comp = 0; comp < 2; comp++) {
        int32_t* ctc = chroma_tc_buf + (int64_t)comp * (rows * 2) * cstride;
        for (int x4 = 0; x4 < 2; x4++) {
          ctc[cstride + mbx * 2 + x4] = AcCount(chroma_ac + mb * 128 + (comp * 4 + 2 + x4) * 16);
        }
      }
    }
  }

  BitWriter w(out, out_cap);
  for (int mby = r0; mby < r1; mby++) {
    for (int mbx = 0; mbx < mbw; mbx++) {
      PackIntraMb(w, mby * mbw + mbx, mbx, mby - top, rows, mbw, luma_mode, chroma_mode,
                  luma_dc, luma_ac, chroma_dc, chroma_ac, luma_tc_buf, chroma_tc_buf);
    }
  }
  // The trailing bits end in the stop bit: the bits before it are the MBs'.
  w.RbspTrailing();
  if (w.Overflowed()) return -1;
  const int64_t n = w.BytePos();
  return 8 * n - __builtin_ctz((unsigned)out[n - 1]) - 1;
}

// The slice RBSP: the header's bits, then chunk k's nbits[k] bits for
// k = 0..n_chunks-1, then the RBSP trailing bits. Returns the byte length,
// or -1 on overflow.
int64_t splice_bits(const uint8_t* header_bytes, int64_t header_nbits,
                    const uint8_t* const* chunks, const int64_t* nbits, int n_chunks,
                    uint8_t* out, int64_t out_cap) {
  BitSplicer s(out, out_cap);
  s.Append(header_bytes, header_nbits);
  for (int k = 0; k < n_chunks; k++) s.Append(chunks[k], nbits[k]);
  return s.Finish();
}

}  // extern "C"
