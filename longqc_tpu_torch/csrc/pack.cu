// Part tile packing (engine/device_index): the four word arrays that B1
// (csrc/sketch.cu) reads -- 2-bit codes, ambiguity, segment starts and
// read ends -- made on the card from the tile's reads' ASCII bytes and
// its layout.
//
// Replaces no TPU kernel: the JAX package packs its tiles on the host
// (longqc_tpu/engine/device_index.py, _TileBuilder._pack, numpy); the
// port's plain twin (ops/pack_cuda.pack_words_plain) is that numpy body,
// run from the same layout record. The words equal the twin's bit for
// bit: codes2 holds 16 columns a word, 2 bits each, column c at bits
// 2 (c % 16); nmask, startmask and endmask 32 columns a word, column c
// at bit c % 32. A base maps through SEQ_NT4_SKETCH (io/pack.py): A / a
// 0, C / c 1, G / g 2, T / t / U / u 3, any other byte ambiguous with
// code 0. Separators and the padding past a row's last read are
// ambiguous with code 0; a segment's first column (the first separator
// before a read, which belongs to that read's segment, or the read's
// first base) carries the start bit; a read's last base the end bit; a
// read of no bases ends at the column before its first, which for the
// first read of a row is the last column of the row before (of the
// tile's last row, for row 0: the twin's numpy index -1). Rows past the
// tile's last are ambiguous throughout.
//
// Layout (ops/pack_cuda.py): raw, the reads' bytes; row_off (R + 1):
// row r's reads are segs[row_off[r] .. row_off[r + 1]); segs (n, 4), a
// read each: its segment's first column, its first base's column, its
// length and the offset of its first byte in raw. Columns are a row's
// own.
//
// One thread a column, one warp a 32-column word of one row, a block 256
// columns of one row (grid ceil(W / 256) x R). The block stages its
// row's segment table (at most READS_PER_ROW = 64 reads) in shared
// memory; each lane finds its segment, the last one whose first column
// is at or before its own, by a binary search there, then loads its byte
// (coalesced along a read) and maps it. nmask, startmask and endmask are
// one __ballot_sync each, codes2's two words an OR over each half warp.
//
// Bound on this card: bytes. A column reads at most one byte and writes
// 5 / 8 of a byte of words; a 2M-column tile bounds at about 1 us at
// 3.35 TB/s, so launch and tail latency set its time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

#define LQ_FULL 0xffffffffu

namespace {

constexpr int THREADS = 256;   // columns a block
constexpr int MAX_SEGS = 64;   // READS_PER_ROW (ops/sketch_cuda)

// SEQ_NT4_SKETCH: setting bit 5 folds each upper-case letter onto its
// lower case, and no other byte onto a lower-case letter
__device__ __forceinline__ int nt4(unsigned b) {
  const unsigned x = b | 0x20u;
  return x == 'a' ? 0 : x == 'c' ? 1 : x == 'g' ? 2
         : (x == 't' || x == 'u') ? 3 : 4;
}

__global__ void __launch_bounds__(THREADS)
lq_pack_tile_kernel(const uint8_t* __restrict__ raw,
                    const int* __restrict__ row_off,
                    const int* __restrict__ segs, uint32_t* codes2,
                    uint32_t* nmask, uint32_t* smask, uint32_t* emask,
                    int R, int W) {
  __shared__ int4 s_seg[MAX_SEGS];
  const int r = blockIdx.y;
  const int a = row_off[r];
  const int n = min(row_off[r + 1] - a, MAX_SEGS);
  if ((int)threadIdx.x < n) {
    const int* s = segs + 4 * (int64_t)(a + threadIdx.x);
    s_seg[threadIdx.x] = make_int4(s[0], s[1], s[2], s[3]);
  }
  __syncthreads();
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= W) return;           // W % 32 == 0: whole warps leave
  int code = 0, amb = 1, st = 0, en = 0;
  if (n > 0) {
    int j = 0;                  // s_seg[0].x == 0 <= c
    for (int step = MAX_SEGS / 2; step; step >>= 1)
      if (j + step < n && s_seg[j + step].x <= c) j += step;
    const int4 s = s_seg[j];
    const int off = c - s.y;
    st = c == s.x;
    en = off == s.z - 1;
    if (off >= 0 && off < s.z) {
      const int v = nt4(raw[(int64_t)s.w + off]);
      amb = v >= 4;
      code = v < 4 ? v : 0;
    }
  }
  if (c == W - 1) {
    // the next row's first read, if it has no bases, ends here
    const int rn = r + 1 == R ? 0 : r + 1;
    const int b = row_off[rn];
    if (row_off[rn + 1] > b && segs[4 * (int64_t)b + 2] == 0) en = 1;
  }
  const unsigned lane = threadIdx.x & 31;
  const unsigned nm = __ballot_sync(LQ_FULL, amb);
  const unsigned sm = __ballot_sync(LQ_FULL, st);
  const unsigned em = __ballot_sync(LQ_FULL, en);
  const unsigned half = lane < 16 ? 0x0000ffffu : 0xffff0000u;
  const unsigned cw =
      __reduce_or_sync(half, (unsigned)code << (2 * (lane & 15)));
  const int64_t q = (int64_t)r * (W / 32) + (c >> 5);
  if (lane == 0) {
    nmask[q] = nm;
    smask[q] = sm;
    emask[q] = em;
  }
  if ((lane & 15) == 0) codes2[2 * q + (lane >> 4)] = cw;
}

}  // namespace

extern "C" int lq_pack_tile(const void* raw, const void* row_off,
                            const void* segs, void* codes2, void* nmask,
                            void* smask, void* emask, int R, int W,
                            void* stream) {
  if (R <= 0 || W <= 0) return 0;
  const dim3 grid((W + THREADS - 1) / THREADS, R);
  lq_pack_tile_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)raw, (const int*)row_off, (const int*)segs,
      (uint32_t*)codes2, (uint32_t*)nmask, (uint32_t*)smask,
      (uint32_t*)emask, R, W);
  return (int)cudaGetLastError();
}
