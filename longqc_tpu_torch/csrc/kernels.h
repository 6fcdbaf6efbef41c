// Plain C launch interface of the hand-written kernels (sketch.cu,
// chain.cu, ringprop.cu, extend.cu, adapter.cu, pack.cu), bound to
// PyTorch by bind.cpp. Every pointer is a contiguous int32 device buffer
// of the layout its .cu file documents (lq_sketch_rows with wide != 0:
// `plan` and `hash` are int64 buffers; lq_adapter_align's `moves` and
// lq_pack_tile's `raw` hold bytes); each function launches on `stream`
// and returns the cudaError_t of its launch (0 on success).
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

int lq_sketch_rows(const void* codes2, const void* nmask, const void* smask,
                   const void* emask, const void* starts, const void* gids,
                   const void* plan, void* emit, void* hash, void* rid,
                   void* pos, void* strand, int R, int W, int k, int w,
                   int CH, int NC, int wide, void* stream);

// P pieces a row, a multiple of 4; cnt: three int32 counters, zeroed
int lq_chain_fill(const void* axh, const void* axl, const void* aq,
                  const void* asp, const void* nb, const void* pen,
                  void* tmark, void* of, void* op, void* ov, void* cnt,
                  int Q, int A, int P, int bw, int pen_stride, int max_dist,
                  int max_skip, void* stream);

int lq_peak_pass(const void* f, const void* v, const void* p, void* peak,
                 int Q, int A, int J, void* stream);

// mark: null (the pending mask in shared memory, A <= 2^20) or Q x
// ceil(A / 32) words of device memory
int lq_minrank_pass(const void* p, const void* own, void* r, void* mark,
                    int Q, int A, int J, void* stream);

int lq_extend_fill(const void* q, const void* ql, const void* t,
                   const void* tl, void* out, int B, int Lq, int Lt, int W,
                   int match, int mismatch, int gapo, int gape, int gapo2,
                   int gape2, int zdrop, int dual, void* stream);

// the wide body (any W): Wa bounds every pair's clamped half band; G
// warps a pair (1, 2, 4 or 8), the pairs in `order`, walked by nslot pair
// slots whose boundary columns of (2 + dual) x (2 Wa + 1) ints each
// `scratch` holds
int lq_extend_wide_fill(const void* q, const void* ql, const void* t,
                        const void* tl, const void* order, void* out, int B,
                        int Lq, int Lt, int W, int Wa, int match,
                        int mismatch, int gapo, int gape, int gapo2,
                        int gape2, int zdrop, int dual, void* scratch,
                        int nslot, int G, void* stream);

// C windows (C, Lw) of wlen[c] codes each against the adapter's m codes
// -> out (8, C); nslot warp slots, each with ceil(m / 32) x (Lw + 32) x
// 32 bytes of `moves` and 2 x 5 x (Lw + 1) ints of `edges`
int lq_adapter_align(const void* adp, const void* win, const void* wlen,
                     void* out, void* moves, void* edges, int C, int m,
                     int Lw, int nslot, void* stream);

// one tile's words (R x W / 16 codes2, R x W / 32 of each mask) from its
// reads' bytes `raw` (uint8) and its layout: row_off (R + 1) and segs
// (4 ints a read)
int lq_pack_tile(const void* raw, const void* row_off, const void* segs,
                 void* codes2, void* nmask, void* smask, void* emask, int R,
                 int W, void* stream);

#ifdef __cplusplus
}
#endif
