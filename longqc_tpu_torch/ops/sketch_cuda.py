"""B1: the fused minimizer sketch over packed 2-bit rows.

`sketch_tiles` launches the hand-written kernel csrc/sketch.cu on CUDA
tensors (the port of longqc_tpu/ops/sketch_pallas.sketch_tiles_pallas)
and runs `sketch_tiles_plain` on CPU tensors. Both return per-column
(R, W) int32 arrays: emit (emission count), hash (bare minimizer hash;
int64 when 2k > 30), rid (global read id), pos (read-local position),
strand, plus an all-zero (R,) flags tensor (the kernel attributes every
emission exactly, so no row needs the exact fallback the TPU kernel's
flag requested). hash/rid/pos/strand are only meaningful where emit >
0; every caller masks the rest.

Any k <= 28 and w <= 255 runs on both devices. The kernel has four
variants, counted apart in ops/_ext.LAUNCHES (`kernel_name`): u32 or
u64 hash words (2k <= 30 or wider), and the ring in registers (w <= 32)
or as a run-time circular buffer in local memory (wider w, with wider
chunks: `chunk_width`).

The plain version is the seg-mode `_sketch_core` (ops/sketch) plus the
read-id / local-position mapping of the JAX tile_flat XLA branch,
scattered back from buffer-entry order to columns.

The kernel runs column chunks of each row in parallel; `chunk_plan`
(plain tensor ops, on the tiles' device) gives each chunk the column
its warm-up starts at and the sequential state there that the warm-up
cannot rebuild: the segment and the k-mer registers.
"""

import torch

from longqc_tpu_torch.ops import _ext
from longqc_tpu_torch.ops.sketch import _sketch_core

READS_PER_ROW = 64
MAX_K = 28          # 2k <= 56 bits: hashes and keys stay below int64 max
MAX_W = 255         # the reference's widest window
REG_RING_W = 32     # widest w whose ring the kernel holds in registers
CHUNK = 128         # columns per kernel thread while w <= REG_RING_W


def is_wide(k):
    """Whether k-mers of length k need 64-bit hash words (2k > 30)."""
    return 2 * k > 30


def hash_dtype(k):
    """Dtype of the hash lanes: int32 while 2k <= 30, else int64."""
    return torch.int64 if is_wide(k) else torch.int32


def chunk_width(w):
    """Columns per kernel thread. A chunk replays up to w + k pushes of
    warm-up before its own columns: CHUNK keeps that under about a third
    of the work while w <= REG_RING_W. Past it the width is the smallest
    power-of-two multiple of CHUNK that is at least 2 (w + MAX_K), so
    the warm-up stays under about half of it (256 columns at w = 40,
    1,024 at w = 255)."""
    if w <= REG_RING_W:
        return CHUNK
    ch = CHUNK
    while ch < 2 * (w + MAX_K):
        ch *= 2
    return ch


def kernel_name(k, w):
    """The kernel variant's name in ops/_ext.LAUNCHES."""
    return ("sketch" + ("_ring" if w > REG_RING_W else "")
            + ("_u64" if is_wide(k) else ""))


def _check_shapes(codes2, nmask, startmask, endmask, starts, gids, W, k, w):
    R = codes2.shape[0]
    if not (0 < k <= MAX_K and 0 < w <= MAX_W and W % 32 == 0 and W >= 32):
        raise ValueError("sketch needs k <= %d, w <= %d and W %% 32 == 0 "
                         "(k=%d w=%d W=%d)" % (MAX_K, MAX_W, k, w, W))
    want = {"codes2": (R, W // 16), "nmask": (R, W // 32),
            "startmask": (R, W // 32), "endmask": (R, W // 32),
            "starts": (R, READS_PER_ROW), "gids": (R, READS_PER_ROW)}
    got = {"codes2": codes2, "nmask": nmask, "startmask": startmask,
           "endmask": endmask, "starts": starts, "gids": gids}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError("%s has shape %s, want %s"
                             % (name, tuple(got[name].shape), shape))


def sketch_tiles(codes2, nmask, startmask, endmask, starts, gids, *, W, k,
                 w):
    """Sketch packed rows (the device_index.Tile layout, words as int32
    tensors holding the uint32 bits; endmask marks each read's last
    column). Returns dict(emit, hash, rid, pos, strand, flags)."""
    _check_shapes(codes2, nmask, startmask, endmask, starts, gids, W, k, w)
    if codes2.device.type == "cpu":
        return sketch_tiles_plain(codes2, nmask, startmask, endmask, starts,
                                  gids, W=W, k=k, w=w)
    ins = [t.contiguous() for t in (codes2, nmask, startmask, endmask,
                                    starts, gids)]
    _ext.require_cuda(*ins)
    R = codes2.shape[0]
    chunk = chunk_width(w)
    plan = chunk_plan(*ins[:3], W=W, k=k, w=w, chunk=chunk)
    dev = codes2.device
    emit = torch.zeros((R, W), dtype=torch.int32, device=dev)
    hsh = torch.empty((R, W), dtype=plan.dtype, device=dev)
    rid, pos, strand = (torch.empty((R, W), dtype=torch.int32, device=dev)
                        for _ in range(3))
    lib = _ext.lib()
    _ext.LAUNCHES[kernel_name(k, w)] += 1
    lib.sketch_rows(*ins, plan, emit, hsh, rid, pos, strand, W, k, w, chunk)
    return {"emit": emit, "hash": hsh, "rid": rid, "pos": pos,
            "strand": strand,
            "flags": torch.zeros(R, dtype=torch.int32, device=dev)}


def chunk_plan(codes2, nmask, startmask, *, W, k, w, chunk):
    """Warm-up plan of the chunked kernel: (R, ceil(W / chunk), 5) rows
    [s0, seg, segst, k0, k1], one per chunk of `chunk` columns starting
    at column c0 = chunk index * chunk; int32, or int64 in all five
    fields when 2k > 30 (k0 / k1 then hold up to 56 bits, and the
    kernel's u64 variant reads an int64 plan).

    s0 is the column of the (w+k)-th push before c0, or 0 when there
    are no more than w+k (a push is every column but a valid one whose
    k-mer is its own reverse complement). Replaying the recurrence from
    s0 with a clean ring, a clean tracked minimum and l = 0 reproduces
    the state at c0 for every rule the chunk's columns apply: the ring
    then holds the same last w pushes; the tracked minimum is always the
    ring's minimum, newest column on ties; and l either restarts at an
    N inside the warm-up or has counted w+k valid pushes, past every
    threshold compared with it. What the warm-up cannot rebuild is taken
    here: seg (the read index, startmask bits before s0, minus one) and
    segst (the column of that read's start bit, 0 when none), and the
    k-mer registers k0 / k1 after the valid bases before s0 (the last k
    of them, zero-filled as the recurrence starts)."""
    R = codes2.shape[0]
    dev = codes2.device
    i64 = torch.int64
    NC = -(-W // chunk)
    kdt = hash_dtype(k)
    codes = unpack2(codes2, W).to(kdt)
    valid = ~unpack1(nmask, W)
    vcum = torch.cumsum(valid, dim=1, dtype=i64)
    # k-mer registers over the valid-base sequence (valid rank order;
    # 2k bits in an int32 or int64 lane, and no shift leaves the 2k bits)
    cv = torch.zeros((R, W + 1), dtype=kdt, device=dev).scatter_(
        1, torch.where(valid, vcum - 1, W), codes)[:, :W]
    kf = cv.clone()
    kr = (3 ^ cv) << (2 * (k - 1))
    for d in range(1, k):
        kf[:, d:] |= cv[:, :W - d] << (2 * d)
        kr[:, d:] |= (3 ^ cv[:, :W - d]) << (2 * (k - 1 - d))
    # registers after column j (unchanged by an ambiguous column)
    rank = (vcum - 1).clamp(min=0)
    k0c = torch.where(vcum > 0, torch.gather(kf, 1, rank), 0)
    k1c = torch.where(vcum > 0, torch.gather(kr, 1, rank), 0)
    push = ~(valid & (k0c == k1c))
    pc = torch.cumsum(push, dim=1, dtype=i64)

    c0 = torch.arange(NC, dtype=i64, device=dev) * chunk
    prev_c = (c0 - 1).clamp(min=0).expand(R, NC)
    n_before = torch.where(c0 > 0, torch.gather(pc, 1, prev_c), 0)
    want = n_before - (w + k) + 1      # the push s0 starts at (1-based)
    s0 = torch.where(want > 1, torch.searchsorted(pc, want.contiguous()),
                     0)
    prev = (s0 - 1).clamp(min=0)
    k0 = torch.where(s0 > 0, torch.gather(k0c, 1, prev), 0)
    k1 = torch.where(s0 > 0, torch.gather(k1c, 1, prev), 0)
    scum = torch.cumsum(unpack1(startmask, W).to(i64), dim=1).contiguous()
    n_seg = torch.where(s0 > 0, torch.gather(scum, 1, prev), 0)
    segst = torch.where(n_seg > 0,
                        torch.searchsorted(scum, n_seg.contiguous()), 0)
    return torch.stack([s0, n_seg - 1, segst, k0, k1],
                       dim=2).to(kdt).contiguous()


def unpack2(words, W):
    """(R, W//16) int32 words -> (R, W) int64 2-bit fields."""
    R = words.shape[0]
    w64 = (words.to(torch.int64) & 0xFFFFFFFF)[:, :, None]
    sh = 2 * torch.arange(16, dtype=torch.int64, device=words.device)
    return ((w64 >> sh) & 3).reshape(R, W)


def unpack1(words, W):
    """(R, W//32) int32 words -> (R, W) bool."""
    R = words.shape[0]
    w64 = (words.to(torch.int64) & 0xFFFFFFFF)[:, :, None]
    sh = torch.arange(32, dtype=torch.int64, device=words.device)
    return (((w64 >> sh) & 1) != 0).reshape(R, W)


def sketch_tiles_plain(codes2, nmask, startmask, endmask, starts, gids, *,
                       W, k, w):
    """Plain tensor version of sketch_tiles (same per-column outputs)."""
    R = codes2.shape[0]
    dev = codes2.device
    i32 = torch.int32
    codes = unpack2(codes2, W)
    amb = unpack1(nmask, W)
    seg = torch.cumsum(unpack1(startmask, W).to(torch.int64), dim=1) - 1
    endb = unpack1(endmask, W)
    cols = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    # a row's used width ends at its last read's end column
    used = torch.where(endb, cols + 1, torch.zeros_like(cols)).amax(dim=1)
    codes = torch.where(amb, torch.full_like(codes, 4), codes)
    res = _sketch_core(codes, used, w=w, k=k, seg=seg)
    has = res["emit"] > 0
    col = torch.where(has, res["pos"].to(torch.int64),
                      torch.full_like(cols.expand(R, W), W))
    sg = res["seg"].clamp(0, READS_PER_ROW - 1)
    rid = torch.gather(gids.to(torch.int64), 1, sg)
    local = res["pos"].to(torch.int64) - torch.gather(
        starts.to(torch.int64), 1, sg)

    def place(v, dtype=i32):
        out = torch.zeros((R, W + 1), dtype=dtype, device=dev)
        return out.scatter_(1, col, v.to(dtype))[:, :W]

    return {"emit": place(torch.where(has, res["emit"],
                                      torch.zeros_like(res["emit"]))),
            "hash": place(torch.where(has, res["hash"],
                                      torch.zeros_like(res["hash"])),
                          hash_dtype(k)),
            "rid": place(torch.where(has, rid, torch.zeros_like(rid))),
            "pos": place(torch.where(has, local, torch.zeros_like(local))),
            "strand": place(torch.where(has, res["strand"],
                                        torch.zeros_like(res["strand"]))),
            "flags": torch.zeros(R, dtype=i32, device=dev)}
