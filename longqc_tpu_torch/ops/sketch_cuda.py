"""B1: the fused minimizer sketch over packed 2-bit rows.

`sketch_tiles` launches the hand-written kernel csrc/sketch.cu on CUDA
tensors (the port of longqc_tpu/ops/sketch_pallas.sketch_tiles_pallas)
and runs `sketch_tiles_plain` on CPU tensors. Both return per-column
(R, W) int32 arrays: emit (emission count), hash (bare minimizer hash),
rid (global read id), pos (read-local position), strand, plus an
all-zero (R,) flags tensor (the kernel attributes every emission
exactly, so no row needs the exact fallback the TPU kernel's flag
requested). hash/rid/pos/strand are only meaningful where emit > 0;
every caller masks the rest.

The plain version is the seg-mode `_sketch_core` (ops/sketch) plus the
read-id / local-position mapping of the JAX tile_flat XLA branch,
scattered back from buffer-entry order to columns.
"""

import torch

from longqc_tpu_torch.ops import _ext
from longqc_tpu_torch.ops.sketch import _sketch_core

READS_PER_ROW = 64
MAX_W = 32          # ring slots in the kernel


def _check_shapes(codes2, nmask, startmask, endmask, starts, gids, W, k, w):
    R = codes2.shape[0]
    if not (2 * k <= 30 and 0 < w <= MAX_W and W % 32 == 0 and W >= 32):
        raise ValueError("sketch kernel needs 2k <= 30, w <= %d and "
                         "W %% 32 == 0 (k=%d w=%d W=%d)" % (MAX_W, k, w, W))
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
    outs = [torch.empty((R, W), dtype=torch.int32, device=codes2.device)
            for _ in range(5)]
    lib = _ext.lib()
    _ext.LAUNCHES["sketch"] += 1
    lib.sketch_rows(*ins, *outs, W, k, w)
    emit, hsh, rid, pos, strand = outs
    return {"emit": emit, "hash": hsh, "rid": rid, "pos": pos,
            "strand": strand,
            "flags": torch.zeros(R, dtype=torch.int32,
                                 device=codes2.device)}


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

    def place(v):
        out = torch.zeros((R, W + 1), dtype=i32, device=dev)
        return out.scatter_(1, col, v.to(i32))[:, :W]

    return {"emit": place(torch.where(has, res["emit"],
                                      torch.zeros_like(res["emit"]))),
            "hash": place(torch.where(has, res["hash"],
                                      torch.zeros_like(res["hash"]))),
            "rid": place(torch.where(has, rid, torch.zeros_like(rid))),
            "pos": place(torch.where(has, local, torch.zeros_like(local))),
            "strand": place(torch.where(has, res["strand"],
                                        torch.zeros_like(res["strand"]))),
            "flags": torch.zeros(R, dtype=i32, device=dev)}
