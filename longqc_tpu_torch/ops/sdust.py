"""Symmetric DUST low-complexity masking (cf. sdust.c, Morgulis 2006;
port of longqc_tpu/ops/sdust).

Two tiers:
  1. A vectorized screen, as torch ops on the reads' device, computes
     per position the windowed triplet counts and flags any position
     where the masking recursion could possibly trigger:  rw*10 >
     len*T  (with len >= the shrunk L the C uses) or any triplet count
     >= 2T/10+1 (the cv-shrink condition, sdust.c:85).  Reads with no
     flagged positions provably have masked_len == 0.  Its flags equal
     the JAX screen's on every read.
  2. Flagged reads run the exact sequential recursion on the host:
     `masked_length` calls its C++ form (csrc/sdust_native.cpp, built
     by io/native on first use; `sdust_impl()` says whether it loaded),
     else sdust_host, the Python specification it is tested against.
     On random long reads the screen flags most reads (a count of 5 of
     one triplet in 62 is common), so the recursion's speed is the
     stage's.

The sdust table row is `name, masked_len, len, frac, meanQ, nQ7`
(sdust.c:211-217); that table doubles as LongQC's master per-read
length/QV table.
"""

import numpy as np
import torch

from longqc_tpu_torch.io.pack import SEQ_NT4_SDUST

SD_WLEN = 3
SD_WTOT = 64


# ---------------------------------------------------------------------------
# exact host recursion (behavioral spec of sdust_core, sdust.c:72-177)


def sdust_host(seq, T=20, W=64):
    """-> list of (start, end) merged masked intervals for one read."""
    codes = SEQ_NT4_SDUST[np.frombuffer(seq.encode("ascii"),
                                        dtype=np.uint8)]
    res = []          # merged intervals
    P = []            # perfect intervals: dicts, sorted desc by start
    win = []          # triplet window (deque)
    L = 0
    rw = rv = 0
    cw = [0] * SD_WTOT
    cv = [0] * SD_WTOT

    def save_masked_regions(start):
        nonlocal P
        if not P or P[-1]["start"] >= start:
            return
        p = P[-1]
        saved = False
        if res:
            s, f = res[-1]
            if p["start"] <= f:
                saved = True
                res[-1] = (s, max(f, p["finish"]))
        if not saved:
            res.append((p["start"], p["finish"]))
        i = len(P) - 1
        while i >= 0 and P[i]["start"] < start:
            i -= 1
        del P[i + 1:]

    def shift_window(t):
        nonlocal L, rw, rv
        if len(win) >= W - SD_WLEN + 1:
            s = win.pop(0)
            cw[s] -= 1
            rw -= cw[s]
            if L > len(win):
                L -= 1
                cv[s] -= 1
                rv -= cv[s]
        win.append(t)
        L += 1
        rw += cw[t]
        cw[t] += 1
        rv += cv[t]
        cv[t] += 1
        if cv[t] * 10 > (T << 1):
            while True:
                s = win[len(win) - L]
                cv[s] -= 1
                rv -= cv[s]
                L -= 1
                if s == t:
                    break

    def find_perfect(start):
        c = list(cv)
        r = rv
        max_r = max_l = 0
        for i in range(len(win) - L - 1, -1, -1):
            t = win[i]
            r += c[t]
            c[t] += 1
            new_r = r
            new_l = len(win) - i - 1
            if new_r * 10 > T * new_l:
                j = 0
                while j < len(P) and P[j]["start"] >= i + start:
                    p = P[j]
                    if max_r == 0 or p["r"] * max_l > max_r * p["l"]:
                        max_r, max_l = p["r"], p["l"]
                    j += 1
                if max_r == 0 or new_r * max_l >= max_r * new_l:
                    max_r, max_l = new_r, new_l
                    P.insert(j, {"start": i + start,
                                 "finish": len(win) + SD_WLEN - 1 + start,
                                 "r": new_r, "l": new_l})

    l = 0
    t = 0
    n = len(codes)
    for i in range(n + 1):
        b = int(codes[i]) if i < n else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & (SD_WTOT - 1)
            if l >= SD_WLEN:
                start = max(l - W, 0) + (i + 1 - l)
                save_masked_regions(start)
                shift_window(t)
                if rw * 10 > L * T:
                    find_perfect(start)
        else:
            start = max(l - W + 1, 0) + (i + 1 - l)
            while P:
                save_masked_regions(start)
                start += 1
            l = t = 0
    return res


def sdust_masked_length(seq, T=20, W=64):
    return sum(e - s for s, e in sdust_host(seq, T, W))


# the native recursion's build: library path, compiler command, seconds,
# and the error (None when it loaded)
NATIVE_BUILD = {"lib": None, "cmd": None, "build_s": 0.0, "error": None}
_native = []     # [CDLL or None] once loading was tried


def _native_lib():
    if not _native:
        import ctypes
        import os
        from longqc_tpu_torch.io import native
        src = os.path.join(os.path.dirname(native.SOURCE),
                           "sdust_native.cpp")
        lib = native.load_library(
            src, os.path.join(native.BUILD_ROOT, "sdust"),
            "libsdust_native", NATIVE_BUILD,
            what="sdust recursion (masking with the Python one)")
        if lib is not None:
            lib.lqs_masked_length.restype = ctypes.c_long
            lib.lqs_masked_length.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                              ctypes.c_int, ctypes.c_int]
        _native.append(lib)
    return _native[0]


def sdust_impl():
    """The recursion masked_length runs: "native" or "python"."""
    return "native" if _native_lib() is not None else "python"


def masked_length(seq, T=20, W=64):
    """sdust_masked_length through the C++ recursion when it is built."""
    lib = _native_lib()
    if lib is None:
        return sdust_masked_length(seq, T, W)
    b = seq.encode("ascii")
    return int(lib.lqs_masked_length(b, len(b), T, W))


# ---------------------------------------------------------------------------
# device screen


def sdust_screen_batch(codes, lengths, *, T=20, W=64):
    """Per-read flag (bool tensor): could sdust mask anything? (a sound
    over-approximation).

    codes: (B, L) SEQ_NT4_SDUST codes and lengths (B,), tensors of one
    device. A read is clean (False) when no position satisfies
    rw*10 > len*T  or  max triplet count >= 2T/10+1  over any window the
    C recursion would use.
    """
    B, L = codes.shape
    dev = codes.device
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_read = pos < lengths[:, None]
    valid = (codes < 4) & in_read

    # triplet value per position (ending at i), valid when the last 3
    # bases are valid
    c = codes.to(torch.int32)
    c1 = torch.nn.functional.pad(c, (1, 0))[:, :L]
    c2 = torch.nn.functional.pad(c, (2, 0))[:, :L]
    v1 = torch.nn.functional.pad(valid, (1, 0))[:, :L]
    v2 = torch.nn.functional.pad(valid, (2, 0))[:, :L]
    tri = (c2 << 4) | (c1 << 2) | c
    tri_valid = valid & v1 & v2 & (pos >= 2)

    # The C deque of pushed triplets persists across N-boundaries
    # (sdust.c:158-161 resets only l/t), so the window is the last
    # up-to-62 *pushed* triplets regardless of ambiguity gaps: window
    # arithmetic runs in triplet-rank space.
    wcap = W - SD_WLEN + 1  # 62
    tr_rank = torch.cumsum(tri_valid, dim=1, dtype=torch.int32)
    win_n = tr_rank.clamp(max=wcap)
    # read position of the triplet of each rank (for cumsum diffs); every
    # position that is no triplet writes slot L, which is never read
    rank_slot = torch.where(tri_valid, tr_rank - 1, L).to(torch.int64)
    pos_of_rank = torch.zeros((B, L + 1), dtype=torch.int32, device=dev)
    pos_of_rank.scatter_(1, rank_slot, pos.expand(B, L).contiguous())
    back_rank = tr_rank - win_n                      # 0 => none before
    back_pos = torch.gather(pos_of_rank, 1,
                            (back_rank - 1).clamp(0, L - 1).to(torch.int64))
    back_pos = back_pos.to(torch.int64)
    has_back = back_rank > 0

    # windowed per-triplet counts via cumsum differences, looped over the
    # 64 triplet values so that no (B, L, 64) tensor is built
    rw = torch.zeros((B, L), dtype=torch.int32, device=dev)
    maxc = torch.zeros((B, L), dtype=torch.int32, device=dev)
    shrink_th = (T << 1) // 10 + 1
    for tval in range(SD_WTOT):
        ind = (tri == tval) & tri_valid
        cum = torch.cumsum(ind, dim=1, dtype=torch.int32)
        base = torch.where(has_back, torch.gather(cum, 1, back_pos), 0)
        cnt = cum - base
        rw += cnt * (cnt - 1) // 2
        torch.maximum(maxc, cnt, out=maxc)
    trigger = ((rw * 10 > win_n * T) & (win_n > 0)) | (maxc >= shrink_th)
    trigger &= tri_valid
    return trigger.any(dim=1)


def masked_lengths(reads, codes=None, lengths=None, T=20, W=64,
                   device="cuda"):
    """Per-read sdust masked length: the screen on `device` + the host
    recursion for flagged reads."""
    from longqc_tpu_torch.io.pack import pack_reads
    from longqc_tpu_torch.ops._ext import require_device
    device = require_device(device)
    if codes is None:
        batch = pack_reads(reads, table=SEQ_NT4_SDUST, with_quals=False)
        codes, lengths = batch.codes, batch.lengths
    flags = sdust_screen_batch(torch.as_tensor(codes, device=device),
                               torch.as_tensor(lengths, device=device),
                               T=T, W=W).cpu().numpy()
    out = np.zeros(len(reads), np.int64)
    for i in np.nonzero(flags)[0]:
        out[i] = masked_length(reads[i][1], T, W)
    return out
