"""ksw2-class banded affine-gap extension (extz / extd), score only.

Torch port of longqc_tpu/ops/extend.py (the lax.scan formulation) and
the entry of its Pallas kernel (longqc_tpu/ops/extend_pallas). The
recurrences (ksw2.h:34-66, ksw2_extz2_sse.c, ksw2_extd2_sse.c):

  H[i][j] = max(H[i-1][j-1] + mat[q_i, t_j], E[i][j], F[i][j])
  E[i][j] = max(E[i][j-1], H[i][j-1] - gapo) - gape     (gap in query)
  F[i][j] = max(F[i-1][j], H[i-1][j] - gapo) - gape     (gap in target)

over the band |i - j| <= W, with an optional second gap family
(gapo2, gape2: extd), implicit boundaries -bndcost(l) where bndcost is
q + l*e (extd: the cheaper family, min(q+l*e, q2+l*e2)), and Z-drop.
Outputs per pair: max score and its (q, t) coordinates, the best score
at the query end (mqe, mqe_t) and at the target end (mte, mte_q), and
the Z-drop flag.

`extz_batch` launches the hand-written kernel (ops/extend_cuda,
csrc/extend.cu) on CUDA tensors and runs `extz_batch_plain` on CPU
tensors; `extz_host` is the full-DP numpy reference for short pairs.
Every value is int32 and every add is the JAX code's int32 add.
"""

import numpy as np
import torch

from longqc_tpu_torch.ops import _ext

NEG_INF = -0x40000000
BIG = 0x3FFFFFFF
KEYS = ("max", "max_q", "max_t", "mqe", "mqe_t", "mte", "mte_q",
        "zdropped")


def _as_tensor(a, device):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device=device, dtype=torch.int32).contiguous()


def extz_batch(query, qlens, target, tlens, *, W, match=2, mismatch=-4,
               gapo=4, gape=2, gapo2=None, gape2=None, zdrop=400,
               device=None):
    """Batched banded extension of (B, Lq) query and (B, Lt) target code
    arrays (0..3 = ACGT, 4 = ambiguous: always a mismatch) with (B,)
    lengths; gapo2/gape2 switch on extd. Inputs are tensors or numpy
    arrays; `device` (default: the query's device, CUDA for numpy) says
    where the run happens, and a CUDA device that is not there raises.
    Any W > 0 runs (the kernel clamps each pair's band to min(W,
    max(qlen, columns)), which leaves every output as it is). Returns a
    dict of (B,) tensors under KEYS (zdropped bool)."""
    if W <= 0:
        raise ValueError("half band width W must be positive")
    if (gapo2 is None) != (gape2 is None):
        raise ValueError("extd needs both gapo2 and gape2")
    if device is None:
        device = query.device if isinstance(query, torch.Tensor) else "cuda"
    device = _ext.require_device(device)
    ins = [_as_tensor(a, device) for a in (query, qlens, target, tlens)]
    kw = dict(W=W, match=match, mismatch=mismatch, gapo=gapo, gape=gape,
              gapo2=gapo2, gape2=gape2, zdrop=zdrop)
    if device.type == "cpu":
        return extz_batch_plain(*ins, **kw)
    from longqc_tpu_torch.ops.extend_cuda import extend_fill
    out = extend_fill(*ins, **kw)
    res = dict(zip(KEYS, out))
    res["zdropped"] = res["zdropped"] != 0
    return res


def extz_batch_plain(query, qlens, target, tlens, *, W, match=2,
                     mismatch=-4, gapo=4, gape=2, gapo2=None, gape2=None,
                     zdrop=400):
    """Plain tensor version: a loop over target columns with tensor ops
    over (B, band); band row r holds query index j + r - W at column j.
    Same contract as extz_batch on tensors of any one device."""
    dev = query.device
    i32 = torch.int32
    B, Lq = query.shape
    Lt = target.shape[1]
    dual = gapo2 is not None
    band = 2 * W + 1
    rr = torch.arange(band, dtype=i32, device=dev)[None, :]
    roff = rr - W

    def bndcost(l):  # noqa: E741
        b1 = gapo + l * gape
        if not dual:
            return b1
        b2 = gapo2 + l * gape2
        return torch.minimum(b1, b2) if torch.is_tensor(l) else min(b1, b2)

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=dev)

    qpad = torch.cat([query.to(i32), full((B, 1), 4)], dim=1)
    ql = qlens.to(i32)[:, None]
    tl = tlens.to(i32)
    negcol = full((B, 1), NEG_INF)
    H = full((B, band), NEG_INF)
    E = full((B, band), NEG_INF)
    E2 = full((B, band), NEG_INF)
    best = full((B,), 0)
    bq, bt = full((B,), -1), full((B,), -1)
    mqe, mqe_t = full((B,), NEG_INF), full((B,), -1)
    mte, mte_q = full((B,), NEG_INF), full((B,), -1)
    dropped = torch.zeros(B, dtype=torch.bool, device=dev)
    for j in range(Lt):
        qi = j + roff                                  # (1, band)
        q_ok = (qi >= 0) & (qi < ql)                   # (B, band)
        t_ok = j < tl                                  # (B,)
        tj = target[:, j].to(i32)[:, None]
        qidx = qi.clamp(0, Lq).to(torch.int64).expand(B, band)
        qb = torch.gather(qpad, 1, qidx)
        is_match = (qb == tj) & (qb < 4) & (tj < 4)
        sub = torch.where(is_match, match, mismatch).to(i32)

        # horizontal predecessors: row r+1 of the previous column
        H_left = torch.cat([H[:, 1:], negcol], dim=1)
        E_left = torch.cat([E[:, 1:], negcol], dim=1)
        if j == 0:
            H_left = (-bndcost(qi + 1)).expand(B, band)
            H_diag = torch.where(qi == 0, 0, -bndcost(qi)).to(i32)
        else:
            H_diag = torch.where(qi == 0, -bndcost(j), H).to(i32)
        E_j = torch.maximum(E_left, H_left - gapo) - gape
        base = torch.maximum(H_diag + sub, E_j)
        if dual:
            E2_left = torch.cat([E2[:, 1:], negcol], dim=1)
            E2_j = torch.maximum(E2_left, H_left - gapo2) - gape2
            base = torch.maximum(base, E2_j)
        base = torch.where(q_ok, base, NEG_INF)
        H_bnd_j = -bndcost(j + 1)

        def fscan(go, ge):
            # lazy F: max over r' < r of base[r'] - go - (r - r')*ge,
            # plus the chain from the boundary row
            run = torch.cummax(base - go + ge * rr, dim=1).values
            run_excl = torch.cat([negcol, run[:, :-1]], dim=1)
            F_bnd = H_bnd_j - go - (qi + 1) * ge
            return torch.maximum(run_excl - ge * rr,
                                 torch.where(q_ok, F_bnd, NEG_INF))

        H_j = torch.maximum(base, fscan(gapo, gape))
        if dual:
            H_j = torch.maximum(H_j, fscan(gapo2, gape2))
        valid = q_ok & t_ok[:, None] & ~dropped[:, None]
        H = torch.where(valid, H_j, NEG_INF)
        E = torch.where(valid, E_j, NEG_INF)
        if dual:
            E2 = torch.where(valid, E2_j, NEG_INF)

        # column maximum; ties go to the smallest band row
        col_best = H.amax(dim=1)
        col_r = torch.where(H == col_best[:, None], rr, BIG).amin(dim=1)
        col_qi = j + col_r - W
        better = col_best > best
        best = torch.where(better, col_best, best)
        bq = torch.where(better, col_qi, bq)
        bt = torch.where(better, j, bt)

        qe_score = torch.where(qi == ql - 1, H, NEG_INF).amax(dim=1)
        qe_up = qe_score > mqe
        mqe = torch.where(qe_up, qe_score, mqe)
        mqe_t = torch.where(qe_up, j, mqe_t)
        te_score = torch.where(tl - 1 == j, col_best, NEG_INF)
        te_up = te_score > mte
        mte = torch.where(te_up, te_score, mte)
        mte_q = torch.where(te_up, col_qi, mte_q)

        dropped = dropped | ((best - col_best > zdrop) & t_ok)
    return dict(zip(KEYS, (best, bq, bt, mqe, mqe_t, mte, mte_q, dropped)))


def extz_host(query, target, match=2, mismatch=-4, gapo=4, gape=2,
              gapo2=None, gape2=None, w=64, zdrop=400):
    """Reference implementation (full DP, numpy) for validating the
    batched versions; same recurrences, band, and outputs (without
    zdropped). gapo2/gape2 enable the dual-gap (extd) recurrence."""
    q = np.asarray(query)
    t = np.asarray(target)
    dual = gapo2 is not None

    def bndcost(l):  # noqa: E741
        b1 = gapo + l * gape
        return min(b1, gapo2 + l * gape2) if dual else b1

    n, m_ = len(q), len(t)
    H = np.full((n + 1, m_ + 1), NEG_INF, np.int64)
    E = np.full((n + 1, m_ + 1), NEG_INF, np.int64)
    F = np.full((n + 1, m_ + 1), NEG_INF, np.int64)
    E2 = np.full((n + 1, m_ + 1), NEG_INF, np.int64)
    F2 = np.full((n + 1, m_ + 1), NEG_INF, np.int64)
    H[0, 0] = 0
    for j in range(1, m_ + 1):
        H[0, j] = -bndcost(j)
    for i in range(1, n + 1):
        H[i, 0] = -bndcost(i)
    best, bq, bt = 0, -1, -1
    mqe, mqe_t = NEG_INF, -1
    mte, mte_q = NEG_INF, -1
    for j in range(1, m_ + 1):
        col_best = NEG_INF
        col_q = -1
        for i in range(1, n + 1):
            if abs((i - 1) - (j - 1)) > w:
                continue
            sub = (match if (q[i - 1] == t[j - 1] and q[i - 1] < 4
                             and t[j - 1] < 4) else mismatch)
            E[i, j] = max(E[i, j - 1], H[i, j - 1] - gapo) - gape
            F[i, j] = max(F[i - 1, j], H[i - 1, j] - gapo) - gape
            H[i, j] = max(H[i - 1, j - 1] + sub, E[i, j], F[i, j])
            if dual:
                E2[i, j] = max(E2[i, j - 1],
                               H[i, j - 1] - gapo2) - gape2
                F2[i, j] = max(F2[i - 1, j],
                               H[i - 1, j] - gapo2) - gape2
                H[i, j] = max(H[i, j], E2[i, j], F2[i, j])
            if H[i, j] > col_best:
                col_best = H[i, j]
                col_q = i - 1
            if H[i, j] > best:
                best, bq, bt = H[i, j], i - 1, j - 1
            if i == n and H[i, j] > mqe:
                mqe, mqe_t = H[i, j], j - 1
        if j == m_ and col_best > mte:
            mte, mte_q = col_best, col_q
        if best - col_best > zdrop:
            break
    return {"max": int(best), "max_q": int(bq), "max_t": int(bt),
            "mqe": int(mqe), "mqe_t": int(mqe_t),
            "mte": int(mte), "mte_q": int(mte_q)}
