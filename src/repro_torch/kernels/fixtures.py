"""Inputs built to break the kernels, shared by the tests and
``chip_smoke.py``: sort rows with the pad key and both int32 extremes inside
them, and chaining anchors on which the DP's oldest-slot rule decides."""
import numpy as np

INT32_MAX, INT32_MIN = 2**31 - 1, -2**31

# Anchor motifs, as (dt, dq) offsets from the motif's last anchor.  Offsets
# (a, b) and (b, a) give one gap and one skip, so predecessors with equal f
# tie for the best candidate while their diagonals differ by 2 (a - b).
TIE_MOTIFS = (
    ((-7, -5), (-5, -7), (0, 0)),             # the newest slot ties an older
    ((-6, -5), (-5, -6), (-1, 50), (0, 0)),   # two older slots tie
    ((-9, -5), (-7, -7), (-5, -9), (0, 0)),   # a better middle slot
    ((-128, -128), (-129, -1), (0, 0)),       # dt == max_gap, max_gap + 1
    ((-3, 0), (0, -3), (0, 0), (0, 0)),       # dt or dq 0, duplicates
)


def edge_rows(rng: np.random.Generator, n: int, L: int) -> np.ndarray:
    """(n, L) int32 rows cycling through six kinds: small keys of both
    signs with INT32_MAX and INT32_MIN inside them (a single row is of this
    kind), keys over the whole int32 range, an all-equal row, heavy
    duplicates, negatives only, and a row of INT32_MAX (the kernel's pad)."""
    out = np.empty((n, L), np.int64)
    for r in range(n):
        kind = r % 6
        if kind == 0:
            k = rng.integers(-1000, 1000, L)
            k[rng.random(L) < 0.1] = INT32_MAX
            k[rng.random(L) < 0.1] = INT32_MIN
        elif kind == 1:
            k = rng.integers(INT32_MIN, INT32_MAX, L, endpoint=True)
        elif kind == 2:
            k = np.full(L, rng.integers(-5, 5))
        elif kind == 3:
            k = rng.integers(-3, 3, L)
        elif kind == 4:
            k = -rng.integers(1, 2**31, L)
        else:
            k = np.full(L, INT32_MAX)
        out[r] = k
    return out.astype(np.int32)


def tie_anchors(rng: np.random.Generator, rows: int, A: int,
                max_gap: int = 128, p_valid: float = 0.95):
    """(q, t, valid) numpy arrays of shape (rows, A), sorted by (t, q):
    motifs of TIE_MOTIFS at random, spaced by 6, 40, max_gap, max_gap + 1
    or 300 target positions, so the oldest-slot rule decides diag0 at many
    steps and some anchors sit exactly max_gap apart."""
    t = np.empty((rows, A), np.int64)
    q = np.empty((rows, A), np.int64)
    for r in range(rows):
        ts, qs, T = [], [], 1000
        while len(ts) < A:
            T += int(rng.choice([6, 40, max_gap, max_gap + 1, 300]))
            Q = int(rng.integers(140, 200))
            for dt, dq in TIE_MOTIFS[rng.integers(len(TIE_MOTIFS))]:
                ts.append(T + dt)
                qs.append(Q + dq)
        t[r], q[r] = ts[:A], qs[:A]
    order = np.lexsort((q, t), axis=-1)
    t = np.take_along_axis(t, order, -1).astype(np.int32)
    q = np.take_along_axis(q, order, -1).astype(np.int32)
    return q, t, rng.random((rows, A)) < p_valid


def lane_tie_anchors(rows: int, A: int, lag: int = 0):
    """(q, t, valid) of shape (rows, A) where the two predecessors tying
    for an anchor's best candidate lie 32 anchors apart: blocks of
    P1 = (T-7, Q-5), 31 invalid fillers at T-6, P2 = (T-5, Q-7), ``lag``
    invalid fillers at T-2 and the anchor (T, Q).  P1 and P2 score the
    same and give the anchor one gap and one skip each, with diagonals 4
    apart; the older, P1, must win.  Slots 32 apart share a lane of the DP
    kernels: at lag 0, P2 is the anchor's newest predecessor (the band
    kernel merges it on its chain, P1 in the reduction ahead of it); at a
    lag > 0 both are older slots of one lane, so the lane decides the tie.
    The anchor is in reach of P1 once the band is 33 + lag or wider."""
    spread = 32
    blk = spread + 2 + lag
    t = np.empty((rows, A), np.int32)
    q = np.empty((rows, A), np.int32)
    v = np.ones((rows, A), bool)
    for r in range(rows):
        for i in range(A):
            b, k = divmod(i, blk)
            T, Q = 1000 + 400 * b, 200 + 3 * r
            if k == 0:
                t[r, i], q[r, i] = T - 7, Q - 5
            elif k < spread:
                t[r, i], q[r, i], v[r, i] = T - 6, 10 * k, False
            elif k == spread:
                t[r, i], q[r, i] = T - 5, Q - 7
            elif k < blk - 1:
                t[r, i], q[r, i], v[r, i] = T - 2, 10 * k, False
            else:
                t[r, i], q[r, i] = T, Q
    order = np.lexsort((q, t), axis=-1)
    return (np.take_along_axis(q, order, -1), np.take_along_axis(t, order, -1),
            np.take_along_axis(v, order, -1))


def band_edge_anchors(rows: int, A: int, B: int):
    """(q, t, valid) of shape (rows, A) probing the band's far edge: groups
    of a predecessor P = (T, Q), invalid fillers at T + 2 and an anchor
    (T + 5, Q + 4) that P alone could extend, g anchors after P, where
    row r takes g = B - 1, B, B + 1 by r % 3 (at least 1).  At g <= B the
    anchor extends P's chain; at g = B + 1, P is out of the band."""
    t = np.empty((rows, A), np.int32)
    q = np.empty((rows, A), np.int32)
    v = np.ones((rows, A), bool)
    for r in range(rows):
        g = max(1, B + r % 3 - 1)
        for i in range(A):
            b, k = divmod(i, g + 1)
            T, Q = 1000 + 400 * b, 200 + 3 * r
            if k == 0:
                t[r, i], q[r, i] = T, Q
            elif k < g:
                t[r, i], q[r, i], v[r, i] = T + 2, 10 * k, False
            else:
                t[r, i], q[r, i] = T + 5, Q + 4
    return q, t, v
