"""The integer arithmetic of the fused cheap-phase kernel
(``src/repro_torch/csrc/cheap_fused.cu``), modelled in numpy on the CPU and
held against the JAX package: the quantization's mean, variance and
24-step Newton square root in one warp and in unsigned arithmetic, the
symbol step as an unsigned division, and the vote's slot decomposition
(``/ H``, ``% H``) and bin (``% vote_bins``) as shifts and masks in the
shipped instance and as unsigned divisions in the generic one.  The kernel
itself runs only on the card (``tests/test_torch_gpu.py``).  Tolerance:
exact.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import quantization as jquant                 # noqa: E402
from repro.core import vote as jvote                          # noqa: E402

DIAG_SHIFT = 1 << 20                 # cheap_fused.cu kDiagShift
I32, U32 = np.int32, np.uint32


def _floordiv(a, b):
    """The kernel's floordiv of int32 values (exact floor, int32 result)."""
    return (np.asarray(a, np.int64) // np.asarray(b, np.int64)).astype(I32)


def _wrap(a):
    """int64 -> int32 with two's complement wraparound, as int32 adds."""
    return np.asarray(a, np.int64).astype(np.uint32).view(I32)


def newton_unsigned(var):
    """The kernel's square root: up to 24 steps of
    (sq + var / max(sq, 1)) >> 1 in uint32 from max(var, 1), ended at a
    fixed point or a two-cycle (then the parity of the steps left picks
    the value), then max(sq, 1).  Returns (root, steps taken)."""
    v = np.asarray(var, I32).astype(U32)
    sq = np.maximum(v, U32(1))
    before = np.full_like(sq, 0xFFFFFFFF)
    live = np.ones(sq.shape, bool)
    steps = np.zeros(sq.shape, np.int64)
    for it in range(24):
        nxt = (sq + v // np.maximum(sq, U32(1))) >> U32(1)
        fixed = live & (nxt == sq)
        cycle = live & ~fixed & (nxt == before)
        take = live & ~fixed & (~cycle | ((23 - it) % 2 == 0))
        steps += live
        before = np.where(live & ~fixed & ~cycle, sq, before)
        sq = np.where(take, nxt, sq)
        live &= ~(fixed | cycle)
    return np.maximum(sq.astype(I32), I32(1)), steps


def quantize_model(eq, nev, cfg):
    """The kernel's quantization of one chunk: eq (R, E) int32 Q-format
    means, nev (R,) valid prefix lengths.  Returns (R, E) int32 symbols."""
    E = eq.shape[1]
    valid = np.arange(E)[None] < nev[:, None]
    n = np.maximum(nev, 1).astype(I32)[:, None]
    mean = _floordiv(_wrap(np.where(valid, eq, 0).astype(np.int64)
                           .sum(1, keepdims=True)), n)
    d = _wrap(eq.astype(np.int64) - mean)
    d2 = d >> 1
    ssq = _wrap(np.where(valid, d2.astype(np.int64) ** 2, 0).sum(
        1, keepdims=True))
    var = _wrap(_floordiv(ssq, n).astype(np.int64) * 4)
    sd = newton_unsigned(var)[0]
    f = cfg.frac_bits
    clip_q = int(round(cfg.quant_clip_sigma * (1 << f)))
    step_q = U32(max((2 * clip_q) // cfg.quant_levels, 1))
    zq = _floordiv(_wrap(d.astype(np.int64) * (1 << f)), sd)
    zq = np.clip(zq, -clip_q, clip_q - 1)
    sym = ((zq + clip_q).astype(U32) // step_q).astype(I32)
    return np.clip(sym, 0, cfg.quant_levels - 1)


def _jax_quantize(eq, nev, cfg):
    valid = np.arange(eq.shape[1])[None] < nev[:, None]
    return np.asarray(jax.jit(jax.vmap(
        lambda e, v: jquant.quantize_events_fixed(e, v, cfg)))(eq, valid))


@pytest.mark.parametrize("var", [
    "small", "squares_less_one", "random", "int32_top"])
def test_unsigned_newton_equals_the_reference_steps(var):
    """The reference's 24 signed floor-division steps (as jit compiles
    them) equal the kernel's unsigned ones, ended early, for every variance
    in [0, 2^31 - 4] drawn: small ones, the k^2 - 1 values where Newton
    ends in a two-cycle, random ones, and the top of int32, where the first
    step's sum is var + 1."""
    rng = np.random.default_rng(1)
    if var == "small":
        v = np.arange(0, 1 << 16, dtype=np.int64)
    elif var == "squares_less_one":
        k = np.arange(1, 46341, dtype=np.int64)
        v = np.concatenate([k * k - 1, k * k, k * k + 1])
    elif var == "random":
        v = rng.integers(0, (1 << 31) - 3, 200_000)
    else:
        v = np.arange((1 << 31) - 4 - 4 * 4096, (1 << 31) - 3, 4)
    v = v[v <= (1 << 31) - 4].astype(I32)

    def steps(x):
        s = jax.lax.fori_loop(
            0, 24, lambda _, s: (s + x // jnp.maximum(s, 1)) // 2,
            jnp.maximum(x, 1))
        return jnp.maximum(s, 1)
    want = np.asarray(jax.jit(jax.vmap(steps))(v))
    got, taken = newton_unsigned(v)
    np.testing.assert_array_equal(got, want)
    if var == "squares_less_one":
        # the steps end early on nearly all of them
        assert (taken < 24).mean() > 0.9


# the MARS config and configs whose symbol step is another constant
CONFIGS = {
    "mars": {},
    "q2": dict(quant_bits=2),
    "q4": dict(quant_bits=4),
    "clip2.5": dict(quant_clip_sigma=2.5),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_quantize_model_equals_jax(name):
    """Random Q-format event means in the range the early quantization
    gives (|x| <= 8 * 2^8), every prefix length of valid events, and edge
    rows: a variance at the top of int32 (two events 92,680 apart), equal
    events (variance 0), one valid event, none."""
    cfg = JaxConfig(**CONFIGS[name])
    E = cfg.max_events
    rng = np.random.default_rng(len(name))
    R = 512
    eq = np.clip(np.round(rng.standard_normal((R, E)) * rng.uniform(
        20, 900, (R, 1))), -2048, 2048).astype(I32)
    nev = rng.integers(0, E + 1, R).astype(I32)
    eq[0, :2] = (46340, -46340)
    nev[0] = 2
    eq[1, :] = 77
    nev[2] = 1
    nev[3] = 0
    eq[4, :] = rng.integers(-2048, 2049, E)
    nev[4] = E
    got = quantize_model(eq, nev, cfg)
    want = _jax_quantize(eq, nev, cfg)
    np.testing.assert_array_equal(got, want)
    # the edge row's variance is at the top of the int32 range
    d2 = 46340 >> 1
    assert (2 * d2 * d2 // 2) * 4 > (1 << 31) - (1 << 17)


def vote_model(t_pos, hit, H, nbins, cfg, shipped):
    """The kernel's vote on the flat (R, E*H) slot plane: e, h from the
    slot index and the two bins, by shifts and masks in the shipped
    instance (H = 16, 4096 bins) and by unsigned division otherwise.
    Returns (keep, anchors, votes cast, clipped votes)."""
    R, EH = t_pos.shape
    s = np.arange(EH, dtype=U32)
    if shipped:
        assert H == 16 and nbins == 4096
        e = (s >> U32(4)).astype(I32)
        h = (s & U32(15)).astype(I32)
    else:
        e = (s // U32(H)).astype(I32)
        h = (s - e.astype(U32) * U32(H)).astype(I32)
    assert (e * H + h == np.arange(EH)).all()
    shifted = _wrap(t_pos.astype(np.int64) - e + DIAG_SHIFT)
    wid = np.maximum(shifted, 0).astype(U32) >> U32(
        cfg.voting_window_log2)
    if shipped:
        b1, b2 = wid & U32(nbins - 1), (wid + U32(1)) & U32(nbins - 1)
    else:
        b1, b2 = wid % U32(nbins), (wid + U32(1)) % U32(nbins)
    hist = np.zeros((R, nbins), np.int64)
    rows = np.broadcast_to(np.arange(R)[:, None], t_pos.shape)
    np.add.at(hist, (rows[hit], b1[hit].astype(np.int64)), 1)
    np.add.at(hist, (rows[hit], b2[hit].astype(np.int64)), 1)
    v1 = np.take_along_axis(hist, b1.astype(np.int64), 1)
    v2 = np.take_along_axis(hist, b2.astype(np.int64), 1)
    keep = hit & (np.maximum(v1, v2) >= cfg.thresh_voting)
    return (keep, keep.sum(1), 2 * hit.sum(1),
            (hit & (shifted < 0)).sum(1))


@pytest.mark.parametrize("H,nbins", [(16, 4096), (16, 3000), (12, 4096),
                                     (12, 3000)])
def test_kernel_vote_bins_equal_jax_vote_filter(H, nbins):
    """Projected starts spread over the genome, piled on one window, below
    -DIAG_SHIFT (clipped) and at the bin table's wrap (wid = nbins - 1)."""
    cfg = JaxConfig(max_hits_per_seed=H, vote_bins=nbins)
    E = cfg.max_events
    rng = np.random.default_rng(H * nbins)
    R = 64
    t_pos = rng.integers(0, 4_000_000, (R, E * H)).astype(I32)
    e = np.arange(E * H) // H
    t_pos[1] = 777_000 + e                         # one window for all
    t_pos[2, ::3] = -DIAG_SHIFT - 5 + e[::3]        # clipped
    wrap = ((nbins - 1) << cfg.voting_window_log2) - DIAG_SHIFT
    t_pos[3] = wrap + e + rng.integers(0, 512, E * H)
    t_pos[4] = (1 << 31) - DIAG_SHIFT - 1 - rng.integers(0, 9, E * H)
    hit = rng.random((R, E * H)) < 0.5
    hit[1] = True
    for shipped in ((False, True) if (H, nbins) == (16, 4096)
                    else (False,)):
        got = vote_model(t_pos, hit, H, nbins, cfg, shipped)
        q_pos = np.broadcast_to(np.arange(E, dtype=I32)[None, :, None],
                                (R, E, H))
        keep, c = jax.jit(lambda q, t, v: jvote.vote_filter(q, t, v, cfg))(
            q_pos, t_pos.reshape(R, E, H), hit.reshape(R, E, H))
        np.testing.assert_array_equal(got[0], np.asarray(keep).reshape(R, -1))
        for g, k in zip(got[1:], ("n_anchors_postvote", "n_votes_cast",
                                  "n_votes_clipped")):
            np.testing.assert_array_equal(g, np.asarray(c[k]), k)
    assert got[1][1] == E * H and got[3][2] > 0
