"""The segment-parallel in-order sum of ``src/repro_torch/csrc/segment_sum.cu``,
modelled in torch on the CPU: the row in tiles of the kernel's size; in a
tile whose ids never decrease, the run boundaries give each segment its
run, and every segment adds its run in order, one sample a step, onto the
sum it carries from the tile before; in a tile whose ids do decrease, every
segment scans the tile in sample order.  The model must be bit-equal to the
plain version (``events.segment_sum_in_order``) and to the JAX package's
``segment_sum`` as ``jax.jit`` compiles it, on the float modes' detection
inputs and on ids built to break it.  The kernel itself runs only on the
card (``tests/test_torch_gpu.py``).  Tolerance: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import events as jev                          # noqa: E402
from repro_torch.core import MarsConfig, events               # noqa: E402

TILE = 2048                          # segment_sum.cu kTile


def segment_sum_runs(x, eid, n_seg, valid_len, tile=TILE):
    """The kernel's order of additions.  x: (R, S) f32; eid: (R, S) int32
    in [0, n_seg).  Returns (sums, counts), (R, n_seg) f32 each."""
    R = x.shape[0]
    acc = torch.zeros((R, n_seg), dtype=torch.float32)
    cnt = torch.zeros((R, n_seg), dtype=torch.int64)
    for t0 in range(0, valid_len, tile):
        n = min(tile, valid_len - t0)
        xs = x[:, t0:t0 + n]
        es = eid[:, t0:t0 + n].to(torch.int64)
        change = es[:, 1:] != es[:, :-1]
        descends = (es[:, 1:] < es[:, :-1]).any(1)
        runs = ~descends
        # run marks: a segment's first sample and one past its last
        start = torch.cat([torch.ones((R, 1), dtype=torch.bool), change], 1)
        stop = torch.cat([change, torch.ones((R, 1), dtype=torch.bool)], 1)
        first = torch.zeros((R, n_seg), dtype=torch.int64)
        last = torch.zeros((R, n_seg), dtype=torch.int64)
        r, i = (start & runs[:, None]).nonzero(as_tuple=True)
        first[r, es[r, i]] = i
        r, i = (stop & runs[:, None]).nonzero(as_tuple=True)
        last[r, es[r, i]] = i + 1
        length = last - first
        # one step adds each segment's next sample of its run
        for j in range(int(length.max()) if n else 0):
            take = length > j
            nxt = xs.gather(1, (first + j).clamp(max=n - 1))
            acc = torch.where(take, acc + nxt, acc)
        cnt += length
        # the tiles whose ids decrease: each segment scans in sample order
        rows = descends.nonzero(as_tuple=True)[0]
        for i in range(n):
            e = es[rows, i]
            acc[rows, e] = acc[rows, e] + xs[rows, i]
            cnt[rows, e] += 1
    return acc, cnt.to(torch.float32)


def _jax_segment_sum(x, eid, n_seg, valid_len):
    """The JAX package's segment sums as segment_means_reference builds
    them (samples past valid_len to an overflow bin), under jax.jit."""
    S = x.shape[1]
    valid = np.arange(S) < valid_len

    def one(xr, er):
        seg = jnp.where(valid, er, n_seg)
        sums = jax.ops.segment_sum(jnp.where(valid, xr, 0.0), seg,
                                   num_segments=n_seg + 1)[:n_seg]
        cnts = jax.ops.segment_sum(valid.astype(jnp.float32), seg,
                                   num_segments=n_seg + 1)[:n_seg]
        return sums, cnts
    return [np.asarray(a) for a in jax.jit(jax.vmap(one))(x, eid)]


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32)


@pytest.fixture(scope="module")
def detection(small_reads):
    """The float modes' detection inputs of the conftest reads: the
    normalized signal and boundaries (rh2), the dequantized Q-format
    signal and boundaries (ms_float)."""
    sig = torch.from_numpy(small_reads.signals)
    out = {}
    for mode in ("rh2", "ms_float"):
        cfg = MarsConfig().with_mode(mode)
        x = events.robust_normalize(sig)
        if cfg.early_quantization:
            x = events.dequantize_fixed(
                events.quantize_signal_fixed(x, cfg.frac_bits),
                cfg.frac_bits)
        out[mode] = (x.contiguous(), events.boundary_mask_float(x, cfg),
                     cfg.max_events)
    return out


CASES = ("ms_float", "rh2", "rh2 valid_len 700", "rh2 shuffled ids",
         "rh2 one run of 1024", "rh2 tail run", "three tiles, mixed rows")


@pytest.mark.parametrize("case", CASES)
def test_segment_parallel_sum_equals_in_order_and_jax(detection, case):
    mode = "ms_float" if case == "ms_float" else "rh2"
    x, b, E = detection[mode]
    R, S = x.shape
    eid = events._event_ids(b, E)
    valid_len = 700 if "700" in case else S
    rng = np.random.default_rng(len(case))
    if "shuffled" in case:
        eid = torch.from_numpy(np.stack([rng.permutation(r)
                                         for r in eid.numpy()]))
    elif "one run" in case:
        eid = torch.zeros_like(eid)
    elif "tail" in case:                # the clamped last event: 642 samples
        eid = torch.clamp(torch.arange(S, dtype=torch.int32) // 2,
                          max=E - 1).expand(R, S).contiguous()
    elif "tiles" in case:               # 6000 samples: 3 tiles a row
        x = torch.from_numpy(rng.standard_normal((4, 6000)).astype(
            np.float32) * 3)
        e = np.sort(rng.integers(0, 300, (4, 6000)), axis=1)
        e[1] = rng.integers(0, 300, 6000)               # every tile mixed
        e[2, 2500:2600] = e[2, 2500:2600][::-1]         # one tile mixed
        eid = torch.from_numpy(e.astype(np.int32))
        E, S, valid_len = 300, 6000, 5990
    got = segment_sum_runs(x, eid, E, valid_len)
    plain = events.segment_sum_in_order(x, eid, E, valid_len)
    want = _jax_segment_sum(x.numpy(), eid.numpy(), E, valid_len)
    for g, p, w, n in zip(got, plain, want, ("sums", "counts")):
        np.testing.assert_array_equal(_bits(g), _bits(w), n)
        np.testing.assert_array_equal(_bits(p), _bits(w), n)
    if case in ("ms_float", "rh2", "rh2 valid_len 700"):
        # through the float detection's means, against the JAX package's
        # segment_means_reference under jit
        jm = jax.jit(jax.vmap(lambda r, c: jev.segment_means_reference(
            r, c, valid_len, E)))(x.numpy(), b.numpy())
        tm = events.segment_means_reference(x, b, valid_len, E,
                                            segment_sum=segment_sum_runs)
        for g, w, n in zip(tm, jm, ("means", "n_events", "counts")):
            np.testing.assert_array_equal(_bits(g), _bits(w), n)
    if mode == "rh2" and valid_len == S:
        # the order decides bits on these inputs: each row read backwards
        # (so each run summed from its end) gives other sums
        back = segment_sum_runs(x.flip(1), eid.flip(1), E, S)[0]
        assert (_bits(back) != _bits(got[0])).any()
