"""Each CUDA kernel against its plain PyTorch version on the card, at the
mapping path's shapes (D5 index, 512 reads of 1024 samples): the fused
cheap phase, the per-stage event detection and the two lookups on the
indices D5's query issues, the in-order segment sum of the float
detection, the sort and the DP.  At full width
the sort and the DP take every read of the chunk, as the gate's full branch
gives them (rows of 3072 keys, 512 anchors); at the ladder widths they take
the reads with anchors, as the compacted branch does (64 or 128 of each
read's smallest keys).  Tolerance: exact.

Marked ``gpu``; every test decides inside itself whether a card exists and
skips without one:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX package, which a
machine with the card need not have.)
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def d5():
    dev = _card()
    from repro_torch.core import build_index, events
    from repro_torch.core.index import index_arrays
    from repro_torch.signal import datasets, simulate
    spec = datasets.DATASETS["D5"]
    cfg = datasets.config_for(spec).with_mode("ms_fixed")
    ref = simulate.make_reference(spec.genome_len, seed=spec.seed)
    reads = simulate.sample_reads(ref, 512, signal_len=cfg.signal_len,
                                  seed=spec.seed + 1, junk_frac=0.08)
    arrays = index_arrays(build_index(ref.events_concat, ref.n_events, cfg),
                          dev)
    xq = events.early_quantize(torch.from_numpy(reads.signals).to(dev), cfg)
    return cfg, arrays, xq


def _rows(d5, survivors):
    """The packed anchor keys of the reads with anchors left, or of every
    read."""
    from repro_torch.core import chaining
    from repro_torch.kernels.cheap_fused.ref import cheap_fused_rows_ref
    cfg, arrays, xq = d5
    R, E, H = xq.shape[0], cfg.max_events, cfg.max_hits_per_seed
    t_pos, keep, cnt = cheap_fused_rows_ref(
        xq, arrays["bucket_start"], arrays["entries_packed"], cfg)
    surv = (cnt[:, 7] > 0) | (not survivors)
    q_pos = torch.arange(E, dtype=torch.int32, device=xq.device)[
        None, :, None].expand(R, E, H)
    return chaining.pack_anchor_keys(q_pos[surv],
                                     t_pos.reshape(R, E, H)[surv],
                                     keep.reshape(R, E, H)[surv].bool())


def test_cheap_fused_kernel_equals_plain(d5):
    from repro_torch import kernels as K
    from repro_torch.kernels.cheap_fused import ops
    from repro_torch.kernels.cheap_fused.ref import cheap_fused_rows_ref
    cfg, arrays, xq = d5
    args = (xq, arrays["bucket_start"], arrays["entries_packed"], cfg)
    n0 = K.LAUNCHES["cheap_fused"]
    got = ops.cheap_fused_rows(*args)
    want = cheap_fused_rows_ref(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cheap_fused"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("L", [64, 128, 3072])
def test_bitonic_sort_kernel_equals_plain(d5, L):
    from repro_torch.core import chaining
    from repro_torch.kernels.bitonic_sort import ops
    from repro_torch.kernels.bitonic_sort.ref import sort_rows_ref
    cfg = d5[0]
    full = L == cfg.max_events * cfg.max_hits_per_seed
    key = _rows(d5, survivors=not full)
    rows = key if full else chaining.select_smallest_count(key, L)
    got = ops.sort_rows(rows.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, sort_rows_ref(rows))


@pytest.mark.parametrize("A", [64, 128, 512])
def test_chain_dp_kernel_equals_plain(d5, A):
    from repro_torch.core import chaining
    from repro_torch.kernels.chain_dp import ops
    from repro_torch.kernels.chain_dp.ref import chain_dp_ref
    cfg = d5[0]
    key = _rows(d5, survivors=A < cfg.max_anchors)
    rows = (torch.sort(key, dim=1).values[:, :A] if A == cfg.max_anchors
            else torch.sort(chaining.select_smallest_count(key, A),
                            dim=1).values)
    sq, st, sv = (x.contiguous() for x in chaining.decode_anchor_keys(rows))
    got = ops.chain_dp(sq, st, sv, cfg)
    want = chain_dp_ref(sq, st, sv, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_chain_dp_kernel_rejects_other_bands(d5):
    from repro_torch.kernels.chain_dp import ops
    dev = d5[1]["bucket_start"].device
    q = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="chain_band"):
        ops.chain_dp(q, q, q.bool(), d5[0].replace(chain_band=16))


def _query_indices(d5):
    """The bucket-offset and entry-row indices D5's query issues."""
    from repro_torch.core import hashing, quantization, seeding
    from repro_torch.kernels.event_detect.ref import event_detect_rows_ref
    cfg, arrays, xq = d5
    E, H = cfg.max_events, cfg.max_hits_per_seed
    means, nev = event_detect_rows_ref(xq, cfg)
    valid = torch.arange(E, device=xq.device) < nev.unsqueeze(-1)
    keys, _ = hashing.pack_seeds(
        quantization.quantize_events(means, valid, cfg), nev, cfg)
    bucket = (keys & (cfg.n_buckets - 1)).to(torch.int32)
    bidx = torch.stack([bucket, bucket + 1])
    start = seeding._take_clip(arrays["bucket_start"], bidx)[0]
    n = arrays["entries_packed"].shape[1]
    idx = torch.clamp(start.unsqueeze(-1)
                      + torch.arange(H, dtype=torch.int32, device=xq.device),
                      max=n - 1)
    return bidx, idx


def test_event_detect_kernel_equals_plain(d5):
    from repro_torch import kernels as K
    from repro_torch.kernels.event_detect import ops
    from repro_torch.kernels.event_detect.ref import event_detect_rows_ref
    cfg, _, xq = d5
    n0 = K.LAUNCHES["event_detect"]
    got = ops.event_detect_rows(xq, cfg)
    want = event_detect_rows_ref(xq, cfg)
    torch.cuda.synchronize()
    assert K.LAUNCHES["event_detect"] == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_lookup_kernels_equal_plain(d5):
    from repro_torch import kernels as K
    from repro_torch.kernels.pluto_lookup import ops
    from repro_torch.kernels.pluto_lookup.ref import lookup_ref
    _, arrays, xq = d5
    bidx, idx = _query_indices(d5)
    wild = torch.randint(-50, arrays["entries_packed"].shape[1] + 50,
                         (1000,), dtype=torch.int32, device=xq.device)
    for table, i, name in ((arrays["bucket_start"], bidx, "pluto_lookup"),
                           (arrays["entries_packed"], idx,
                            "pluto_lookup_rows"),
                           (arrays["entries_packed"], wild,
                            "pluto_lookup_rows")):
        n0 = K.LAUNCHES[name]
        got = ops.lookup(table, i)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == n0 + 1
        assert torch.equal(got, lookup_ref(table, i)), name


def test_lookup_kernels_keep_narrow_dtypes_and_refuse_64_bit():
    """A narrower table comes back in its own dtype, equal to the CPU's
    answer; a 64-bit table or index raises on the card as on the CPU."""
    dev = _card()
    from repro_torch.kernels.pluto_lookup import ops
    g = torch.Generator().manual_seed(4)
    table = torch.randint(-2**15, 2**15, (2, 777), generator=g,
                          dtype=torch.int16)
    idx = torch.randint(-9, 790, (5, 41), generator=g, dtype=torch.int32)
    for t in (table[0], table):
        got = ops.lookup(t.to(dev), idx.to(dev))
        assert got.dtype == torch.int16
        assert torch.equal(got.cpu(), ops.lookup(t, idx))
    for t, i in ((table.to(torch.int64), idx),
                 (table, idx.to(torch.int64))):
        with pytest.raises(TypeError, match="at most 32 bits"):
            ops.lookup(t.to(dev), i.to(dev))
        with pytest.raises(TypeError, match="at most 32 bits"):
            ops.lookup(t, i)


def test_segment_sum_kernel_equals_plain(d5):
    """The float detection's in-order segment sums (ms_float's dequantized
    signal and boundaries): bit-equal to the sequential plain version."""
    from repro_torch.core import events
    from repro_torch.kernels.segment_sum import ops
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    cfg, _, xq = d5
    cfg_f = cfg.with_mode("ms_float")
    x = events.dequantize_fixed(xq, cfg.frac_bits)
    eid = events._event_ids(events.boundary_mask_float(x, cfg_f),
                            cfg.max_events)
    got = ops.segment_sum(x, eid, cfg.max_events, x.shape[1])
    want = segment_sum_ref(x, eid, cfg.max_events, x.shape[1])
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def d5_signals(d5):
    from repro_torch.signal import datasets, simulate
    spec = datasets.DATASETS["D5"]
    ref = simulate.make_reference(spec.genome_len, seed=spec.seed)
    reads = simulate.sample_reads(ref, 64, signal_len=d5[0].signal_len,
                                  seed=spec.seed + 1, junk_frac=0.08)
    return torch.from_numpy(reads.signals).to(d5[2].device)


def test_kernels_plan_never_runs_the_plain_cheap_phase_on_the_card(
        d5, d5_signals):
    """On the card the kernels plan's per-stage level launches the
    event_detect and lookup kernels (never the plain versions) and equals
    the fused kernel and the reference plan, which launches no kernel; a
    float config resolves detect to the reference (no event_detect launch,
    the segment_sum helper for its sums) and still launches the
    lookups."""
    from repro_torch import kernels as K
    from repro_torch.core import pipeline, stages
    cfg, arrays, _ = d5
    sig = d5_signals
    for c, launched, idle in (
            (cfg, ("event_detect", "pluto_lookup", "pluto_lookup_rows"),
             ("cheap_fused", "segment_sum")),
            (cfg.with_mode("ms_float"),
             ("pluto_lookup", "pluto_lookup_rows", "segment_sum"),
             ("cheap_fused", "event_detect"))):
        kern = stages.resolve_plan(c, stages.KERNELS)
        K.reset_launches()
        got = pipeline.cheap_phase(sig, arrays, c, kern, use_fused=False)
        torch.cuda.synchronize()
        assert all(K.LAUNCHES[k] == 1 for k in launched), K.LAUNCHES
        assert all(K.LAUNCHES[k] == 0 for k in idle), K.LAUNCHES
        K.reset_launches()
        wants = [pipeline.cheap_phase(sig, arrays, c, stages.resolve_plan(
            c, stages.REFERENCE))]
        torch.cuda.synchronize()
        # the reference plan is plain torch on the card: no kernel launches
        assert not any(K.LAUNCHES.values()), K.LAUNCHES
        if c.fixed_point:
            wants.append(pipeline.cheap_phase(sig, arrays, c, kern))
        torch.cuda.synchronize()
        for want in wants:
            for g, w in zip(got[:3], want[:3]):
                assert torch.equal(g, w)
            assert all(torch.equal(got[3][k], want[3][k]) for k in want[3])
