"""Each CUDA kernel against its plain PyTorch version on the card, at the
mapping path's shapes (D5 index, 512 reads of 1024 samples): the fused
cheap phase, the per-stage event detection and the two lookups on the
indices D5's query issues, the in-order segment sum of the float
detection, the sort and the DP.  At full width
the sort and the DP take every read of the chunk, as the gate's full branch
gives them (rows of 3072 keys, 512 anchors); at the ladder widths they take
the reads with anchors, as the compacted branch does (64 or 128 of each
read's smallest keys).  Beside those, inputs built to break the
redesigned kernels: the sort's edge rows at every padded width, the DP's
tie-heavy anchors, the fused cheap phase's edge reads and generic-instance
configs, the segment sum's edge ids, the event detection's edge reads in
both its instances (and the fused kernel's detection on the same reads),
and the 1-D lookup's edge indices.  Then the per-read stage engine
under the kernels plan (``cheap_phase_vmap``, the whole-graph chunk,
``map_read``, a body-only sort backend: each kernel once a chunk, never a
plain version, equal to the reference plan), the serving path (the prefix
ladder's shapes, ``ServeDriver``'s kernels plan against its reference
plan) and the tiered index (``Mapper(backend="tiered")`` against the
resident kernels plan, a slot evicted while the chunk that reads it is
still queued, back-to-back page-ins from pinned host tiles).
Tolerance: exact.

Marked ``gpu``; every test decides inside itself whether a card exists and
skips without one:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX package, which a
machine with the card need not have.)
"""
import numpy as np
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


@pytest.mark.parametrize("rows", [1, 513])
@pytest.mark.parametrize("L", [1, 7, 33, 127, 128, 129, 1000, 3072, 4096,
                               8192])
def test_bitonic_sort_kernel_equals_plain_on_edge_rows(L, rows):
    """Rows the register network could get wrong (INT32_MAX and INT32_MIN
    inside, all equal, heavy duplicates, negatives, all pads) at every
    padded width and at row counts that leave a CTA part-filled."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.kernels.bitonic_sort import ops
    from repro_torch.kernels.bitonic_sort.ref import sort_rows_ref
    from repro_torch.kernels.fixtures import edge_rows
    dev = _card()
    keys = torch.from_numpy(edge_rows(np.random.default_rng(L + rows), rows,
                                      L)).to(dev)
    n0 = K.LAUNCHES["bitonic_sort"]
    got = ops.sort_rows(keys)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bitonic_sort"] == n0 + 1
    assert torch.equal(got, sort_rows_ref(keys))


@pytest.mark.parametrize("L", [128, 1000, 3072])
def test_bitonic_sort_kernel_equals_plain_on_unaligned_rows(L):
    """Rows that start 4 bytes past a 16-byte boundary take the key-by-key
    loads: the same answer."""
    import numpy as np
    from repro_torch.kernels.bitonic_sort import ops
    from repro_torch.kernels.bitonic_sort.ref import sort_rows_ref
    from repro_torch.kernels.fixtures import edge_rows
    dev = _card()
    rows = torch.from_numpy(edge_rows(np.random.default_rng(L), 37, L))
    buf = torch.empty(rows.numel() + 1, dtype=torch.int32, device=dev)
    keys = buf[1:].view(37, L)
    keys.copy_(rows)
    assert keys.data_ptr() % 16 == 4
    got = ops.sort_rows(keys)
    torch.cuda.synchronize()
    assert torch.equal(got, sort_rows_ref(keys))


@pytest.mark.parametrize("A", [1, 31, 33, 512])
def test_chain_dp_kernel_equals_plain_on_tie_rows(d5, A):
    """Anchors where several band slots tie for the best candidate with
    different diagonals (the oldest-slot rule decides diag0), the newest
    slot among them or not, anchors exactly max_gap apart, and an
    all-invalid row."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.kernels.chain_dp import ops
    from repro_torch.kernels.chain_dp.ref import chain_dp_ref
    from repro_torch.kernels.fixtures import tie_anchors
    cfg = d5[0]
    dev = d5[2].device
    q, t, v = tie_anchors(np.random.default_rng(A), 64, A,
                          max_gap=cfg.max_gap)
    v[1] = False
    sq, st, sv = (torch.from_numpy(x).to(dev) for x in (q, t, v))
    n0 = K.LAUNCHES["chain_dp"]
    got = ops.chain_dp(sq, st, sv, cfg)
    want = chain_dp_ref(sq, st, sv, cfg)
    torch.cuda.synchronize()
    assert K.LAUNCHES["chain_dp"] == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["D5 rows", "ties", "lane ties"])
@pytest.mark.parametrize("B", [1, 16, 33, 64, 128, 300])
def test_chain_dp_band_kernel_equals_plain(d5, B, case):
    """Any chain_band but 32 launches the band kernel: D5's anchors at full
    width, tie-heavy anchors, and anchors whose tying predecessors lie 32
    apart (slots of one lane once B > 32); B = 128 and 300 keep the band
    in the scratch row."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core import chaining
    from repro_torch.kernels.chain_dp import ops
    from repro_torch.kernels.chain_dp.ref import chain_dp_ref
    from repro_torch.kernels.fixtures import lane_tie_anchors, tie_anchors
    cfg = d5[0].replace(chain_band=B)
    dev = d5[2].device
    A = cfg.max_anchors
    if case == "D5 rows":
        rows = torch.sort(_rows(d5, survivors=False), dim=1).values[:64, :A]
        sq, st, sv = (x.contiguous()
                      for x in chaining.decode_anchor_keys(rows))
    else:
        q, t, v = (tie_anchors(np.random.default_rng(B), 64, A,
                               max_gap=cfg.max_gap) if case == "ties"
                   else lane_tie_anchors(64, A))
        sq, st, sv = (torch.from_numpy(x).to(dev) for x in (q, t, v))
    n0 = K.LAUNCHES["chain_dp"]
    got = ops.chain_dp(sq, st, sv, cfg)
    want = chain_dp_ref(sq, st, sv, cfg)
    torch.cuda.synchronize()
    assert K.LAUNCHES["chain_dp"] == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


# Reads built to break the event detection: all-zero reads (one event),
# levels of alternating sign (more boundaries than E: the E-1 clamp), rows
# of 1000 and 1001 samples (not a multiple of the thread count; rows not
# 16-byte aligned), of 3 samples (under one thread's run) and of 3072
# (three passes of the shipped instance).
DETECT_CASES = ("D5 chunk", "all zero", "alternating levels", "S=1000",
                "S=1001", "S=3", "S=3072")


def _detect_edge_reads(d5, case):
    import numpy as np
    from repro_torch.core import events
    cfg, _, xq = d5
    S = xq.shape[1]
    if case == "all zero":
        return torch.zeros_like(xq[:64])
    if case == "alternating levels":
        rng = np.random.default_rng(2)
        levels = rng.uniform(0.8, 2.0, (64, S // 5 + 1)) * np.where(
            np.arange(S // 5 + 1) % 2, 1.0, -1.0)
        sig = (np.repeat(levels, 5, axis=1)[:, :S]
               + rng.normal(0, .01, (64, S)))
        return events.early_quantize(
            torch.from_numpy(sig.astype(np.float32)).to(xq.device), cfg)
    if case == "S=3072":
        return torch.cat([xq, xq.flip(0), xq.roll(7, 0)], 1).contiguous()
    if case.startswith("S="):
        return xq[:, :int(case[2:])].contiguous()
    return xq


# (the shipped instance on D5's chunk is test_event_detect_kernel_equals_plain)
@pytest.mark.parametrize("instance,case", [
    (i, c) for i in ("shipped", "generic tw=3 peak=2") for c in DETECT_CASES
    if (i, c) != ("shipped", "D5 chunk")])
def test_event_detect_kernel_equals_plain_on_edge_reads(d5, case, instance):
    from repro_torch import kernels as K
    from repro_torch.kernels.event_detect import ops
    from repro_torch.kernels.event_detect.ref import event_detect_rows_ref
    cfg = d5[0]
    if instance != "shipped":
        cfg = cfg.replace(tstat_window=3, peak_window=2)
    xq = _detect_edge_reads(d5, case)
    n0 = K.LAUNCHES["event_detect"]
    got = ops.event_detect_rows(xq, cfg)
    want = event_detect_rows_ref(xq, cfg)
    torch.cuda.synchronize()
    assert K.LAUNCHES["event_detect"] == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "all zero":
        assert (want[1] == 1).all()
    elif case == "alternating levels":
        assert (want[1] == cfg.max_events).all()


@pytest.mark.parametrize("case", DETECT_CASES[1:])
def test_cheap_fused_detection_equals_event_detect_on_edge_reads(d5, case):
    """The fused kernel's detection (the shared detect_fixed.cuh, 256
    threads x 4 samples) on the event detection's edge reads: its outputs
    equal the plain version's, and its event counts those of the
    event_detect kernel."""
    from repro_torch.kernels.cheap_fused import ops
    from repro_torch.kernels.cheap_fused.ref import cheap_fused_rows_ref
    from repro_torch.kernels.event_detect import ops as ed_ops
    cfg, arrays, _ = d5
    xq = _detect_edge_reads(d5, case)
    args = (xq, arrays["bucket_start"], arrays["entries_packed"], cfg)
    got = ops.cheap_fused_rows(*args)
    want = cheap_fused_rows_ref(*args)
    n_ev = ed_ops.event_detect_rows(xq, cfg)[1]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[2][:, 0], n_ev)


# Indices built to break the 1-D lookup: far outside [0, N-1] at Q = 1, 7
# and 196,609 (odd: a query left over after the pairs), and an index view at
# storage offset 1.
LOOKUP_CASES = ("Q=1", "Q=7", "Q=196609", "offset 1")


@pytest.mark.parametrize("case", LOOKUP_CASES)
def test_lookup_kernel_equals_plain_on_edge_indices(d5, case):
    from repro_torch import kernels as K
    from repro_torch.kernels.pluto_lookup import ops
    from repro_torch.kernels.pluto_lookup.ref import lookup_ref
    _, arrays, xq = d5
    table = arrays["bucket_start"]
    g = torch.Generator().manual_seed(len(case))
    if case == "offset 1":
        idx = torch.randint(-1000, table.numel() + 1000, (196_610,),
                            generator=g, dtype=torch.int32).to(xq.device)[1:]
        assert idx.storage_offset() == 1
    else:
        idx = torch.randint(-2**31, 2**31 - 1, (int(case[2:]),), generator=g,
                            dtype=torch.int32).to(xq.device)
    n0 = K.LAUNCHES["pluto_lookup"]
    got = ops.lookup(table, idx)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pluto_lookup"] == n0 + 1
    assert torch.equal(got, lookup_ref(table, idx))


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


# Reads and configs built to break the fused kernel: every hit on one
# diagonal window (the vote histogram's atomics all on two bins), flat
# reads (no boundary: one event), reads whose events fill all E slots, and
# configs that take the generic instance (H = 12 and 3000 vote bins; other
# windows and minimizer winnowing).
CHEAP_CASES = ("one vote bin", "flat reads", "events fill E",
               "generic H=12 bins=3000", "generic tw=3 peak=2 minimizer=2")


@pytest.mark.parametrize("case", CHEAP_CASES)
def test_cheap_fused_kernel_equals_plain_on_edge_reads(d5, case):
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core import events
    from repro_torch.kernels.cheap_fused import ops
    from repro_torch.kernels.cheap_fused.ref import cheap_fused_rows_ref
    cfg, arrays, xq = d5
    bs, ent = arrays["bucket_start"], arrays["entries_packed"]
    if case == "one vote bin":
        # t_pos - e + 2^20 in [256 k, 256 k + 255] for every e < E
        ent = ent.clone()
        ent[1] = 255 + 256 * 20
    elif case == "flat reads":
        xq = torch.zeros_like(xq[:64])
    elif case == "events fill E":
        # levels 5 samples long, of alternating sign: more boundaries
        # than E slots
        rng = np.random.default_rng(2)
        S = cfg.signal_len
        levels = rng.uniform(0.8, 2.0, (64, S // 5 + 1)) * np.where(
            np.arange(S // 5 + 1) % 2, 1.0, -1.0)
        sig = (np.repeat(levels, 5, axis=1)[:, :S]
               + rng.normal(0, .01, (64, S)))
        xq = events.early_quantize(
            torch.from_numpy(sig.astype(np.float32)).to(xq.device), cfg)
    elif case.startswith("generic H"):
        cfg = cfg.replace(max_hits_per_seed=12, vote_bins=3000)
    else:
        cfg = cfg.replace(tstat_window=3, peak_window=2, minimizer_radius=2)
    n0 = K.LAUNCHES["cheap_fused"]
    got = ops.cheap_fused_rows(xq, bs, ent, cfg)
    want = cheap_fused_rows_ref(xq, bs, ent, cfg)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cheap_fused"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w), case
    cnt = want[2]
    if case == "one vote bin":
        assert int(cnt[:, 7].sum()) > 0
    elif case == "flat reads":
        assert (cnt[:, 0] == 1).all()
    elif case == "events fill E":
        assert (cnt[:, 0] == cfg.max_events).all()


# Ids built to break the segment-parallel sum: ids that decrease (the scan
# path), one run longer than the CTA, the clamped tail event, samples past
# valid_len, the rh2 detection (normalized signal, order-sensitive sums)
# and rows of three tiles with one mixed tile.
SEGMENT_CASES = ("shuffled ids", "one run of 1024", "tail run",
                 "valid_len 700", "rh2 detection", "three tiles")


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_sum_kernel_equals_plain_on_edge_ids(d5, case):
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core import events
    from repro_torch.kernels.segment_sum import ops
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref
    cfg, _, xq = d5
    dev = xq.device
    E = cfg.max_events
    x = events.dequantize_fixed(xq, cfg.frac_bits)
    eid = events._event_ids(
        events.boundary_mask_float(x, cfg.with_mode("ms_float")), E)
    R, S = x.shape
    valid_len = S
    rng = np.random.default_rng(len(case))
    if case == "shuffled ids":
        perm = torch.from_numpy(np.argsort(rng.random((R, S)), 1)).to(dev)
        eid = eid.gather(1, perm).contiguous()
    elif case == "one run of 1024":
        x = events.robust_normalize(x)
        eid = torch.zeros_like(eid)
    elif case == "tail run":
        x = events.robust_normalize(x)
        eid = torch.clamp(torch.arange(S, dtype=torch.int32, device=dev) // 2,
                          max=E - 1).expand(R, S).contiguous()
    elif case == "valid_len 700":
        valid_len = 700
    elif case == "rh2 detection":
        x = events.robust_normalize(x)
        eid = events._event_ids(
            events.boundary_mask_float(x, cfg.with_mode("rh2")), E)
    else:
        x = torch.from_numpy((rng.standard_normal((64, 6000)) * 3).astype(
            np.float32)).to(dev)
        e = np.sort(rng.integers(0, 300, (64, 6000)), axis=1)
        e[1] = rng.integers(0, 300, 6000)
        e[2, 2500:2600] = e[2, 2500:2600][::-1]
        eid = torch.from_numpy(e.astype(np.int32)).to(dev)
        E, valid_len = 300, 5990
    n0 = K.LAUNCHES["segment_sum"]
    got = ops.segment_sum(x, eid, E, valid_len)
    want = segment_sum_ref(x, eid, E, valid_len)
    torch.cuda.synchronize()
    assert K.LAUNCHES["segment_sum"] == n0 + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_segment_sum_kernel_refuses_rows_past_2_24():
    """Past 2^24 samples the plain version's in-order f32 count of ones
    stops growing while the kernel's integer count does not: the wrapper
    raises on the card instead of launching."""
    dev = _card()
    from repro_torch.kernels.segment_sum import ops
    n = 1 << 24
    x = torch.zeros((1, n), dtype=torch.float32, device=dev)
    eid = torch.zeros((1, n), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="2\\^24"):
        ops.segment_sum(x, eid, 4, n)
    sums, cnts = ops.segment_sum(x, eid, 4, n - 1)
    torch.cuda.synchronize()
    assert float(cnts[0, 0]) == n - 1


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


# --------------------------------------------------------------------------- #
# The per-read stage engine on the card
# --------------------------------------------------------------------------- #
# the kernels each route launches once, under the kernels plan
PERREAD_CHEAP = {"ms_fixed": ("event_detect", "pluto_lookup",
                              "pluto_lookup_rows"),
                 "ms_float": ("pluto_lookup", "pluto_lookup_rows",
                              "segment_sum"),
                 "rh2": ("pluto_lookup", "pluto_lookup_rows", "segment_sum")}
PERREAD_CHAIN = ("bitonic_sort", "chain_dp")


def _launched_once(expected):
    from repro_torch import kernels as K
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {
        k: 1 for k in expected}, K.LAUNCHES


@pytest.mark.parametrize("mode", ["ms_fixed", "ms_float", "rh2"])
def test_cheap_phase_vmap_kernels_plan_equals_reference_plan(d5, d5_signals,
                                                             mode):
    """The stage bodies' cheap phase under the kernels plan launches its
    kernels once each (never cheap_fused) and equals the reference plan's
    stage bodies and, in ms_fixed, the fused ladder."""
    from repro_torch import kernels as K
    from repro_torch.core import pipeline, stages
    cfg, arrays, _ = d5
    c = cfg.with_mode(mode)
    kern = stages.resolve_plan(c, stages.KERNELS)
    torch.cuda.synchronize()
    K.reset_launches()
    got = pipeline.cheap_phase_vmap(d5_signals, arrays, c, kern)
    torch.cuda.synchronize()
    _launched_once(PERREAD_CHEAP[mode])
    wants = [pipeline.cheap_phase_vmap(d5_signals, arrays, c,
                                       stages.resolve_plan(c,
                                                           stages.REFERENCE)),
             pipeline.cheap_phase(d5_signals, arrays, c, kern)]
    torch.cuda.synchronize()
    for want in wants:
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
        assert set(got[3]) == set(want[3])
        assert all(torch.equal(got[3][k], want[3][k]) for k in want[3])


def _equal_map(got, want):
    for f in ("t_start", "score", "mapped", "n_events"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert set(got.counters) == set(want.counters)
    for k in want.counters:
        assert torch.equal(got.counters[k], want.counters[k]), k


@pytest.mark.parametrize("mode", ["ms_fixed", "ms_float", "rh2"])
def test_whole_graph_map_chunk_kernels_plan_equals_reference_plan(
        d5, d5_signals, mode):
    """``chain_compaction`` off: the whole graph through the stage bodies,
    every kernel of the route once (the sort at 3072 keys a read, the DP
    at 512 anchors), the "graph" route; with four pad rows it equals the
    reference plan's whole graph and the compacted kernels path."""
    from repro_torch import kernels as K
    from repro_torch.core import map_chunk, pipeline
    cfg, arrays, _ = d5
    c = cfg.with_mode(mode).replace(chain_compaction=False)
    n = d5_signals.shape[0]
    torch.cuda.synchronize()
    K.reset_launches()
    pipeline.CHAIN_ROUTES.clear()
    got = map_chunk(d5_signals, arrays, c, use_kernels=True, n_valid=n - 4)
    torch.cuda.synchronize()
    _launched_once(PERREAD_CHEAP[mode] + PERREAD_CHAIN)
    EH = c.max_events * c.max_hits_per_seed
    assert dict(pipeline.CHAIN_ROUTES) == {("graph", n, EH): 1}
    _equal_map(got, map_chunk(d5_signals, arrays, c, use_kernels=False,
                              n_valid=n - 4))
    _equal_map(got, map_chunk(d5_signals, arrays,
                              c.replace(chain_compaction=True),
                              use_kernels=True, n_valid=n - 4))


def test_map_read_kernels_plan_equals_its_chunk_row(d5, d5_signals):
    """``map_read`` under the kernels plan: each read launches the route's
    kernels once and equals the reference plan's map_read and its row of
    the whole-graph chunk."""
    from repro_torch import kernels as K
    from repro_torch.core import map_chunk, map_read, stages
    cfg, arrays, _ = d5
    kern = stages.resolve_plan(cfg, stages.KERNELS)
    chunk = map_chunk(d5_signals, arrays,
                      cfg.replace(chain_compaction=False), use_kernels=True)
    for i in range(4):
        K.reset_launches()
        res, cnt = map_read(d5_signals[i], arrays, cfg, kern)
        torch.cuda.synchronize()
        _launched_once(PERREAD_CHEAP["ms_fixed"] + PERREAD_CHAIN)
        res_r, cnt_r = map_read(d5_signals[i], arrays, cfg)
        for f in res._fields:
            assert torch.equal(getattr(res, f), getattr(res_r, f)), f
        assert all(torch.equal(cnt[k], cnt_r[k]) for k in cnt_r)
        for f in ("t_start", "score", "mapped"):
            assert torch.equal(getattr(res, f), getattr(chunk, f)[i]), f


def test_stage_bodies_never_take_the_plain_versions_on_the_card(
        d5, d5_signals, monkeypatch):
    """Every kernel body of the whole graph, on CUDA tensors, launches its
    kernel: with each wrapper's plain version replaced by one that raises,
    the graph still runs (and launches each kernel once)."""
    from repro_torch import kernels as K
    from repro_torch.core import stages
    from repro_torch.kernels.bitonic_sort import ops as sort_ops
    from repro_torch.kernels.chain_dp import ops as dp_ops
    from repro_torch.kernels.event_detect import ops as ed_ops
    from repro_torch.kernels.pluto_lookup import ops as pl_ops

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")
    for mod, name in ((sort_ops, "sort_rows_ref"), (dp_ops, "chain_dp_ref"),
                      (ed_ops, "event_detect_rows_ref"),
                      (pl_ops, "lookup_ref")):
        monkeypatch.setattr(mod, name, refuse)
    cfg, arrays, _ = d5
    K.reset_launches()
    res, counters = stages.execute_reads(
        d5_signals, arrays, cfg, stages.resolve_plan(cfg, stages.KERNELS))
    torch.cuda.synchronize()
    _launched_once(PERREAD_CHEAP["ms_fixed"] + PERREAD_CHAIN)
    assert res.t_start.shape == (d5_signals.shape[0],)


def test_state_dict_only_sort_backend_launches_the_sort_kernel(d5,
                                                               d5_signals):
    """A sort backend with a body and no primitive sends ``map_chunk`` down
    the whole graph (compaction on); its body's sorter, the kernel,
    launches once, and the chunk equals the reference plan's."""
    from repro_torch import kernels as K
    from repro_torch.core import map_chunk, pipeline, stages
    from repro_torch.kernels.bitonic_sort.ops import sort_rows
    cfg, arrays, _ = d5
    stages.register_backend(
        "sort", "body_only",
        lambda st, c, index: stages.sort_with(st, c, index,
                                              sorter=sort_rows))
    try:
        plan = tuple((s, "body_only" if s == "sort" else b)
                     for s, b in stages.resolve_plan(cfg, stages.KERNELS))
        K.reset_launches()
        pipeline.CHAIN_ROUTES.clear()
        got = map_chunk(d5_signals, arrays, cfg, plan=plan)
        torch.cuda.synchronize()
        assert [b for b, _, _ in pipeline.CHAIN_ROUTES] == ["graph"]
        _launched_once(PERREAD_CHEAP["ms_fixed"] + PERREAD_CHAIN)
        _equal_map(got, map_chunk(d5_signals, arrays, cfg,
                                  use_kernels=False))
    finally:
        del stages._REGISTRY[("sort", "body_only")]


# --------------------------------------------------------------------------- #
# The serving path: the prefix ladder's shapes and the driver on the card
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def d1_serving():
    """D1's index in both fixed and float modes and 96 of its reads."""
    dev = _card()
    from repro_torch.core import build_index
    from repro_torch.signal import datasets, simulate
    spec = datasets.DATASETS["D1"]
    cfg = datasets.config_for(spec)
    ref = simulate.make_reference(spec.genome_len, seed=spec.seed)
    reads = simulate.sample_reads(ref, 96, signal_len=cfg.signal_len,
                                  seed=spec.seed + 1, junk_frac=0.08)
    index = {m: build_index(ref.events_concat, ref.n_events,
                            cfg.with_mode(m)) for m in ("ms_fixed",
                                                        "ms_float")}
    return dev, cfg, reads, index


@pytest.mark.parametrize("mode", ["ms_fixed", "ms_float"])
@pytest.mark.parametrize("L", [256, 512, 768, 1024])
def test_map_chunk_kernels_equal_plain_at_serving_shapes(d1_serving, L,
                                                         mode):
    """One chunk of 32 reads cut to each ladder prefix (``stage_cfg``):
    the kernels plan equals the reference plan, field by field and counter
    by counter, and the fused cheap kernel and event_detect equal their
    plain versions at those shapes."""
    from repro_torch.core import events, map_chunk
    from repro_torch.core.index import index_arrays
    from repro_torch.core.realtime import stage_cfg
    from repro_torch.kernels.cheap_fused import ops as cf_ops
    from repro_torch.kernels.cheap_fused.ref import cheap_fused_rows_ref
    from repro_torch.kernels.event_detect import ops as ed_ops
    from repro_torch.kernels.event_detect.ref import event_detect_rows_ref
    dev, cfg, reads, index = d1_serving
    c = stage_cfg(cfg.with_mode(mode), L)
    arrays = index_arrays(index[mode], dev)
    sig = torch.from_numpy(reads.signals[:32, :L].copy()).to(dev)
    got = map_chunk(sig, arrays, c, use_kernels=True, n_valid=30)
    want = map_chunk(sig, arrays, c, use_kernels=False, n_valid=30)
    for f in ("t_start", "score", "mapped", "n_events"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert all(torch.equal(got.counters[k], want.counters[k])
               for k in want.counters)
    if mode == "ms_fixed":
        xq = events.early_quantize(sig, c)
        args = (xq, arrays["bucket_start"], arrays["entries_packed"], c)
        for g, w in zip(cf_ops.cheap_fused_rows(*args),
                        cheap_fused_rows_ref(*args)):
            assert torch.equal(g, w)
        for g, w in zip(ed_ops.event_detect_rows(xq, c),
                        event_detect_rows_ref(xq, c)):
            assert torch.equal(g, w)


def _serve_state(sd) -> str:
    import dataclasses
    import json
    return json.dumps(dict(
        streams={k: dataclasses.asdict(v) for k, v in sd._streams.items()},
        classes={str(k): dataclasses.asdict(v)
                 for k, v in sd.class_report().items()},
        tenants={str(k): dataclasses.asdict(v)
                 for k, v in sd.tenant_report().items()},
        report={k: dataclasses.asdict(v) for k, v in sd.report().items()},
        events=sd.events, clock=sd.clock, counters=sd.counters,
        n_chunks=sd.n_chunks, n_pad_rows=sd.n_pad_rows), sort_keys=True)


@pytest.mark.parametrize("mode,shed", [("ms_fixed", False),
                                       ("ms_fixed", True),
                                       ("ms_float", False)])
def test_serving_kernels_plan_equals_reference_plan(d1_serving, mode, shed):
    """``ServeDriver`` with the early-termination ladder (and with shedding
    under SLO classes and tenant budgets) over the kernels plan gives the
    reference plan's run on the card: every stream state and report, the
    class and tenant reports, the event trace, the virtual clock and the
    counters.  The kernels plan launches its path's kernels and no
    other."""
    from repro_torch import kernels as K
    from repro_torch.core import Mapper, ServeDriver, TenantBudget
    from repro_torch.launch import serve_rsga
    dev, cfg, reads, index = d1_serving
    c = cfg.with_mode(mode)
    kw = dict(chunk=32, early_term=True)
    slos, tenants = None, 0
    if shed:
        tenants = 4
        slos = [k.name for k in serve_rsga.SHED_CLASSES]
        kw.update(shed=True, shed_window=2.0,
                  slo_classes=serve_rsga.SHED_CLASSES,
                  tenant_budgets=tuple(TenantBudget(f"t{i}", rate=8.0)
                                       for i in range(tenants)))
    trace = serve_rsga.build_trace(reads.signals, 4, 24,
                                   arrival_rate=(1.3 if shed else 0.7) * 32,
                                   slos=slos, tenants=tenants,
                                   skew=1.0 if shed else 0.0)
    K.reset_launches()
    got = ServeDriver(Mapper(index[mode], c, use_kernels=True, device=dev),
                      **kw)
    got.serve_trace(trace)
    launched = {k for k, v in K.LAUNCHES.items() if v}
    want = ServeDriver(Mapper(index[mode], c, device=dev), **kw)
    want.serve_trace(trace)
    assert _serve_state(got) == _serve_state(want)
    path = ({"cheap_fused", "bitonic_sort", "chain_dp"} if mode == "ms_fixed"
            else {"pluto_lookup", "pluto_lookup_rows", "segment_sum",
                  "bitonic_sort", "chain_dp"})
    assert launched == path
    assert got.n_chunks > len(trace) // 32
    if shed:
        assert got.n_shed > 0


# --------------------------------------------------------------------------- #
# The tiered index: host tiles paged into device slots
# --------------------------------------------------------------------------- #
def _tiered_chunks(m, sig, chunk):
    """``Mapper.map_signals``'s stream (prefetching the next chunk's tiles),
    chunk by chunk."""
    from repro_torch.core import driver
    return list(driver.stream_map(
        m.chunk_fn(), driver.array_chunks(sig, chunk),
        prefetch=lambda s, nv: m.cache.prefetch(s, m.cfg, m.plan)))


@pytest.mark.parametrize("slots", [4, 16])
def test_tiered_mapper_equals_resident_kernels_plan(d1_serving, slots):
    """D1 through 16 host tiles and 4 or 16 device slots (4: every chunk
    takes the transient wide view) gives the resident index's kernels
    plan, chunk by chunk: every output field and counter.  The tiered
    plan launches no hand-written kernel; the host tiles are pinned."""
    from repro_torch import kernels as K
    from repro_torch.core import Mapper, driver
    dev, cfg, reads, index = d1_serving
    cfg = cfg.with_mode("ms_fixed")
    sig = reads.signals
    want = list(driver.stream_map(
        Mapper(index["ms_fixed"], cfg, use_kernels=True,
               device=dev).chunk_fn(), driver.array_chunks(sig, 32)))
    m = Mapper(index["ms_fixed"], cfg, backend="tiered", tiles=16,
               cache_slots=slots, device=dev)
    assert m.cache._host_ent.is_pinned() and m.cache._host_bstart.is_pinned()
    K.reset_launches()
    got = _tiered_chunks(m, sig, 32)
    torch.cuda.synchronize()
    assert not any(K.LAUNCHES.values()), K.LAUNCHES
    assert len(got) == len(want) == 3
    for (gc, gn, g), (wc, wn, w) in zip(got, want):
        assert (gc, gn) == (wc, wn)
        for f in ("t_start", "score", "mapped", "n_events"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.counters == w.counters
    assert m.cache.n_chunks == 3 and m.cache.misses >= 1
    assert m.cache.paged_bytes == m.cache.misses * m.cache.tiered.tile_nbytes


def test_tiered_slot_evicted_while_its_chunk_is_queued(d1_serving):
    """A page-in overwrites persistent slots in place, on the current
    stream: a chunk's query enqueued before the overwrite (held behind a
    sleep kernel, so it has not run yet) still reads the slots' old
    planes.  The cheap phase over the view equals the same call made
    before any overwrite, and the resident index's at every hit."""
    from repro_torch.core import Mapper, pipeline, stages
    from repro_torch.core.index import index_arrays
    dev, cfg, reads, index = d1_serving
    cfg = cfg.with_mode("ms_fixed")
    m = Mapper(index["ms_fixed"], cfg, backend="tiered", tiles=16,
               cache_slots=16, device=dev)
    sig = reads.signals[:32]
    view = m.cache.prepare(sig, cfg, m.plan)
    want = pipeline.cheap_phase(None, view, cfg, m.plan)  # pre-pass keys
    res = pipeline.cheap_phase(torch.from_numpy(sig).to(dev),
                               index_arrays(index["ms_fixed"], dev), cfg,
                               stages.resolve_plan(cfg, stages.REFERENCE))
    torch.cuda.synchronize()
    resident = [int(t) for t in m.cache._slot_tile if t >= 0]
    assert len(resident) >= 2
    torch.cuda._sleep(1_000_000_000)      # ~0.5 s: hold the stream
    got = pipeline.cheap_phase(None, view, cfg, m.plan)
    # rotate every resident tile into another tile's slot while the query
    # above still waits behind the sleep
    slots = [s for s, t in enumerate(m.cache._slot_tile) if t >= 0]
    for s, t in zip(slots, resident[1:] + resident[:1]):
        m.cache._load_slot(s, t)
    assert torch.cuda.current_stream().query() is False
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert all(torch.equal(got[3][k], want[3][k]) for k in want[3])
    hit = res[2]
    assert torch.equal(got[2], hit) and bool(hit.any())
    assert torch.equal(got[1][hit], res[1][hit])
    assert all(torch.equal(got[3][k], res[3][k]) for k in res[3])


def test_tiered_pages_from_pinned_memory_twice_in_a_row(d1_serving):
    """Two asynchronous page-ins into one slot back to back, and two wide
    views built back to back, each from pinned host tiles: every device
    plane ends up with its own tile's bytes."""
    from repro_torch.core import Mapper
    dev, cfg, _, index = d1_serving
    m = Mapper(index["ms_fixed"], cfg.with_mode("ms_fixed"),
               backend="tiered", tiles=16, cache_slots=1, device=dev)
    c, ti = m.cache, m.cache.tiered
    c._load_slot(0, 3)
    c._load_slot(0, 7)
    hist = np.ones(16, np.int64)
    v1 = c._overflow_view(np.arange(8), hist)
    v2 = c._overflow_view(np.arange(8, 16), hist)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(c._dev_bstart[0].cpu().numpy(),
                                  ti.tile_bucket_start[7])
    np.testing.assert_array_equal(c._dev_ent[:, 0].cpu().numpy(),
                                  ti.tile_entries_packed[7])
    for v, tiles in ((v1, range(8)), (v2, range(8, 16))):
        for i, t in enumerate(tiles):
            np.testing.assert_array_equal(
                v["t_bucket_start"][i].cpu().numpy(),
                ti.tile_bucket_start[t])
            np.testing.assert_array_equal(
                v["t_entries_packed"][:, i].cpu().numpy(),
                ti.tile_entries_packed[t])


# --------------------------------------------------------------------------- #
# Rows past one sort block, and the sharded mapper on the card
# --------------------------------------------------------------------------- #
def test_sort_rows_past_one_block_take_the_counted_library_route():
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.kernels.bitonic_sort import ops
    from repro_torch.kernels.bitonic_sort.ref import sort_rows_ref
    from repro_torch.kernels.fixtures import edge_rows
    dev = _card()
    keys = torch.from_numpy(edge_rows(np.random.default_rng(3), 33,
                                      16384)).to(dev)
    K.reset_launches()
    got = ops.sort_rows(keys)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sort_rows_library"] == 1
    assert K.LAUNCHES["bitonic_sort"] == 0
    assert torch.equal(got, sort_rows_ref(keys))


def _sharded_kernels_rank(index, cfg, signals):
    """A rank of a (1, 2) gloo mesh on the card: the kernels plan over
    ``signals`` in chunks of 64, with its launches."""
    from repro_torch import kernels as K
    from repro_torch.core import Mapper
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 2), ("data", "model"), backend="gloo")
    fn = Mapper(index, cfg, use_kernels=True, mesh=mesh).chunk_fn()
    K.reset_launches()
    outs = []
    for i in range(0, len(signals), 64):
        o = fn(signals[i:i + 64], 64)
        outs.append(({f: getattr(o, f).cpu().numpy()
                      for f in ("t_start", "score", "mapped", "n_events")},
                     {k: int(v) for k, v in o.counters.items()}))
    return dict(outs=outs, launches=dict(K.LAUNCHES),
                device=str(mesh.device), backend=mesh.backend,
                staged=mesh.stats["staged_bytes"])


def test_two_gloo_ranks_on_the_card_equal_the_single_device(d1_serving):
    """Two ranks sharing the card through gloo (host-staged collectives):
    every chunk of the kernels plan equals the single-device kernels plan,
    and each rank launched the fused path's kernels."""
    from repro_torch.core import Mapper
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_ranks
    dev, cfg, reads, index = d1_serving
    cfg = cfg.with_mode("ms_fixed")
    build.build()                      # the ranks only load the library
    sig = reads.signals[:96]
    fn = Mapper(index["ms_fixed"], cfg, use_kernels=True,
                device=dev).chunk_fn()
    want = []
    for i in range(0, len(sig), 64):
        o = fn(sig[i:i + 64], 64)
        want.append(({f: getattr(o, f).cpu().numpy()
                       for f in ("t_start", "score", "mapped",
                                 "n_events")},
                      {k: int(v) for k, v in o.counters.items()}))
    ranks = run_ranks(_sharded_kernels_rank, 2, index["ms_fixed"], cfg, sig,
                      timeout=300)
    for r in ranks:
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert r["staged"] > 0
        assert all(r["launches"][k] > 0
                   for k in ("cheap_fused", "bitonic_sort", "chain_dp"))
        for (g, gc), (w, wc) in zip(r["outs"], want):
            assert gc == wc
            for f in w:
                np.testing.assert_array_equal(g[f], w[f])


# ---- the paper's evaluation on the card ------------------------------------
PAPER_KEYS = ("counters", "accuracy", "index_bytes", "bench_bytes_raw",
              "n_reads")


@pytest.mark.parametrize("ds,mode,path", [
    ("D3", "ms_float", ("pluto_lookup", "pluto_lookup_rows", "segment_sum",
                        "bitonic_sort", "chain_dp")),
    ("D4", "ms_fixed", ("cheap_fused", "bitonic_sort", "chain_dp"))])
def test_paper_record_kernels_plan_equals_jax_golden(ds, mode, path,
                                                     tmp_path, monkeypatch):
    """``pipeline_run`` under the kernels plan on the card gives the JAX
    package's record (``jax_records.json``) and launches its path's
    kernels, and no other."""
    import json
    import pathlib
    from repro_torch import kernels as K
    from repro_torch.benchmarks import common
    dev = _card()
    golden = json.loads((pathlib.Path(common.__file__).parent
                         / "jax_records.json").read_text())
    monkeypatch.setattr(common, "CACHE", tmp_path)
    K.reset_launches()
    rec = common.pipeline_run(ds, mode, backend="kernels", device=dev)
    launches = dict(K.LAUNCHES)
    K.reset_launches()
    want = golden["records"][f"{ds}/{mode}"]
    for k in PAPER_KEYS:
        assert rec[k] == want[k], k
    assert rec["device"] == "cuda:0"
    assert (tmp_path / "cuda" / f"{ds}_{mode}_kernels.json").exists()
    assert {k for k, v in launches.items() if v} == set(path), launches


def test_filter_ablation_without_filters_kernels_equal_reference_plan():
    """The ablation's "none" variant (no frequency filter, no vote filter,
    float detection with late quantization) at the example's size: the
    kernels plan equals the reference plan on the card."""
    from repro_torch import kernels as K
    from repro_torch.examples import filter_ablation
    dev = _card()
    name = "none (raw RawHash-like)"
    ref, reads = filter_ablation.inputs()
    K.reset_launches()
    _, got = filter_ablation.map_variant(name, ref, reads, "kernels", dev)
    assert K.LAUNCHES["bitonic_sort"] > 0 and K.LAUNCHES["chain_dp"] > 0
    K.reset_launches()
    _, want = filter_ablation.map_variant(name, ref, reads, "reference", dev)
    assert not any(K.LAUNCHES.values())
    assert got == want
