"""Each CUDA kernel against its plain PyTorch version on the card, at the
mapping path's shapes (D5 index, 512 reads of 1024 samples).  At full width
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


def test_kernels_plan_never_runs_the_plain_cheap_phase_on_the_card(d5):
    """On the card, a config outside the fused kernel's gate or
    ``use_fused=False`` raises under the kernels plan (the per-stage
    kernels are not ported) and runs under the reference plan."""
    from repro_torch.core import pipeline, stages
    cfg, arrays, xq = d5
    sig = torch.zeros((2, cfg.signal_len), device=xq.device)
    kern = stages.resolve_plan(cfg, stages.KERNELS)
    with pytest.raises(NotImplementedError, match="use_fused=False"):
        pipeline.cheap_phase(sig, arrays, cfg, kern, use_fused=False)
    wide = cfg.replace(tstat_window=13)
    with pytest.raises(NotImplementedError, match="cheap_fused"):
        pipeline.cheap_phase(sig, arrays, wide,
                             stages.resolve_plan(wide, stages.KERNELS))
    out = pipeline.cheap_phase(sig, arrays, cfg,
                               stages.resolve_plan(cfg, stages.REFERENCE),
                               use_fused=False)
    assert out[1].shape == (2, cfg.max_events, cfg.max_hits_per_seed)
