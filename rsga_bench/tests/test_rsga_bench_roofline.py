"""Each roofline count against a count worked by hand at a small shape, and
the readers that turn counts and device time into a share."""
import json

import pytest
import torch

from rsga_bench import check, manifest, run

CFG = json.loads((manifest.BENCH / "configs" / "d5_human_ms_fixed.json")
                 .read_text())["mars_config"]


def test_dp_pairs_by_hand():
    # anchor i weighs min(i, band) predecessors: 0, 0, 0+1+2+3+4 = 10, and
    # for 40 anchors at band 32: 0+1+..+32 = 528, then 7 more of 32 = 224
    n = torch.tensor([0, 1, 5, 33, 40])
    assert check._dp_pairs(n, 32).tolist() == [0, 0, 10, 528, 752]


def test_chain_dp_count_by_hand():
    count = manifest.roofline_count("chain_dp")
    # int32: 752 pairs x 8 + 40 anchors x 3; float32: 752 x 7 + 40 x 3;
    # 40 anchors x 16 bytes
    assert count(dict(dp_pairs=752, dp_anchors=40), CFG) == (6136, 5384,
                                                              640)


@pytest.mark.parametrize("w,r,seed_w", [(4, 3, 7), (6, 2, 5)])
def test_cheap_fused_count_by_hand(w, r, seed_w):
    count = manifest.roofline_count("cheap_fused")
    work = dict(reads=1, samples=1024, events=100, valid_seeds=94,
                probes=50, bucket_words=60, entries=40, anchors=30)
    cfg = dict(CFG, tstat_window=w, peak_window=r, seed_width=seed_w)
    # int32: 1024 x (4 w + 12) + 100 x (2 seed_w + 16) + 94 x 24 + 50 x 12
    # float32: 1024 x (4 + 4 r)
    # bytes: 1024 x 4 + 60 x 4 + 40 x 8 + 30 x 4 + 1 x 36
    want = {(4, 3, 7): (28672 + 3000 + 2256 + 600, 16384, 4812),
            (6, 2, 5): (36864 + 2600 + 2256 + 600, 12288, 4812)}
    assert count(work, cfg) == want[(w, r, seed_w)]


def test_chunk_work_sums_the_window_blocks_and_refuses_others():
    ans = check.Answers(*(None,) * 5, work=[dict(reads=2, dp_pairs=3),
                                            dict(reads=2, dp_pairs=5)])
    ans = ans._replace(t_start=torch.zeros(4).numpy())
    rec = dict(chunks=[dict(g=0, n=2), dict(g=2, n=2), dict(g=4, n=2)])
    assert check.chunk_work(rec, ans, 2) == dict(reads=6, dp_pairs=11)
    assert check.chunk_work(dict(chunks=[dict(g=1, n=2)]), ans, 2) is None
    assert check.chunk_work(dict(chunks=[dict(g=2, n=1)]), ans, 2) is None


PEAKS = dict(int32_ops_per_s=1e12, fp32_ops_per_s=2e12,
             issue_ops_per_s=2e12, hbm_bytes_per_s=1e11)


def _ctx(by_name, work, peaks=PEAKS, trace=True):
    red = dict(by_name=by_name) if trace else None
    return dict(roofline=lambda k: run.trace_share(
        red, k, peaks, lambda: work, manifest.roofline_count(k), CFG))


@pytest.mark.parametrize("kernel", ["chain_dp", "cheap_fused"])
def test_roofline_share_and_silence(kernel):
    read = manifest.reader(f"{kernel}_roofline")
    work = dict(dp_pairs=10 ** 6, dp_anchors=10 ** 4, reads=10, samples=10240,
                events=1000, valid_seeds=900, probes=500, bucket_words=600,
                entries=400, anchors=300)
    i, f, nbytes = manifest.roofline_count(kernel)(work, CFG)
    least = max(i / 1e12, f / 2e12, (i + f) / 2e12, nbytes / 1e11)
    by_name = {f"void {kernel}_kernel<4>(int*)": (3, 2 * least)}
    assert read(_ctx(by_name, work)) == pytest.approx(50.0)
    # no kernel of that name in the trace, no trace, no peaks, no work:
    # nothing
    assert read(_ctx({"other": (1, 1.0)}, work)) is None
    assert read(_ctx(by_name, work, trace=False)) is None
    assert read(_ctx(by_name, work, peaks=None)) is None
    assert read(_ctx(by_name, None)) is None


def test_the_least_time_takes_the_slowest_pipe():
    count = lambda work, cfg: work            # noqa: E731
    red = dict(by_name={"k": (1, 1.0)})

    def share(i, f, b):
        return run.trace_share(red, "k", PEAKS, lambda: (i, f, b), count,
                               CFG)
    assert share(0.5e12, 0, 0) == pytest.approx(50.0)     # int32 pipe
    assert share(0, 1e12, 0) == pytest.approx(50.0)       # float32 pipe
    assert share(0.4e12, 0.8e12, 0) == pytest.approx(60.0)  # issue
    assert share(0, 0, 0.5e11) == pytest.approx(50.0)     # HBM
