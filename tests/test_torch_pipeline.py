"""The PyTorch port end to end against the JAX package: ``map_chunk`` (every
MapOutput field, every CHUNK_COUNTER_SCHEMA counter), ``Mapper`` over
several chunks, the ``map_reads`` launcher's accuracy line and PAF, and
resume through ``ProgressLog``.  Tolerance: exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp                                       # noqa: E402

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import Mapper as JaxMapper                    # noqa: E402
from repro.core import build_index as jax_build_index         # noqa: E402
from repro.core import driver as jdriver                      # noqa: E402
from repro.core import pipeline as jpipe                      # noqa: E402
from repro.core import score_accuracy as jax_score_accuracy   # noqa: E402
from repro.core.index import index_arrays as jax_index_arrays  # noqa: E402
from repro.launch import map_reads as jax_map_reads           # noqa: E402
from repro.signal import simulate                             # noqa: E402
from repro_torch.core import (MarsConfig, Mapper, driver,     # noqa: E402
                              map_chunk, score_accuracy, stages)
from repro_torch.core.index import index_arrays, index_from_numpy  # noqa: E402
from repro_torch.launch import map_reads                      # noqa: E402

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")
FIELDS = ("t_start", "score", "mapped", "n_events")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def s():
    cfg_j = JaxConfig(hash_bits=12).with_mode("ms_fixed")
    cfg_t = MarsConfig(hash_bits=12).with_mode("ms_fixed")
    ref = simulate.make_reference(6_000, seed=9)
    reads = simulate.sample_reads(ref, 10, signal_len=cfg_t.signal_len,
                                  seed=10, junk_frac=0.2)
    jidx = jax_build_index(ref.events_concat, ref.n_events, cfg_j)
    tidx = index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                            jidx.n_ref_events, cfg_t)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, ref=ref, reads=reads, jidx=jidx,
                tidx=tidx)


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_map_chunk_equals_jax(s, use_kernels):
    """Pad rows (n_valid < R) are masked out of ``mapped`` and counters."""
    sig = s["reads"].signals[:6]
    want = jpipe.map_chunk(jnp.asarray(sig), jax_index_arrays(s["jidx"]),
                           s["cfg_j"], use_kernels=False, n_valid=4)
    got = map_chunk(torch.from_numpy(sig), index_arrays(s["tidx"], "cpu"),
                    s["cfg_t"], use_kernels=use_kernels, n_valid=4)
    for f in FIELDS:
        _eq(getattr(got, f), getattr(want, f), f)
    assert set(got.counters) == set(want.counters) == set(
        stages.CHUNK_COUNTER_SCHEMA)
    for k in stages.CHUNK_COUNTER_SCHEMA:
        assert got.counters[k].dtype == torch.int32
        assert int(got.counters[k]) == int(want.counters[k]), k
    assert bool(np.asarray(want.mapped).any())


def test_map_chunk_without_compaction(s):
    cfg_j = s["cfg_j"].replace(chain_compaction=False)
    cfg_t = s["cfg_t"].replace(chain_compaction=False)
    sig = s["reads"].signals[:4]
    want = jpipe.map_chunk(jnp.asarray(sig), jax_index_arrays(s["jidx"]),
                           cfg_j)
    got = map_chunk(torch.from_numpy(sig), index_arrays(s["tidx"], "cpu"),
                    cfg_t, use_kernels=True)
    for f in FIELDS:
        _eq(getattr(got, f), getattr(want, f), f)
    for k in want.counters:
        assert int(got.counters[k]) == int(want.counters[k]), k


def test_mapper_map_signals_several_chunks(s):
    sig = s["reads"].signals
    want = JaxMapper(s["jidx"], s["cfg_j"]).map_signals(sig, chunk=4)
    got = Mapper(s["tidx"], s["cfg_t"], use_kernels=True,
                 device="cpu").map_signals(sig, chunk=4)
    for f in FIELDS:
        _eq(getattr(got, f), getattr(want, f), f)
    assert got.counters == {k: int(v) for k, v in want.counters.items()}
    r = s["reads"]
    args = (r.true_pos, r.true_strand, r.mappable, r.n_bases,
            s["ref"].n_events)
    assert score_accuracy(got, *args) == jax_score_accuracy(want, *args)


def test_mapper_with_cfg(s):
    m = Mapper(s["tidx"], s["cfg_t"], use_kernels=True, device="cpu")
    m2 = m.with_cfg(s["cfg_t"].replace(thresh_voting=2))
    assert m2.arrays is m.arrays and m2.cfg.thresh_voting == 2
    with pytest.raises(ValueError, match="hash_bits"):
        m.with_cfg(s["cfg_t"].replace(hash_bits=13))


def test_collect_empty_stream_has_schema():
    out = driver.collect(iter(()))
    assert out.counters == {k: 0 for k in stages.CHUNK_COUNTER_SCHEMA}
    assert out.t_start.shape == (0,)


def _launch(main, tmp_path, tag, capsys, extra=()):
    wd = tmp_path / tag
    paf = tmp_path / f"{tag}.paf"
    main(["--dataset", "D1", "--reads", "64", "--workdir", str(wd),
          "--out", str(paf), *extra])
    lines = capsys.readouterr().out.splitlines()
    return lines, paf.read_text()


def test_map_reads_launcher_matches_jax(tmp_path, capsys):
    want_lines, want_paf = _launch(jax_map_reads.main, tmp_path, "jax",
                                   capsys)
    got_lines, got_paf = _launch(map_reads.main, tmp_path, "torch", capsys,
                                 ("--use-kernels", "--device", "cpu"))
    acc = [ln for ln in got_lines if ln.startswith("[accuracy]")]
    assert acc and acc == [ln for ln in want_lines
                           if ln.startswith("[accuracy]")]
    assert got_paf and got_paf == want_paf


def test_map_reads_resume(tmp_path, capsys, monkeypatch):
    """A job killed after its first chunk resumes at chunk 1 and writes the
    same PAF as an uninterrupted run."""
    args = ("--chunk", "16", "--use-kernels", "--device", "cpu")
    _, clean_paf = _launch(map_reads.main, tmp_path, "clean", capsys, args)

    real = driver.stream_map

    def killed_after_first(*a, **kw):
        for i, item in enumerate(real(*a, **kw)):
            if i == 1:
                raise KeyboardInterrupt("killed")
            yield item
    monkeypatch.setattr(driver, "stream_map", killed_after_first)
    with pytest.raises(KeyboardInterrupt):
        _launch(map_reads.main, tmp_path, "resumed", capsys, args)
    monkeypatch.setattr(driver, "stream_map", real)
    lines, paf = _launch(map_reads.main, tmp_path, "resumed", capsys, args)
    assert "[resume] continuing at chunk 1" in lines
    assert paf == clean_paf


def test_progress_log_replay_matches_jax(tmp_path):
    """Both ProgressLogs replay the same file — a compacted base line, an
    appended chunk and a torn tail — to the same (next chunk, rows)."""
    for cls, tag in ((jdriver.ProgressLog, "jax"), (driver.ProgressLog,
                                                    "torch")):
        log = cls(tmp_path / f"{tag}.jsonl", compact_every=2)
        log.append(1, [(5, 1.5, True)])
        log.append(2, [(7, 2.5, False)])              # compacts
        log.append(3, [(9, 3.5, True)])
        with open(log.path, "a") as f:
            f.write('{"next": 4, "rows": [[1, 2')      # torn tail
    want = jdriver.ProgressLog(tmp_path / "jax.jsonl").load()
    got = driver.ProgressLog(tmp_path / "torch.jsonl").load()
    assert got == want and got[0] == 3
    assert ((tmp_path / "torch.jsonl").read_bytes()
            == (tmp_path / "jax.jsonl").read_bytes())
