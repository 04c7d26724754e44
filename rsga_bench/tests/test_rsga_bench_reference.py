"""The frozen reference against the port's plain path on a few reads, on
the CPU, in both configurations' arithmetic; and its index against the
port's."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from rsga_bench import datagen, manifest, run
from rsga_bench.reference import mars


@pytest.fixture(scope="module")
def data():
    genome = datagen.make_genome(40_000, 2 ** 31 + 3)
    return genome, datagen.make_pool(genome, 48, 1024, 2 ** 31 + 3)


@pytest.mark.parametrize("config", ["d5_human_ms_fixed", "d5_human_rh2"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_reference_equals_the_port(data, config, use_kernels):
    from repro_torch.core import Mapper, build_index
    genome, pool = data
    m = manifest.load()
    entry = next(c for c in m["configs"] if c["name"] == config)
    cfg = run.mars_config(json.loads((manifest.ROOT / entry["file"])
                                     .read_text()))
    idx = build_index(genome.events_concat, genome.n_events, cfg)
    out = Mapper(idx, cfg, use_kernels=use_kernels,
                 device="cpu").map_signals(pool, chunk=16)
    p = mars.Params.from_config(dataclasses.asdict(cfg))
    ri = mars.build_index(genome.events_concat, genome.n_events, p)
    for k in ("bucket_start", "entries_key", "entries_pos", "entries_cnt"):
        port = np.asarray(getattr(idx, k)).view(np.int32)
        assert np.array_equal(ri[k], port), k
    r = mars.map_reads(torch.from_numpy(pool), mars.index_tensors(ri, "cpu"),
                       p)
    assert np.array_equal(out.t_start, r.t_start.numpy())
    assert np.array_equal(out.score.view(np.int32),
                          r.score.view(torch.int32).numpy())
    assert np.array_equal(out.mapped, r.mapped.numpy())
    assert np.array_equal(out.n_events, r.n_events.numpy())
    for k in mars.COUNTERS:
        assert out.counters[k] == int(r.counters[k].sum()), k
    assert out.mapped.mean() > 0.5            # the reads do map


def test_the_pool_repeats_from_its_seed():
    g = datagen.make_genome(20_000, 11)
    a = datagen.make_pool(g, 16, 256, 11)
    b = datagen.make_pool(datagen.make_genome(20_000, 11), 16, 256, 11)
    c = datagen.make_pool(g, 16, 256, 12)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(datagen.make_genome(20_000, 2 ** 33).events_fwd,
                          datagen.make_genome(20_000, 2 ** 33).events_fwd)
