"""Every read of ``chip_smoke.py``'s six ``[map]`` cells: D1 and D5 in
``rh2``, ``ms_float`` and ``ms_fixed``, 4096 reads (``junk_frac`` 0.08) in
chunks of 512, as ``chip_smoke.make_dataset`` builds them (the index under
the ``ms_fixed`` config, the mode applied to the mapper's config).  The
JAX package's streamed outputs are committed as
``src/repro_torch/benchmarks/jax_map_digest.json`` (``common.map_digest``:
a SHA-256 of each per-read field, one a chunk, and the summed counters),
so the card, whose host has no JAX, holds all 4096 reads of each cell.

``test_golden_cell_equals_a_fresh_jax_run`` regenerates the D1
``ms_fixed`` entry from the JAX package and requires equality;
``test_port_cell_equals_golden`` maps the same cell through the port on
the CPU.  Tolerance: exact.

Regenerate the whole file after a deliberate change of the JAX package:

    PYTHONPATH=src python tests/test_torch_map_digest.py
"""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import common  # noqa: E402

READS, CHUNK = 4096, 512
DATASETS = ("D1", "D5")
MODES = ("rh2", "ms_float", "ms_fixed")
CELL = ("D1", "ms_fixed")     # the cell the CPU tests map


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_inputs(datasets, simulate, build_index, key):
    """chip_smoke.make_dataset's inputs, from either package."""
    spec = datasets.DATASETS[key]
    cfg = datasets.config_for(spec).with_mode("ms_fixed")
    ref = simulate.make_reference(spec.genome_len, seed=spec.seed)
    reads = simulate.sample_reads(ref, READS, signal_len=cfg.signal_len,
                                  seed=spec.seed + 1, junk_frac=0.08)
    return cfg, reads, build_index(ref.events_concat, ref.n_events, cfg)


def jax_digest(key: str, mode: str) -> dict:
    from repro.core import Mapper, build_index
    from repro.signal import datasets, simulate
    cfg, reads, index = cell_inputs(datasets, simulate, build_index, key)
    out = Mapper(index, cfg.with_mode(mode)).map_signals(reads.signals,
                                                         chunk=CHUNK)
    return common.map_digest(out, CHUNK)


def port_digest(key: str, mode: str) -> dict:
    from repro_torch.core import Mapper, build_index
    from repro_torch.signal import datasets, simulate
    cfg, reads, index = cell_inputs(datasets, simulate, build_index, key)
    out = Mapper(index, cfg.with_mode(mode), device="cpu").map_signals(
        reads.signals, chunk=CHUNK)
    return common.map_digest(out, CHUNK)


@pytest.fixture(scope="module")
def golden():
    return json.loads(common.MAP_DIGEST.read_text())


def test_golden_holds_the_six_cells(golden):
    assert set(golden) == {f"{d} {m}" for d in DATASETS for m in MODES}
    for key, d in golden.items():
        assert (d["n_reads"], d["chunk"]) == (READS, CHUNK), key
        assert len(d["chunks"]) == READS // CHUNK, key
        assert d["counters"]["n_reads"] == READS, key
        assert set(d["fields"]) == {f for f, _ in common.DIGEST_FIELDS}


def test_golden_cell_equals_a_fresh_jax_run(golden):
    pytest.importorskip("jax")
    assert jax_digest(*CELL) == golden[" ".join(CELL)]


def test_port_cell_equals_golden(golden):
    got = port_digest(*CELL)
    assert common.digest_mismatch(got, golden[" ".join(CELL)]) is None
    assert got == golden[" ".join(CELL)]


def test_digest_names_the_first_differing_chunk(golden):
    want = golden[" ".join(CELL)]
    got = json.loads(json.dumps(want))
    got["chunks"][3] = "0" * 64
    got["fields"]["score"] = "0" * 64
    msg = common.digest_mismatch(got, want)
    assert msg.startswith("chunk 3 (reads 1536-2047)") and "score" in msg
    got = json.loads(json.dumps(want))
    got["counters"]["n_seeds"] += 1
    assert "n_seeds" in common.digest_mismatch(got, want)


if __name__ == "__main__":
    digests = {f"{d} {m}": jax_digest(d, m) for d in DATASETS for m in MODES}
    common.MAP_DIGEST.write_text(json.dumps(digests, indent=1,
                                            sort_keys=True) + "\n")
    print(f"wrote {common.MAP_DIGEST}")
