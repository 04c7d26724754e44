"""``chip_smoke.py``'s ``train_sharded`` phase rehearsed on the CPU with
qwen3-4b's reduced config (4 gloo ranks; the card runs it at full width):
the one device's reference beside the ranks, the 2-layer check (the
update's blocks by digest, the gradient rebuilt from the ranks' blocks'
sums of squares), the launcher with its last step profiled on rank 0, its
collectives against the counting mesh's, and what the phase records, so
that the script's own code has run before a call to the card."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_sharded_phase_rehearses_on_the_cpu():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.train import golden as G
    out = chip_smoke.phase_train_sharded("cpu rehearsal", "cpu", True)
    assert out["cut_worst"] <= G.load_sharded()["tolerance"]["card_grad"]
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert np.isfinite(out["grad_norms"]).all()
    assert set(out["step_collectives"]) == {"all_gather", "all_reduce",
                                            "reduce_scatter"}
    assert all(v["calls"] > 0 for v in out["step_collectives"].values())
    # the counting mesh's rank-0 count of the step equals gloo's
    assert out["counted_collectives"] == {
        f"{k}_{f}": v[f] for k, v in out["step_collectives"].items()
        for f in ("calls", "bytes")}
    assert out["ranks"] == 4 and len(out["step_times_s"]) == 3
    assert not any(v for r in out["rank_launches"] for v in r.values())
