"""The LM's sharded train step on a (2, 2) mesh of 4 gloo ranks (CPU),
for five of the ten reduced configs (the others:
``test_torch_lm_sharded_train_1.py``; split so that each file's JAX
compiles stay short), on the training golden's weights and batches
(batch 2, seq 16, three steps; ``repro_torch.train.golden``):

- the gathered gradient leaf by leaf within ``sharded_grad`` (1e-2) of
  the port on one device, every rank's equal;
- the same within the family's bound of the JAX package's sharded
  gradient (where the JAX package's own sharded gradient departs from
  its one-device one by more than the bound, of that one), bounded
  through the port's one-device gradient and the golden's record of its
  distance from the JAX gradient (``torch_lm_sharded_train_cases``);
- three ``make_train_step`` steps' losses within 1e-2 of one device and
  of the JAX package's sharded steps (``jax_train_sharded_golden.json``),
  the leaf norms within the family's bound of the golden's, the learning
  rates equal;
- the golden's qwen3-4b entry against a live JAX run (8 host devices in
  a subprocess, while the ranks run).

Run ``PYTHONPATH=src python tests/torch_lm_sharded_train_cases.py
--deviations`` to print the measured deviations.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_lm_sharded_train_cases as C  # noqa: E402

ARCHS = ["llama4-maverick-400b-a17b", "mamba2-780m", "qwen3-4b",
         "qwen3-moe-30b-a3b", "whisper-medium"]


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
def live(tmp_path_factory):
    """The JAX package's qwen3-4b gradient from a subprocess started
    before the ranks, so that the two run side by side."""
    pytest.importorskip("jax")
    path = tmp_path_factory.mktemp("jax") / "grads.npz"
    proc = C.start_jax_grads(["qwen3-4b"], path)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def case(live):
    return C.port_runs(ARCHS)


@pytest.mark.parametrize("arch,leaf", C.leaf_ids(ARCHS),
                         ids=lambda x: x)
def test_sharded_leaf_gradient_against_one_device(case, arch, leaf):
    C.check_leaf_against_one_device(case, arch, leaf)


@pytest.mark.parametrize("arch,leaf", C.leaf_ids(ARCHS),
                         ids=lambda x: x)
def test_sharded_leaf_gradient_against_jax_sharded(case, arch, leaf):
    C.check_leaf_against_jax(case, arch, leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_steps_against_one_device_and_golden(case, arch):
    C.check_steps(case, arch)


def test_sharded_golden_entry_equals_a_fresh_jax_run(case, live):
    proc, path = live
    C.check_golden(C.jax_grads(proc, path, ["qwen3-4b"])["qwen3-4b"],
                   "qwen3-4b")
