"""The LM's sharded train step on a (2, 2) mesh of 4 gloo ranks (CPU),
for five of the ten reduced configs (the others:
``test_torch_lm_sharded_train_2.py``; split so that each file's JAX
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

Run ``PYTHONPATH=src python tests/torch_lm_sharded_train_cases.py
--deviations`` to print the measured deviations.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_lm_sharded_train_cases as C  # noqa: E402

ARCHS = ["granite-20b", "h2o-danube-1.8b", "hymba-1.5b",
         "llama-3.2-vision-11b", "llama3-405b"]


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
def case():
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
