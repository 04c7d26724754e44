"""The LM scaffold's training, port against the JAX package, for two
of the ten reduced configs (the others: ``test_torch_train_grads_1.py`` and ``_2.py``; split so that each
file's reference compiles stay short): the gradient of ``loss_fn`` leaf
by leaf within the family's bound, the global norm, three
``make_train_step`` steps' losses, grad norms and learning rates against
the reference's and the committed golden's, and the golden entry against
a fresh reference run.  Weights: ``model.seeded_params`` (numpy draws)
carried into both packages; batches: the token stream.  The bounds, and
the JAX package's own bf16-against-f32 spread they were sized from, are
in ``src/repro_torch/train/jax_train_golden.json``
(``repro_torch.train.golden``).
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_train_cases as C  # noqa: E402

ARCHS = ["llama4-maverick-400b-a17b", "qwen3-moe-30b-a3b"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,leaf", C.leaf_ids(ARCHS),
                         ids=lambda x: x)
def test_leaf_gradient_within_family_tolerance(arch, leaf):
    C.check_leaf(C.case(arch), leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_global_norm_and_train_steps_within_tolerance(arch):
    C.check_norm_and_steps(C.case(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_entry_equals_a_fresh_jax_run(arch):
    C.check_golden(C.case(arch))

