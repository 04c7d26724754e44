"""The LM scaffold's training, port against the JAX package, for four
of the ten reduced configs (the others: ``test_torch_train_grads_1.py`` and ``_3.py``; split so that each
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

ARCHS = ["hymba-1.5b", "llama-3.2-vision-11b", "mamba2-780m", "qwen3-4b"]


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


def test_long_sequence_ssd_gradient_is_finite_where_the_reference_s_is_not():
    """At 128 tokens a chunk's decay exponents above the diagonal pass
    exp's f32 range: the reference takes exp and then masks, so its
    gradient is NaN (a reference-side fault, mamba2's and hymba's SSD
    block alike); the port masks first.  The losses agree within
    ``loss_tol``, every port gradient is finite, and where the
    reference's is finite the port's is within the bound."""
    arch = "mamba2-780m"
    import numpy as np
    from repro_torch.data.tokens import TokenStream
    gold = C.G.load()
    cfg_t = C.TC.get_config(arch).reduced()
    params = C.TM.seeded_params(cfg_t, 0, "cpu")
    batch = TokenStream(cfg_t.vocab, 1, 128, seed=0).next_batch()
    vg, _ = C.jax_fns(arch)       # a new input shape: a second compile
    (lj, _), gj = vg(C.jax_tree(params), C.jax_batch(batch))
    (lt, _), gt = C.TM.value_and_grad(params, C.TS.device_batch(batch, "cpu"),
                                      cfg_t)
    assert abs(float(lt) - float(lj)) <= gold["loss_tol"]
    gj = C.port_flat(gj)
    finite = {k for k, v in gj.items() if torch.isfinite(v.float()).all()}
    assert finite != set(gj)               # the reference's NaN gradient
    gt = C.TM.flatten(gt)
    assert all(torch.isfinite(v.float()).all() for v in gt.values())
    errs = C.G.leaf_errors(gt, {k: gj[k] for k in finite})
    assert max(errs.values()) <= gold["grad_tol"][cfg_t.family], errs
    assert np.isfinite(float(lj))


def test_microbatched_train_step_within_tolerance_of_reference():
    """Two microbatches of the golden's shape (a batch of 4 rows): the
    reference's accumulation (``train/steps.py``'s scan: f32 zeros,
    ``a + b.astype(f32)``, a division by M, the mean loss) over its own
    jitted gradient, then its update, against the port's
    ``make_train_step(microbatches=2)``: losses within ``loss_tol``, grad
    norms within ``grad_norm_tol``, learning rates equal, nll the loss,
    aux 0, the moments f32."""
    import jax.numpy as jnp
    from repro.train import optimizer as JO
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.tokens import TokenStream
    gold = C.G.load()
    arch = "qwen3-4b"
    cfg = C.TC.get_config(arch).reduced()
    vg, upd = C.jax_fns(arch)
    pj = C.jax_tree(C.TM.seeded_params(cfg, gold["weights_seed"], "cpu"))
    sj = JO.init_state(pj)
    _, jit_for, _ = C.TS.make_train_step(cfg, None, C.adamw(gold, C.TO),
                                         microbatches=2)
    step = jit_for(C.TS.make_batch_abstract(
        cfg, ShapeSpec("t", gold["seq"], 2 * gold["batch"], "train")))
    pt = C.TM.seeded_params(cfg, gold["weights_seed"], "cpu")
    st = C.TO.init_state(pt)
    stream = TokenStream(cfg.vocab, 2 * gold["batch"], gold["seq"], seed=5)
    for _ in range(3):
        b = stream.next_batch()
        acc = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), pj)
        loss = 0.0
        for half in (slice(0, gold["batch"]), slice(gold["batch"], None)):
            (l, _), g = vg(pj, C.jax_batch({k: v[half] for k, v in
                                            b.items()}))
            acc = jax.tree_util.tree_map(lambda a, x: a + x.astype(a.dtype),
                                         acc, g)
            loss = loss + l
        pj, sj, mj = upd(pj, jax.tree_util.tree_map(lambda x: x / 2, acc),
                         sj)
        pt, st, mt = step(pt, st, C.TS.device_batch(b, "cpu"))
        assert float(mt["lr"]) == float(mj["lr"])
        assert abs(float(mt["loss"]) - float(loss / 2)) <= gold["loss_tol"]
        assert float(mt["nll"]) == float(mt["loss"])
        assert float(mt["aux"]) == 0.0
        assert (abs(float(mt["grad_norm"]) - float(mj["grad_norm"]))
                <= gold["grad_norm_tol"] * float(mj["grad_norm"]))
    assert all(t.dtype == torch.float32 for t in C.TO.tree_leaves(st.m))
