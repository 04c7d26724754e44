"""The LM scaffold's forward pass and loss, port against the JAX package,
for every reduced architecture, with the JAX package's own initial
weights carried over by ``load_numpy_params``.

Tolerance (``repro_torch.models.golden``): max|Δlogits| over max|JAX
logits| within the family's bound (2e-2 dense, vlm and audio; 3e-2 hybrid
and ssm; 6e-2 moe), |Δnll| and |Δaux| within 1e-2.  Batch 2, 64 tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import golden as G  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

GOLD = G.load()
BS, SEQ = 2, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    """A JAX parameter tree as numpy, bf16 leaves as their uint16 bits."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def make_case(arch):
    """(arch, port config, JAX config, port params, JAX params, batch as
    numpy) — JAX's weights from ``jax.random.key(0)``."""
    cfg_j = JC.get_config(arch).reduced()
    cfg_t = TC.get_config(arch).reduced()
    params_j = JM.init_params(cfg_j, jax.random.key(0))
    params_t = TM.load_numpy_params(cfg_t, numpy_tree(params_j), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_t.vocab, (BS, SEQ)).astype(np.int32)
    batch = dict(tokens=tokens, labels=np.roll(tokens, -1, axis=1))
    if cfg_t.n_ctx_tokens:
        batch["ctx"] = rng.normal(0, 1, (BS, cfg_t.n_ctx_tokens,
                                         cfg_t.d_model)).astype(np.float32)
    return arch, cfg_t, cfg_j, params_t, params_j, batch


def deviations(case) -> dict:
    """max|Δlogits| over max|JAX logits|, |Δnll|, |Δaux| of the forward
    and the loss, port against the JAX package."""
    arch, cfg_t, cfg_j, params_t, params_j, batch = case
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    # one compiled program for both (the model's scans are compiled either
    # way; this halves the reference's compile time)
    logits_j, parts_j = jax.jit(lambda p, b: (
        JM.forward(p, b["tokens"], cfg_j, ctx=b.get("ctx"))[0],
        JM.loss_fn(p, b, cfg_j)[1]))(params_j, bj)
    logits_t, cache, aux_t = TM.forward(params_t, bt["tokens"], cfg_t,
                                        ctx=bt.get("ctx"))
    _, parts_t = TM.loss_fn(params_t, bt, cfg_t)
    assert cache is None
    assert logits_t.dtype == torch.float32
    assert logits_t.shape == (BS, SEQ, cfg_t.vocab)
    assert float(aux_t) == float(parts_t["aux"])
    want = np.asarray(logits_j)
    return dict(logits=float(np.abs(logits_t.numpy() - want).max()
                             / np.abs(want).max()),
                **{k: abs(float(parts_t[k]) - float(parts_j[k]))
                   for k in ("nll", "aux")})


@pytest.fixture(scope="module", params=sorted(TC.ARCHS))
def pair(request):
    return make_case(request.param)


def test_forward_and_loss_within_family_tolerance(pair):
    arch, cfg_t = pair[:2]
    dev = deviations(pair)
    assert dev["logits"] <= GOLD["tolerance"][cfg_t.family], (arch, dev)
    assert dev["nll"] <= GOLD["nll_tol"], (arch, dev)
    assert dev["aux"] <= GOLD["nll_tol"], (arch, dev)


def test_lm_module_holds_the_tree(pair):
    arch, cfg_t, _, params_t, _, batch = pair
    lm = TM.LM(cfg_t, params_t)
    assert set(lm.state_dict()) == set(TM.flatten(params_t))
    # leaves that require a gradient (the training slice's autograd)
    assert all(p.requires_grad for p in lm.parameters())
    tok = torch.from_numpy(batch["tokens"][:, :8])
    ctx = batch.get("ctx")
    ctx = None if ctx is None else torch.from_numpy(ctx)
    got, _, _ = lm(tok, ctx=ctx)
    want, _, _ = TM.forward(params_t, tok, cfg_t, ctx=ctx)
    assert torch.equal(got, want)


def test_load_numpy_params_checks_keys_shapes_and_dtypes():
    cfg = TC.get_config("qwen3-4b").reduced()
    tree = TM.tree_map(lambda t: (t.view(torch.int16).numpy().view(np.uint16)
                                  if t.dtype == torch.bfloat16 else t.numpy()),
                       TM.seeded_params(cfg, 0, "cpu"))
    got = TM.load_numpy_params(cfg, tree, "cpu")
    want = TM.seeded_params(cfg, 0, "cpu")
    for k, v in TM.flatten(want).items():
        assert torch.equal(TM.flatten(got)[k], v), k
    bad_key = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unexpected.*extra"):
        TM.load_numpy_params(cfg, bad_key, "cpu")
    bad_shape = dict(tree, final_norm=tree["final_norm"][:5])
    with pytest.raises(ValueError, match="final_norm"):
        TM.load_numpy_params(cfg, bad_shape, "cpu")
    bad_dtype = dict(tree, final_norm=tree["final_norm"].astype(np.float32))
    with pytest.raises(ValueError, match="uint16 bits"):
        TM.load_numpy_params(cfg, bad_dtype, "cpu")


if __name__ == "__main__":
    # the measured deviations the tests bound, one line an architecture
    for a in sorted(TC.ARCHS):
        d = deviations(make_case(a))
        print(f"{a:28s} {TC.get_config(a).family:7s} logits "
              f"{d['logits']:.6f}  |nll| {d['nll']:.2e}  |aux| "
              f"{d['aux']:.2e}", flush=True)
