"""The port's LM train step on the CPU, without the JAX package: the
gradient with and without rematerialisation (equal bit for bit, over
every block kind; the training forward never writes a cache),
the step factory's contract, and the golden's stated bounds.  The port
against the golden itself is held in ``test_torch_train_grads_*.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import golden as G  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import steps as S  # noqa: E402

ARCHS = sorted(TC.ARCHS)
GOLD = G.load()


# configs whose groups hold every block kind between them: self-attention
# and MoE (llama4), attention beside the SSD scan (hymba), the decoder
# with cross-attention and the encoder's own remat (whisper)
@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "hymba-1.5b",
                                  "whisper-medium"])
def test_remat_on_and_off_give_equal_gradients(arch, monkeypatch):
    def no_cache(*a, **k):
        raise AssertionError("the training forward wrote a cache")
    # every cache write goes through layers.update_slice (the hybrid's
    # windowed attention too, through layers.store_kv)
    monkeypatch.setattr(layers, "update_slice", no_cache)
    cfg = TC.get_config(arch).reduced()
    params = M.seeded_params(cfg, 1, "cpu")
    batch = S.device_batch(G.batches(cfg, GOLD)[0], "cpu")
    (l_on, p_on), g_on = M.value_and_grad(params, batch, cfg, remat=True)
    (l_off, p_off), g_off = M.value_and_grad(params, batch, cfg, remat=False)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(p_on[k], p_off[k]) for k in p_on)
    f_on, f_off = M.flatten(g_on), M.flatten(g_off)
    assert list(f_on) == list(M.flatten(params))
    for k in f_on:
        assert f_on[k].dtype == params_leaf(params, k).dtype
        assert torch.equal(f_on[k], f_off[k]), k
    # the loss is the forward's, and the parameters were left untouched
    loss, _ = M.loss_fn(params, batch, cfg)
    assert torch.equal(loss, l_on) and not loss.requires_grad
    assert all(not t.requires_grad for t in M.flatten(params).values())


def params_leaf(params, path):
    return M.flatten(params)[path]


def test_golden_states_its_bounds_and_spreads():
    assert sorted(GOLD["reduced"]) == sorted(GOLD["spread"]) == ARCHS
    for arch in ARCHS:
        fam = TC.get_config(arch).family
        # each bound sits above the JAX package's own bf16-vs-f32 spread
        assert GOLD["spread"][arch]["grad_leaf_max"] < GOLD["grad_tol"][fam]
        assert GOLD["spread"][arch]["grad_norm"] < GOLD["grad_norm_tol"]
        assert len(GOLD["reduced"][arch]["loss"]) == GOLD["steps"]


def test_train_step_factory_contract():
    cfg = TC.get_config("qwen3-4b").reduced()
    adamw = O.AdamWConfig(warmup_steps=2, total_steps=4)
    step, jit_for, sh = S.make_train_step(cfg, None, adamw)
    assert set(sh) == {"params", "opt"}
    # one device: the reference's specs on a (1, 1) mesh, each block the
    # whole leaf
    from repro_torch.distributed.sharding import local_shape
    assert all(local_shape(tuple(a.shape), s.spec, s.mesh) == tuple(a.shape)
               and s.mesh.size == 1 for a, s in zip(
                   M.flatten(M.abstract_params(cfg)).values(),
                   M.flatten(sh["params"]).values()))
    assert M.flatten(sh["params"]).keys() == M.flatten(
        M.abstract_params(cfg)).keys()
    assert isinstance(sh["opt"], O.AdamWState)
    b_abs = S.make_batch_abstract(cfg, ShapeSpec("t", 16, 4, "train"))
    assert jit_for(b_abs) is step
    with pytest.raises(ValueError, match="labels"):
        jit_for({"tokens": b_abs["tokens"]})
    _, jit_mb, _ = S.make_train_step(cfg, None, adamw, microbatches=3)
    with pytest.raises(ValueError, match="3 microbatches"):
        jit_mb(b_abs)

    # on a mesh of four the shardings are the reference's: the moments'
    # the parameters', the step replicated (the step itself runs in
    # tests/test_torch_lm_sharded_train*.py)
    from repro_torch.launch.mesh import AbstractMesh
    four = S.make_train_step(cfg, AbstractMesh((2, 2), ("data", "model")),
                             adamw)[2]
    assert four["params"]["lm_head"].spec == ("data", "model")
    assert four["opt"].v is four["params"] and four["opt"].step.spec == ()
    # donate=False leaves the inputs as they were
    params = M.seeded_params(cfg, 0, "cpu")
    before = {k: v.clone() for k, v in M.flatten(params).items()}
    state = O.init_state(params)
    keep, _, _ = S.make_train_step(cfg, None, adamw, donate=False)
    batch = S.device_batch(G.batches(cfg, GOLD)[0], "cpu")
    new_p, new_s, m = keep(params, state, batch)
    assert set(m) == {"loss", "nll", "aux", "grad_norm", "lr"}
    assert all(torch.equal(before[k], v) for k, v in
               M.flatten(params).items())
    assert int(state.step) == 0 and int(new_s.step) == 1
    assert not torch.equal(M.flatten(new_p)["embed"], before["embed"])
    assert np.isfinite(float(m["loss"]))
