"""The LM scaffold's serving path: the KV/SSM cache, prefill and decode,
the step factories and ``python -m repro_torch.launch.serve``.

Port against the JAX package, with the JAX package's weights carried over
by ``load_numpy_params``: prefill(16) + decode(1) for every reduced
architecture, and the int8 cache for qwen3-4b and h2o-danube, within the
family tolerance of ``repro_torch.models.golden`` (max|Δ| over max|JAX|).
The port's own prefill + decode against its forward over 17 tokens, at
the JAX package's own bound (rtol = atol = 5e-2; the int8 cache 0.08).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import steps as JSTEPS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import golden as G  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import steps as TSTEPS  # noqa: E402

GOLD = G.load()
BS, S = 2, 16
INT8_ARCHS = ("h2o-danube-1.8b", "qwen3-4b")


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


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _prefill_decode(M, params, cfg, tokens, ctx, cache):
    _, cache = M.prefill(params, tokens[:, :S], cfg, cache=cache, ctx=ctx)
    got, cache = M.decode_step(params, tokens[:, S:S + 1], cfg, cache=cache,
                               cache_index=S, ctx=ctx)
    return got, cache


def _jax_prefill_decode(params, cfg, tokens, ctx, cache):
    """The reference's prefill + decode as one compiled program."""
    return jax.jit(lambda p, t, x, c: _prefill_decode(JM, p, cfg, t, x, c))(
        params, tokens, ctx, cache)


def make_case(arch):
    cfg_j = JC.get_config(arch).reduced()
    cfg_t = TC.get_config(arch).reduced()
    params_j = JM.init_params(cfg_j, jax.random.key(2))
    params_t = TM.load_numpy_params(cfg_t, numpy_tree(params_j), "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg_t.vocab, (BS, S + 1)).astype(np.int32)
    ctx = (rng.normal(0, 1, (BS, cfg_t.n_ctx_tokens, cfg_t.d_model))
           .astype(np.float32) if cfg_t.n_ctx_tokens else None)
    return arch, cfg_t, cfg_j, params_t, params_j, tokens, ctx


def _both(tokens, ctx):
    return ((jnp.asarray(tokens), None if ctx is None else jnp.asarray(ctx)),
            (torch.from_numpy(tokens),
             None if ctx is None else torch.from_numpy(ctx)))


def decode_deviation(case, kv_int8=False):
    """Port against JAX: max|Δ| over max|JAX| of the decode logits after a
    prefill of 16 tokens; and the port's decode logits."""
    arch, cfg_t, cfg_j, params_t, params_j, tokens, ctx = case
    (tj, cj), (tt, ct) = _both(tokens, ctx)
    kv_j, kv_t = ((jnp.int8, torch.int8) if kv_int8
                  else (jnp.bfloat16, torch.bfloat16))
    want, _ = _jax_prefill_decode(params_j, cfg_j, tj, cj,
                                  JM.init_cache(cfg_j, BS, S + 8, kv_j))
    cache = TM.init_cache(cfg_t, BS, S + 8, kv_t, "cpu")
    got, new_cache = _prefill_decode(TM, params_t, cfg_t, tt, ct, cache)
    assert new_cache is cache            # updated in place (donated)
    assert got.shape == (BS, cfg_t.vocab) and got.dtype == torch.float32
    return _rel(got.numpy(), np.asarray(want)), got, cache


@pytest.fixture(scope="module", params=sorted(TC.ARCHS))
def arch_case(request):
    return make_case(request.param)


def test_prefill_decode_within_family_tolerance(arch_case):
    arch, cfg_t, _, params_t, _, tokens, ctx = arch_case
    err, _, _ = decode_deviation(arch_case)
    assert err <= GOLD["tolerance"][cfg_t.family], (arch, err)
    # the JAX package's own property, on the port, at its batch of 1 (MoE
    # capacity depends on the tokens routed together, so at batch 2 a
    # decode step and the forward may drop different tokens, in both
    # packages): prefill + decode equals the forward over S + 1 tokens at
    # the last position
    _, (tt, ct) = _both(tokens, ctx)
    one = (tt[:1], None if ct is None else ct[:1])
    got1, _ = _prefill_decode(TM, params_t, cfg_t, *one,
                              TM.init_cache(cfg_t, 1, S + 8, device="cpu"))
    full, _, _ = TM.forward(params_t, one[0], cfg_t, ctx=one[1])
    tol = GOLD["prefill_decode_tol"]
    np.testing.assert_allclose(got1.numpy(), full[:, -1].numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_cache_within_tolerance(arch):
    case = make_case(arch)
    err, got, cache = decode_deviation(case, kv_int8=True)
    assert cache["slot0"]["k"].dtype == torch.int8
    assert bool((cache["slot0"]["k"][:, :, :S + 1] != 0).any())
    assert not bool(cache["slot0"]["k"][:, :, S + 1:].any())
    assert err <= GOLD["tolerance"]["dense"], err
    full, _, _ = TM.forward(case[3], torch.from_numpy(case[5]), case[1])
    assert _rel(got.numpy(), full[:, -1].numpy()) < GOLD["int8_tol"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-medium"])
def test_batch_stand_ins_equal_reference(arch, kind):
    shape_t = TC.ShapeSpec("s", 48, 3, kind)
    shape_j = JShapeSpec("s", 48, 3, kind)
    got = TSTEPS.make_batch_abstract(TC.get_config(arch), shape_t)
    want = JSTEPS.make_batch_abstract(JC.get_config(arch), shape_j)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())


def test_step_factories_check_their_stand_ins():
    cfg = TC.get_config("llama-3.2-vision-11b").reduced()
    _, jit_prefill, sh = TSTEPS.make_prefill_step(cfg, None, 24, 2)
    _, jit_decode, _ = TSTEPS.make_decode_step(cfg, None, 24, 2)
    assert TM.flatten(sh["params"]).keys() == TM.flatten(
        TM.abstract_params(cfg)).keys()
    ok_p = TSTEPS.make_batch_abstract(cfg, TC.ShapeSpec("p", 16, 2,
                                                        "prefill"))
    ok_d = TSTEPS.make_batch_abstract(cfg, TC.ShapeSpec("d", 24, 2,
                                                        "decode"))
    prefill_fn, decode_fn = jit_prefill(ok_p), jit_decode(ok_d)
    for jit_for, bad in ((jit_prefill, dict(ok_p, tokens=ok_p["tokens"][:1])),
                         (jit_prefill, {"tokens": ok_p["tokens"]}),
                         (jit_decode, ok_p)):
        with pytest.raises(ValueError, match="stand-ins"):
            jit_for(bad)
    params = TM.seeded_params(cfg, 0, "cpu")
    cache = TM.init_cache(cfg, 2, 24, device="cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17))
                           .astype(np.int32))
    ctx = torch.from_numpy(rng.normal(0, 1, (2, cfg.n_ctx_tokens,
                                             cfg.d_model))).to(torch.bfloat16)
    _, cache = prefill_fn(params, tok[:, :16], cache, ctx)
    got, _ = decode_fn(params, tok[:, 16:], cache, 16, ctx)
    full, _, _ = TM.forward(params, tok, cfg, ctx=ctx)
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), rtol=5e-2,
                               atol=5e-2)


def _flags(parser_fn):
    import argparse
    import unittest.mock as mock
    seen = []
    real = argparse.ArgumentParser.add_argument

    def record(self, *names, **kw):
        seen.extend(n for n in names if n.startswith("--") and n != "--help")
        return real(self, *names, **kw)
    with mock.patch.object(argparse.ArgumentParser, "add_argument", record):
        try:
            parser_fn()
        except (SystemExit, RuntimeError, NotImplementedError):
            pass
    return set(seen)


def test_launcher_flags_include_the_reference_launchers():
    ref = _flags(lambda: jax_serve.main(["--help"]))
    got = _flags(lambda: serve.parse_args(["--help"]))
    assert ref == {"--arch", "--reduced", "--batch", "--prompt-len", "--gen",
                   "--mesh", "--kv-int8"}
    assert got == ref | {"--device"}
    args = serve.parse_args(["--arch", "qwen3-4b"])
    assert (args.batch, args.prompt_len, args.gen, args.mesh,
            args.kv_int8, args.device) == (4, 64, 32, "auto", False, "cuda")


def test_launcher_on_the_cpu(capsys):
    argv = ["--device", "cpu", "--arch", "qwen3-4b", "--reduced",
            "--batch", "2", "--prompt-len", "16", "--gen", "4"]
    toks = serve.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "arch=qwen3-4b-reduced batch=2 prompt=16 gen=4"
    assert lines[1].startswith("prefill: ") and "tok/s)" in lines[1]
    assert lines[2].startswith("decode : ") and "tok/s)" in lines[2]
    assert lines[3].startswith("sample tokens: [")
    assert len(lines) == 4
    assert isinstance(toks, np.ndarray) and toks.shape == (2, 4)
    cfg = TC.get_config("qwen3-4b").reduced()
    assert toks.min() >= 0 and toks.max() < cfg.vocab
    # --kv-int8 serves the bf16 cache, as the reference's launcher does
    res = serve.run(serve.parse_args(argv + ["--kv-int8"]))
    capsys.readouterr()
    np.testing.assert_array_equal(res["tokens"], toks)
    assert res["cache"]["slot0"]["k"].dtype == torch.bfloat16
    # an ssm stack, a vlm stack (context stub) and the mesh flag
    for arch in ("mamba2-780m", "llama-3.2-vision-11b"):
        out = serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                          "--batch", "2", "--prompt-len", "8", "--gen", "2",
                          "--mesh", "1x1"])
        assert out.shape == (2, 2)
    # a mesh of several devices spawns its ranks (gloo on the CPU), each
    # serving the launcher's body (tests/test_torch_lm_sharded.py runs it)
    import unittest.mock as mock
    spawned = []

    def fake_run_ranks(fn, n, *a, backend, timeout):
        spawned.append((fn, n, a[1:], backend))
        return [dict(tokens=toks, rank=r) for r in range(n)]
    with mock.patch.object(serve, "run_ranks", fake_run_ranks):
        out = serve.main(argv + ["--mesh", "2x2"])
    assert spawned == [(serve.serve_rank, 4, ((2, 2), ("data", "model")),
                        "gloo")]
    assert out is toks
    assert dataclasses.asdict(res["cfg"]) == dataclasses.asdict(cfg)


def test_launcher_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-4b", "--reduced", "--batch", "1",
                    "--prompt-len", "4", "--gen", "1"])
    cfg = TC.get_config("qwen3-4b").reduced()
    for call in (lambda: TM.init_params(cfg, None),
                 lambda: TM.init_cache(cfg, 1, 8),
                 lambda: TM.seeded_params(cfg, 0),
                 lambda: TM.load_numpy_params(cfg, {}, "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


if __name__ == "__main__":
    # the measured deviations the tests bound, one line an architecture
    for a in sorted(TC.ARCHS):
        case = make_case(a)
        line = (f"{a:28s} {case[1].family:7s} decode "
                f"{decode_deviation(case)[0]:.6f}")
        if a in INT8_ARCHS:
            line += f"  int8 {decode_deviation(case, kv_int8=True)[0]:.6f}"
        print(line, flush=True)
