"""The LM's sharded serving path on a (2, 2) mesh of gloo ranks (CPU),
against the port on one device and the JAX package's sharded steps.

For the ten reduced configs, with ``model.seeded_params`` weights and the
sharded golden's inputs (batch 4, a prompt of 16, one decode step, a cache
of 32; ``repro_torch.models.golden.sharded_inputs``), each rank holding
its blocks and computing its rows:

- prefill and decode logits (for FULL_ARCHS also the int8 cache's and
  the forward's) against the port on one device, and against the JAX
  package's sharded prefill and decode (``jax_lm_sharded_golden.json``),
  within the family tolerance of max|Δlogits| / max|reference| (2e-2
  dense, vlm, audio; 3e-2 hybrid, ssm; 6e-2 MoE);
- prefill + decode against the forward (sharded for FULL_ARCHS, else one
  device's), rtol = atol = 5e-2 (the JAX package's own test's bound; the
  int8 cache within 0.08);
- the launcher's body on the mesh: rank 0 prints the reference launcher's
  lines, every rank samples the same tokens;
- each config's prefill and decode step's collective calls and bytes by
  kind on each rank (``Mesh.stats``) against the counting mesh's count of
  the same step for that rank on the meta device (``analysis.count``):
  exact.

(``tests/test_torch_lm_collectives.py`` regenerates the golden's
h2o-danube-1.8b case on a (4, 2) mesh.)  Run as a script to print the
measured deviations:

    PYTHONPATH=src python tests/test_torch_lm_sharded.py

The spawned ranks import this module: no JAX at its top.
"""
import contextlib
import io
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import golden as G  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = sorted(TC.ARCHS)
GOLD = G.load_sharded()
LAUNCH = ["--arch", "qwen3-4b", "--reduced", "--batch", "4",
          "--prompt-len", "16", "--gen", "2", "--device", "cpu",
          "--mesh", "2x2"]
# the configs that also run the int8 cache and the whole forward on the
# mesh: the cache's head_dim split (granite's one KV head), heads split
# (qwen3), the decoder beside cross-attention (whisper), attention beside
# experts (llama4)
FULL_ARCHS = ("granite-20b", "llama4-maverick-400b-a17b", "qwen3-4b",
              "whisper-medium")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank() -> dict:
    """One rank of the (2, 2) mesh: every reduced config's prefill and
    decode logits (for FULL_ARCHS also the int8 cache's and the
    forward's), then the launcher's body."""
    torch.set_num_threads(1)          # tiny products; the host is shared
    mesh = MESH.make_mesh((2, 2), ("data", "model"), device="cpu")
    outs = {}
    for arch in ARCHS:
        cfg = TC.get_config(arch).reduced()
        params = TM.seeded_params(cfg, GOLD["weights_seed"], "cpu",
                                  mesh=mesh)
        tokens, ctx = G.sharded_inputs(cfg, GOLD)
        out = dict(zip(("prefill", "decode"), G.prefill_decode(
            params, cfg, tokens, ctx, GOLD, mesh)))
        if arch in FULL_ARCHS:
            out["prefill_int8"], out["decode_int8"] = G.prefill_decode(
                params, cfg, tokens, ctx, GOLD, mesh, torch.int8)
            out["forward"] = TM.forward(params, tokens, cfg, ctx=ctx,
                                        mesh=mesh)[0][:, -1]
        outs[arch] = {k: v.float().numpy() for k, v in out.items()}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = serve.serve(serve.parse_args(LAUNCH), mesh)
    # a train step of reduced qwen3-4b on the same mesh
    from repro_torch.train import golden as TG
    train = TG.train_run(TC.get_config("qwen3-4b").reduced(), TG.load(),
                         "cpu", mesh, steps=1)
    stats = dict(mesh.stats)
    return dict(rank=mesh.rank, outs=outs, tokens=res["tokens"],
                printed=printed.getvalue(), stats=stats, train=train,
                collectives=_collectives(mesh))


def _collectives(mesh) -> dict:
    """{arch: {step: (Mesh.stats' calls and bytes, the counting mesh's)}}
    of each reduced config's prefill and decode step on this rank."""
    from repro_torch.analysis import count as COUNT
    from repro_torch.configs.base import ShapeSpec
    out = {}
    for arch in ARCHS:
        cfg = TC.get_config(arch).reduced()
        params = TM.seeded_params(cfg, GOLD["weights_seed"], "cpu",
                                  mesh=mesh)
        tokens, ctx = G.sharded_inputs(cfg, GOLD)
        B, S = tokens.shape[0], tokens.shape[1] - 1
        cache = TM.init_cache(cfg, B, GOLD["max_len"], device="cpu",
                              mesh=mesh)
        got = {}
        for kind in ("prefill", "decode"):
            mesh.stats.clear()
            if kind == "prefill":
                _, cache = TM.prefill(params, tokens[:, :S], cfg,
                                      cache=cache, ctx=ctx, mesh=mesh)
            else:
                TM.decode_step(params, tokens[:, S:], cfg, cache=cache,
                               cache_index=S, ctx=ctx, mesh=mesh)
            counted = COUNT.CountingMesh((2, 2), ("data", "model"),
                                         rank=mesh.rank)
            COUNT.count_step(cfg, ShapeSpec(kind, S, B, kind), counted,
                             with_bytes=False, max_len=GOLD["max_len"],
                             cache_index=S)
            got[kind] = (COUNT.calls_and_bytes(mesh.stats),
                         COUNT.calls_and_bytes(counted.stats))
        out[arch] = got
    return out


@pytest.fixture(scope="module")
def ranks():
    return MESH.run_ranks(_rank, 4, timeout=300)


@pytest.fixture(scope="module")
def single():
    """The port on one device, on the same weights and inputs."""
    out = {}
    for arch in ARCHS:
        cfg = TC.get_config(arch).reduced()
        tokens, ctx = G.sharded_inputs(cfg, GOLD)
        out[arch] = G.serve_outputs(
            TM.seeded_params(cfg, GOLD["weights_seed"], "cpu"), cfg, tokens,
            ctx, GOLD)
    return out


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def deviations(ranks, single) -> dict:
    """Per config: the largest over the ranks of each output's deviation
    from one device, and of the prefill and decode from the JAX golden."""
    out = {}
    for arch in ARCHS:
        d = {k: max(rel(r["outs"][arch][k], v) for r in ranks)
             for k, v in single[arch].items() if k in ranks[0]["outs"][arch]}
        case = GOLD["cases"][f"{arch} (2, 2)"]
        for k in ("prefill", "decode"):
            d[f"jax_{k}"] = max(G.rel_err(G.digest_rows(
                r["outs"][arch][k], GOLD), case[k]) for r in ranks)
        out[arch] = d
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_logits_within_family_tolerance(ranks, single, arch):
    tol = GOLD["tolerance"][TC.get_config(arch).family]
    d = deviations(ranks, single)[arch]
    assert max(d.values()) <= tol, d
    # every rank sees the same whole logits
    for r in ranks[1:]:
        for k, v in r["outs"][arch].items():
            np.testing.assert_array_equal(v, ranks[0]["outs"][arch][k])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_decode_against_forward(ranks, single, arch):
    out = ranks[0]["outs"][arch]
    forward = out.get("forward", single[arch]["forward"])
    tol = GOLD["prefill_decode_tol"]
    np.testing.assert_allclose(out["decode"], forward, rtol=tol, atol=tol)
    if arch in FULL_ARCHS:
        assert rel(out["decode_int8"], forward) < G.load()["int8_tol"]


def test_launcher_body_on_the_mesh(ranks):
    lines = ranks[0]["printed"].splitlines()
    assert lines[0] == "arch=qwen3-4b-reduced batch=4 prompt=16 gen=2"
    assert lines[1].startswith("prefill: ") and "tok/s)" in lines[1]
    assert lines[2].startswith("decode : ") and "tok/s)" in lines[2]
    assert lines[3].startswith("sample tokens: [") and len(lines) == 4
    assert all(r["printed"] == "" for r in ranks[1:])
    toks = ranks[0]["tokens"]
    assert toks.shape == (4, 2) and 0 <= toks.min() and toks.max() < 512
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["tokens"], toks)
    # FSDP gathers and TP sums ran on every rank
    for r in ranks:
        assert r["stats"]["all_gather_calls"] > 0
        assert r["stats"]["all_reduce_calls"] > 0


def test_meshes_that_cannot_be_honoured_raise(ranks):
    """The train step is no longer among them: on the (2, 2) mesh every
    rank's gathered gradient of reduced qwen3-4b is the one device's
    within the sharded golden's bound, and its shardings are the
    parameters' (``tests/test_torch_lm_sharded_train*.py`` hold the
    rest).  NCCL on the CPU or on a shared card still raises."""
    from repro_torch.train import golden as TG
    mesh = MESH.AbstractMesh((2, 2), ("data", "model"), rank=0)
    cfg = TC.get_config("qwen3-4b").reduced()
    sh = TS.make_train_step(cfg, mesh, TO.AdamWConfig())[2]
    assert sh["opt"].m["embed"].spec == ("model", "data")
    one = TG.train_run(cfg, TG.load(), "cpu", steps=1)
    tol = TG.load_sharded()["tolerance"]
    for r in ranks:
        got = r["train"]
        assert max(TG.leaf_errors(got["grads"], one["grads"]).values()) \
            <= tol["sharded_grad"]
        assert abs(got["loss"][0] - one["loss"][0]) <= tol["loss"]
        assert got["lr"] == one["lr"]
    # NCCL wants a card a rank: never on the CPU, nor ranks sharing a card
    with pytest.raises(ValueError, match="nccl"):
        MESH._check_backend(torch.device("cpu"), "nccl", 4)
    with pytest.raises(ValueError, match="one card per rank"):
        MESH.run_ranks(print, 4, backend="nccl")


@pytest.mark.parametrize("arch", ARCHS)
def test_counting_mesh_equals_gloo_stats_prefill_decode(ranks, arch):
    for r in ranks:
        for kind, (gloo, counted) in r["collectives"][arch].items():
            assert gloo["all_gather_calls"] > 0, (arch, kind)
            assert counted == gloo, (arch, kind, r["rank"], counted, gloo)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_lm_sharded as T
    rk = MESH.run_ranks(T._rank, 4, timeout=300)
    sg = T.single.__wrapped__()
    for a, d in T.deviations(rk, sg).items():
        print(a, {k: round(v, 5) for k, v in d.items()},
              "jax spread", GOLD["cases"][f"{a} (2, 2)"]["jax_spread"])
