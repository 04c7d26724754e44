"""The sharded train step's collectives and their gradients on gloo ranks
(CPU): each autograd collective of ``models.part`` against the
one-process computation, in f64, on the 2-rank axes of a (2, 2) mesh and
on a (4,) mesh of the same 4 ranks; ``Mesh.reduce_scatter``; the
replicated leaves' sum; and the ten reduced configs' gathered gradient
with f32 parameters against one device's, where no bf16 rounding hides a
wrong adjoint (a missing or doubled sum changes a leaf by 100%; rounding
moves it by 1e-6).

Every rank draws every rank's inputs and cotangents from one seed, so a
rank computes what each collective's backward must return (the
vector-Jacobian product of the whole mesh's function) on its own.

The spawned ranks import this module: no JAX at its top.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import part  # noqa: E402
from repro_torch.train import golden as TG  # noqa: E402

F64 = torch.float64
ARCHS = sorted(TC.ARCHS)
# f32 parameters: the sharded gradient against one device's, per leaf
# (measured up to 1.6e-4 in the SSM's leaves, whose scan rounds to bf16
# inside; 1e-6 elsewhere)
F32_LEAF_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draws(seed, n, shape):
    """n arrays of ``shape`` (one a rank), f64, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=F64) for _ in range(n)]


def _vjp(out, inputs, cot):
    return torch.autograd.grad(out, inputs, cot, allow_unused=True)


def _coord(mesh, axes):
    """The rank's row-major coordinate over ``axes`` and their size."""
    pos, n = 0, 1
    for a in axes:
        pos, n = pos * mesh.shape[a] + mesh.coords[a], n * mesh.shape[a]
    return pos, n


def _group(mesh, axes):
    """The global ranks that differ from this one only along ``axes``, by
    their row-major coordinate over them."""
    grid = np.arange(mesh.size).reshape(tuple(mesh.shape.values()))
    index = tuple(slice(None) if a in axes else mesh.coords[a]
                  for a in mesh.axis_names)
    sub = grid[index]
    return [int(r) for r in np.asarray(sub).reshape(-1)]


def collectives(mesh) -> dict:
    """Each collective's forward and backward on this rank, and what they
    must be."""
    r, n = mesh.rank, mesh.size
    out = {}

    def check(name, got, want):
        out[name] = float(max((g - w).abs().max() for g, w in
                              zip(got, want)))

    # gather with a reduce-scatter adjoint over every axis of the gather
    # (FSDP with the batch split over them), over one axis and two
    for axes in [a for a in (("data",), ("model",), ("data", "model"))
                 if all(x in mesh.axis_names for x in a)]:
        ranks = _group(mesh, axes)
        pos, k = _coord(mesh, axes)
        blocks = draws(1, n, (3, 2))
        cots = draws(2, n, (3 * k, 2))
        x = blocks[r].clone().requires_grad_(True)
        for summed in (axes, ()):
            y, = part.gather([x], [0], axes, mesh, summed)
            whole = torch.cat([blocks[j] for j in ranks])
            want_g = (sum(cots[j] for j in ranks) if summed else cots[r])
            g, = _vjp(y, [x], cots[r])
            check(f"gather {axes} sum={bool(summed)}",
                  (y, g), (whole, want_g[3 * pos:3 * pos + 3]))
    # tp_sum: the sum over 'model'; its adjoint the identity
    ranks = _group(mesh, ("model",))
    xs, cot = draws(3, n, (4,)), draws(4, 1, (4,))[0]
    x = xs[r].clone().requires_grad_(True)
    y = part.tp_sum(x, mesh)
    check("tp_sum", (y, _vjp(y, [x], cot)[0]),
          (sum(xs[j] for j in ranks), cot))
    # tp_copy: the identity; its adjoint the sum over 'model'
    cots = draws(5, n, (4,))
    x = xs[0].clone().requires_grad_(True)
    y = part.tp_copy(x, mesh)
    check("tp_copy", (y, _vjp(y, [x], cots[r])[0]),
          (xs[0], sum(cots[j] for j in ranks)))
    # tp_block: the own block of a replicated tensor; its adjoint the
    # blocks' cotangents gathered
    m = mesh.shape["model"]
    c = mesh.coords["model"]
    cots = draws(6, n, (2, 3))
    x = torch.arange(2 * 3 * m, dtype=F64).reshape(2, 3 * m)
    x.requires_grad_(True)
    y = part.tp_block(x, -1, 3, mesh)
    check("tp_block", (y, _vjp(y, [x], cots[r])[0]),
          (x.detach()[:, 3 * c:3 * c + 3],
           torch.cat([cots[j] for j in ranks], dim=-1)))
    # batch_block: the own rows; adjoint the rows' cotangents gathered
    dp = MESH.dp_axes(mesh)
    if dp:
        pos, k = _coord(mesh, dp)
        ranks_dp = _group(mesh, dp)
        x = torch.arange(4.0 * k, dtype=F64).reshape(2 * k, 2)
        x.requires_grad_(True)
        y = part.batch_block(x, dp, mesh)
        check("batch_block", (y, _vjp(y, [x], cots[r][:, :2])[0]),
              (x.detach()[2 * pos:2 * pos + 2],
               torch.cat([cots[j][:, :2] for j in ranks_dp])))
        # replica_share: the identity, the gradient over the ranks
        x = xs[0].clone().requires_grad_(True)
        y = part.replica_share(x, dp, mesh)
        check("replica_share", (y, _vjp(y, [x], cot)[0]), (xs[0], cot / k))
    # column_products: the rank's columns of x @ w; the input's adjoint
    # summed over 'model', the weight's the rank's own
    xw = draws(7, 1, (2, 3, 4))[0]
    ws = draws(8, n, (4, 5))
    cots = draws(9, n, (2, 3, 5))
    x = xw.clone().requires_grad_(True)
    w = ws[r].clone().requires_grad_(True)
    y, = part.column_products(x, [w], mesh, torch.matmul)
    gx, gw = _vjp(y, [x, w], cots[r])
    check("column_products", (y, gx, gw),
          (xw @ ws[r], sum(cots[j] @ ws[j].T for j in ranks),
           torch.einsum("bsd,bsx->dx", xw, cots[r])))
    # reduce_replicated: a leaf replicated over the batch's axes summed
    # over them, one split over them left alone
    if dp:
        gs = draws(10, n, (3,))
        spec = {"norm": (None,), "fsdp": (dp,)}
        got = part.reduce_replicated({"norm": gs[r], "fsdp": gs[r]}, spec,
                                     dp, mesh)
        check("reduce_replicated", (got["norm"], got["fsdp"]),
              (sum(gs[j] for j in ranks_dp), gs[r]))
    # reduce_scatter directly: bf16 blocks summed in f32, rounded once
    if dp:
        parts = [t.to(torch.bfloat16) for t in draws(11, n, (4 * k, 3))]
        got, = mesh.reduce_scatter([parts[r]], [0], dp)
        want = sum(parts[j].float() for j in ranks_dp).to(torch.bfloat16)
        check("reduce_scatter bf16",
              (got.double(),), (want[4 * pos:4 * pos + 4].double(),))
        out["reduce_scatter dtype"] = str(got.dtype)
    return out


def _rank() -> dict:
    torch.set_num_threads(1)
    mesh22 = MESH.make_mesh((2, 2), ("data", "model"), device="cpu")
    mesh4 = MESH.make_mesh((4,), ("data",), device="cpu")
    res = dict(rank=mesh22.rank, m22=collectives(mesh22),
               m4=four_rank(mesh4))
    res["f32"] = {}
    gold = TG.load()
    for arch in ARCHS:
        cfg = TC.get_config(arch).reduced()
        params = TM.tree_map(lambda t: t.float(), TM.seeded_params(
            cfg, gold["weights_seed"], "cpu", mesh=mesh22))
        run = TG.train_run(cfg, gold, "cpu", mesh22, params=params,
                           steps=1)
        res["f32"][arch] = dict(grads=run["grads"], loss=run["loss"])
    return res


def four_rank(mesh) -> dict:
    """The gathers and their adjoints over one axis of 4 ranks."""
    r, n = mesh.rank, mesh.size
    blocks, cots = draws(21, n, (2, 3)), draws(22, n, (8, 3))
    x = blocks[r].clone().requires_grad_(True)
    out = {}
    for summed in (("data",), ()):
        y, = part.gather([x], [0], "data", mesh, summed)
        g, = _vjp(y, [x], cots[r])
        want = (sum(cots) if summed else cots[r])[2 * r:2 * r + 2]
        out[f"gather sum={bool(summed)}"] = float(max(
            (y - torch.cat(blocks)).abs().max(), (g - want).abs().max()))
    # the sums' order is the coordinates': every rank gets the same bits
    sums, = mesh.reduce_scatter([cots[r].float()], [0], "data")
    out["reduce_scatter"] = sums.numpy()
    return out


@pytest.fixture(scope="module")
def ranks():
    return MESH.run_ranks(_rank, 4, timeout=300)


def test_each_collective_backward_is_its_adjoint(ranks):
    for res in ranks:
        for name, err in res["m22"].items():
            if name == "reduce_scatter dtype":
                assert err == "torch.bfloat16"
            else:
                assert err <= 1e-12, (res["rank"], name, err)
        for name, err in res["m4"].items():
            if name != "reduce_scatter":
                assert err <= 1e-12, (res["rank"], name, err)


def test_reduce_scatter_sums_in_coordinate_order(ranks):
    """Over 4 ranks the f32 sums are the coordinates' left to right,
    equal bit for bit to the host's, each rank its block."""
    cots = [c.float() for c in draws(22, 4, (8, 3))]
    want = ((cots[0] + cots[1]) + cots[2]) + cots[3]
    for res in ranks:
        r = res["rank"]
        np.testing.assert_array_equal(res["m4"]["reduce_scatter"],
                                      want[2 * r:2 * r + 2].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_sharded_gradient_equals_one_device(ranks, arch):
    """With f32 parameters the (2, 2) mesh's gathered gradient equals one
    device's leaf by leaf within F32_LEAF_TOL: every adjoint (the FSDP
    reduce-scatter, tp_copy's sum, the replicated leaves' sum, the MoE's
    replicated routing) sums each partial exactly once."""
    gold = TG.load()
    cfg = TC.get_config(arch).reduced()
    params = TM.tree_map(lambda t: t.float(), TM.seeded_params(
        cfg, gold["weights_seed"], "cpu"))
    one = TG.train_run(cfg, gold, "cpu", params=params, steps=1)
    for res in ranks:
        got = res["f32"][arch]
        errs = TG.leaf_errors(got["grads"], one["grads"])
        assert max(errs.values()) <= F32_LEAF_TOL, sorted(
            errs.items(), key=lambda kv: -kv[1])[:3]
        assert abs(got["loss"][0] - one["loss"][0]) <= 1e-5
