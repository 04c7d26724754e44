"""The LM scaffold's dry run in the port (``repro_torch.launch.dryrun``,
``analysis.roofline``, ``analysis.count``) against the JAX package's
dry run, read from its golden (``jax_dryrun_golden.json``; no JAX cell is
lowered here):

- the roofline math and suggestions (``tests/test_configs_roofline.py``'s
  checks on the ``tpu-v5e`` row, and the ``h100`` row's);
- exact over every golden cell: the cell list and names, ``chips``, every
  skip and its note, ``tokens``, ``model_flops`` and its basis, the
  ``tpu-v5e`` row's derived fields from the JAX cell's own inputs, and
  ``format_table`` / ``format_suggestions`` text;
- the skip cell through the launcher;
- the counted flops a device of a few full-width cells against the JAX
  cell's HLO count, within the parity rule's tolerance
  (``analysis.golden``);
- a reduced config's step counted on the meta device against the same
  step's count on real tensors, exact, for every reduced config and the
  train launcher's warm-up step.
"""
import io
import json
import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import roofline as jrl  # noqa: E402  (no JAX import)
from repro_torch.analysis import count  # noqa: E402
from repro_torch.analysis import golden as G  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.configs import ARCHS, SHAPE_ORDER, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

GOLD = G.load()
CELLS = GOLD["cells"]
INPUTS = ("arch", "shape", "mesh", "chips", "flops_per_device",
          "bytes_per_device", "wire_bytes_per_device", "collective_detail",
          "peak_memory_per_device", "model_flops", "model_flops_basis",
          "tokens", "status", "note")
DERIVED = ("t_compute", "t_memory", "t_collective", "bottleneck",
           "useful_flops_ratio", "roofline_fraction", "flops_global",
           "bytes_global", "suggestion")
# the counted cells: one train, one prefill (dense), and the cheapest
# decode cell of two more families; the launcher's test counts a third,
# mamba2-780m's, an explained one (the rest, 5-80 s a cell:
# tests/torch_dryrun_cases.py --deviations)
COUNTED = ("h2o-danube-1.8b__train_4k__single",
           "h2o-danube-1.8b__prefill_32k__single",
           "whisper-medium__decode_32k__single",
           "llama-3.2-vision-11b__decode_32k__single")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the counts are python-bound, and the suite's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# Roofline math
# --------------------------------------------------------------------------- #
def _cell(hw, **kw):
    base = dict(arch="x", shape="train_4k", mesh="single", chips=256,
                flops_per_device=0.0, bytes_per_device=0.0,
                wire_bytes_per_device=0.0, collective_detail={},
                peak_memory_per_device=None, model_flops=0.0,
                model_flops_basis="6ND", tokens=1, hw=hw)
    base.update(kw)
    return rl.CellResult(**base)


@pytest.mark.parametrize("hw", sorted(rl.HARDWARE))
def test_roofline_terms_math(hw):
    row = rl.HARDWARE[hw]
    c = _cell(hw, flops_per_device=row.peak_flops,      # 1 s of compute
              bytes_per_device=row.hbm_bw,              # 1 s of HBM
              wire_bytes_per_device=2 * row.link_bw,    # 2 s of link
              model_flops=row.peak_flops * 256 / 2)     # half the flops
    assert c.t_compute == pytest.approx(1.0)
    assert c.t_memory == pytest.approx(1.0)
    assert c.t_collective == pytest.approx(2.0)
    assert c.bottleneck == "collective"
    assert c.useful_flops_ratio == pytest.approx(0.5)
    assert c.roofline_fraction == pytest.approx(0.25)
    assert "TP degree" in c.suggestion or "FSDP" in c.suggestion
    assert c.to_dict()["hw"] == hw


def test_hardware_rows():
    tpu, h100 = rl.HARDWARE["tpu-v5e"], rl.HARDWARE["h100"]
    assert (tpu.peak_flops, tpu.hbm_bw, tpu.link_bw) == (
        jrl.PEAK_FLOPS, jrl.HBM_BW, jrl.LINK_BW)
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == (
        989e12, 3.35e12, 50e9)
    assert rl.DEFAULT_HW == "h100"


@pytest.mark.parametrize("hw", sorted(rl.HARDWARE))
def test_suggestions_cover_all_bottlenecks(hw):
    for arch in ("llama3-405b", "qwen3-moe-30b-a3b", "mars-rsga"):
        for b in ("compute", "memory", "collective"):
            for basis in ("6ND", "2ND"):
                got = rl.suggest(arch, b, basis, hw)
                assert len(got) > 10
                want = jrl.suggest(arch, b, basis)
                if hw == "tpu-v5e":
                    assert got == want
                else:
                    assert got == want.replace("VMEM", "shared memory")


def test_error_cell_saves_without_dividing_by_zero(tmp_path):
    """The one departure from the reference: chips=0 (the launcher's
    error cell) prices every term at 0 where the reference raises."""
    c = _cell("h100", chips=0, status="error", note="boom")
    with pytest.raises(ZeroDivisionError):
        jrl.CellResult(**{k: getattr(c, k) for k in INPUTS}).t_compute
    f = rl.save_cell(c, tmp_path)
    d = json.loads(f.read_text())
    assert (d["t_compute"], d["t_memory"], d["roofline_fraction"]) == (0, 0, 0)
    assert f.name == "x__train_4k__single.json"


# --------------------------------------------------------------------------- #
# Exact against the golden
# --------------------------------------------------------------------------- #
def test_golden_holds_every_cell():
    want = {f"{a}__{s}__{m}" for a in ARCHS for s in SHAPE_ORDER
            for m in ("single", "multi")}
    want |= {"mars-rsga__map_8k__single", "mars-rsga__map_8k__multi"}
    assert set(CELLS) == want and len(CELLS) == 82
    assert all(c["status"] in ("ok", "skip") for c in CELLS.values())
    assert GOLD["flops_tolerance"] == G.FLOPS_TOLERANCE


@pytest.mark.parametrize("key", sorted(CELLS))
def test_cell_fields_equal_jax(key):
    """chips, status, skips and notes, tokens, model_flops and its basis:
    exact (the mars-rsga cell is written as a skip, its note says why)."""
    jc = CELLS[key]
    pc = dryrun.cell_spec(jc["arch"], jc["shape"], jc["mesh"] == "multi",
                          hw="tpu-v5e").to_dict()
    for k in ("arch", "shape", "mesh", "chips", "tokens", "model_flops",
              "model_flops_basis"):
        assert pc[k] == jc[k], (key, k, pc[k], jc[k])
    if jc["arch"] == "mars-rsga":
        assert pc["status"] == "skip" and pc["note"] == dryrun.MARS_NOTE
        assert jc["model_flops"] == 1_498_939_392
    else:
        assert (pc["status"], pc["note"] if jc["status"] == "skip"
                else "") == (jc["status"], jc["note"] if jc["status"] ==
                             "skip" else "")


def test_derived_fields_equal_jax_on_the_tpu_row():
    """Every roofline field, from the JAX cell's own inputs on the
    ``tpu-v5e`` row, equals the JAX cell's, as does the table text."""
    port = {}
    for key, jc in CELLS.items():
        c = rl.CellResult(**{k: jc[k] for k in INPUTS}, hw="tpu-v5e")
        d = c.to_dict()
        for k in DERIVED:
            assert d[k] == jc[k], (key, k, d[k], jc[k])
        port[key] = d
    assert rl.format_table(port) == jrl.format_table(CELLS)
    assert rl.format_suggestions(port) == jrl.format_suggestions(CELLS)
    assert rl.format_table(CELLS) == jrl.format_table(CELLS)


def test_skip_cell_through_the_launcher(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k", "--mesh",
                     "single", "--out", str(tmp_path), "--hw", "tpu-v5e"])
    assert "[skip] qwen3-4b long_500k single: SKIP(full-attention)" in \
        out.getvalue()
    cell = json.loads(
        (tmp_path / "qwen3-4b__long_500k__single.json").read_text())
    jc = CELLS["qwen3-4b__long_500k__single"]
    assert cell["status"] == "skip" and cell["note"] == "SKIP(full-attention)"
    for k in INPUTS + DERIVED:
        assert cell[k] == jc[k], k
    assert cell["hw"] == "tpu-v5e"


# --------------------------------------------------------------------------- #
# Counted flops against the JAX cells
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key", COUNTED)
def test_counted_flops_within_tolerance(key):
    """Rank 0's step counted as the launcher counts it (flops only; the
    launcher's own route, bytes and wire included, is the next test's)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.mesh import make_production_mesh
    jc = CELLS[key]
    mesh = count.CountingMesh.of(make_production_mesh(
        multi_pod=jc["mesh"] == "multi"))
    got = count.count_step(get_config(jc["arch"]), SHAPES[jc["shape"]],
                           mesh, with_bytes=False)
    lo, hi = G.cell_bounds(key)
    ratio = got["flops"] / jc["flops_per_device"]
    assert lo <= ratio <= hi, (key, ratio, (lo, hi))


def test_counted_cell_through_the_launcher():
    key = "mamba2-780m__decode_32k__single"
    jc = CELLS[key]
    pc = dryrun.count_cell(jc["arch"], jc["shape"], False)
    lo, hi = G.cell_bounds(key)
    assert lo <= pc.flops_per_device / jc["flops_per_device"] <= hi
    assert pc.status == "ok" and pc.hw == "h100" and pc.chips == 256
    assert pc.wire_bytes_per_device == sum(
        v for k, v in pc.collective_detail.items() if k.startswith("bytes_"))
    assert pc.wire_bytes_per_device > 0 and pc.bytes_per_device > 0
    assert pc.peak_memory_per_device > 0
    for k in ("tokens", "model_flops", "model_flops_basis"):
        assert getattr(pc, k) == jc[k]


# --------------------------------------------------------------------------- #
# Meta against real tensors
# --------------------------------------------------------------------------- #
def _real_step_flops(cfg, kind, B, S):
    """The FlopCounterMode count of one step on real CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as TS
    params = M.seeded_params(cfg, 0, "cpu")
    if kind == "train":
        batch = TS.device_batch(TokenStream(
            cfg.vocab, B, S, seed=1, n_ctx=cfg.n_ctx_tokens,
            d_model=cfg.d_model).next_batch(), "cpu")
        step, _, _ = TS.make_train_step(cfg, None, O.AdamWConfig())
        args = (params, O.init_state(params), batch)
        kw = {}
    else:
        make = (TS.make_prefill_step if kind == "prefill"
                else TS.make_decode_step)
        step, _, _ = make(cfg, None, S, B)
        tokens = torch.zeros((B, S if kind == "prefill" else 1),
                             dtype=torch.int32)
        args = (params, tokens, M.init_cache(cfg, B, S, device="cpu"))
        if kind == "decode":
            args += (S - 1,)
        kw = ({} if not cfg.n_ctx_tokens else dict(ctx=torch.zeros(
            (B, cfg.n_ctx_tokens, cfg.d_model), dtype=torch.bfloat16)))
    with FlopCounterMode(display=False) as fc:
        step(*args, **kw)
    return float(fc.get_total_flops())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_step_equals_real_step(arch):
    cfg = get_config(arch).reduced()
    for kind, B, S in (("train", 2, 16), ("decode", 2, 16)):
        meta = count.count_step(cfg, ShapeSpec(kind, S, B, kind), None,
                                with_bytes=False)
        assert meta["flops"] > 0
        assert meta["flops"] == _real_step_flops(cfg, kind, B, S), (arch,
                                                                    kind)


def test_launcher_warmup_flops_equal_meta():
    """The card check's route on the CPU: the train launcher's first step
    counted under FlopCounterMode (``chip_smoke.first_step_flops``)
    equals the meta count of that step."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.launch import train
    args = train.parse_args(["--arch", "qwen3-4b", "--reduced", "--steps",
                             "2", "--batch", "2", "--seq", "16",
                             "--device", "cpu", "--log-every", "100"])
    got = {}
    with contextlib.redirect_stdout(io.StringIO()):
        with chip_smoke.first_step_flops(got):
            train.run(args)
    meta = count.count_step(get_config("qwen3-4b").reduced(),
                            ShapeSpec("train", 16, 2, "train"), None,
                            with_bytes=False)
    assert got["flops"] == meta["flops"] > 0


def test_counting_mesh_stats_equal_its_detail():
    """The counting mesh's two records of one sharded step agree: calls by
    kind, and each kind's result bytes as the reference weighs them."""
    mesh = count.CountingMesh((2, 2), ("data", "model"), rank=3)
    count.count_step(get_config("qwen3-4b").reduced(),
                     ShapeSpec("train", 16, 4, "train"), mesh,
                     with_bytes=False)
    for kind, hlo in count.HLO_KIND.items():
        assert mesh.stats[f"{kind}_calls"] == mesh.detail[f"count_{hlo}"]
    # a (2, 2) mesh: a gather's result is 2x what it sends, a reduce-
    # scatter's half, an all-reduce's its payload (weighted 2x)
    assert mesh.detail["bytes_all-gather"] == 2 * mesh.stats[
        "all_gather_bytes"]
    assert mesh.detail["bytes_reduce-scatter"] == mesh.stats[
        "reduce_scatter_bytes"] / 2
    assert mesh.detail["bytes_all-reduce"] == 2 * mesh.stats[
        "all_reduce_bytes"]
