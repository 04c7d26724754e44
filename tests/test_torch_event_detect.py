"""The port's fixed-point event detection (``kernels/event_detect``; on
the CPU its plain version) against the JAX ``event_detect`` kernel in
interpret mode, and the ``ms_fixed`` per-stage cheap phase
(``use_fused=False``: event_detect + the two lookups) against the JAX
package's.  Tolerance: exact, every output and counter."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import build_index as jax_build_index         # noqa: E402
from repro.core import pipeline as jpipe                      # noqa: E402
from repro.core import stages as jstages                      # noqa: E402
from repro.core.index import index_arrays as jax_index_arrays  # noqa: E402
from repro.kernels.cheap_fused import cheap_fused as jax_cheap_fused  # noqa: E402
from repro.kernels.event_detect import ops as jax_ed           # noqa: E402
from repro.kernels.event_detect.event_detect import event_detect_fixed  # noqa: E402
from repro_torch import kernels as K                          # noqa: E402
from repro_torch.core import MarsConfig, events, pipeline, stages  # noqa: E402
from repro_torch.core.index import index_arrays, index_from_numpy  # noqa: E402
from repro_torch.kernels.cheap_fused import ops as cf_ops     # noqa: E402
from repro_torch.kernels.event_detect import ops               # noqa: E402

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _kernel_args(cfg):
    return dict(E=cfg.max_events, w=cfg.tstat_window,
                tau2=int(round(cfg.tstat_threshold ** 2)),
                eps=1 << (2 * cfg.frac_bits - 8), peak_r=cfg.peak_window,
                frac_bits=cfg.frac_bits)


@pytest.mark.parametrize("S,E,w,tau,peak_r", [
    (1024, 192, 4, 2.5, 3), (512, 96, 3, 2.0, 2), (300, 48, 6, 4.0, 4),
    (256, 32, 12, 2.5, 1)])
def test_event_detect_rows_equals_jax_kernel(S, E, w, tau, peak_r):
    """On Q-format rows: piecewise-constant levels plus noise (real
    boundaries), pure noise, and flat rows (no events)."""
    cfg_kw = dict(signal_len=S, max_events=E, tstat_window=w,
                  tstat_threshold=tau, peak_window=peak_r)
    cfg_t = MarsConfig(**cfg_kw).with_mode("ms_fixed")
    rng = np.random.default_rng(S + E + w)
    lim = int(events.SIGNAL_CLIP * 256)
    levels = np.repeat(rng.normal(0, 300, size=(6, S // 8 + 1)), 8,
                       axis=1)[:, :S]
    xq = np.concatenate([levels + rng.normal(0, 40, size=(6, S)),
                         rng.normal(0, 200, size=(3, S)),
                         np.full((2, S), 77.0)])
    xq = np.clip(np.round(xq), -lim, lim).astype(np.int32)
    want = event_detect_fixed(jnp.asarray(xq), **_kernel_args(cfg_t))
    got = ops.event_detect_rows(torch.from_numpy(xq), cfg_t)
    _eq(got[0], want[0], "means")
    _eq(got[1], want[1], "n_events")
    assert int(got[1][-1]) < int(got[1][:6].min())   # flat rows: fewest


def test_event_detect_equals_jax_wrapper(small_reads):
    """From raw signals, through the normalization, against the JAX
    wrapper as its chunk program compiles it (jit)."""
    cfg_j = JaxConfig().with_mode("ms_fixed")
    cfg_t = MarsConfig().with_mode("ms_fixed")
    sig = small_reads.signals[:6]
    want = jax.jit(lambda x: jax_ed.event_detect(x, cfg_j))(
        jnp.asarray(sig))
    K.reset_launches()
    got = ops.event_detect(torch.from_numpy(sig), cfg_t)
    _eq(got[0], want[0], "means")
    _eq(got[1], want[1], "n_events")
    assert K.LAUNCHES["event_detect"] == 0      # CPU: the plain version


def test_event_detect_gate():
    """The wrapper refuses what the kernel cannot serve, exactly where the
    supports gate resolves ``detect`` to the reference."""
    xq = torch.zeros((1, 1024), dtype=torch.int32)
    for cfg in (MarsConfig().with_mode("rh2"),
                MarsConfig().with_mode("ms_float"),
                MarsConfig(tstat_window=13).with_mode("ms_fixed")):
        assert dict(stages.resolve_plan(cfg, stages.KERNELS))[
            "detect"] == stages.REFERENCE
        with pytest.raises(ValueError):
            ops.event_detect_rows(xq, cfg)
    with pytest.raises(TypeError):
        ops.event_detect_rows(xq.to(torch.int64), MarsConfig())


@pytest.fixture(scope="module")
def s(small_ref, small_reads):
    cfg_j = JaxConfig(hash_bits=10).with_mode("ms_fixed")
    cfg_t = MarsConfig(hash_bits=10).with_mode("ms_fixed")
    jidx = jax_build_index(small_ref.events_concat, small_ref.n_events,
                           cfg_j)
    tidx = index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                            jidx.n_ref_events, cfg_t)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, sig=small_reads.signals[:4],
                jarr=jax_index_arrays(jidx), tarr=index_arrays(tidx, "cpu"))


def _eq_cheap(got, want, tag):
    for g, w, n in zip(got[:3], want[:3], ("q_pos", "t_pos", "hit_valid")):
        _eq(g, w, f"{tag} {n}")
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        _eq(got[3][k], want[3][k], f"{tag} counter {k}")


def test_perstage_cheap_phase_equals_jax(s):
    """ms_fixed, ``use_fused=False``, kernels plan (event_detect + both
    lookups, plain versions here) == the JAX per-stage level under the
    pallas plan (event_detect and pLUTo kernels, interpret mode) == the JAX
    fused kernel == the port's fused path."""
    cfg_j, cfg_t = s["cfg_j"], s["cfg_t"]
    x = jnp.asarray(s["sig"])
    plan_j = jstages.resolve_plan(cfg_j, jstages.PALLAS)
    want = jax.jit(lambda a: jpipe.cheap_phase(a, s["jarr"], cfg_j, plan_j,
                                               use_fused=False))(x)
    plan_t = stages.resolve_plan(cfg_t, stages.KERNELS)
    got = pipeline.cheap_phase(torch.from_numpy(s["sig"]), s["tarr"], cfg_t,
                               plan_t, use_fused=False)
    _eq_cheap(got, want, "per-stage")
    _eq_cheap(got, jax_cheap_fused(x, s["jarr"], cfg_j), "jax fused")
    _eq_cheap(got, cf_ops.cheap_fused(torch.from_numpy(s["sig"]), s["tarr"],
                                      cfg_t), "port fused")
    assert int(got[3]["n_anchors_postvote"].sum()) > 0
