"""The LM scaffold's layers, port against the JAX package, function by
function, on the same numpy inputs.

At f32 (``rtol = 1e-5``): ``rms_norm``, ``apply_rope``, ``swiglu``,
``mha_online`` at ``chunk=16`` so that the online softmax spans several
chunks (causal, windowed, a partly valid cache, int8 values with scales)
and the hybrid's ``_mha_dyn_window``.  At bf16, within the LM's family
tolerance (``repro_torch.models.golden``: max|diff| over max|JAX|):
``_causal_conv`` in both forms, ``ssd_chunked`` over four chunks (CHUNK
set to 16 in both packages for the test), ``moe_ffn`` with padded tokens.
Exact: the cache update's clamp and the top-k tie rule.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import golden as G  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

RTOL = 1e-5
TOL = G.load()["tolerance"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype="f32"):
    """The same array for both packages: (jax array, torch tensor)."""
    if dtype == "bf16":
        b = a.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(b),
                torch.from_numpy(b.view(np.uint16).view(np.int16)).view(
                    torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol,
                               atol=rtol * np.abs(_np(want)).max())


def _rel(got, want) -> float:
    w = _np(want)
    return float(np.abs(_np(got) - w).max() / np.abs(w).max())


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rms_norm_apply_rope_swiglu_f32(rng):
    xj, xt = _pair(rng.normal(0, 1, (2, 7, 64)).astype(np.float32))
    wj, wt = _pair(rng.normal(1, 0.1, (64,)).astype(np.float32))
    _close(TL.rms_norm(xt, wt), JL.rms_norm(xj, wj))
    qj, qt = _pair(rng.normal(0, 1, (2, 7, 4, 32)).astype(np.float32))
    for pos in (np.arange(7) + 3, np.arange(14).reshape(2, 7) * 5):
        pj, pt = _pair(pos.astype(np.int32))
        for theta in (10_000.0, 1_000_000.0):
            _close(TL.apply_rope(qt, pt, theta), JL.apply_rope(qj, pj, theta))
    ws = [_pair(rng.normal(0, 0.1, s).astype(np.float32))
          for s in ((64, 96), (64, 96), (96, 64))]
    _close(TL.swiglu(xt, *(w[1] for w in ws)),
           JL.swiglu(xj, *(w[0] for w in ws)))


def _qkv(rng, S, T, H=4, K=2, D=32):
    return (_pair(rng.normal(0, 1, (2, S, H, D)).astype(np.float32)),
            _pair(rng.normal(0, 1, (2, T, K, D)).astype(np.float32)),
            _pair(rng.normal(0, 1, (2, T, K, D)).astype(np.float32)))


@pytest.mark.parametrize("case", [
    # (S, T, causal, window, q_offset, valid_len)
    (40, 40, True, None, 0, 40),        # causal, 3 chunks (T padded to 48)
    (40, 40, True, 10, 0, 40),          # sliding window
    (40, 40, False, None, 0, 40),       # bidirectional (encoder)
    (3, 48, True, None, 20, 23),        # a partly valid cache, decode-like
    (1, 37, True, 8, 30, 31),           # one token, window, padded cache
])
def test_mha_online_f32(rng, case):
    S, T, causal, window, q_offset, valid_len = case
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, S, T)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              valid_len=valid_len, chunk=16)
    _close(TL.mha_online(qt, kt, vt, **kw), JL.mha_online(qj, kj, vj, **kw))


def test_mha_online_int8_f32(rng):
    """int8 values with per-(token, head) scales, dequantized per chunk."""
    S, T = 5, 40
    (qj, qt), _, _ = _qkv(rng, S, T)
    ints = [_pair(rng.integers(-127, 128, (2, T, 2, 32)).astype(np.int8))
            for _ in range(2)]
    scs = [_pair(rng.uniform(0.001, 0.05, (2, T, 2, 1)).astype(np.float32))
           for _ in range(2)]
    kw = dict(causal=True, window=None, q_offset=30, valid_len=35, chunk=16)
    got = TL.mha_online(qt, (ints[0][1], scs[0][1]), (ints[1][1], scs[1][1]),
                        **kw)
    want = JL.mha_online(qj, (ints[0][0], scs[0][0]),
                         (ints[1][0], scs[1][0]), **kw)
    _close(got, want)


@pytest.mark.parametrize("window", [6, 1 << 30])
def test_mha_dyn_window_f32(rng, window):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 3, 40)
    kw = dict(q_offset=17, valid_len=20, chunk=16)
    _close(TT._mha_dyn_window(qt, kt, vt, window, **kw),
           JT._mha_dyn_window(qj, kj, vj, jnp.int32(window), **kw))


def test_update_slice_clamps_as_dynamic_update_slice(rng):
    buf = rng.normal(0, 1, (2, 10, 3, 4)).astype(np.float32)
    val = rng.normal(0, 1, (2, 4, 3, 4)).astype(np.float32)
    for index in (0, 3, 6, 8, 50, -2):
        want = jax.lax.dynamic_update_slice(jnp.asarray(buf),
                                            jnp.asarray(val),
                                            (0, index, 0, 0))
        got = TL.update_slice(torch.from_numpy(buf.copy()),
                              torch.from_numpy(val), index)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_breaks_ties_by_the_lower_index():
    x = np.array([[0.125] * 8, [0.1, 0.3, 0.3, 0.1, 0.0, 0.3, 0.1, 0.0]],
                 np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 3)
    vt, it = TMOE._top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_causal_conv_bf16_both_forms(rng):
    xj, xt = _pair(rng.normal(0, 1, (2, 12, 64)).astype(np.float32), "bf16")
    wj, wt = _pair(rng.normal(0, 0.2, (4, 64)).astype(np.float32), "bf16")
    yt, _ = TS._causal_conv(xt, wt)
    yj, _ = JS._causal_conv(xj, wj)
    assert _rel(yt, yj) <= TOL["ssm"]
    sj, st = _pair(rng.normal(0, 1, (2, 3, 64)).astype(np.float32), "bf16")
    (yt, nt), (yj, nj) = (TS._causal_conv(xt[:, :1], wt, st),
                          JS._causal_conv(xj[:, :1], wj, sj))
    assert yt.dtype == torch.bfloat16 and nt.dtype == torch.bfloat16
    assert _rel(yt, yj) <= TOL["ssm"]
    np.testing.assert_array_equal(_np(nt), _np(nj))


def test_ssd_chunked_bf16_several_chunks(rng, monkeypatch):
    monkeypatch.setattr(JS, "CHUNK", 16)
    monkeypatch.setattr(TS, "CHUNK", 16)
    B, S, H, P, N = 2, 64, 4, 32, 16
    xj, xt = _pair(rng.normal(0, 1, (B, S, H, P)).astype(np.float32), "bf16")
    dj, dt_ = _pair(np.log1p(np.exp(rng.normal(-1, 0.5, (B, S, H))))
                    .astype(np.float32))
    aj, at = _pair(-np.exp(rng.normal(0, 0.3, (H,))).astype(np.float32))
    bj, bt = _pair(rng.normal(0, 1, (B, S, N)).astype(np.float32), "bf16")
    cj, ct = _pair(rng.normal(0, 1, (B, S, N)).astype(np.float32), "bf16")
    yt, st = TS.ssd_chunked(xt, dt_, at, bt, ct)
    yj, sj = JS.ssd_chunked(xj, dj, aj, bj, cj)
    assert yt.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert _rel(yt, yj) <= TOL["ssm"], _rel(yt, yj)
    assert _rel(st, sj) <= TOL["ssm"], _rel(st, sj)


def test_moe_ffn_bf16_padded_tokens():
    """T = 2 x 40 = 80 tokens: two groups of 64, the second padded."""
    arch = "llama4-maverick-400b-a17b"      # routed and shared experts
    cfg_j, cfg_t = JC.get_config(arch).reduced(), TC.get_config(arch).reduced()
    shapes = JM.abstract_params(cfg_j)["blocks"]["slot1"]["moe"]
    rng = np.random.default_rng(1)
    pj, pt = {}, {}
    for k, v in shapes.items():
        bf16 = v.dtype == jnp.bfloat16
        pj[k], pt[k] = _pair(rng.normal(0, 0.1 if k == "router" else 0.05,
                                        v.shape[1:]).astype(np.float32),
                             "bf16" if bf16 else "f32")
    xj, xt = _pair(rng.normal(0, 1, (2, 40, cfg_t.d_model))
                   .astype(np.float32), "bf16")
    yt, auxt = TMOE.moe_ffn(xt, pt, cfg_t)
    yj, auxj = jax.jit(JMOE.moe_ffn, static_argnums=2)(xj, pj, cfg_j)
    assert yt.dtype == torch.bfloat16 and yt.shape == (2, 40, cfg_t.d_model)
    assert _rel(yt, yj) <= TOL["moe"], _rel(yt, yj)
    assert abs(float(auxt) - float(auxj)) <= 1e-5
