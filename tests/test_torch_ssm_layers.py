"""Parity of the port's recurrent layers (Mamba2, mLSTM, sLSTM) with the
reference's, on the CPU.

The same numpy inputs (from a seed) and the same weights (the port's
initializer from a seed, handed to the reference as arrays) go through
each JAX function and its counterpart in
``repro_torch.models.layers``, at the reduced widths of ``zamba2-2.7b``
(d_model 256, 8 Mamba2 heads of 64, state 16) and ``xlstm-1.3b`` (d_model
256, 4 heads; mLSTM head_dim 128, sLSTM 64).

Tolerance: both packages compute the same float32 recurrences, but sum the
matrix products, the chunked SSD's einsums and the cumulative sums in
other orders, so outputs and final states agree within ``RTOL`` of their
scale (measured up to 1.3e-6 here). One exception: the chunked SSD's final
state decays by ``exp(a_cs[-1] - a_cs)``, where ``a_cs`` is a cumulative
sum over the 256-step chunk that reaches |a_cs| ~ 180 here; XLA and
PyTorch sum it in other orders, and one float32 ulp at that magnitude
(1.5e-5) is a relative error of the decay. So that state is held to
``CHUNK_STATE_RTOL`` (measured 1.45e-5); the outputs of the same call
stay within RTOL. Inside the port, the chunked SSD equals the sequential
scan, and a prefill of S tokens plus one decode step equals a prefill of
S + 1, within RTOL.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jget_config  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.layers import mamba2 as jmamba  # noqa: E402
from repro.models.layers import xlstm as jxlstm  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.init import materialize  # noqa: E402
from repro_torch.models.layers import mamba2 as mamba  # noqa: E402
from repro_torch.models.layers import xlstm  # noqa: E402


RTOL = 1e-5
CHUNK_STATE_RTOL = 5e-5


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    got = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)


def _layer(arch, spec_fn, seed):
    """(reference cfg, port cfg, reference params, port params): the port's
    spec sampled from ``seed``, the same values as jax arrays."""
    cfg = get_config(arch).reduced()
    tp = materialize(spec_fn(cfg), seed, "cpu")
    return (jget_config(arch).reduced(), cfg,
            {k: jnp.asarray(v.numpy()) for k, v in tp.items()}, tp)


@pytest.fixture(scope="module")
def mamba_layer():
    return _layer("zamba2-2.7b", mamba.mamba2_spec, 1)


def _x(rng, b, s, d, scale=1.0):
    return (rng.standard_normal((b, s, d)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,branch", [(7, "sequential"), (512, "chunked")])
def test_mamba2_matches_reference(mamba_layer, seq, branch):
    """``apply_mamba2`` and the stateful prefill (the reference's
    ``blocks._mamba_seq_with_state``) on both SSD branches: a 512-token
    input takes the chunked one (a multiple of the 256 chunk, longer than
    it), a 7-token one the sequential scan. Output and final state (SSM
    state, conv tail) within RTOL."""
    jcfg, cfg, jp, tp = mamba_layer
    x = _x(np.random.default_rng(seq), 1, seq, cfg.d_model)
    ref = jmamba.apply_mamba2(jp, jnp.asarray(x), jcfg)
    jy, jstate = jblocks._mamba_seq_with_state(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        y, state = mamba.mamba2_seq(tp, torch.from_numpy(x), cfg)
        assert torch.equal(mamba.apply_mamba2(tp, torch.from_numpy(x), cfg),
                           y)
    assert _rel(y, ref) <= RTOL and _rel(y, jy) <= RTOL
    assert _rel(state.ssm, jstate.ssm) <= (
        CHUNK_STATE_RTOL if branch == "chunked" else RTOL)
    assert _rel(state.conv, jstate.conv) <= RTOL
    assert state.ssm.dtype == torch.float32


def test_decode_mamba2_steps_match_reference(mamba_layer):
    """Four one-token decodes from a prefill state, each step's output and
    state against the reference's."""
    jcfg, cfg, jp, tp = mamba_layer
    rng = np.random.default_rng(3)
    x = _x(rng, 2, 5, cfg.d_model)
    _, jst = jblocks._mamba_seq_with_state(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        _, st = mamba.mamba2_seq(tp, torch.from_numpy(x), cfg)
        for _ in range(4):
            xt = _x(rng, 2, 1, cfg.d_model)
            jy, jst = jmamba.decode_mamba2(jp, jnp.asarray(xt), jst, jcfg)
            y, st = mamba.decode_mamba2(tp, torch.from_numpy(xt), st, cfg)
            assert _rel(y, jy) <= RTOL
            assert _rel(st.ssm, jst.ssm) <= RTOL
            assert _rel(st.conv, jst.conv) <= RTOL


def test_ssd_chunked_equals_sequential():
    """Port-internal: the chunked SSD (intra-chunk quadratic term plus the
    carried chunk states) against the recurrence, from a non-zero initial
    state, outputs and final states."""
    rng = np.random.default_rng(4)
    b, l, h, p, n = 2, 192, 3, 8, 5
    x = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.3, (b, l, h)).astype(
        np.float32))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, h).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((b, l, n)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((b, l, n)).astype(np.float32))
    S0 = torch.from_numpy(rng.standard_normal((b, h, n, p)).astype(
        np.float32))
    y_c, s_c = mamba.ssd_chunked(x, dt, A, B, C, 64, S0)
    y_s, s_s = mamba.ssd_sequential(x, dt, A, B, C, S0)
    assert _rel(y_c, y_s.numpy()) <= RTOL
    assert _rel(s_c, s_s.numpy()) <= RTOL
    with pytest.raises(ValueError, match="not divisible"):
        mamba.ssd_chunked(x[:, :100], dt[:, :100], A, B[:, :100],
                          C[:, :100], 64)
    # The mask above the diagonal is exactly -inf, so its exp is exactly 0.
    seg = mamba._segsum(torch.ones(4))
    assert torch.isneginf(seg[torch.triu(torch.ones(4, 4), 1) > 0]).all()
    assert (torch.exp(seg).triu(1) == 0).all()


@pytest.mark.parametrize("seq", [2, 7, 511, 512])
def test_prefill_plus_decode_equals_longer_prefill(mamba_layer, seq):
    """The state after a prefill of S tokens plus one decode gives the next
    output of a prefill of S + 1: a prompt shorter than the conv window
    (its tail left-padded), a sequential one, and the chunked branch on
    either side (511 + 1 against a chunked 512; a chunked 512 + 1 against
    a sequential 513)."""
    _, cfg, _, tp = mamba_layer
    x = torch.from_numpy(_x(np.random.default_rng(seq), 1, seq + 1,
                            cfg.d_model))
    with torch.no_grad():
        _, st = mamba.mamba2_seq(tp, x[:, :seq], cfg)
        y1, st1 = mamba.decode_mamba2(tp, x[:, seq:], st, cfg)
        y_all, st_all = mamba.mamba2_seq(tp, x, cfg)
    assert _rel(y1, y_all[:, -1:].numpy()) <= RTOL
    assert _rel(st1.ssm, st_all.ssm.numpy()) <= RTOL
    assert _rel(st1.conv, st_all.conv.numpy()) <= RTOL


# ---------------------------------------------------------------------------
# mLSTM and sLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_layer_matches_reference(kind):
    """A 6-token prefill from the initial state, then a one-token step
    from the carried state: outputs and every state leaf (C, n, m, the
    conv window; c, n, hid, m for sLSTM) within RTOL."""
    spec = xlstm.mlstm_spec if kind == "mlstm" else xlstm.slstm_spec
    jcfg, cfg, jp, tp = _layer("xlstm-1.3b", spec, 2)
    japply = jxlstm.apply_mlstm if kind == "mlstm" else jxlstm.apply_slstm
    apply = xlstm.apply_mlstm if kind == "mlstm" else xlstm.apply_slstm
    rng = np.random.default_rng(5)
    jstate = state = None
    for s in (6, 1):
        x = _x(rng, 2, s, cfg.d_model)
        jy, jstate = japply(jp, jnp.asarray(x), jcfg, jstate)
        with torch.no_grad():
            y, state = apply(tp, torch.from_numpy(x), cfg, state)
        assert _rel(y, jy) <= RTOL
        for name in state._fields:
            got, ref = getattr(state, name), getattr(jstate, name)
            assert got.dtype == (torch.float32 if name != "conv"
                                 else torch.from_numpy(x).dtype)
            assert _rel(got, ref) <= RTOL, name


def test_xlstm_initial_states():
    """States start at zero, the stabilizer ``m`` at -1e30, in float32
    whatever the model dtype; the conv window in the model dtype."""
    cfg = get_config("xlstm-1.3b").reduced()
    jcfg = jget_config("xlstm-1.3b").reduced()
    for init, jinit in ((xlstm.init_mlstm_state, jxlstm.init_mlstm_state),
                        (xlstm.init_slstm_state, jxlstm.init_slstm_state)):
        st = init(cfg, 3, torch.bfloat16)
        jst = jinit(jcfg, 3, jnp.bfloat16)
        for name in st._fields:
            got, ref = getattr(st, name), np.asarray(getattr(jst, name),
                                                     np.float32)
            assert tuple(got.shape) == ref.shape
            np.testing.assert_array_equal(got.float().numpy(), ref)
            assert (got.dtype == torch.bfloat16) == (name == "conv")
