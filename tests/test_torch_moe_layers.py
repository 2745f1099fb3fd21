"""Parity of the port's Mixture-of-Experts layer with the reference's, on
the CPU.

The same numpy inputs (from a seed) and the same weights (the port's
initializer from a seed, handed to the reference as arrays) go through
the jitted reference ``repro.models.layers.moe.apply_moe`` and the port's
``repro_torch.models.layers.moe.apply_moe``, at the reduced widths of
``grok-1-314b`` (d_model 256, 4 experts, top-2, expert FFN 512) and
``llama4-maverick-400b-a17b`` (4 experts, top-1), at S = 1, 7, 32 and 512
tokens a row (512: two groups of 256; 7: one group of 7).

Routing is held equal, not close: expert ids, slots and the kept mask.
It is compared on router logits fed to both packages (the router is a 0/1
selection of the input's first E channels, so the logits are those
channels exactly in both): the router product's sum order, which differs
between the packages, cannot then decide a float32 near-tie. The one
step that is not bit for bit is the softmax's ``exp``: XLA's CPU ``exp``
is a polynomial that differs from PyTorch's (and from the correctly
rounded one) by an ulp on ~7 % of inputs, so the probabilities, and the
renormalized weights, are held within ``WEIGHT_ULPS`` float32 ulps
(measured 2). Everything after the softmax (top-k with ties to the lower
index, the renormalization, the slots and the drop) is held bit for bit
on the reference's own probabilities (``moe.select``).

Tolerances: in float32 the expert products sum in other orders (cuBLAS /
MKL against XLA), so ``y`` agrees within ``RTOL`` of its scale (measured
up to 7.4e-7) and the load-balance loss within ``AUX_ATOL`` (measured
1.2e-7). In bfloat16 both round each expert product to bfloat16 after
summing it in float32 in their own order, so an element moves by at most
a few bfloat16 ulps: ``BF16_RTOL`` of the scale, 2^-7 (measured 2.5e-3).
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jget_config  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.init import materialize  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402


RTOL = 1e-5
AUX_ATOL = 1e-6
BF16_RTOL = 2.0 ** -7
WEIGHT_ULPS = 4
ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
SEQS = (1, 7, 32, 512)
_JIT_MOE = jax.jit(jmoe.apply_moe, static_argnums=(2, 3))


@partial(jax.jit, static_argnums=(1, 2))
def _ref_routing(logits, cfg, capacity_factor):
    """The reference's routing, from its router logits on: the lines of
    ``repro.models.layers.moe.apply_moe`` up to ``within``, read out as
    (probs, ids, weights, slot of each choice, kept) of shape (B, S, k)."""
    b, s, e = logits.shape
    k = cfg.experts_per_token
    g = min(jmoe.DEFAULT_GROUP, s)
    if s % g:
        g = s
    ng = s // g
    cap = jmoe.expert_capacity(g, cfg, capacity_factor)
    probs = jax.nn.softmax(logits, axis=-1)
    top_w, top_ids = jax.lax.top_k(probs, k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    sel = jax.nn.one_hot(top_ids.reshape(b, ng, g, k), e, dtype=jnp.int32)
    pos = jnp.cumsum(sel.reshape(b, ng, g * k, e), axis=2) - 1
    pos = pos.reshape(b, ng, g, k, e)
    within = (pos < cap) & (sel > 0)
    slot = (pos * sel).sum(-1).reshape(b, s, k)
    kept = within.any(-1).reshape(b, s, k)
    return probs, top_ids, top_w, slot, kept


def _layer(arch, dtype=torch.float32, seed=0):
    """(reference cfg, port cfg, reference params, port params): the port's
    spec sampled from ``seed`` (the experts in ``dtype``, the router in
    float32 as the spec says), the same values as jax arrays."""
    cfg = get_config(arch).reduced()
    tp = materialize(moe.moe_spec(cfg), seed, "cpu")
    tp = {k: v if k == "router" else v.to(dtype) for k, v in tp.items()}
    jp = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.float32 if k == "router" else _jdt(dtype)) for k, v in tp.items()}
    return jget_config(arch).reduced(), cfg, jp, tp


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _x(cfg, b, s, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    return jnp.asarray(tx.float().numpy()).astype(_jdt(dtype)), tx


def _rel(port, ref):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    return np.max(np.abs(port.detach().float().numpy() - ref)) / max(
        np.max(np.abs(ref)), 1e-30)


def _fed(cfg, tp, jp, logits):
    """Inputs whose router logits are exactly ``logits`` (B, S, E) in both
    packages: the router selects the first E channels of x, which hold
    the logits; the other channels stay random."""
    b, s, e = logits.shape
    x = np.random.default_rng(9).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    x[..., :e] = logits
    sel = np.zeros((cfg.d_model, e), np.float32)
    sel[np.arange(e), np.arange(e)] = 1.0
    tp = dict(tp, router=torch.from_numpy(sel))
    jp = dict(jp, router=jnp.asarray(sel))
    return x, tp, jp


def _ulps(a, b):
    """Largest distance in float32 ulps between two arrays of one sign."""
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64)
                             - b.view(np.int32).astype(np.int64))))


def _assert_routing_equal(r, ref, bitwise=False):
    """ids, slots and the kept mask equal; probabilities and weights equal
    bit for bit when ``bitwise`` (the reference's own probabilities went
    in), else within WEIGHT_ULPS."""
    probs, ids, w, slot, kept = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    limit = 0 if bitwise else WEIGHT_ULPS
    assert _ulps(r.weights.numpy(), w) <= limit
    assert _ulps(r.probs.numpy(), probs) <= limit


def _check_fed(arch, b, s, logits, capacity_factor):
    """Route ``logits`` in both packages (the port's own route, and the
    routing its apply_moe took on the fed input): equal. Then y and the
    loss of both apply_moe on that input. Returns the port's routing."""
    jcfg, cfg, jp, tp = _layer(arch)
    x, tp, jp = _fed(cfg, tp, jp, logits)
    ref = _ref_routing(jnp.asarray(logits), jcfg, capacity_factor)
    r = moe.route(torch.from_numpy(logits), cfg, capacity_factor)
    _assert_routing_equal(r, ref)
    on_ref_probs = moe.select(torch.from_numpy(np.array(ref[0])), cfg,
                              capacity_factor)
    _assert_routing_equal(on_ref_probs, ref, bitwise=True)
    with moe.record_routing() as seen:
        y, aux = moe.apply_moe(tp, torch.from_numpy(x), cfg, capacity_factor)
    assert len(seen) == 1
    _assert_routing_equal(seen[0], ref)
    jy, jaux = _JIT_MOE(jp, jnp.asarray(x), jcfg, capacity_factor)
    assert _rel(y, jy) < RTOL
    assert abs(float(aux) - float(jaux)) < AUX_ATOL
    return r


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", SEQS)
def test_routing_equals_reference_on_fed_logits(arch, s):
    """ids, slots and the kept mask equal the reference's, the weights
    too (bits) on its probabilities, at capacity factor 1.25: two groups
    of 256 at S = 512."""
    e = get_config(arch).reduced().num_experts
    logits = np.random.default_rng(s).standard_normal(
        (2, s, e)).astype(np.float32)
    r = _check_fed(arch, 2, s, logits, 1.25)
    g = min(256, s)
    assert r.capacity == moe.expert_capacity(g, get_config(arch).reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_drops_past_capacity_like_the_reference(arch):
    """A router biased toward expert 0 at capacity factor 0.25: many
    choices are dropped, the same ones in both packages (token-major,
    then choice-rank order), and the dropped weight is lost from y."""
    e = get_config(arch).reduced().num_experts
    logits = np.random.default_rng(5).standard_normal(
        (2, 64, e)).astype(np.float32)
    logits[..., 0] += 3.0
    r = _check_fed(arch, 2, 64, logits, 0.25)
    assert moe.dropped_choices(r) > 0
    # The kept choices of each expert are the first `capacity` of its
    # group in token-major, choice-rank order.
    ids, kept = r.ids.numpy(), r.kept.numpy()
    for b in range(2):
        seen = np.zeros(e, int)
        for t in range(64):
            for j in range(ids.shape[-1]):
                want = seen[ids[b, t, j]] < r.capacity
                assert kept[b, t, j] == want
                seen[ids[b, t, j]] += 1


@pytest.mark.parametrize("arch", ARCHS)
def test_equal_logits_choose_the_lowest_experts(arch):
    """With every logit equal, lax.top_k chooses experts 0..k-1 with equal
    weights; the port's stable sort chooses the same."""
    cfg = get_config(arch).reduced()
    logits = np.zeros((1, 3, cfg.num_experts), np.float32)
    r = _check_fed(arch, 1, 3, logits, 1.25)
    k = cfg.experts_per_token
    assert (r.ids.numpy() == np.arange(k)).all()
    assert (r.weights.numpy() == np.float32(1.0 / k)).all()


# ---------------------------------------------------------------------------
# The layer's output
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", SEQS)
def test_apply_moe_matches_reference_float32(arch, s):
    jcfg, cfg, jp, tp = _layer(arch)
    jx, tx = _x(cfg, 2, s, seed=s)
    jy, jaux = _JIT_MOE(jp, jx, jcfg, 1.25)
    y, aux = moe.apply_moe(tp, tx, cfg)
    assert y.shape == tx.shape and y.dtype == torch.float32
    assert _rel(y, jy) < RTOL
    assert abs(float(aux) - float(jaux)) < AUX_ATOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", (7, 512))
def test_apply_moe_matches_reference_bfloat16(arch, s):
    jcfg, cfg, jp, tp = _layer(arch, torch.bfloat16)
    jx, tx = _x(cfg, 2, s, seed=s, dtype=torch.bfloat16)
    jy, jaux = _JIT_MOE(jp, jx, jcfg, 1.25)
    y, aux = moe.apply_moe(tp, tx, cfg)
    assert y.dtype == torch.bfloat16
    assert _rel(y, jy) < BF16_RTOL
    assert abs(float(aux) - float(jaux)) < AUX_ATOL


def test_capacity_and_groups():
    """The reference's capacity rule and group split, at reduced and full
    width: full-width grok at a 256-token group has 80 slots an expert,
    llama4 8; a one-token decode group has 8."""
    for arch in ARCHS:
        for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                          (get_config(arch).reduced(),
                           jget_config(arch).reduced())):
            for g in (1, 7, 32, 256):
                for cf in (0.25, 1.25):
                    assert moe.expert_capacity(g, cfg, cf) == \
                        jmoe.expert_capacity(g, jcfg, cf)
    assert moe.expert_capacity(256, get_config("grok-1-314b")) == 80
    assert moe.expert_capacity(
        256, get_config("llama4-maverick-400b-a17b")) == 8
    assert moe.expert_capacity(1, get_config("grok-1-314b")) == 8
    assert [moe.group_shape(s) for s in (1, 7, 256, 300, 512)] == [
        (1, 1), (7, 1), (256, 1), (300, 1), (256, 2)]


def test_rows_route_alone():
    """Groups run within a row: each row's output equals that row run
    alone in a batch of the same size (the other rows zero), so one
    request's experts never depend on another's routing."""
    _, cfg, _, tp = _layer("grok-1-314b")
    _, tx = _x(cfg, 3, 32, seed=2)
    y, _ = moe.apply_moe(tp, tx, cfg)
    for r in range(3):
        alone = torch.zeros_like(tx)
        alone[r] = tx[r]
        ya, _ = moe.apply_moe(tp, alone, cfg)
        torch.testing.assert_close(ya[r], y[r], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_is_apply_moe_without_the_loss(arch):
    """moe_forward (what the blocks call) gives apply_moe's output bits and
    the routing whose load_balance_loss is apply_moe's loss."""
    _, cfg, _, tp = _layer(arch)
    _, tx = _x(cfg, 2, 32, seed=3)
    y, aux = moe.apply_moe(tp, tx, cfg)
    y2, r = moe.moe_forward(tp, tx, cfg)
    assert torch.equal(y, y2)
    assert torch.equal(moe.load_balance_loss(r), aux)


def test_record_routing_sees_only_its_own_thread():
    """A record_routing() block collects the layers its thread runs, not
    those another thread runs meanwhile (a threaded server's)."""
    import threading

    _, cfg, _, tp = _layer("grok-1-314b")
    _, tx = _x(cfg, 1, 7, seed=4)
    with moe.record_routing() as seen:
        t = threading.Thread(target=moe.moe_forward, args=(tp, tx, cfg))
        t.start()
        t.join()
        assert seen == []
        moe.moe_forward(tp, tx, cfg)
    assert len(seen) == 1 and seen[0].ids.shape == (1, 7, 2)
