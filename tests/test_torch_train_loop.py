"""Parity of the port's optimizer and training loop with the
reference's, on the CPU: AdamW (``optim/adamw.py``), the train step with
microbatches and every rematerialization mode (``training/loop.py``),
and ``train()``. The reduced models run in float32 with the reference's
weights bridged into the port.

Tolerances, each measured against what the two packages can agree on:

* AdamW from identical gradients: the learning rate bitwise; the global
  norm within 1e-5 of its value (10^6 squares summed in other orders);
  float32 moments and parameters within 4e-7 of each leaf's largest
  magnitude (~3 ulps, from the norm's clipping scale and XLA's pow);
  bfloat16 parameters within one bfloat16 ulp of each value, the
  reference run eagerly (jitted, XLA keeps bfloat16 intermediates in
  float32: ``xla_allow_excess_precision``).
* A train step against the reference's jitted one: loss within 1e-6 of
  its value; the float32 moments after the step, which hold the
  accumulated, clipped gradient (mu = 0.1 g, nu = 0.05 g^2), within
  ``MOMENT_RTOL`` of each leaf's largest magnitude (measured up to
  1.4e-6, ~12 ulps: gradients and the clipping norm summed in other
  orders, nu squaring them; half the batch or a lost 1/mb moves them by
  O(1)); and, coarsely, every parameter within 2.5 learning rates of
  the reference's, since AdamW's first step moves a parameter by about
  the learning rate whatever its gradient's size.
* Inside the port, every remat mode equals ``"none"`` bit for bit (the
  same operations, recomputed), and four microbatches equal one batch:
  loss within 1e-6, moments within ``MOMENT_RTOL``, parameters within
  2.5 learning rates.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training.loop import make_train_step as jmake_train_step  # noqa: E402,E501
from repro_torch.config import TrainConfig, get_config  # noqa: E402
from repro_torch.data.synthetic import ShardedLoader  # noqa: E402
from repro_torch.models.api import batch_to, build_model  # noqa: E402
from repro_torch.models.bridge import (  # noqa: E402
    opt_state_from_numpy,
    params_from_numpy,
)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training.loop import (  # noqa: E402
    REMAT_MODES,
    make_loss_fn,
    make_train_step,
    train,
)
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

from conftest import reduced_model  # noqa: E402

MOMENT_RTOL = 4e-6

def _port(arch):
    jmodel, jparams = reduced_model(arch)
    return (jmodel, jparams, build_model(get_config(arch).reduced()),
            params_from_numpy(jax.device_get(jparams), "cpu"))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pairs(ttree, jtree):
    """(port leaf, reference leaf as float64) in the reference's order."""
    tl, jl = tree_leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == tuple(np.shape(j))
    return [(t, np.asarray(j, np.float64)) for t, j in zip(tl, jl)]


def _rel(t, j):
    return float(np.abs(t.double().numpy() - j).max()
                 / max(float(np.abs(j).max()), 1e-30))


def _grads_like(jparams, seed, dtype=None):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.05).astype(
            dtype or a.dtype), jax.device_get(jparams))


def _bf16_ulps(t, j):
    """Largest distance in bfloat16 ulps between two bfloat16 trees."""
    a = t.view(torch.int16).numpy().astype(np.int64)
    b = np.asarray(j).view(np.int16).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_reference_from_identical_gradients(steps):
    _, jp, _, p = _port("olmo-1b")
    kw = dict(warmup_steps=2, total_steps=10, learning_rate=1e-2)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jstate, state = jadamw.init_state(jp), adamw.init_state(p)
    for s in range(steps):
        g = _grads_like(jp, s)
        jp, jstate, jmet = jax.jit(jadamw.apply_updates, static_argnums=3)(
            jp, jax.tree.map(jnp.asarray, g), jstate, jtc)
        p, state, met = adamw.apply_updates(p, params_from_numpy(g, "cpu"),
                                            state, tc)
        assert int(state.step) == int(jstate.step) == s + 1
        assert np.float32(met["lr"].item()) == np.float32(jmet["lr"])
        jn = float(jmet["grad_norm"])
        assert abs(float(met["grad_norm"]) - jn) <= 1e-5 * jn
        for tree, jtree in ((p, jp), (state.mu, jstate.mu),
                            (state.nu, jstate.nu)):
            for t, j in _pairs(tree, jtree):
                assert t.dtype == torch.float32
                assert _rel(t, j) <= 4e-7


def test_adamw_bfloat16_params_match_eager_reference():
    _, jp, _, _ = _port("olmo-1b")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    p = params_from_numpy(jax.device_get(jp), "cpu")
    tc = TrainConfig(warmup_steps=2, total_steps=10, learning_rate=1e-2)
    jtc = JTrainConfig(warmup_steps=2, total_steps=10, learning_rate=1e-2)
    jstate, state = jadamw.init_state(jp), adamw.init_state(p)
    ids = [id(x) for x in tree_leaves(p)]
    for s in range(2):
        g = _grads_like(jp, s)
        jp, jstate, _ = jadamw.apply_updates(
            jp, jax.tree.map(jnp.asarray, g), jstate, jtc)
        p, state, _ = adamw.apply_updates(p, params_from_numpy(g, "cpu"),
                                          state, tc)
    # In place: the same tensors, overwritten.
    assert [id(x) for x in tree_leaves(p)] == ids
    for t, j in zip(tree_leaves(p), jax.tree.leaves(jp)):
        assert t.dtype == torch.bfloat16
        assert _bf16_ulps(t, j) <= 1
    for t, j in _pairs(state.mu, jstate.mu) + _pairs(state.nu, jstate.nu):
        assert _rel(t, j) <= 4e-7


def test_adamw_state_crosses_from_the_reference():
    _, jp, _, p = _port("olmo-1b")
    tc, jtc = TrainConfig(), JTrainConfig()
    g = _grads_like(jp, 7)
    _, jstate, _ = jax.jit(jadamw.apply_updates, static_argnums=3)(
        jp, jax.tree.map(jnp.asarray, g), jadamw.init_state(jp), jtc)
    state = opt_state_from_numpy(jax.device_get(jstate), "cpu")
    assert state.step.dtype == torch.int32 and int(state.step) == 1
    for t, j in _pairs(state.mu, jstate.mu) + _pairs(state.nu, jstate.nu):
        np.testing.assert_array_equal(t.numpy(), j.astype(np.float32))
    assert tc == TrainConfig(**{f: getattr(jtc, f)
                                for f in jtc.__dataclass_fields__})


def _step(model, params, batch, **kw):
    params = tree_map(torch.clone, params)
    state = adamw.init_state(params)
    return make_train_step(model, TrainConfig(**kw))(params, state, batch)


@pytest.mark.parametrize("arch", ["olmo-1b", "grok-1-314b"])
def test_train_step_remat_microbatches_and_reference(arch):
    jm, jp, m, p = _port(arch)
    raw = jmake_batch(jm.cfg, 8, 16, seed=0)
    batch = batch_to(raw, "cpu")
    lr = float(adamw.cosine_lr(TrainConfig(), torch.tensor(1)))
    out = {}
    for remat in REMAT_MODES:
        for mb in (1, 4):
            out[remat, mb] = _step(m, p, batch, remat=remat, microbatches=mb)
    for (remat, mb), (tp, state, met) in out.items():
        base_p, _, base_met = out["none", mb]
        assert torch.equal(met["loss"], base_met["loss"]), remat
        for a, b in zip(tree_leaves(tp), tree_leaves(base_p)):
            assert torch.equal(a, b), (remat, mb)
    one, four = out["none", 1], out["none", 4]
    assert abs(float(four[2]["loss"]) - float(one[2]["loss"])) <= \
        1e-6 * float(one[2]["loss"])
    # The moments hold the clipped gradient itself (mu = 0.1 g, nu =
    # 0.05 g^2 after one step): microbatched against one batch.
    for field in ("mu", "nu"):
        for a, b in zip(tree_leaves(getattr(four[1], field)),
                        tree_leaves(getattr(one[1], field))):
            assert _rel(a, b.double().numpy()) <= MOMENT_RTOL, field
    for a, b in zip(tree_leaves(four[0]), tree_leaves(one[0])):
        assert float((a - b).abs().max()) <= 2.5 * lr
    for mb in (1, 4):
        jstep = jax.jit(jmake_train_step(jm, JTrainConfig(microbatches=mb)))
        jpp, jstate, jmet = jstep(jp, jadamw.init_state(jp), _jbatch(raw))
        tp, state, met = out["none", mb]
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
            1e-6 * float(jmet["loss"])
        assert int(state.step) == int(jstate.step) == 1
        for t, j in (_pairs(state.mu, jstate.mu)
                     + _pairs(state.nu, jstate.nu)):
            assert _rel(t, j) <= MOMENT_RTOL, (mb, t.shape)
        for t, j in _pairs(tp, jpp):
            assert float(np.abs(t.double().numpy() - j).max()) <= 2.5 * lr


def test_make_loss_fn_rejects_an_unknown_mode():
    _, _, m, _ = _port("olmo-1b")
    with pytest.raises(ValueError, match="remat"):
        make_loss_fn(m, "everything")
    assert make_loss_fn(m, "blocks").__self__.cfg.block_remat


def test_loss_decreases_on_learnable_stream():
    """The reference's own check, on the port: reduced olmo with a
    128-token vocabulary, 40 steps."""
    cfg = get_config("olmo-1b").reduced().replace(vocab_size=128)
    model = build_model(cfg)
    tc = TrainConfig(learning_rate=3e-3, total_steps=40, warmup_steps=4,
                     log_every=0)
    loader = ShardedLoader(cfg, global_batch=8, seq_len=32, seed=0)
    res = train(model, tc, loader, num_steps=40, device="cpu")
    assert len(res.losses) == len(res.step_s) == 40
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.1, (first, last)
    assert int(res.opt_state.step) == 40
    assert res.steps_per_sec > 0
    assert not any(x.requires_grad for x in tree_leaves(res.params))
