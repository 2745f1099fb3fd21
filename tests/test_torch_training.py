"""Parity of the port's training loss and its gradients
(``Model.loss_fn``) with the reference's ``jax.value_and_grad``, one
reduced model a family, on the CPU, with the reference's weights bridged
into the port (float32).

Tolerances: the loss within 8 float32 ulps of its value (both sum the
same float32 forward in other orders; measured 0-3 ulps). Every gradient
leaf within 2e-5 of its largest magnitude (measured ~1.5e-6), or of 1e-4
of the whole tree's largest gradient where the leaf's own cancels below
that (an mLSTM input-gate bias sums terms of ~1e-4 to ~6e-11: what is
left is the rounding of those terms).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.api import batch_to, build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.training.loop import _value_and_grad  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

from conftest import reduced_model  # noqa: E402

# One arch a family: dense, moe (its load-balance loss counts), the two
# recurrent ones, vlm (the vision prefix skipped), audio (src_frames) and
# the CNN; and the sequence length each batch is drawn at.
FAMILIES = [("olmo-1b", 16), ("grok-1-314b", 16), ("xlstm-1.3b", 16),
            ("zamba2-2.7b", 16), ("qwen2-vl-7b", 32),
            ("seamless-m4t-large-v2", 16), ("resnet50", 0)]


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


@pytest.mark.parametrize("arch,seq", FAMILIES)
def test_loss_and_gradients_match_reference(arch, seq):
    jm, jp, m, p = _port(arch)
    batch = jmake_batch(jm.cfg, 2, seq, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp,
                                                             _jbatch(batch))
    loss, grads = _value_and_grad(m.loss_fn, p, batch_to(batch, "cpu"))
    assert loss.dtype == torch.float32 and loss.ndim == 0
    jl = np.float32(jloss)
    assert abs(float(loss) - float(jl)) <= 8 * float(np.spacing(jl))
    pairs = _pairs(grads, jgrads)
    top = max(float(np.abs(j).max()) for _, j in pairs)
    assert top > 0
    for t, j in pairs:
        scale = max(float(np.abs(j).max()), 1e-4 * top)
        assert float(np.abs(t.double().numpy() - j).max()) <= 2e-5 * scale
    # Outside a step the parameters take no gradients.
    assert not any(x.requires_grad for x in tree_leaves(p))


def test_moe_loss_counts_the_load_balance_loss():
    """grok's loss is the next-token loss plus router_aux_loss times the
    blocks' load-balance losses: with the weight at zero it drops by
    exactly that term, which is positive."""
    _, _, m, p = _port("grok-1-314b")
    batch = batch_to(jmake_batch(m.cfg, 2, 16, seed=1), "cpu")
    with torch.no_grad():
        full = m.loss_fn(p, batch)
        bare = build_model(m.cfg.replace(router_aux_loss=0.0)).loss_fn(p,
                                                                      batch)
    assert float(full - bare) > 0




def test_serving_forwards_skip_the_load_balance_loss(monkeypatch):
    """Only the loss asks for the MoE blocks' load-balance loss: prefill,
    the one-shot split and the forward compute none (their outputs are
    unchanged), and the loss computes one a block."""
    import repro_torch.models.blocks as blk

    _, _, m, p = _port("grok-1-314b")
    batch = batch_to(jmake_batch(m.cfg, 2, 16, seed=1), "cpu")
    calls = []
    real = blk.load_balance_loss
    monkeypatch.setattr(blk, "load_balance_loss",
                        lambda routing: calls.append(1) or real(routing))
    with torch.no_grad():
        logits = m.forward(p, batch)
        pre, caches = m.prefill(p, batch, cache_len=20)
        boundary = m.run_head(p, batch, 1)
        tail = m.run_tail(p, boundary, 1)
        assert calls == []
        m.loss_fn(p, batch)
    assert len(calls) == m.cfg.num_layers
    assert torch.equal(pre, logits) and torch.equal(tail, logits)
    assert caches is not None
