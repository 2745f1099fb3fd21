"""The port's chunked attention with its recomputing backward
(``models/layers/attention.py`` ``chunked_attention``, the counterpart of
the reference's ``_flash`` custom VJP), against the reference on the CPU.

* **Gradients** of the reference test's cases (causal, windowed, GQA;
  several query and key chunks) equal ``jax.grad`` through the
  reference's ``chunked_attention`` within 2e-4 (rtol and atol) in
  float32, as the reference's own test holds its flash gradients against
  its dense ones; ``prefill_attention`` with the dense threshold lowered
  takes the same path.
* **The forward is unchanged**: with a gradient asked for, the output is
  the no-grad loop's bit for bit.
* **What the backward keeps** grows with S, not S^2. One causal call
  with 128-wide chunks: the bytes packed by ``saved_tensors_hooks`` grow
  at most 2.2x from S = 512 to 1,024 (autograd through the forward loop
  alone grows 3.9x). A reduced olmo-1b loss, with the port's
  ``prefill_attention`` monkeypatched here to take the chunked path at
  these lengths, under each of the four remat modes: the bytes the
  forward leaves alive for the backward (every buffer an op made, still
  referenced once the loss is out: saved tensors, a selective
  checkpoint's kept products, checkpoint inputs) grow at most 2.2x too.
  Under ``remat="dots"`` that holds only because the policy keeps no
  product that runs with gradients off.
* **A whole loss** at a sequence that takes the chunked path (1 x 3,072
  tokens, past the 2,048 dense threshold): reduced olmo-1b's loss and
  every gradient leaf against ``jax.value_and_grad`` of the reference's,
  at ``tests/test_torch_training.py``'s tolerances.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.api import batch_to, build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.layers import attention as attn  # noqa: E402
from repro_torch.training.loop import (  # noqa: E402
    REMAT_MODES,
    _value_and_grad,
    make_loss_fn,
)
from repro_torch.utils.tree import tree_leaves  # noqa: E402

from conftest import reduced_model  # noqa: E402

# The reference test's gradient cases (tests/test_attention.py): batch,
# seq, heads, kv heads, head dim, causal, window; chunks of 64.
CASES = [
    (2, 256, 4, 2, 16, True, 0),
    (1, 256, 4, 4, 16, False, 0),
    (2, 256, 8, 2, 16, True, 64),
]
CHUNK = 64
GRAD_TOL = 2e-4
GROWTH = 2.2          # bytes kept at S = 1,024 over S = 512, at most
LONG_SEQ = 3072       # past prefill_attention's dense threshold


def _qkv(b, s, h, kv, hd, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, hd).astype(np.float32),
            rng.randn(b, s, kv, hd).astype(np.float32),
            rng.randn(b, s, kv, hd).astype(np.float32))


def _jax_grads(q, k, v, causal, window):
    def f(q, k, v):
        o = jattn.chunked_attention(q, k, v, causal=causal, window=window,
                                    q_chunk=CHUNK, kv_chunk=CHUNK)
        return (o ** 2).sum()
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _torch_grads(fn, q, k, v):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (fn(tq, tk, tv) ** 2).sum().backward()
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES)
def test_gradients_match_jax_grad(b, s, h, kv, hd, causal, window):
    q, k, v = _qkv(b, s, h, kv, hd)
    want = _jax_grads(q, k, v, causal, window)
    got = _torch_grads(functools.partial(
        attn.chunked_attention, causal=causal, window=window,
        q_chunk=CHUNK, kv_chunk=CHUNK), q, k, v)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES)
def test_prefill_attention_takes_the_chunked_backward(b, s, h, kv, hd,
                                                      causal, window,
                                                      monkeypatch):
    """``prefill_attention`` above a lowered dense threshold runs the
    Function (once) and gives the reference's gradients at its chunks."""
    q, k, v = _qkv(b, s, h, kv, hd, seed=2)
    want = _jax_grads(q, k, v, causal, window)
    calls = []
    real = attn._Flash.apply
    monkeypatch.setattr(attn._Flash, "apply",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(attn, "chunked_attention", functools.partial(
        attn.chunked_attention, q_chunk=CHUNK, kv_chunk=CHUNK))
    got = _torch_grads(functools.partial(
        attn.prefill_attention, causal=causal, window=window,
        dense_threshold=CHUNK), q, k, v)
    assert calls == [1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES)
def test_forward_is_the_no_grad_loop_bit_for_bit(b, s, h, kv, hd, causal,
                                                 window, dtype):
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(b, s, h, kv, hd))
    call = functools.partial(attn.chunked_attention, causal=causal,
                             window=window, q_chunk=CHUNK, kv_chunk=CHUNK)
    with torch.no_grad():
        plain = call(q, k, v)
    graded = call(q.requires_grad_(), k, v)
    assert graded.grad_fn is not None and graded.dtype == dtype
    assert torch.equal(graded.detach(), plain)


# ---------------------------------------------------------------------------
# What the backward keeps
# ---------------------------------------------------------------------------


def _saved_bytes(fn, s: int) -> int:
    """Bytes of the distinct storages ``saved_tensors_hooks`` packs for
    one causal call at (1, s, 4, 32), the inputs' own left out."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, s, 4, 32, generator=g, requires_grad=True)
               for _ in range(3))
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(q, k, v)
    inputs = {t.untyped_storage()._cdata for t in (q, k, v)}
    return sum(n for c, n in seen.items() if c not in inputs)


def test_one_call_keeps_bytes_linear_in_seq():
    chunked = functools.partial(attn.chunked_attention, causal=True,
                                q_chunk=128, kv_chunk=128)
    loop = functools.partial(attn._flash_forward, causal=True, window=0,
                             q_chunk=128, kv_chunk=128)
    short, long_ = _saved_bytes(chunked, 512), _saved_bytes(chunked, 1024)
    assert 0 < long_ <= GROWTH * short, (short, long_)
    # The measure sees S^2: autograd through the loop keeps every block.
    loop_short = _saved_bytes(lambda *a: loop(*a)[0], 512)
    loop_long = _saved_bytes(lambda *a: loop(*a)[0], 1024)
    assert loop_long >= 3.5 * loop_short, (loop_short, loop_long)
    assert loop_short > 10 * short


class _Held(torch.utils._python_dispatch.TorchDispatchMode):
    """Weak references to every storage an op makes inside the block."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.multiprocessing.reductions import StorageWeakRef
        from torch.utils._pytree import tree_flatten

        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.refs.append((StorageWeakRef(st), st.nbytes()))
        return out

    def alive(self, exclude) -> int:
        live = {w.cdata: n for w, n in self.refs
                if not w.expired() and w.cdata not in exclude}
        return sum(live.values())


def _kept_by_loss(model, params, remat: str, seq: int) -> int:
    """Bytes the loss's forward leaves alive for its backward."""
    batch = batch_to(jmake_batch(model.cfg, 1, seq, seed=0), "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        held = _Held()
        with held:
            loss = make_loss_fn(model, remat)(params, batch)
        kept = held.alive({t.untyped_storage()._cdata
                           for t in leaves + list(batch.values())})
        torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return kept


@pytest.fixture(scope="module")
def olmo():
    m = build_model(get_config("olmo-1b").reduced())
    return m, m.init(0, "cpu")


@pytest.mark.parametrize("remat", REMAT_MODES)
def test_loss_keeps_bytes_linear_in_seq(olmo, remat, monkeypatch):
    def chunked_prefill(q, k, v, *, causal=True, window=0,
                        dense_threshold=2048):
        core = functools.partial(attn.chunked_attention, causal=causal,
                                 window=window, q_chunk=128, kv_chunk=128)
        return attn._on_head_shards(core, q, k, v)

    monkeypatch.setattr(attn, "prefill_attention", chunked_prefill)
    model, params = olmo
    short = _kept_by_loss(model, params, remat, 512)
    long_ = _kept_by_loss(model, params, remat, 1024)
    assert 0 < long_ <= GROWTH * short, (remat, short, long_)


# ---------------------------------------------------------------------------
# A whole loss on the chunked path
# ---------------------------------------------------------------------------


def test_long_sequence_loss_and_gradients_match_reference():
    jm, jp = reduced_model("olmo-1b")
    m = build_model(get_config("olmo-1b").reduced())
    p = params_from_numpy(jax.device_get(jp), "cpu")
    batch = jmake_batch(jm.cfg, 1, LONG_SEQ, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    calls = []
    real = attn._Flash.apply
    attn._Flash.apply = lambda *a: calls.append(1) or real(*a)
    try:
        loss, grads = _value_and_grad(m.loss_fn, p, batch_to(batch, "cpu"))
    finally:
        attn._Flash.apply = real
    assert len(calls) == m.cfg.num_layers
    jl = np.float32(jloss)
    assert abs(float(loss) - float(jl)) <= 8 * float(np.spacing(jl))
    tl, jls = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(tl) == len(jls)
    pairs = [(t, np.asarray(j, np.float64)) for t, j in zip(tl, jls)]
    top = max(float(np.abs(j).max()) for _, j in pairs)
    for t, j in pairs:
        assert tuple(t.shape) == j.shape
        scale = max(float(np.abs(j).max()), 1e-4 * top)
        assert float(np.abs(t.double().numpy() - j).max()) <= 2e-5 * scale
