"""The port's granite-4.0-h-micro (IBM Granite 4.0-H Micro, a Mamba2 and
NoPE attention hybrid with muP scalars), on the CPU at reduced widths.

The reference registry has no such arch, so the port is held against
the benchmark's plain float32 reference (``bench/reference/
granite_hybrid.py``) on the same seeded weights: prefill logits, and
teacher-forced decode through the hybrid caches (Mamba2 states beside
KV). Tolerance ``REL``: both sides compute in float32, but the scan in
three forms (the reference's quadratic form with a float64 cumulative
decay, the port's chunked SSD above one chunk and its recurrence below)
sums in other orders over hundreds of positions; measured up to 1.5e-5
of the largest logit here, where bfloat16 operands move the logits by
about 1e-2 of it. The padded chunked prefill is held against the
recurrence at 1, 2 and 3 chunks, plus and minus one position, within
the Mamba2 layer tests' ``RTOL`` (same reason: other summation orders).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

from repro.config import list_archs as jlist_archs  # noqa: E402
from repro_torch.config import (  # noqa: E402
    ModelConfig,
    assigned_archs,
    get_config,
    list_archs,
)
from repro_torch.config.types import MUP_DEFAULTS, MupConfig, mup  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.init import materialize  # noqa: E402
from repro_torch.models.layers import mamba2  # noqa: E402
from repro_torch.utils import trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from bench.reference import granite_hybrid as ref  # noqa: E402
from bench.weights import draw, same_layout  # noqa: E402

ARCH = "granite-4.0-h-micro"
REL = 1e-4
RTOL = 1e-5
# The published config's keys the reference reads, at reduced widths:
# two attention layers among four Mamba2 ones, Mamba2 heads of 64.
SMALL = dict(
    num_hidden_layers=6, hidden_size=128, intermediate_size=256,
    vocab_size=300, num_attention_heads=4, num_key_value_heads=2,
    layer_types=["mamba", "attention", "mamba", "mamba", "attention",
                 "mamba"],
    mamba_d_head=64, mamba_n_heads=4, mamba_d_state=16, mamba_n_groups=1,
    mamba_d_conv=4, mamba_expand=2, mamba_chunk_size=256,
    mamba_conv_bias=True, mamba_proj_bias=False, attention_bias=False,
    position_embedding_type="nope", tie_word_embeddings=True,
    embedding_multiplier=12, residual_multiplier=0.22,
    attention_multiplier=0.015625, logits_scaling=8, rms_norm_eps=1e-5)


def small_model():
    cfg = get_config(ARCH).replace(**ref.port_overrides(SMALL),
                                   dtype="float32", param_dtype="float32",
                                   ssm_param_dtype="float32")
    model = build_model(cfg)
    params = draw(ref.layout(SMALL), 11, "cpu", torch.float32,
                  embed_std=0.05)
    assert same_layout(params, model.abstract_params())
    return model, params


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_registered_port_only():
    cfg = get_config(ARCH)
    assert isinstance(cfg, MupConfig) and ARCH in list_archs()
    assert ARCH not in jlist_archs()
    assert ARCH not in assigned_archs() and len(assigned_archs()) == 10
    assert cfg.block_pattern == "".join(
        "d" if i in (5, 15, 25, 35) else "M" for i in range(40))
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.attention_multiplier, cfg.logits_scaling) == (
                12.0, 0.22, 0.015625, 8.0)


def test_reference_archs_keep_the_reference_fields():
    """The muP scalars are fields of the port-only ``MupConfig`` alone:
    every reference arch keeps its fields and reads the defaults that
    leave its arithmetic as it was, as does a config of the reference's
    own class."""
    from repro.config import get_config as jget_config

    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert not set(MUP_DEFAULTS) & set(names)
    assert set(MUP_DEFAULTS) <= {f.name for f in dataclasses.fields(
        MupConfig)}
    for arch in jlist_archs():
        for cfg in (get_config(arch), jget_config(arch)):
            assert list(dataclasses.asdict(cfg)) == names
            assert {k: mup(cfg, k) for k in MUP_DEFAULTS} == MUP_DEFAULTS


def test_every_leaf_is_bfloat16_at_full_width():
    model = build_model(get_config(ARCH))
    dtypes = set()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            dtypes.add(t.dtype)

    walk(model.abstract_params())
    assert dtypes == {torch.bfloat16}
    assert 3.18e9 < model.param_count() < 3.20e9
    assert model.decoupling_points()[19] == "seg4_M3"


@pytest.mark.parametrize("length", [255, 256, 257, 511, 512, 513, 767, 768,
                                    769])
def test_padded_chunked_prefill_matches_the_recurrence(length):
    cfg = get_config(ARCH).replace(d_model=64, ssm_state_dim=8,
                                   dtype="float32", param_dtype="float32",
                                   ssm_param_dtype="float32")
    params = materialize(mamba2.mamba2_spec(cfg), 3, "cpu")
    params["A_log"] = torch.linspace(-1.0, 1.0, 2)
    params["dt_bias"] = torch.full((2,), -2.0)
    x = torch.from_numpy(np.random.default_rng(length).standard_normal(
        (2, length, 64)).astype(np.float32))
    mamba2.PREFILLS.clear()
    with torch.no_grad():
        y, st = mamba2.mamba2_seq(params, x, cfg)
        # A chunk longer than the input: the recurrence.
        y_r, st_r = mamba2.mamba2_seq(params, x, cfg, chunk=1 << 20)
    chunked = length > mamba2.SSD_CHUNK
    assert mamba2.PREFILLS == {"chunked": 1, "recurrence": 1} if chunked \
        else mamba2.PREFILLS == {"recurrence": 2}
    assert y.shape == y_r.shape == (2, length, 64)
    assert _rel(y, y_r) <= RTOL
    assert _rel(st.ssm, st_r.ssm) <= RTOL
    assert torch.equal(st.conv, st_r.conv)
    # The conv window: the last three raw conv inputs, not a padded one.
    assert torch.equal(st.conv, torch.matmul(x, params["in_proj"])[
        :, -3:, 128:128 + 144])


def test_chunked_ssd_keeps_its_contract():
    x = torch.zeros(1, 300, 2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        mamba2.ssd_chunked(x, torch.zeros(1, 300, 2), -torch.ones(2),
                           torch.zeros(1, 300, 3), torch.zeros(1, 300, 3),
                           256)
    assert [mamba2.ssd_chunks(n) for n in (1, 256, 257, 512, 7168)] == [
        0, 0, 2, 2, 28]


@pytest.mark.parametrize("length", [2473, 3072])
def test_causal_prefill_attention_at_any_length(length):
    """Past the dense threshold a causal prefill is chunked; a length that
    is not a multiple of the chunk is padded to one and equals the dense
    attention (float32; the online softmax sums in another order)."""
    from repro_torch.models.layers import attention as attn

    g = torch.Generator().manual_seed(length)
    q = torch.randn(1, length, 4, 16, generator=g)
    k, v = (torch.randn(1, length, 2, 16, generator=g) for _ in range(2))
    got = attn.prefill_attention(q, k, v, causal=True)
    assert _rel(got, attn.full_attention(q, k, v, causal=True)) <= RTOL


@pytest.mark.parametrize("prompt", [9, 300])
def test_prefill_and_teacher_forced_decode_match_the_reference(prompt):
    """A prompt's prefill (the recurrence at 9 tokens, the padded chunked
    SSD at 300), then four decode steps fed the sequence's own tokens
    through the Mamba2 states and KV caches, against the reference's
    logits of the whole sequence."""
    model, params = small_model()
    toks = torch.from_numpy(np.random.default_rng(prompt).integers(
        1, SMALL["vocab_size"], prompt + 4))
    with torch.no_grad():
        want = ref.forward(SMALL, params, toks)
        logits, caches = model.prefill(params, {"tokens": toks[None,
                                                               :prompt]},
                                       prompt + 8)
        assert _rel(logits[0], want[:prompt]) <= REL
        for p in range(prompt, prompt + 4):
            step, caches = model.decode_step(params, toks[None, p:p + 1], p,
                                             caches)
            assert _rel(step[0, 0], want[p]) <= REL


def test_ssm_spans_name_each_prefill_and_decode():
    model, params = small_model()
    toks = (torch.arange(300) % 299 + 1)[None]
    with torch.no_grad(), trace.recording() as rec:
        _, caches = model.prefill(params, {"tokens": toks}, 310)
        model.decode_step(params, toks[:, -1:], 300, caches)
    pre = [s.attrs for s in rec if s.name == "ssm.prefill"]
    dec = [s.attrs for s in rec if s.name == "ssm.decode"]
    assert pre == [{"rows": 1, "tokens": 300, "chunks": 2}] * 4
    assert dec == [{"rows": 1, "tokens": 1, "chunks": 0}] * 4
