"""Checkpoints, the sharded loader, the tree helpers and the training
launcher of the port, against the reference's on the CPU.

Tolerance: none. A checkpoint is bytes: leaves numbered in jax's flatten
order (dict keys sorted), in the reference's layout, must restore bit for
bit in either package, whichever wrote them; a bfloat16 leaf is written
and read as numpy's raw ``|V2`` bytes. The loader's batches, the tree
helpers' leaf order, names, counts and messages must equal the
reference's exactly.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.data.synthetic import ShardedLoader as JLoader  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint.store import treedef_str  # noqa: E402
from repro_torch.config import TrainConfig, get_config  # noqa: E402
from repro_torch.data.synthetic import ShardedLoader  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import (  # noqa: E402
    opt_state_from_numpy,
    params_from_numpy,
)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

from conftest import reduced_model  # noqa: E402


def _trained(arch="olmo-1b"):
    """(reference params, reference AdamW state after one update, the
    port's copies): non-zero moments and a step of 1."""
    _, jp = reduced_model(arch)
    rng = np.random.default_rng(0)
    g = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(a.dtype)), jp)
    jp, jstate, _ = jadamw.apply_updates(jp, g, jadamw.init_state(jp),
                                         JTrainConfig())
    host_p, host_s = jax.device_get(jp), jax.device_get(jstate)
    return (jp, jstate, params_from_numpy(host_p, "cpu"),
            opt_state_from_numpy(host_s, "cpu"))


def _bits_equal(t, a):
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        return np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16))
    return np.array_equal(t.numpy(), a) and t.numpy().dtype == a.dtype


def test_round_trip_is_bitwise_and_keeps_the_layout(tmp_path):
    jp, jstate, p, state = _trained()
    d = str(tmp_path / "ckpt")
    path = ckpt.save_checkpoint(d, 7, p, state)
    assert path == os.path.join(d, "step_00000007")
    assert sorted(os.listdir(path)) == ["manifest.json", "opt_state.npz",
                                        "params.npz"]
    assert ckpt.latest_step(d) == 7
    p2, s2, step = ckpt.restore_checkpoint(d, p, state)
    assert step == 7
    for a, b in zip(tree.tree_leaves(p) + tree.tree_leaves(state),
                    tree.tree_leaves(p2) + tree.tree_leaves(s2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(s2, adamw.AdamWState) and int(s2.step) == 1
    # The manifest records the structures as jax prints them.
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest == {"step": 7,
                        "params_treedef": str(jax.tree.structure(jp)),
                        "opt_treedef": str(jax.tree.structure(jstate))}
    assert treedef_str({"b": [None, (1,)], "a": ()}) == \
        str(jax.tree.structure({"b": [None, (1,)], "a": ()}))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jp, jstate, p, state = _trained()
    d = str(tmp_path / "ref")
    jckpt.save_checkpoint(d, 3, jp, jstate)
    p2, s2, step = ckpt.restore_checkpoint(d, p, state)
    assert step == 3
    for t, a in zip(tree.tree_leaves(p2) + tree.tree_leaves(s2),
                    jax.tree.leaves(jp) + jax.tree.leaves(jstate)):
        assert _bits_equal(t, jax.device_get(a))
    assert s2.step.dtype == torch.int32


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jp, jstate, p, state = _trained()
    d = str(tmp_path / "port")
    ckpt.save_checkpoint(d, 5, p, state)
    assert jckpt.latest_step(d) == 5
    jp2, js2, step = jckpt.restore_checkpoint(d, jp, jstate)
    assert step == 5
    for a, t in zip(jax.tree.leaves(jp2) + jax.tree.leaves(js2),
                    tree.tree_leaves(p) + tree.tree_leaves(state)):
        assert _bits_equal(t, a)


def test_bfloat16_leaves_are_raw_two_byte_values(tmp_path):
    """A full param_dtype tree (bfloat16) round-trips on the port side,
    through ``|V2`` leaves; a reference-written bfloat16 leaf (numpy with
    ml_dtypes) restores into the port bit for bit."""
    cfg = get_config("olmo-1b").reduced().replace(dtype="bfloat16",
                                                 param_dtype="bfloat16")
    p = build_model(cfg).init(0, "cpu")
    assert all(x.dtype == torch.bfloat16 for x in tree.tree_leaves(p))
    d = str(tmp_path / "bf16")
    path = ckpt.save_checkpoint(d, 1, p)
    with np.load(os.path.join(path, "params.npz")) as z:
        assert {z[k].dtype.str for k in z.files} == {"|V2"}
    p2, s2, _ = ckpt.restore_checkpoint(d, p)
    assert s2 is None
    for a, b in zip(tree.tree_leaves(p), tree.tree_leaves(p2)):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))

    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      reduced_model("olmo-1b")[1])
    jckpt.save_checkpoint(str(tmp_path / "jbf16"), 2, jp)
    template = tree.cast_floating(params_from_numpy(jax.device_get(jp),
                                                    "cpu"), torch.bfloat16)
    p3, _, _ = ckpt.restore_checkpoint(str(tmp_path / "jbf16"), template)
    for t, a in zip(tree.tree_leaves(p3), jax.tree.leaves(jp)):
        assert _bits_equal(t, jax.device_get(a))


def test_restore_checks_its_templates(tmp_path):
    _, _, p, _ = _trained()
    d = str(tmp_path / "c")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d, p)
    assert ckpt.latest_step(d) is None
    ckpt.save_checkpoint(d, 1, p)
    bad = dict(p, embed=torch.zeros(3, 4))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, bad)
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore_checkpoint(d, tree.cast_floating(p, torch.float64))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-7b",
                                  "seamless-m4t-large-v2"])
def test_sharded_loader_batches_equal_the_reference(arch):
    for hosts, host in ((1, 0), (2, 1)):
        loader = iter(ShardedLoader(get_config(arch).reduced(), 4, 32,
                                    num_hosts=hosts, host_id=host, seed=3))
        jloader = iter(JLoader(jget_config(arch).reduced(), 4, 32,
                               num_hosts=hosts, host_id=host, seed=3))
        for _ in range(3):
            got, want = next(loader), next(jloader)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="divide"):
        ShardedLoader(get_config(arch).reduced(), 3, 8, num_hosts=2)


def test_tree_helpers_match_the_reference():
    jm, jp = reduced_model("zamba2-2.7b")
    p = params_from_numpy(jax.device_get(jp), "cpu")
    state = adamw.init_state(p)
    jstate = jadamw.init_state(jp)
    # Leaves in jax's order (dict keys sorted; the port's trees keep
    # insertion order), paths named as the reference names them.
    for t, a in zip(tree.tree_leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    assert tree.tree_param_count(p) == jtree.tree_param_count(jp)
    assert tree.tree_size_bytes(state) == jtree.tree_size_bytes(jstate)
    names, jnames = [], []
    tree.tree_map_with_path_names(lambda n, x: names.append(n), state)
    jtree.tree_map_with_path_names(lambda n, x: jnames.append(n), jstate)
    assert sorted(names) == sorted(jnames)
    bad = dict(p, segments=[dict(s) for s in p["segments"]])
    bad["segments"][1]["ln"] = {"scale": torch.tensor([1.0, float("nan")])}
    jbad = dict(jp, segments=list(jp["segments"]))
    jbad["segments"][1] = dict(jbad["segments"][1],
                               ln={"scale": jnp.array([1.0, jnp.nan])})
    with pytest.raises(FloatingPointError) as err:
        tree.check_no_nans(bad, "params")
    with pytest.raises(FloatingPointError) as jerr:
        jtree.check_no_nans(jbad, "params")
    assert str(err.value) == str(jerr.value)
    tree.check_no_nans(p)
    cast = tree.cast_floating({"w": torch.ones(2), "i": torch.ones(2).int()},
                              torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32


def test_train_cli_runs_on_the_cpu(tmp_path, caplog):
    caplog.set_level("INFO", logger="repro_torch")
    d = str(tmp_path / "cli")
    assert train_cli.main(["--arch", "olmo-1b", "--reduced", "--device",
                           "cpu", "--steps", "3", "--batch", "4", "--seq",
                           "16", "--checkpoint-dir", d,
                           "--checkpoint-every", "3"]) == 0
    assert "done: first loss" in caplog.text
    assert ckpt.latest_step(d) == 3
    model = build_model(get_config("olmo-1b").reduced())
    params = model.init(0, "cpu")
    p2, s2, _ = ckpt.restore_checkpoint(d, params, adamw.init_state(params))
    assert int(s2.step) == 3
    assert not all(torch.equal(a, b) for a, b in zip(
        tree.tree_leaves(params), tree.tree_leaves(p2)))
    assert TrainConfig().remat == "none"
