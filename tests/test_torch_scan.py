"""The port's ``scan`` (``repro_torch.utils.scan``), its counterpart of
``jax.lax.scan``, and the rolled counts it gives the step accounting
(``launch/step_analysis.py``, ``launch/dryrun.py``).

* **Eager mode is the loop it replaced.** The mLSTM cell, the sLSTM layer
  and the sequential SSD, run through ``scan``, against the same layers
  with ``scan`` swapped for the loop they had before (a slice ``x[:, t]``
  a step, then ``torch.stack``): outputs, final states and the gradients
  of every input and weight, bit for bit.
* **The recurrences match the reference's ``lax.scan``** within
  ``tests/test_torch_ssm_layers.py``'s ``RTOL`` (1e-5 of the scale).
* **Rolled counts equal the loop's.** A reduced mLSTM, sLSTM and Mamba2
  block (``blocks.block_apply_seq``), forward and forward + backward, at
  L = 1, 3 and 8, on fake tensors under a counter that rolls the time
  loops and under one that runs them: FLOPs, bytes accessed, operations,
  argument and output bytes exactly. Temporary bytes are equal too, but
  for the sLSTM's backward, which the rolled count puts one carry leaf
  (B x heads x head_dim float32) below the loop's: within the one carry a
  rolled scan may differ by.
* **A real step never rolls.** A real mLSTM block's forward and backward
  on the CPU under a rolling counter gives the bits of the uncounted
  step and counts what a counter that rolls nothing counts.
* **The dry run**, in subprocesses with a fake world of 8 (as
  ``tests/test_torch_dryrun.py`` runs it): reduced xlstm-1.3b and
  zamba2-2.7b train and prefill steps (``count_fake_step``, the dry run's
  count) give the same record with the time scans rolled or run, on one
  rank and on (2, 2). ``--no-unroll``'s layer rolling gives the default
  record for olmo-1b, zamba2-2.7b, xlstm-1.3b and seamless-m4t-large-v2,
  reduced but 4 blocks a segment (so the layer loops do roll), in train,
  prefill and decode, on one rank and on (2, 2). On the fake 256-rank
  world, full-width olmo-1b x decode_32k through ``dryrun_one`` equals
  with ``unroll=False`` key for key but the count's seconds, and the CLI
  takes ``--no-unroll``.

Seven subprocesses run side by side with one thread each, beside the
in-process cases.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(1 if __name__ == "__main__" else 2)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5                     # tests/test_torch_ssm_layers.py's
LENGTHS = [1, 3, 8]
KINDS = ["l", "s", "m"]         # mLSTM, sLSTM, Mamba2 blocks
TINY = {"train": ("tiny_train", 32, 4, "train"),
        "prefill": ("tiny_prefill", 32, 2, "prefill"),
        "decode": ("tiny_decode", 32, 2, "decode")}
MESHES = ["1x1", "2x2"]
TIME_ARCHS = ["xlstm-1.3b", "zamba2-2.7b"]
TIME_MODES = ["train", "prefill"]
LAYER_ARCHS = ["olmo-1b", "zamba2-2.7b", "xlstm-1.3b",
               "seamless-m4t-large-v2"]
# Reduced, but 4 blocks a segment: a layer loop of 4 rolls (n > 3).
DEEP = {"olmo-1b": dict(num_layers=4),
        "zamba2-2.7b": dict(num_layers=8, block_pattern="m" * 8,
                            shared_attention_every=4),
        "xlstm-1.3b": dict(num_layers=8, block_pattern="llllssss"),
        "seamless-m4t-large-v2": dict(num_layers=4, block_pattern="cccc",
                                      num_encoder_layers=4)}
# One subprocess a group, all side by side: (kind, arch).
GROUPS = [("time", a) for a in TIME_ARCHS] + \
    [("layers", a) for a in LAYER_ARCHS] + [("full", "olmo-1b")]


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    got = port.detach().numpy()
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)


def _select_loop(step, carry, xs, *, consts=(), dim=1, loop="time"):
    """The loop ``scan`` replaced: a slice ``x.select(dim, t)`` of every
    leaf a step, then one ``torch.stack`` of the outputs."""
    n = xs[0].shape[dim]
    ys = []
    for t in range(n):
        carry, y = step(carry, tuple(x.select(dim, t) for x in xs), *consts)
        ys.append(y)
    return carry, torch.stack(ys, dim)


def _recurrence_inputs(kind, seed=0):
    """(function of the inputs, the inputs) of one recurrence at reduced
    widths: the mLSTM cell, the sLSTM layer (weights from ``seed``), the
    sequential SSD."""
    from repro_torch.config import get_config
    from repro_torch.models.init import materialize
    from repro_torch.models.layers import mamba2 as mamba
    from repro_torch.models.layers import xlstm

    rng = np.random.default_rng(seed)

    def t(*shape, lo=None, hi=None):
        a = rng.uniform(lo, hi, shape) if lo is not None else \
            rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32))

    cfg = get_config("xlstm-1.3b").reduced()
    if kind == "mlstm":
        b, l, h, dh = 2, 7, 4, 16
        st = xlstm.init_mlstm_state(cfg, b, torch.float32)
        state = xlstm.MLSTMState(t(b, h, dh, dh), t(b, h, dh),
                                 t(b, h), st.conv)
        args = [t(b, l, h, dh), t(b, l, h, dh), t(b, l, h, dh),
                t(b, l, h), torch.log(torch.sigmoid(t(b, l, h)))]

        def fn(q, k, v, ig, fg, C, n, m):
            y, (C, n, m) = xlstm._mlstm_cell_scan(
                q, k, v, ig, fg, xlstm.MLSTMState(C, n, m, state.conv))
            return y, C, n, m

        return fn, args + [state.C, state.n, state.m], xlstm
    if kind == "slstm":
        params = materialize(xlstm.slstm_spec(cfg), seed, "cpu")
        names = sorted(params)

        def fn(x, *leaves):
            y, st = xlstm.apply_slstm(dict(zip(names, leaves)), x, cfg)
            return (y,) + tuple(st)

        return fn, [t(2, 7, cfg.d_model)] + [params[k] for k in names], xlstm
    b, l, h, p, n = 2, 7, 3, 8, 5
    return (lambda *a: mamba.ssd_sequential(*a),
            [t(b, l, h, p), t(b, l, h, lo=0.01, hi=0.3),
             -t(h, lo=0.5, hi=2.0), t(b, l, n), t(b, l, n),
             t(b, h, n, p)], mamba)


def _run_with_grads(fn, args):
    args = [a.clone().requires_grad_(True) for a in args]
    outs = fn(*args)
    loss = sum((o.float() * (i + 1)).sum() for i, o in enumerate(outs))
    grads = torch.autograd.grad(loss, args, allow_unused=True)
    return [o.detach() for o in outs], grads


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "ssd"])
def test_eager_scan_is_the_old_loop(kind, monkeypatch):
    fn, args, module = _recurrence_inputs(kind)
    outs, grads = _run_with_grads(fn, args)
    monkeypatch.setattr(module, "scan", _select_loop)
    old_outs, old_grads = _run_with_grads(fn, args)
    for a, b in zip(outs, old_outs):
        assert torch.equal(a, b)
    for a, b in zip(grads, old_grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "ssd"])
def test_recurrences_match_reference_scan(kind):
    """Outputs and final states against the reference's ``lax.scan``
    recurrences on the same inputs and weights."""
    import jax.numpy as jnp

    from repro.config import get_config as jget_config
    from repro.models.layers import mamba2 as jmamba
    from repro.models.layers import xlstm as jxlstm

    fn, args, _ = _recurrence_inputs(kind)
    with torch.no_grad():
        outs = fn(*args)
    j = [jnp.asarray(a.numpy()) for a in args]
    if kind == "mlstm":
        st = jxlstm.init_mlstm_state(jget_config("xlstm-1.3b").reduced(), 2,
                                     jnp.float32)
        y, (C, n, m) = jxlstm._mlstm_cell_scan(
            *j[:5], jxlstm.MLSTMState(j[5], j[6], j[7], st.conv))
        ref = [y, C, n, m]
    elif kind == "slstm":
        from repro_torch.config import get_config
        from repro_torch.models.init import materialize
        from repro_torch.models.layers import xlstm

        names = sorted(materialize(xlstm.slstm_spec(
            get_config("xlstm-1.3b").reduced()), 0, "cpu"))
        y, st = jxlstm.apply_slstm(dict(zip(names, j[1:])), j[0],
                                   jget_config("xlstm-1.3b").reduced())
        ref = [y] + list(st)
    else:
        ref = list(jmamba.ssd_sequential(*j))
    assert len(outs) == len(ref)
    for got, want in zip(outs, ref):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got, want) <= RTOL


# ---------------------------------------------------------------------------
# Rolled counts of one block
# ---------------------------------------------------------------------------


def _block_count(kind, length, grad, rolled, real=False):
    """(StepCount, outputs) of one reduced block of ``kind`` over
    ``length`` tokens (batch 2), forward or forward + backward, on fake
    tensors (real ones from a seed with ``real``); no counter with
    ``rolled`` None."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.config import get_config
    from repro_torch.launch.step_analysis import StepCounter
    from repro_torch.models import blocks as blk
    from repro_torch.models.init import materialize
    from repro_torch.utils.tree import tree_leaves, tree_map

    arch = "zamba2-2.7b" if kind == "m" else "xlstm-1.3b"
    cfg = get_config(arch).reduced()
    params = materialize(blk.block_spec(kind, cfg), 0, "cpu")
    x = torch.from_numpy(np.random.default_rng(length).standard_normal(
        (2, length, cfg.d_model)).astype(np.float32))
    mode = contextlib.nullcontext()
    if not real:
        mode = FakeTensorMode()
        params, x = tree_map(mode.from_tensor, params), mode.from_tensor(x)
    leaves = tree_leaves(params) + [x]
    if grad:
        for p in leaves:
            p.requires_grad_(True)
    counter = StepCounter((params, x), rolled=rolled) if rolled is not None \
        else contextlib.nullcontext()
    with mode, counter:
        ctx = blk.SeqContext(torch.arange(length)[None].expand(2, length),
                             0, 0)
        out = blk.block_apply_seq(kind, params, x, ctx, cfg)[0]
        res = [out]
        if grad:
            res = list(torch.autograd.grad(out.float().sum(), leaves))
    return (counter.finish(res) if rolled is not None else None), res


def _fields(c):
    return dict(flops=c.flops, bytes=c.bytes_accessed, ops=c.ops,
                argument_bytes=c.argument_bytes, output_bytes=c.output_bytes,
                collectives=c.collectives.by_kind())


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "fwd_bwd"])
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_rolled_block_counts_the_loop(kind, length, grad):
    from repro_torch.config import get_config

    loop, _ = _block_count(kind, length, grad, ())
    rolled, _ = _block_count(kind, length, grad, ("time",))
    assert loop.flops > 0
    assert _fields(rolled) == _fields(loop)
    if kind == "s" and grad and length > 3:
        cfg = get_config("xlstm-1.3b").reduced()
        carry_leaf = 2 * cfg.d_model * 4
        assert loop.temp_bytes - rolled.temp_bytes == carry_leaf
    else:
        assert rolled.temp_bytes == loop.temp_bytes


def test_real_step_runs_the_loop():
    """On real tensors a rolling counter runs every step: the same bits as
    no counter, and the counts of a counter that rolls nothing."""
    from repro_torch.utils import scan as scan_mod

    plain, want = _block_count("l", 8, True, None, real=True)
    rolling, got = _block_count("l", 8, True, ("time", "layers"), real=True)
    loop, _ = _block_count("l", 8, True, (), real=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _fields(rolling) == _fields(loop)
    assert rolling.temp_bytes == loop.temp_bytes
    assert scan_mod.ACTIVE_COUNTERS == []


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_real_step_counts_the_fake_rolled_step(mode):
    """``chip_smoke.py`` step 14 (e) on the CPU at reduced width: xlstm-1.3b
    at the published pattern's first period (``lllllll s``), a real
    ``build_step`` step (the loops over time run step by step) counts
    exactly the fake step's FLOPs and bytes (its loops over time
    roll)."""
    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.utils.tree import tree_leaves

    base = get_config("xlstm-1.3b")
    model = build_model(base.reduced().replace(
        num_layers=8, block_pattern=base.block_pattern[:8]))
    shape = ShapeConfig(f"cpu_{mode}", 8, 1, mode)
    tc = TrainConfig(remat="blocks")
    fake = dryrun.count_fake_step(model, shape, tc, None)
    step, abstract, in_sh = dryrun.build_step(model, shape, tc, None)
    args = dryrun.place_args(abstract, in_sh, None, "cpu")
    with torch.no_grad():
        for dst, src in zip(tree_leaves(args[0]),
                            tree_leaves(model.init(0, "cpu"))):
            dst.copy_(src)
        for t in tree_leaves(args[1:-1]):
            t.zero_()
        args[-1]["tokens"].copy_(torch.randint(0, model.cfg.vocab_size,
                                               (1, 8)))
    got, real = dryrun.run_counted(step, args, ("time", "layers"))
    assert real.flops == fake.flops
    assert real.bytes_accessed == fake.bytes_accessed
    value = got[2]["loss"] if mode == "train" else got[0]
    assert torch.isfinite(value).all()


# ---------------------------------------------------------------------------
# The dry run (subprocesses)
# ---------------------------------------------------------------------------


def _record(c):
    return {**_fields(c), "collectives": {k: list(v) for k, v in
                                          c.collectives.by_kind().items()},
            "temp_bytes": c.temp_bytes}


def _side(kind: str, arch: str) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.utils import scan as scan_mod

    rolled_loops = []
    pick = scan_mod._rolling_counter

    def spy(loop, n, tree):
        got = pick(loop, n, tree)
        if got is not None:
            rolled_loops.append(loop)
        return got

    scan_mod._rolling_counter = spy
    out = {}
    if kind == "full":
        dryrun.fake_world(256)
        recs = {}
        for unroll in (True, False):
            del rolled_loops[:]
            rec = dryrun.dryrun_one(arch, "decode_32k", unroll=unroll)
            recs[str(unroll)] = dict(rec, rolled=sorted(set(rolled_loops)))
        out["full"] = recs
        path = Path(sys.argv[3]).with_suffix(".jsonl")
        out["cli_rc"] = dryrun.main(["--arch", arch, "--shape",
                                     "decode_32k", "--no-unroll", "--out",
                                     str(path)])
        out["cli"] = json.loads(path.read_text().splitlines()[-1])
        return out

    dryrun.fake_world(8)

    def mesh(name):
        shape = (1, 1) if name == "1x1" else (2, 2)
        return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(
            shape), mesh_dim_names=("data", "model"))

    def count(model, mode, m, rolled):
        del rolled_loops[:]
        c = dryrun.count_fake_step(model, ShapeConfig(*TINY[mode]),
                                   TrainConfig(remat="blocks"), m, rolled)
        return dict(_record(c), rolled=sorted(set(rolled_loops)))

    if kind == "time":
        model = build_model(get_config(arch).reduced())
        for mode in TIME_MODES:
            for name in MESHES:
                out[f"time/{arch}/{mode}/{name}"] = {
                    r: count(model, mode, mesh(name), (r,) if r else ())
                    for r in ("", "time")}
        return out
    model = build_model(get_config(arch).reduced().replace(**DEEP[arch]))
    for mode in TINY:
        for name in MESHES:
            out[f"layers/{arch}/{mode}/{name}"] = {
                r: count(model, mode, mesh(name), tuple(r.split("+")))
                for r in ("time", "time+layers")}
    return out


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """The subprocesses, started with the file's first test so that the
    in-process cases run beside them."""
    d = tmp_path_factory.mktemp("scan")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for kind, arch in GROUPS:
        path = d / f"{kind}_{arch}.json"
        procs.append((kind, arch, path, subprocess.Popen(
            [sys.executable, __file__, kind, arch, str(path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    yield procs
    for *_, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(_started):
    out, fails = {}, []
    for kind, arch, path, proc in _started:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            fails.append(f"{kind} {arch} rc={proc.returncode}:\n"
                         f"{log[-3000:]}")
            continue
        got = json.loads(path.read_text())
        print(f"{kind} {arch}: {got.pop('seconds'):.1f} s")
        out.update(got)
    assert not fails, "\n".join(fails)
    return out


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("mode", TIME_MODES)
@pytest.mark.parametrize("arch", TIME_ARCHS)
def test_dryrun_time_scans_roll_to_the_same_record(runs, arch, mode, name):
    got = runs[f"time/{arch}/{mode}/{name}"]
    loop, rolled = got[""], got["time"]
    assert loop.pop("rolled") == [] and rolled.pop("rolled") == ["time"]
    assert rolled == loop


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("mode", list(TINY))
@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_no_unroll_gives_the_default_record(runs, arch, mode, name):
    got = runs[f"layers/{arch}/{mode}/{name}"]
    default, rolled = got["time"], got["time+layers"]
    assert "layers" not in default.pop("rolled")
    assert "layers" in rolled.pop("rolled")
    assert rolled == default


def test_dryrun_one_no_unroll_full_width(runs):
    """Full-width olmo-1b x decode_32k on the fake 16 x 16 world: the
    record of ``unroll=False`` is the default's but for the count's
    seconds, with the same keys; the CLI takes ``--no-unroll``."""
    default, rolled = runs["full"]["True"], runs["full"]["False"]
    assert default.pop("rolled") == [] and rolled.pop("rolled") == [
        "layers"]
    assert list(rolled) == list(default)
    assert {k: v for k, v in rolled.items() if k != "count_s"} == \
        {k: v for k, v in default.items() if k != "count_s"}
    assert runs["cli_rc"] == 0
    assert {k: v for k, v in runs["cli"].items() if k != "count_s"} == \
        {k: v for k, v in default.items() if k != "count_s"}


if __name__ == "__main__":
    import time

    t0 = time.perf_counter()
    kind, arch, path = sys.argv[1:4]
    result = _side(kind, arch)
    result["seconds"] = time.perf_counter() - t0
    Path(path).write_text(json.dumps(result))
