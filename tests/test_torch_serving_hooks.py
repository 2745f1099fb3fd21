"""Parity of the port's last serving hooks with the reference's: the
fleet's token streams (``FleetServer.attach_stream`` / ``step_streams`` /
``run_streams``) and ``DecoupledRunner.run_simulated``.

Fleet streams run reduced olmo-1b, with the reference's weights bridged
into the port, as three ``TokenStreamSession``s, two of them on one plan.
Tolerance: none. Each session's tokens must equal the same session run
alone and the reference fleet's; the fleet's ``cloud_groups`` must hold
the reference's keys and uids; and each step must run one batched encode
and one batched decode per non-empty plan bucket.

``run_simulated`` runs the reduced resnet50 at a mid-network point (2, 4
and 8 bits; bitpack and perchannel) and reduced olmo-1b. On a shared
boundary (the reference head's own output) the simulated values must
equal the *jitted* reference codec's bit for bit (the reference's
``run_simulated`` calls ``simulate`` outside jit, where XLA keeps a true
division the compiled decode does not, so its boundary may differ by an
ulp); the logits must agree within the forward's tolerance
(2e-5 of their scale for the CNN, 1e-5 for the decoder, as
``tests/test_torch_cnn.py`` and ``tests/test_torch_lm_model.py`` hold the
forwards), and must equal the port's own wire path (``run``): bit for
bit, but for the decoder's per-channel tail, which takes the decoded
boundary as a channel-major view and agrees within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codec import get_codec as jget_codec  # noqa: E402
from repro.config import JaladConfig as JJaladConfig  # noqa: E402
from repro.config import ServeConfig as JServeConfig  # noqa: E402
from repro.config import types as jtypes  # noqa: E402
from repro.core.decoupler import DecoupledPlan as JPlan  # noqa: E402
from repro.core.decoupler import DecoupledRunner as JRunner  # noqa: E402
from repro.core.decoupler import JaladEngine as JEngine  # noqa: E402
from repro.core.latency import LatencyModel as JLatency  # noqa: E402
from repro.core.predictor import PredictorTables as JTables  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.serving.fleet import FleetServer as JFleet  # noqa: E402
from repro.serving.scheduler import GenRequest as JRequest  # noqa: E402
from repro.serving.streaming import TokenStreamSession as JStream  # noqa: E402
from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.codec.base import BoundaryCodec  # noqa: E402
from repro_torch.config import JaladConfig, ServeConfig  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.config import types as ttypes  # noqa: E402
from repro_torch.core.decoupler import (  # noqa: E402
    DecoupledPlan,
    DecoupledRunner,
    JaladEngine,
)
from repro_torch.core.latency import LatencyModel  # noqa: E402
from repro_torch.core.predictor import PredictorTables  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving.fleet import FleetServer  # noqa: E402
from repro_torch.serving.scheduler import GenRequest  # noqa: E402
from repro_torch.serving.streaming import TokenStreamSession  # noqa: E402

from conftest import reduced_model  # noqa: E402

# (plan, prompt sizes, tokens, arrivals) of each session; the first two
# share a plan.
SESSIONS = [((0, 8, "bitpack"), [5, 9], [6, 3], [0, 1]),
            ((0, 8, "bitpack"), [7, 4], [4, 5], [0, 2]),
            ((1, 4, "perchannel"), [6, 8], [5, 2], [1, 0])]


def _port(arch):
    jmodel, jparams = reduced_model(arch)
    return (jmodel, jparams, build_model(get_config(arch).reduced()),
            params_from_numpy(jax.device_get(jparams), "cpu"))


def _plan(cls, key):
    point, bits, codec = key
    return cls(point=point, bits=bits, predicted_latency=0.0,
               predicted_acc_drop=0.0, solve_ms=0.0, codec=codec)


def _engines(jmodel, model):
    """Both packages' engines over one small hand-made table (the fleet
    needs one for its decision plane; the streams bring their own plans)."""
    n = len(model.decoupling_points())
    rng = np.random.default_rng(0)
    acc = rng.random((n, 2, 2)) * 0.1
    size = rng.random((n, 2, 2)) * 1e4 + 1e2
    fmacs = model.per_point_fmacs(1, 16)
    out = []
    for tables, cfg, lat, eng, m, types in (
            (JTables, JJaladConfig, JLatency, JEngine, jmodel, jtypes),
            (PredictorTables, JaladConfig, LatencyModel, JaladEngine, model,
             ttypes)):
        jc = cfg(bits_choices=(4, 8), codec_choices=("bitpack", "perchannel"),
                 accuracy_drop_budget=0.5)
        t = tables(points=m.decoupling_points(), bits_choices=[4, 8],
                   codecs=["bitpack", "perchannel"], acc_drop=acc.copy(),
                   size_bytes=size.copy(), base_accuracy=0.9)
        out.append(eng(m, t, lat(fmacs, jc.edge, jc.cloud, 64.0), jc))
    return out


def _sessions(stream_cls, req_cls, plan_cls, model, params, cfg_cls,
              only=None):
    out = []
    for si, (key, sizes, max_new, arrivals) in enumerate(SESSIONS):
        if only is not None and si != only:
            continue
        s = stream_cls(model, params, cfg_cls(max_batch=2, max_seq_len=32),
                       plan=_plan(plan_cls, key))
        rng = np.random.default_rng(si)
        for j, n in enumerate(sizes):
            s.submit(req_cls(uid=10 * si + j,
                             tokens=rng.integers(1, model.cfg.vocab_size,
                                                 size=n).astype(np.int32),
                             max_new_tokens=max_new[j],
                             arrival=arrivals[j]))
        out.append(s)
    return out


def _results(session):
    return {r.uid: np.asarray(r.result).tolist() for r in session.completed}


def test_fleet_streams_match_solo_sessions_and_the_reference(monkeypatch):
    jmodel, jparams, model, params = _port("olmo-1b")
    jeng, teng = _engines(jmodel, model)
    jfleet = JFleet(jeng, jparams, [jtypes.EDGE_TX2])
    tfleet = FleetServer(teng, params, [ttypes.EDGE_TX2])
    for s in _sessions(JStream, JRequest, JPlan, jmodel, jparams,
                       JServeConfig):
        jfleet.attach_stream(s)
    for s in _sessions(TokenStreamSession, GenRequest, DecoupledPlan, model,
                       params, ServeConfig):
        tfleet.attach_stream(s)

    calls = {"encode": 0, "decode": 0}
    for name, kind in (("encode_batch", "encode"),
                       ("decode_batch", "decode")):
        for codec in ("bitpack", "perchannel"):
            cls = type(get_codec(codec))
            orig = getattr(cls, name)

            def spy(self, *a, _orig=orig, _kind=kind, **kw):
                calls[_kind] += 1
                return _orig(self, *a, **kw)

            monkeypatch.setattr(cls, name, spy)
    assert issubclass(cls, BoundaryCodec)
    tokens = 0
    while any(s.queue or s.num_active for s in tfleet.stream_sessions):
        before = (len(tfleet.cloud_groups), dict(calls))
        tokens += tfleet.step_streams()
        groups = len(tfleet.cloud_groups) - before[0]
        assert 1 <= groups <= 2
        assert calls["encode"] - before[1]["encode"] == groups
        assert calls["decode"] - before[1]["decode"] == groups
    monkeypatch.undo()
    assert tfleet.run_streams() == 0
    assert jfleet.run_streams() == tokens == sum(
        s.tokens_out for s in tfleet.stream_sessions)

    assert [(g.key, g.uids) for g in tfleet.cloud_groups] == \
        [(tuple(g.key), list(g.uids)) for g in jfleet.cloud_groups]
    assert {g.key for g in tfleet.cloud_groups} == {k for k, *_ in SESSIONS}
    assert any(len({u // 10 for u in g.uids}) == 2
               for g in tfleet.cloud_groups)   # two sessions, one group
    for si, (ts, js) in enumerate(zip(tfleet.stream_sessions,
                                      jfleet.stream_sessions)):
        got = _results(ts)
        assert got == _results(js)
        solo = _sessions(TokenStreamSession, GenRequest, DecoupledPlan,
                         model, params, ServeConfig, only=si)[0]
        solo.run()
        assert got == _results(solo)
        assert ts.bytes_sent == solo.bytes_sent == js.bytes_sent


def test_attach_stream_needs_a_plan():
    _, _, model, params = _port("olmo-1b")
    _, teng = _engines(reduced_model("olmo-1b")[0], model)
    fleet = FleetServer(teng, params, [ttypes.EDGE_TX2])
    with pytest.raises(ValueError, match="DecoupledPlan"):
        fleet.attach_stream(object())
    assert fleet.step_streams() == 0
    assert fleet.run_streams() == 0
    assert fleet.cloud_groups == []


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.double().numpy() - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("codec", ["bitpack", "perchannel"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_run_simulated_matches_reference_cnn(codec, bits):
    jmodel, jparams, model, params = _port("resnet50")
    point = len(model.decoupling_points()) // 2
    batch = jmake_batch(jmodel.cfg, 2, 0, seed=4)
    jrun = JRunner(jmodel, jparams, _plan(JPlan, (point, bits, codec)))
    trun = DecoupledRunner(model, params, _plan(DecoupledPlan,
                                                (point, bits, codec)))
    got = trun.run_simulated(batch)
    want = jrun.run_simulated({k: jnp.asarray(v) for k, v in batch.items()})
    _close(got, want, 2e-5)
    assert torch.equal(got, trun.run(batch)[0])
    # The value transform on a shared boundary: the reference head's own.
    jb = jmodel.run_head(jparams, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, point)
    jsim = jax.jit(lambda a: jget_codec(codec).simulate(a, bits))(jb)
    tsim = get_codec(codec).simulate(torch.from_numpy(np.array(jb)), bits)
    np.testing.assert_array_equal(tsim.numpy(), np.asarray(jsim))


def test_run_simulated_matches_reference_lm():
    jmodel, jparams, model, params = _port("olmo-1b")
    batch = jmake_batch(jmodel.cfg, 2, 12, seed=5)
    for key in ((0, 8, "bitpack"), (1, 4, "perchannel")):
        jrun = JRunner(jmodel, jparams, _plan(JPlan, key))
        trun = DecoupledRunner(model, params, _plan(DecoupledPlan, key))
        got = trun.run_simulated(batch)
        want = jrun.run_simulated({k: jnp.asarray(v)
                                   for k, v in batch.items()})
        _close(got, want, 1e-5)
        wire = trun.run(batch)[0]
        if key[2] == "bitpack":
            assert torch.equal(got, wire)
        else:
            # The same boundary values, but the per-channel decode hands
            # the tail a channel-major view, whose products the CPU sums
            # in another order.
            _close(got, wire.numpy(), 1e-5)
