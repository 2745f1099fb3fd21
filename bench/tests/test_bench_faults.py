"""A run's check against the plain reference, at reduced sizes on the CPU:
sound runs pass, the control (the reference in the next lower precision
in the program's place) and each fault planted in the timed path fail."""
import copy
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness

torch.set_num_threads(2)
pytest.importorskip("repro_torch.serving.fleet")
ROOT = Path(__file__).resolve().parents[2]


def small(name: str) -> harness.Cell:
    """The cell at a size a test run holds: every width cut, every
    mechanism kept."""
    cell = harness.find_cell(ROOT, name)
    cfg = cell.config = copy.deepcopy(cell.config)
    if cfg["system"] == "fleet":
        # All 1,000 classes: a 2-bit cut after ``fc`` quantizes the logits,
        # and with fewer of them the control moves no code there.
        cfg["model"].update(image_size=32)
        cfg["frames"] = 2
        cfg["serving"].update(input_pool=4, bits=[2])
        cell.mix.update(rate_per_s=20.0, warm_s=0.2)
    else:
        cfg["model"].update(num_layers=4, d_model=128, num_heads=2,
                            num_kv_heads=2, d_ff=256, vocab_size=512)
        cfg["serving"].update(cut="seg0_d1", slots=4, cache_len=96)
        cell.mix.update(clients=4, prompt_tokens=[8, 64],
                        output_tokens=[4, 24])
    return cell


def run(name: str, seconds: float = 1.0, seed: int = 2**31 + 11):
    return harness.run_cell(ROOT, name, seed, seconds, False,
                            time.perf_counter(), device="cpu",
                            cell=small(name), keep_system=True)


CELLS = ["resnet50.fleet_wifi", "olmo-1b.stream_chat"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_control_is_not(name):
    out = run(name)
    assert out.result["correct"], out.result
    assert out.result["attempted"] > 0 and out.result["failed"] == 0
    own = small(name).own
    limits = own["limits"]
    rng = np.random.default_rng(3)
    control = out.system.check(rng, 4, control=True,
                               **own.get("check_args", {}))
    for k, v in control.items():
        assert v > limits[k], (k, v, limits[k])
        assert v >= 3 * out.checks[k][0]


def _perturb_logits(monkeypatch):
    from repro_torch.core.decoupler import DecoupledRunner

    real = DecoupledRunner.cloud_step_batch

    def altered(self, *a, **kw):
        outs = real(self, *a, **kw)
        outs[0] = outs[0].clone()
        outs[0][0, 0] += outs[0].abs().max()
        return outs

    monkeypatch.setattr(DecoupledRunner, "cloud_step_batch", altered)


def _half_wave(monkeypatch):
    from repro_torch.serving.fleet import FleetServer

    real = FleetServer.serve
    monkeypatch.setattr(FleetServer, "serve",
                        lambda self, reqs: real(self, list(reqs)[::2]))


def _fleet_unchanged(monkeypatch):
    from repro_torch.serving.fleet import FleetServer

    monkeypatch.setattr(FleetServer, "serve", lambda self, reqs: [])


def _alter_token(monkeypatch):
    from repro_torch.serving.scheduler import ContinuousBatchingEngine

    real = ContinuousBatchingEngine._select_tokens

    def altered(self, slots, rows):
        host, dev = real(self, slots, rows)
        return (host + 1) % rows.shape[-1], (dev + 1) % rows.shape[-1]

    monkeypatch.setattr(ContinuousBatchingEngine, "_select_tokens", altered)


def _stream_unchanged(monkeypatch):
    from repro_torch.serving.streaming import TokenStreamSession

    real = TokenStreamSession.step
    calls = {"n": 0}

    def step(self):
        calls["n"] += 1
        # Set-up fills the slots; after that, a step does nothing.
        return real(self) if calls["n"] <= 3 else []

    monkeypatch.setattr(TokenStreamSession, "step", step)


def _half_slots(monkeypatch):
    from repro_torch.serving.streaming import TokenStreamSession

    real = TokenStreamSession._active_slots
    monkeypatch.setattr(TokenStreamSession, "_active_slots",
                        lambda self: real(self)[::2])


@pytest.mark.parametrize("name,fault", [
    ("resnet50.fleet_wifi", _perturb_logits),
    ("resnet50.fleet_wifi", _half_wave),
    ("resnet50.fleet_wifi", _fleet_unchanged),
    ("olmo-1b.stream_chat", _alter_token),
    ("olmo-1b.stream_chat", _stream_unchanged),
    ("olmo-1b.stream_chat", _half_slots),
], ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    try:
        out = run(name)
    except (RuntimeError, ValueError, IndexError):
        return          # a run that crashes prints no result either
    assert not out.result["correct"], out.result
