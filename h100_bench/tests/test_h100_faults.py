"""The check that decides ``correct``, driven through a whole run on the
CPU at the rehearsal size (``runner.run(..., rehearse=True)``, which skips
the look for a card), in float32 so that a sound run sits far inside the
limits: a sound run is correct, and the control (the reference in float8
in the program's place) and each fault the cell can have make it not
correct."""

import time

import pytest
import torch

from h100_bench.harness import runner, spec
from h100_bench.loops import serve, train

SERVE = ["cp-serve-b16", "cp-serve-b16-unsorted"]
TRAIN = ["benchnet-train-b8", "cp-train-b16"]


@pytest.fixture
def f32(monkeypatch):
    """Rehearsals in float32."""
    load = spec.load_cell

    def load_f32(name, *a, **kw):
        cell = load(name, *a, **kw)
        cell.config["rehearsal"] = dict(cell.config["rehearsal"],
                                        dtype="float32")
        return cell

    monkeypatch.setattr(spec, "load_cell", load_f32)


def _run(workload):
    return runner.run(workload, 20261018, 0.3, False, True,
                      time.perf_counter())


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_sound_run_is_correct(f32, workload):
    r = _run(workload)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", SERVE + TRAIN)
def test_control_is_not_correct(f32, monkeypatch, workload):
    def control(self, i):
        return serve.ref_serve(self.s, i % len(self.s.ring), "fp8")

    monkeypatch.setattr(serve.Loop, "__call__", control)
    monkeypatch.setattr(train, "program_steps",
                        lambda loop: train.ref_steps(loop.s, quant="fp8"))
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_answer_swapped_is_not_correct(f32, monkeypatch, workload):
    call = serve.Loop.__call__

    def swapped(self, i):
        out = call(self, i).clone()
        out[0] = out[1]
        return out

    monkeypatch.setattr(serve.Loop, "__call__", swapped)
    r = _run(workload)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("workload", TRAIN)
def test_state_unchanged_is_not_correct(f32, monkeypatch, workload):
    monkeypatch.setattr(train, "sgd_update", lambda params, lr: None)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_half_batch_is_not_correct(f32, monkeypatch, workload):
    fresh = runner.fresh_tensor
    loss = train.train_loss

    def half(features, indices, batch):
        keep = (indices[:, :1] >= 0) & (indices[:, :1] < batch.batch_size
                                         // 2)
        return fresh(torch.where(keep, features, 0),
                     torch.where(keep, indices, -1), batch)

    monkeypatch.setattr(runner, "fresh_tensor", half)
    monkeypatch.setattr(train, "train_loss", lambda out: 2.0 * loss(out))
    assert not _run(workload)["correct"]
