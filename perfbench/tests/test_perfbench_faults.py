"""A run whose timed path is broken comes out not correct under the cells'
own limits: a step that leaves the state unchanged, a step that leaves
half of the batch out (the mean over the rest), and the control, the
reference computed in fp8 in the program's place.  The runs skip the
look for a card and run the program's plain path on the CPU at tiny
widths; each fault is planted under the harness, in the executor's
training step."""
import time

import pytest
import torch
from perfbench_tiny import tiny

from perfbench import judge, train


def _run(family, monkeypatch, broken):
    from repro_torch.runtime import executor

    make = executor.make_train_step

    def make_broken(*args, **kwargs):
        return broken(make(*args, **kwargs))

    monkeypatch.setattr(executor, "make_train_step", make_broken)
    cell, base = tiny(family)
    return train.run(cell, 99, 0.2, False, torch.device("cpu"),
                     time.perf_counter(), base_config=base,
                     log=lambda m: None)


def _unchanged(step):
    def run(params, opt_state, batch):
        from repro_torch.models.transformer import lm_loss
        return {"loss": lm_loss(params, batch, _unchanged.cfg).detach()}
    return run


def _half_batch(step):
    def run(params, opt_state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(params, opt_state, half)
    return run


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_state_left_unchanged_is_not_correct(family, monkeypatch):
    from perfbench import families  # noqa: F401
    import importlib
    cell, base = tiny(family)
    fam = importlib.import_module(f"perfbench.families.{family}")
    _unchanged.cfg = fam.port_config(cell.config, base)
    out = _run(family, monkeypatch, _unchanged)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_half_batch_is_not_correct(family, monkeypatch):
    out = _run(family, monkeypatch, _half_batch)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_fp8_control_is_not_correct(family):
    cell, base = tiny(family)
    dev = torch.device("cpu")
    from perfbench import traffic
    import importlib
    fam = importlib.import_module(f"perfbench.families.{family}")
    leaves = fam.leaves(cell.config)
    n = cell.spec["checked_steps"]
    seeds = [3, 4, 5]
    for seed in seeds:
        batches = traffic.make_batches(cell.traffic, fam.vocab(cell.config),
                                       seed)[:n]
        ref = train.reference_readings(cell, leaves, seed, batches, dev)
        ctl = train.reference_readings(cell, leaves, seed, batches, dev,
                                       "fp8")
        ok, checks = judge.verdict(judge.gaps(ctl, ref), cell.spec["limits"])
        assert not ok, checks
