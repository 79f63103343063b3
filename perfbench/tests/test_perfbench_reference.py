"""The plain references against the program's plain path at tiny widths
on the CPU (fp32): the same losses, gradients and AdamW changes; and the
harness's whole run at that size comes out correct under the cells' own
limits."""
import time

import pytest
import torch
from perfbench_tiny import tiny

from perfbench import judge, train


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_reference_matches_program_on_cpu(family):
    cell, base = tiny(family)
    dev = torch.device("cpu")
    seed = 2 ** 31 + 77
    pg = train.build(cell, seed, dev, base)
    n = cell.spec["checked_steps"]
    prog = train.program_readings(pg.step, pg.params, pg.opt_state,
                                  pg.batches[:n], pg.leaves, seed, pg.beta1,
                                  dev)
    ref = train.reference_readings(cell, pg.leaves, seed, pg.batches[:n],
                                   dev)
    g = judge.gaps(prog, ref)
    assert g["loss_gap"] < 1e-6
    assert g["grad_gap"] < 1e-5
    assert g["change_gap"] < 1e-4
    assert not g["left_out"]


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_run_is_correct_on_cpu(family):
    cell, base = tiny(family)
    out = train.run(cell, 5, 0.2, False, torch.device("cpu"),
                    time.perf_counter(), base_config=base, log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["attempted"] > cell.spec["checked_steps"]
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_seed_gives_same_weights_and_batches():
    from perfbench import traffic, weights
    from perfbench.families import ssm

    cell, _ = tiny("ssm")
    leaves = ssm.leaves(cell.config)
    a = dict(weights.draw(leaves, 12345678901, "cpu"))
    b = dict(weights.draw(leaves, 12345678901, "cpu"))
    c = dict(weights.draw(leaves, 12345678902, "cpu"))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert (a["blocks.0.ssm.A_log"].exp() >= 1).all()
    assert (a["blocks.0.ssm.A_log"].exp() <= 16).all()
    step = torch.nn.functional.softplus(a["blocks.0.ssm.dt_bias"])
    assert (step >= 1e-3 - 1e-7).all() and (step <= 0.1 + 1e-7).all()
    x = traffic.make_batches(cell.traffic, 512, 2 ** 33)
    y = traffic.make_batches(cell.traffic, 512, 2 ** 33)
    assert all(torch.equal(p["tokens"], q["tokens"]) for p, q in zip(x, y))
    assert torch.equal(x[0]["tokens"][:, 1:], x[0]["labels"][:, :-1])
    rows = [tuple(r.tolist()) for b in x for r in b["tokens"]]
    assert len(set(rows)) == len(rows)
