"""Tensor parallelism of the Mamba2 block (``models/ssm.py::ssm_block``
with a sharding context), emulated in one process on the CPU.

Each of ``tp`` threads plays one ``model`` rank: it holds the contiguous
column shard of ``in_proj`` and the row shard of ``out_proj`` that the
rule table gives it (the other weights whole, as the rule table
replicates them over ``model``) and
runs ``ssm_block`` with a context whose ``gather_tp`` and
``gather_columns`` concatenate the threads' pieces in rank order;
``to_tp``, ``tp_local``, ``keep_columns`` and ``from_tp`` act as on one
rank, so the sum of the threads' outputs is what
``from_tp``'s sum over ``model`` gives.  It must equal the single-process
block within 1e-5 of its largest magnitude (fp32, reduced mamba2-370m:
8 SSM heads, d_inner 512, state 16).  The column and channel selections
are held against a construction by name from ``[z | x | B | C | dt]``.
"""
import copy
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.ssm import (init_ssm, ssm_block, ssm_tp_columns,
                                    ssm_tp_conv_channels)

torch.set_num_threads(1)

TOL = 1e-5


def _cfg():
    return get_config("mamba2-370m").reduced(n_layers=2).with_(
        dtype=torch.float32)


class _EmulatedRank:
    """What ``ssm_block`` calls on a ``ShardContext``, for one of ``tp``
    threads sharing ``board``."""

    def __init__(self, tp, rank, board, barrier):
        self.tp, self.model_rank = tp, rank
        self._board, self._barrier, self._calls = board, barrier, 0

    def to_tp(self, x):
        return x

    def from_tp(self, x):
        return x

    def tp_local(self, t):
        n = t.shape[-1] // self.tp
        return t[..., self.model_rank * n:(self.model_rank + 1) * n]

    def gather_tp(self, t):
        key = self._calls
        self._calls += 1
        self._board[key, self.model_rank] = t
        self._barrier.wait()
        return torch.cat([self._board[key, r] for r in range(self.tp)], -1)

    gather_columns = gather_tp
    keep_columns = tp_local


def _emulate(p, x, cfg, tp):
    """Each emulated rank's output of ``ssm_block`` on its ``in_proj`` and
    ``out_proj`` shards, in rank order."""
    board, barrier = {}, threading.Barrier(tp)
    outs, errors = [None] * tp, []
    shards = p.in_proj.detach().chunk(tp, dim=-1)
    rows = p.out_proj.detach().chunk(tp, dim=0)

    def run(r):
        try:
            local = copy.deepcopy(p)
            local.in_proj = torch.nn.Parameter(shards[r].clone())
            local.out_proj = torch.nn.Parameter(rows[r].clone())
            with torch.no_grad():
                outs[r] = ssm_block(local, x, cfg,
                                    shard=_EmulatedRank(tp, r, board,
                                                        barrier))
        except BaseException as e:      # a failed rank must not hang others
            barrier.abort()
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs


@pytest.mark.parametrize("tp", [2, 4])
def test_emulated_tp_ranks_sum_to_the_block(tp):
    cfg = _cfg()
    p = init_ssm(cfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():       # nonzero biases, so that slicing shows
        for t in (p.conv_b, p.dt_bias, p.D, p.norm_w):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                     .astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model))
                         .astype(np.float32))
    with torch.no_grad():
        want = ssm_block(p, x, cfg)
    outs = _emulate(p, x, cfg, tp)
    got = torch.stack(outs).sum(0)
    assert got.shape == want.shape
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= TOL, err
    # every rank contributes: no rank's heads are dropped
    assert all(o.abs().max() > 0 for o in outs)


def _names(cfg):
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return ([("z", c // P, c) for c in range(di)]
            + [("x", c // P, c) for c in range(di)]
            + [("B", None, n) for n in range(N)]
            + [("C", None, n) for n in range(N)]
            + [("dt", h, h) for h in range(H)])


def _flatten(ranges):
    return [i for a, b in ranges for i in range(a, b)]


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_selected_columns_are_the_ranks_heads_and_all_of_b_and_c(tp):
    cfg = _cfg()
    H = cfg.ssm_heads
    names = _names(cfg)
    assert len(names) == 2 * cfg.d_inner + 2 * cfg.ssm_state + H
    seen = set()
    for r in range(tp):
        heads = range(r * H // tp, (r + 1) * H // tp)
        want = ([n for n in names if n[0] == "z" and n[1] in heads]
                + [n for n in names if n[0] == "x" and n[1] in heads]
                + [n for n in names if n[0] in ("B", "C")]
                + [n for n in names if n[0] == "dt" and n[1] in heads])
        cols = _flatten(ssm_tp_columns(cfg, tp, r))
        assert [names[c] for c in cols] == want
        seen |= set(cols)
        conv = [n for n in names[cfg.d_inner:] if n[0] != "dt"]
        chans = _flatten(ssm_tp_conv_channels(cfg, tp, r))
        assert [conv[c] for c in chans] == [n for n in want
                                            if n[0] in ("x", "B", "C")]
    assert seen == set(range(len(names)))
