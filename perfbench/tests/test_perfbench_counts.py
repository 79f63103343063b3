"""The frozen counts against hand-worked numbers and the port's kernel
table (PERF.md section 6: flash forward 0.27800 ms and backward 0.69501
ms by operations at B 2, S 4096, H 32, KV 8, dh 128; the SSD forward
0.04320 ms by bytes at B 8, S 2048, H 32, P 64, N 128)."""
import json

import pytest
from perfbench_tiny import ROOT

from perfbench.counts import attention, dense, ssd, ssm
from perfbench.peaks import least_seconds

H100 = "NVIDIA H100 80GB HBM3"


def _conf(name):
    return json.loads((ROOT / "perfbench" / "configs" / name).read_text())


def test_dense_model_flops_hand_worked():
    conf = _conf("qwen3-8b-l6.json")
    # per layer: q 4096*4096, k and v 4096*1024, o 4096*4096, MLP 3*4096*12288
    block = 16777216 + 2 * 4194304 + 16777216 + 3 * 50331648
    assert block == 192937984
    assert dense.matmul_params(conf) == 6 * block + 4096 * 151936 == 1779957760
    assert dense.model_flops(conf, {"batch": 2, "seq": 4096}) == (
        6 * 1779957760 * 8192 + 12 * 16781312 * 32 * 128 * 6)


def test_ssm_model_flops_hand_worked():
    conf = _conf("mamba2-370m.json")
    block = 1024 * (2 * 2048 + 2 * 128 + 32) + 2048 * 1024
    assert ssm.padded_vocab(conf) == 50288      # 50277 padded to 16
    assert ssm.matmul_params(conf) == 48 * block + 50288 * 1024 == 367640576
    assert ssm.model_flops(conf, {"batch": 8, "seq": 2048}) == (
        6 * 367640576 * 16384 + 12 * 64 * 128 * 32 * 16384 * 48)


@pytest.mark.parametrize("S,T,causal,window", [
    (5, 5, True, None), (4, 6, True, None), (6, 6, True, 3),
    (3, 7, False, None),
    (64, 64, True, 16), (1, 9, True, None)])
def test_admitted_pairs_closed_form_matches_count(S, T, causal, window):
    brute = sum(1 for i in range(S) for j in range(T)
                if (not causal or j <= T - S + i)
                and (window is None or j > T - S + i - window))
    assert attention.admitted_pairs(S, T, causal, window) == brute
    assert attention._pairs(S, T, causal, window) == brute


def test_flash_bounds_match_kernel_table():
    call = {"shapes": [(2, 4096, 32, 128), (2, 4096, 8, 128),
                       (2, 4096, 8, 128)], "itemsize": 2,
            "kwargs": {"causal": True, "window": None}}
    fo, fb, bo, bb = attention.call_cost(call)
    assert attention._pairs(4096, 4096, True, None) * 2 == 16781312
    assert round(least_seconds(fo, fb, H100) * 1e3, 5) == 0.27800
    assert round(least_seconds(bo, bb, H100) * 1e3, 5) == 0.69501
    assert fo / 989e12 > fb / 3.35e12        # bound by operations


def test_ssd_bounds():
    call = {"shapes": [(8, 2048, 32, 64), (8, 2048, 32), (32,),
                       (8, 2048, 1, 128), (8, 2048, 1, 128)], "itemsize": 2}
    fo, fb, bo, bb = ssd.call_cost(call)
    assert fo == 4 * 64 * 128 * 8 * 2048 * 32 and bo == 2 * fo
    # the forward by bytes, as the kernel table has it (0.04320 ms)
    assert round(least_seconds(fo, fb, H100) * 1e3, 4) == 0.0432
    # the backward by bytes here; the table's 0.07817 counts the chunked
    # kernels' operations, not the recurrence's
    assert round(least_seconds(bo, bb, H100) * 1e3, 4) == 0.0664
    assert bb / 3.35e12 > bo / 989e12
