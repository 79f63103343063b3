"""The port's profiler (``repro_torch/core/profiler.py``) against the JAX
package's, on the CPU.

Every case of ``tests/test_profiled_constants.py`` is mirrored against the
port's ``core``.  The deterministic parts are held against
``repro.core.profiler`` on the same inputs: the latency-bandwidth fit, the
arithmetic of ``profile_layerspecs`` (its chain size, repeat and FLOP
scaling and the 0.45 x peak rescale, with both packages' timers replaced by
one function of the workload) and the cache file, read and written across
the two packages.  The port's own cases: ``profile_collectives()`` is
``{}`` without a process group and measures the four kinds over 2 gloo
ranks, the fingerprint's ``platform:kind:count`` form names the group's
backend, the default cache path differs from the reference's, and
``profile_layerspecs`` gives one time per distinct layer name.  Measured
times are not compared: they are this host's.
"""
import json
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core.profiler as jax_profiler
from repro.configs import get_config as jax_get_config
from repro.configs.specs import layerspecs_for as jax_layerspecs_for
from repro.core.hardware import CollectiveProfile as JaxCollectiveProfile
from repro_torch.configs import get_config
from repro_torch.configs.specs import layerspecs_for
from repro_torch.core import (CollectiveProfile, CostModel,
                              enumerate_strategies, paper_8gpu,
                              paper_16gpu_low)
from repro_torch.core.hardware import COLLECTIVE_KINDS
from repro_torch.core.layerspec import dense_layer, head_layer
from repro_torch.core import profiler as torch_profiler
from repro_torch.core.profiler import (_lstsq_latency_bandwidth,
                                       cached_collective_profiles,
                                       default_profile_cache_path,
                                       device_fingerprint,
                                       load_collective_profiles,
                                       measure_matmul_throughput,
                                       profile_collectives,
                                       profile_layerspecs, profiled_cluster,
                                       save_collective_profiles)
from repro_torch.launch.mesh import init_distributed, run_ranks

torch.set_num_threads(1)

GB = 1024 ** 3

PROFILES = {
    "all_reduce": CollectiveProfile(latency_s=25e-6, bus_bandwidth=180e9,
                                    n_samples=3),
    "ppermute": CollectiveProfile(latency_s=8e-6, bus_bandwidth=220e9,
                                  n_samples=3),
}


# ---------------------------------------------------------------------------
# the cases of tests/test_profiled_constants.py, on the port's core
# ---------------------------------------------------------------------------

def test_with_profiles_roundtrip_and_selection():
    cluster = paper_8gpu()
    prof = cluster.with_profiles(PROFILES)
    assert prof.profiles() == PROFILES
    assert cluster.profiles() == {}
    lat, bw = prof.collective_coeffs("all_reduce", 4)
    assert (lat, bw) == (25e-6, 180e9)
    assert prof.collective_coeffs("all_gather", 4) \
        == (0.0, cluster.bandwidth_for_group(4))
    assert prof.collective_coeffs("all_reduce", 1) \
        == (0.0, cluster.bandwidth_for_group(1))
    big = prof.island_size * 2
    assert prof.collective_coeffs("all_reduce", big) \
        == (0.0, cluster.bandwidth_for_group(big))


def test_no_profiles_is_analytic_identity():
    cluster = paper_16gpu_low()
    for kind in COLLECTIVE_KINDS:
        for g in (1, 2, 8, 16):
            assert cluster.collective_coeffs(kind, g) \
                == (0.0, cluster.bandwidth_for_group(g))


def test_tables_match_scalar_with_latency_profiles():
    cluster = paper_8gpu().with_profiles(PROFILES)
    cm = CostModel(cluster)
    specs = [dense_layer(f"l{i}", 256, 512, 8, 8, 2048,
                         store_attn_matrix=bool(i % 2)) for i in range(4)]
    specs.append(head_layer("head", 256, 512, 32000))
    strategies = enumerate_strategies(8)
    for inflight in (1, 3):
        tb = cm.layer_cost_tables(specs, strategies, 8.0, inflight=inflight)
        for l, sp in enumerate(specs):
            for j, s in enumerate(strategies):
                c = cm.layer_costs(sp, s, 8.0, inflight=inflight)
                assert tb.time_sync[l, j] == pytest.approx(c.time, rel=1e-9)
                assert tb.time_nosync[l, j] == pytest.approx(
                    c.time_nosync, rel=1e-9)
                assert tb.mem_ms[l, j] == pytest.approx(c.mem_ms, rel=1e-9)


def test_profiles_change_costs():
    spec = dense_layer("l0", 512, 1024, 16, 16, 4096)
    base = CostModel(paper_8gpu())
    slow = CostModel(paper_8gpu().with_profiles({
        "all_reduce": CollectiveProfile(latency_s=5e-3, bus_bandwidth=1e9)}))
    strategies = enumerate_strategies(4)
    tp = next(s for s in strategies if s.tp > 1)
    assert slow.layer_costs(spec, tp, 8.0).time \
        > base.layer_costs(spec, tp, 8.0).time


def test_cache_miss_measures_and_writes(tmp_path):
    path = tmp_path / "collectives.json"
    calls = []

    def fake_profile():
        calls.append(1)
        return dict(PROFILES)

    got = cached_collective_profiles(path, fingerprint="test:fake:8",
                                     profile_fn=fake_profile)
    assert got == PROFILES and len(calls) == 1
    again = cached_collective_profiles(
        path, fingerprint="test:fake:8",
        profile_fn=lambda: pytest.fail("cache hit must not re-profile"))
    assert again == PROFILES
    newer = {"all_reduce": CollectiveProfile(1e-6, 300e9, 5)}
    got = cached_collective_profiles(path, fingerprint="test:fake:8",
                                     refresh=True, profile_fn=lambda: newer)
    assert got == newer
    assert load_collective_profiles(path)["test:fake:8"] == newer


def test_cache_merges_fingerprints(tmp_path):
    path = tmp_path / "collectives.json"
    save_collective_profiles(path, {"other:machine:4": PROFILES})
    cached_collective_profiles(path, fingerprint="this:machine:8",
                               profile_fn=lambda: dict(PROFILES))
    assert set(load_collective_profiles(path)) == {"other:machine:4",
                                                   "this:machine:8"}


def test_cache_caches_empty_measurement(tmp_path):
    path = tmp_path / "collectives.json"
    assert cached_collective_profiles(path, fingerprint="cpu:cpu:1",
                                      profile_fn=lambda: {}) == {}
    assert cached_collective_profiles(
        path, fingerprint="cpu:cpu:1",
        profile_fn=lambda: pytest.fail("empty result must be cached")) == {}


def test_corrupt_cache_remeasures(tmp_path):
    path = tmp_path / "collectives.json"
    path.write_text("{not json")
    got = cached_collective_profiles(path, fingerprint="test:fake:8",
                                     profile_fn=lambda: dict(PROFILES))
    assert got == PROFILES
    assert load_collective_profiles(path)["test:fake:8"] == PROFILES


def test_default_cache_path_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_COLLECTIVES_CACHE",
                       str(tmp_path / "c.json"))
    assert default_profile_cache_path() == tmp_path / "c.json"


def test_profile_collectives_safe_without_a_group():
    """One process, no default group: ``{}`` instead of a crash."""
    assert not dist.is_initialized()
    assert profile_collectives() == {}


def test_profile_json_roundtrip(tmp_path):
    path = tmp_path / "collectives.json"
    save_collective_profiles(path, {"fp:x:2": PROFILES})
    assert load_collective_profiles(path)["fp:x:2"] == PROFILES
    raw = json.loads(path.read_text())
    raw["fp:x:2"]["bogus_collective"] = {"latency_s": 1, "bus_bandwidth": 1}
    path.write_text(json.dumps(raw))
    assert set(load_collective_profiles(path)["fp:x:2"]) == set(PROFILES)


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------

def test_default_cache_path_differs_from_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_COLLECTIVES_CACHE", raising=False)
    monkeypatch.delenv("REPRO_COLLECTIVES_CACHE", raising=False)
    assert default_profile_cache_path() != jax_profiler.default_profile_cache_path()
    assert default_profile_cache_path().parent.name == "repro_torch"
    monkeypatch.setenv("REPRO_COLLECTIVES_CACHE", "/elsewhere/c.json")
    assert str(default_profile_cache_path()) != "/elsewhere/c.json"


def test_fingerprint_form_without_a_group():
    assert device_fingerprint("cpu") == "cpu:cpu:1"
    assert re.fullmatch(r"(cpu|cuda):[^:\s]+:\d+", device_fingerprint())


def test_profiled_cluster_unchanged_without_measurements(tmp_path):
    """One process measures nothing: the cluster keeps its analytic
    constants (and the empty result is cached under this fingerprint)."""
    path = tmp_path / "c.json"
    cluster = paper_8gpu()
    assert profiled_cluster(cluster, path) == cluster
    assert load_collective_profiles(path) == {device_fingerprint(): {}}


def test_profile_layerspecs_one_time_per_distinct_name():
    specs = layerspecs_for(get_config("qwen3-4b").reduced(n_layers=3), 32)
    names = [s.name for s in specs]
    got = profile_layerspecs(specs + specs[1:2], device="cpu", iters=1)
    assert list(got) == list(dict.fromkeys(names))
    assert all(t >= 0.0 for t in got.values())
    # same FLOPs, same measurement
    flops = {}
    for s in specs:
        flops.setdefault(round(s.flops_per_sample, 3), set()).add(got[s.name])
    assert all(len(v) == 1 for v in flops.values())
    assert measure_matmul_throughput(64, iters=1, device="cpu") > 0


# ---------------------------------------------------------------------------
# the deterministic parts against repro.core.profiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["linear", "noisy", "flat", "degenerate"])
def test_lstsq_latency_bandwidth_matches_the_reference(case):
    sizes = [2.0 ** 20, 2.0 ** 22, 2.0 ** 24, 2.0 ** 26]
    rng = np.random.default_rng(0)
    times = {
        "linear": [20e-6 + b / 150e9 for b in sizes],
        "noisy": [(20e-6 + b / 150e9) * (1 + 0.1 * rng.standard_normal())
                  for b in sizes],
        # a negative intercept: latency clamps to 0
        "flat": [b / 150e9 - 5e-6 for b in sizes],
        # falling times: the fit falls back to the mean rate
        "degenerate": [4e-3, 3e-3, 2e-3, 1e-3],
    }[case]
    got = _lstsq_latency_bandwidth(sizes, times)
    want = jax_profiler._lstsq_latency_bandwidth(sizes, times)
    assert got.to_json() == want.to_json()
    assert got.latency_s >= 0.0 and got.bus_bandwidth > 0.0


def _fake_time_fn(fn, *args, iters=3, **_):
    """A timer that is a function of the workload alone: the (d, d)
    operand's d, and whether it is the two-operand yardstick."""
    d = args[0].shape[0]
    return 1e-12 * d ** 3 * (2.5 if len(args) == 2 else 1.0)


@pytest.mark.parametrize("peak", [None, 989e12, 1e15])
@pytest.mark.parametrize("arch,seq,reduced", [
    ("qwen3-4b", 4096, False),      # > 2e10 FLOPs: the capped chain
    ("qwen3-4b", 32, True),         # the d 64 floor, one repeat
    ("mamba2-370m", 2048, False),
    ("zamba2-1.2b", 256, True),
])
def test_profile_layerspecs_matches_the_reference(monkeypatch, arch, seq,
                                                  reduced, peak):
    """Both packages' timers replaced by one function of the workload:
    the chain's size, the repeat and FLOP scaling and the 0.45 x peak
    rescale give the same seconds per sample, bit for bit."""
    monkeypatch.setattr(torch_profiler, "_time_fn", _fake_time_fn)
    monkeypatch.setattr(jax_profiler, "_time_fn", _fake_time_fn)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    specs = layerspecs_for(cfg, seq)
    jspecs = jax_layerspecs_for(jcfg, seq)
    assert [(s.name, s.flops_per_sample) for s in specs] \
        == [(s.name, s.flops_per_sample) for s in jspecs]
    got = profile_layerspecs(specs, device_peak_flops=peak, device="cpu")
    want = jax_profiler.profile_layerspecs(jspecs, device_peak_flops=peak)
    assert got == want
    assert any(t > 0.0 for t in got.values())
    if peak is not None:
        # the rescale on layers with FLOPs: achieved / (0.45 x peak)
        base = profile_layerspecs(specs, device="cpu")
        achieved = 2.0 * 1024 ** 3 / _fake_time_fn(
            None, np.ones((1024, 1)), np.ones(1))
        scale = achieved / (0.45 * peak)
        for s in specs:
            if s.flops_per_sample > 0:
                assert got[s.name] == pytest.approx(base[s.name] * scale,
                                                    rel=1e-12)


def test_cache_file_is_shared_with_the_reference(tmp_path):
    """A cache written by either package reads back in the other to the
    same profiles, and both write the same bytes."""
    jax_profiles = {k: JaxCollectiveProfile(p.latency_s, p.bus_bandwidth,
                                            p.n_samples)
                    for k, p in PROFILES.items()}
    by_fp = {"cuda+gloo:NVIDIA-H100-80GB-HBM3:4": PROFILES,
             "cpu:cpu:1": {}}
    jax_by_fp = {"cuda+gloo:NVIDIA-H100-80GB-HBM3:4": jax_profiles,
                 "cpu:cpu:1": {}}
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    save_collective_profiles(ours, by_fp)
    jax_profiler.save_collective_profiles(theirs, jax_by_fp)
    assert ours.read_bytes() == theirs.read_bytes()
    as_json = lambda d: {fp: {k: p.to_json() for k, p in kinds.items()}
                         for fp, kinds in d.items()}
    assert as_json(jax_profiler.load_collective_profiles(ours)) \
        == as_json(by_fp)
    assert load_collective_profiles(theirs) == by_fp


def test_profiler_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        measure_matmul_throughput(64, iters=1)


TIMEOUT_S = 120


def _collective_worker(rank, world, init_file, out_file):
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        prof = profile_collectives((0.0625, 0.25), iters=1)
        fp = device_fingerprint("cpu")
        if rank == 0:
            save_collective_profiles(out_file, {fp: prof})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_profile_collectives_over_two_gloo_ranks(tmp_path):
    """Over a gloo group of 2 every kind is measured, and the fingerprint
    names the backend and the group's size."""
    out = tmp_path / "c.json"
    run_ranks(_collective_worker, (2, str(tmp_path / "rdv"), str(out)), 2,
              timeout_s=TIMEOUT_S)
    (fp, prof), = load_collective_profiles(out).items()
    assert fp == "cpu+gloo:cpu:2"
    assert set(prof) == set(COLLECTIVE_KINDS)
    for p in prof.values():
        assert p.bus_bandwidth > 0 and p.latency_s >= 0 and p.n_samples == 2
