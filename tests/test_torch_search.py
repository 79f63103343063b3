"""The port's copy of the Galvatron-BMW search against the JAX package's.

Both packages run the same search on the same workload and cluster; the
port's plans must be byte-identical to the reference's
(``ParallelPlan.canonical_dumps``: every field but the wall-time
telemetry), and so must the search CLI's ``--out`` files up to their
``search_seconds``.  Also: the example plans load to the same canonical
bytes, ``layerspecs_for`` builds equal ``LayerSpec``s, the H100 presets'
fields, and the train driver's ``search_plan`` and remat rule.

The search settings keep each case under about a second (small batch
grids, as the reference's own tests use).
"""
import dataclasses
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE_PLANS = sorted((REPO / "examples" / "plans").glob("*.plan.json"))
GB = 1024 ** 3
PKGS = ("repro", "repro_torch")
SCHEDULES = ("1f1b", "1f1b-interleaved", "zb-h1")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _cluster(pkg, cluster):
    """``cluster`` (either package's ``ClusterSpec``) as ``pkg``'s."""
    hw = _m(pkg, "core.hardware")
    fields = {f.name: getattr(cluster, f.name)
              for f in dataclasses.fields(cluster)}
    fields["device"] = hw.DeviceSpec(**dataclasses.asdict(cluster.device))
    return hw.ClusterSpec(**fields)


def _preset(pkg, name, devices=None):
    c = _m(pkg, "core").CLUSTERS[name]
    return c.with_devices(devices) if devices else c


def _variant(pkg, name, **fields):
    ocfg = _m(pkg, "core").galvatron_variant(name)
    for k, v in fields.items():
        setattr(ocfg, k, v)
    return ocfg


def _paper(pkg, model):
    return _m(pkg, "configs.paper_models").paper_model_specs(model)


def _arch(pkg, arch, seq, **with_):
    cfg = _m(pkg, "configs").get_config(arch)
    if with_:
        cfg = cfg.with_(**with_)
    return _m(pkg, "configs.specs").layerspecs_for(cfg, seq)


def _at_budgets(pkg, specs, cluster, ocfg, budgets_gb, cost_cfg=None):
    opt = _m(pkg, "core").GalvatronOptimizer(specs, cluster, ocfg, cost_cfg)
    frontier = opt.sweep_budgets([b * GB for b in budgets_gb])
    return [None if p.plan is None else p.plan.canonical_dumps()
            for p in frontier.points]


def _bert_schedules(pkg):
    return _at_budgets(pkg, _paper(pkg, "bert-huge-32"),
                       _preset(pkg, "8x-rtx-titan-pcie"),
                       _variant(pkg, "bmw", schedules=SCHEDULES,
                                batch_grid=[8, 16, 32, 64]), [12])


def _bert_variant(name):
    def case(pkg):
        return _at_budgets(pkg, _paper(pkg, "bert-huge-32"),
                           _preset(pkg, "8x-rtx-titan-pcie"),
                           _variant(pkg, name, batch_grid=[16, 32]), [12])
    return case


def _bert_frontier(pkg):
    opt = _m(pkg, "core").GalvatronOptimizer(
        _paper(pkg, "bert-huge-32"), _preset(pkg, "8x-rtx-titan-pcie"),
        _variant(pkg, "bmw", schedules=SCHEDULES, batch_grid=[8, 16]))
    frontier = opt.sweep_budgets([b * GB for b in (4, 8, 12, 16, 20)])
    knees = [p.budget_bytes for p in frontier.knee_points()]
    return [None if p.plan is None else p.plan.canonical_dumps()
            for p in frontier.points] + [json.dumps(knees)]


def _qwen_sp(pkg):
    """The SP example plan's search (``tests/test_sp_search.py``)."""
    core = _m(pkg, "core")
    cost_cfg = _m(pkg, "core.cost_model").CostModelConfig(
        min_samples_per_device=1.0)
    ocfg = _m(pkg, "core.optimizer").OptimizerConfig(
        use_sp=True, batch_grid=(1, 2), micro_candidates=2, n_bins=64)
    return _at_budgets(pkg, _arch(pkg, "qwen3-4b", 131072),
                       core.CLUSTERS["16x-a100-nvlink-ib100"], ocfg, [32],
                       cost_cfg)


def _moe_ep(pkg):
    """``tests/test_ep_search.py``'s MoE flip, specs built by ``pkg``."""
    ls = _m(pkg, "core.layerspec")
    specs = [ls.moe_layer(f"l{i}", 2048, 2048, 16, 16, 8192, 8, 2,
                          capacity_factor=1.25) for i in range(4)]
    ocfg = _m(pkg, "core.optimizer").OptimizerConfig(
        use_ep=True, batch_grid=(8,), micro_candidates=2, n_bins=64)
    return _at_budgets(pkg, specs, _preset(pkg, "8x-rtx-titan-pcie"), ocfg,
                       [6, 12])


def _ssm_arch(arch):
    def case(pkg):
        return _at_budgets(pkg, _arch(pkg, arch, 2048),
                           _preset(pkg, "16x-a100-nvlink-ib100"),
                           _variant(pkg, "bmw", batch_grid=[16, 32]), [20])
    return case


def _gpt3(pkg):
    cluster = _preset(pkg, "32x-a100-80g-ib400")
    ocfg = dict(batch_grid=[32, 64], n_bins=64)
    return (_at_budgets(pkg, _paper(pkg, "gpt3-15b"), cluster,
                        _variant(pkg, "bmw", **ocfg), [80])
            + _at_budgets(pkg, _arch(pkg, "gpt3-15b", 2048), cluster,
                          _variant(pkg, "bmw", **ocfg), [80]))


def _h100_one_card(pkg):
    """Phase 13's search in ``chip_smoke.py``: qwen3-4b at 28 layers and
    4096 tokens on one card of the port's H100 node (the preset handed to
    the reference as its own ``ClusterSpec``), the train driver's ``bmw``
    settings with batch grid [2]."""
    from repro_torch.core import h100_node
    ocfg = _variant(pkg, "bmw", batch_grid=[2], n_bins=96,
                    micro_candidates=2, max_pp=4, schedules=SCHEDULES,
                    vpp_candidates=(2,))
    cluster = _cluster(pkg, h100_node().with_devices(1))
    return _at_budgets(pkg, _arch(pkg, "qwen3-4b", 4096, n_layers=28),
                       cluster, ocfg, [80])


def _moe_arch(arch):
    """A MoE arch cut to 4 layers (full width, every expert) with EP on
    the 32-card A100 preset: the plans put ``ep`` on the expert layers."""
    def case(pkg):
        ocfg = _m(pkg, "core.optimizer").OptimizerConfig(
            use_ep=True, batch_grid=(64,), micro_candidates=2, n_bins=64)
        return _at_budgets(pkg, _arch(pkg, arch, 2048, n_layers=4),
                           _preset(pkg, "32x-a100-80g-ib400"), ocfg, [40, 80])
    return case


SEARCH_CASES = {
    "bert-huge-32/8x-rtx-titan-pcie/12GB/3-schedules": _bert_schedules,
    "bert-huge-32/variant-dp+tp": _bert_variant("dp+tp"),
    "bert-huge-32/variant-galvatron": _bert_variant("galvatron"),
    "bert-huge-32/variant-bmw": _bert_variant("bmw"),
    "bert-huge-32/budget-sweep-frontier": _bert_frontier,
    "qwen3-4b/131072/sp/16x-a100/32GB": _qwen_sp,
    "moe-layers/ep/8x-rtx-titan-pcie": _moe_ep,
    "mamba2-370m/16x-a100-nvlink-ib100": _ssm_arch("mamba2-370m"),
    "zamba2-1.2b/16x-a100-nvlink-ib100": _ssm_arch("zamba2-1.2b"),
    "gpt3-15b/32x-a100-80g-ib400": _gpt3,
    "qwen3-4b/28-layers/h100-one-card": _h100_one_card,
    "arctic-480b/4-layers/ep/32x-a100-80g-ib400": _moe_arch("arctic-480b"),
    "kimi-k2-1t-a32b/4-layers/ep/32x-a100-80g-ib400":
        _moe_arch("kimi-k2-1t-a32b"),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_is_byte_identical_to_the_reference(case):
    ref, port = (SEARCH_CASES[case](pkg) for pkg in PKGS)
    assert any(p is not None for p in ref), "the case finds no plan"
    assert port == ref


@pytest.mark.parametrize("path", EXAMPLE_PLANS, ids=lambda p: p.name)
def test_example_plans_load_to_the_same_canonical_bytes(path):
    from repro.core import ParallelPlan as JaxPlan
    from repro_torch.core import ParallelPlan
    d = json.loads(path.read_text())
    port = ParallelPlan.from_json(d)
    assert port.canonical_dumps() == JaxPlan.from_json(d).canonical_dumps()
    assert ParallelPlan.loads(port.dumps()) == port


def _old_format(version):
    """A plan dict of format ``version``, trimmed as
    ``tests/test_plan_roundtrip.py`` and ``tests/test_plan_lint.py`` build
    them."""
    from repro_torch.core import ParallelPlan, Strategy
    d = ParallelPlan(
        n_devices=8, pp_degree=2, partition=[4, 4],
        strategies=[Strategy((("dp", 2), ("tp", 2)), ckpt=True)] * 8,
        global_batch=64, n_micro=8).to_json()
    drop = {0: ("format_version", "schedule", "vpp_degree", "est_iter_time",
                "est_throughput", "est_stage_mem", "alpha_t", "alpha_m",
                "searched_by", "search_stats", "serving", "sp_degree",
                "seq_len", "ep_degree"),
            1: ("vpp_degree", "search_stats", "serving", "sp_degree",
                "seq_len", "ep_degree"),
            2: ("serving", "sp_degree", "seq_len", "ep_degree"),
            3: ("sp_degree", "seq_len", "ep_degree"),
            4: ("ep_degree",)}[version]
    for k in drop:
        d.pop(k, None)
    if version:
        d["format_version"] = version
    return d


@pytest.mark.parametrize("version", [0, 1, 2, 3, 4])
def test_older_formats_load_to_the_same_canonical_bytes(version):
    from repro.core import ParallelPlan as JaxPlan
    from repro_torch.core import ParallelPlan
    d = _old_format(version)
    port = ParallelPlan.from_json(json.loads(json.dumps(d)))
    assert port.canonical_dumps() == JaxPlan.from_json(d).canonical_dumps()


LAYERSPEC_CASES = [("qwen3-4b", 4096, {}), ("qwen3-4b", 128, {"n_layers": 2}),
                   ("mamba2-370m", 2048, {}), ("zamba2-1.2b", 2048, {}),
                   ("gpt3-15b", 2048, {})]


@pytest.mark.parametrize("arch,seq,with_", LAYERSPEC_CASES,
                         ids=[f"{a}@{s}" for a, s, _ in LAYERSPEC_CASES])
def test_layerspecs_equal_the_reference_field_by_field(arch, seq, with_):
    ref, port = (_arch(pkg, arch, seq, **with_) for pkg in PKGS)
    assert len(port) == len(ref) > 2
    for a, b in zip(ref, port):
        assert dataclasses.asdict(b) == dataclasses.asdict(a), a.name


def test_gpt3_15b_runtime_config_is_registered_as_in_the_reference():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    ref, port = jax_get_config("gpt3-15b"), get_config("gpt3-15b")
    for f in dataclasses.fields(ref):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.dtype == torch.bfloat16


def test_paper_clusters_equal_the_reference_and_tpu_presets_are_left_out():
    from repro.core import CLUSTERS as JAX_CLUSTERS
    from repro_torch.core import CLUSTERS
    for name, ref in JAX_CLUSTERS.items():
        if ref.device.name.startswith("tpu"):
            assert name not in CLUSTERS
            continue
        assert dataclasses.asdict(CLUSTERS[name]) == dataclasses.asdict(ref)
    import repro_torch.core.hardware as hw
    assert not [n for n in dir(hw) if "tpu" in n.lower()]


def test_h100_presets():
    from repro_torch.core import CLUSTERS, H100_SXM, h100_cluster, h100_node
    assert (H100_SXM.name, H100_SXM.peak_flops, H100_SXM.hbm_bytes,
            H100_SXM.hbm_bandwidth, H100_SXM.overlap_slowdown) == (
        "h100-sxm-80g", 989e12, 80 * GB, 3.35e12, 1.3)
    node, cl = h100_node(), h100_cluster()
    assert (node.name, node.n_devices, node.island_size,
            node.intra_island_bandwidth, node.inter_island_bandwidth) == (
        "8x-h100-sxm-nvlink", 8, 8, 450e9, 450e9)
    assert (cl.name, cl.n_devices, cl.island_size, cl.intra_island_bandwidth,
            cl.inter_island_bandwidth) == (
        "64x-h100-sxm-ib400", 64, 8, 450e9, 40e9)
    assert node.device is H100_SXM and cl.device is H100_SXM
    assert CLUSTERS[node.name] == node and CLUSTERS[cl.name] == cl
    assert h100_cluster(16).name == "16x-h100-sxm-ib400"
    one = node.with_devices(1)
    assert one.n_devices == 1 and one.budget() == 80 * GB


def test_bmw_search_on_one_h100_certifies():
    """``chip_smoke.py`` phase 13's plan: the train driver's
    ``search_plan`` on one card of the H100 node with batch grid [2] is the
    reference's plan for that cluster, and it certifies."""
    from repro_torch.analysis import verify_plan_json, verify_program
    from repro_torch.configs import get_config
    from repro_torch.core import h100_node
    from repro_torch.launch.search import certify_plans
    from repro_torch.launch.train import remat_from_plan, search_plan
    from repro_torch.runtime.schedules import compile_schedule
    plan = search_plan(get_config("qwen3-4b").with_(n_layers=28), 4096,
                       cluster=h100_node().with_devices(1), batch_grid=[2])
    assert [plan.canonical_dumps()] == _h100_one_card("repro")
    errors = [d for d in verify_plan_json(plan.to_json())
              + verify_program(compile_schedule(plan.schedule,
                                                plan.pp_degree, plan.n_micro,
                                                plan.vpp_degree))
              if d.severity == "error"]
    assert errors == [] and certify_plans([plan])
    assert plan.n_devices == 1 and plan.global_batch == 2
    # remat as the reference's train driver takes it: the embed layer's
    assert remat_from_plan(plan) == [True]


TRAIN_SEARCH_CASES = [("qwen3-4b", 128), ("mamba2-370m", 64),
                      ("qwen3-4b", 4096)]


@pytest.mark.parametrize("arch,seq", TRAIN_SEARCH_CASES,
                         ids=[f"{a}@{s}" for a, s in TRAIN_SEARCH_CASES])
def test_train_driver_search_plan_matches_the_reference(arch, seq):
    """The port's ``search_plan`` on the reference's default cluster (its
    v5e pod of 64, handed over as a port ``ClusterSpec``) gives the
    reference driver's plan, on reduced configs."""
    from repro.configs import get_config as jax_get_config
    from repro.core import tpu_v5e_pod
    from repro.launch.train import search_plan as jax_search_plan
    from repro_torch.configs import get_config
    from repro_torch.launch.train import remat_from_plan, search_plan
    ref = jax_search_plan(jax_get_config(arch).reduced(n_layers=4), seq)
    port = search_plan(get_config(arch).reduced(n_layers=4), seq,
                       cluster=_cluster("repro_torch", tpu_v5e_pod(64)))
    assert port.canonical_dumps() == ref.canonical_dumps()
    assert remat_from_plan(port) == [s.ckpt for s in ref.strategies[:1]]


def test_train_driver_searches_on_the_64_gpu_h100_preset_by_default():
    from repro_torch.configs import get_config
    from repro_torch.core import GalvatronOptimizer
    from repro_torch.launch import train as train_cli
    seen = []
    real = GalvatronOptimizer.__init__

    def spy(self, specs, cluster, *a, **kw):
        seen.append(cluster.name)
        real(self, specs, cluster, *a, **kw)

    GalvatronOptimizer.__init__ = spy
    try:
        plan = train_cli.search_plan(get_config("qwen3-4b").reduced(), 64)
    finally:
        GalvatronOptimizer.__init__ = real
    assert seen == ["64x-h100-sxm-ib400"] and plan.n_devices == 64


def _cli_out(pkg, argv, path):
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        rc = _m(pkg, "launch.search").main(argv + ["--out", str(path)])
    assert rc == 0
    return path.read_text()


CLI_CASES = {
    "bert-huge-32-12GB": ["--model", "bert-huge-32", "--cluster",
                          "8x-rtx-titan-pcie", "--budget", "12"],
    "qwen3-4b-slo-sweep": ["--arch", "qwen3-4b", "--cluster",
                           "8x-rtx-titan-pcie", "--slo-sweep", "30",
                           "--max-context", "2048"],
    # the MoE archs at full size (their training search finds no plan on
    # a preset both packages have; serving does)
    "arctic-480b-slo-sweep": ["--arch", "arctic-480b", "--cluster",
                              "32x-a100-80g-ib400", "--slo-sweep", "30",
                              "--max-context", "2048"],
    "kimi-k2-1t-a32b-slo-sweep": ["--arch", "kimi-k2-1t-a32b", "--cluster",
                                  "32x-a100-80g-ib400", "--slo-sweep", "60",
                                  "--max-context", "2048"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_search_cli_writes_the_reference_bytes(case, tmp_path):
    """The same bytes, but for the wall time the search took
    (``search_stats.search_seconds``), which is set to 0 on both sides."""
    outs = []
    for pkg in PKGS:
        text = _cli_out(pkg, CLI_CASES[case], tmp_path / f"{pkg}.json")
        d = json.loads(text)
        assert d["search_stats"]["search_seconds"] > 0
        d["search_stats"]["search_seconds"] = 0.0
        assert text == json.dumps(json.loads(text), indent=2) + "\n"
        outs.append(json.dumps(d, indent=2) + "\n")
    assert outs[1] == outs[0]


def _cost_specs(pkg):
    ls = _m(pkg, "core.layerspec")
    return [ls.dense_layer("dense", 4096, 1024, 16, 4, 4096),
            ls.dense_layer("bert", 512, 1280, 20, 20, 5120, causal=False,
                           gated=False, qkv_bias=True,
                           store_attn_matrix=True),
            ls.moe_layer("moe", 2048, 2048, 16, 16, 8192, 8, 2,
                         capacity_factor=1.25),
            ls.ssm_layer("ssm", 2048, 1024)]


@pytest.mark.parametrize("cluster", ["8x-rtx-titan-pcie",
                                     "16x-a100-nvlink-ib100"])
def test_scalar_and_vectorised_costs_equal_the_reference(cluster):
    """``CostModel.layer_costs`` (the scalar path) and
    ``layer_cost_tables`` (the vectorised path the search runs) on every
    strategy of a group of 8, SP and EP included, on both packages."""
    out = []
    for pkg in PKGS:
        core = _m(pkg, "core")
        cm = _m(pkg, "core.cost_model")
        strategy = _m(pkg, "core.strategy")
        model = cm.CostModel(_preset(pkg, cluster),
                             cm.CostModelConfig(min_samples_per_device=1.0))
        strats = core.enumerate_strategies(
            8, paradigms=strategy.PARADIGMS + (strategy.SP, strategy.EP))
        specs = _cost_specs(pkg)
        scalar = [dataclasses.astuple(model.layer_costs(sp, st, 8.0,
                                                        inflight=2))
                  for sp in specs for st in strats]
        tables = model.layer_cost_tables(specs, strats, 8.0, inflight=2)
        out.append((scalar, [json.dumps(np.asarray(getattr(tables, f.name))
                                        .tolist())
                             for f in dataclasses.fields(tables)]))
    assert len(out[1][0]) > 100
    assert out[1] == out[0]
