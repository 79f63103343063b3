"""§Perf hillclimb driver: run a (arch, shape) pair with an optimization
variant through the dry run (``launch/dryrun.py::run_one``) and append the
roofline row (tagged) to experiments/perf.jsonl (``repro/launch/
hillclimb.py``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb kimi-shmap
    PYTHONPATH=src python -m repro_torch.launch.hillclimb q72-seq --multi-pod
"""
import json
import pathlib
import sys

VARIANTS = {
    # pair 2: kimi-k2 x train_4k (most collective-bound)
    "kimi-shmap": dict(arch="kimi-k2-1t-a32b", shape="train_4k",
                       config_overrides={"moe_dispatch": "shmap"}),
    "kimi-shmap-seq": dict(arch="kimi-k2-1t-a32b", shape="train_4k",
                           config_overrides={"moe_dispatch": "shmap"},
                           policy_overrides={"seq_shard": True}),
    "kimi-shmap-cf1": dict(arch="kimi-k2-1t-a32b", shape="train_4k",
                           config_overrides={"moe_dispatch": "shmap",
                                             "capacity_factor": 1.0}),
    # pair 3: qwen2-72b x train_4k (flagship dense; memory + collective)
    "q72-seq": dict(arch="qwen2-72b", shape="train_4k",
                    policy_overrides={"seq_shard": True}),
    "q72-seq-nozero": dict(arch="qwen2-72b", shape="train_4k",
                           policy_overrides={"seq_shard": True,
                                             "zero": False}),
    # pair 1: arctic-480b x prefill_32k (worst useful fraction)
    "arctic-shmap": dict(arch="arctic-480b", shape="prefill_32k",
                         config_overrides={"moe_dispatch": "shmap"}),
    "arctic-shmap-cf1": dict(arch="arctic-480b", shape="prefill_32k",
                             config_overrides={"moe_dispatch": "shmap",
                                               "capacity_factor": 1.0}),
    # extra beyond-paper runs
    "q72-prefill-seq": dict(arch="qwen2-72b", shape="prefill_32k",
                            policy_overrides={"seq_shard": True}),
    "qwen3-4b-seq": dict(arch="qwen3-4b", shape="train_4k",
                         policy_overrides={"seq_shard": True}),
    # decode ablation: KV-cache context sharded over model axis (default)
    # vs KV-head sharding fallback
    "q72-decode-noseqcache": dict(arch="qwen2-72b", shape="decode_32k",
                                  policy_overrides={"shard_cache_seq": False}),
}


def main():
    from repro_torch.launch.dryrun import run_one
    name = sys.argv[1]
    spec = VARIANTS[name]
    multi = "--multi-pod" in sys.argv
    row = run_one(spec["arch"], spec["shape"], multi_pod=multi,
                  policy_overrides=spec.get("policy_overrides"),
                  config_overrides=spec.get("config_overrides"),
                  variant=name)
    out = pathlib.Path("experiments/perf.jsonl")
    out.parent.mkdir(exist_ok=True)
    with out.open("a") as f:
        f.write(json.dumps(row) + "\n")
    print("written", name)


if __name__ == "__main__":
    main()
