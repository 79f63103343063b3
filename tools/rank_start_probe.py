"""Time what a gloo rank of the port pays before its work, and gloo itself.

Spawns 4 ranks with ``launch/mesh.py::run_ranks`` and prints, for each, the
seconds from the parent's spawn to the rank's function, of its CUDA context,
of its first and second ``init_train_state`` on a (data 2, model 2) mesh
(qwen3-4b at one layer, TP + ZeRO), of its first and second remat loss and
gradients (the first ``torch.utils.checkpoint`` call imports
``torch._dynamo``), then the mean time of a gloo all-reduce of 64 KiB and of
64 MiB of bf16 on the device.  One JSON line a rank.

    python tools/rank_start_probe.py               # on the card
    python tools/rank_start_probe.py --device cpu  # reduced, on the CPU
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
WORLD = 4


def _rank(rank, world, run_dir, device, t_spawn):
    t = time.time()
    out = {"rank": rank, "to_fn_s": t - t_spawn}
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_lm_batches
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (ShardPolicy, init_train_state,
                                     make_sharded_loss)

    def lap(name):
        nonlocal t
        if device == "cuda":
            torch.cuda.synchronize()
        out[name] = time.time() - t
        t = time.time()

    out["imports_s"] = time.time() - t
    t = time.time()
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda")
    lap("context_s")
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous")
    lap("group_s")
    cfg = get_config("qwen3-4b").with_(n_layers=1)
    if device == "cpu":
        cfg = cfg.reduced().with_(n_layers=1)
    mesh = make_local_mesh(2, device_type=device)
    pol = ShardPolicy(tp=True, zero=True, remat_segments=(True,))
    for i in range(2):
        params, _ = init_train_state(cfg, mesh=mesh, policy=pol, seed=0,
                                     opt_cfg=AdamWConfig(lr=1e-4),
                                     device=device)
        lap(f"init_{i}_s")
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(
        synthetic_lm_batches(DataConfig(seq_len=512, global_batch=2,
                                        vocab_size=cfg.vocab_size))).items()}
    loss_fn = make_sharded_loss(cfg, mesh, pol)
    for i in range(2):
        loss_fn(params, batch)
        lap(f"remat_step_{i}_s")
    out["dynamo_imported"] = "torch._dynamo" in sys.modules
    for name, n in (("allreduce_64KiB_ms", 1 << 15),
                    ("allreduce_64MiB_ms", 1 << 25)):
        a = torch.ones(n, dtype=torch.bfloat16, device=device)
        dist.all_reduce(a)
        lap("warm")
        for _ in range(5):
            dist.all_reduce(a)
        lap(name)
        out[name] *= 1e3 / 5
    del out["warm"]
    dist.destroy_process_group()
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in out.items()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import run_ranks

    with tempfile.TemporaryDirectory(prefix="rank_start_probe_") as d:
        t0 = time.time()
        run_ranks(_rank, (WORLD, d, args.device, t0), WORLD, timeout_s=600)
        print(f"4 ranks in {time.time() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
