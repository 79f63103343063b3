"""Multi-pod dry run: one rank's step of every (architecture x input shape)
on the production meshes, run on the ``meta`` device; memory and cost
counts and roofline rows (``repro/launch/dryrun.py``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
        [--out results.jsonl] [--isolate]

The reference lowers and compiles each step with XLA on 512 fake CPU
devices, reads per-device FLOPs and bytes from ``cost_analysis()``, parses
the HLO text for collective bytes, and extrapolates from two shallow depths
because XLA counts a scan body once (``probe_depths``).  PyTorch has none
of that.  Here rank 0 of the production mesh (``launch/mesh.py::
make_production_mesh``, a mapping; ``runtime/dry.py::DryMesh``) builds its
shards of the parameters, the AdamW state, the batch and the decode state
on ``meta`` and runs one real ``make_train_step`` / ``make_prefill_step`` /
``make_serve_step`` with no process group, under three counters:

  * ``torch.utils.flop_counter.FlopCounterMode``: the aten FLOPs;
  * ``kernels/meta.py::KernelCharges``: the hand kernels, charged by the
    formulas of their bounds (a ``meta`` tensor runs no kernel);
  * ``runtime/sharding.py::Traffic``: the bytes each collective would
    send, by the reference's opcode names.

Every layer runs, so the counts are the full depth's, with no
extrapolation; ``probe_depths`` is kept for the tests' depths.  A
``TorchDispatchMode`` adds each aten op's input and output bytes (the
unfused upper bound, as XLA:CPU's "bytes accessed" is) and tracks the peak
of the bytes the step allocates (``temp_bytes``).  Nothing here needs a
card or a process group.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.specs import layerspecs_for
from repro_torch.kernels.meta import KernelCharges, charge_kernels
from repro_torch.launch.inputs import (TOKEN_DTYPE, config_for_shape,
                                       decode_dims, input_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.encdec import init_encdec_decode_state
from repro_torch.models.transformer import init_decode_state
from repro_torch.roofline import model_flops, roofline_report
from repro_torch.roofline.analysis import modeled_memory
from repro_torch.runtime.dry import DryMesh
from repro_torch.runtime.executor import (init_serving_params,
                                          init_train_state, make_prefill_step,
                                          make_serve_step, make_train_step)
from repro_torch.runtime.sharding import ShardPolicy, Traffic

ASSIGNED = ["qwen2-72b", "qwen2.5-14b", "internvl2-26b", "kimi-k2-1t-a32b",
            "qwen3-4b", "zamba2-1.2b", "whisper-medium", "mamba2-370m",
            "arctic-480b", "qwen3-8b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

HBM_CAPACITY = 80e9         # one H100 SXM's HBM3


def default_policy(cfg: ModelConfig, mode: str,
                   overrides: Optional[Dict[str, Any]] = None) -> ShardPolicy:
    """Paper-faithful baseline mapping: the Galvatron plan for the
    production cluster resolves to SDP x TP with CKPT for training
    (see EXPERIMENTS.md §Dry-run); serving uses TP only."""
    kw: Dict[str, Any] = {}
    if mode == "train":
        n_seg = 2 if (cfg.n_experts > 1 and cfg.first_k_dense) else 1
        kw = dict(tp=True, zero=True, remat_segments=(True,) * n_seg)
    else:
        kw = dict(tp=True, zero=False)
    kw.update(overrides or {})
    return ShardPolicy(**kw)


def depth_scaled(cfg: ModelConfig, n: int) -> ModelConfig:
    """Same architecture at reduced depth (scan-linear probe point)."""
    kw: Dict[str, Any] = {"n_layers": n}
    if cfg.is_encoder_decoder:
        kw["n_enc_layers"] = n
    return cfg.with_(**kw)


def probe_depths(cfg: ModelConfig):
    """The reference's two shallow probe depths (its XLA counts a scan body
    once; the port runs every layer and needs no probe): the tests' depths
    for a model that keeps the arch's layer pattern."""
    if cfg.arch_type == "hybrid" and cfg.attn_every:
        return cfg.attn_every, 2 * cfg.attn_every
    if cfg.n_experts > 1 and cfg.first_k_dense:
        return cfg.first_k_dense + 1, cfg.first_k_dense + 2
    return 2, 4


def _model_flops_global(cfg: ModelConfig, shape, train: bool) -> float:
    specs = layerspecs_for(config_for_shape(cfg, shape), shape.seq_len)
    n = sum(s.param_count for s in specs)
    n_active = sum(s.active_param_count() for s in specs)
    toks = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    return model_flops(n, toks, active_params=n_active, train=train)


# --------------------------------------------------------------------------
# the counters
# --------------------------------------------------------------------------

# allocations that move no bytes
_NO_TRAFFIC = {"empty", "new_empty", "empty_like", "empty_strided",
               "new_empty_strided"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpBytes(TorchDispatchMode):
    """Each aten op's input and output bytes (``unfused``; views and bare
    allocations move none), and the peak of the bytes held by the tensors
    the ops create (``peak``), each counted from its op until the tensor
    is freed."""

    def __init__(self):
        super().__init__()
        self.unfused = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if func.overloadpacket.__name__ not in _NO_TRAFFIC:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.unfused += sum(_nbytes(t) for t in ins + outs)
        # an op that writes into its input (``add_``, ``out=``) allocates
        # nothing
        if not any(r.alias_info is not None for r in func._schema.returns):
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


def _bytes_of(tree) -> int:
    """Bytes of the distinct tensors in a tree of dicts, lists and
    modules."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    seen, n = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            n += _nbytes(t)
    return n


@dataclasses.dataclass
class DryCounts:
    """One rank's step, counted (:func:`dry_step`)."""
    aten_flops: float
    kernels: KernelCharges
    traffic: Traffic
    unfused_bytes: float        # aten ops' inputs + outputs, kernels' bytes
    param_bytes: int
    optimizer_bytes: int
    input_bytes: int            # the rank's rows of the batch; decode: the
    state_bytes: int            # tokens, and the decode state
    output_bytes: int
    temp_bytes: int

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernels.ops

    @property
    def argument_bytes(self) -> int:
        return (self.param_bytes + self.optimizer_bytes + self.input_bytes
                + self.state_bytes)


def dry_step(cfg: ModelConfig, shape: InputShape, axes: Dict[str, int], *,
             policy: Optional[ShardPolicy] = None,
             policy_overrides: Optional[Dict[str, Any]] = None,
             device: torch.device = "meta") -> DryCounts:
    """Rank 0's step of ``cfg`` at ``shape`` on a mesh of ``axes`` (a
    mapping, ``runtime/dry.py::DryMesh``), on ``device`` (``meta``; a CPU
    run with every axis of size 1 runs the same code on numbers), under
    ``policy`` (default :func:`default_policy` with ``policy_overrides``).
    The parameters and AdamW state are the rank's shards from seed 0, the
    batch ``input_specs``' (the step keeps the rank's rows), a decode
    state ``init_decode_state(shard=)``'s (an encoder-decoder's
    ``init_encdec_decode_state(shard=)``'s, whose encoder pass is set-up,
    not counted).  Raises what the port raises for the combination."""
    mesh = DryMesh(axes)
    mode = "train" if shape.mode == "train" else "serve"
    pol = policy or default_policy(cfg, mode, policy_overrides)
    batch = input_specs(cfg, shape)
    if torch.device(device).type != "meta":     # numbers, from seed 0
        g = torch.Generator().manual_seed(0)
        batch = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                                   dtype=v.dtype)
                     if v.dtype == TOKEN_DTYPE
                     else torch.randn(v.shape, generator=g)).to(device)
                 for k, v in batch.items()}
    opt: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    if shape.mode == "train":
        params, opt = init_train_state(cfg, mesh=mesh, policy=pol,
                                       device=device)
        step = make_train_step(cfg, mesh=mesh, policy=pol)
        local = step.shard.local_batch(batch, params.embed.device)
        args = (params, opt, batch)
    else:
        params = init_serving_params(cfg, mesh=mesh, policy=pol,
                                     device=device)
        if shape.mode == "prefill":
            step = make_prefill_step(cfg, mesh=mesh, policy=pol)
            lo, hi = step.shard.lane_range(shape.global_batch)
            local = {k: v[lo:hi] for k, v in batch.items()}
            args = (params, batch)
        else:
            step = make_serve_step(cfg, mesh=mesh, policy=pol)
            B, context = decode_dims(cfg, shape)
            if cfg.is_encoder_decoder:
                state = init_encdec_decode_state(
                    params, batch["frames"], cfg, context, shard=step.shard)
            else:
                state = init_decode_state(cfg, B, context, device=device,
                                          shard=step.shard)
            local = {"tokens": torch.zeros(B, dtype=TOKEN_DTYPE,
                                           device=device)}
            args = (params, state, local["tokens"])
    step.shard.traffic = Traffic()      # the step's own bytes only
    flops, charges, op_bytes = FlopCounterMode(display=False), \
        KernelCharges(), OpBytes()
    with flops, op_bytes, charge_kernels(charges):
        out = step(*args)
    return DryCounts(
        aten_flops=float(flops.get_total_flops()), kernels=charges,
        traffic=step.shard.traffic,
        unfused_bytes=float(op_bytes.unfused + charges.bytes),
        param_bytes=_bytes_of(params), optimizer_bytes=_bytes_of(opt),
        input_bytes=_bytes_of(local),
        state_bytes=_bytes_of({k: v for k, v in state.items()
                               if k != "layout"}),
        output_bytes=_bytes_of(out), temp_bytes=op_bytes.peak)


# --------------------------------------------------------------------------
# one row
# --------------------------------------------------------------------------

def _mesh_name(axes: Dict[str, int]) -> str:
    return "x".join(str(n) for n in axes.values())


def _cache_total(cfg: ModelConfig, shape: InputShape) -> float:
    """The reference's global KV/SSM cache bytes of a decode shape."""
    cache_total = 0.0
    if cfg.arch_type in ("ssm", "hybrid"):
        n_ssm = cfg.n_layers
        cache_total += n_ssm * shape.global_batch * cfg.ssm_heads \
            * cfg.ssm_head_dim * cfg.ssm_state * 4.0
    if cfg.arch_type != "ssm" and cfg.n_kv_heads:
        span = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        n_attn = (cfg.n_layers if cfg.arch_type != "hybrid"
                  else max(1, cfg.n_layers // (cfg.attn_every or 6)))
        cache_total += n_attn * shape.global_batch * span \
            * cfg.n_kv_heads * cfg.dh * 2 * 2.0
    return cache_total


def dry_row(cfg: ModelConfig, shape: InputShape, axes: Dict[str, int], *,
            arch: str, policy: Optional[ShardPolicy] = None,
            policy_overrides: Optional[Dict[str, Any]] = None,
            variant: str = "baseline") -> Dict[str, Any]:
    """The dry run's row for ``cfg`` at ``shape`` on a mesh of ``axes``
    (:func:`dry_step` under ``policy``, default :func:`default_policy` with
    ``policy_overrides``): the reference's keys where the meaning holds
    (README, "the dry run")."""
    mesh_name = _mesh_name(axes)
    chips = 1
    for n in axes.values():
        chips *= n
    t0 = time.time()
    c = dry_step(cfg, shape, axes, policy=policy,
                 policy_overrides=policy_overrides)

    rep = roofline_report(
        arch=arch, shape=shape.name, mesh_name=mesh_name, chips=chips,
        cost_analysis={"flops": c.flops, "bytes accessed": c.unfused_bytes},
        collectives=c.traffic.per_op,
        model_flops_global=_model_flops_global(cfg, shape,
                                               shape.mode == "train"))

    # modeled (fusion-aware) HBM traffic + residency; keep the raw unfused
    # count alongside as an upper bound.
    specs = layerspecs_for(cfg, shape.seq_len)
    cache_total = _cache_total(cfg, shape) if shape.mode == "decode" else 0.0
    tp = axes.get("model", 1)
    seq = (policy.seq_shard if policy is not None
           else (policy_overrides or {}).get("seq_shard"))
    seq_shard = tp if seq else 1
    mm = modeled_memory(
        specs, mode=shape.mode, chips=chips, tp=tp,
        data_shards=chips // tp, remat=shape.mode == "train",
        batch=shape.global_batch, cache_bytes_total=cache_total,
        hbm_capacity=HBM_CAPACITY, seq_shard=seq_shard)
    rep.t_memory, raw_t_memory = mm.t_memory(), rep.t_memory

    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "mode": shape.mode, "chips": chips, "variant": variant,
        "compile_seconds": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes": c.argument_bytes,
            "output_bytes": c.output_bytes,
            "temp_bytes": c.temp_bytes,
            "generated_code_bytes": None,
            "param_bytes": c.param_bytes,
            "optimizer_bytes": c.optimizer_bytes,
            "input_bytes": c.input_bytes,
            "state_bytes": c.state_bytes,
        },
        "t_memory_unfused_s": raw_t_memory,
        "modeled_resident_bytes_per_device": mm.resident_bytes_per_device,
        "modeled_fits_80g": mm.fits,
        "aten_flops": c.aten_flops,
        "kernel_flops": c.kernels.ops,
        "kernels": c.kernels.by_kernel,
        "bytes_sent": c.traffic.bytes_sent,
        **rep.row(),
    }


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            policy_overrides: Optional[Dict[str, Any]] = None,
            config_overrides: Optional[Dict[str, Any]] = None,
            variant: str = "baseline",
            verbose: bool = True) -> Dict[str, Any]:
    shape = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(get_config(arch), shape)
    if config_overrides:
        cfg = cfg.with_(**config_overrides)
    row = dry_row(cfg, shape, make_production_mesh(multi_pod=multi_pod),
                  arch=arch, policy_overrides=policy_overrides,
                  variant=variant)
    if verbose:
        print(f"[{arch} x {shape_name} x {row['mesh']}] "
              f"dry={row['compile_seconds']}s "
              f"bottleneck={row['bottleneck']} "
              f"t=(c{row['t_compute_s']:.4f} m{row['t_memory_s']:.4f} "
              f"x{row['t_collective_s']:.4f})s "
              f"useful={row['useful_flops_ratio']:.2f}")
        print("  memory:", row["memory"])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=list_archs(), default=None)
    ap.add_argument("--shape", choices=SHAPES, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--isolate", action="store_true",
                    help="run each combo in its own subprocess")
    args = ap.parse_args(argv)

    combos = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        for a in ASSIGNED:
            for s in SHAPES:
                for mp in meshes:
                    combos.append((a, s, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape, mp) for mp in meshes]

    out_path = pathlib.Path(args.out) if args.out else None
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)

    def emit(row):
        if out_path:
            with out_path.open("a") as f:
                f.write(json.dumps(row) + "\n")

    n_ok, failures = 0, []
    if args.isolate:
        # one subprocess per combo: a killed run only loses that combo, and
        # each run's memory is returned to the OS afterwards.
        import subprocess
        done = set()
        if out_path and out_path.exists():
            for line in out_path.read_text().splitlines():
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except Exception:
                    pass
        for a, s, mp in combos:
            key = (a, s, _mesh_name(make_production_mesh(multi_pod=mp)))
            if key in done:
                print(f"[skip cached] {key}")
                n_ok += 1
                continue
            cmd = [sys.executable, "-u", "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s]
            if mp:
                cmd.append("--multi-pod")
            if args.out:
                cmd += ["--out", str(out_path)]
            res = subprocess.run(cmd, timeout=3600)
            if res.returncode == 0:
                n_ok += 1
            else:
                failures.append((a, s, mp, f"rc={res.returncode}"))
    else:
        for a, s, mp in combos:
            try:
                emit(run_one(a, s, multi_pod=mp))
                n_ok += 1
            except Exception as e:  # noqa: BLE001 — report all failures
                traceback.print_exc()
                failures.append((a, s, mp, repr(e)))
    print(f"\ndry-run: {n_ok} ok, {len(failures)} failed", flush=True)
    for f_ in failures:
        print("  FAIL", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
