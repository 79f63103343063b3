#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):

1. print the card's name and power limit (``nvidia-smi``), turn TF32 off,
   build the kernels from the sources in this checkout (``nvcc`` for the
   CUDA C++ flash attention, Triton's compiler for RMSNorm) and print the
   build seconds;
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes, with the stated tolerances;
3. serve full-width qwen3-4b (random bf16 weights from seed 0) through the
   paged continuous-batching engine: 12 requests, prompts of 33-400
   tokens, 16-32 new tokens each; every request must complete and both
   kernels must have launched on this path;
4. serve a reduced fp32 qwen3-4b on the card and on the CPU: the greedy
   tokens must be identical;
5. time each kernel, its plain version and the PyTorch library call for
   the same function at the serving shapes, with the least time the card
   could take (bytes over 3.35 TB/s or operations over 989 TFLOP/s).

The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  It needs a CUDA device and the rest of
the checkout; without either it exits non-zero and prints no result.
"""
import copy
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, tensor / vector

# the serving geometry of phase 3
PAGE_SIZE, MAX_CONTEXT, DECODE_SLOTS = 16, 512, 8
PREFILL_BATCH, PREFILL_CHUNK = 4, 128
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: card, build
# ---------------------------------------------------------------------------

def phase_build():
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.build("flash_attention")
    nvcc_s = time.perf_counter() - t0
    log(f"[build] nvcc flash_attention.cu: {nvcc_s:.1f} s -> "
        f"{lib.relative_to(ROOT)}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
    t0 = time.perf_counter()
    for dt in (torch.bfloat16, torch.float32):
        for d in (2560, 128):
            rmsnorm_cuda(torch.ones(4, d, device="cuda", dtype=dt),
                         torch.ones(d, device="cuda", dtype=dt))
    torch.cuda.synchronize()
    log(f"[build] triton rmsnorm (4 specialisations): "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _i32(vals):
    import torch
    return torch.tensor(vals, dtype=torch.int32, device="cuda")


def flash_cases():
    """(name, B, S, T, kwargs): H=32, KV=8, dh=128 as in qwen3-4b."""
    return [
        ("prefill base 0", 4, 128, 512,
         dict(q_offset=_i32([0] * 4), kv_len=_i32([128, 100, 128, 0]))),
        ("prefill base 256", 4, 128, 512,
         dict(q_offset=_i32([256] * 4), kv_len=_i32([384, 300, 260, 0]))),
        ("decode mixed L", 8, 1, 512,
         dict(q_offset=_i32([0, 5, 100, 255, 256, 511, -1, 37]))),
        ("ragged S=77 T=333", 2, 77, 333, {}),
        ("window 100", 2, 300, 300, dict(window=100)),
        ("all-masked rows", 2, 128, 64, dict(window=1)),
        ("not causal, kv_len", 2, 64, 200,
         dict(causal=False, kv_len=_i32([200, 57]))),
    ]


def phase_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    g = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_attention": 0.0, "rmsnorm": 0.0}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for name, B, S, T, kw in flash_cases():
            q = torch.randn(B, S, 32, 128, generator=g, device="cuda").to(dt)
            k = torch.randn(B, T, 8, 128, generator=g, device="cuda").to(dt)
            v = torch.randn(B, T, 8, 128, generator=g, device="cuda").to(dt)
            out = flash_attention_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = (out.float() - want.float()).abs().max().item()
            log(f"[flash] {dtype:8s} {name:20s} max|diff| {err:.3e} "
                f"(tol {TOL[dtype]:.0e})")
            check(err <= TOL[dtype], f"flash {name} {dtype}: {err}")
            if name == "all-masked rows":
                check(bool((out[:, 64:] == 0).all()),
                      "rows with no admissible key are not exact zeros")
            errs["flash_attention"] = max(errs["flash_attention"], err)
        for shape in [(PREFILL_BATCH * PREFILL_CHUNK, 2560),
                      (PREFILL_BATCH * PREFILL_CHUNK * 32, 128),
                      (DECODE_SLOTS, 2560), (DECODE_SLOTS * 32, 128)]:
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dt)
            w = torch.randn(shape[-1], generator=g, device="cuda").to(dt)
            out = rmsnorm_cuda(x, w, 1e-6).float()
            torch.cuda.synchronize()
            want = ref.rmsnorm_ref(x, w, 1e-6).float()
            err = (out - want).abs().max().item()
            if dtype == "float32":
                ok, tol = err <= TOL[dtype], f"{TOL[dtype]:.0e}"
            else:       # fp32 math, one bf16 rounding: at most one ulp
                ulp = torch.exp2(torch.floor(torch.log2(
                    want.abs().clamp_min(1e-30))) - 7)
                ok, tol = bool(((out - want).abs() <= ulp).all()), "1 ulp"
            log(f"[rmsnorm] {dtype:8s} {str(shape):14s} max|diff| "
                f"{err:.3e} (tol {tol})")
            check(ok, f"rmsnorm {shape} {dtype}: {err}")
            errs["rmsnorm"] = max(errs["rmsnorm"], err)
    return errs


# ---------------------------------------------------------------------------
# phase 3: full-width qwen3-4b through the paged engine
# ---------------------------------------------------------------------------

def phase_serve():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import init_lm
    from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

    cfg = get_config("qwen3-4b")
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[serve] qwen3-4b: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.2f} B params ({n_params * 2 / 1e9:.2f} GB bf16), "
        f"init {time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(page_size=PAGE_SIZE,
                        n_pages=DECODE_SLOTS * MAX_CONTEXT // PAGE_SIZE,
                        decode_slots=DECODE_SLOTS, max_context=MAX_CONTEXT,
                        prefill_batch=PREFILL_BATCH,
                        prefill_chunk=PREFILL_CHUNK)
    # warm-up: Triton compiles its kernel for the serving shapes here, not
    # inside the measured run
    ServingEngine(cfg, params, ecfg, device="cuda").run(
        [ServeRequest(rid="warmup", prompt=list(range(1, 150)), max_new=3)])
    engine = ServingEngine(cfg, params, ecfg, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(rid=f"r{i}",
                         prompt=rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(33, 401))
                                             ).tolist(),
                         max_new=int(rng.integers(16, 33)))
            for i in range(12)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = rmsnorm_cuda.launches = 0
    metrics = engine.run(reqs)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention_cuda.launches,
                "rmsnorm": rmsnorm_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summ = metrics.summary()
    for r in reqs:
        check(r.done and len(r.tokens) == r.max_new,
              f"request {r.rid}: {len(r.tokens)} of {r.max_new} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid}: token out of range")
    check(summ["completed"] == len(reqs), f"completed {summ['completed']}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the serving path")

    # one decode step and one prefill chunk, timed on the engine's pools
    P = ecfg.pages_per_slot
    rows = torch.arange(DECODE_SLOTS * P, dtype=torch.int32,
                        device="cuda").reshape(DECODE_SLOTS, P)
    tok = torch.zeros(DECODE_SLOTS, dtype=torch.int32, device="cuda")
    lens = torch.full((DECODE_SLOTS,), 300, dtype=torch.int32, device="cuda")
    ptok = torch.zeros(PREFILL_BATCH, PREFILL_CHUNK, dtype=torch.int32,
                       device="cuda")
    plen = torch.full((PREFILL_BATCH,), 400, dtype=torch.int32,
                      device="cuda")

    def decode():
        return engine._decode(params, engine.pools, tok, rows, lens)

    def prefill():
        return engine._prefill(params, engine.pools, ptok,
                               rows[:PREFILL_BATCH], 256, plen)

    def launches_of(step):
        before = (flash_attention_cuda.launches, rmsnorm_cuda.launches)
        out = step()
        return out, {"flash_attention":
                     flash_attention_cuda.launches - before[0],
                     "rmsnorm": rmsnorm_cuda.launches - before[1]}

    logits, per_decode = launches_of(decode)
    check(logits.shape == (DECODE_SLOTS, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "decode logits not finite")
    logits, per_prefill = launches_of(prefill)
    check(logits.shape == (PREFILL_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    decode_ms = cuda_ms(decode, iters=10)
    prefill_ms = cuda_ms(prefill, iters=5, warmup=1)
    for name, step, ms in (("decode", decode, decode_ms),
                           ("prefill", prefill, prefill_ms)):
        profile_step(name, step, ms)
    result = {
        "requests": summ["completed"], "new_tokens": summ["new_tokens"],
        "decode_steps": summ["decode_steps"],
        "prefill_chunks": summ["prefill_chunks"],
        "wall_s": summ["wall_s"], "tok_per_s": summ["tok_per_s"],
        "ttft_ms_p50": summ["ttft_ms_p50"], "ttft_ms_p99": summ["ttft_ms_p99"],
        "tok_ms_p50": summ["tok_ms_p50"],
        "decode_step_ms": decode_ms, "prefill_chunk_ms": prefill_ms,
        "peak_mem_gb": peak_gb,
        "launches_per_decode_step": per_decode,
        "launches_per_prefill_chunk": per_prefill,
    }
    log("[serve] " + json.dumps(result))
    return launches


def profile_step(name, step, step_ms, n=3):
    """Device time by kernel over ``n`` steps (torch.profiler), and the
    device's busy share of the step time measured without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] {name} step: device busy {busy_ms:.3f} ms of "
        f"{step_ms:.3f} ms ({100 * busy_ms / step_ms:.1f}%), "
        f"{sum(e.count for e in kernels) // n} kernels per step; top: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f}"
                    f" ms x{e.count // n}" for e in top))


# ---------------------------------------------------------------------------
# phase 4: reduced fp32 model, card vs CPU
# ---------------------------------------------------------------------------

def phase_cpu_vs_card():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

    cfg = get_config("qwen3-4b").reduced().with_(dtype=torch.float32)
    ecfg = EngineConfig(page_size=8, n_pages=48, decode_slots=4,
                        max_context=96, prefill_batch=2, prefill_chunk=16)
    params_cpu = init_lm(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    rng = np.random.default_rng(1)
    spec = [(rng.integers(0, cfg.vocab_size, int(rng.integers(5, 61))
                          ).tolist(), int(rng.integers(4, 11)))
            for _ in range(6)]
    tokens = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        reqs = [ServeRequest(rid=str(i), prompt=p, max_new=n)
                for i, (p, n) in enumerate(spec)]
        ServingEngine(cfg, params, ecfg, device=dev).run(reqs)
        tokens[dev] = [r.tokens for r in reqs]
    same = tokens["cpu"] == tokens["cuda"]
    log(f"[cpu-vs-card] reduced fp32 qwen3-4b, {len(spec)} requests: greedy "
        f"tokens identical: {same}")
    check(same, f"card {tokens['cuda']} != cpu {tokens['cpu']}")


# ---------------------------------------------------------------------------
# phase 5: timings and bounds
# ---------------------------------------------------------------------------

def _bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _flash_timing(B, S, T, q_offset, kv_len):
    """ms of the kernel, its plain version and SDPA, and the bound, at one
    serving shape in bf16 (H=32, KV=8, dh=128)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    H, KV, dh = 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, S, H, dh, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, T, KV, dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, T, KV, dh, generator=g, device="cuda").bfloat16()
    kw = dict(q_offset=_i32(q_offset), kv_len=_i32(kv_len))
    # admissible (query, key) pairs of these inputs, and the keys read
    qpos = kw["q_offset"][:, None].long() + torch.arange(S, device="cuda")
    kpos = torch.arange(T, device="cuda")
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < kw["kv_len"].long()[:, None, None]))
    pairs = mask.sum().item()
    keys = mask.any(1).sum().item()
    n_bytes = 2 * (2 * B * S * H * dh + 2 * keys * KV * dh) + 8 * B
    n_ops = 4 * pairs * H * dh
    bound, by = _bound_ms(n_bytes, n_ops, "bfloat16")
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_mask = mask[:, None]

    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw))
    plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=sdpa_mask, enable_gqa=True))
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib,
                shape=f"B={B} S={S} T={T} H={H} KV={KV} dh={dh} bf16")


def _rmsnorm_timing(rows, d):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    w = torch.randn(d, generator=g, device="cuda").bfloat16()
    bound, by = _bound_ms(2 * (2 * rows * d + d), 4 * rows * d, "bfloat16")
    ms = cuda_ms(lambda: rmsnorm_cuda(x, w, 1e-6))
    plain = cuda_ms(lambda: ref.rmsnorm_ref(x, w, 1e-6))
    lib = cuda_ms(lambda: F.rms_norm(x, (d,), w, 1e-6))
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, shape=f"rows={rows} d={d} bf16")


def phase_timings(errs, launches):
    decode_L = [300] * DECODE_SLOTS
    flash = {
        "decode": _flash_timing(DECODE_SLOTS, 1, MAX_CONTEXT, decode_L,
                                [MAX_CONTEXT] * DECODE_SLOTS),
        "prefill": _flash_timing(PREFILL_BATCH, PREFILL_CHUNK, MAX_CONTEXT,
                                 [256] * PREFILL_BATCH,
                                 [384] * PREFILL_BATCH),
    }
    rms = {
        "decode": _rmsnorm_timing(DECODE_SLOTS, 2560),
        "prefill": _rmsnorm_timing(PREFILL_BATCH * PREFILL_CHUNK, 2560),
        "prefill_qk": _rmsnorm_timing(PREFILL_BATCH * PREFILL_CHUNK * 32, 128),
    }
    kernels = []
    for name, route, source, replaces, by_shape in (
            ("flash_attention", "cuda",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:143", flash),
            ("rmsnorm", "triton", "src/repro_torch/kernels/rmsnorm.py",
             "src/repro/kernels/rmsnorm.py:33", rms)):
        main = by_shape["decode"]       # the shape of every decode step
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name],
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "shapes": by_shape,
        })
        for shape, t in by_shape.items():
            log(f"[time] {name:15s} {shape:10s} {t['shape']:36s} "
                f"kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
                f"library {t['library_ms']:.4f} ms  bound {t['bound_ms']:.5f}"
                f" ms ({t['bound_by']})")
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    try:
        phase_build()
        errs = phase_kernels()
        launches = phase_serve()
        phase_cpu_vs_card()
        kernels = phase_timings(errs, launches)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
