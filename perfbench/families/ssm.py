"""The Mamba2 family: pre-norm Mamba2 blocks (SSD), a tied head."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from perfbench.counts.ssm import padded_vocab


def dims(config: Dict[str, Any]) -> Dict[str, int]:
    d = config["d_model"]
    di = config["expand"] * d
    return dict(d=d, di=di, H=di // config["headdim"], P=config["headdim"],
                N=config["d_state"], K=config["d_conv"],
                G=config["ngroups"], V=padded_vocab(config),
                L=config["n_layer"], Q=config["chunk_size"])


def port_config(config: Dict[str, Any], base: Optional[Any] = None):
    """The program's config: the registered arch (or ``base``) at the
    file's depth and padded vocabulary, checked against every width of
    the file."""
    import torch
    from repro_torch.configs import get_config

    base = base if base is not None else get_config(config["port_arch"])
    cfg = base.with_(n_layers=config["n_layer"],
                     vocab_size=padded_vocab(config),
                     dtype=getattr(torch, config["torch_dtype"]))
    x = dims(config)
    want = dict(d_model=x["d"], d_inner=x["di"], ssm_heads=x["H"],
                ssm_head_dim=x["P"], ssm_state=x["N"], ssm_conv=x["K"],
                ssm_chunk=x["Q"], vocab_size=x["V"],
                norm_eps=float(config["rms_norm_eps"]),
                tie_embeddings=config["tie_embeddings"], arch_type="ssm")
    have = {k: getattr(cfg, k) for k in want}
    if have != want or x["G"] != 1 or config["norm_before_gate"]:
        raise ValueError(f"the program's {cfg.name} differs from the "
                         f"benchmark's file: {have} != {want} (the program "
                         "runs one B/C group, the norm after the gate)")
    return cfg


def leaves(config: Dict[str, Any]) -> List[Dict[str, Any]]:
    x = dims(config)
    d, di, H, N, K = x["d"], x["di"], x["H"], x["N"], x["K"]
    dt = config["torch_dtype"]
    conv = di + 2 * N

    def leaf(name, shape, init, dtype=dt):
        return {"name": name, "shape": list(shape), "dtype": dtype,
                "init": init}

    out = [leaf("embed", (x["V"], d), ["normal", 0.02])]
    for i in range(x["L"]):
        p = f"blocks.{i}."
        out += [leaf(p + "ln1", (d,), ["const", 1.0]),
                leaf(p + "ssm.in_proj", (d, 2 * di + 2 * N + H),
                     ["normal", d ** -0.5]),
                leaf(p + "ssm.conv_w", (K, conv), ["normal", K ** -0.5]),
                leaf(p + "ssm.conv_b", (conv,), ["uniform", -0.5, 0.5]),
                leaf(p + "ssm.A_log", (H,), ["log_uniform", 1.0, 16.0],
                     "float32"),
                leaf(p + "ssm.D", (H,), ["const", 1.0], "float32"),
                leaf(p + "ssm.dt_bias", (H,),
                     ["inv_softplus_log_uniform", 0.001, 0.1], "float32"),
                leaf(p + "ssm.norm_w", (di,), ["const", 1.0]),
                leaf(p + "ssm.out_proj", (di, d), ["normal", di ** -0.5])]
    out.append(leaf("final_norm", (d,), ["const", 1.0]))
    return out


def vocab(config: Dict[str, Any]) -> int:
    """The ids the traffic draws: the published vocabulary, not the
    table's padding rows."""
    return config["vocab_size"]
