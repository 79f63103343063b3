"""The dense decoder family (Qwen3): pre-norm GQA attention with QK-norm
and RoPE, a SwiGLU MLP, an untied or tied head."""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def port_config(config: Dict[str, Any], base: Optional[Any] = None):
    """The program's config: the registered arch (or ``base``) cut to the
    file's depth, checked against every width of the file."""
    import torch
    from repro_torch.configs import get_config

    base = base if base is not None else get_config(config["port_arch"])
    cfg = base.with_(n_layers=config["num_hidden_layers"],
                     dtype=getattr(torch, config["torch_dtype"]))
    want = dict(d_model=config["hidden_size"],
                d_ff=config["intermediate_size"],
                n_heads=config["num_attention_heads"],
                n_kv_heads=config["num_key_value_heads"],
                dh=config["head_dim"], vocab_size=config["vocab_size"],
                rope_theta=float(config["rope_theta"]),
                norm_eps=float(config["rms_norm_eps"]),
                tie_embeddings=config["tie_word_embeddings"],
                qkv_bias=config["attention_bias"], qk_norm=True,
                arch_type="dense", n_experts=0)
    have = {k: getattr(cfg, k) for k in want}
    if have != want:
        raise ValueError(f"the program's {cfg.name} differs from the "
                         f"benchmark's file: {have} != {want}")
    return cfg


def leaves(config: Dict[str, Any]) -> List[Dict[str, Any]]:
    d, f = config["hidden_size"], config["intermediate_size"]
    H, KV, dh = (config["num_attention_heads"], config["num_key_value_heads"],
                 config["head_dim"])
    V, dt = config["vocab_size"], config["torch_dtype"]

    def leaf(name, shape, init):
        return {"name": name, "shape": list(shape), "dtype": dt, "init": init}

    out = [leaf("embed", (V, d), ["normal", 0.02])]
    for i in range(config["num_hidden_layers"]):
        p = f"blocks.{i}."
        out += [leaf(p + "ln1", (d,), ["const", 1.0]),
                leaf(p + "attn.wq", (d, H * dh), ["normal", d ** -0.5]),
                leaf(p + "attn.wk", (d, KV * dh), ["normal", d ** -0.5]),
                leaf(p + "attn.wv", (d, KV * dh), ["normal", d ** -0.5]),
                leaf(p + "attn.wo", (H * dh, d), ["normal", (H * dh) ** -0.5]),
                leaf(p + "attn.q_norm", (dh,), ["const", 1.0]),
                leaf(p + "attn.k_norm", (dh,), ["const", 1.0]),
                leaf(p + "ln2", (d,), ["const", 1.0]),
                leaf(p + "mlp.w_gate", (d, f), ["normal", d ** -0.5]),
                leaf(p + "mlp.w_up", (d, f), ["normal", d ** -0.5]),
                leaf(p + "mlp.w_down", (f, d), ["normal", f ** -0.5])]
    out.append(leaf("final_norm", (d,), ["const", 1.0]))
    if not config["tie_word_embeddings"]:
        out.append(leaf("head", (d, V), ["normal", d ** -0.5]))
    return out


def vocab(config: Dict[str, Any]) -> int:
    return config["vocab_size"]
