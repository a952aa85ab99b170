"""Where the benchmark meets the system under test, the port
(``repro_torch``): its configuration built from the benchmark's
configuration file, and its serving engine. Nothing else here reads the
program."""
from __future__ import annotations

import dataclasses


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file: the registry's
    architecture with the file's published sizes, norm epsilon and rotary
    base put in. A setting the port cannot express is refused."""
    from repro_torch.configs import get_config
    heads = cfg["num_attention_heads"]
    kw = dict(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
              n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
              head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
              d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
              norm_eps=float(cfg["rms_norm_eps"]),
              rope_theta=float(cfg["rope_theta"]),
              tie_embeddings=bool(cfg["tie_word_embeddings"]),
              dtype=cfg["torch_dtype"], logit_softcap=0.0, sliding_window=0)
    if cfg.get("n_routed_experts"):
        if cfg.get("first_k_dense_replace") != 1:
            raise ValueError("the port keeps exactly one leading dense layer "
                             "in a model with shared experts")
        if not cfg["norm_topk_prob"]:
            raise ValueError(
                "the configuration keeps the top-k gates as the softmax "
                "gives them (norm_topk_prob false); the port renormalises "
                "them and has no setting to do otherwise")
        kw.update(n_experts=cfg["n_routed_experts"],
                  n_shared_experts=cfg["n_shared_experts"],
                  top_k=cfg["num_experts_per_tok"],
                  moe_d_ff=cfg["moe_intermediate_size"])
    return dataclasses.replace(get_config(cfg["arch"]), **kw)


def engine(cfg: dict, params: dict, device):
    """The port's continuous-batching engine over `params`, greedy."""
    from repro_torch.serving.engine import ServingEngine
    e = cfg["engine"]
    return ServingEngine(port_config(cfg), params, max_batch=e["max_batch"],
                         max_seq=e["max_seq"], device=device,
                         temperature=0.0, paged=False,
                         moe_dispatch=e["moe_dispatch"])
