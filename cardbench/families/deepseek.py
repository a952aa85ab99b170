"""The ``deepseek`` family (DeepSeekMoE-16B's ``config.json``): the shared
decoder (``_decoder.py``) with the leading ``first_k_dense_replace`` layers
dense and the rest mixtures of experts: a softmax router, the top-k routed
experts and the shared ones.

The published gate rule is the file's ``norm_topk_prob``: false keeps the
top-k softmax gates as they are, true renormalises them to sum to one. The
port's ``ServingEngine`` renormalises; where it takes a ``norm_topk_prob``
argument, the file's rule is passed to it, and until then a file that
keeps the gates is refused.
"""
from __future__ import annotations

import inspect

from cardbench.families import _decoder
from cardbench.families._decoder import Shape, logits, small

__all__ = ["shape", "logits", "port_config", "engine_args", "small"]


def shape(cfg: dict) -> Shape:
    return Shape.of(cfg)


def engine_args(cfg: dict) -> dict:
    """``norm_topk_prob`` as the file gives it, where the engine takes one;
    nothing where the file's rule is the port's own."""
    from repro_torch.serving.engine import ServingEngine
    if "norm_topk_prob" in inspect.signature(ServingEngine).parameters:
        return {"norm_topk_prob": bool(cfg["norm_topk_prob"])}
    if not cfg["norm_topk_prob"]:
        raise ValueError(
            "the configuration keeps the top-k gates as the softmax "
            "gives them (norm_topk_prob false); the port renormalises "
            "them and has no setting to do otherwise")
    return {}


def port_config(cfg: dict):
    """The shared decoder's ``ModelConfig``, for a file whose gate rule
    the port can run (`engine_args`)."""
    engine_args(cfg)
    return _decoder.port_config(cfg)
