"""The ``llama`` family (Yi-6B's ``config.json``): the shared decoder
(``_decoder.py``) with a dense SwiGLU MLP in every layer and grouped-query
attention."""
from __future__ import annotations

from cardbench.families._decoder import Shape, logits, port_config, small

__all__ = ["shape", "logits", "port_config", "engine_args", "small"]


def shape(cfg: dict) -> Shape:
    return Shape.of(cfg)


def engine_args(cfg: dict) -> dict:
    return {}
