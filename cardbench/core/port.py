"""Where the benchmark meets the system under test, the port
(``repro_torch``): its configuration built from the benchmark's
configuration file, and its serving engine, each by the configuration's
family (``families/<model_type>.py``). Nothing else here reads the
program."""
from __future__ import annotations

from cardbench.core import registry


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file (the family's
    ``port_config``; a setting the port cannot express is refused)."""
    return registry.family(cfg).port_config(cfg)


def engine(cfg: dict, params: dict, device):
    """The port's continuous-batching engine over `params`, greedy, with
    the file's ``engine`` sizes and its family's ``engine_args``."""
    from repro_torch.serving.engine import ServingEngine
    fam = registry.family(cfg)
    e = cfg["engine"]
    return ServingEngine(fam.port_config(cfg), params,
                         max_batch=e["max_batch"], max_seq=e["max_seq"],
                         device=device, temperature=0.0, paged=False,
                         moe_dispatch=e["moe_dispatch"],
                         **fam.engine_args(cfg))
