"""A cell of the benchmark cut to a size the CPU runs in seconds: the same
configuration keys, traffic and settings with the widths of its family's
``small``, few slots, short prompts and a short lead-in. For tests only."""
from __future__ import annotations

from cardbench.core import registry

# the tiny cells' limits, for the numbers their full cells compare; from
# eight seeds on the CPU: the program's widest gap read at most 0.026 on
# the dense cell and its mean gap at most 0.013 on the MoE one, the fp8
# control's at least 0.34 and 0.06
LIMITS = {"max_logit_gap": 0.15, "mean_logit_gap": 0.03}


def cell(name: str, dtype: str = "bfloat16",
         config: str | None = None) -> registry.Cell:
    """The cell `name` cut small; with `config`, on that configuration file
    instead of the cell's (a mixture of experts with the port's
    renormalised gates, norm_topk_prob true, since the port has no other
    rule). A mixture of experts compares the mean gap."""
    c = registry.cell(name)
    base = c.config
    if config is not None:
        base = registry.load_json(registry.BENCH_DIR / "configs"
                                  / f"{config}.json")
        if "n_routed_experts" in base:
            base = dict(base, norm_topk_prob=True)
    cfg = dict(registry.family(base).small(base), torch_dtype=dtype)
    cfg["engine"] = dict(cfg["engine"], max_batch=4, max_seq=256)
    mix = dict(c.traffic, lead_in_s=1.0,
               prompt_tokens=dict(c.traffic["prompt_tokens"], clip=[8, 64]),
               output_tokens=dict(c.traffic["output_tokens"], clip=[4, 12]))
    if mix["loop"] == "closed":
        mix["clients"] = 4
    else:
        mix["tail_s"] = 1.0
    limits = {k: LIMITS[k] for k in c.settings["limits"] if k in LIMITS}
    if "n_routed_experts" in cfg:
        limits = {"mean_logit_gap": LIMITS["mean_logit_gap"]}
    # an open loop fast enough to keep the 4 slots busy on the CPU
    st = dict(c.settings, rate_per_s=40.0, profile_s=1.0, sample_tokens=60,
              limits=dict(limits, min_compared_tokens=20))
    return registry.Cell(name=c.name, chips=1, config=cfg, traffic=mix,
                         settings=st, end_to_end=c.end_to_end,
                         per_layer=c.per_layer)
