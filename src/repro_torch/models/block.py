"""Published settings of a block that its ``ModelConfig`` does not hold.

A ``ModelConfig`` is the JAX package's (``configs/`` is a verbatim copy of
it), and the JAX package has no gate rule other than renormalised top-k
gates and no rotary scaling. A published model that needs either passes a
`Block` to the serving engine (``ServingEngine(block=...)``), which threads
it to `model.prefill`, `model.decode_step` and `model.loss_fn` as it
threads ``moe_dispatch``. The default `Block` is the JAX package's model,
and a model run with it computes what it computed without one, bit for bit.

* The gate rule of a mixture-of-experts layer (DeepSeek-V2's ``MoEGate``):
  the top-k softmax gates, renormalised to sum to one where
  ``norm_topk_prob`` and kept as they are otherwise. The published
  ``routed_scaling_factor`` is not a setting: the one configuration that
  runs here publishes 1, and its harness family refuses another value.
* `YaRN` rotary scaling of an MLA layer's rope dims (DeepSeek-V2's
  ``DeepseekV2YarnRotaryEmbedding``): blended inverse frequencies, cos and
  sin scaled by ``mscale(f, mscale) / mscale(f, mscale_all_dim)``, and the
  attention's softmax scale times ``mscale(f, mscale_all_dim)**2``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch


def yarn_mscale(factor: float, mscale: float) -> float:
    """``0.1 * mscale * ln(factor) + 1`` (1 where the factor does not
    stretch the context)."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_dim(rotations: float, dim: int, base: float,
                        original: int) -> float:
    """The frequency slot whose wavelength fits `rotations` times into the
    original context."""
    return (dim * math.log(original / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


@dataclasses.dataclass(frozen=True)
class YaRN:
    """The ``rope_scaling`` of type ``yarn`` of a published config."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    def correction_range(self, dim: int, base: float) -> tuple[int, int]:
        """(low, high): the slots between which the frequencies blend."""
        orig = self.original_max_position_embeddings
        low = math.floor(yarn_correction_dim(self.beta_fast, dim, base, orig))
        high = math.ceil(yarn_correction_dim(self.beta_slow, dim, base, orig))
        return max(low, 0), min(high, dim - 1)

    def inv_freq(self, dim: int, base: float) -> torch.Tensor:
        """(dim / 2,) float32: slots below ``low`` keep the base frequency
        (extrapolated), slots above ``high`` take it over ``factor``
        (interpolated), a linear ramp between."""
        exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
        extra = 1.0 / (base ** exps)
        inter = 1.0 / (self.factor * base ** exps)
        low, high = self.correction_range(dim, base)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
                / (high - low)).clamp(0, 1)
        keep = 1.0 - ramp
        return inter * (1 - keep) + extra * keep

    @property
    def cos_sin_scale(self) -> float:
        return (yarn_mscale(self.factor, self.mscale)
                / yarn_mscale(self.factor, self.mscale_all_dim))

    @property
    def softmax_factor(self) -> float:
        """What the attention's softmax scale is multiplied by."""
        if not self.mscale_all_dim:
            return 1.0
        return yarn_mscale(self.factor, self.mscale_all_dim) ** 2


@functools.lru_cache(maxsize=None)
def _freqs_on(yarn: YaRN, dim: int, base: float,
              device: torch.device) -> torch.Tensor:
    # made once a device, by the first (eager) call: a copy to the card
    # inside a captured prefill graph would fail
    return yarn.inv_freq(dim, base).to(device)


@dataclasses.dataclass(frozen=True)
class Block:
    """The published settings (see the module docstring); the defaults are
    the JAX package's model."""
    norm_topk_prob: bool = True
    rope_scaling: Optional[YaRN] = None

    def gates(self, topv: torch.Tensor) -> torch.Tensor:
        """The top-k softmax probabilities (..., k) as the combine weights
        of their experts."""
        if self.norm_topk_prob:
            topv = topv / topv.sum(dim=-1, keepdim=True)
        return topv

    def rope(self, dim: int, base: float, device) -> tuple:
        """(the inverse frequencies (dim / 2,) on `device`, the cos and sin
        scale) of the MLA rope dims; None where the rope is plain."""
        if self.rope_scaling is None:
            return None
        return (_freqs_on(self.rope_scaling, dim, float(base),
                          torch.device(device)),
                self.rope_scaling.cos_sin_scale)

    @property
    def softmax_factor(self) -> float:
        return 1.0 if self.rope_scaling is None \
            else self.rope_scaling.softmax_factor

    def check(self, cfg) -> None:
        """Raise unless `cfg` has the layers each setting acts on: the
        rotary scaling acts on MLA layers alone, the gate rule on MoE
        layers."""
        if self.rope_scaling is not None and cfg.mla is None:
            raise ValueError(f"{cfg.arch_id}: rope_scaling acts on MLA "
                             f"layers, and the model has none")
        if self.norm_topk_prob != DEFAULT.norm_topk_prob \
                and not cfg.n_experts:
            raise ValueError(f"{cfg.arch_id}: a gate rule acts on MoE "
                             f"layers, and the model has none")


DEFAULT = Block()


def of(block: Optional[Block]) -> Block:
    """`block`, or the default settings."""
    return DEFAULT if block is None else block
