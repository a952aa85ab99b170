"""Edge/cloud server model with an analytic LLM cost model.

The per-request cost model is derived from the deployed model's config
(`repro_torch.configs`):  prefill is compute-bound (2·N_active FLOPs/token), decode
is the max of the compute and weight-streaming (memory-bandwidth) terms — the
same roofline logic used for the TPU dry-run, applied to the cluster.

DVFS frequency tiers (`freq_tiers`) make per-request compute allocation a
schedulable resource: at a tier of relative frequency f, inference time
scales as 1/f and dynamic (active-over-idle) power as f³ — the classic
cubic CV²f law — so energy *per token* scales as f². The table's nominal
tier is f = 1.0 and reproduces the untier'd cost model bit-exactly; the
default table is the single nominal tier, so existing testbeds are
unchanged unless tiers are asked for.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

from repro_torch.configs import get_config

# A defensible DVFS ladder for both Xeon edges and the A100/TPU cloud:
# deep-idle-ish 40%, two intermediate steps, and the nominal clock.
DVFS_TIERS: Tuple[float, ...] = (0.4, 0.55, 0.7, 1.0)


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    name: str
    kind: str                 # "edge" | "cloud"
    arch_id: str              # deployed model
    flops: float              # sustained FLOP/s for LLM inference
    mem_bw: float             # bytes/s effective weight-streaming bandwidth
    power_active: float       # W while computing (at the nominal tier)
    power_idle: float         # W on standby
    tx_power: float           # W attributable to an active transfer
    bandwidth: float          # bits/s uplink capacity
    max_concurrency: int      # batch lanes
    weight_bytes_per_param: float = 1.0   # int8 deployment
    # paged KV-cache pool: 0 blocks = KV memory not modeled (legacy
    # behavior — capacity is lanes only and preemption always re-prefills)
    kv_blocks: int = 0        # block-pool size
    kv_block_tokens: int = 16  # tokens of KV per block
    # DVFS table: selectable relative frequencies, nominal = 1.0. The
    # single-entry default keeps the placement-only cost model bit-exact.
    freq_tiers: Tuple[float, ...] = (1.0,)

    def __post_init__(self):
        if not self.freq_tiers or any(f <= 0.0 for f in self.freq_tiers):
            raise ValueError(f"freq_tiers must be positive, got "
                             f"{self.freq_tiers}")

    # ------------------------------------------------------------------
    @property
    def n_tiers(self) -> int:
        return len(self.freq_tiers)

    @property
    def nominal_tier(self) -> int:
        """Index of the tier closest to frequency 1.0 (the calibration
        point: the spec's flops/mem_bw/power_active describe this tier)."""
        return min(range(len(self.freq_tiers)),
                   key=lambda k: abs(self.freq_tiers[k] - 1.0))

    def tier_freq(self, tier: int = -1) -> float:
        """Relative frequency of `tier`; -1 = nominal (exactly 1.0)."""
        if tier < 0:
            return 1.0
        return float(self.freq_tiers[tier])

    # ------------------------------------------------------------------
    def model_cfg(self):
        return get_config(self.arch_id)

    # The config-derived constants below are immutable per spec but sit on
    # every per-arrival cost prediction; cached_property stores them in the
    # instance __dict__ (legal on a frozen, non-slots dataclass) so the
    # config walk runs once per spec instead of once per predicted time.
    @functools.cached_property
    def _active_params(self) -> float:
        return float(self.model_cfg().active_param_count())

    @functools.cached_property
    def _kv_bytes_per_token(self) -> float:
        return float(self.model_cfg().kv_bytes_per_token())

    @functools.cached_property
    def _decode_weight_stream(self) -> float:
        # same expression decode_step_time evaluated inline before caching
        return (self._active_params * self.weight_bytes_per_param
                / self.mem_bw)

    def active_params(self) -> float:
        return self._active_params

    def prefill_time(self, prompt_tokens: int, tier: int = -1) -> float:
        fl = 2.0 * self._active_params * prompt_tokens
        return fl / self.flops / self.tier_freq(tier)

    def decode_step_time(self, batch: int = 1, tier: int = -1) -> float:
        """Seconds per decode step for a batch (memory- vs compute-bound),
        at DVFS tier `tier` (time ∝ 1/f)."""
        weight_stream = self._decode_weight_stream
        compute = batch * 2.0 * self._active_params / self.flops
        return max(weight_stream, compute) / self.tier_freq(tier)

    def decode_time(self, output_tokens: int, batch: int = 1,
                    tier: int = -1) -> float:
        return output_tokens * self.decode_step_time(batch, tier)

    @functools.cached_property
    def _service_memo(self) -> dict:
        # one-entry memo (cleared on every miss, so it never grows): each
        # dispatched request evaluates service_time twice back-to-back with
        # the same arguments — once in the view's nominal predictor, once
        # in the runtime's realized draw
        return {}

    def service_time(self, prompt_tokens: int, output_tokens: int,
                     batch: int = 1, tier: int = -1) -> float:
        memo = self._service_memo
        key = (prompt_tokens, output_tokens, batch, tier)
        hit = memo.get(key)
        if hit is None:
            hit = self.prefill_time(prompt_tokens, tier) \
                + self.decode_time(output_tokens, batch, tier)
            memo.clear()
            memo[key] = hit
        return hit

    def tx_time(self, payload_bytes: float, share: float = 1.0) -> float:
        """share: fraction of the uplink granted to this transfer."""
        return payload_bytes * 8.0 / (self.bandwidth * max(share, 1e-9))

    def kv_blocks_needed(self, prompt_tokens: int,
                         output_tokens: int) -> int:
        """KV blocks a request occupies end-to-end (prompt + all decoded
        tokens, allocated up front like the paged engine does)."""
        return max(1, math.ceil((prompt_tokens + output_tokens)
                                / self.kv_block_tokens))

    def kv_bytes_per_token(self) -> float:
        """KV-cache bytes one token pins on this server's model — the
        wire size of a KV migration is `blocks × block_tokens × this`."""
        return self._kv_bytes_per_token

    def infer_energy(self, t_inf: float, tier: int = -1,
                     lane_share: float = 1.0) -> float:
        """Active-over-idle energy for `t_inf` seconds on one batch lane —
        the one formula every runtime charges inference with.

        `t_inf` is the *realized* (already tier/share-stretched) window;
        dynamic power scales as f³ with the tier's frequency and linearly
        with the lane share, so per-token energy goes as f² and is
        share-invariant. The nominal tier at full share reproduces the
        untier'd charge bit-exactly."""
        f = self.tier_freq(tier)
        return (self.power_active - self.power_idle) \
            / self.max_concurrency * (f * f * f) * lane_share * t_inf


@dataclasses.dataclass
class ServerState:
    """Mutable per-simulation server bookkeeping."""

    spec: ServerSpec
    busy_until: float = 0.0
    uplink_free_at: float = 0.0
    queued: int = 0
    # accounting
    e_infer: float = 0.0
    e_tx: float = 0.0
    e_idle: float = 0.0
    busy_time: float = 0.0
    tx_busy_time: float = 0.0
    tokens_out: int = 0
    served: int = 0

    def reset(self) -> None:
        self.busy_until = 0.0
        self.uplink_free_at = 0.0
        self.queued = 0
        self.e_infer = self.e_tx = self.e_idle = 0.0
        self.busy_time = self.tx_busy_time = 0.0
        self.tokens_out = 0
        self.served = 0

    def finalize_idle(self, horizon: float) -> None:
        # standby power is a constant baseline over the whole run; dynamic
        # (inference) power is accounted separately in e_infer
        self.e_idle = horizon * self.spec.power_idle

    @property
    def total_energy(self) -> float:
        return self.e_infer + self.e_tx + self.e_idle
