"""Testbed factories.

`paper_testbed` mirrors PerLLM §4.1: five Xeon-4214R edge servers (one of
{Yi-6B, LLaMA2-7B, LLaMA3-8B, Yi-9B} per experiment) and one A100-40GB cloud
server running LLaMA2-33B; 100 Mbps edge / 300 Mbps cloud links.

`tpu_testbed` is the TPU-native adaptation (DESIGN.md §3): the cloud is a
v5e pod slice whose throughput constants come from this repo's own dry-run
roofline (197 TF/s bf16 and 819 GB/s HBM per chip).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.cluster.server import DVFS_TIERS, ServerSpec

# Sustained-rate calibration (DESIGN.md §3): public spec sheets derated to
# realistic LLM-serving efficiency.
XEON_4214R_FLOPS = 3.0e12       # AVX-512 VNNI int8 effective
XEON_MEM_BW = 80e9              # 6-ch DDR4-2933 @ ~57% efficiency
A100_FLOPS = 150e12             # bf16 sustained (of 312 peak)
A100_MEM_BW = 1.45e12           # of 1.55 TB/s
V5E_FLOPS = 0.55 * 197e12      # bf16 sustained per chip
V5E_MEM_BW = 0.75 * 819e9

MBPS = 1e6  # bits/s


def paper_testbed(edge_arch: str = "llama2-7b", n_edge: int = 5,
                  cloud_arch: str = "llama2-33b", kv_blocks: int = 0,
                  cloud_kv_blocks: int = -1,
                  kv_block_tokens: int = 16,
                  freq_tiers: Tuple[float, ...] = (1.0,),
                  ) -> List[ServerSpec]:
    """`kv_blocks > 0` models each edge's paged KV-cache pool (and the
    cloud's, default 4× the edge pool), making KV memory a schedulable
    resource; the default 0 keeps the legacy lanes-only capacity model.
    `kv_block_tokens` defaults to the `ServerSpec`/`ServingEngine` block
    granularity — keep them equal, C5 slack mixes units otherwise.
    `freq_tiers` is every server's DVFS table (e.g. the stock
    `repro_torch.cluster.server.DVFS_TIERS` ladder); the single-nominal default
    keeps the testbed bit-exact with the pre-allocation cost model."""
    if cloud_kv_blocks < 0:
        cloud_kv_blocks = 4 * kv_blocks
    edges = [
        ServerSpec(
            name=f"edge{i}", kind="edge", arch_id=edge_arch,
            flops=XEON_4214R_FLOPS, mem_bw=XEON_MEM_BW,
            power_active=130.0, power_idle=55.0, tx_power=15.0,
            bandwidth=100 * MBPS, max_concurrency=8,
            weight_bytes_per_param=1.0,     # int8 edge deployment
            kv_blocks=kv_blocks, kv_block_tokens=kv_block_tokens,
            freq_tiers=freq_tiers)
        for i in range(n_edge)
    ]
    cloud = ServerSpec(
        name="cloud", kind="cloud", arch_id=cloud_arch,
        flops=A100_FLOPS, mem_bw=A100_MEM_BW,
        power_active=520.0, power_idle=120.0, tx_power=30.0,
        bandwidth=300 * MBPS, max_concurrency=16,
        weight_bytes_per_param=2.0,         # bf16 cloud deployment
        kv_blocks=cloud_kv_blocks, kv_block_tokens=kv_block_tokens,
        freq_tiers=freq_tiers)
    return edges + [cloud]


def tpu_testbed(edge_arch: str = "gemma-2b", n_edge: int = 5,
                cloud_arch: str = "gemma3-27b",
                cloud_chips: int = 4,
                freq_tiers: Tuple[float, ...] = (1.0,)) -> List[ServerSpec]:
    edges = [
        ServerSpec(
            name=f"edge{i}", kind="edge", arch_id=edge_arch,
            flops=XEON_4214R_FLOPS, mem_bw=XEON_MEM_BW,
            power_active=130.0, power_idle=55.0, tx_power=15.0,
            bandwidth=100 * MBPS, max_concurrency=2,
            weight_bytes_per_param=1.0, freq_tiers=freq_tiers)
        for i in range(n_edge)
    ]
    cloud = ServerSpec(
        name="tpu-cloud", kind="cloud", arch_id=cloud_arch,
        flops=cloud_chips * V5E_FLOPS, mem_bw=cloud_chips * V5E_MEM_BW,
        power_active=cloud_chips * 220.0 + 150.0,
        power_idle=cloud_chips * 60.0 + 80.0, tx_power=30.0,
        bandwidth=300 * MBPS, max_concurrency=8 * cloud_chips,
        weight_bytes_per_param=2.0, freq_tiers=freq_tiers)
    return edges + [cloud]


__all__ = ["DVFS_TIERS", "paper_testbed", "tpu_testbed"]
