"""Hand-written CUDA attention kernels for the serving hot path, with their
plain PyTorch versions.

flash_attention — causal / sliding-window prefill attention.
decode_attention — one-token decode against a dense KV cache, per-row
    valid lengths.
ops — the model-layout (B, S, H, D) entry points that pick kernel or
    plain version by device.
ref — the plain versions.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
