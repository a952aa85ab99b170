"""Hand-written CUDA kernels for the serving hot path, with their plain
PyTorch versions.

flash_attention — causal / sliding-window prefill attention.
decode_attention — one-token decode against a dense KV cache, per-row
    valid lengths.
paged_attention — the same decode through a page table over a paged pool.
ssd_diag — the Mamba-2 SSD diagonal block (prefill of the SSM family).
ops — the model-layout entry points that pick kernel or plain version by
    device.
ref — the plain versions.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
