"""The paper's deployment models (yi-6b, llama2-7b, llama3-8b, yi-9b,
llama2-33b) and the gemma3 family in the port against the JAX package:
reduced float32 engines on shared weights give the JAX engine's greedy
tokens; the full configs' attention shapes fit the kernels; and the JAX
engine's rolling-window prefill, which keeps the padded bucket's last
slots, is pinned on both sides."""
import jax  # noqa: F401  (both packages in one process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, weights_pair
from repro.models import cpu_context
from repro.models import forward as jax_forward
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.configs.paper_models import CLOUD_MODEL, EDGE_MODELS
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fl
from repro_torch.models import forward
from repro_torch.serving import ServingEngine

DEPLOYMENTS = EDGE_MODELS + (CLOUD_MODEL, "gemma3-12b", "gemma3-27b")
REDUCED = dict(n_layers=2, d_model=256, vocab_size=512)


def _prompts(n, vocab, lo=3, hi=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["llama2-7b", "llama3-8b", "yi-9b",
                                  "llama2-33b", "gemma3-27b"])
def test_reduced_engine_matches_jax_engine(arch):
    """More requests than slots over several prompt buckets: the same
    greedy tokens per request and the same slots (llama2's reduced heads
    stay MHA, llama3's 4 a kv-head, yi's 8 collapse to MQA, gemma3-27b's
    local layers roll past their 64-slot window)."""
    jcfg, tcfg = config_pair(arch, **REDUCED)
    jp, tp = weights_pair(jcfg, tcfg)
    je = JaxEngine(jcfg, jp, max_batch=3, max_seq=128)
    te = ServingEngine(tcfg, tp, max_batch=3, max_seq=128, device="cpu")
    for p in _prompts(6, REDUCED["vocab_size"], hi=90):
        je.submit(p, max_new_tokens=8)
        te.submit(p, max_new_tokens=8)
    jd = sorted(je.run_until_idle(), key=lambda r: r.rid)
    td = sorted(te.run_until_idle(), key=lambda r: r.rid)
    assert [r.generated for r in td] == [r.generated for r in jd]
    assert [r.slot for r in td] == [r.slot for r in jd]
    assert all(len(r.generated) == 8 for r in td)


@pytest.mark.parametrize("arch", DEPLOYMENTS)
def test_full_width_attention_fits_the_kernels(arch):
    """Each deployment's full head_dim and q-heads per kv-head are shapes
    the flash and decode wrappers take (their limits are checked on every
    device), and its window divides every prefill bucket that exceeds it
    (the rolling prefill keeps the bucket's last `window` slots)."""
    cfg = get_config(arch)
    d = cfg.resolved_head_dim
    assert d in fl.HEAD_DIMS and d in dec.HEAD_DIMS
    dec.check_group(cfg.n_heads, cfg.n_kv_heads)
    if cfg.sliding_window:
        assert all(b % cfg.sliding_window == 0
                   for b in (2048, 4096) if b > cfg.sliding_window)


# the rolling-window fact: a reduced float32 gemma3-12b (window 64, max_seq
# 128), a 70-token prompt (tokens in [1, 512) from seed 0) in the 128
# bucket, 6 greedy tokens
ROLL_NEW = 6


def test_rolling_window_prefill_keeps_the_bucket_padding():
    """The JAX engine right-pads the prompt to its 128 bucket; prefill
    keeps the bucket's last 64 slots in each local layer, which hold pad
    K/V, and decode attends all 64. The port's engine gives the JAX
    engine's tokens, and both differ from exact decoding (a full forward
    over the growing sequence, the same in both packages), with the first
    token, read from the prefill's last real row, the same in all four."""
    jcfg, tcfg = config_pair("gemma3-12b", n_layers=2, d_model=128,
                             vocab_size=512)
    assert tcfg.sliding_window == 64
    jp, tp = weights_pair(jcfg, tcfg)
    prompt = np.random.default_rng(0).integers(1, 512, 70).tolist()
    je = JaxEngine(jcfg, jp, max_batch=1, max_seq=128)
    te = ServingEngine(tcfg, tp, max_batch=1, max_seq=128, device="cpu")
    jr = je.submit(prompt, max_new_tokens=ROLL_NEW)
    tr = te.submit(prompt, max_new_tokens=ROLL_NEW)
    je.run_until_idle()
    te.run_until_idle()

    ctx = cpu_context()
    j_exact, t_exact = list(prompt), list(prompt)
    for _ in range(ROLL_NEW):
        jl = jax_forward(jp, {"tokens": jnp.asarray([j_exact])}, cfg=jcfg,
                         ctx=ctx)[0]
        j_exact.append(int(jnp.argmax(jl[0, -1])))
        with torch.no_grad():
            tl, _ = forward(tp, {"tokens": torch.tensor([t_exact])},
                            cfg=tcfg)
        t_exact.append(int(tl[0, -1].argmax()))
    j_exact, t_exact = j_exact[len(prompt):], t_exact[len(prompt):]

    assert tr.generated == jr.generated
    assert t_exact == j_exact
    assert tr.generated != t_exact
    assert tr.generated[0] == t_exact[0]
