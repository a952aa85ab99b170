"""Public model API: init / forward / loss / prefill / decode, per config.

Parameters are a plain dict: ``embed`` (V, D), ``layers`` (one dict per
layer, in execution order), ``final_norm``, for untied models ``unembed``,
for VLMs ``vision_proj`` (D, D), the stub vision tower's projection, and
for encoder-decoder models ``encoder`` ({"layers": [...], "norm"}).
``init_params`` draws from a seeded ``torch.Generator`` with the JAX
package's distributions and scales (not its bits: ``convert.py`` carries
JAX weights over when the two must agree).
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.parallel import resolve_device

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights for `cfg` on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    # the meta device (`params_shapes`) draws nothing
    gen = None if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    dt = L.torch_dtype(cfg.dtype)
    params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02,
                              dtype=dt, device=dev),
        "layers": T.init_stack(gen, cfg, dev),
        "final_norm": L.init_rmsnorm(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(
            gen, (cfg.vocab_size, cfg.d_model),
            scale=1.0 / math.sqrt(cfg.d_model), dtype=dt, device=dev)
    if cfg.enc_dec:
        params["encoder"] = T.init_encoder(gen, cfg, dev)
    if cfg.vision_tokens:
        params["vision_proj"] = L.dense_init(
            gen, (cfg.d_model, cfg.d_model), scale=0.02, dtype=dt,
            device=dev)
    return params


def params_shapes(cfg: ModelConfig):
    """The parameter tree of `cfg` on the meta device: shapes and dtypes,
    no memory."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens]
    if cfg.family in ("dense", "hybrid", "vlm") and cfg.tie_embeddings:
        # gemma-family convention: scale token embeddings by sqrt(d), in the
        # embedding's own dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def embed_inputs(params, batch, cfg: ModelConfig):
    """Token embeddings; for a VLM given ``vision_embeds`` (B, n, D), the
    first n positions take ``vision_embeds @ vision_proj`` instead (the
    stub vision tower), as in the JAX package."""
    x = embed_tokens(params, batch["tokens"], cfg)
    if cfg.vision_tokens and "vision_embeds" in batch:
        e, w = batch["vision_embeds"], params["vision_proj"]
        dt = torch.promote_types(e.dtype, w.dtype)
        v = e.to(dt) @ w.to(dt)
        x = torch.cat([v.to(x.dtype), x[:, v.shape[1]:]], dim=1)
    return x


def encode(params, batch, cfg: ModelConfig, mode: str = "train"):
    """The encoder's output (B, S_enc, D) for an encoder-decoder model's
    ``audio_frames``, in every mode but decode (decode never re-encodes:
    the cross keys and values were cached at prefill); None otherwise. The
    frames must be in the model's dtype (the JAX package promotes mixed
    operands; torch's matrix products refuse them)."""
    if not cfg.enc_dec or mode == "decode":
        return None
    frames = batch["audio_frames"]
    want = params["embed"].dtype
    if frames.dtype != want:
        raise TypeError(f"audio_frames are {frames.dtype}; the model takes "
                        f"{want} frames")
    return T.run_encoder(params["encoder"], frames, cfg=cfg)


def lm_head(params, x, cfg: ModelConfig):
    """Logits in float32, with the optional tanh softcap."""
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = x.float() @ w.float().t()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def forward(params, batch, *, cfg: ModelConfig, mode: str = "train",
            cache=None, pos=None, moe_dispatch: str = "dense"):
    """batch: {"tokens": (B, S) integer [, "positions": (B, S), or (3, B,
    S) for M-RoPE] [, "vision_embeds": (B, n, D) for a VLM] [,
    "audio_frames": (B, S_enc, D) for an encoder-decoder model, but at
    decode]}.

    Returns (logits (B, S, V) float32, cache'). The cache is updated in
    place. ``moe_dispatch`` picks the MoE layers' dispatch, "dense" or
    "capacity", as the JAX package's ``ParallelContext.moe_dispatch``. The
    MoE load-balance loss is `loss_fn`'s (serving ignores it, as the JAX
    engine does)."""
    enc_out = encode(params, batch, cfg, mode)
    x = embed_inputs(params, batch, cfg)
    x, new_cache, _ = T.run_stack(params["layers"], x, cfg=cfg, mode=mode,
                                  cache=cache, pos=pos,
                                  positions=batch.get("positions"),
                                  moe_dispatch=moe_dispatch, enc_out=enc_out)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_head(params, x, cfg), new_cache


CE_CHUNK = 512


def ce_from_hidden(params, x, labels, cfg: ModelConfig):
    """Softmax cross-entropy straight from the final hidden states, a
    sequence chunk of ``min(CE_CHUNK, S)`` at a time (one chunk when that
    does not divide S), each under `torch.utils.checkpoint`, so no chunk's
    (B, c, V) float32 logits live on into the backward. Labels below 0 are
    masked. Returns (summed nll, count), float32."""
    s = x.shape[1]
    chunk = min(CE_CHUNK, s)
    if s % chunk:
        chunk = s

    def piece(xc, lc):
        logits = lm_head(params, xc, cfg)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            lc.long().clamp(min=0)[..., None])[..., 0]
        mask = (lc >= 0).float()
        return ((logz - gold) * mask).sum(), mask.sum()

    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        n, c = torch.utils.checkpoint.checkpoint(
            piece, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
            use_reentrant=False)
        nll, cnt = nll + n, cnt + c
    return nll, cnt


def loss_fn(params, batch, *, cfg: ModelConfig, aux_weight: float = 0.01,
            moe_dispatch: str = "dense", remat: bool = False):
    """Mean next-token cross-entropy over the labels >= 0, plus
    ``aux_weight`` times the MoE load-balance loss. batch: `forward`'s
    train batch with ``labels`` (B, S). ``remat`` checkpoints each layer.
    Returns (total, {"loss", "moe_aux_loss"})."""
    enc_out = encode(params, batch, cfg)
    x = embed_inputs(params, batch, cfg)
    x, _, aux = T.run_stack(params["layers"], x, cfg=cfg, mode="train",
                            positions=batch.get("positions"),
                            moe_dispatch=moe_dispatch, enc_out=enc_out,
                            remat=remat)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    nll, cnt = ce_from_hidden(params, x, batch["labels"], cfg)
    loss = nll / torch.clamp(cnt, min=1.0)
    total = loss + aux_weight * aux["moe_aux_loss"]
    return total, {"loss": loss, "moe_aux_loss": aux["moe_aux_loss"]}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None):
    """One cache dict per layer: attention {"k", "v"} of (batch, slots, Hkv,
    D), MLA {"ckv", "krope"} of (batch, slots, rank), Mamba-2 {"state",
    "conv"}. ``device="meta"`` gives the shapes alone (the paged cache
    probes them)."""
    return T.init_stack_cache(cfg, batch, max_seq, dtype=dtype,
                              device=resolve_device(device))


def prefill(params, batch, cache, *, cfg: ModelConfig):
    """Run the prompt through the stack and fill the cache.

    Returns (last_token_logits (B, V), cache')."""
    logits, new_cache = forward(params, batch, cfg=cfg, mode="prefill",
                                cache=cache)
    return logits[:, -1], new_cache


def decode_step(params, tokens, cache, pos, *, cfg: ModelConfig,
                moe_dispatch: str = "dense", batch_extras=None):
    """One decode step. tokens: (B, 1); pos: int or (B,) current positions
    (for M-RoPE all three streams take ``pos``, as in the JAX package);
    ``batch_extras`` joins the batch (an encoder-decoder model's frames are
    not re-encoded: decode reads the cross keys and values its prefill
    cached).

    Returns (logits (B, V), cache')."""
    batch = {"tokens": tokens}
    if batch_extras:
        batch.update(batch_extras)
    if cfg.mrope and "positions" not in batch:
        b = tokens.shape[0]
        batch["positions"] = torch.as_tensor(
            pos, dtype=torch.int32, device=tokens.device).reshape(
                1, -1, 1).expand(3, b, 1)
    logits, new_cache = forward(params, batch, cfg=cfg,
                                mode="decode", cache=cache, pos=pos,
                                moe_dispatch=moe_dispatch)
    return logits[:, -1], new_cache


def greedy_generate(params, prompts, *, cfg: ModelConfig, steps: int,
                    max_seq: int, extras=None):
    """Greedy decoding at the model level, without an engine (the serving
    path of an encoder-decoder model, which no engine takes): each prompt
    prefilled alone at its own length with its rows of ``extras`` (e.g.
    ``audio_frames``), the caches joined, then `steps` decode steps of all
    rows at once with a (B,) position vector. Returns each prompt's
    ``steps + 1`` new tokens."""
    dev = params["embed"].device
    caches, tok = [], []
    for i, prompt in enumerate(prompts):
        batch = {"tokens": torch.tensor([prompt], device=dev)}
        batch.update({k: v[i:i + 1] for k, v in (extras or {}).items()})
        logits, cache = prefill(params, batch, init_cache(
            cfg, 1, max_seq, device=dev), cfg=cfg)
        caches.append(cache)
        tok.append(logits.argmax(-1, keepdim=True))
    cache = [{k: torch.cat([c[j][k] for c in caches]) for k in caches[0][j]}
             for j in range(len(caches[0]))]
    del caches
    tok = torch.cat(tok)
    pos = torch.tensor([len(p) for p in prompts], device=dev)
    out = [tok]
    for _ in range(steps):
        logits, cache = decode_step(params, tok, cache, pos, cfg=cfg)
        tok = logits.argmax(-1, keepdim=True)
        pos = pos + 1
        out.append(tok)
    return torch.cat(out, dim=1).tolist()


# ---------------------------------------------------------------------------
# Convenience: a random batch for smoke runs
# ---------------------------------------------------------------------------


def dummy_batch(gen: torch.Generator, cfg: ModelConfig, batch: int, seq: int,
                kind: str = "train"):
    """A random batch of `kind` ("train", "prefill" or "decode") on the
    generator's device, with the inputs `cfg` takes as the JAX package's
    ``dummy_batch`` gives them: tokens (and labels to train), M-RoPE's
    (3, B, S) positions, a VLM's vision embeddings and an encoder-decoder
    model's ``min(encoder_seq_len, seq)`` audio frames, both in the model's
    dtype (the JAX package draws them in bfloat16 whatever the model's)."""
    dev = gen.device
    s = seq if kind != "decode" else 1
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, s),
                                   generator=gen, device=dev)}
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=gen, device=dev)
    if cfg.mrope:
        out["positions"] = torch.arange(s, dtype=torch.int32, device=dev
                                        ).expand(3, batch, s)
    dt = L.torch_dtype(cfg.dtype)
    if cfg.vision_tokens and kind != "decode":
        out["vision_embeds"] = torch.randn(
            (batch, min(cfg.vision_tokens, seq // 2), cfg.d_model),
            generator=gen, device=dev).to(dt)
    if cfg.enc_dec and kind != "decode":
        out["audio_frames"] = torch.randn(
            (batch, min(cfg.encoder_seq_len, seq), cfg.d_model),
            generator=gen, device=dev).to(dt)
    return out
