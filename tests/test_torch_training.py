"""The port's training against the JAX package's: the AdamW step, the
loss and its gradients for every assigned family, microbatching, remat,
checkpoints that either package writes, the data stream and the launcher.

Reduced float32 configs; batches made with numpy and handed to both
packages. Tolerances: the loss to 1e-5 relative and the gradients at
rtol 1e-4, atol 1e-5 (both sum in float32, in different orders); parameters
after an AdamW step at the JAX tests' own 5e-3 (tests/test_training.py:
the first step is close to lr * sign(g), so a gradient near zero that
rounds differently moves a whole step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, numpy_tree, weights_pair
from repro.configs import ASSIGNED_ARCHS
from repro.models import cpu_context
from repro.models import loss_fn as jax_loss_fn
from repro.training import adamw_update as jax_adamw_update
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import load_checkpoint as jax_load_checkpoint
from repro.training import make_train_step as jax_make_train_step
from repro.training import save_checkpoint as jax_save_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch import train as train_launcher
from repro_torch.models import dummy_batch, init_params, loss_fn
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.training import (
    AdamWConfig, DataConfig, SyntheticLM, adamw_update, init_opt_state,
    load_checkpoint, make_train_step, save_checkpoint, train,
)
from repro_torch.training.optimizer import leaves, tree_map

CTX = cpu_context(remat=False)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=5e-3, atol=5e-3)


def _numpy_batch(cfg, b=2, s=32, seed=0):
    """A train batch for `cfg` as numpy: tokens and labels, M-RoPE's (3, B,
    S) positions, a VLM's vision embeddings and an encoder-decoder model's
    frames, in float32."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.mrope:
        out["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32), (3, b, s)).copy()
    if cfg.vision_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (b, min(cfg.vision_tokens, s // 2), cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["audio_frames"] = rng.standard_normal(
            (b, min(cfg.encoder_seq_len, s), cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
            else torch.from_numpy(v) for k, v in batch.items()}


def _grads(params, batch, cfg, **kw):
    shadow = tree_map(lambda t: t.detach().requires_grad_(True), params)
    total, metrics = loss_fn(shadow, batch, cfg=cfg, **kw)
    grads = torch.autograd.grad(total, leaves(shadow))
    return total, metrics, grads


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_adamw_matches_reference_step():
    cfg = AdamWConfig(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      grad_clip=1e9, warmup_steps=0, total_steps=1,
                      min_lr_ratio=1.0)
    params = {"w": torch.tensor([[1.0, 2.0]])}
    grads = {"w": torch.tensor([[0.1, -0.2]])}
    new, state, _ = adamw_update(cfg, params, grads, init_opt_state(params))
    # adam's first step: mhat = g, vhat = g², delta = sign(g)
    expect = np.array([[1.0, 2.0]]) - 1e-2 * np.sign([[0.1, -0.2]])
    np.testing.assert_allclose(new["w"].numpy(), expect, rtol=1e-4)
    assert state.step == 1


def test_grad_clip_applies():
    cfg = AdamWConfig(lr=1e-2, grad_clip=0.5, warmup_steps=0)
    params = {"w": torch.ones(4)}
    _, _, metrics = adamw_update(cfg, params, {"w": torch.full((4,), 100.0)},
                                 init_opt_state(params))
    assert float(metrics["grad_norm"]) == 200.0  # reported before the clip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_steps(dtype):
    """Three steps on a tree of matrices and vectors (decay on matrices
    only), clipping active, warm-up and cosine: the JAX update's
    parameters, moments and metrics. A bf16 parameter is updated in float32
    and cast once, as in JAX."""
    cfg = AdamWConfig(lr=3e-2, weight_decay=0.1, grad_clip=0.5,
                      warmup_steps=2, total_steps=5)
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": {"s": rng.standard_normal((4,)).astype(np.float32)}}
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    tp = {"a": torch.from_numpy(p0["a"]).to(tdt),
          "b": {"s": torch.from_numpy(p0["b"]["s"]).to(tdt)}}
    js, ts = jax_init_opt_state(jp), init_opt_state(tp)
    for i in range(3):
        g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"s": rng.standard_normal((4,)).astype(np.float32)}}
        jp, js, jm = jax_adamw_update(
            cfg, jp, jax.tree.map(lambda a: jnp.asarray(a, jdt), g), js)
        tp, ts, tm = adamw_update(
            cfg, tp, tree_map(lambda a: torch.from_numpy(a).to(tdt), g), ts)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    for t, j in ((tp["a"], jp["a"]), (tp["b"]["s"], jp["b"]["s"]),
                 (ts.m["a"], js.m["a"]), (ts.v["b"]["s"], js.v["b"]["s"])):
        assert t.dtype == (tdt if t is tp["a"] or t is tp["b"]["s"]
                           else torch.float32)
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=1e-5, atol=1e-6 if dtype == "float32"
                                   else 1e-2)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """`loss_fn`'s value, its metrics and the gradient of every parameter
    against ``jax.value_and_grad(M.loss_fn)`` on the same weights and
    batch: attention through `FlashAttentionFn`, the SSD block through
    `SSDDiagFn`, the MoE aux loss, the encoder and cross attention."""
    jcfg, tcfg = config_pair(arch)
    jp, tp = weights_pair(jcfg, tcfg)
    batch = _numpy_batch(jcfg)
    (jtotal, jm), jg = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jp, _jax(batch), cfg=jcfg, ctx=CTX)
    total, metrics, grads = _grads(tp, _torch(batch), tcfg)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["moe_aux_loss"].item(),
                               float(jm["moe_aux_loss"]), rtol=1e-5,
                               atol=1e-7)
    if tcfg.n_experts:
        assert metrics["moe_aux_loss"].item() > 0
    want = leaves(params_from_jax(numpy_tree(jg), tcfg, device="cpu"))
    assert len(want) == len(grads)
    for g, w in zip(grads, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


def test_loss_near_log_vocab_at_init():
    """Random weights give a loss near ln V, as tests/test_archs.py holds
    the JAX package's."""
    cfg = dataclasses.replace(get_config("gemma-2b").reduced(),
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    _, metrics = loss_fn(params, dummy_batch(gen, cfg, 2, 32), cfg=cfg)
    assert abs(metrics["loss"].item() - np.log(cfg.vocab_size)) < 1.5


def test_ce_masks_negative_labels_and_chunks():
    """Labels below 0 are left out of the mean; a sequence of 1024 runs in
    two checkpointed chunks of 512 and gives the single-chunk value."""
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("gemma-2b").reduced(vocab_size=64),
                              dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    x = torch.randn(1, 1024, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    labels = torch.randint(0, 64, (1, 1024), generator=torch.Generator()
                           .manual_seed(3))
    labels[0, ::3] = -1
    nll, cnt = M.ce_from_hidden(params, x, labels, cfg)
    logits = M.lm_head(params, x, cfg)
    keep = labels >= 0
    want = torch.nn.functional.cross_entropy(logits[keep], labels[keep],
                                             reduction="sum")
    assert cnt.item() == keep.sum().item()
    torch.testing.assert_close(nll, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "whisper-base"])
def test_remat_matches_no_remat(arch):
    """Each layer under `torch.utils.checkpoint` recomputes the same
    forward: the loss and the gradients are the same."""
    _, tcfg = config_pair(arch)
    params = init_params(tcfg, seed=0, device="cpu")
    batch = _torch(_numpy_batch(tcfg, seed=1))
    t0, _, g0 = _grads(params, batch, tcfg)
    t1, _, g1 = _grads(params, batch, tcfg, remat=True)
    torch.testing.assert_close(t1, t0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g0, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b",
                                  "whisper-base"])
def test_train_step_matches_jax(arch):
    """One step of `make_train_step` against the JAX step on the same
    weights and batch: the metrics, and every parameter at 5e-3."""
    jcfg, tcfg = config_pair(arch)
    jp, tp = weights_pair(jcfg, tcfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    batch = _numpy_batch(jcfg, seed=2)
    jp, _, jm = jax_make_train_step(jcfg, CTX, ocfg)(
        jp, jax_init_opt_state(jp), _jax(batch))
    tp, state, tm = make_train_step(tcfg, ocfg)(tp, init_opt_state(tp),
                                               _torch(batch))
    assert state.step == 1
    for key in ("loss", "grad_norm", "total_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    want = leaves(params_from_jax(numpy_tree(jp), tcfg, device="cpu"))
    for t, w in zip(leaves(tp), want, strict=True):
        np.testing.assert_allclose(t.numpy(), w.numpy(), **STEP_TOL)


def test_microbatch_accumulation_matches_full_batch():
    """Two microbatches == one full-batch step (the same math), with the
    positions of an M-RoPE model split on their batch axis."""
    for arch in ("gemma-2b", "qwen2-vl-2b"):
        _, cfg = config_pair(arch, n_layers=2, d_model=64, vocab_size=128)
        params = init_params(cfg, seed=0, device="cpu")
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, grad_clip=1e9)
        batch = _torch(_numpy_batch(cfg, b=4, s=16, seed=3))
        p1, _, m1 = make_train_step(cfg, ocfg)(
            tree_map(torch.clone, params), init_opt_state(params), batch)
        p2, _, m2 = make_train_step(cfg, ocfg, microbatches=2)(
            tree_map(torch.clone, params), init_opt_state(params), batch)
        assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
        for a, b in zip(leaves(p1), leaves(p2), strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)


def test_microbatches_accumulate_in_float32():
    """On a bf16 model the microbatch gradients are summed in float32
    buffers (a bf16 sum would lose the low bits the JAX step keeps)."""
    cfg = get_config("gemma-2b").reduced(n_layers=1, d_model=64,
                                         vocab_size=128)
    params = init_params(cfg, seed=0, device="cpu")
    seen = []
    real = adamw_update

    def spy(opt_cfg, p, grads, state):
        seen.extend(g.dtype for g in grads)
        return real(opt_cfg, p, grads, state)

    import repro_torch.training.train_loop as TL
    TL.adamw_update = spy
    try:
        make_train_step(cfg, AdamWConfig(), microbatches=2)(
            params, init_opt_state(params),
            _torch(_numpy_batch(cfg, b=2, s=8)))
    finally:
        TL.adamw_update = real
    assert seen and set(seen) == {torch.float32}


# ---------------------------------------------------------------------------
# the training loop, the data, checkpoints, the launcher
# ---------------------------------------------------------------------------


def test_training_loss_decreases():
    cfg = get_config("gemma-2b").reduced(n_layers=2, d_model=128,
                                         vocab_size=512)
    _, _, hist = train(cfg, steps=40, batch_size=4, seq_len=64, log_every=10,
                       device="cpu",
                       opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=5,
                                           total_steps=40))
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5


def test_synthetic_data_deterministic_and_learnable():
    c = DataConfig(vocab_size=128, seq_len=32, batch_size=2, seed=11)
    b1 = next(SyntheticLM(c).batches())
    b2 = next(SyntheticLM(c).batches())
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (2, 32)
    data = SyntheticLM(c)
    toks = np.concatenate([next(data.batches())["tokens"].ravel()
                           for _ in range(20)])
    frac = np.mean(data.successor[toks[:-1]] == toks[1:])
    assert 0.3 < frac < 0.7


def test_train_refuses_encoder_decoder_without_frames():
    cfg = get_config("whisper-base").reduced()
    with pytest.raises(ValueError, match="audio frames"):
        train(cfg, steps=1, device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("gemma-2b").reduced(n_layers=2, d_model=64,
                                         vocab_size=128)
    params = init_params(cfg, seed=0, device="cpu")
    save_checkpoint(str(tmp_path / "ck"), params, cfg, extra={"step": 7})
    from repro_torch.models import params_shapes
    restored, extra = load_checkpoint(str(tmp_path / "ck"),
                                      params_shapes(cfg), cfg, device="cpu")
    assert extra["step"] == 7
    for a, b in zip(leaves(params), leaves(restored), strict=True):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert restored["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch,dtype", [("gemma-2b", "bfloat16"),
                                        ("whisper-base", "float32"),
                                        ("recurrentgemma-2b", "bfloat16")])
def test_jax_checkpoint_loads_into_the_port(tmp_path, arch, dtype):
    jcfg, tcfg = config_pair(arch)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    from repro.models import init_params as jax_init_params
    jp = jax_init_params(jax.random.key(3), jcfg)
    jax_save_checkpoint(str(tmp_path / "ck"), jp, extra={"step": 3})
    like = init_params(tcfg, seed=9, device="cpu")
    got, extra = load_checkpoint(str(tmp_path / "ck"), like, tcfg,
                                 device="cpu")
    assert extra == {"step": 3}
    want = params_from_jax(numpy_tree(jp), tcfg, device="cpu")
    for a, b in zip(leaves(got), leaves(want), strict=True):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,dtype", [("gemma-2b", "bfloat16"),
                                        ("whisper-base", "float32"),
                                        ("deepseek-moe-16b", "bfloat16")])
def test_port_checkpoint_loads_into_jax(tmp_path, arch, dtype):
    jcfg, tcfg = config_pair(arch)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    params = init_params(tcfg, seed=4, device="cpu")
    save_checkpoint(str(tmp_path / "ck"), params, tcfg, extra={"step": 5})
    from repro.models import init_params as jax_init_params
    like = jax_init_params(jax.random.key(0), jcfg)
    got, extra = jax_load_checkpoint(str(tmp_path / "ck"), like)
    assert extra == {"step": 5}
    want = params_to_jax(params, tcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        np.testing.assert_array_equal(a, b)


def test_train_launcher_runs_on_cpu(capsys):
    cfg, params, _, hist = train_launcher.main(
        ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "32", "--microbatches", "2", "--remat",
         "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"training {cfg.arch_id}" in out and "done: loss" in out
    assert out.count("step ") == 3 and len(hist) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    assert params["embed"].device.type == "cpu"
