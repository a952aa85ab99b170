"""The vocabulary-parallel head: the cross-entropy that gathers no logits,
and the prefill that runs the head on one row.

Reduced float32 gemma-2b (``n_layers=2, d_model=128, vocab_size=512``,
its head tied to the embedding) on gloo ranks on the CPU, a (2, 2) and a
(1, 4) ``('data', 'model')`` mesh, whose model axis splits the vocabulary
into slices of 256 and 128. Five loss cases: labels over the whole
vocabulary (every rank's slice holds some), half of them masked, all of
them masked, ``logit_softcap=30.0``, and S = 1024, which the loss takes in
two chunks of 512. Each sharded loss equals the port's one-process
`loss_fn` and the JAX package's to 1e-5, its gradients the one-process
gradients to 1e-4 (the tolerances of `test_torch_dist_train.py`), and no
all-gather of the loss reaches a chunk's (B_local, c, V) float32 logits.
The sharded prefill equals the one-process prefill, for an int `last` and
a (B,) one, and its head gathers (B_local, 1, V) alone. On one process,
`prefill(last=)` is the head run on the hidden row `last`, and the
engine's bucket prefill runs the head on one row.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_dist_harness import run_ranks
from _torch_parity import config_pair, numpy_tree
from repro.models import cpu_context
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro_torch.models import model as M
from repro_torch.models import parallel as PAR
from repro_torch.models import tp as TP
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServingEngine
from repro_torch.training.optimizer import leaves, tree_map

REDUCED = dict(n_layers=2, d_model=128, vocab_size=512)
B, S, S_LONG = 4, 64, 1024
MESHES = [(2, 2), (1, 4)]
CASES = ["all_labels", "half_masked", "all_masked", "softcap", "two_chunks"]
PREFILL_LAST = {"int": 40, "rows": [63, 10, 33, 5]}


def _configs(case):
    jcfg, tcfg = config_pair("gemma-2b", **REDUCED)
    if case == "softcap":
        jcfg = dataclasses.replace(jcfg, logit_softcap=30.0)
        tcfg = dataclasses.replace(tcfg, logit_softcap=30.0)
    return jcfg, tcfg


def _batch(case):
    """Tokens and labels (numpy) of `case`, from a seed."""
    rng = np.random.default_rng(CASES.index(case))
    s = S_LONG if case == "two_chunks" else S
    tokens = rng.integers(0, REDUCED["vocab_size"], (B, s), np.int32)
    labels = rng.integers(0, REDUCED["vocab_size"], (B, s), np.int32)
    if case == "half_masked":
        labels[rng.random((B, s)) < 0.5] = -1
    elif case == "all_masked":
        labels[:] = -1
    return {"tokens": tokens, "labels": labels}


def _torch_batch(np_batch):
    return {k: torch.as_tensor(v).long() for k, v in np_batch.items()}


def _prefill_tokens():
    return np.random.default_rng(7).integers(0, REDUCED["vocab_size"],
                                             (B, S), np.int32)


def _last(kind):
    v = PREFILL_LAST[kind]
    return torch.tensor(v) if isinstance(v, list) else v


def _whole(t, spec, ctx):
    for d, e in enumerate(spec):
        if e is not None:
            t = PAR.all_gather(t, ctx, e, d)
    return t


def _ranked(ctx, jp, batches):
    """Each loss case's (loss, whole gradients, collectives), then the
    prefill's logits for each kind of `last` and the shapes its head
    gathered."""
    out = {"loss": {}, "prefill": {}}
    for case, np_batch in batches.items():
        _, tcfg = _configs(case)
        specs = PAR.param_specs(M.params_shapes(tcfg), ctx)
        params = tree_map(lambda t: t.requires_grad_(True), PAR.shard_params(
            params_from_jax(jp, tcfg, device="cpu"), ctx))
        PAR.reset_collectives()
        total, metrics = M.loss_fn(params, _torch_batch(np_batch), cfg=tcfg,
                                   ctx=ctx)
        total.backward()
        counts = PAR.collective_counts()
        with torch.no_grad():
            def grad(p, spec):
                g = torch.zeros_like(p) if p.grad is None else p.grad
                if ctx.batch_sharded(B):
                    g = g.clone()
                    dist.all_reduce(g, group=ctx.mesh.group(ctx.batch_spec))
                return _whole(g, spec, ctx)
            grads = PAR.map_trees(grad, params, specs)
        out["loss"][case] = {"loss": metrics["loss"].item(), "grads": grads,
                             "counts": counts}

    _, tcfg = _configs("all_labels")
    params = PAR.shard_params(params_from_jax(jp, tcfg, device="cpu"), ctx)
    tokens = torch.as_tensor(_prefill_tokens()).long()
    real, gathered = TP.lm_head, []

    def head(w, x, cfg, c):
        logits = real(w, x, cfg, c)
        gathered.append(tuple(logits.shape))
        return logits
    TP.lm_head = head
    try:
        for kind in PREFILL_LAST:
            gathered.clear()
            PAR.reset_collectives()
            cache = M.init_cache(tcfg, B, 2 * S, device="cpu", ctx=ctx)
            logits, _ = M.prefill(params, {"tokens": tokens}, cache, cfg=tcfg,
                                  last=_last(kind), ctx=ctx)
            out["prefill"][kind] = {"logits": logits,
                                    "heads": list(gathered),
                                    "counts": PAR.collective_counts()}
    finally:
        TP.lm_head = real
    return out


@pytest.fixture(scope="module")
def shared():
    jcfg, _ = config_pair("gemma-2b", **REDUCED)
    jp = numpy_tree(jax_init_params(jax.random.key(0), jcfg))
    batches = {case: _batch(case) for case in CASES}
    ranked = {mesh: run_ranks(_ranked, mesh, ("data", "model"), jp, batches)
              for mesh in MESHES}
    return jp, batches, ranked


def _one_process(jp, case, np_batch):
    _, tcfg = _configs(case)
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_jax(jp, tcfg, device="cpu"))
    total, metrics = M.loss_fn(params, _torch_batch(np_batch), cfg=tcfg)
    total.backward()
    return metrics["loss"].item(), tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params)


def _jax_loss(jp, case, np_batch):
    jcfg, _ = _configs(case)
    _, metrics = jax_loss_fn(jax.tree.map(jnp.asarray, jp),
                             {k: jnp.asarray(v) for k, v in np_batch.items()},
                             cfg=jcfg, ctx=cpu_context(remat=False))
    return metrics["loss"].item()


def test_every_rank_slice_holds_labels(shared):
    _, batches, _ = shared
    labels = batches["all_labels"]["labels"]
    for m in (2, 4):
        width = REDUCED["vocab_size"] // m
        assert set(np.unique(labels // width)) == set(range(m))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_sharded_loss_and_grads_match_one_process_and_jax(shared, mesh,
                                                          case):
    jp, batches, ranked = shared
    got = ranked[mesh]["loss"][case]
    loss, grads = _one_process(jp, case, batches[case])
    assert abs(got["loss"] - loss) < 1e-5
    assert abs(got["loss"] - _jax_loss(jp, case, batches[case])) < 1e-5
    if case == "all_masked":
        assert got["loss"] == 0.0
    for a, b in zip(leaves(got["grads"]), leaves(grads), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    # no chunk's logits cross the ranks: every all-gather is smaller than
    # one (B_local, c, V) float32 chunk
    b_local = B // mesh[0]
    c = min(M.CE_CHUNK, batches[case]["tokens"].shape[1])
    assert got["counts"]["all-gather"]["largest"] \
        < b_local * c * REDUCED["vocab_size"] * 4
    assert got["counts"]["all-reduce"]["calls"] > 0


@pytest.mark.parametrize("kind", list(PREFILL_LAST))
@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_sharded_prefill_gathers_one_row_and_matches_one_process(
        shared, mesh, kind):
    jp, _, ranked = shared
    got = ranked[mesh]["prefill"][kind]
    _, tcfg = _configs("all_labels")
    params = params_from_jax(jp, tcfg, device="cpu")
    cache = M.init_cache(tcfg, B, 2 * S, device="cpu")
    want, _ = M.prefill(params,
                        {"tokens": torch.as_tensor(_prefill_tokens()).long()},
                        cache, cfg=tcfg, last=_last(kind))
    assert got["logits"].shape == (B, REDUCED["vocab_size"])
    torch.testing.assert_close(got["logits"], want, rtol=1e-5, atol=1e-5)
    # the head ran once, on this rank's rows at one position, and gathered
    # their vocabulary alone
    b_local = B // mesh[0]
    assert got["heads"] == [(b_local, 1, REDUCED["vocab_size"])]
    assert got["counts"]["all-gather"]["largest"] \
        < b_local * S * REDUCED["vocab_size"] * 4


@pytest.mark.parametrize("kind", list(PREFILL_LAST))
def test_prefill_runs_the_head_on_row_last(kind):
    """`prefill(last=)` is the head on the hidden row `last`, bit for bit;
    against the whole forward's row, which a product of another shape sums
    in another order, and the JAX forward's, to 1e-5 and 1e-4."""
    jcfg, tcfg = config_pair("gemma-2b", **REDUCED)
    jp = jax_init_params(jax.random.key(0), jcfg)
    params = params_from_jax(numpy_tree(jp), tcfg, device="cpu")
    toks = _prefill_tokens()
    batch = {"tokens": torch.as_tensor(toks).long()}
    last = _last(kind)
    logits, cache = M.prefill(params, batch, M.init_cache(
        tcfg, B, 2 * S, device="cpu"), cfg=tcfg, last=last)
    x, cache2, _ = M.hidden_states(params, batch, cfg=tcfg, mode="prefill",
                                   cache=M.init_cache(tcfg, B, 2 * S,
                                                      device="cpu"))
    rows = torch.arange(B)
    idx = last if isinstance(last, torch.Tensor) else torch.full((B,), last)
    want = M.lm_head(params, x[rows, idx][:, None], tcfg)[:, 0]
    assert torch.equal(logits, want)
    for a, b in zip(leaves(cache), leaves(cache2), strict=True):
        assert torch.equal(a, b)
    full, _ = M.forward(params, batch, cfg=tcfg, mode="prefill",
                        cache=M.init_cache(tcfg, B, 2 * S, device="cpu"))
    torch.testing.assert_close(logits, full[rows, idx], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(logits.argmax(-1), full[rows, idx].argmax(-1))
    jfull, _, _ = jax_forward(jp, {"tokens": jnp.asarray(toks)}, cfg=jcfg,
                              ctx=cpu_context(remat=False), mode="train")
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jfull)[rows.numpy(), idx.numpy()],
                               rtol=1e-4, atol=1e-4)


def test_engine_prefill_runs_the_head_on_one_row(monkeypatch):
    """The engine's bucket prefill (a 5-token prompt in the 8 bucket) and
    its decode steps hand the head one row each, and the first token is
    the argmax of the whole forward's row plen - 1."""
    _, tcfg = config_pair("gemma-2b", **REDUCED)
    params = M.init_params(tcfg, seed=0, device="cpu")
    real, seen = M.lm_head, []

    def head(p, x, cfg, ctx=None):
        seen.append(tuple(x.shape))
        return real(p, x, cfg, ctx)
    monkeypatch.setattr(M, "lm_head", head)
    prompt = [3, 141, 59, 26, 5]
    eng = ServingEngine(tcfg, params, max_batch=2, max_seq=64, device="cpu")
    req = eng.submit(prompt, max_new_tokens=3)
    eng.run_until_idle()
    assert eng.n_prefills == 1 and len(req.generated) == 3
    assert seen[0] == (1, 1, tcfg.d_model)
    assert all(s[1] == 1 for s in seen)
    padded = torch.tensor([prompt + [0, 0, 0]])
    full, _ = M.forward(params, {"tokens": padded}, cfg=tcfg, mode="prefill",
                        cache=M.init_cache(tcfg, 1, 64, device="cpu"))
    assert req.generated[0] == int(full[0, len(prompt) - 1].argmax())
