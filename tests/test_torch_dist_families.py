"""The port's sharded Mamba-2, RG-LRU, MLA, M-RoPE and encoder-decoder
families and its sharded paged engine, on 8 gloo ranks.

A (2, 4) ``('data', 'model')`` mesh of processes on the CPU
(`test_torch_dist_harness.run_ranks`) against the JAX package's runs under
the same mesh (`test_torch_dist_jaxref.py` case ``families``, 8 host
devices) and the port's single process, on the JAX ``init_params(key 0)``
weights of each reduced float32 model:

* the sharded engines' greedy tokens (mamba2 with 4 SSD heads a rank,
  recurrentgemma with 64 RG-LRU channels a rank, minicpm3 with one MLA head
  a rank, qwen2-vl with its M-RoPE attention heads split);
* whisper-base's prefill and decode logits at the model level;
* the sharded paged engine (gemma-2b, whose slot cache splits its sequence
  over ``model``, and mamba2): an eviction, a resume in a slot of the other
  data rank and a prefix hit, the allocator's block ids equal on every
  rank, and a migration between two engines of the mesh;
* the train step's loss and every gradient leaf against one process;
* no all-gather of a decode step, nor of a train step's forward and
  backward, as large as one of the mixers' weights: the weights stay where
  the rules put them.

One JAX process and one spawn of the ranks serve every case.
"""
import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from test_torch_dist_harness import jax_ref, run_ranks
from test_torch_dist_jaxref import (
    FAMILIES, MAX_NEW, PAGED, PAGED_NEW, PROMPTS, WHISPER_FRAMES,
    WHISPER_PROMPT, WHISPER_ROWS, WHISPER_SLOTS, evict_resume, paged_prompts,
)
from _torch_parity import config_pair, numpy_tree
from repro.models import init_params as jax_init_params
from repro_torch.models import model as M
from repro_torch.models import parallel as PAR
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import block_program
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  init_opt_state_sharded, make_train_step)
from repro_torch.training.optimizer import leaves

TRAIN = ("mamba2-2.7b", "recurrentgemma-2b", "minicpm3-4b")
ARCHS = sorted(set(FAMILIES) | set(PAGED) | set(TRAIN) | {"whisper-base"})
# the mixers' column- and row-parallel leaves, by layer kind
MIXER_WEIGHTS = {"ssm": ("wz", "wx", "out_proj"),
                 "rec": ("w_gate_in", "w_rec_in", "out_proj"),
                 "mla": ("wq_b", "wkv_b", "wo")}


def _inputs():
    rng = np.random.default_rng(0)
    _, tcfg = config_pair("whisper-base")
    return {
        "whisper_tokens": rng.integers(0, tcfg.vocab_size,
                                       (WHISPER_ROWS, WHISPER_PROMPT + 3)),
        "whisper_frames": rng.standard_normal(
            (WHISPER_ROWS, WHISPER_FRAMES, tcfg.d_model)).astype(np.float32)}


def _train_batch(vocab):
    rng = np.random.default_rng(1)
    return {k: torch.as_tensor(rng.integers(0, vocab, (4, 16)))
            for k in ("tokens", "labels")}


def _params(tcfg, jp, ctx=None):
    params = params_from_jax(jp, tcfg, device="cpu")
    return PAR.shard_params(params, ctx) if ctx is not None else params


def _whole(tree, specs, ctx):
    """Each leaf gathered whole over the axes its spec names."""
    return PAR.map_trees(lambda t, spec: PAR.gather_tree(t, spec, ctx),
                         tree, specs)


# (kind, result shape) of each counted collective since the last reset,
# where `_log_collectives` put its hook (in the ranks)
CALLS = []


def _log_collectives():
    count = PAR._count

    def logged(kind, out):
        CALLS.append((kind, tuple(out.shape)))
        count(kind, out)
    PAR._count = logged


def _calls():
    """The collectives logged since the last call (and reset them)."""
    out = list(CALLS)
    CALLS.clear()
    PAR.reset_collectives()
    return out


def _serve(tcfg, params, ctx=None):
    """Greedy tokens of the engine, and the collectives of one decode step
    (the second step: every prompt was admitted at the first)."""
    eng = ServingEngine(tcfg, params, max_batch=4, max_seq=64, device="cpu",
                        ctx=ctx)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    eng.step()
    _calls()
    eng.step()
    calls = _calls()
    eng.run_until_idle()
    return [list(r.generated) for r in reqs], calls


def _paged_engine(tcfg, params, ctx=None):
    eng = ServingEngine(tcfg, params, max_batch=4, max_seq=64, device="cpu",
                        ctx=ctx, paged=True, kv_block_tokens=16)
    log = []
    allocate = eng.kv.allocate

    def logged(*a, **kw):
        table = allocate(*a, **kw)
        log.append(None if table is None else (list(table.blocks),
                                               table.shared_blocks))
        return table
    eng.kv.allocate = logged
    return eng, log


def _paged(tcfg, params, ctx=None):
    """The evict/resume/prefix-hit run: (tokens, prefix hits, the
    allocator's tables in order, its free list after)."""
    eng, log = _paged_engine(tcfg, params, ctx)
    toks = evict_resume(eng, paged_prompts(), PAGED_NEW)
    assert eng.kv.free_blocks == eng.kv.n_blocks
    return toks, eng.n_prefix_hits, log, list(eng.kv.allocator._free)


def _migrate(tcfg, params, ctx):
    """The first paged prompt evicted from one engine after 3 steps, its
    pages exported into a second engine of the same mesh and resumed
    there: its tokens."""
    src, _ = _paged_engine(tcfg, params, ctx)
    dst, _ = _paged_engine(tcfg, params, ctx)
    req = src.submit(paged_prompts()[0], max_new_tokens=PAGED_NEW)
    for _ in range(3):
        src.step()
    src.evict(req.slot)
    snap = req.kv
    table = dst.kv.import_pages(src.kv.export(req.pages),
                                len(req.pages.blocks))
    src.release(req)
    req.pages, req.kv = table, snap
    dst.resubmit(req)
    dst.run_until_idle()
    return list(req.generated)


def _whisper(tcfg, params, inp, ctx=None):
    toks = torch.as_tensor(inp["whisper_tokens"])
    s = WHISPER_PROMPT
    cache = M.init_cache(tcfg, WHISPER_ROWS, WHISPER_SLOTS, device="cpu",
                         ctx=ctx)
    last, cache = M.prefill(params, {
        "tokens": toks[:, :s],
        "audio_frames": torch.as_tensor(inp["whisper_frames"])}, cache,
        cfg=tcfg, ctx=ctx)
    out = [last]
    for i in range(toks.shape[1] - s):
        lg, cache = M.decode_step(params, toks[:, s + i:s + i + 1], cache,
                                  s + i, cfg=tcfg, ctx=ctx)
        out.append(lg)
    return torch.stack(out).numpy()


def _whole_cache_logits(tcfg, params, ctx=None):
    """Prefill and two decode steps of one row on a cache held whole
    (`init_cache` without ``ctx``): under a mesh each mixer cuts its shard
    of it and gathers it back."""
    toks = torch.tensor([[5, 9, 23, 7, 100, 3, 44, 12, 77]])
    cache = M.init_cache(tcfg, 1, 32, device="cpu")
    last, cache = M.prefill(params, {"tokens": toks[:, :7]}, cache, cfg=tcfg,
                            ctx=ctx)
    out = [last]
    for i in (7, 8):
        lg, cache = M.decode_step(params, toks[:, i:i + 1], cache, i,
                                  cfg=tcfg, ctx=ctx)
        out.append(lg)
    return torch.stack(out).numpy()


def _grads(tcfg, params, batch, ctx=None):
    """The loss and its gradient, leaf by leaf (this rank's shards), and
    the collectives of the forward and backward."""
    params = PAR.map_trees(lambda t: t.detach().requires_grad_(True), params)
    _calls()
    loss, _ = M.loss_fn(params, batch, cfg=tcfg, ctx=ctx)
    loss.backward()
    return loss.item(), PAR.map_trees(lambda t: t.grad, params), _calls()


def _step(tcfg, params, batch, ctx=None):
    """One train step's metrics."""
    opt = init_opt_state_sharded(params, tcfg, ctx) if ctx is not None \
        else init_opt_state(params)
    step = make_train_step(tcfg, AdamWConfig(warmup_steps=1), ctx=ctx)
    _, _, metrics = step(params, opt, batch)
    return {k: float(v) for k, v in metrics.items()}


def _ranked(ctx, weights, inp):
    import torch.distributed as dist
    _log_collectives()
    out = {"engine": {}, "paged": {}, "train": {}, "whole_cache": {}}
    for arch in FAMILIES:
        tcfg, jp = weights[arch]
        out["engine"][arch] = _serve(tcfg, _params(tcfg, jp, ctx), ctx)
    for arch in PAGED:
        tcfg, jp = weights[arch]
        toks, hits, log, free = _paged(tcfg, _params(tcfg, jp, ctx), ctx)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (log, free))
        out["paged"][arch] = (toks, hits, every)
    tcfg, jp = weights["gemma-2b"]
    out["migrated"] = _migrate(tcfg, _params(tcfg, jp, ctx), ctx)
    tcfg, jp = weights["whisper-base"]
    out["whisper"] = _whisper(tcfg, _params(tcfg, jp, ctx), inp, ctx)
    for arch in TRAIN:
        tcfg, jp = weights[arch]
        out["whole_cache"][arch] = _whole_cache_logits(
            tcfg, _params(tcfg, jp, ctx), ctx)
        batch = _train_batch(tcfg.vocab_size)
        loss, grads, calls = _grads(tcfg, _params(tcfg, jp, ctx), batch, ctx)
        specs = PAR.param_specs(M.params_shapes(tcfg), ctx)
        # each data rank's gradient is its rows'; the step sums them
        grads = PAR.map_trees(lambda g: PAR.all_reduce(g, ctx, "data"),
                              grads)
        out["train"][arch] = dict(
            loss=loss, grads=_whole(grads, specs, ctx), calls=calls,
            step=_step(tcfg, _params(tcfg, jp, ctx), batch, ctx))
    return out


@pytest.fixture(scope="module")
def runs():
    """(the JAX mesh run, the 8 ranks' run, the weights): the JAX process
    runs while the ranks do."""
    weights = {}
    for arch in ARCHS:
        jcfg, tcfg = config_pair(arch)
        weights[arch] = (tcfg, numpy_tree(jax_init_params(jax.random.key(0),
                                                          jcfg)))
    inp = _inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(jax_ref, "families", inp)
        got = run_ranks(_ranked, (2, 4), ("data", "model"), weights, inp)
        return ref.result(), got, weights, inp


def _gathered_mixer_weights(tcfg, calls):
    """The all-gathers among `calls` whose result has the shape of a whole
    column- or row-parallel mixer leaf, and the number of such shapes."""
    shapes = set()
    for spec, p in zip(block_program(tcfg).layers(),
                       M.params_shapes(tcfg)["layers"], strict=True):
        for name in MIXER_WEIGHTS.get(spec.kind, ()):
            shapes.add(tuple(p["mix"][name].shape))
    return [c for c in calls if c[0] == "all-gather" and c[1] in shapes], \
        len(shapes)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_engine_matches_jax_engine_and_one_process(runs, arch):
    ref, got, weights, _ = runs
    tcfg, jp = weights[arch]
    single, _ = _serve(tcfg, _params(tcfg, jp))
    toks, calls = got["engine"][arch]
    assert toks == ref["engine"][arch] == single, arch
    # the mixers' weights stay where the rules put them: a decode step
    # gathers none of them
    gathered, n = _gathered_mixer_weights(tcfg, calls)
    assert calls and not gathered
    assert (n > 0) == (arch != "qwen2-vl-2b")


def test_sharded_whisper_matches_jax_mesh(runs):
    ref, got, weights, inp = runs
    tcfg, jp = weights["whisper-base"]
    single = _whisper(tcfg, _params(tcfg, jp), inp)
    scale = np.abs(ref["whisper"]).max()
    np.testing.assert_allclose(got["whisper"], ref["whisper"], rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got["whisper"], single, rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("arch", PAGED)
def test_sharded_paged_engine_matches_jax_mesh(runs, arch):
    ref, got, weights, _ = runs
    tcfg, jp = weights[arch]
    toks, hits, every = got["paged"][arch]
    single, single_hits, _, _ = _paged(tcfg, _params(tcfg, jp))
    want, want_hits = ref["paged"][arch]
    assert toks == want == single
    assert hits == want_hits == single_hits == (1 if arch == "gemma-2b"
                                                 else 0)
    # every rank took the same allocations, prefix hits and frees
    assert all(r == every[0] for r in every) and every[0][0]
    if arch == "gemma-2b":
        # a migration between two engines of the mesh resumes the evicted
        # request with the uninterrupted tokens
        assert got["migrated"] == want[0]


@pytest.mark.parametrize("arch", TRAIN)
def test_mixers_on_a_cache_held_whole(runs, arch):
    """A cache held whole on every rank (no specs) gives one process's
    logits: each mixer runs on its shard of it and gathers it back."""
    _, got, weights, _ = runs
    tcfg, jp = weights[arch]
    np.testing.assert_allclose(got["whole_cache"][arch],
                               _whole_cache_logits(tcfg, _params(tcfg, jp)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", TRAIN)
def test_sharded_train_step_matches_one_process(runs, arch):
    _, got, weights, _ = runs
    tcfg, jp = weights[arch]
    batch = _train_batch(tcfg.vocab_size)
    loss, grads, _ = _grads(tcfg, _params(tcfg, jp), batch)
    mine = got["train"][arch]
    assert abs(mine["loss"] - loss) < 1e-5
    n = 0
    for a, b in zip(leaves(mine["grads"]), leaves(grads), strict=True):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * max(scale, 1e-30), \
            (arch, tuple(b.shape))
        n += 1
    assert n == len(leaves(grads))
    step = _step(tcfg, _params(tcfg, jp), batch)
    assert abs(mine["step"]["loss"] - step["loss"]) < 1e-5
    assert abs(mine["step"]["grad_norm"] / step["grad_norm"] - 1) < 1e-4
    # the forward and backward gather no mixer weight
    gathered, n = _gathered_mixer_weights(tcfg, mine["calls"])
    assert any(kind == "all-reduce" for kind, _ in mine["calls"])
    assert not gathered and n > 0
