"""The port's expert-parallel MoE on 8 gloo ranks.

Reduced float32 deepseek-moe-16b (4 routed experts, top-2, 2 shared) on a
(2, 4) ``('data', 'model')`` mesh of processes: ``moe_layer_ep_a2a`` (the
all-to-all form) against dense dispatch at ``capacity_factor=8.0`` (no
token dropped) within 3e-3, the JAX test's tolerance, and against the JAX
package's ``moe_layer_ep_a2a`` on 8 host devices; the constraint form
``moe_layer_expert_parallel``; gradients through the all-to-alls against
one process's gradients of dense dispatch; and the reference's own
non-expert-parallel semantics (dense dispatch where the experts do not
divide the model axis, capacity dispatch without a mesh).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_dist_harness import jax_ref, run_ranks
from _torch_parity import config_pair
from repro.models.moe import init_moe as jax_init_moe
from repro_torch.models import moe as MOE
from repro_torch.models import parallel as PAR
from repro_torch.models.convert import to_tensor


def _setup():
    jcfg, tcfg = config_pair("deepseek-moe-16b")
    p = jax.tree.map(np.asarray, jax_init_moe(jax.random.key(0), jcfg))
    x = np.random.default_rng(1).standard_normal((4, 32, tcfg.d_model),
                                                 np.float32)
    return tcfg, p, x


def _torch_tree(p):
    return PAR.map_trees(lambda a: to_tensor(a, "cpu"), p)


def _full_grad(t, spec, ctx):
    """A shard's gradient summed over the data axis, whole over model."""
    g = PAR.all_reduce(t.grad, ctx, "data")
    for d, e in enumerate(spec):
        if e is not None:
            g = PAR.all_gather(g, ctx, e, d)
    return g


def _ranked(ctx, tcfg, p, x, forms):
    out = {}
    for form in forms:
        cfg = tcfg
        if form == "indivisible":       # 6 experts on a model axis of 4
            cfg = dataclasses.replace(tcfg, n_experts=6)
        full = _torch_tree(p) if form != "indivisible" else MOE.init_moe(
            torch.Generator().manual_seed(0), cfg, "cpu")
        specs = PAR.param_specs(full, ctx)
        local = PAR.map_trees(lambda t: t.requires_grad_(True),
                              PAR.shard_tree(full, specs, ctx))
        xl = ctx.shard_batch(torch.as_tensor(x)).clone().requires_grad_(True)
        fn = {"ep_a2a": lambda: MOE.moe_layer_ep_a2a(
                  local, xl, cfg=cfg, ctx=ctx, capacity_factor=8.0),
              "ep": lambda: MOE.moe_layer_expert_parallel(local, xl,
                                                          cfg=cfg, ctx=ctx),
              "indivisible": lambda: MOE.moe_layer_ep_a2a(
                  local, xl, cfg=cfg, ctx=ctx)}[form]
        o, aux = fn()
        (o ** 2).sum().backward()
        out[form] = {
            "out": PAR.all_gather(o.detach(), ctx, "data", 0).numpy(),
            "aux": float(aux["moe_aux_loss"].detach()),
            "gx": PAR.all_gather(xl.grad, ctx, "data", 0).numpy(),
            "grads": PAR.map_trees(lambda t, s: _full_grad(t, s, ctx).numpy(),
                                   local, specs),
            "counts": PAR.collective_counts(),
        }
        PAR.reset_collectives()
    return out


@pytest.fixture(scope="module")
def runs():
    tcfg, p, x = _setup()
    got = run_ranks(_ranked, (2, 4), ("data", "model"), tcfg, p, x,
                    ("ep_a2a", "ep", "indivisible"))
    return tcfg, p, x, got


def _dense(tcfg, p, x):
    pt = PAR.map_trees(lambda t: t.requires_grad_(True), _torch_tree(p))
    xt = torch.as_tensor(x).clone().requires_grad_(True)
    o, _ = MOE.moe_layer(pt, xt, cfg=tcfg)
    (o ** 2).sum().backward()
    return o.detach().numpy(), pt, xt.grad.numpy()


def test_ep_a2a_matches_dense_and_jax(runs):
    tcfg, p, x, got = runs
    dense, _, _ = _dense(tcfg, p, x)
    ref = jax_ref("ep_a2a", {"x": x})
    ep = got["ep_a2a"]
    np.testing.assert_allclose(ep["out"], dense, rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(ep["out"], ref["ep"], rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(ep["aux"], ref["aux"], rtol=1e-5)
    # two all-to-alls of the routed rows and three re-laying the weights,
    # and as many in the backward
    assert ep["counts"]["all-to-all"]["calls"] == 10


@pytest.mark.parametrize("form", ["ep_a2a", "ep"])
def test_expert_parallel_gradients_match_dense(runs, form):
    """Gradients through the all-to-alls (and the constraint form's sums)
    equal one process's gradients of dense dispatch."""
    tcfg, p, x, got = runs
    dense, pt, gx = _dense(tcfg, p, x)
    r = got[form]
    np.testing.assert_allclose(r["out"], dense, rtol=3e-3, atol=3e-3)
    assert np.isfinite(r["gx"]).all()
    np.testing.assert_allclose(r["gx"], gx, rtol=1e-4,
                               atol=1e-4 * np.abs(gx).max())

    def check(g, t):
        assert np.isfinite(g).all()
        want = t.grad.numpy()
        np.testing.assert_allclose(g, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    PAR.map_trees(check, r["grads"], pt)


def test_ep_a2a_keeps_the_reference_semantics(runs):
    """Experts that do not divide the model axis: dense dispatch (the
    sharded dense layer, which sums over model); no mesh: capacity."""
    tcfg, p, x, got = runs
    cfg6 = dataclasses.replace(tcfg, n_experts=6)
    full = MOE.init_moe(torch.Generator().manual_seed(0), cfg6, "cpu")
    want, _ = MOE.moe_layer(full, torch.as_tensor(x), cfg=cfg6)
    r = got["indivisible"]
    want = want.numpy()
    np.testing.assert_allclose(r["out"], want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert r["counts"]["all-to-all"]["calls"] == 0
    xt = torch.as_tensor(x)
    a, _ = MOE.moe_layer_ep_a2a(_torch_tree(p), xt, cfg=tcfg)
    b, _ = MOE.moe_layer_capacity(_torch_tree(p), xt, cfg=tcfg)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _published_gates(ctx, tcfg, p, x):
    from repro_torch.models import block as BL
    full = _torch_tree(p)
    local = PAR.shard_tree(full, PAR.param_specs(full, ctx), ctx)
    xl = ctx.shard_batch(torch.as_tensor(x))
    with torch.no_grad():
        o, _ = MOE.moe_layer_ep_a2a(local, xl, cfg=tcfg, ctx=ctx,
                                    capacity_factor=8.0,
                                    block=BL.Block(norm_topk_prob=False))
    return PAR.all_gather(o, ctx, "data", 0).numpy()


def test_ep_a2a_takes_the_published_gate_rule():
    """The all-to-all form's own gate site (on a (1, 2) mesh) keeps the
    top-k softmax gates as they are under ``Block(norm_topk_prob=False)``,
    as dense dispatch does, and so differs from the renormalised rule."""
    from repro_torch.models import block as BL
    tcfg, p, x = _setup()
    got = run_ranks(_published_gates, (1, 2), ("data", "model"), tcfg, p, x)
    xt = torch.as_tensor(x)
    want, _ = MOE.moe_layer(_torch_tree(p), xt, cfg=tcfg,
                            block=BL.Block(norm_topk_prob=False))
    np.testing.assert_allclose(got, want.numpy(), rtol=3e-3, atol=3e-3)
    renorm, _ = MOE.moe_layer(_torch_tree(p), xt, cfg=tcfg)
    assert not np.allclose(got, renorm.numpy(), atol=1e-2)
