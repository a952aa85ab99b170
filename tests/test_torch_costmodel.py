"""The port's cost model: exact FLOPs on known programs (the four cases of
tests/test_costmodel.py, ported), and the prefill step of a reduced config
of every family against the JAX package's jaxpr walker.

The port's prefill runs the head on the last row alone, so the JAX
prefill is walked with its head moved onto the last row too (its
``lm_head`` wrapped in memory while the jaxpr is traced), the same work.
Measured on this suite's shapes (batch 2, 64 tokens, float32): the
products' FLOPs equal the walker's ``dot_general`` FLOPs exactly for every
family but Mamba-2 (0.09% fewer: the chunked scan's inter-chunk products
are shaped differently), and the total FLOPs lie within 0.5% of the
walker's (elementwise work the two packages split into different
operations); both are held to 1%. Bytes are not compared: a torch view
moves no data and counts none, where the walker counts reshapes and
transposes.
"""
import dataclasses

import jax
import pytest
import torch
import torch.utils.checkpoint

from repro.configs import ASSIGNED_ARCHS, InputShape
from repro.configs import get_config as jax_get_config
from repro.launch import costmodel as JC
from repro.models import cpu_context
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.launch.costmodel import step_cost
from repro_torch.models import model as TM


def _meta(*shape, grad=False):
    return torch.empty(*shape, device="meta").requires_grad_(grad)


def test_matmul_flops_exact():
    c = step_cost(lambda x, y: x @ y, _meta(64, 128), _meta(128, 32))
    assert c["flops"] == 2 * 64 * 128 * 32
    assert c["bytes"] == (64 * 128 + 128 * 32 + 64 * 32) * 4


def test_loop_multiplies_by_trip_count():
    def f(x, w):
        for _ in range(10):
            x = x @ w
        return x

    c = step_cost(f, _meta(128, 128), _meta(128, 128))
    assert c["flops"] == 10 * 2 * 128 ** 3


def test_grad_counts_forward_and_backward():
    def loss(x, w):
        return ((x @ w) ** 2).sum()

    x, w = _meta(64, 64), _meta(64, 64, grad=True)
    fwd = step_cost(loss, x, w)["flops"]
    both = step_cost(lambda x, w: torch.autograd.grad(loss(x, w), w),
                     x, w)["flops"]
    assert both >= 1.9 * fwd


def test_remat_increases_flops():
    def net(x, w):
        for _ in range(4):
            x = torch.tanh(x @ w)
        return x.sum()

    x, w = _meta(64, 64, grad=True), _meta(64, 64)
    plain = step_cost(lambda x, w: torch.autograd.grad(net(x, w), x),
                      x, w)["flops"]
    rem = step_cost(lambda x, w: torch.autograd.grad(
        torch.utils.checkpoint.checkpoint(net, x, w, use_reentrant=False),
        x), x, w)["flops"]
    assert rem > plain


def _dot_flops(jaxpr) -> float:
    """The walker's ``dot_general`` FLOPs alone, with its recursion."""
    total = 0.0
    for eqn in jaxpr.eqns:
        p = eqn.primitive.name
        if p == "dot_general":
            total += JC._dot_flops(eqn)
        elif p == "scan":
            total += eqn.params["length"] * _dot_flops(
                eqn.params["jaxpr"].jaxpr)
        elif p == "while":
            total += _dot_flops(eqn.params["body_jaxpr"].jaxpr)
        elif p == "cond":
            total += max(_dot_flops(b.jaxpr) for b in eqn.params["branches"])
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                if key in eqn.params:
                    sub = eqn.params[key]
                    total += _dot_flops(getattr(sub, "jaxpr", sub))
                    break
    return total


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_prefill_flops_match_the_jax_walker(arch, monkeypatch):
    head = JM.lm_head
    monkeypatch.setattr(JM, "lm_head",
                        lambda p, x, cfg: head(p, x[:, -1:], cfg))
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    b, s = 2, 64
    shape = InputShape("prefill_64", s, b, "prefill")
    jaxpr = jax.make_jaxpr(lambda p, x, c: JM.prefill(
        p, x, c, cfg=jcfg, ctx=cpu_context()))(
        JM.params_shapes(jcfg), JM.input_specs(jcfg, shape, dtype="float32"),
        jax.eval_shape(lambda: JM.init_cache(jcfg, b, s))).jaxpr
    want_dot = _dot_flops(jaxpr)
    want = JC.jaxpr_cost(jaxpr)

    batch = TM.input_specs(tcfg, shape, dtype=torch.float32)
    batch["tokens"] = torch.empty(b, s, dtype=torch.long, device="meta")
    got = step_cost(lambda p, x, c: TM.prefill(p, x, c, cfg=tcfg),
                    TM.params_shapes(tcfg), batch,
                    TM.init_cache(tcfg, b, s, device="meta"))
    assert got["product_flops"] == pytest.approx(want_dot, rel=1e-2)
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-2)
