"""The port's twins of the JAX package's last three example entry points
(`repro_torch.examples.{arch_zoo,quickstart,train_100m}`) against
`examples/{arch_zoo,quickstart,train_100m}.py` on the CPU: the zoo's decode
logits on shared weights, the quickstart's schedule, losses and served
requests, and checkpoints read across the two packages bit for bit."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, numpy_tree
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro_torch.examples import arch_zoo, quickstart, train_100m
from repro_torch.models.convert import params_from_jax, stack_like_jax
from repro_torch.models.convert import to_numpy
from repro_torch.training import load_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_model.py's float32


def _jax_example(name):
    path = os.path.join(HERE, "..", "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _F32Config:
    """`get_config(arch)` for the JAX tour whose `reduced()` is float32."""

    def __init__(self, cfg):
        self._cfg = cfg

    def reduced(self):
        return dataclasses.replace(self._cfg.reduced(), dtype="float32")

    def __getattr__(self, name):
        return getattr(self._cfg, name)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_arch_zoo_logits_match_the_jax_tour(arch):
    """The JAX example's own `tour` runs on a float32 reduced config, its
    weights, batch and decode logits caught on the way; the port's `tour`
    takes the same weights (through numpy) and batch: the prefill's last
    logits and the decode step's agree. Whisper's frames and qwen2-vl's
    vision embeddings are the same float32 arrays on both sides."""
    mod = _jax_example("arch_zoo")
    seen = {}
    get, init, batch_of, step = (mod.get_config, mod.init_params,
                                 mod.dummy_batch, mod.decode_step)
    pre = mod.prefill

    def init_params(key, cfg):
        seen["params"] = init(key, cfg)
        return seen["params"]

    def dummy_batch(*a, **kw):
        b = batch_of(*a, **kw)
        b = {k: v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v
             for k, v in b.items()}
        seen["batch"] = b
        return b

    def prefill(*a, **kw):
        seen["last"], cache = pre(*a, **kw)
        return seen["last"], cache

    def decode_step(*a, **kw):
        seen["logits"], cache = step(*a, **kw)
        return seen["logits"], cache

    mod.get_config = lambda a: _F32Config(get(a))
    mod.init_params, mod.dummy_batch = init_params, dummy_batch
    mod.prefill, mod.decode_step = prefill, decode_step
    mod.tour(arch)

    _, tcfg = config_pair(arch)
    params = params_from_jax(numpy_tree(seen["params"]), tcfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             seen["batch"].items()}
    batch["tokens"] = batch["tokens"].long()
    with torch.no_grad():
        got = arch_zoo.tour(arch, "cpu", cfg=tcfg, params=params,
                            batch=batch)
    np.testing.assert_allclose(got["last"].numpy(), np.asarray(seen["last"]),
                               **TOL)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(seen["logits"]), **TOL)


def test_arch_zoo_tours_every_arch_at_its_defaults(capsys):
    """Without weights or a batch the tour draws its own from seed 0 and
    prints the JAX example's line for each of the 10 archs."""
    out = arch_zoo.main(["--device", "cpu"])
    assert list(out) == list(ASSIGNED_ARCHS)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(ASSIGNED_ARCHS)
    for arch, res in out.items():
        assert res["logits"].shape == (2, 1024)
        assert bool(torch.isfinite(res["logits"]).all())


def test_quickstart_matches_the_jax_example(capsys):
    """The scheduling section's lines are the JAX example's (the simulator
    and policies are verbatim copies); the step-0 loss is within 1% of the
    JAX run's and the last within 5% (bfloat16 on two backends, weights
    from two generators); the same requests are served, each to its 8
    tokens."""
    capsys.readouterr()
    _jax_example("quickstart").main()
    want = capsys.readouterr().out.strip().splitlines()
    got = quickstart.main(["--device", "cpu"])
    capsys.readouterr()
    assert got["schedule"] == want[-2:]
    losses = {ln.split()[1]: float(ln.split("loss=")[1].split()[0])
              for ln in want if ln.startswith("step")}
    hist = got["history"]
    assert [h["step"] for h in hist] == [int(s) for s in losses]
    assert abs(hist[0]["loss"] - losses["0"]) <= 0.01 * losses["0"]
    assert abs(hist[-1]["loss"] - losses["29"]) <= 0.05 * losses["29"]
    served = [ln.split(":")[0] for ln in want if ln.startswith("req ")]
    assert [f"req {r.rid}" for r in got["requests"][:3]] == served
    assert [len(r.generated) for r in got["requests"]] == [8] * 6
    assert len(got["engine"].completed) == 6


def test_train_100m_checkpoint_reads_across_packages(tmp_path, capsys):
    """Two steps of the ~100M config, checkpointed by the port: the JAX
    package's `load_checkpoint` reads it to the port's parameters in the
    JAX tree, bit for bit; a checkpoint the JAX package writes of that tree
    loads back in the port to the same parameters, bit for bit."""
    from repro.models import init_params as jax_init_params
    from repro.training import load_checkpoint as jax_load
    from repro.training import save_checkpoint as jax_save

    ckpt = str(tmp_path / "port")
    got = train_100m.main(["--steps", "2", "--batch", "1", "--seq", "32",
                           "--ckpt", ckpt, "--device", "cpu"])
    cfg = got["cfg"]
    jcfg = dataclasses.replace(
        jax_get_config("gemma-2b"),
        arch_id="gemma-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=1, head_dim=64, d_ff=2048, vocab_size=32000)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert len(got["history"]) == 2
    assert "checkpoint -> " + ckpt in capsys.readouterr().out

    like = jax.eval_shape(lambda: jax_init_params(jax.random.key(0), jcfg))
    tree, extra = jax_load(ckpt, like)
    assert extra == {"steps": 2, "arch": "gemma-100m"}
    want = [to_numpy(x) for x in jax.tree.leaves(stack_like_jax(
        got["params"], cfg))]
    have = jax.tree.leaves(tree)
    assert len(have) == len(want)
    for h, w in zip(have, want, strict=True):
        h = np.asarray(h)
        assert h.dtype.itemsize == w.dtype.itemsize and h.shape == w.shape
        assert h.tobytes() == w.tobytes()

    back = str(tmp_path / "jax")
    jax_save(back, tree, extra={"from": "jax"})
    params, extra = load_checkpoint(back, got["params"], cfg, device="cpu")
    assert extra == {"from": "jax"}
    mine = jax.tree.leaves(stack_like_jax(params, cfg))
    theirs = jax.tree.leaves(stack_like_jax(got["params"], cfg))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("example", [arch_zoo, quickstart, train_100m])
def test_examples_run_on_the_card_by_default(monkeypatch, example):
    """Without ``--device`` each example asks for the card, and raises
    where there is none rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
