"""The port's serving example (`repro_torch.examples.perllm_serving`)
against the JAX package's `examples/perllm_serving.py`, on the CPU at a
small workload: the same simulator rows, energy lines and allocations, and
the same requests executed on each real engine."""
import importlib.util
import os
import re

import pytest

from repro_torch.examples import perllm_serving

N_SERVICES = 60
HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_example_lines(capsys):
    """The JAX example's output with its workload cut to N_SERVICES."""
    path = os.path.join(HERE, "..", "examples", "perllm_serving.py")
    spec = importlib.util.spec_from_file_location("jax_perllm_serving", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    whole = mod.generate_workload
    mod.generate_workload = lambda n, **kw: whole(N_SERVICES, **kw)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.strip().splitlines()


def test_fleet_counts_match_the_jax_example(capsys):
    want = _jax_example_lines(capsys)
    got = perllm_serving.main(["--device", "cpu", "--services",
                               str(N_SERVICES)])
    capsys.readouterr()
    assert got["lines"][:-1] == want[:-1]
    counts = re.search(r"executed (\d+)/(\d+) .*edge0=(\d+), edge1=(\d+), "
                       r"cloud=(\d+)\)", want[-1]).groups()
    done, total, *per = map(int, counts)
    assert (got["done"], got["requests"], got["per_engine"]) == (
        done, total, per)
    assert done == total == 24


def test_example_runs_on_the_card_by_default(monkeypatch):
    """Without ``--device`` it asks for the card, and raises where there is
    none rather than falling back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perllm_serving.main(["--services", str(N_SERVICES)])
