"""A whole run without the look for a card, on the CPU at a small size:
sound, it comes out correct; with the timed path broken underneath (a
decode step that leaves the cache unchanged, half the batch left out of a
step, a token altered where it is produced) it comes out not correct; and
the fp8 control, put in the program's place, reads over the limit. (The
cells run on one card: there is no exchange between cards to leave out.)"""
import time

import pytest

from cardbench.core import cell as C
from cardbench.tests import tiny

# (cell, configuration file): each cell, and the docqa mix on a mixture of
# experts (the DeepSeekMoE file with the port's gate rule)
CASES = [("yi6b-chat", None), ("yi6b-docqa", None),
         ("yi6b-docqa", "deepseek-moe-16b")]


def _run(name, config=None, seed=2**31 + 3, control=False):
    c = tiny.cell(name, config=config)
    prep = C.Prepared(c, seed, "cpu", time.perf_counter())
    return C.measure(c, prep, seed=seed, seconds=4.0, trace=False,
                     device="cpu", control=control)


@pytest.mark.parametrize("name,config", CASES)
def test_sound_run_is_correct_and_the_control_is_not(name, config):
    out = _run(name, config, control=True)
    assert out["correct"], out["checks"]
    lim = tiny.cell(name, config=config).settings["limits"]
    assert any(out["info"]["control_gaps"][k] > v for k, v in lim.items()
               if k.endswith("_gap"))
    assert out["checks"]["compared_tokens"]["value"] >= 20


def _unchanged_state(monkeypatch):
    from repro_torch.models import layers

    def no_write(cache_arr, new, pos):
        return cache_arr
    monkeypatch.setattr(layers, "update_cache_seq", no_write)


def _half_batch(monkeypatch):
    from repro_torch.serving import engine
    real = engine.M.decode_step

    def half(params, tokens, cache, pos, **kw):
        # every odd slot left out: it takes the even slot's logits
        logits, cache = real(params, tokens, cache, pos, **kw)
        if logits.shape[0] > 1:
            logits = logits.clone()
            logits[1::2] = logits[0:logits.shape[0] // 2 * 2:2]
        return logits, cache
    monkeypatch.setattr(engine.M, "decode_step", half)


def _altered_token(monkeypatch):
    from repro_torch.serving import engine
    real = engine.sample_tokens

    def altered(logits, *a, **kw):
        t = real(logits, *a, **kw).clone()
        t[0] = (t[0] + 1) % logits.shape[-1]
        return t
    monkeypatch.setattr(engine, "sample_tokens", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_token])
@pytest.mark.parametrize("name,config", [CASES[0], CASES[2]])
def test_a_broken_path_is_not_correct(name, config, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(name, config)
    assert not out["correct"], out["checks"]
