"""Cells, mixes, configurations and metrics are found by name; a new one
is taken without editing a file that is there. BENCHMARK.json keeps to the
benchmark's contract."""
import json
import os
import re
import shutil
import subprocess
import sys

from cardbench.core import registry

ROOT = registry.BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return registry.load_json(ROOT / "BENCHMARK.json")


def test_a_new_cell_mix_config_and_metric_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "cardbench"
    shutil.copytree(registry.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _bench()
    cfg = registry.load_json(bench_dir / "configs" / "yi-6b.json")
    cfg["name"] = "yi-6b-copy"
    (bench_dir / "configs" / "yi-6b-copy.json").write_text(json.dumps(cfg))
    mix = registry.load_json(bench_dir / "traffic" / "chat.json")
    mix.update(name="chat-short", lead_in_s=1.0)
    (bench_dir / "traffic" / "chat-short.json").write_text(json.dumps(mix))
    (bench_dir / "cells" / "new-cell.json").write_text(json.dumps(
        {"profile_s": 2.0, "sample_tokens": 10,
         "limits": {"max_logit_gap": 0.5, "min_compared_tokens": 5}}))
    (bench_dir / "metrics" / "steps_in_window.new.py").write_text(
        "def read(rec):\n    return float(len(rec.window_steps()))\n")
    bench["configs"].append(dict(bench["configs"][0], name="yi-6b-copy",
                                 file="cardbench/configs/yi-6b-copy.json"))
    bench["workloads"].append({"name": "new-cell", "config": "yi-6b-copy",
                               "traffic": "chat-short", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:        # the chat mix's metrics
        if m["name"].endswith(".chat"):
            m["workloads"].append("new-cell")
    bench["per_layer"].append({"name": "steps_in_window.new", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "out_tok_s",
                               "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.cell("new-cell", bench_dir)
    assert cell.config["name"] == "yi-6b-copy"
    assert cell.traffic["lead_in_s"] == 1.0
    assert cell.settings["limits"]["max_logit_gap"] == 0.5
    assert [m["name"] for m in cell.per_layer] == ["steps_in_window.new"]
    assert {m["name"] for m in cell.end_to_end} == {"j_per_req.chat",
                                                    "setup_s"}
    read = registry.reader("steps_in_window.new", bench_dir)

    class Rec:
        def window_steps(self):
            return [1, 2, 3]
    assert read(Rec()) == 3.0


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["cardbench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert registry.reader_file(m["name"]).is_file()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert registry.load_json(ROOT / c["file"])["reduced"] == \
            c["reduced"]
    for w in b["workloads"]:
        assert w["chips"] == 1
        cell = registry.cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        e2e_names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e_names and len(e2e_names) >= 2
        for m in cell.per_layer:        # every cell reports what it moves
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
        assert len(w["why"]) <= 200


def test_a_metric_of_a_mix_is_read_by_its_base_reader():
    metrics = registry.BENCH_DIR / "metrics"
    assert registry.reader_file("mfu.chat") == metrics / "mfu.py"
    assert registry.reader_file("mfu.a-later-mix") == metrics / "mfu.py"
    assert registry.reader_file("out_tok_s") == metrics / "out_tok_s.py"
    assert registry.reader("idle_share.docqa") is not None


# a block the harness has no family for: multi-query attention, one
# key/value head for every query head whatever num_key_value_heads says
MQA = '''"""Multi-query attention on the llama block."""
import dataclasses

from cardbench.families import _decoder

small = _decoder.small


def shape(cfg):
    return dataclasses.replace(_decoder.Shape.of(cfg), hkv=1)


def logits(weights, cfg, seqs, rows, precision="f32"):
    return _decoder.logits(weights, dict(cfg, num_key_value_heads=1), seqs,
                           rows, precision)


def port_config(cfg):
    return dataclasses.replace(_decoder.port_config(cfg), n_kv_heads=1)


def engine_args(cfg):
    return {}
'''

# run in the copy, which is the package `cardbench` there
IN_THE_COPY = '''
import time
import torch
from cardbench.core import cell as C, port, reference, registry, weights
from cardbench.tests import tiny
from repro_torch.models.model import forward
c = registry.cell("mqa-chat")
fam = registry.family(c.config)
assert fam.__file__ == str(registry.BENCH_DIR / "families" / "mqa.py")
s = fam.shape(c.config)
assert (s.hq, s.hkv, s.kv_bytes_per_token) == (32, 1, 2 * 32 * 128 * 2)
cfg = dict(fam.small(c.config), torch_dtype="float32")
w = weights.make_weights(fam.shape(cfg), 5, "cpu")
assert tuple(w["layers"][0]["mix"]["wk"].shape) == (64, 16)
toks = torch.randint(0, 256, (1, 40),
                     generator=torch.Generator().manual_seed(1))
want, _ = forward(w, {"tokens": toks}, cfg=port.port_config(cfg),
                  mode="train")
got = reference.logits(w, cfg, [toks[0]], [(0, 40)])[0]
torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)
tc = tiny.cell("mqa-chat")
seed = 2**31 + 3
out = C.measure(tc, C.Prepared(tc, seed, "cpu", time.perf_counter()),
                seed=seed, seconds=3.0, trace=False, device="cpu")
assert out["correct"], out["checks"]
print("correct", out["checks"]["compared_tokens"]["value"])
'''


def test_a_new_block_is_taken_by_files_alone(tmp_path):
    """A family file, a configuration, a cell and entries: the copy's
    registry finds the family by the file's model_type, draws its weights,
    and its reference computes the port's model at the small size; a whole
    run of the cell cut small comes out correct."""
    bench_dir = tmp_path / "cardbench"
    shutil.copytree(registry.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "families" / "mqa.py").write_text(MQA)
    cfg = registry.load_json(bench_dir / "configs" / "yi-6b.json")
    cfg.update(name="yi-6b-mqa", model_type="mqa")
    (bench_dir / "configs" / "yi-6b-mqa.json").write_text(json.dumps(cfg))
    (bench_dir / "cells" / "mqa-chat.json").write_text(
        (bench_dir / "cells" / "yi6b-chat.json").read_text())
    bench = _bench()
    bench["configs"].append(dict(bench["configs"][0], name="yi-6b-mqa",
                                 file="cardbench/configs/yi-6b-mqa.json"))
    bench["workloads"].append({"name": "mqa-chat", "config": "yi-6b-mqa",
                               "traffic": "chat", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "yi6b-chat" in m.get("workloads", ()):
            m["workloads"].append("mqa-chat")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())

    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path),
                                           str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", IN_THE_COPY], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[0] == "correct"
