"""Cells, mixes, configurations and metrics are found by name; a new one
is taken without editing a file that is there. BENCHMARK.json keeps to the
benchmark's contract."""
import json
import re
import shutil

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
