"""Additions need no edits: a new configuration, mix and metric are files found by name.

Copies of the three folders and the manifest get a dummy of each; the
harness finds them by the names a new cell and metric give, and no file
that was there changes. Every name and unit of BENCHMARK.json keeps to the
allowed characters.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

from conftest import ROOT, run_cell, tiny
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_dummy_config_mix_and_metric_are_found_by_name(tmp_path):
    src = os.path.join(ROOT, "portbench")
    for kind in ("configs", "mixes", "metrics"):
        shutil.copytree(os.path.join(src, kind), tmp_path / kind)
    before = digest(tmp_path)
    conf, mix = tiny("ecoli_3pct.grow")
    (tmp_path / "configs" / "dummy_cfg.json").write_text(json.dumps(dict(conf, name="dummy_cfg")))
    (tmp_path / "mixes" / "dummy_mix.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "dummy_metric.py").write_text(
        "def read(readings):\n    return 42.0 + len(readings.get('phases', []))\n")

    man = harness.manifest()
    man["configs"].append({"name": "dummy_cfg", "source": "x", "file": "x", "reduced": [], "why": "x"})
    man["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                             "traffic": "dummy_mix", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "dummy_metric", "unit": "x", "better": "lower",
                             "source": "host_clock", "layer": "x", "moves": "round_s_p90",
                             "workloads": ["dummy_cfg.dummy_mix"]})
    cell = man["workloads"][-1]
    c = harness.load_json("configs", cell["config"], root=str(tmp_path))
    m = harness.load_json("mixes", cell["traffic"], root=str(tmp_path))
    assert c["name"] == "dummy_cfg" and m["entry"] == "rounds"
    names = [x["name"] for x in harness.cell_metrics(man, cell["name"], "per_layer")]
    assert names == ["dummy_metric"]
    reader = harness.load_module("metrics", "dummy_metric", root=str(tmp_path))
    assert reader.read({"phases": [{}, {}]}) == 44.0
    # the new cell runs through the general entry its mix names
    rc, res = run_cell("ecoli_3pct.grow", 5, 0.5, config=c, mix=m)
    assert rc == 0 and res["correct"]
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_metric_has_a_reader_and_every_cell_its_files():
    man = harness.manifest()
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
    for w in man["workloads"]:
        harness.load_json("configs", w["config"])
        assert harness.load_json("mixes", w["traffic"])["entry"] in ("rounds", "locate")
        per = harness.cell_metrics(man, w["name"], "per_layer")
        e2e = {x["name"] for x in harness.cell_metrics(man, w["name"], "end_to_end")}
        assert per and "setup_s" in e2e and len(e2e) >= 2
        assert all(x["moves"] in e2e for x in per)


def test_names_and_units_keep_to_the_allowed_characters():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in man[sec]:
            assert NAME.match(x["name"]), x["name"]
            if "unit" in x:
                assert UNIT.match(x["unit"]), x["unit"]
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for c in man["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["source"]) <= 200
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(man)) < 64 * 1024
