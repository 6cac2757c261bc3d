"""``BENCHMARK.json`` against the benchmark's contract: its keys, the
characters of names and units, the files each entry names, and that every
per-layer metric is reported in cells that report what it moves."""

import json
import re
from pathlib import Path

import pytest

from perfbench import spec

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|ffn|_dim$"
                    r"|_rank$|experts_per_tok|expansion)")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer",
               "moves", "workloads"}


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32
    assert all(one_line(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_unique():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names)), key
        assert all(NAME.match(n) for n in names), key
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert set(m) <= METRIC_KEYS, m["name"]
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        if m["name"].split(".")[0].endswith("_roofline") \
                or "mfu" in m["name"]:
            assert m["unit"] == "%", m["name"]


def test_configs_name_their_files():
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["why"])
        assert one_line(c["source"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        raw = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in raw and not WIDTHS.search(k)
        s = spec.load_config(c["name"], ROOT / c["file"])
        assert s.hidden % s.heads == 0
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_workloads_name_their_files():
    configs = {c["name"] for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = spec.load_json("traffic", w["traffic"])
        assert (HERE / "drivers" / f"{mix['kind']}.py").exists()
        lim = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
        assert lim["limits"], w["name"]
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert fours <= max(1, len(MAN["workloads"]) // 4)


def reports(cell: str) -> set:
    return {m["name"] for m in MAN["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_end_to_end_metrics_and_bounds():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    for w in MAN["workloads"]:
        r = reports(w["name"])
        assert "setup_s" in r and len(r) >= 2, w["name"]


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_what_its_cells_report(m):
    assert "bound" not in m
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert one_line(m["layer"])
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for c in cells:
        assert m["moves"] in reports(c), (m["name"], c)
    assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_every_cell_reports_a_per_layer_metric():
    for w in MAN["workloads"]:
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in MAN["per_layer"])
