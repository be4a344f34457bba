"""The run's result line and exit codes, ``BENCHMARK.json`` against the
contract's limits, and the imports: nothing the benchmark loads is JAX or
the JAX package, and the reference loads nothing of the program."""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdbench import run, spec, traffic
from sdbench.tests.tiny import cell, mix

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_result_line_keys():
    c = cell(mix("batch8", batch=2))
    r = run.run_cell(c, 2**31 + 99, 1.0, False, "cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "check"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    units = {m["name"]: m["unit"] for m in c.end_to_end}
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
        assert m["value"] > 0 or name == "peak_mem_gib"
    assert {"images_per_s", "setup_s", "peak_mem_gib"} <= set(r["metrics"])
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["check"]) == {"mean_abs_levels"}
    assert set(r["check"]["mean_abs_levels"]) == {"value", "limit"}
    json.dumps(r)


def test_image_readings():
    from sdbench.check import image_readings, readings

    ref = np.zeros((4, 5, 3), np.uint8)
    img = ref.copy()
    img[0, :, 0] = 3      # 5 of 60 values 3 levels off
    img[1, 0, :] = 200    # 3 of 60 values 200 levels off
    names = ["mean_abs_levels", "pct_over_2_levels", "pct_over_3_levels"]
    r = image_readings(img, ref, names)
    assert r["mean_abs_levels"] == pytest.approx((5 * 3 + 3 * 200) / 60)
    assert r["pct_over_2_levels"] == pytest.approx(100 * 8 / 60)
    assert r["pct_over_3_levels"] == pytest.approx(100 * 3 / 60)
    # the sample's worst image, per number
    worst = readings([img, ref], [ref, ref], names)
    assert worst == r
    assert readings([], [], names)["mean_abs_levels"] is None
    with pytest.raises(KeyError):
        image_readings(img, ref, ["max_levels"])


def test_a_number_beyond_its_limit_or_unset_is_not_correct():
    from sdbench.check import judge

    assert judge({"a": 1.0}, {"a": 2.0})[0]
    assert not judge({"a": 3.0}, {"a": 2.0})[0]
    assert not judge({"a": 1.0}, {"a": None})[0]
    assert not judge({"a": None}, {"a": 2.0})[0]


def test_exits_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "sdbench.run", "--workload", "tinysd-b8",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_imports_are_neither_jax_nor_the_jax_package():
    code = ("import sys, json\n"
            "from sdbench import run, check, drive, trace, traffic, weights, work, control\n"
            "from sdbench.tests.tiny import cell, mix\n"
            "r = run.run_cell(cell(mix('single2')), 7, 0.5, False, 'cpu')\n"
            "import sdbench.reference.pipeline\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "HOME": str(spec.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)
    assert "sdtpu_torch" in top


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import sdbench.reference.pipeline, sdbench.check\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "sdtpu", "sdtpu_torch"}


def test_benchmark_json_keeps_the_contract():
    b = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["sdbench"] and 1 <= b["run_seconds"] <= 51
    n_cells = len(b["workloads"])
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).is_file() and c["file"].startswith("sdbench/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (spec.HERE / "workloads" / f"{w['name']}.json").is_file()
        c = spec.load_cell(w["name"])
        assert callable(traffic.kind(c.traffic).run)
        assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
        assert c.per_layer
        lim = json.loads((spec.HERE / "workloads" / f"{w['name']}.json").read_text())
        assert lim["limits"]["mean_abs_levels"] is not None
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
        for cell_name in m["workloads"]:
            assert any(x["name"] == m["moves"] for x in spec.load_cell(cell_name).end_to_end)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert callable(run.load_metric(m["name"]))
    for w in b["workloads"] + b["configs"]:
        assert NAME.match(w["name"])
    assert n_cells <= 24 and len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
