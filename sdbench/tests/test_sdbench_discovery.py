"""A configuration, a traffic mix of a new kind, a cell and per-layer
metrics added as new files plus ``BENCHMARK.json`` entries, in a copy of
the benchmark, are found and run without any file that was there being
edited: the new kind's driver, the guidance the configuration states (none
here), the metric's own reader and a metric read by its base's."""

import hashlib
import json
import shutil
import subprocess
import sys

from sdbench import spec
from sdbench.tests.tiny import TINY


# a traffic kind of its own: one device request at a time
LOCKSTEP = '''
import sys

from sdbench import drive
from sdbench.traffic import batched

PER_ROW = True
call = batched.call
warm = batched.warm


def run(pipe, cfg, mix, inputs, seconds, tracer):
    print("lockstep", file=sys.stderr)
    return drive.run_closed(lambda reqs: call(pipe, cfg, mix, reqs), dict(mix, in_flight=1),
                            inputs, seconds, tracer)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "sdbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_suffice(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "sdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "sdtpu_torch").symlink_to(spec.ROOT / "sdtpu_torch")
    before = _digests(tmp_path)

    (tmp_path / "sdbench/configs/toy.json").write_text(json.dumps(dict(TINY, cfg_scale=1.0)))
    (tmp_path / "sdbench/traffic/lockstep.py").write_text(LOCKSTEP)
    (tmp_path / "sdbench/traffic/toy-b2.json").write_text(json.dumps(
        {"kind": "lockstep", "batch": 2, "prompt_tokens": [3, 9]}))
    (tmp_path / "sdbench/workloads/toy-b2.json").write_text(json.dumps(
        {"sample": 1, "limits": {"mean_abs_levels": 3.0}}))
    (tmp_path / "sdbench/metrics/toy_rows.py").write_text(
        "def read(ctx):\n    return float(sum(r.rows for r in ctx.window.records))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test", "file": "sdbench/configs/toy.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy-b2", "config": "toy", "traffic": "toy-b2",
                               "chips": 1, "why": "a toy cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("toy-b2")
    bench["per_layer"].append({"name": "toy_rows", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "pipeline",
                               "moves": "images_per_s", "workloads": ["toy-b2"]})
    bench["per_layer"].append({"name": "mfu_pct.toy", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "pipeline",
                               "moves": "images_per_s", "workloads": ["toy-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json, sys\n"
            "from sdbench import run, spec\n"
            "c = spec.load_cell('toy-b2')\n"
            "r0 = run.run_cell(c, 5, 0.5, False, 'cpu')\n"
            "r1 = run.run_cell(c, 5, 0.5, True, 'cpu')\n"
            "print(json.dumps([sorted(r0['metrics']), sorted(r1['metrics']), r0['correct'],\n"
            "                  r1['metrics']['toy_rows']['value'], r0['attempted']]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    e2e, per_layer, correct, rows, attempted = json.loads(out.stdout.strip().splitlines()[-1])
    assert e2e == ["images_per_s", "setup_s"]
    # the traced run reports the metrics that list the new cell
    assert per_layer == ["mfu_pct.toy", "toy_rows"] and correct and rows >= 2
    assert "lockstep" in out.stderr and attempted >= 2

    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())
