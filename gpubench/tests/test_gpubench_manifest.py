"""The harness finds a configuration, a traffic mix and a per-layer metric
by name, as new files; and it loads no module it may not load."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import run, traffic_gen

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"


def test_new_config_traffic_and_metric_are_found_as_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "gpubench").rglob("*") if p.is_file()}
    cfg = json.loads((BENCH / "configs/t2v-1.3b-int8.json").read_text())
    (tmp_path / "gpubench/configs/t2v-1.3b-int8-b.json").write_text(
        json.dumps(dict(cfg, name="t2v-1.3b-int8-b")))
    (tmp_path / "gpubench/traffic/pairs.json").write_text(json.dumps(
        {"kind": "closed_loop", "clients": 1, "blocks_deck": {"2": 1}, "prompt_words": [8, 8]}))
    (tmp_path / "gpubench/metrics/double_dit_ms.py").write_text(
        "def read(run):\n    return 2 * run['dit_ms'][0] if run['dit_ms'] else None\n")
    manifest["configs"].append(dict(manifest["configs"][0], name="t2v-1.3b-int8-b",
                                    file="gpubench/configs/t2v-1.3b-int8-b.json"))
    manifest["workloads"].append({"name": "t2v-1.3b-int8-b.pairs", "config": "t2v-1.3b-int8-b",
                                  "traffic": "pairs", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "double_dit_ms", "unit": "ms", "better": "lower",
                                  "source": "program_span", "layer": "DiT", "moves": "fps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = ("import itertools, json; from gpubench import run, traffic_gen as t;"
            "w, c, m = run.find_cell('t2v-1.3b-int8-b.pairs', run.load_json(run.ROOT / "
            "'BENCHMARK.json'));"
            "s = list(itertools.islice(t.sessions(m, 3), 3));"
            "print(json.dumps([c['name'], [x.num_blocks for x in s],"
            " run.metric_reader('double_dit_ms')({'dit_ms': [21.0]})]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(tmp_path)), check=True)
    assert json.loads(out.stdout) == ["t2v-1.3b-int8-b", [2, 2, 2], 42.0]
    for p, data in before.items():  # no file of the benchmark was edited
        assert p.read_bytes() == data


@pytest.mark.parametrize("change", [{"kind": "open_loop"}, {"clients": 2},
                                    {"use_taehv": True}])
def test_a_mix_the_harness_does_not_implement_is_refused(change):
    mix = dict(traffic_gen.load("stream"), **change)
    with pytest.raises(ValueError, match=next(iter(change))):
        next(traffic_gen.sessions(mix, 1))


def test_forbidden_modules_are_matched_by_whole_top_level_name():
    assert run.forbidden_modules(["realtime_video_tpu_torch", "realtime_video_tpu_torch.ops",
                                  "jaxtyping", "flaxen", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "realtime_video_tpu.models", "flax",
                                  "jaxlib"]) == ["flax", "jax", "jaxlib", "realtime_video_tpu"]


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imported_tops(path) & set(run.FORBIDDEN_MODULES), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "realtime_video_tpu_torch" not in _imported_tops(path), path
    code = ("import sys; import gpubench.check, gpubench.reference.wan_dit, "
            "gpubench.reference.wan_vae, gpubench.reference.umt5; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'realtime_video_tpu', 'realtime_video_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_the_run_loads_no_jax():
    code = ("import sys; from gpubench import run; import realtime_video_tpu_torch.serving.models, "
            "realtime_video_tpu_torch.serving.session; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env=dict(os.environ, USE_FLAX="0"))
    assert out.stdout.strip() == "[]"
