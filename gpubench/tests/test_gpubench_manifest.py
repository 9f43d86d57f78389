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


#: a layout's reference and its count of work, as a later configuration adds
#: them: its served DiT drawn from the run's seed + 1 (key 1, as a second
#: DiT of the process would be), the VAE as Wan's
LAYOUT_REFERENCE = """from gpubench.reference.wan_dit import WanDiT
from gpubench.reference.wan_vae import WanVAE


class SecondDiT(WanDiT):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, key=1, **kwargs)


class PlainVAE(WanVAE):
    pass
"""
LAYOUT_WORK = """from gpubench import roofline


def warm_block_work(cfg):
    work = roofline.warm_block_work(cfg)
    work["second_dit"] = roofline.dit_linear_work(cfg, roofline.block_tokens(cfg), 1)
    return work
"""


def _copy_with_new_files(tmp_path, files: dict, configs=(), workloads=(), per_layer=()):
    """gpubench copied under tmp_path with `files` added and BENCHMARK.json
    extended; returns the copy's files before the additions, with their bytes."""
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "gpubench").rglob("*") if p.is_file()}
    for rel, text in files.items():
        (tmp_path / rel).write_text(text)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"] += list(configs)
    manifest["workloads"] += list(workloads)
    manifest["per_layer"] += list(per_layer)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return before


def _layout_config() -> dict:
    """The tiny configuration with every key a file may state about its
    layout: a VAE entry of the port other than "wan2.1", the stride, the
    reference classes and the count of work of new files. (The port's
    session holds 16 latent channels at stride 8, so the run keeps those.)"""
    from gpubench.tests import tiny

    cfg = tiny.tiny_cell()[0]
    cfg.update(name="tiny-layout",
               reference_modules={"dit": "tiny_layout:SecondDiT", "vae": "tiny_layout:PlainVAE"},
               work="tiny_layout_work:warm_block_work")
    cfg["port"] = dict(cfg["port"], vae_name="vae-tiny16")
    cfg["vae"] = dict(cfg["vae"], stride=[4, 8, 8])
    return cfg


def test_new_config_traffic_and_metric_are_found_as_new_files(tmp_path):
    cfg = json.loads((BENCH / "configs/t2v-1.3b-int8.json").read_text())
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    layout_cfg = dict(cfg, name="t2v-1.3b-int8-b", work="tiny_layout_work:warm_block_work",
                      reference_modules={"dit": "tiny_layout:SecondDiT"},
                      vae=dict(cfg["vae"], z_dim=48, stride=[4, 16, 16]))
    layout_cfg["port"] = dict(cfg["port"], vae_name="wan2.2")
    before = _copy_with_new_files(
        tmp_path,
        {"gpubench/configs/t2v-1.3b-int8-b.json": json.dumps(layout_cfg),
         "gpubench/traffic/pairs.json": json.dumps(
             {"kind": "closed_loop", "clients": 1, "blocks_deck": {"2": 1},
              "prompt_words": [8, 8], "placement": {"vae_sp_devices": 3}}),
         "gpubench/metrics/double_dit_ms.py":
             "def read(run):\n    return 2 * run['dit_ms'][0] if run['dit_ms'] else None\n",
         "gpubench/reference/tiny_layout.py": LAYOUT_REFERENCE,
         "gpubench/tiny_layout_work.py": LAYOUT_WORK},
        configs=[dict(manifest["configs"][0], name="t2v-1.3b-int8-b",
                      file="gpubench/configs/t2v-1.3b-int8-b.json")],
        workloads=[{"name": "t2v-1.3b-int8-b.pairs", "config": "t2v-1.3b-int8-b",
                    "traffic": "pairs", "chips": 4, "why": "a test"}],
        per_layer=[{"name": "double_dit_ms", "unit": "ms", "better": "lower",
                    "source": "program_span", "layer": "DiT", "moves": "fps"}])
    code = ("import itertools, json; from gpubench import layout, run, traffic_gen as t;"
            "w, c, m = run.find_cell('t2v-1.3b-int8-b.pairs', run.load_json(run.ROOT / "
            "'BENCHMARK.json'));"
            "s = list(itertools.islice(t.sessions(m, 3), 3));"
            "print(json.dumps([c['name'], [x.num_blocks for x in s],"
            " run.metric_reader('double_dit_ms')({'dit_ms': [21.0]}), m['placement'],"
            " layout.vae_name(c), layout.latent_shape(c, 3), layout.reference(c, 'dit').__name__,"
            " layout.reference(c, 'vae').__name__, sorted(layout.work(c))]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(tmp_path)), check=True)
    assert json.loads(out.stdout) == [
        "t2v-1.3b-int8-b", [2, 2, 2], 42.0, {"vae_sp_devices": 3}, "wan2.2",
        [1, 3, 48, 30, 52], "SecondDiT", "WanVAE", ["attention", "conv", "linear", "second_dit"]]
    for p, data in before.items():  # no file of the benchmark was edited
        assert p.read_bytes() == data


def test_a_new_layout_runs_as_new_files_and_reads_correct(tmp_path):
    """A configuration that names another VAE entry of the port, its own
    reference and work modules and a DiT of another key runs end to end on
    the CPU (tiny.py's path) from new files alone, and its check passes."""
    from gpubench.tests.test_gpubench_correctness import TINY_LIMITS

    cfg = dict(_layout_config(), limits=TINY_LIMITS)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _copy_with_new_files(
        tmp_path,
        {"gpubench/configs/tiny-layout.json": json.dumps(cfg),
         "gpubench/traffic/three.json": json.dumps(
             {"kind": "closed_loop", "clients": 1, "blocks_deck": {"3": 1},
              "prompt_words": [8, 12], "check_sessions": 1}),
         "gpubench/reference/tiny_layout.py": LAYOUT_REFERENCE,
         "gpubench/tiny_layout_work.py": LAYOUT_WORK},
        configs=[dict(manifest["configs"][0], name="tiny-layout",
                      file="gpubench/configs/tiny-layout.json")],
        workloads=[{"name": "tiny-layout.three", "config": "tiny-layout", "traffic": "three",
                    "chips": 1, "why": "a test"}])
    code = """
import json, types
from gpubench import layout, run
from gpubench.tests import tiny
from realtime_video_tpu_torch import config as port
from realtime_video_tpu_torch.serving import models

w, cfg, mix = run.find_cell("tiny-layout.three", run.load_json(run.ROOT / "BENCHMARK.json"))
tiny.use_tiny_port(types.SimpleNamespace(setitem=lambda d, k, v: d.__setitem__(k, v)), cfg)
port.VAE_CONFIGS["vae-tiny16"] = port.VAE_CONFIGS["wan2.1"]  # as the port would list it
run.check_port_sizes(cfg)  # against that entry, by the file's name
build = models._build_base_transformer  # the served DiT made from the run's seed + 1
models._build_base_transformer = lambda c, ckpt, shift, dev, seed: build(c, ckpt, shift, dev,
                                                                          seed + 1)
args = tiny.args(seconds=6.0)
args.workload = "tiny-layout.three"
result = run.run(args, device="cpu")
# the same run checked against the DiT of key 0 (the run's seed): not correct
plain = dict(cfg, reference_modules={"vae": "tiny_layout:PlainVAE"})
other = run.run(args, device="cpu", cfg=plain, mix=mix, work=w)
print(json.dumps([result["correct"], result["checks"], layout.latent_shape(cfg, 3),
                  other["correct"]]))
"""
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{ROOT}", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    correct, checks, shape, with_key_0 = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and set(checks) == set(TINY_LIMITS), checks
    assert not with_key_0
    assert shape == [1, 3, 16, 8, 8]
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("change", [{"kind": "open_loop"}, {"clients": 2},
                                    {"use_taehv": True}, {"placement": {"vae_gpu": 1}}])
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
