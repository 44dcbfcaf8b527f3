"""BENCHMARK.json against the benchmark's rules, the files it names, what
a run imports, and a run without a card."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "indonesian_image_captioning_tpu"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        names.append(w["name"])
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_have_their_readers_and_their_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "portbench" / "end_to_end"
                / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_rooflines_and_mfu_are_named_so():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"].endswith("_roofline") for m in BENCH["per_layer"])


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_a_run_imports_neither_jax_nor_the_jax_package():
    """Everything a run imports, the program's modules that the drivers
    load included, by whole top-level names."""
    out = _run(
        "import sys; sys.argv = ['x']\n"
        "import portbench.run, portbench.readings, portbench.trace\n"
        "from portbench.drivers import decode_batch, images_batch\n"
        "from portbench.drivers import train_cached\n"
        "import indonesian_image_captioning_tpu_torch.decode.api\n"
        "import indonesian_image_captioning_tpu_torch.train.steps\n"
        "import indonesian_image_captioning_tpu_torch.serve.engine\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))")
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    out = _run(
        "import sys\n"
        "import portbench.reference.decoder, portbench.reference.beam\n"
        "import portbench.reference.train, portbench.reference.resnet\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))")
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "indonesian_image_captioning_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_run_without_a_card_fails_and_prints_no_result(workload):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_run_beside_no_program_fails_and_prints_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
