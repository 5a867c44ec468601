"""The harness on the CPU: names found by file, the result line's keys, no
result without a card or without the port, and no JAX anywhere."""
import ast
import importlib.util
import json
import shutil
import subprocess
import sys

import pytest
import torch

import fedbench_tiny as tiny

from fedbench.harness import compare, session, spec as S, trace as T

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_name_of_benchmark_json_is_found():
    spec = S.benchmark()
    for w in spec["workloads"]:
        S.family(S.config(spec, w["config"]))
        S.traffic(w["traffic"])
        S.limits(w["name"])
        assert S.end_to_end(spec, w["name"])
        assert S.per_layer(spec, w["name"])
    for m in spec["per_layer"]:
        assert callable(S.reader(m["name"]))


def test_unknown_names_fail():
    spec = S.benchmark()
    for find, name in ((lambda n: S.cell(spec, n), "no-such-cell"),
                       (lambda n: S.config(spec, n), "no-such-config"),
                       (S.traffic, "no-such-mix"), (S.reader, "no_metric"),
                       (S.limits, "no-such-cell")):
        with pytest.raises(S.SpecError):
            find(name)


def test_per_layer_selection():
    spec = S.benchmark()
    e2e = {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        got = [m["name"] for m in S.per_layer(spec, w["name"])]
        assert got == [m["name"] for m in spec["per_layer"]
                       if w["name"] in m["workloads"]]
        assert "mfu" in got and "idle_share" in got
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tmp_path, trace):
    root = tiny.lay_out(tmp_path, "attn")
    rc, line, err = tiny.run_cell(root, trace=trace)
    assert rc == 0
    keys = CONTRACT_KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert list(line) == keys
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line["compared"]) == list(compare.NUMBERS)
    tail = err.strip().splitlines()[-len(compare.NUMBERS):]
    assert [t.split()[0] for t in tail] == list(compare.NUMBERS)
    if not trace:
        assert set(line["metrics"]) == {"round_s", "peak_mem_gb", "setup_s"}
        assert all(v["value"] > 0 for k, v in line["metrics"].items()
                   if k != "peak_mem_gb")
    else:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in line["device"]


def test_no_result_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(tiny.BENCH / "run.py"), "--workload",
         "phi3-d16.int8.b4x1024", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        cwd=tiny.ROOT, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_result_without_the_port(tmp_path, monkeypatch):
    """A checkout that holds only BENCHMARK.json and the benchmark's
    files: even where a card is seen, the run stops before any result."""
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = importlib.util.spec_from_file_location(
        "fedbench_run_copy", tmp_path / "fedbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(sys, "path", list(sys.path))
    assert run.main(["--workload", "phi3-d16.int8.b4x1024", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_scan():
    """No module of the benchmark imports JAX or the JAX package
    (top-level names compared whole: `repro_torch` is not `repro`), and
    the reference imports nothing of the port or of the harness."""
    files = sorted(tiny.BENCH.rglob("*.py"))
    assert files
    for f in files:
        names = set(_imports(f))
        assert not names & FORBIDDEN, (f, names & FORBIDDEN)
    for f in sorted((tiny.BENCH / "reference").rglob("*.py")):
        tree = ast.parse(f.read_text())
        mods = {n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level == 0}
        mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        assert "repro_torch" not in {m.split(".")[0] for m in mods}, f
        assert not any(m.startswith("fedbench.harness") for m in mods), f


def test_forbidden_modules_compare_whole_names():
    assert session.forbidden_modules(
        ["repro_torch", "repro_torch.fl", "reproduce", "jaxtyping"]) == []
    assert session.forbidden_modules(
        ["repro", "repro.core", "jax.numpy", "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_trace_reading(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 40,
         "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "fedbench.round",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "fl.data_draw",
         "ts": 16, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 3}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = T.read_chrome_trace(str(path))
    assert len(tr["device"]) == 3 and len(tr["host"]) == 3
    iv = T.busy_intervals(tr["device"])
    assert iv == [[0.0, 15.0], [40.0, 50.0]]
    assert T.idle_by_host(iv, tr["host"]) == [("fl.data_draw", 25e-6)]
    ops = dict(T.device_ops(tr["device"]))
    assert ops == {"k1": 10e-6, "k2": 10e-6, "copy": 10e-6}


def test_a_mix_past_the_sliding_window_is_refused():
    from fedbench.harness.program import Program
    cfg = dict(tiny.tiny_config("attn"), sliding_window=8)
    with pytest.raises(ValueError, match="sliding window"):
        Program(S.family(cfg), cfg, tiny.tiny_mix(seq=16), 1, {},
                device="cpu")
