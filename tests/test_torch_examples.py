"""The port's example scripts (``examples/torch_*.py``) at tiny sizes on the CPU.

Each script's ``main([...])`` runs in process with ``--device cpu``, and its
key lines are checked; without ``--device`` a script asks for the card and,
with none here, raises.  Every script imports only ``repro_torch``, numpy
and torch (and the standard library).
"""
import ast
import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SCRIPTS = ["torch_quickstart", "torch_svm_speedup", "torch_svm_multiclass", "torch_svm_stream",
           "torch_svm_serve_live", "torch_budgeted_kv_serve", "torch_train_lm"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the scripts' tensors are tiny, and a busy
    machine's cores are shared by the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv, capsys):
    _load(name).main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_imports_only_the_port(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots - set(sys.stdlib_module_names) <= {"repro_torch", "numpy", "torch"}, roots


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_asks_for_the_card(name):
    with pytest.raises(RuntimeError, match="CUDA device"):
        _load(name).main([])


def test_quickstart(capsys):
    out = _run("torch_quickstart", ["--n", "200", "--epochs", "1"], capsys)
    for method in ("gss", "gss-precise", "lookup-h", "lookup-wd"):
        assert re.search(rf"{method}\s+acc=0\.\d+\s+SVs=\d+/40", out), method
    assert "lookup tables built" in out


def test_svm_speedup_prints_both_paper_figures(capsys):
    out = _run("torch_svm_speedup", ["--n", "800", "--budget", "10"], capsys)
    for method in ("gss", "lookup-wd"):
        line = re.search(rf"{method}\s+time=.*merges=(\d+) merge_time=(\d+)% of total", out)
        assert line and int(line.group(1)) > 0, method
    figures = re.search(r"paper figures on cpu: total-training-time improvement (-?[\d.]+)% "
                        r"\(paper 44%\), merging-time reduction (-?[\d.]+)% \(paper 65%\)", out)
    assert figures, out


def test_svm_speedup_streamed(capsys):
    out = _run("torch_svm_speedup", ["--n", "300", "--budget", "8", "--stream",
                                     "--chunk-rows", "64"], capsys)
    assert "streamed in 64-row chunks" in out and "paper figures on cpu" in out


def test_svm_multiclass(capsys):
    out = _run("torch_svm_multiclass", ["--n", "400", "--classes", "4", "--budget", "10",
                                        "--batch-size", "8"], capsys)
    acc = float(re.search(r"batched OVR: time=\s*[\d.]+s\s+test_acc=([\d.]+)", out).group(1))
    merges = re.search(r"per-class merges: \[.*\]  \(total (\d+)\)", out)
    assert acc >= 0.9 and int(merges.group(1)) > 0
    assert "loop-over-classes baseline" in out


def test_svm_multiclass_streamed(capsys):
    out = _run("torch_svm_multiclass", ["--n", "400", "--classes", "4", "--budget", "10",
                                        "--batch-size", "8", "--stream", "--chunk-rows", "128",
                                        "--skip-loop-baseline"], capsys)
    assert "one-vs-rest, streamed" in out and "loop-over-classes" not in out


def test_svm_stream(capsys):
    out = _run("torch_svm_stream", ["--n", "1000", "--chunk-rows", "160", "--budget", "16"],
               capsys)
    assert "state bit-equal to in-memory train_epoch on the same order" in out
    assert "resumed mid-epoch: final state bit-equal" in out


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "chaos"])
def test_svm_serve_live(faults, capsys):
    argv = ["--n", "1024", "--chunk-rows", "128", "--budget", "16", "--epochs", "1"]
    out = _run("torch_svm_serve_live", argv + (["--faults", "0"] if faults else []), capsys)
    assert "queue == direct predict (bitwise)" in out
    versions = re.search(r"versions served: (\{.*\})", out).group(1)
    assert len(ast.literal_eval(versions)) >= 2
    assert ("chaos drill survived" in out) == faults


def test_budgeted_kv_serve(capsys):
    out = _run("torch_budgeted_kv_serve", ["--budget", "16", "--steps", "64", "--batch", "2",
                                           "--heads", "2", "--head-dim", "16"], capsys)
    assert re.search(r"t=\s+64 cache= 16/16\s+merge_err=[\d.]+\s+evict_err=[\d.]+", out), out
    final = re.search(r"final rel err: merge=([\d.]+) evict=([\d.]+)", out)
    assert final and float(final.group(1)) <= float(final.group(2))


def test_train_lm(capsys):
    """One layer of the default model's width, 100 steps of 8 x 32 tokens."""
    out = _run("torch_train_lm", ["--layers", "1", "--steps", "100", "--seq-len", "32"], capsys)
    assert re.search(r"training smollm_360m: [\d.]+M params, 100 steps, batch 8 x 32", out), out
    first, last = map(float, re.search(r"loss: first10=([\d.]+) last10=([\d.]+)", out).groups())
    assert last < first - 0.5 and "OK: loss dropped toward the bigram floor" in out
