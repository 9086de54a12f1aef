"""The port's recipes (``tensorflowasr_tpu_torch/recipes/``) against the JAX
package's ``examples/``:

- ``recipes/synthetic_mandarin.py`` and ``examples/synthetic_mandarin/
  generate.py`` (run as a script, as users run it) write the same bytes for
  the same arguments; ``noise.list`` holds absolute paths, so only its root
  may differ;
- ``recipes/aishell1_prepare.py`` and ``examples/aishell1/prepare.py`` on
  that corpus write the same lists, vocabularies and phone map, and an
  ``am_data.yml`` equal as a dict once the output root is mapped;
- ``recipes/headtohead.py::write_configs`` gives the dicts
  ``examples/headtohead/run_ours.py::write_configs`` gives, for the offline,
  ``--streaming``, ``--chunk`` and ``--augment`` runs;
- the quick setting is ``bench.py::bench_headtohead_live``'s, argument for
  argument (read from its source with ``ast``);
- ``recipes.headtohead --device cpu`` at 4 steps of B = 4 writes a
  ``result.json`` with the keys of the JAX script's (as recorded in
  ``examples/headtohead/RESULTS.json``); ``--device cuda`` raises without a
  card."""

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import yaml

from tensorflowasr_tpu_torch.recipes import (
    aishell1_prepare,
    headtohead,
    synthetic_mandarin,
)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SMALL = ["--n_chars", "30", "--n_train", "8", "--n_dev", "2", "--n_test",
         "2", "--seed", "21", "--speakers", "3", "--reverb", "0.3",
         "--noise", "0.04", "--emit_noise", "2"]


def load_example(relpath: str):
    """An ``examples/`` script as a module (they are not a package)."""
    path = EXAMPLES / relpath
    spec = importlib.util.spec_from_file_location(
        "example_" + path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tree(root: pathlib.Path) -> dict:
    """relative path -> bytes of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def mapped(value, old: str, new: str):
    """``value`` with every string's ``old`` root replaced by ``new``."""
    if isinstance(value, dict):
        return {k: mapped(v, old, new) for k, v in value.items()}
    if isinstance(value, list):
        return [mapped(v, old, new) for v in value]
    if isinstance(value, str):
        return value.replace(old, new)
    return value


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The small corpus written by JAX's script and by the port's."""
    root = tmp_path_factory.mktemp("corpora")
    jax_dir, port_dir = root / "jax", root / "port"
    subprocess.run([sys.executable,
                    str(EXAMPLES / "synthetic_mandarin" / "generate.py"),
                    "--out_dir", str(jax_dir), *SMALL],
                   check=True, capture_output=True, timeout=300)
    assert synthetic_mandarin.main(["--out_dir", str(port_dir), *SMALL]) == 0
    return jax_dir, port_dir


def test_synthetic_corpus_is_byte_identical(corpora):
    jax_dir, port_dir = corpora
    want, got = tree(jax_dir), tree(port_dir)
    assert sorted(got) == sorted(want)
    assert len([k for k in want if k.endswith(".wav")]) == 8 + 2 + 2 + 2
    for name in want:
        if name == "noise.list":
            assert got[name].decode().replace(str(port_dir), "ROOT") == \
                want[name].decode().replace(str(jax_dir), "ROOT")
        else:
            assert got[name] == want[name], name


@pytest.fixture(scope="module")
def prepared(corpora, tmp_path_factory):
    """JAX's and the port's preparation of the JAX corpus."""
    jax_corpus, _ = corpora
    root = tmp_path_factory.mktemp("prepared")
    outs = root / "jax", root / "port"
    extra = ["--train_time_lexicon", str(jax_corpus / "lexicon.tsv"),
             "--bucket_seconds", "1.5,2,2.5,3,4"]
    prepare = load_example("aishell1/prepare.py")
    for main, out in zip((prepare.main, aishell1_prepare.main), outs):
        assert main(["--data_dir", str(jax_corpus), "--out_dir", str(out),
                     *extra]) == 0
    return outs


def test_prepare_writes_the_same_lists_vocabularies_and_map(prepared):
    jax_out, port_out = prepared
    want, got = tree(jax_out), tree(port_out)
    assert sorted(got) == sorted(want) == sorted(
        ["am_data.yml", "chars.txt", "dev.list", "phones.txt",
         "pinyin2phone.map", "test.list", "train.list"])
    for name in want:
        if name != "am_data.yml":
            assert got[name] == want[name], name
    assert len(want["train.list"].decode().splitlines()) == 8


def test_prepare_writes_the_same_data_config(prepared):
    jax_out, port_out = prepared
    want = yaml.safe_load((jax_out / "am_data.yml").read_text())
    got = yaml.safe_load((port_out / "am_data.yml").read_text())
    assert mapped(got, str(port_out), "ROOT") == \
        mapped(want, str(jax_out), "ROOT")
    assert got["speech_config"]["bucket_seconds"] == [1.5, 2.0, 2.5, 3.0,
                                                      4.0]
    assert got["speech_config"]["pinyin_lexicon"].endswith("lexicon.tsv")


@pytest.mark.parametrize("flags", [
    [], ["--streaming"], ["--chunk"], ["--augment"],
    ["--augment", "--noise_list", "/data/noise.list", "--lr", "5e-4",
     "--wav_max_duration", "5", "--total_steps", "300", "--batch", "8"],
], ids=["offline", "streaming", "chunk", "augment", "augment_noise"])
def test_write_configs_equal_jax(prepared, tmp_path, flags):
    jax_out, _ = prepared
    run_ours = load_example("headtohead/run_ours.py")
    dicts = []
    for side, write in (("jax", run_ours.write_configs),
                        ("port", headtohead.write_configs)):
        out = tmp_path / side
        out.mkdir()
        args = headtohead.build_parser().parse_args(
            ["--work_dir", str(jax_out), "--out_dir", str(out), *flags])
        data_yml, model_yml = write(args)
        dicts.append([mapped(yaml.safe_load(open(p)), str(out), "OUT")
                      for p in (data_yml, model_yml)])
    assert dicts[1] == dicts[0]


def test_write_configs_takes_the_jax_flags():
    """Every flag of run_ours.py but JAX's platform switch ``--cpu`` (the
    port takes ``--device``) parses with the same default (False for a
    switch)."""
    source = (EXAMPLES / "headtohead" / "run_ours.py").read_text()
    jax_flags = {}
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "add_argument":
            keywords = {k.arg: ast.literal_eval(k.value)
                        for k in node.keywords if k.arg != "type"}
            jax_flags[node.args[0].value.lstrip("-")] = (
                False if keywords.get("action") == "store_true"
                else keywords.get("default"))
    assert jax_flags.pop("cpu") is False
    port = vars(headtohead.build_parser().parse_args(
        ["--work_dir", "w", "--out_dir", "o"]))
    for flag, default in jax_flags.items():
        if flag not in ("work_dir", "out_dir"):
            assert port[flag] == default, flag
    assert port["device"] == "cuda"


def bench_quick_lists():
    """The string constants of the three argument lists
    ``bench_headtohead_live`` passes to generate.py, prepare.py and
    run_ours.py, in order."""
    source = (ROOT / "bench.py").read_text()
    fn = next(n for n in ast.parse(source).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "bench_headtohead_live")
    lists = [n.args[0] for n in ast.walk(fn)
             if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
             == "run" and n.args and isinstance(n.args[0], ast.List)]
    return [[e.value for e in lst.elts if isinstance(e, ast.Constant)]
            for lst in sorted(lists, key=lambda l: l.lineno)]


def test_quick_setting_is_bench_py_s(tmp_path):
    corpus, prepare, run = bench_quick_lists()
    root = str(tmp_path)
    got = headtohead.quick_commands(root, "cpu")
    paths = {os.path.join(root, "corpus"), os.path.join(root, "work"),
             os.path.join(root, "ours"),
             os.path.join(root, "corpus", "lexicon.tsv"),
             os.path.join(root, "corpus", "noise.list")}
    stripped = [[a for a in argv if a not in paths] for argv in got]
    assert stripped[0] == corpus
    assert stripped[1] == prepare
    assert stripped[2] == run + ["--device", "cpu"]
    assert run[run.index("--total_steps") + 1] == "2000"
    # the flags that carry paths name the same places as bench.py's
    assert got[1][got[1].index("--train_time_lexicon") + 1] == \
        os.path.join(root, "corpus", "lexicon.tsv")
    assert got[2][got[2].index("--noise_list") + 1] == \
        os.path.join(root, "corpus", "noise.list")


def jax_result_keys() -> set:
    """The keys of run_ours.py's result.json, as RESULTS.json records
    them."""
    with open(EXAMPLES / "headtohead" / "RESULTS.json") as f:
        return set(json.load(f)["families"]["offline"]["ours_round4"])


def test_headtohead_cpu_writes_jax_s_result(prepared, tmp_path, capsys):
    jax_out, _ = prepared
    out = tmp_path / "ours"
    assert headtohead.main(
        ["--work_dir", str(jax_out), "--out_dir", str(out),
         "--total_steps", "4", "--batch", "4", "--lr", "5e-4",
         "--data_workers", "0", "--eval_list", "train.list",
         "--device", "cpu"]) == 0
    result = json.loads((out / "result.json").read_text())
    assert set(result) == jax_result_keys()
    assert (result["framework"], result["model_family"],
            result["total_steps"], result["batch"]) == (
        "ours", "offline", 4, 4)
    assert result["phone_N"] > 0 and result["char_N"] > 0
    printed = [l for l in capsys.readouterr().out.splitlines()
               if l.startswith("RESULT ")]
    assert json.loads(printed[-1][len("RESULT "):]) == result
    assert sorted(os.listdir(out / "logs" / "checkpoints")) == [
        "ckpt_000000004.pt"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_headtohead_cuda_without_a_card_raises(prepared, tmp_path):
    jax_out, _ = prepared
    args = headtohead.build_parser().parse_args(
        ["--work_dir", str(jax_out), "--out_dir", str(tmp_path),
         "--total_steps", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        headtohead.run(args)
    assert not (tmp_path / "result.json").exists()

