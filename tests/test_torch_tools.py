"""demucs_tpu_torch's measuring tools (`tools/memory_report.py`,
`profile_hlo.py`, `bench_bag.py`, `bench_sweep.py`, and `bench_train.py`'s
command line) against the JAX package's tools of the same names, on the
CPU at tiny sizes (full-width models, 4096 samples): each port tool takes
every flag of the JAX tool with the JAX default (plus `--device`), and
its JSON holds every key the JAX tool's does; `memory_report`'s weight
bytes equal the JAX tree's `nbytes` in f32 and with int8 weights (q plus
scales); and `bench_train` measures the configuration a JAX command line
names. The JAX tools' flags are read from their parsers (stopped before
they parse), their keys from the dict literals of their sources."""

import argparse
import ast
import inspect
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demucs_tpu import params as JP
from demucs_tpu.config import HDEMUCS_V3 as JV3, HTDEMUCS_4S as J4S, HTDEMUCS_6S as J6S
from demucs_tpu.params.quant import quantize_int8 as jax_quantize_int8
from demucs_tpu.tools import bench_bag as j_bag
from demucs_tpu.tools import bench_sweep as j_sweep
from demucs_tpu.tools import bench_train as j_train
from demucs_tpu.tools import memory_report as j_mem
from demucs_tpu.tools import profile_hlo as j_prof

from demucs_tpu_torch.tools import bench_bag, bench_sweep, bench_train, memory_report, profile_hlo

from _torch_threads import _one_torch_thread  # noqa: F401

SEG = 4096
# the port's only flag more; and the output paths, which the port puts
# under the temporary directory
PORT_ONLY = {"--device"}
DEFAULTS_DIFFER = {"--out", "--trace-dir"}
# bench_train's --steps-per-call takes several values in the port (a sweep),
# one of which is the JAX default
SWEPT = {"--steps-per-call"}


class _Parsed(Exception):
    pass


def _parser(main, monkeypatch, *args) -> argparse.ArgumentParser:
    """The parser `main` builds, stopped before it parses."""
    def stop(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as caught:
            main(*args)
    return caught.value.args[0]


def _flags(parser) -> dict:
    return {a.option_strings[0]: a for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}


@pytest.mark.parametrize("jax_main,port_main", [
    (j_mem.main, memory_report.main), (j_prof.main, profile_hlo.main),
    (j_bag.main, bench_bag.main), (j_sweep.main, bench_sweep.main),
    (j_train.main, bench_train.main)],
    ids=["memory_report", "profile_hlo", "bench_bag", "bench_sweep", "bench_train"])
def test_tools_take_the_jax_flags(monkeypatch, jax_main, port_main):
    args = () if jax_main is j_prof.main else (None,)
    theirs = _flags(_parser(jax_main, monkeypatch, *args))
    ours = _flags(_parser(port_main, monkeypatch, None))
    extra = set(ours) - set(theirs) - PORT_ONLY
    if port_main is bench_train.main:
        extra -= {"--families", "--top"}  # the port's sweep over families; its profile
    assert set(theirs) <= set(ours) and not extra, (set(theirs) ^ set(ours))
    assert ours["--device"].default == "cuda"
    for flag, a in theirs.items():
        b = ours[flag]
        assert (b.choices, b.type, b.const) == (a.choices, a.type, a.const), flag
        if flag in SWEPT:
            assert b.nargs == "+" and b.default == [a.default], flag
            continue
        assert b.nargs == a.nargs, flag
        assert flag in DEFAULTS_DIFFER or b.default == a.default, flag


def _literal_keys(module, func: str) -> set[str]:
    """The string keys of the dict literals in `func` of `module`'s
    source, and the string subscripts it assigns to."""
    tree = ast.parse(inspect.getsource(module))
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def _all_keys(obj) -> set[str]:
    if isinstance(obj, dict):
        return set(obj).union(*(_all_keys(v) for v in obj.values()))
    if isinstance(obj, list):
        return set().union(*(_all_keys(v) for v in obj))
    return set()


def _jax_tree_bytes(cfg, schema_fn) -> dict[bool, int]:
    """nbytes of the trees the JAX memory_report gives its f32 program,
    with dense (False) and with int8 weights (True)."""
    params = JP.unflatten_tree(JP.init_flat(schema_fn(cfg), seed=0))
    int8 = jax.tree.map(lambda x: jnp.asarray(x) if np.asarray(x).dtype == np.int8
                        else jnp.asarray(x, jnp.float32), jax_quantize_int8(params))
    dense = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)
    return {int8_: sum(x.nbytes for x in jax.tree.leaves(tree))
            for int8_, tree in ((False, dense), (True, int8))}


@pytest.mark.parametrize("model,cfg,schema_fn", [
    ("4s", J4S, JP.htdemucs_schema), ("6s", J6S, JP.htdemucs_schema),
    ("v3", JV3, JP.hdemucs_v3_schema)], ids=["4s", "6s", "v3"])
def test_memory_report_weight_bytes_match_jax(model, cfg, schema_fn):
    keys = _literal_keys(j_mem, "compiled_memory")
    jax_bytes = _jax_tree_bytes(cfg, schema_fn)
    for int8 in (False, True):
        rep = memory_report.compiled_memory(model, batch=1, segment=SEG, dtype=torch.float32,
                                            int8=int8, device="cpu")
        assert keys <= set(rep), keys - set(rep)
        assert rep["weight_bytes"] == jax_bytes[int8], (model, int8)
        assert rep["argument_bytes"] == rep["weight_bytes"] + 2 * SEG * 4
        assert rep["output_bytes"] == cfg.num_sources * 2 * SEG * 4
        # the allocator's numbers are the card's: none on the CPU
        assert rep["temp_bytes"] is rep["peak_bytes"] is None
        assert rep["dtype"] == ("int8" if int8 else "f32") and rep["int8_skips"] is False


def test_memory_report_train_and_cli(capsys):
    rep = memory_report.train_compiled_memory("4s", batch=1, segment=SEG, device="cpu")
    keys = _literal_keys(j_mem, "train_compiled_memory")
    assert keys <= set(rep) and rep["mode"] == "train" and rep["remat"] is True
    # parameters, Adam's two moments and their step counters, the mix and the refs
    assert rep["argument_bytes"] > 3 * rep["weight_bytes"]
    memory_report.main(["--device", "cpu", "--segment", str(SEG), "--batch", "1", "--int8",
                        "--json"])
    line = json.loads(capsys.readouterr().out)
    assert line["dtype"] == "int8" and line["dtype_flag"] == "bf16" and line["device"] == "cpu"


def test_profile_hlo_report(tmp_path, monkeypatch, capsys):
    keys = _literal_keys(j_prof, "main")
    fake = {"convolution.1": 3e9, "fusion.2": 1e9}
    theirs = j_prof.group_report(fake, steps=2)
    ours = profile_hlo.group_report({"void fprop_kernel": 3e3, "mha_fwd_kernel<float>": 1e3},
                                    steps=2)
    assert set(ours) == set(theirs)
    assert ours["device_ms_per_step"] == theirs["device_ms_per_step"] == 2.0
    assert ours["buckets_ms"] == {"convolution": 1.5, "attention (K1)": 0.5}
    assert [r["op"] for r in ours["top_ops_ms"]] == ["void fprop_kernel", "mha_fwd_kernel<float>"]
    monkeypatch.setattr(profile_hlo, "CPU_SEGMENT_SAMPLES", SEG)
    out = tmp_path / "report.json"
    assert profile_hlo.main(["--device", "cpu", "--steps", "1", "--out", str(out),
                             "--trace-dir", str(tmp_path / "trace")]) == 0
    rep = json.loads(out.read_text())
    assert keys <= _all_keys(rep), keys - _all_keys(rep)
    assert set(theirs) <= set(rep)
    # no device on the CPU: no device time
    assert rep["device_ms_per_step"] is None and rep["wall_ms_per_step"] > 0
    assert rep["config"]["segment"] == SEG and (tmp_path / "trace" / "trace.json").exists()
    assert "wall_ms_per_step" in capsys.readouterr().out


def test_bench_bag_lines(monkeypatch, capsys):
    monkeypatch.setattr(bench_bag, "CPU_SEGMENT_SAMPLES", SEG)
    assert bench_bag.main(["--device", "cpu", "--iters", "1"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["strategy"] for r in lines] == ["vmap", "sequential4"]
    keys = _literal_keys(j_bag, "main")
    for r in lines:
        assert keys - {"note"} <= set(r) and r["step_s"] > 0 and r["device"] == "cpu"


def test_bench_sweep_lines_and_family(capsys):
    assert bench_sweep.main(["--device", "cpu", "--segment-samples", str(SEG), "--batches", "1",
                             "--iters", "1", "--quant", "int8", "--dtypes", "f32"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [(r["quant"], r["dtype"]) for r in lines] == [("int8", "f32")]
    for r in lines:
        assert _literal_keys(j_sweep, "main") <= set(r) and r["step_s"] > 0
    report = bench_sweep.family_bench(batch=1, iters=1, seg=SEG, device="cpu")
    json.dumps(report)
    # the family entries of the JAX report come from its table of families
    fams = {"htdemucs_4s", "htdemucs_6s", "hdemucs_v3"}
    assert _literal_keys(j_sweep, "family_bench") | fams <= _all_keys(report)
    for key in fams | {"ft_bag_sequential4", "ft_bag_unrolled", "train_step"}:
        assert report[key]["step_s"] > 0, key
    assert report["train_step"]["compute_dtype"] == "bf16" and report["device"] == "cpu"


# the JAX tool's own command lines (its docstring's and its family flags)
BENCH_TRAIN_ARGV = [
    [], ["--batches", "2", "4"],
    ["--batches", "4", "--remat", "off", "dots", "none", "dots_nb", "--dtypes", "f32", "bf16"],
    ["--v3"], ["--family", "htdemucs_6s"], ["--family", "hdemucs_v3", "--v3"],
    ["--steps-per-call", "2", "--segment-samples", "8192", "--iters", "3"],
]


@pytest.mark.parametrize("argv", BENCH_TRAIN_ARGV, ids=lambda a: " ".join(a) or "defaults")
def test_bench_train_measures_what_the_jax_command_line_names(monkeypatch, argv):
    names = {id(J4S): "htdemucs_4s", id(J6S): "htdemucs_6s", id(JV3): "hdemucs_v3"}
    theirs, ours = [], []

    def jax_one(cfg, batch, seg, remat, dtype_name, iters, lr=3e-4, steps_per_call=1):
        theirs.append((names[id(cfg)], batch, seg, remat, dtype_name, iters, steps_per_call))
        return {}

    def port_one(family, batch, seg, remat, dtype_name, iters, steps_per_call, device, top=0):
        ours.append((family, batch, seg, remat, dtype_name, iters, steps_per_call))
        return {}

    monkeypatch.setattr(j_train, "bench_one", jax_one)
    monkeypatch.setattr(bench_train, "bench_one", port_one)
    assert j_train.main(argv) == 0
    assert bench_train.main(argv + ["--device", "cpu"]) == 0
    assert ours == theirs and ours
