"""demucs_tpu_torch weights against demucs_tpu: the schema, the module
names, random init, ggml files in both directions, and the port's
independence from JAX."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from demucs_tpu import params as JP
from demucs_tpu.config import HTDEMUCS_4S as J4S, HTDEMUCS_6S as J6S

from demucs_tpu_torch import params as TP
from demucs_tpu_torch.config import HTDEMUCS_4S, HTDEMUCS_6S
from demucs_tpu_torch.models import HTDemucs, build_htdemucs
from demucs_tpu_torch.utils.device import f32_precision, resolve_device

REPO = Path(__file__).resolve().parents[1]
CONFIGS = [(J4S, HTDEMUCS_4S), (J6S, HTDEMUCS_6S)]


@pytest.mark.parametrize("jcfg,tcfg", CONFIGS, ids=["4s", "6s"])
def test_schema_equals_jax(jcfg, tcfg):
    ours = TP.htdemucs_schema(tcfg)
    assert ours == JP.htdemucs_schema(jcfg)
    assert list(ours) == list(JP.htdemucs_schema(jcfg))
    assert len(ours) == (533 if tcfg is HTDEMUCS_4S else 525)


@pytest.mark.parametrize("tcfg", [HTDEMUCS_4S, HTDEMUCS_6S], ids=["4s", "6s"])
def test_module_parameter_names_are_the_schema(tcfg):
    with torch.device("meta"):
        model = HTDemucs(tcfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == TP.htdemucs_schema(tcfg)


@pytest.mark.parametrize("seed", [0, 3])
def test_init_flat_bit_identical(seed):
    ours = TP.init_flat(TP.htdemucs_schema(HTDEMUCS_4S), seed=seed)
    ref = JP.init_flat(JP.htdemucs_schema(J4S), seed=seed)
    assert list(ours) == list(ref)
    for name in ref:
        assert ours[name].dtype == ref[name].dtype
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


def test_ggml_jax_writer_to_port_reader(tmp_path):
    flat = JP.init_flat(JP.htdemucs_schema(J4S), seed=1)
    path = tmp_path / "m.bin"
    JP.write_ggml(path, "htdemucs_4s", flat)
    cfg, sd = TP.load_model_params(path)
    assert cfg == HTDEMUCS_4S
    _, tree = JP.load_model_params(path)
    ref = JP.flatten_tree(tree)
    assert set(sd) == set(ref)
    for name, arr in ref.items():
        assert tuple(sd[name].shape) == arr.shape
        np.testing.assert_array_equal(sd[name].numpy(), arr, err_msg=name)


def test_ggml_port_writer_to_jax_reader(tmp_path):
    flat = TP.init_flat(TP.htdemucs_schema(HTDEMUCS_6S), seed=2)
    sd = TP.from_state_dict(flat, TP.htdemucs_schema(HTDEMUCS_6S))
    path = tmp_path / "m6.bin"
    TP.write_ggml(path, "htdemucs_6s", sd)
    kind, tensors = JP.load_ggml(path)
    assert kind == "htdemucs_6s"
    assert list(tensors) == list(flat)
    for name, arr in flat.items():
        # init_flat leaves some arrays in float64; the state dict holds f32
        want = np.squeeze(arr.astype(np.float32)).astype(np.float16)
        np.testing.assert_array_equal(tensors[name], want, err_msg=name)


def test_from_state_dict_rejects_bad_dicts():
    schema = {"a.weight": (2, 3), "a.bias": (3,)}
    good = {"a.weight": np.ones((2, 3, 1)), "a.bias": np.zeros(3)}
    out = TP.from_state_dict(good, schema)
    assert out["a.weight"].shape == (2, 3) and out["a.weight"].dtype == torch.float32
    with pytest.raises(ValueError, match="missing"):
        TP.from_state_dict({"a.weight": good["a.weight"]}, schema)
    with pytest.raises(ValueError, match="unexpected"):
        TP.from_state_dict({**good, "b": np.zeros(1)}, schema)
    with pytest.raises(ValueError, match="want"):
        TP.from_state_dict({**good, "a.bias": np.zeros(4)}, schema)


def test_build_htdemucs_is_strict():
    sd = TP.from_state_dict(TP.init_flat(TP.htdemucs_schema(HTDEMUCS_6S)),
                            TP.htdemucs_schema(HTDEMUCS_6S))
    sd.pop("freq_emb.embedding.weight")
    with pytest.raises(RuntimeError, match="freq_emb"):
        build_htdemucs(HTDEMUCS_6S, sd)


def test_tree_roundtrip_and_jax_conversion():
    flat = JP.init_flat(JP.htdemucs_schema(J6S), seed=4)
    tree = JP.unflatten_tree(flat)
    ours = TP.unflatten_tree(flat)
    assert TP.flatten_tree(ours).keys() == JP.flatten_tree(tree).keys()
    assert isinstance(ours["encoder"], list)
    assert isinstance(ours["encoder"][0]["dconv"]["layers"][0], dict)
    from_tree = TP.from_jax_params(tree)
    from_flat = TP.from_jax_params(flat)
    assert set(from_tree) == set(from_flat) == set(flat)
    for name, arr in flat.items():
        assert from_tree[name].dtype == torch.float32
        want = arr.astype(np.float32)
        np.testing.assert_array_equal(from_tree[name].numpy(), want)
        np.testing.assert_array_equal(from_flat[name].numpy(), want)


def test_load_model_params_rejects_unported_inputs(tmp_path):
    """A dmc3 file missing tensors fails the strict v3 schema check; a
    checkpoint directory and a bad magic are refused."""
    v3 = tmp_path / "v3.bin"
    TP.write_ggml(v3, "hdemucs_mmi", {"encoder.4.norm1.weight": np.ones(768)})
    with pytest.raises(ValueError, match="missing"):
        TP.load_model_params(v3)
    with pytest.raises(ValueError, match="directories"):
        TP.load_model_params(tmp_path)
    with pytest.raises(ValueError, match="magic"):
        TP.load_model_params(b"\0\0\0\0")


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_f32_precision_is_scoped():
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    with f32_precision():
        assert [f.allow_tf32 for f in flags] == [False, False]
    assert [f.allow_tf32 for f in flags] == before


_ISOLATION_PROBE = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "demucs_tpu"):
            raise ImportError(f"demucs_tpu_torch imported {name}")
        return None

sys.meta_path.insert(0, Block())
import demucs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(demucs_tpu_torch.__path__,
                                               "demucs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "demucs_tpu"))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_demucs_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _ISOLATION_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split(maxsplit=1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"
