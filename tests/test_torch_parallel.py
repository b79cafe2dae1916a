"""demucs_tpu_torch.parallel against demucs_tpu.parallel on the CPU.

The port runs over gloo ranks, one process each
(`tests/torch_ranks_worker.py`: 2 ranks, 4 for the bag), the JAX
package over the conftest's 8-device virtual CPU mesh, both on the
inputs of tests/test_parallel.py (its seeds, mixes and segment of 8192
samples) and the same weights (the JAX package's `init_flat`, carried
over by `from_jax_params`). The model is a narrow htdemucs-4s (channels
8, bottom 64: a transformer of 8 heads of D=8 whose projections --int8
quantizes) so the suite stays cheap; the tp rule is checked on the
full-width schemas.

Tolerances, float32 on the CPU:
  * separation: atol 2e-5, tests/test_parallel.py's for the JAX sharded
    programs against the unsharded one;
  * the two training steps: tests/test_torch_train.py's (rtol 2e-4, atol
    2e-5; the one-channel biases that feed a GroupNorm, whose gradient is
    a rounding residue, within 2 lr a step), against the port's
    single-process step (which tests/test_torch_train.py holds to the JAX
    package's) and against make_sharded_train_step; the first dp=2
    step's averaged gradients against the one-process step's: 2e-4 of
    each tensor's norm;
  * a tp=2 layer's output and gradients against the whole layer's (one
    process): 1e-6 of each gradient's scale, the order of the sums the
    only difference.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from demucs_tpu import params as JP
from demucs_tpu.config import HDEMUCS_V3 as J_V3
from demucs_tpu.config import HTDEMUCS_4S as J4S
from demucs_tpu.config import HTDEMUCS_6S as J6S
from demucs_tpu.models import htdemucs_segment
from demucs_tpu.models.bag import stack_bag_params
from demucs_tpu.parallel import ShardedSeparator as JShardedSeparator
from demucs_tpu.parallel import make_bag_fn as j_make_bag_fn
from demucs_tpu.parallel import make_mesh as j_make_mesh
from demucs_tpu.parallel import make_sharded_fn as j_make_sharded_fn
from demucs_tpu.parallel import mesh_shape_for as j_mesh_shape_for
from demucs_tpu.parallel import param_pspecs
from demucs_tpu.params.quant import quantize_int8 as j_quantize_int8
from demucs_tpu.params.quant import quantized_model_fn
from demucs_tpu.pipeline import ApplyOptions as JApplyOptions
from demucs_tpu.train import make_sharded_train_step

from demucs_tpu_torch.config import HTDEMUCS_4S
from demucs_tpu_torch.models import build_model, feeds_group_norm
from demucs_tpu_torch.ops.cuda.quant_matmul import quant_plan
from demucs_tpu_torch.params import from_jax_params
from demucs_tpu_torch.parallel import mesh_shape_for, tp_dim
from demucs_tpu_torch.train import TrainStep

from _torch_ranks import REPO, run_ranks
from _torch_threads import _one_torch_thread  # noqa: F401

SEG = 8192
NARROW = dict(channels=8, bottom_channels=64, t_layers=3)
JCFG = dataclasses.replace(J4S, **NARROW)
ATOL = 2e-5
LR, EMA = 1e-3, 0.9
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
WORKER = REPO / "tests" / "torch_ranks_worker.py"


def _inputs() -> dict:
    """The weights and inputs of the ranks, as tests/test_parallel.py and
    tests/test_torch_train.py make them."""
    schema = JP.htdemucs_schema(JCFG)
    d = {f"seed{s}/{k}": np.asarray(v, np.float32)
         for s in range(5) for k, v in JP.init_flat(schema, seed=s).items()}
    d["mix_dp"] = (np.random.default_rng(0).standard_normal((8, 2, SEG)) * 0.1
                   ).astype(np.float32)
    d["mix_tp"] = (np.random.default_rng(1).standard_normal((2, 2, SEG)) * 0.1
                   ).astype(np.float32)
    mix = (np.random.default_rng(2).standard_normal((1, 2, SEG)) * 0.1).astype(np.float32)
    d["mix_bag"] = np.concatenate([mix, mix])  # a batch of 2: the dp axis populated too
    d["audio"] = (np.random.default_rng(6).standard_normal((2, 30011)) * 0.3
                  ).astype(np.float32)
    rng = np.random.default_rng(0)
    d["train_mix"] = (rng.standard_normal((2, 2, SEG)) * 0.1).astype(np.float32)
    d["train_refs"] = (rng.standard_normal((2, JCFG.num_sources, 2, SEG)) * 0.05
                       ).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _ranks(tmp_path_factory, inputs, world: int) -> dict:
    where = tmp_path_factory.mktemp(f"ranks{world}")
    try:
        np.savez(where / "inputs.npz", **inputs)
        run_ranks(WORKER, world, str(where))
        with np.load(where / "out.npz") as out:
            return dict(out)
    finally:
        shutil.rmtree(where, ignore_errors=True)


@pytest.fixture(scope="module")
def two(tmp_path_factory, inputs):
    """What rank 0 of 2 gloo ranks computed (torch_ranks_worker.py)."""
    return _ranks(tmp_path_factory, inputs, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory, inputs):
    return _ranks(tmp_path_factory, inputs, 4)


def _params(inputs, seed: int):
    prefix = f"seed{seed}/"
    return JP.unflatten_tree({k[len(prefix):]: v for k, v in inputs.items()
                              if k.startswith(prefix)})


def _segment(p, m):
    return htdemucs_segment(p, m, JCFG)


@pytest.mark.parametrize("n,tp,bag", [(8, 1, 1), (8, 2, 1), (8, 2, 4), (8, 3, 1), (4, 2, 1),
                                      (4, 1, 4), (2, 2, 1), (1, 1, 1), (6, 4, 1), (16, 8, 2)])
def test_mesh_shape_for_matches_jax(n, tp, bag):
    """tests/test_parallel.py's table and more: the same factors, and a
    ValueError where the JAX function raises one."""
    try:
        want = j_mesh_shape_for(n, tp=tp, bag=bag)
    except ValueError:
        with pytest.raises(ValueError):
            mesh_shape_for(n, tp=tp, bag=bag)
    else:
        assert mesh_shape_for(n, tp=tp, bag=bag) == want


def _schema_tree(schema):
    return JP.unflatten_tree({k: np.broadcast_to(np.float32(0), shape)
                              for k, shape in schema.items()})


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("cfg", [J4S, J6S, J_V3], ids=["4s", "6s", "v3"])
def test_tp_rule_selects_what_param_pspecs_shards(cfg, tp):
    """tp_dim picks the state-dict entries that the JAX package's
    param_pspecs gives a "tp" axis, on the same dimension; none of v3."""
    v3 = cfg is J_V3
    schema = JP.hdemucs_v3_schema(cfg) if v3 else JP.htdemucs_schema(cfg)
    specs = param_pspecs(_schema_tree(schema), j_make_mesh(tp=tp))
    flat, _ = jax.tree.flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))
    want = {}
    for path, spec in flat:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if "tp" in tuple(spec):
            want[name] = tuple(spec).index("tp")
    ours = {name: d for name, shape in schema.items()
            if (d := tp_dim(name, shape, tp)) is not None}
    assert ours == want
    assert (not ours) == v3
    if not v3:  # in_proj, linear1 (weight, bias), linear2, out_proj of every layer
        assert len(ours) == 6 * 2 * cfg.t_layers


def test_dp_matches_jax(inputs, two):
    """dp=2 ranks against make_sharded_fn over dp=8 (batch 8, seed 3), and
    a batch of 3, padded to a multiple of dp and cut back."""
    fn, placed, in_sh = j_make_sharded_fn(_segment, j_make_mesh(), _params(inputs, 3))
    want = np.asarray(fn(placed, jax.device_put(inputs["mix_dp"], in_sh)))
    np.testing.assert_allclose(two["dp"], want, atol=ATOL)
    np.testing.assert_allclose(two["dp_odd"], want[:3], atol=ATOL)


def _tp_mesh():
    return j_make_mesh(jax.devices()[:4], tp=2)  # dp=2, tp=2


def test_tp_matches_jax(inputs, two):
    """tp=2 ranks (4 heads each) against make_sharded_fn at tp=2."""
    fn, placed, in_sh = j_make_sharded_fn(_segment, _tp_mesh(), _params(inputs, 4))
    want = np.asarray(fn(placed, jax.device_put(inputs["mix_tp"], in_sh)))
    np.testing.assert_allclose(two["tp"], want, atol=ATOL)


def test_tp_int8_matches_jax(inputs, two):
    """--int8 at tp=2: the port shards each quantized projection (q with
    its rows' scales, or q's columns with every scale); the JAX rule
    leaves quantized leaves whole, so its result is the dense product."""
    q = j_quantize_int8(_params(inputs, 4))
    fn, placed, in_sh = j_make_sharded_fn(quantized_model_fn(_segment), _tp_mesh(), q)
    want = np.asarray(fn(placed, jax.device_put(inputs["mix_tp"], in_sh)))
    np.testing.assert_allclose(two["tp_int8"], want, atol=ATOL)
    # rank 0's shares: Q, K and V rows of its 4 heads with their scales;
    # linear2's first half of the input columns with all 64 scales
    flat = JP.flatten_tree(q)
    name = "crosstransformer.layers.0.self_attn.in_proj_weight"
    C = 64
    rows = np.r_[0:C // 2, C:C + C // 2, 2 * C:2 * C + C // 2]
    assert two["tp_rank"] == 0
    np.testing.assert_array_equal(two["int8_in_proj_q"], np.asarray(flat[name + ".q"])[rows])
    np.testing.assert_array_equal(two["int8_in_proj_scale"].reshape(-1),
                                  np.asarray(flat[name + ".scale"]).reshape(-1)[rows])
    name = "crosstransformer.layers.0.linear2.weight"
    np.testing.assert_array_equal(two["int8_linear2_q"], np.asarray(flat[name + ".q"])[:, :128])
    np.testing.assert_array_equal(two["int8_linear2_scale"].reshape(-1),
                                  np.asarray(flat[name + ".scale"]).reshape(-1))


def test_shard_then_gather_is_the_identity(two):
    assert two["roundtrip_equal"]


def test_multihost_mesh_keeps_tp_inside_a_host(two):
    """make_mesh over 2 ranks on the CPU (one host): tp=2 gives (1, 1, 2);
    tp=4 exceeds the ranks and raises. With the ranks made to report a
    host each, a tp=2 group would span two hosts and raises, as the JAX
    make_multihost_mesh does past the per-host device count, while dp=2
    over the two hosts is allowed."""
    np.testing.assert_array_equal(two["multihost_shape"], [1, 1, 2])
    assert two["multihost_tp4_raises"]
    assert two["cross_host_tp_raises"]
    np.testing.assert_array_equal(two["cross_host_dp_shape"], [1, 2, 1])


def test_bag_matches_jax(inputs, four):
    """bag=4 ranks, one model each (seeds 0-3), against make_bag_fn over
    bag=4, dp=2; both rows of the batch equal the one mix's stems."""
    stacked = stack_bag_params([_params(inputs, s) for s in range(4)])
    fn, placed, in_sh = j_make_bag_fn(_segment, j_make_mesh(bag=4), stacked)
    want = np.asarray(fn(placed, jax.device_put(inputs["mix_bag"], in_sh)))
    np.testing.assert_allclose(four["bag"], want, atol=ATOL)
    np.testing.assert_array_equal(four["shares"].reshape(-1), [0, 1, 2, 3])


def _positional(params, mix):
    B, C, T = mix.shape
    ramp = 0.5 + jnp.arange(T, dtype=jnp.float32) / (2 * T)
    d1 = jnp.pad(mix, ((0, 0), (0, 0), (3, 0)))[:, :, :T]
    return jnp.stack([mix * ramp, d1 * ramp], axis=1)


def test_sharded_separator_batched_and_fused_match_jax(inputs, two):
    """ShardedSeparator over dp=2 on the JAX test's translation-sensitive
    toy: the batched path and the fused pass against the JAX class's
    (dp=8), and against each other; the options' batch rounded up to dp
    on a copy, the caller's left as it was."""
    opts = JApplyOptions(segment_samples=4096, batch_size=3, shift_offset=55,
                         max_shift_secs=0.02)
    audio = inputs["audio"]
    ref = JShardedSeparator(_positional, {}, 2, j_make_mesh(), opts)(audio)
    fused = JShardedSeparator(_positional, {}, 2, j_make_mesh(),
                              dataclasses.replace(opts, fused_track=True))(audio)
    assert two["sep_batched"].shape == two["sep_fused"].shape == (2, 2, 30011)
    np.testing.assert_allclose(two["sep_batched"], ref, atol=ATOL)
    np.testing.assert_allclose(two["sep_fused"], fused, atol=ATOL)
    np.testing.assert_allclose(two["sep_fused"], two["sep_batched"], atol=3e-5)
    np.testing.assert_array_equal(two["options_batch"], [3, 4])


@pytest.fixture(scope="module")
def jax_train(inputs):
    """make_sharded_train_step at tp=2 (over 2 devices): the losses and
    the parameters and EMA after two Adam steps, flat."""
    params = _params(inputs, 0)
    place_fn, step_fn, place_batch = make_sharded_train_step(
        j_make_mesh(jax.devices()[:2], tp=2), JCFG, optax.adam(LR), ema_decay=EMA)
    p, s = place_fn(params)
    losses = []
    for _ in range(2):
        p, s, loss = step_fn(p, s, *place_batch(inputs["train_mix"], inputs["train_refs"]))
        losses.append(float(loss))
    flat = lambda tree: {k: np.asarray(v) for k, v in JP.flatten_tree(tree).items()}  # noqa: E731
    return dict(loss=losses, params=flat(p), ema=flat(s[1]))


def _close(ours: dict, want: dict, lr_steps: float, what: str) -> None:
    assert set(ours) == set(want), what
    for name, w in want.items():
        if feeds_group_norm(name) and w.size == 1:
            # a rounding residue's gradient: Adam moves it ~lr a step
            assert np.abs(ours[name] - w).max() <= 2 * lr_steps, (what, name)
        else:
            np.testing.assert_allclose(ours[name], w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{what} {name}")


def _rank_state(two, prefix):
    return {k[len(prefix):]: v for k, v in two.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def one_process_train(inputs):
    """The port's single-process TrainStep: the same two steps."""
    cfg = dataclasses.replace(HTDEMUCS_4S, **NARROW)
    sd = from_jax_params(JP.flatten_tree(_params(inputs, 0)))
    step = TrainStep(build_model(cfg, sd, "cpu", train=True), lr=LR, ema_decay=EMA)
    mix, refs = torch.from_numpy(inputs["train_mix"]), torch.from_numpy(inputs["train_refs"])
    losses = [step(mix, refs).item()]
    grads = {k: p.grad.numpy().copy() for k, p in step.model.named_parameters()}
    losses.append(step(mix, refs).item())
    state = step.checkpoint_state()
    flat = lambda d: {k: v.numpy() for k, v in d.items()}  # noqa: E731
    return dict(loss=losses, grads=grads, params=flat(state["params"]),
                ema=flat(state["ema"]))


@pytest.mark.parametrize("mesh", ["tp", "dp"])
def test_sharded_training_steps_match_one_process(two, one_process_train, mesh):
    """Two Adam steps of ShardedTrainStep (EMA on) at tp=2 and at dp=2
    (each rank one row, the gradients averaged), the state gathered from
    the ranks, against the single-process step; a batch that dp does not
    divide refused."""
    prefix = "train_" if mesh == "tp" else "train_dp_"
    np.testing.assert_allclose(two[prefix + "loss"], one_process_train["loss"], rtol=1e-5)
    _close(_rank_state(two, prefix + "params/"), one_process_train["params"], 2 * LR,
           f"{mesh} params")
    if mesh == "tp":
        _close(_rank_state(two, "train_ema/"), one_process_train["ema"], 2 * LR, "tp ema")
    else:
        assert two["odd_batch_raises"]


def test_dp_gradients_are_the_global_batch_mean(two, one_process_train):
    """The first dp=2 step's gradients, each rank's averaged over dp,
    against the one-process step's on the whole batch: each tensor within
    PARAM_RTOL (2e-4) of its norm, the order of the sums the only
    difference (6e-5 at worst, a GroupNorm weight; a sum
    over dp instead of the mean would be off by its whole norm, which
    Adam's update alone barely shows). A tensor that feeds a GroupNorm has
    a gradient whose mean is a rounding residue: it is compared with its
    mean removed, and the two means within 1e-3 of the largest gradient
    (the residue bound of chip_smoke.py's training comparisons)."""
    ours, want = _rank_state(two, "train_dp_grads/"), one_process_train["grads"]
    assert set(ours) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    gaps = {}
    for name, w in want.items():
        g = ours[name].astype(np.float64)
        w = w.astype(np.float64)
        if feeds_group_norm(name):
            assert abs(g.mean() - w.mean()) <= 1e-3 * top, name
            g, w = g - g.mean(), w - w.mean()
        gaps[name] = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-6 * top)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= PARAM_RTOL, (worst, gaps[worst])


@pytest.mark.parametrize("mesh", ["tp", "dp"])
def test_sharded_training_steps_match_jax(two, jax_train, mesh):
    """The same steps against make_sharded_train_step at tp=2 (one JAX
    compile, shared by both cases)."""
    prefix = "train_" if mesh == "tp" else "train_dp_"
    np.testing.assert_allclose(two[prefix + "loss"], jax_train["loss"], rtol=1e-5)
    _close(_rank_state(two, prefix + "params/"), jax_train["params"], 2 * LR, f"{mesh} params")
    if mesh == "tp":
        _close(_rank_state(two, "train_ema/"), jax_train["ema"], 2 * LR, "tp ema")


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_tp_layer_gradients_equal_the_whole_layers(two, kind):
    """A tp=2 CrossTransformerLayer against the whole layer in one
    process: the output, the input's (and kv's) gradient and every
    parameter's gradient, gathered: the Megatron operators (identity
    forward and all-reduce backward before the column-parallel
    projections, all-reduce forward and identity backward after the
    row-parallel ones) give the single-process gradient, not tp times it."""
    g = _rank_state(two, f"grad_{kind}/")
    assert g["y_err"] <= 1e-6 and g["x_err"] <= 1e-6 * g["x_scale"]
    if kind == "cross":
        assert g["kv_err"] <= 1e-6
    names = {k.rsplit("/", 1)[0] for k in g if k.endswith("/err")}
    assert len(names) == (18 if kind == "cross" else 16)
    for name in names:
        assert g[f"{name}/err"] <= 1e-6 * max(g[f"{name}/scale"], 1.0), name


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("C", [512, 384], ids=["4s", "6s"])
def test_quant_plan_takes_wgmma_at_every_tp_shape(C, tp):
    """--int8 --tp: each rank's products of the transformer, for B = 1-8
    segments of 2688 and 1344 tokens: Q, K, V (N = C/tp), the output
    projection (K = C/tp: 256/128/64 for htdemucs-4s, 192/96/48 for 6s),
    linear1 (N = 4C/tp) and linear2 (K = 4C/tp). K7's wgmma form needs
    K % 16 == 0, which every one of them has."""
    for B in range(1, 9):
        for T in (2688, 1344):
            for K, N in ((C, C // tp), (C // tp, C), (C, 4 * C // tp), (4 * C // tp, C)):
                assert K % 16 == 0, (C, tp, K)
                p = quant_plan(B * T, N, K, x_ptr=256, q_ptr=4096)
                assert p.form == "wgmma", (C, tp, B, T, K, N, p)
