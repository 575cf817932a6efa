"""The port's sharding against the JAX reference, on the CPU.

  * specs: for every arch of the registry, ``param_pspecs``,
    ``opt_pspecs`` and ``input_pspecs`` equal the reference's leaf for
    leaf, each reference spec carried into the port's layout through
    ``interop.param_entries`` (`interop.spec_to_port`);
  * rules: `logical_spec` for every key of ``DEFAULT_RULES`` (and the
    combinations where an axis is used twice) on the shape-only meshes of
    ``tests/launch/test_dryrun_units.py`` ((2, 4) and (2, 16, 16)),
    `zero1_specs` on the reference's own spec trees, `best_mesh`'s shape
    for n = 1…16 — all equal;
  * compression: `compress_tree` / `decompress_tree` and error feedback
    bit-equal on the reference's test cases; `compressed_psum` at world
    size 1 equal to the reference's ``shard_map`` case, and at world size
    2 (gloo) to the reference's per-rank `compress_tree` summed in int32 ×
    mean scale / 2;
  * sharded training (``models.sharding`` + ``train.step.MeshPlan``): a
    reduced qwen3-1.7b step (the reference's weights and batch, the
    reference step `test_torch_train.py` shares) and a reduced qwen3-moe
    step (seeded weights) at meshes 1×1, 1×2, 2×1 and 1×4 (fewer KV heads
    than ranks).  1×1 equals the unsharded port bit for bit (loss,
    gradients, parameters and moments after a step, all computed in the
    same process).  The others, against the unsharded port: the loss
    within 1e-3 relative, every gradient within 0.05·max|g|, parameters
    after a step within 2·lr₁ + 1e-6, first moments within 0.05·max|m|;
    qwen3's loss and gradients also against the reference's, to the same
    bounds; qwen3 at 1×2 under ``REPRO_ATTN_MODE=sp`` (the
    sequence-parallel attention) too; qwen3 at 1×2 with ``remat`` (each
    layer's collectives rerun in the backward) equal to 1×2 without it,
    bit for bit.  Each rank's shards have the shapes
    its spec gives;
  * collectives: at world sizes 2 and 4, gloo's own all-gather and
    reduce-scatter and their ``all_reduce`` emulation both equal the
    ranks' concatenation and sum, on every mesh, along every dimension;
  * the CLI: ``--model-parallel 2`` under two gloo ranks logs losses
    within 1 % of the reference CLI's; its step-3 checkpoint resumed at
    ``--model-parallel 1`` (a process of its own) logs steps 4–5 within
    1 % of the uninterrupted run's; a ``--model-parallel 2`` run whose
    step 4 stalls past ``--step-budget-s`` on both ranks exits 75 with
    step 3 saved and resumes to the uninterrupted run's final checkpoint,
    leaf for leaf; ``--model-parallel 3`` at world size 2 fails the
    mesh's assertion, as the reference's does.

The ranks run once per world size for the session (`shared_result`):
one ``torch.multiprocessing.spawn`` of gloo ranks for each of 1, 2 and 4,
and a second pair at 2 for the straggler cut, each joined through a
``file://`` store of its own and with its own timeout.
"""
import pickle
import shutil
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import get_arch as j_get_arch
from repro.configs.registry import list_archs as j_list_archs
from repro.models import sharding as j_sh
from repro.train import compression as j_comp
from repro.train import elastic as j_elastic
from repro.train import optimizer as j_opt

from repro_torch import interop
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.models import sharding as t_sh
from repro_torch.testing.shared import shared_result
from repro_torch.train import compression as t_comp
from repro_torch.train import elastic as t_elastic
from repro_torch.train import optimizer as t_opt

import _sharding_ranks as R
from test_torch_train import (  # noqa: F401  (fixtures)
    CLI, _lm_model, _losses, _port_opt, _seed_port_checkpoint, lm_ref,
    ref_cli_losses,
)

# ---------------------------------------------------------------------------
# the ranks (`_sharding_ranks`): sharded steps, compression and the CLI at
# world sizes 1, 2 and 4.  First in the file, so that one worker starts
# them while the others take the spec tests.
# ---------------------------------------------------------------------------

def _runs(tmp: Path, lm) -> dict:
    """World sizes 2, 4 and 1 and the straggler cut's pair together
    (world size 1 ends by resuming, with no process group, the checkpoint
    that world size 2's CLI run wrote, at ``--model-parallel 1``).  The
    ranks' inputs (the reference's weights, ``lm``) and the CLI runs'
    first checkpoint are written while the ranks start."""
    assert R.CLI == CLI
    ranks = [R.spawn(2, tmp, "cut")] + [R.spawn(ws, tmp) for ws in (2, 4, 1)]
    try:
        opt = _port_opt(lm["opt"])
        rng = np.random.default_rng(7)
        moe_toks = rng.integers(0, 512, (2, 17)).astype(np.int64)
        inputs = {"qwen3-1.7b": dict(tree=lm["tree"], tokens=lm["tokens"],
                                     targets=lm["targets"], opt=opt),
                  "qwen3-moe-30b-a3b": dict(seed=3, tokens=moe_toks[:, :-1],
                                            targets=moe_toks[:, 1:],
                                            opt=opt)}
        (tmp / "inputs.part").write_bytes(pickle.dumps(inputs))
        (tmp / "inputs.part").rename(tmp / "inputs.pkl")
        _seed_port_checkpoint(tmp / "mp2")
        for d in ("mp1", "cut"):
            shutil.copytree(tmp / "mp2", tmp / d)
        (tmp / "seeded").touch()
    except BaseException:
        for ctx, _ in ranks:
            for p in ctx.processes:
                p.kill()
        raise
    for ctx in ranks:
        R.join(*ctx)
    out = {ws: pickle.loads((tmp / f"ws{ws}.pkl").read_bytes())
           for ws in (1, 2, 4)}
    out[2].update(pickle.loads((tmp / "ws2cut.pkl").read_bytes()))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, lm_ref):
    return shared_result(tmp_path_factory, "torch-sharding-ranks",
                         lambda tmp: _runs(tmp, lm_ref))


def _case(runs, arch, data, model):
    ws = max(data * model, 1)
    return runs[ws]["train"][(arch, data, model)]


@pytest.mark.parametrize("arch", R.ARCHS)
def test_one_by_one_mesh_is_bit_equal(runs, arch):
    base, got = _case(runs, arch, 0, 0), _case(runs, arch, 1, 1)
    assert got["loss"] == base["loss"] and got["step_loss"] == base["step_loss"]
    for key in ("grads", "params", "mu"):
        for n, w in base[key].items():
            assert got[key][n].tobytes() == w.tobytes(), (key, n)
    assert got["step"] == base["step"] == 1


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")


def _spec_tuple(p):
    return tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in p)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _meta_model(arch, shape):
    if arch.family == "lm":
        from repro_torch.models.transformer import Transformer
        return Transformer(arch.cfg, device="meta")
    if arch.family == "recsys":
        from repro_torch.models.dlrm import DLRM
        return DLRM(arch.cfg, device="meta")
    return arch._meta_model(shape, False)


def _param_specs_equal(port_specs, ref_specs, model):
    for entry in interop.param_entries(model):
        name = entry[0]
        node = _get(ref_specs, entry[1])
        if name == "tables":
            want = {_spec_tuple(interop.spec_to_port(node[f"t{t}"]["table"],
                                                     entry))
                    for t in range(len(node))}
            assert want == {_spec_tuple(port_specs[name])}, name
        else:
            assert _spec_tuple(port_specs[name]) == _spec_tuple(
                interop.spec_to_port(node, entry)), name
    assert len(port_specs) == len(interop.param_entries(model))


def _arch_shapes(name):
    arch = get_arch(name)
    if arch.family == "gnn":
        return [(s, s) for s in GNN_SHAPES]
    return [(s, None) for s in arch.shapes()]


@pytest.mark.parametrize("name", list_archs())
def test_param_and_opt_pspecs_equal_reference(name):
    assert sorted(list_archs()) == sorted(j_list_archs())
    arch, jarch = get_arch(name), j_get_arch(name)
    shapes = GNN_SHAPES if arch.family == "gnn" else (None,)
    for shape in shapes:
        kw = {} if shape is None else {"shape": shape}
        model = _meta_model(arch, shape)
        _param_specs_equal(arch.param_pspecs(**kw), jarch.param_pspecs(**kw),
                           model)
        opt, jopt = arch.opt_pspecs(**kw), jarch.opt_pspecs(**kw)
        assert _spec_tuple(opt.step) == _spec_tuple(jopt.step) == ()
        _param_specs_equal(opt.mu, jopt.mu, model)
        _param_specs_equal(opt.nu, jopt.nu, model)
        got = arch.abstract_params(**kw)
        assert {k: v.shape for k, v in got.items()} == {
            n: tuple(p.shape) for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", list_archs())
def test_input_pspecs_equal_reference(name):
    arch, jarch = get_arch(name), j_get_arch(name)
    for shape, _ in _arch_shapes(name):
        got, want = arch.input_pspecs(shape), jarch.input_pspecs(shape)
        if arch.family == "gnn":
            for field, spec in got["batch"].items():
                assert _spec_tuple(spec) == _spec_tuple(
                    getattr(want["batch"], field)), (shape, field)
            assert (getattr(want["batch"], "pos") is None) == (
                "pos" not in got["batch"])
        elif "cache" in want:
            cfg = arch.cfg
            for i, layer in enumerate(got["cache"]):
                node = want["cache"]
                if cfg.local_global:
                    node = node["local" if i % 2 == 0 else "global"]
                for kv in ("k", "v"):
                    assert _spec_tuple(layer[kv]) == _spec_tuple(
                        node[kv])[1:], (shape, i, kv)
            assert len(got["cache"]) == cfg.n_layers
            for k in ("tokens", "positions"):
                assert _spec_tuple(got[k]) == _spec_tuple(want[k]), (shape, k)
        else:
            assert set(got) == set(want), shape
            for k in got:
                assert _spec_tuple(got[k]) == _spec_tuple(want[k]), (shape, k)


def test_default_specs_replicate_everything():
    """The reference's ``Arch`` defaults: every leaf ``P()``."""
    from repro_torch.configs.base import (default_input_pspecs,
                                          default_param_pspecs,
                                          spec_tree_like)

    specs = get_arch("dlrm-rm2").input_specs("train_batch")
    got = default_input_pspecs({"x": specs, "n": [specs["labels"], None]})
    assert set(got["x"]) == set(specs)
    assert all(v == t_sh.P() for v in got["x"].values())
    assert got["n"] == [t_sh.P(), None]
    paths = []
    spec_tree_like({"a": {"b": 1}, "c": (2, 3)},
                   lambda path, leaf: paths.append(path))
    assert paths == [("a", "b"), ("c", "0"), ("c", "1")]
    model = _meta_model(get_arch("schnet"), "molecule")
    assert set(default_param_pspecs(model).values()) == {t_sh.P()}


def test_wkv_mode_switch_equals_reference(monkeypatch):
    arch, jarch = get_arch("qwen3-1.7b"), j_get_arch("qwen3-1.7b")
    model = _meta_model(arch, None)
    monkeypatch.setenv("REPRO_WKV_MODE", "replicated")
    got = arch.param_pspecs()
    _param_specs_equal(got, jarch.param_pspecs(), model)
    assert _spec_tuple(got["layers.0.attn.wk.weight"]) == (None, None)
    assert _spec_tuple(got["layers.0.attn.wq.weight"]) == ("model", None)


# ---------------------------------------------------------------------------
# rules, ZeRO-1, best_mesh
# ---------------------------------------------------------------------------

MESHES = [((2, 4), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


def _stubs(shape, names):
    """The reference's shape-only mesh (`test_dryrun_units`) and the
    port's (a DeviceMesh's ``mesh_dim_names`` and ``shape``)."""
    return (types.SimpleNamespace(axis_names=tuple(names),
                                  devices=np.empty(shape)),
            types.SimpleNamespace(mesh_dim_names=tuple(names),
                                  shape=tuple(shape)))


@pytest.mark.parametrize("shape,names", MESHES)
def test_logical_spec_equals_reference(shape, names):
    assert t_sh.DEFAULT_RULES == j_sh.DEFAULT_RULES
    jm, tm = _stubs(shape, names)
    keys = list(j_sh.DEFAULT_RULES)
    combos = [(k,) for k in keys] + [
        ("batch", "residual", "embed"), ("batch", "seq", "heads", None),
        ("nodes", "roots"), ("roots", "batch", "vocab"),
        ("batch", "kv_seq", "kv_heads", "head_dim"), (None, "mlp")]
    for rules in (None, {"seq": "model", "embed": ("data", "model")}):
        with j_sh.use_rules(jm, rules), t_sh.use_rules(tm, rules):
            assert t_sh.current_mesh() is tm
            for axes in combos:
                want = j_sh.logical_spec(*axes)
                got = t_sh.logical_spec(*axes)
                assert _spec_tuple(got) == _spec_tuple(want), axes
                for part in got:
                    if part is not None:
                        assert t_sh._axis_size(tm, part) == j_sh._axis_size(
                            jm, part)
            got = t_sh.named_sharding("batch", "vocab")
            assert got.mesh is tm and got.spec == t_sh.logical_spec(
                "batch", "vocab")
    assert t_sh.current_mesh() is None
    # outside a mesh: no axis maps and constrain moves nothing
    assert _spec_tuple(t_sh.logical_spec("batch", "heads")) == (None, None)
    x = torch.ones(2, 3)
    assert t_sh.constrain(x, "batch", "embed", src=("batch", "seq")) is x
    assert t_sh.named_sharding("batch") is None


def _ref_zero1_inputs(name):
    jarch = j_get_arch(name)
    specs = jarch.param_pspecs()
    abst = jarch.abstract_params()
    paths = jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    shapes = jax.tree_util.tree_leaves(abst)
    return specs, abst, [(jax.tree_util.keystr(p), s, a.shape)
                         for (p, s), a in zip(paths, shapes)]


@pytest.mark.parametrize("name", ["qwen3-1.7b", "qwen3-moe-30b-a3b",
                                  "dlrm-rm2"])
@pytest.mark.parametrize("shape,names", MESHES)
def test_zero1_specs_equal_reference(name, shape, names):
    """The port's `zero1_specs` on the reference's own trees (specs and
    shapes, keyed by path) equals the reference's, leaf for leaf; and on
    the port's layout it splits only unsharded, divisible dimensions."""
    jm, tm = _stubs(shape, names)
    specs, abst, flat = _ref_zero1_inputs(name)
    data = tuple(a for a in ("pod", "data") if a in names)
    want = jax.tree_util.tree_leaves(
        j_opt.zero1_specs(specs, abst, data_axes=data, mesh=jm),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = t_opt.zero1_specs({k: t_sh.P(*s) for k, s, _ in flat},
                            {k: types.SimpleNamespace(shape=sh)
                             for k, _, sh in flat}, data, mesh=tm)
    assert [_spec_tuple(got[k]) for k, _, _ in flat] == [
        _spec_tuple(w) for w in want]
    # the port's own layout
    arch = get_arch(name)
    ps, ab = arch.param_pspecs(), arch.abstract_params()
    z = t_opt.zero1_specs(ps, ab, data, mesh=tm)
    dsize = int(np.prod([dict(zip(names, shape))[a] for a in data]))
    for n, spec in z.items():
        moved = [i for i, (a, b) in enumerate(zip(
            list(spec), list(ps[n]) + [None] * 4)) if a != b]
        assert len(moved) <= 1, n
        for i in moved:
            assert ab[n].shape[i] % dsize == 0 and ps[n][i:i + 1] in (
                (), (None,)), n
    assert t_opt.zero1_specs(ps, ab, data, mesh=None) is ps


def test_best_mesh_shape_follows_reference(monkeypatch):
    made = {}
    monkeypatch.setattr(j_elastic, "jax", types.SimpleNamespace(
        devices=lambda: list(range(16))))
    monkeypatch.setattr(j_elastic.jax_compat, "make_mesh",
                        lambda shape, names, devices=None:
                        made.setdefault("m", (shape, names)))
    for n in range(1, 17):
        for prefer in (16, 4, 1):
            made.clear()
            j_elastic.best_mesh(n, prefer_model=prefer)
            assert t_elastic.best_mesh_shape(n, prefer_model=prefer) == \
                tuple(made["m"][0]), (n, prefer)
            assert made["m"][1] == ("data", "model")


def test_meshes_need_the_world():
    from repro_torch.launch import mesh as t_mesh

    assert not dist.is_initialized()
    with pytest.raises(AssertionError):
        t_mesh.make_mesh_for_devices(2, 3)
    with pytest.raises(ValueError, match="256 ranks"):
        t_mesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        t_mesh.make_production_mesh(multi_pod=True)
    _, tm = _stubs((2, 16, 16), ("pod", "data", "model"))
    assert t_mesh.mesh_device_count(tm) == 512


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("case", ["normal", "offset", "zeros", "tiny",
                                  "halves"])
def test_compress_tree_bit_equal_to_reference(case):
    rng = np.random.default_rng(0)
    g = {"normal": {"w": rng.normal(size=(256,)),
                    "m": rng.normal(size=(7, 9)) * 1e3},
         "offset": {"w": rng.normal(size=(64,)) * 0.01 + 5.0},
         "zeros": {"w": np.zeros(5)},
         "tiny": {"w": rng.normal(size=(33,)) * 1e-30},
         "halves": {"w": np.arange(-254, 255) / 2.0}}[case]
    g = {k: np.asarray(v, np.float32) for k, v in g.items()}
    jq, js, _ = j_comp.compress_tree({k: jnp.asarray(v) for k, v in g.items()})
    tq, ts, _ = t_comp.compress_tree({k: torch.from_numpy(v.copy())
                                      for k, v in g.items()})
    for k in g:
        assert tq[k].dtype == torch.int8
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        assert ts[k].numpy().tobytes() == np.asarray(js[k]).tobytes()
        back = t_comp.decompress_tree(tq, ts)[k].numpy()
        assert back.tobytes() == np.asarray(
            j_comp.decompress_tree(jq, js)[k]).tobytes()
        assert np.abs(back - g[k]).max() <= np.abs(g[k]).max() / 254 + 1e-7


def test_error_feedback_bit_equal_to_reference():
    rng = np.random.default_rng(1)
    g = {"w": np.asarray(rng.normal(size=(64,)) * 0.01 + 5.0, np.float32)}
    jstate = j_comp.compression_init({"w": jnp.asarray(g["w"])})
    tstate = t_comp.compression_init({"w": torch.from_numpy(g["w"].copy())})
    acc = np.zeros(64, np.float32)
    for _ in range(50):
        jq, js, jstate = j_comp.compress_tree({"w": jnp.asarray(g["w"])},
                                              jstate)
        tq, ts, tstate = t_comp.compress_tree(
            {"w": torch.from_numpy(g["w"].copy())}, tstate)
        np.testing.assert_array_equal(tq["w"].numpy(), np.asarray(jq["w"]))
        assert tstate.residual["w"].numpy().tobytes() == np.asarray(
            jstate.residual["w"]).tobytes()
        acc += t_comp.decompress_tree(tq, ts)["w"].numpy()
    np.testing.assert_allclose(acc / 50, g["w"], rtol=1e-3, atol=1e-3)


def test_compressed_psum_single_rank_equals_reference():
    from repro import jax_compat

    assert not dist.is_initialized()
    g = {"w": np.asarray([1.0, -2.0, 3.0], np.float32)}
    mesh = jax_compat.make_mesh((1,), ("data",))
    want = jax_compat.shard_map(
        lambda g: j_comp.compressed_psum(g, "data")[0], mesh=mesh,
        in_specs=({"w": jax.sharding.PartitionSpec()},),
        out_specs={"w": jax.sharding.PartitionSpec()})(
        {"w": jnp.asarray(g["w"])})
    got, _ = t_comp.compressed_psum({"w": torch.from_numpy(g["w"].copy())})
    assert got["w"].numpy().tobytes() == np.asarray(want["w"]).tobytes()


# ---------------------------------------------------------------------------
# the ranks' results: the other meshes, compression at two ranks, the CLI
# ---------------------------------------------------------------------------

MESH_CASES = [(1, 2), (2, 1), (1, 4)]


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("data,model", MESH_CASES)
def test_sharded_step_within_tolerance(runs, lm_ref, arch, data, model):
    _check_step(_case(runs, arch, data, model), _case(runs, arch, 0, 0),
                lm_ref, arch)


def test_sequence_parallel_step_within_tolerance(runs, lm_ref):
    """``REPRO_ATTN_MODE=sp`` at 1×2: wq/wk/wv/wo gathered, every rank the
    whole sequence's attention — within the bounds of the other meshes."""
    arch = R.ARCHS[0]
    assert runs[2]["sp_modes"] == {False}
    _check_step(runs[2]["train"][(arch, 1, 2, "sp")], _case(runs, arch, 0, 0),
                lm_ref, arch)


def test_remat_step_equals_no_remat(runs):
    """qwen3 at 1×2 with ``remat`` (each layer recomputed in the backward,
    its collectives rerun there on both ranks): the same loss, gradients,
    parameters and moments as without it, bit for bit."""
    arch = R.ARCHS[0]
    base = _case(runs, arch, 1, 2)
    got = runs[2]["train"][(arch, 1, 2, "remat")]
    assert got["loss"] == base["loss"]
    assert got["step_loss"] == base["step_loss"]
    for key in ("grads", "params", "mu"):
        for n, w in base[key].items():
            assert got[key][n].tobytes() == w.tobytes(), (key, n)


@pytest.mark.parametrize("ws", [2, 4])
def test_native_and_emulated_collectives_agree(runs, ws):
    """On every mesh of the world size, gloo's own all-gather and
    reduce-scatter of CPU tensors and their ``all_reduce`` emulation (the
    path of gloo on CUDA tensors) both give the ranks' concatenation and
    sum, along each dimension."""
    got = runs[ws]["collectives"]
    assert sorted(got) == sorted(R.WORLD_MESHES[ws])
    assert all(n > 0 for n in got.values()), got


def _check_step(got, base, lm_ref, arch):
    assert got["loss"] == pytest.approx(base["loss"], rel=1e-3)
    assert got["step_loss"] == pytest.approx(base["step_loss"], rel=1e-3)
    for n, w in base["grads"].items():
        assert np.abs(got["grads"][n] - w).max() <= 0.05 * np.abs(w).max(), n
    lr1 = float(t_opt.schedule(_port_opt(lm_ref["opt"]),
                               torch.tensor(1)))
    for n, w in base["params"].items():
        assert np.abs(got["params"][n] - w).max() <= 2 * lr1 + 1e-6, n
    for n, w in base["mu"].items():
        assert np.abs(got["mu"][n] - w).max() <= 0.05 * np.abs(w).max(), n
    assert got["step"] == 1
    if arch == "qwen3-1.7b":      # and against the reference's step
        assert got["loss"] == pytest.approx(lm_ref["loss"], rel=1e-3)
        model_ = _lm_model(lm_ref)
        for entry in interop.param_entries(model_):
            want = interop._read(lm_ref["grads"], entry)
            err = np.abs(got["grads"][entry[0]] - want).max()
            assert err <= 0.05 * np.abs(want).max(), entry[0]


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("data,model", MESH_CASES + [(1, 1)])
def test_local_shards_follow_the_specs(runs, arch, data, model):
    """Each rank's parameter and moment shapes are the specs' (ZeRO-1
    splits the moments over data where a dimension divides)."""
    a = get_arch(arch)
    names = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  shape=(data, model))
    specs = a.param_pspecs(reduced=True)
    abst = a.abstract_params(reduced=True)
    mom = t_opt.zero1_specs(specs, abst, ("data",), names)
    got = _case(runs, arch, data, model)["shapes"]
    split = 0
    for n, (pshape, mshape) in got.items():
        whole = abst[n].shape
        assert pshape == t_sh.NamedSharding(names, specs[n]).local_shape(
            whole), n
        assert mshape == t_sh.NamedSharding(names, mom[n]).local_shape(
            whole), n
        split += pshape != whole
    assert (split > 0) == (model > 1)
    if arch == "qwen3-1.7b" and model == 4:   # 2 KV heads, 4 ranks
        assert got["layers.0.attn.wk.weight"][0] == (8, 64)


def test_compressed_psum_two_ranks_equals_reference(runs):
    """Each rank's int8 payload summed in int32, times the mean scale,
    over 2 — the reference's arithmetic on its own per-rank quantization."""
    qs, ss = [], []
    for r in range(2):
        q, s, _ = j_comp.compress_tree(
            {k: jnp.asarray(v) for k, v in R.grads_for(r).items()})
        qs.append(q)
        ss.append(s)
    for k, got in runs[2]["psum"].items():
        qsum = (np.asarray(qs[0][k]).astype(np.int32)
                + np.asarray(qs[1][k]).astype(np.int32))
        smean = (np.asarray(ss[0][k]) + np.asarray(ss[1][k])) / np.float32(2)
        want = qsum.astype(np.float32) * smean / np.float32(2)
        assert got.tobytes() == want.astype(np.float32).tobytes(), k
    one = runs[1]["psum"]
    for k, v in R.grads_for(0).items():
        q, s, _ = j_comp.compress_tree({k: jnp.asarray(v)})
        want = np.asarray(j_comp.decompress_tree(q, s)[k])
        assert one[k].tobytes() == want.tobytes(), k


def test_cli_model_parallel_two_matches_reference_cli(runs, ref_cli_losses):
    rc, out = runs[2]["mp2"]
    assert rc == 0, out
    assert "[train] resumed from step -1" in out
    assert "mesh (data, model)=(1, 2)" in out
    got = _losses(out)
    assert sorted(got) == sorted(ref_cli_losses) == list(range(6))
    for s, want in ref_cli_losses.items():
        assert got[s] == pytest.approx(want, rel=0.01), s


def test_checkpoint_written_at_mp2_resumes_at_mp1(runs):
    rc, out = runs[1]["resumed"]
    assert rc == 0, out
    assert "[train] resumed from step 3" in out
    rc1, out1 = runs[1]["mp1"]
    assert rc1 == 0, out1
    whole, resumed = _losses(out1), _losses(out)
    assert sorted(resumed) == [4, 5]
    for s in resumed:
        assert resumed[s] == pytest.approx(whole[s], rel=0.01), s


def test_cli_model_parallel_three_at_world_two_fails(runs):
    assert runs[2]["mp3"] == "AssertionError"


def test_straggler_cut_at_mp2_resumes_bit_exact(runs, tmp_path_factory):
    """Both ranks' step 4 stalls past ``--step-budget-s``: exit 75 with
    step 3 saved by rank 0, then the same command ends on the final
    checkpoint of the uninterrupted ``--model-parallel 2`` run, leaf for
    leaf."""
    rc, out = runs[2]["cut"]
    assert rc == 75, out
    assert "[train] step 4 straggled; checkpoint-restart" in out
    rc, out = runs[2]["cut_resumed"]
    assert rc == 0, out
    assert "[train] resumed from step 3" in out
    assert runs[2]["cut_final"] == runs[2]["mp2_final"]
