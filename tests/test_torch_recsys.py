"""The port's DLRM serving path against the JAX reference, on the CPU.

On CPU tensors the embedding-bag wrapper takes its plain version, so these
tests hold the port's algorithm to the reference's on the same numpy
inputs, with the reference's weights carried over by `repro_torch.interop`:

  * `ops.embedding_bag` against the reference's oracle and its Pallas
    kernel in interpret mode on ``tests/kernels/test_kernels.py``'s cases:
    bit-exact at H = 1, f32 atol = rtol = 1e-6 otherwise;
  * `embedding_bag_apply` (bf16 and f32, weights, both combiners) against
    the reference's: bit-exact at H = 1; at H > 1 the reference sums bf16
    rows in bf16 and the port in f32, so bf16 is held to 2e-2 (the
    reference's bf16 kernel tolerance) and f32 to 1e-6;
  * `dlrm_apply`, the serve step and `retrieval_score` at the reduced
    config: equal (the same bf16 products, lookups exact at n_hot 1), and
    the top-100 ids equal (the port's stable sort breaks ties by id, as
    ``lax.top_k`` does);
  * the data and the arch wrapper (batches, shapes, input specs, FLOPs).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recsys as j_recsys
from repro.data.synthetic import dlrm_batches as j_batches
from repro.kernels.embedding_bag.kernel import embedding_bag_pallas
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_bag_ref
from repro.models import dlrm as j_dlrm
from repro.models.embedding import embedding_bag_apply as j_bag_apply

from repro_torch import interop
from repro_torch.configs import recsys as t_recsys
from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import dlrm_batches as t_batches
from repro_torch.kernels.embedding_bag.kernel import load_bytes
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models import dlrm as t_dlrm
from repro_torch.models.embedding import embedding_bag_apply, embedding_bag_init

REPO = Path(__file__).resolve().parents[1]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("R,D,B,H", [(100, 32, 16, 1), (64, 16, 8, 4),
                                     (32, 128, 16, 2), (16, 8, 64, 8)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_matches_reference_kernel(R, D, B, H, combiner):
    rng = np.random.default_rng(R * D + B)
    table = rng.normal(size=(R, D)).astype(np.float32)
    idx = rng.integers(-1, R, (B, H)).astype(np.int32)
    got = _np(embedding_bag(torch.as_tensor(table), torch.as_tensor(idx),
                            combiner=combiner))
    want_ref = np.asarray(j_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                    combiner=combiner))
    want_kernel = np.asarray(embedding_bag_pallas(
        jnp.asarray(table), jnp.asarray(idx), combiner=combiner,
        bags_per_block=8, interpret=True))
    for want in (want_ref, want_kernel):
        if H == 1:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("H,weighted", [(1, False), (1, True), (3, False),
                                        (3, True)])
def test_embedding_bag_apply_matches_reference(dtype, combiner, H, weighted):
    rng = np.random.default_rng(H + 10 * weighted)
    table = (0.01 * rng.normal(size=(50, 24))).astype(np.float32)
    idx = rng.integers(-1, 50, (32, H)).astype(np.int32)
    w = rng.normal(size=(32, H)).astype(np.float32) if weighted else None
    want = np.asarray(j_bag_apply(
        {"table": jnp.asarray(table)}, jnp.asarray(idx),
        None if w is None else jnp.asarray(w), combiner=combiner,
        dtype=JDT[dtype])).astype(np.float32)
    got = embedding_bag_apply(torch.as_tensor(table), torch.as_tensor(idx),
                              None if w is None else torch.as_tensor(w),
                              combiner=combiner, dtype=TDT[dtype])
    assert got.dtype == TDT[dtype] and got.shape == (32, 24)
    if H == 1:
        np.testing.assert_array_equal(_np(got), want)
    else:
        tol = 2e-2 if dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(_np(got), want, atol=tol * np.abs(want).max(),
                                   rtol=tol)


def test_stacked_tables_equal_one_table_at_a_time():
    # the (T, R, D) stack DLRM launches once equals T single-table bags
    rng = np.random.default_rng(3)
    tables = torch.as_tensor(rng.normal(size=(5, 40, 8)), dtype=torch.bfloat16)
    ids = torch.as_tensor(rng.integers(-1, 40, (16, 5, 2)), dtype=torch.int32)
    w = torch.as_tensor(rng.normal(size=(16, 5, 2)), dtype=torch.float32)
    for combiner in ("sum", "mean"):
        stacked = embedding_bag(tables, ids, w, combiner=combiner)
        for t in range(5):
            one = embedding_bag(tables[t], ids[:, t], w[:, t],
                                combiner=combiner)
            assert torch.equal(stacked[:, t], one)


@pytest.mark.parametrize("dtype,D,offset,want", [
    ("bfloat16", 64, 0, 16), ("float32", 64, 0, 16), ("bfloat16", 8, 0, 16),
    ("bfloat16", 72, 0, 16), ("float32", 9, 0, 4), ("bfloat16", 10, 0, 4),
    ("bfloat16", 64, 1, 2), ("float32", 64, 1, 4), ("float32", 64, 2, 8),
])
def test_bag_kernel_path_follows_shape_and_alignment(dtype, D, offset, want):
    """The bytes a lane of the CUDA kernel loads at a time, picked before
    the launch: 16 where D·size and the pointers allow it, else a pair of
    elements, else one (a table view offset by one element)."""
    store = torch.zeros(offset + 3 * 10 * D, dtype=TDT[dtype])
    tables = store[offset:].view(3, 10, D)
    out = torch.empty((4, 3, D), dtype=TDT[dtype])
    assert load_bytes(tables, out) == want


def test_embedding_bag_init_shape_and_scale():
    t = embedding_bag_init(1000, 16, torch.Generator().manual_seed(0))
    assert t.shape == (1000, 16) and t.dtype == torch.float32
    assert 0.008 < float(t.std()) < 0.012


def test_embedding_bag_rejects_other_devices():
    with pytest.raises(ValueError, match="combiner"):
        embedding_bag(torch.zeros(4, 2), torch.zeros(3, 1, dtype=torch.int32),
                      combiner="max")
    meta = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        embedding_bag(meta, torch.zeros(3, 1, dtype=torch.int32, device="meta"))


def _reduced_model(seed=0):
    cfg = j_recsys.REDUCED
    params = j_dlrm.dlrm_init(jax.random.key(seed), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, interop.dlrm_params_from_numpy(tree, t_recsys.REDUCED)


def _batch(B, seed=0):
    cfg = j_recsys.REDUCED
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    idx = rng.integers(0, cfg.table_rows,
                       (B, cfg.n_sparse, cfg.n_hot)).astype(np.int32)
    return dense, idx


def test_reduced_config_equals_reference():
    assert dataclasses.asdict(t_recsys.REDUCED) == \
        dataclasses.asdict(j_recsys.REDUCED)
    assert dataclasses.asdict(t_recsys.CONFIG) == \
        dataclasses.asdict(j_recsys.CONFIG)


def test_interop_tables_are_the_reference_tables_in_bf16():
    params, model = _reduced_model()
    want = np.asarray(params["tables"]["t7"]["table"].astype(jnp.bfloat16)
                      ).astype(np.float32)
    np.testing.assert_array_equal(_np(model.tables[7]), want)
    assert model.tables.dtype == torch.bfloat16


@pytest.mark.parametrize("B", [8, 64])
def test_dlrm_apply_matches_reference(B):
    params, model = _reduced_model()
    dense, idx = _batch(B, seed=B)
    want = np.asarray(j_dlrm.dlrm_apply(params, j_recsys.REDUCED,
                                        jnp.asarray(dense), jnp.asarray(idx))
                      ).astype(np.float32)
    got = t_dlrm.dlrm_apply(model, torch.as_tensor(dense), torch.as_tensor(idx))
    assert got.shape == (B,) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
def test_serve_step_matches_reference(shape):
    params, model = _reduced_model(seed=1)
    j_arch, t_arch = j_recsys.RecsysArch("x", j_recsys.CONFIG,
                                         j_recsys.REDUCED), get_arch("dlrm-rm2")
    inputs = j_arch.reduced_inputs(shape, None)
    want = np.asarray(j_arch.reduced_step_fn(shape)(
        params, inputs["dense"], inputs["sparse_idx"])).astype(np.float32)
    got = t_arch.step_fn(shape)(model,
                                torch.as_tensor(np.array(inputs["dense"])),
                                torch.as_tensor(np.array(inputs["sparse_idx"])))
    assert got.shape == (t_arch.batch(shape, reduced=True),)
    np.testing.assert_array_equal(_np(got), want)


def test_dlrm_loss_matches_reference():
    params, model = _reduced_model()
    dense, idx = _batch(32, seed=5)
    labels = np.random.default_rng(5).integers(0, 2, 32).astype(np.int32)
    want = float(j_dlrm.dlrm_loss(params, j_recsys.REDUCED, jnp.asarray(dense),
                                  jnp.asarray(idx), jnp.asarray(labels)))
    got = float(t_dlrm.dlrm_loss(model, torch.as_tensor(dense),
                                 torch.as_tensor(idx), torch.as_tensor(labels)))
    assert got == pytest.approx(want, rel=1e-6)


def test_retrieval_score_matches_reference():
    params, model = _reduced_model(seed=2)
    t_arch = get_arch("dlrm-rm2")
    inputs = t_arch.inputs("retrieval_cand", reduced=True, seed=3,
                           device="cpu")
    assert inputs["candidates"].shape == (10240, 16)
    ws, wi = j_dlrm.retrieval_score(
        params, j_recsys.REDUCED, jnp.asarray(inputs["dense"].numpy()),
        jnp.asarray(inputs["sparse_idx"].numpy()),
        jnp.asarray(inputs["candidates"].numpy()), top_k=100)
    gs, gi = t_arch.step_fn("retrieval_cand")(
        model, inputs["dense"], inputs["sparse_idx"], inputs["candidates"])
    assert gs.shape == gi.shape == (1, 100) and gs.dtype == torch.float32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("step", [0, 3])
def test_dlrm_batches_equal_reference(step):
    cfg = j_recsys.REDUCED
    want = next(j_batches(cfg, 16, seed=1, start_step=step))
    got = next(t_batches(t_recsys.REDUCED, 16, seed=1, start_step=step))
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("shape", list(j_recsys.RECSYS_SHAPES))
def test_shapes_specs_and_flops_equal_reference(shape):
    j_arch = j_recsys.RecsysArch("dlrm-rm2", j_recsys.CONFIG, j_recsys.REDUCED)
    t_arch = get_arch("dlrm-rm2")
    assert dataclasses.asdict(t_recsys.RECSYS_SHAPES[shape]) == \
        dataclasses.asdict(j_recsys.RECSYS_SHAPES[shape])
    assert t_arch.model_flops(shape) == j_arch.model_flops(shape)
    for reduced in (False, True):
        want = j_arch.input_specs(shape, reduced=reduced)
        got = t_arch.input_specs(shape, reduced=reduced)
        assert sorted(got) == sorted(want)
        for k, spec in want.items():
            assert got[k].shape == spec.shape
            assert str(got[k].dtype)[6:] == str(spec.dtype)


def test_train_kind_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_arch("dlrm-rm2").step_fn("train_batch")


def test_new_modules_import_with_jax_blocked():
    # jax and the reference package made unimportable, then every module
    # this slice added is imported
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "for m in ['repro_torch.kernels.embedding_bag.ops',\n"
        "          'repro_torch.kernels.gather_aggregate.ops',\n"
        "          'repro_torch.models.embedding', 'repro_torch.models.dlrm',\n"
        "          'repro_torch.models.gnn.common',\n"
        "          'repro_torch.models.gnn.graphsage',\n"
        "          'repro_torch.configs.base', 'repro_torch.configs.recsys',\n"
        "          'repro_torch.configs.dlrm_rm2',\n"
        "          'repro_torch.configs.gnn_arch',\n"
        "          'repro_torch.configs.graphsage_reddit',\n"
        "          'repro_torch.data.sampler', 'repro_torch.interop',\n"
        "          'repro_torch.testing.parity']:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _generator() -> torch.Generator:
    return torch.Generator(device="cuda" if torch.cuda.is_available()
                           else "cpu").manual_seed(0)


# The recsys and GNN entry points, each called without a device.
ENTRY_POINTS = {
    "recsys.init": lambda: get_arch("dlrm-rm2").init(_generator(),
                                                     reduced=True),
    "recsys.inputs": lambda: get_arch("dlrm-rm2").inputs("serve_p99",
                                                         reduced=True),
    "gnn.init": lambda: get_arch("graphsage-reddit").init(
        "minibatch_lg", _generator(), reduced=True),
    "gnn.reduced_inputs": lambda: get_arch("graphsage-reddit").reduced_inputs(
        "minibatch_lg"),
    "gnn.node_data": lambda: get_arch("graphsage-reddit").node_data(
        "minibatch_lg", 50),
}


def _tensors(out) -> list:
    if isinstance(out, torch.nn.Module):
        return list(out.parameters()) + list(out.buffers())
    if isinstance(out, dict):
        return list(out.values())
    if isinstance(out, tuple):
        return list(out)
    return [v for v in vars(out).values() if isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_runs_on_the_card_by_default(name):
    """Without a device an entry point runs on CUDA: without a card it
    raises, and it never hands back CPU tensors."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ENTRY_POINTS[name]()
        return
    tensors = _tensors(ENTRY_POINTS[name]())
    assert tensors and all(t.device.type == "cuda" for t in tensors)
