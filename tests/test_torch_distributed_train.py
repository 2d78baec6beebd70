"""Multi-process training on the CPU: one 4-rank gloo gang
(``runtime.worker_main`` → ``tests/dist_support.py:train_suite``) trains
``tiny`` (fp32) for 5 steps on each of the meshes ``{fsdp: 4}``,
``{data: 2, fsdp: 2}``, ``{data: 2, seq: 2}`` (``ring_flash``) and
``{seq: 4}`` (``ring``), the first and third with the fused norm, SwiGLU
and CE on (their plain versions, on each rank's local blocks), and is held
against JAX's ``Trainer`` on the same mesh of 4 virtual devices (its
kernels off, JAX's rule on a mesh) and against the port's one-process
run with the same fused setting, from the same init and the same global
batches:

- the step-1 loss within 1e-5, every parameter after step 1 within 1e-5
  of its leaf's largest magnitude, the 5-step loss curve within 1e-3;
- each rank's batch is its rows of the global batch, which equals JAX's
  (the concatenation of the data shards of the batch axes);
- the sharded init is the one-process draw, cut along each leaf's spec;
- the sharded global norm equals the unsharded one;
- the checkpoint the 4 ranks wrote restores bit for bit at worlds 1, 2
  and 4, loads through ``file://``, and a ``Trainer`` on another mesh
  resumes it to the same loss;
- only the coordinator writes manifests, metrics and the goodput ledger;
- the gang's ranks also run ``llm_pretrain``, ``vision_train`` (CLIP) and
  ``torch_train`` as a four-process world;
- the ``model``, ``pipeline`` and ``expert`` axes pass the mesh check and
  a leaf keeps its dim over them beside its fsdp gather dim (their
  training is tests/test_torch_tp.py's, tests/test_torch_pipeline.py's
  and tests/test_torch_moe_mesh.py's).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dist_support import (  # noqa: E402
    CKPT_CASE, ENTRY_CONFIGS, STEPS, TRAIN_CASES, check_gang, entry_dirs,
    finish, spawn_gang, train_config, whole_tree,
)
from kubeflow_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from kubeflow_tpu.train import data as jdata  # noqa: E402
from kubeflow_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu.train.trainer import (  # noqa: E402
    TrainerConfig as JTrainerConfig,
)
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.models.decoder import (  # noqa: E402
    decoder_param_specs,
)
from kubeflow_tpu_torch.parallel.sharding import (  # noqa: E402
    cut_local, shard_params,
)
from kubeflow_tpu_torch.runtime.mesh import MESH_AXES  # noqa: E402
from kubeflow_tpu_torch.serve.storage import load_params  # noqa: E402
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from kubeflow_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager, ShardLayout,
)
from kubeflow_tpu_torch.train.optim import OptimizerConfig  # noqa: E402
from kubeflow_tpu_torch.train.step import setup_train  # noqa: E402
from kubeflow_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig,
)
from port_threads import torch_on_one_thread  # noqa: E402,F401

CASES = list(TRAIN_CASES)


def _dp(axes: dict) -> int:
    return axes.get("dcn", 1) * axes.get("data", 1) * axes.get("fsdp", 1)


class _Global:
    """The global batch of a step: the batch shards ``0..dp-1`` of a data
    module (the JAX package's or the port's), concatenated."""

    def __init__(self, make, cfg, dp: int):
        self.srcs = [make(cfg, shard=i, num_shards=dp) for i in range(dp)]

    def batch_at(self, step: int) -> np.ndarray:
        return np.concatenate([s.batch_at(step) for s in self.srcs])


def _data_cfg(module):
    return module.DataConfig(vocab_size=256, seq_len=32, global_batch=4)


def _jax_run(axes: dict, init: dict) -> dict:
    """JAX's Trainer on a 4-device mesh from the port's init."""
    conf = train_config("ring" if axes.get("seq", 1) > 1 else "xla")
    jt = JTrainer(JTrainerConfig.from_dict(conf),
                  jax_mesh(axes, jax.devices()[:4]))
    jt.data = _Global(jdata.make_data_source, jt.data_cfg, _dp(axes))
    params = jax.tree.map(jnp.asarray, init)
    jt.task.state = jax.device_put(
        {"params": params, "opt_state": jt.task.optimizer.init(params),
         "step": jnp.int32(0)}, jt.task.state_shardings)
    rec = {"losses": [], "grad_norms": []}

    def on_step(step, m):
        rec["losses"].append(m["loss"])
        rec["grad_norms"].append(m["grad_norm"])
        if step == 1:
            rec["params1"] = jax.tree.map(np.asarray,
                                          jt.task.state["params"])

    jt.run(on_step=on_step)
    rec["batches"] = [jt.data.batch_at(s) for s in range(STEPS)]
    return rec


def _port_run(axes: dict, attn: str, fused: str, tmp) -> dict:
    """The port's one-process Trainer on the same global batches."""
    conf = train_config(attn, fused=fused)
    tmp.mkdir()
    tr = Trainer(TrainerConfig.from_dict(conf), device="cpu",
                 workdir=str(tmp))
    tr.data = _Global(tdata.make_data_source, tr.data_cfg, _dp(axes))
    rec = {"losses": []}

    def on_step(step, m):
        rec["losses"].append(m["loss"])
        if step == 1:
            rec["params1"] = T.map_tree(lambda t: t.detach().clone(),
                                        tr.task.state["params"])

    tr.run(on_step=on_step)
    return rec


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    out = tmp_path_factory.mktemp("gang")
    procs = spawn_gang("dist_support:train_suite", {"out": str(out)}, 4,
                       [out / f"w{r}" for r in range(4)],
                       parallelism={"fsdp": 4})
    try:
        task = setup_train(preset("tiny", dtype="float32"),
                           OptimizerConfig(), device="cpu")
        init = T.map_tree(lambda t: t.detach().clone(), task.params)
        init_np = T.map_tree(lambda t: t.numpy(), init)
        refs = {}
        for name, (axes, attn, fused) in TRAIN_CASES.items():
            refs[name] = {"jax": _jax_run(axes, init_np),
                          "port": _port_run(axes, attn, fused,
                                            out / f"one-{name}")}
    finally:
        res = finish(procs)
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} exit {rc}:\n{err[-4000:]}"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return {"out": out, "init": init, "refs": refs, "ranks": ranks}


def _sizes(name: str) -> dict:
    return {a: TRAIN_CASES[name][0].get(a, 1) for a in MESH_AXES}


def _whole(gang, name: str, get) -> dict:
    """Flattened whole tree assembled from the ranks' local shards of
    ``get(record)``."""
    return whole_tree([r[name] for r in gang["ranks"]], get)


def _close_leaves(got: dict, want: dict, tol: float = 1e-5) -> None:
    for p, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[p], np.float64) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (p, err)


@pytest.mark.parametrize("name", CASES)
def test_step_one_matches_jax(gang, name):
    j = gang["refs"][name]["jax"]
    for rec in (r[name] for r in gang["ranks"]):
        assert abs(rec["losses"][0] - j["losses"][0]) <= 1e-5
        assert abs(rec["grad_norms"][0] - j["grad_norms"][0]) \
            <= 1e-4 * j["grad_norms"][0]
    got = _whole(gang, name, lambda r: r["state1"]["params"])
    _close_leaves(got, T.flatten(j["params1"]))


@pytest.mark.parametrize("name", CASES)
def test_step_one_matches_the_one_process_run(gang, name):
    p = gang["refs"][name]["port"]
    assert abs(gang["ranks"][0][name]["losses"][0] - p["losses"][0]) <= 1e-5
    got = _whole(gang, name, lambda r: r["state1"]["params"])
    _close_leaves(got, {k: v.numpy()
                        for k, v in T.flatten(p["params1"]).items()})


@pytest.mark.parametrize("name", CASES)
def test_five_step_curve_tracks_jax_and_the_one_process_run(gang, name):
    got = np.array(gang["ranks"][0][name]["losses"])
    for ref in ("jax", "port"):
        want = np.array(gang["refs"][name][ref]["losses"])
        assert len(got) == len(want) == STEPS
        assert np.abs(got - want).max() <= 1e-3, (ref, got, want)
    assert got[-1] < got[0]


@pytest.mark.parametrize("name", CASES)
def test_each_rank_reads_its_rows_of_jaxs_global_batch(gang, name):
    axes = TRAIN_CASES[name][0]
    dp = _dp(axes)
    want = gang["refs"][name]["jax"]["batches"]
    rows = want[0].shape[0] // dp
    for rec in (r[name] for r in gang["ranks"]):
        c = rec["coords"]
        b = (c["dcn"] * axes.get("data", 1) + c["data"]) \
            * axes.get("fsdp", 1) + c["fsdp"]
        for s in range(STEPS):
            np.testing.assert_array_equal(
                rec["batches"][s], want[s][b * rows:(b + 1) * rows])


@pytest.mark.parametrize("name", CASES)
def test_sharded_init_is_the_one_process_draw(gang, name):
    got = _whole(gang, name, lambda r: r["init"])
    for p, w in T.flatten(gang["init"]).items():
        assert torch.equal(got[p], w), p
    # embed over fsdp: wq [L, D, H, Dh] is split on its D dim, not dim 0.
    wq = gang["ranks"][0][name]["init"]["layers"]["attn"]["wq"]
    full = gang["init"]["layers"]["attn"]["wq"]
    fsdp = TRAIN_CASES[name][0].get("fsdp", 1)
    assert wq.shape == (full.shape[0], full.shape[1] // fsdp,
                        *full.shape[2:])


@pytest.mark.parametrize("name", CASES)
def test_sharded_global_norm_is_the_whole_norm(gang, name):
    for rec in (r[name] for r in gang["ranks"]):
        assert abs(rec["norm_sharded"] - rec["norm_whole"]) \
            <= 1e-6 * rec["norm_whole"]


def _state_specs(specs: dict) -> dict:
    out = {}
    for p, s in specs.items():
        for pre in ("params/", "opt_state/mu/", "opt_state/nu/"):
            out[pre + p] = s
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_checkpoint_of_four_ranks_restores_bit_for_bit(gang, world):
    name = CKPT_CASE
    mgr = CheckpointManager(str(gang["out"] / "ckpt"))
    assert mgr.steps_on_disk() == [2, 4, 5]
    whole = {}
    for sub in ("params", "opt_state/mu", "opt_state/nu"):
        def get(r, sub=sub):
            node = r["state2"]
            for k in sub.split("/"):
                node = node[k]
            return node
        whole.update({f"{sub}/{p}": t
                      for p, t in _whole(gang, name, get).items()})
    if world == 4:
        layouts = [ShardLayout(_sizes(name), r[name]["coords"],
                               _state_specs(r[name]["specs"]))
                   for r in gang["ranks"]]
    else:
        sizes = {a: 1 for a in MESH_AXES}
        sizes["fsdp"] = world
        params = T.unflatten({p[len("params/"):]: t for p, t in whole.items()
                              if p.startswith("params/")})
        specs = T.flatten(shard_params(params, decoder_param_specs(
            preset("tiny")), sizes))
        layouts = [ShardLayout(sizes, {**{a: 0 for a in MESH_AXES},
                                       "fsdp": r}, _state_specs(specs))
                   for r in range(world)]
    for lay in layouts:
        got = mgr.restore(2, layout=lay if world > 1 else None)
        assert got["step"] == 2 and got["opt_state"]["count"] == 2
        flat = T.flatten(got)
        for p, w in whole.items():
            want = cut_local(w, lay.specs.get(p, ()), lay.sizes, lay.coords)
            assert torch.equal(flat[p], want), (world, p)


def test_checkpoint_of_four_ranks_loads_through_file_uri(gang):
    got = load_params(f"file://{gang['out'] / 'ckpt'}",
                      preset("tiny", dtype="float32"), device="cpu")
    want = _whole(gang, CKPT_CASE, lambda r: r[f"state{STEPS}"]["params"])
    flat = T.flatten(got)
    assert list(flat) == list(want)
    for p, w in want.items():
        assert torch.equal(flat[p], w), p


def test_resume_on_another_mesh_repeats_the_last_step(gang):
    """Step 4 of the ``{data: 2, fsdp: 2}`` run (its blocks split in two
    over fsdp), resumed on ``{fsdp: 4}`` (the same four batch shards,
    blocks split in four): step 5 runs again to the same loss."""
    want = gang["ranks"][0][CKPT_CASE]["losses"][STEPS - 1]
    for r in gang["ranks"]:
        assert list(r["resumed"]) == [STEPS]
        assert abs(r["resumed"][STEPS] - want) <= 1e-5


def test_only_the_coordinator_writes_manifests_metrics_and_ledger(gang):
    out = gang["out"]
    writers = (out / "manifest_writers.txt").read_text().split()
    assert writers and set(writers) == {"0"}
    for name in CASES:
        for r in range(4):
            wd = out / name / f"rank{r}"
            assert (wd / "metrics.jsonl").exists() == (r == 0), (name, r)
            assert bool(list(wd.glob("goodput*"))) == (r == 0), (name, r)


@pytest.mark.parametrize("name", list(ENTRY_CONFIGS))
def test_four_process_gang_trains(gang, name):
    """The gang's ranks also ran ``llm_pretrain`` and ``vision_train``
    (CLIP, one row a rank: the contrastive logits over the gathered
    batch) on their ``{fsdp: 4}`` mesh, and ``torch_train`` over its own
    gloo group."""
    check_gang(name, 4, ENTRY_CONFIGS[name], entry_dirs(gang["out"], name,
                                                        4))


@pytest.mark.parametrize("axis", ["model", "pipeline", "expert"])
def test_unported_axis_raises_with_the_roadmap_pointer(axis):
    """No axis is left unported: ``model`` trains (tests/test_torch_tp.py),
    ``pipeline`` (tests/test_torch_pipeline.py) and ``expert``
    (tests/test_torch_moe_mesh.py). The check lets each through and a
    leaf keeps both its dims, ``wq [L, D, H, Dh]`` gathering D over fsdp
    and keeping H split over model (or, under the pipeline rule
    ``layers → pipeline``, L split over stages), an MoE ``gate [L, E, D,
    M]`` gathering D over fsdp and keeping E split over expert; an axis
    the mesh does not know raises."""
    from kubeflow_tpu_torch.models.decoder import abstract_decoder_params
    from kubeflow_tpu_torch.parallel.fsdp import check_mesh
    from kubeflow_tpu_torch.parallel.sharding import (
        DEFAULT_RULES, placement, with_rule,
    )

    mesh = {axis: 2, "fsdp": 2}
    check_mesh(mesh)
    cfg = preset("tiny-moe" if axis == "expert" else "tiny",
                 dtype="float32")
    rules = (with_rule(DEFAULT_RULES, "layers", "pipeline")
             if axis == "pipeline" else DEFAULT_RULES)
    specs = T.flatten(shard_params(abstract_decoder_params(cfg),
                                   decoder_param_specs(cfg), mesh, rules))
    if axis == "model":
        wq = placement(specs["layers/attn/wq"], mesh)
        assert (wq.gather, wq.tp, wq.partial) == (1, 2, False)
    elif axis == "pipeline":
        wq = placement(specs["layers/attn/wq"], mesh)
        assert (wq.gather, wq.tp, wq.stage) == (1, None, 0)
        assert placement(specs["embed"], mesh).stage is None
    else:
        gate = placement(specs["layers/mlp/gate"], mesh)
        assert (gate.gather, gate.ep, gate.tp) == (2, 1, None)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        check_mesh({axis: 2, "stage": 2})


def test_mesh_without_the_unported_axes_passes_the_check():
    from kubeflow_tpu_torch.parallel.fsdp import check_mesh

    check_mesh({"dcn": 2, "data": 2, "fsdp": 2, "seq": 2})
