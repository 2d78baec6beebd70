"""The port's mesh and sharding layer against the JAX package's:
``ParallelismSpec``, ``build_mesh``'s product check, ``detect_local_cluster``,
``logical_to_mesh_axes`` and ``_drop_nondivisible`` for every rule on many
meshes (``model`` included), the spec trees of the decoder, ViT and CLIP
params, ``shard_params`` for every leaf of ``tiny``, ``tiny-moe``,
``tiny-vit`` and ``tiny-clip`` against JAX's ``shard_params(...).spec``,
and the local-shard cut and reassembly, bit for bit."""

import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.core.jobs import ParallelismSpec as JSpec
from kubeflow_tpu.models import config as jconfig
from kubeflow_tpu.models import decoder as jdec
from kubeflow_tpu.models import vision as jvis
from kubeflow_tpu.parallel import sharding as JS
from kubeflow_tpu.runtime import mesh as jmesh
from kubeflow_tpu.runtime import topology as jtopo
from kubeflow_tpu_torch.core.jobs import ParallelismSpec
from kubeflow_tpu_torch.models import config as tconfig
from kubeflow_tpu_torch.models import decoder as tdec
from kubeflow_tpu_torch.models import vision as tvis
from kubeflow_tpu_torch.parallel import sharding as S
from kubeflow_tpu_torch.runtime import mesh as tmesh
from kubeflow_tpu_torch.runtime import topology as ttopo
from kubeflow_tpu_torch.train import tree as T
from port_threads import torch_on_one_thread  # noqa: F401

MESHES = [
    {"fsdp": 8}, {"data": 8}, {"data": 2, "fsdp": 4}, {"fsdp": 2, "model": 4},
    {"data": 2, "seq": 2, "model": 2}, {"expert": 4, "fsdp": 2},
    {"dcn": 2, "fsdp": 2, "seq": 2}, {"pipeline": 2, "fsdp": 4},
    {"model": 8}, {"seq": 8}, {"fsdp": 4, "expert": 2},
]
LOGICAL = [name for name, _ in S.DEFAULT_RULES] + [None]


def _jmesh(axes: dict):
    return jmesh.build_mesh(axes, jax.devices()[:8])


def _sizes(axes: dict) -> dict:
    return {a: axes.get(a, 1) for a in tmesh.MESH_AXES}


def _jspec(ps, ndim: int) -> tuple:
    t = tuple(ps)
    return t + (None,) * (ndim - len(t))


def test_parallelism_spec_matches_jax():
    for axes in MESHES + [{}]:
        mine, theirs = ParallelismSpec(**axes), JSpec(**axes)
        assert mine.axis_sizes() == theirs.axis_sizes()
        assert mine.total == theirs.total
    assert ParallelismSpec.from_dict({"fsdp": "4"}).fsdp == 4
    with pytest.raises(ValueError, match="unknown parallelism axes"):
        ParallelismSpec.from_dict({"fsdp": 2, "tensor": 2})
    with pytest.raises(ValueError):
        ParallelismSpec(data=1.5)


def test_mesh_axes_and_helpers_match_jax():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.batch_sharding_axes() == jmesh.batch_sharding_axes()
    assert tmesh.infer_parallelism(4).axis_sizes() == \
        jmesh.infer_parallelism(4).axis_sizes()


def test_build_mesh_product_must_equal_the_world():
    # No process group: a world of one process.
    with pytest.raises(ValueError, match="product 4 != device count 1"):
        tmesh.build_mesh({"fsdp": 4})
    with pytest.raises(ValueError, match="unknown mesh axes"):
        tmesh.build_mesh({"tensor": 1})


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12])
def test_detect_local_cluster_matches_jax(n):
    for gen in ("v5e", "sim", "cpu"):
        mine = ttopo.detect_local_cluster(num_chips=n, generation=gen)
        theirs = jtopo.detect_local_cluster(num_chips=n, generation=gen)
        assert mine.slices[0].dims == theirs.slices[0].dims
        assert mine.total_chips == theirs.total_chips == n
        assert mine.slices[0].num_hosts == theirs.slices[0].num_hosts
    local = ttopo.detect_local_cluster()
    if not torch.cuda.is_available():
        assert local.total_chips == 1
        assert local.slices[0].generation == "cpu"
    assert ttopo.SliceTopology.parse("s", "4x4x4", "v5p").num_chips == 64
    for name, g in jtopo.GENERATIONS.items():
        assert ttopo.GENERATIONS[name].__dict__ == dict(g)


def test_logical_to_mesh_axes_matches_jax_for_every_rule():
    rules = [S.DEFAULT_RULES, S.with_rule(S.DEFAULT_RULES, "layers",
                                          "pipeline"),
             S.with_rule(S.DEFAULT_RULES, "embed", ("fsdp", "seq"))]
    jrules = [JS.DEFAULT_RULES, JS.with_rule(JS.DEFAULT_RULES, "layers",
                                             "pipeline"),
              JS.with_rule(JS.DEFAULT_RULES, "embed", ("fsdp", "seq"))]
    assert S.DEFAULT_RULES == JS.DEFAULT_RULES
    for mine, theirs in zip(rules, jrules):
        for names in itertools.product(LOGICAL, repeat=2):
            assert S.logical_to_mesh_axes(names, mine) == tuple(
                JS.logical_to_mesh_axes(names, theirs)), names
        for names in (("batch", "batch", "act_seq"),
                      ("batch", "embed", "mlp", "vocab"),
                      ("expert", "embed", "expert_mlp")):
            assert S.logical_to_mesh_axes(names, mine) == tuple(
                JS.logical_to_mesh_axes(names, theirs)), names
    with pytest.raises(KeyError):
        S.logical_to_mesh_axes(("nope",))


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "-".join(
    f"{k}{v}" for k, v in a.items()))
def test_drop_nondivisible_matches_jax(axes):
    jm = _jmesh(axes)
    shapes = [(8, 4, 6), (12, 2, 16), (3, 8, 5), (16, 16, 1)]
    for names in itertools.product(LOGICAL, repeat=3):
        spec = S.logical_to_mesh_axes(names)
        for shape in shapes:
            want = JS._drop_nondivisible(
                JS.logical_to_mesh_axes(names), shape, jm)
            assert S._drop_nondivisible(spec, shape, _sizes(axes)) == \
                _jspec(want, len(shape)), (names, shape)


def _jax_tree_specs(params_shape, specs, axes):
    sh = JS.shard_params(params_shape, specs, _jmesh(axes))
    return {p: _jspec(s.spec, len(params_shape_leaf.shape))
            for (p, s), params_shape_leaf in zip(
                _flat(sh).items(), _flat(params_shape).values())}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


MODEL_NAMES = ("tiny", "tiny-moe", "tiny-gemma", "tiny-vit", "tiny-clip")


@functools.lru_cache(maxsize=None)
def _model(name: str):
    """(port params, port logical specs, JAX shape tree, JAX specs) of a
    decoder, ViT or CLIP preset, built on first use."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    if name == "tiny-vit":
        tv, jv = tvis.vit_preset(name), jvis.vit_preset(name)
        return (tvis.init_vit_params(gen, tv), tvis.vit_param_specs(tv),
                jax.eval_shape(lambda: jvis.init_vit_params(key, jv)),
                jvis.vit_param_specs(jv))
    if name == "tiny-clip":
        tc, jc = tvis.clip_preset(name), jvis.clip_preset(name)
        return (tvis.init_clip_params(gen, tc), tvis.clip_param_specs(tc),
                jax.eval_shape(lambda: jvis.init_clip_params(key, jc)),
                jvis.clip_param_specs(jc))
    tc, jc = tconfig.preset(name), jconfig.preset(name)
    return (tdec.init_decoder_params(gen, tc), tdec.decoder_param_specs(tc),
            jax.eval_shape(lambda: jdec.init_decoder_params(key, jc)),
            jdec.decoder_param_specs(jc))


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_logical_spec_trees_match_jax(name):
    params, specs, jshape, jspecs = _model(name)
    assert T.flatten(specs) == _flat(jspecs)
    assert {p: tuple(t.shape) for p, t in T.flatten(params).items()} == \
        {p: tuple(s.shape) for p, s in _flat(jshape).items()}


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "-".join(
    f"{k}{v}" for k, v in a.items()))
def test_shard_params_matches_jax_for_every_leaf(axes):
    for name in MODEL_NAMES:
        params, specs, jshape, jspecs = _model(name)
        mine = T.flatten(S.shard_params(params, specs, _sizes(axes)))
        theirs = _jax_tree_specs(jshape, jspecs, axes)
        assert mine == theirs, name


def test_cut_and_assemble_round_trip_bit_for_bit():
    sizes = _sizes({"dcn": 2, "data": 2, "fsdp": 2, "model": 2})
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 6, 4)).astype(np.float32))
    for spec in [(None, None, None), ("fsdp", None, None),
                 (None, "model", "fsdp"), (("dcn", "data"), None, "model"),
                 (("dcn", "data", "fsdp"), None, None)]:
        shards = {}
        for c in S.all_coords(sizes, tmesh.MESH_AXES):
            part = S.cut_local(x, spec, sizes, c)
            key = tuple(c[a] for a in tmesh.MESH_AXES)
            shards[key] = part
        back = S.assemble(x.shape, spec, sizes, lambda c: shards[tuple(
            c.get(a, 0) for a in tmesh.MESH_AXES)])
        assert torch.equal(back, x), spec
    with pytest.raises(ValueError):
        S.local_slices((6,), ("fsdp",), {"fsdp": 4}, {"fsdp": 0})


def test_with_logical_constraint_is_a_no_op_on_a_local_tensor():
    x = torch.ones(2, 3)
    assert S.with_logical_constraint(x, ("batch", "act_embed")) is x
    assert S.with_logical_constraint(x, ("batch", None),
                                     mesh={"fsdp": 2}) is x
    with pytest.raises(KeyError):
        S.with_logical_constraint(x, ("nope",))


def test_sharded_dim_allows_one_split_dim():
    """A leaf's placement names one gather dim (over fsdp) and one TP dim
    (over model, kept local); a dim that did not divide over model or
    expert is whole and read in parts; a dim over model and another axis
    at once, or two gather dims, raise."""
    sizes = _sizes({"fsdp": 2, "model": 2})
    assert S.placement((None, "fsdp", None), sizes) == S.Placement(1, None)
    assert S.placement((None, "seq", None), sizes) == S.Placement()
    assert S.placement(("model", "fsdp"), sizes) == S.Placement(1, 0)
    # wk's kv heads did not divide: whole on every model rank, read in parts.
    assert S.placement((None, "fsdp", None, None), sizes,
                       (None, "fsdp", "model", None)).partial
    # Nor did 4 experts over expert = 3: whole on every expert rank, each
    # computing its part, the gradient summed over expert (JAX's layout;
    # tests/test_torch_nondivisible.py holds the sums to JAX).
    three = _sizes({"expert": 3})
    assert S.placement((None, None, None), three,
                       (None, "expert", None)) == S.Placement(ep_partial=True)
    with pytest.raises(NotImplementedError, match="Queue 1"):
        S.placement((("fsdp", "model"), None), sizes)
    with pytest.raises(NotImplementedError, match="Queue 1"):
        S.placement(("fsdp", "data"), _sizes({"fsdp": 2, "data": 2}))


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_abstract_params_are_the_init_without_a_draw(name):
    """A sharded train state lays itself out from these: every leaf's
    shape and dtype, on the ``meta`` device."""
    cfg = tconfig.preset(name)
    meta = T.flatten(tdec.abstract_decoder_params(cfg))
    full = T.flatten(tdec.init_decoder_params(torch.Generator().manual_seed(0),
                                              cfg))
    assert {p: (tuple(t.shape), t.dtype) for p, t in meta.items()} == \
        {p: (tuple(t.shape), t.dtype) for p, t in full.items()}
    assert {t.device.type for t in meta.values()} == {"meta"}


def test_init_cut_as_drawn_is_the_cut_of_the_whole_draw():
    """``init_decoder_params(shard=...)`` keeps each rank's block of every
    leaf (one layer of a stacked leaf at a time) bit for bit."""
    cfg = tconfig.preset("tiny", dtype="float32")
    sizes = _sizes({"data": 2, "fsdp": 2})
    specs = T.flatten(S.shard_params(tdec.abstract_decoder_params(cfg),
                                     tdec.decoder_param_specs(cfg), sizes))
    full = T.flatten(tdec.init_decoder_params(
        torch.Generator().manual_seed(3), cfg))
    for coords in S.all_coords(sizes, ("data", "fsdp")):
        def cut(path, t, coords=coords):
            spec = specs[path]
            if t.dim() == len(spec) - 1:
                spec = spec[1:]
            return S.cut_local(t, spec, sizes, coords)

        got = T.flatten(tdec.init_decoder_params(
            torch.Generator().manual_seed(3), cfg, shard=cut))
        for p, w in full.items():
            assert torch.equal(got[p], S.cut_local(w, specs[p], sizes,
                                                   coords)), (coords, p)
    assert got["layers/attn/wq"].shape[1] == full["layers/attn/wq"].shape[1] // 2
