"""Dims that do not divide over their mesh axis, replicated as JAX
replicates them, held against the JAX package on the CPU: a 3-rank and a
2-rank gloo gang of ``runtime.worker_main`` run ``tests/dist_support.py``'s
``nondiv_suite`` over ``NONDIV_CASES``: tiny on ``{model: 3}`` (its 4
heads, 2 kv heads, 128 mlp columns and vocabulary of 256 all whole on
every rank, each rank computing its part), 6 heads and 3 kv heads on
``{model: 2}`` (the q heads split, each rank holding every kv head its q
heads read), and tiny-moe's 4 experts on ``{expert: 3}``:

- ``decoder_loss``'s metrics and every gradient (the ranks' synced blocks,
  assembled) against JAX's ``decoder_loss(mesh=)`` on the same mesh of
  virtual devices: 1e-5 of the reference's magnitude, the MoE case on the
  dispatch and the dense paths;
- every leaf's spec JAX's ``shard_params`` on the same mesh;
- the TP engine's greedy tokens, contiguous cache and page pool, equal to
  JAX's ``LLMEngine(mesh=)`` on the same weights and to the port's
  one-process engine;
- the refusals left are JAX's own: ``pipeline`` × ``model`` where the
  heads do not divide, ``pipeline`` × ``expert`` where the experts do
  not, each with JAX's text.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from dist_support import (  # noqa: E402
    NONDIV_CASES, NONDIV_ENGINES, TP_ENGINE_CASES, TP_PROMPTS, finish,
    nondiv_cfg, spawn_gang, tp_tokens, whole_tree,
)
from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.parallel import sharding as jsharding  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.models.decoder import check_stages  # noqa: E402
from kubeflow_tpu_torch.serve.engine import (  # noqa: E402
    LLMEngine, SamplingParams,
)
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

TOL = 1e-5
CASES = [(w, n) for w, cases in NONDIV_CASES.items() for n in cases]
IDS = [n for _, n in CASES]
LOSS_CASES = [(w, n, impl) for w, n in CASES
              for impl in (("dispatch", "dense") if n.startswith("moe")
                           else ("dispatch",))]
ENGINE_CASES = [(w, n, e) for w, n in CASES if not n.startswith("moe")
                for e in NONDIV_ENGINES]


def _jcfg(world: int, name: str, **kw):
    p, over, _ = NONDIV_CASES[world][name]
    return jconfig.preset(p, dtype="float32", **over, **kw)


def _jax_loss_grads(world: int, name: str, impl: str, jparams) -> dict:
    axes = NONDIV_CASES[world][name][2]
    mesh = jax_mesh(axes, jax.devices()[:world])
    cfg = _jcfg(world, name, moe_impl=impl)
    shardings = jsharding.shard_params(jparams, jdec.decoder_param_specs(
        cfg), mesh)
    toks = jax.device_put(jnp.asarray(tp_tokens()), NamedSharding(
        mesh, jsharding.logical_to_mesh_axes(("batch", None))))
    (_, m), grads = jax.jit(jax.value_and_grad(
        lambda p, t: jdec.decoder_loss(p, t, cfg, mesh=mesh),
        has_aux=True))(jax.device_put(jparams, shardings), toks)
    return {"metrics": {k: float(m[k]) for k in ("ce_loss", "accuracy",
                                                  "aux_loss") if k in m},
            "grads": T.flatten(jax.tree.map(np.asarray, grads)),
            "specs": T.flatten(jax.tree.map(
                lambda s: tuple(s.spec), shardings,
                is_leaf=lambda x: isinstance(x, NamedSharding)))}


def _jax_tokens(world: int, name: str, layout: str, jparams) -> list:
    spec = dict(TP_ENGINE_CASES[layout])
    spec.pop("prefill_buckets", None)
    eng = jengine.LLMEngine(
        _jcfg(world, name), JBatchingSpec(prefill_buckets=[16, 32], **spec),
        params=jparams, mesh=jax_mesh(NONDIV_CASES[world][name][2],
                                      jax.devices()[:world]))
    return [eng.generate(p, jengine.SamplingParams(max_new_tokens=10))
            for p in TP_PROMPTS]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Both gangs' records; JAX's loss, gradient and engine references
    and the one-process engines' tokens, computed while they run."""
    base = tmp_path_factory.mktemp("nondiv")
    jparams, whole = {}, {}
    for w, n in CASES:
        jparams[n] = jdec.init_decoder_params(jax.random.PRNGKey(7),
                                              _jcfg(w, n))
        whole[n] = params_from_jax(jax.tree.map(np.asarray, jparams[n]),
                                   "cpu")
    torch.save(whole, base / "params.pt")
    procs = {}
    for w in NONDIV_CASES:
        (base / str(w)).mkdir()
        procs[w] = spawn_gang(
            "dist_support:nondiv_suite",
            {"params": str(base / "params.pt"), "out": str(base / str(w))},
            w, [base / str(w) / f"w{r}" for r in range(w)])
    refs = {}
    try:
        for w, n, impl in LOSS_CASES:
            refs[w, n, impl] = _jax_loss_grads(w, n, impl, jparams[n])
        for w, n, e in ENGINE_CASES:
            refs[w, n, e] = _jax_tokens(w, n, e, jparams[n])
            eng = LLMEngine(nondiv_cfg(n, w), BatchingSpec(
                **TP_ENGINE_CASES[e]), params=whole[n], device="cpu",
                seed=3)
            refs[w, n, e, "one"] = [eng.generate(p, SamplingParams(
                max_new_tokens=10)) for p in TP_PROMPTS]
    finally:
        res = {w: finish(p) for w, p in procs.items()}
    for w, rs in res.items():
        for r, (rc, _, err) in enumerate(rs):
            assert rc == 0, f"world {w} rank {r} exit {rc}:\n{err[-4000:]}"
    ranks = {}
    for w in NONDIV_CASES:
        recs = [torch.load(base / str(w) / f"rank{r}.pt", weights_only=False)
                for r in range(w)]
        for n in NONDIV_CASES[w]:
            ranks[w, n] = [rec[n] for rec in recs]
    return {"refs": refs, "ranks": ranks}


@pytest.mark.parametrize("world,name,impl", LOSS_CASES,
                         ids=[f"{n}-{i}" for _, n, i in LOSS_CASES])
def test_loss_and_every_gradient_match_jax(gangs, world, name, impl):
    ref = gangs["refs"][world, name, impl]
    recs = gangs["ranks"][world, name]
    for rec in recs:
        got = rec[impl]
        for k, v in ref["metrics"].items():
            assert abs(got[k] - v) <= TOL * max(1.0, abs(v)), k
    got = whole_tree(recs, lambda r: r[impl]["grads"])
    assert set(got) == set(ref["grads"])
    for p, w in ref["grads"].items():
        w = np.asarray(w, np.float64)
        err = np.abs(got[p].numpy().astype(np.float64) - w).max()
        assert err <= TOL * max(np.abs(w).max(), 1e-30), (p, err)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_specs_are_jaxs_with_the_dims_that_do_not_divide_replicated(
        gangs, world, name):
    def norm(s):
        s = tuple(s)
        while s and s[-1] is None:
            s = s[:-1]
        return s

    ref = gangs["refs"][world, name, "dispatch"]["specs"]
    got = gangs["ranks"][world, name][0]["specs"]
    assert {p: norm(s) for p, s in got.items()} == \
        {p: norm(s) for p, s in ref.items()}
    axis = "expert" if name.startswith("moe") else "model"
    assert any(axis not in norm(s) for s in got.values())


@pytest.mark.parametrize("world,name,layout", ENGINE_CASES,
                         ids=[f"{n}-{e}" for _, n, e in ENGINE_CASES])
def test_tp_engine_greedy_tokens_match_jax(gangs, world, name, layout):
    got = gangs["ranks"][world, name][0][layout]
    assert got == gangs["refs"][world, name, layout]
    assert got == gangs["refs"][world, name, layout, "one"]


def test_the_refusals_left_are_jaxs():
    """``pipeline`` × ``model`` with heads that do not divide, and
    ``pipeline`` × ``expert`` with experts that do not, raise in JAX's
    staged branch; the port's ``check_stages`` raises with JAX's text."""
    tiny = jconfig.preset("tiny", dtype="float32")
    moe = jconfig.preset("tiny-moe", dtype="float32")
    toks = jnp.asarray(tp_tokens()[:2])
    for cfg, axes in ((tiny, {"pipeline": 2, "model": 3}),
                      (moe, {"pipeline": 2, "expert": 3})):
        mesh = jax_mesh(axes, jax.devices()[:6])
        params = jdec.init_decoder_params(jax.random.PRNGKey(0), cfg)
        with pytest.raises(ValueError) as want:
            jax.jit(lambda p, t, cfg=cfg, mesh=mesh: jdec.decoder_loss(
                p, t, cfg, mesh=mesh))(params, toks)
        tcfg = nondiv_cfg("tiny-model3", 3) if cfg is tiny else \
            nondiv_cfg("moe-expert3", 3)
        with pytest.raises(ValueError) as got:
            check_stages(tcfg, axes)
        text = str(got.value)
        if cfg is tiny:
            assert text == str(want.value)
        else:
            head = text.split(":")[0]
            assert str(want.value).startswith(head)
            assert "'expert' (of size 3)" in str(want.value)
