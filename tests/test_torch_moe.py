"""The port's MoE block and MoE serving (``models/layers.py``'s MoE,
``models/decoder.py``, the engine's per-phase expert paths) on the CPU,
held against the JAX package on the same numpy-seeded inputs and on
weights carried across by ``convert.params_from_jax``, fp32, ``tiny-moe``:

- ``moe_capacity`` equals the JAX formula over a range of T;
- ``_moe_dispatch`` equals JAX's output and balance loss to 1e-5 of the
  reference's magnitude with drops (capacity factor 1.25) and without
  (capacity factor E), with and without ``valid_len``, and with a router
  whose two best columns tie (the tie goes to the lower index, as
  ``jax.lax.top_k``'s); ``_moe_dense`` and ``_moe_aux_loss`` with
  ``valid`` likewise;
- ``decoder_forward`` on ``tiny-moe`` equals JAX's, dispatch and dense;
- engines (contiguous, paged, int8 pages; each ``moe_prefill_impl`` ×
  ``moe_decode_impl``) give the JAX engine's greedy tokens, at the
  training capacity factor with prompts long enough to drop; an ngram
  spec engine on prompts sure to draft gives them too;
- the dispatch prefill is batch independent, its pads claim no capacity,
  unknown impls raise with JAX's messages, and a worker serves from a
  JAX ``BatchingSpec`` dump;
- ``decoder_loss`` on ``tiny-moe`` gives a finite loss, the CE plus 0.01
  times a nonzero balance loss (``tests/test_torch_moe_train.py`` holds
  its value and gradients to JAX's)."""

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdecoder  # noqa: E402
from kubeflow_tpu.models import layers as jlayers  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models import decoder as tdecoder  # noqa: E402
from kubeflow_tpu_torch.models import layers as tlayers  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv, free_port  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams  # noqa: E402
from kubeflow_tpu_torch.serve.tokenizer import ByteTokenizer  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
#: The last prompt's 48 near-identical tokens overflow one expert's
#: capacity at the training factor (C = 40 in the 64 bucket, 20 per
#: 32-token chunk), so the dispatch prefill drops pairs.
PROMPTS = [[5, 17, 3, 99, 42], [7] * 20, [9, 8, 7, 6, 5, 4], [30, 31],
           [7] * 48]
LAYOUTS = {"contiguous": {}, "paged": {"paged": True},
           "int8": {"paged": True, "kv_cache_dtype": "int8"}}


def _cfgs(**over):
    return (jconfig.preset("tiny-moe", dtype="float32", **over),
            tconfig.preset("tiny-moe", dtype="float32", **over))


@pytest.fixture(scope="module")
def cfgs():
    return _cfgs()


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jdecoder.init_decoder_params(jax.random.PRNGKey(0), cfgs[0])


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _moe_params(cfg, seed=0):
    p, _ = jlayers.init_moe(jax.random.PRNGKey(seed), cfg)
    return p, params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


def _x(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


# -- the block ----------------------------------------------------------------------

@pytest.mark.parametrize("cf,e,k", [(1.25, 4, 2), (1.0, 8, 2), (2.0, 8, 1),
                                    (8.0, 8, 2), (0.5, 4, 2)])
def test_moe_capacity_equals_jax(cf, e, k):
    jc, tc = _cfgs(capacity_factor=cf, num_experts=e, experts_per_token=k)
    for t in list(range(1, 70)) + [127, 128, 512, 1500, 2048, 4096]:
        assert tlayers.moe_capacity(tc, t) == jlayers.moe_capacity(jc, t), t


_VALID = {"none": None, "scalar": 11, "rows": [9, 16]}


@pytest.mark.parametrize("valid", list(_VALID), ids=list(_VALID))
@pytest.mark.parametrize("cf", [1.25, 4.0], ids=["drops", "ample"])
def test_dispatch_equals_jax(cf, valid):
    jc, tc = _cfgs(capacity_factor=cf)
    jp, tp = _moe_params(jc)
    x = _x((2, 16, jc.hidden))
    vl = _VALID[valid]
    jout, jaux = jlayers.moe_block(
        jp, jnp.asarray(x), jc,
        valid_len=None if vl is None else jnp.asarray(vl))
    tout, taux = tlayers.moe_block(
        tp, torch.from_numpy(x), tc,
        valid_len=None if vl is None else torch.tensor(vl))
    close(tout, jout)
    close(taux, jaux)
    if vl is not None:
        # A pad row claims no capacity and gets no expert output.
        rows = np.asarray(_VALID[valid]).reshape(-1) * np.ones(2, int)
        for b, n in enumerate(rows):
            assert not tout[b, n:].abs().any()


def test_dispatch_drops_at_the_training_factor():
    """Near-identical tokens at capacity factor 1.25: pairs drop (the
    dispatch output departs from the dense oracle), and the port drops the
    same pairs as JAX."""
    jc, tc = _cfgs(capacity_factor=1.25)
    jp, tp = _moe_params(jc)
    x = np.broadcast_to(_x((1, 1, jc.hidden), seed=3), (1, 32, jc.hidden))
    x = np.ascontiguousarray(x + 1e-3 * _x((1, 32, jc.hidden), seed=4))
    tout, _ = tlayers.moe_block(tp, torch.from_numpy(x), tc)
    dense, _ = tlayers.moe_block(tp, torch.from_numpy(x),
                                 dataclasses.replace(tc, moe_impl="dense"))
    jout, _ = jlayers.moe_block(jp, jnp.asarray(x), jc)
    close(tout, jout)
    assert float((tout - dense).abs().max()) > 1e-2
    assert not tout[0, -1].abs().any()     # the tail token fully dropped


@pytest.mark.parametrize("impl", ["dispatch", "dense"])
@pytest.mark.parametrize("cf", [1.25, 4.0], ids=["drops", "ample"])
def test_tied_router_columns_break_to_the_lower_index(impl, cf):
    """Experts 1 and 2 get equal router columns, far above the rest: every
    token's two choices tie, and the first choice (which claims capacity
    first) must be expert 1, as in ``jax.lax.top_k``."""
    jc, tc = _cfgs(capacity_factor=cf, moe_impl=impl)
    jp, _ = _moe_params(jc, seed=5)
    router = np.asarray(jp["router"]).copy()
    router[:, 1] = router[:, 2] = np.abs(router).max(axis=1) * 4.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.abs(_x((2, 16, jc.hidden), seed=6))
    logits = torch.from_numpy(x).reshape(-1, jc.hidden) @ tp["router"]
    assert torch.equal(logits[:, 1], logits[:, 2])
    vals, idx = tlayers._top_k(logits, 2)
    assert (idx[:, 0] == 1).all() and (idx[:, 1] == 2).all()
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    assert np.array_equal(np.asarray(jidx), idx.numpy())
    jout, jaux = jlayers.moe_block(jp, jnp.asarray(x), jc)
    tout, taux = tlayers.moe_block(tp, torch.from_numpy(x), tc)
    close(tout, jout)
    close(taux, jaux)


def test_dense_and_aux_with_valid_equal_jax():
    jc, tc = _cfgs(moe_impl="dense")
    jp, tp = _moe_params(jc)
    x = _x((2, 16, jc.hidden))
    jout, jaux = jlayers.moe_block(jp, jnp.asarray(x), jc)
    tout, taux = tlayers.moe_block(tp, torch.from_numpy(x), tc)
    close(tout, jout)
    close(taux, jaux)
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 16, jc.num_experts)).astype(np.float32)
    onehot = rng.integers(0, 2, (2, 16, jc.num_experts)).astype(np.float32)
    valid = np.arange(16)[None, :] < np.array([5, 12])[:, None]
    for v in (None, valid):
        want = jlayers._moe_aux_loss(
            jnp.asarray(logits), jnp.asarray(onehot), jc, None,
            valid=None if v is None else jnp.asarray(v))
        got = tlayers._moe_aux_loss(
            torch.from_numpy(logits), torch.from_numpy(onehot), tc,
            valid=None if v is None else torch.from_numpy(v))
        close(got, want)


def test_parallel_axes_and_unknown_impl_raise():
    """The expert, sequence and model axes run now
    (tests/test_torch_moe_mesh.py). Leaves whole on a model rank (columns
    that do not divide, replicated as JAX replicates them) are read in the
    rank's part: the ranks' partial outputs add up to the whole block's.
    Experts that do not divide over the expert axis are whole on every
    rank and their gradients summed over it (``ep_partial``). What still
    raises: leaves that are neither whole nor the rank's cut of the
    experts or of their columns, and an unknown impl."""
    from kubeflow_tpu_torch.models.config import with_model_axis
    from kubeflow_tpu_torch.parallel.collectives import ModelAxis
    from kubeflow_tpu_torch.parallel.sharding import Placement, placement

    _, tc = _cfgs()
    _, tp = _moe_params(_cfgs()[0])
    x = torch.from_numpy(_x((1, 4, tc.hidden)))
    dense = dataclasses.replace(tc, moe_impl="dense")
    whole = tlayers.moe_block(tp, x, dense)[0]
    parts = sum(tlayers.moe_block(tp, x, with_model_axis(
        dense, ModelAxis(None, r, 3)))[0] for r in range(3))
    close(parts, whole.numpy())
    cut = {k: v if k == "router" else v[:, :, :40] if k != "down"
           else v[:, :40] for k, v in tp.items()}
    with pytest.raises(ValueError, match="expert_mlp"):
        tlayers.moe_block(cut, x, with_model_axis(tc, ModelAxis(None, 0, 2)))
    with pytest.raises(ValueError, match="experts"):
        tlayers.moe_block({k: v[:2] if k != "router" else v
                           for k, v in tp.items()}, x, tc)
    assert placement((None, None, "fsdp", "model"), {"expert": 3},
                     (None, "expert", "fsdp", "model")) == Placement(
                         ep_partial=True)
    with pytest.raises(ValueError, match="moe_impl"):
        tlayers.moe_block(tp, x, dataclasses.replace(tc, moe_impl="ragged"))


@pytest.mark.parametrize("impl", ["dispatch", "dense"])
def test_decoder_forward_equals_jax(cfgs, jparams, params, impl):
    jc = dataclasses.replace(cfgs[0], moe_impl=impl)
    tc = dataclasses.replace(cfgs[1], moe_impl=impl)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 24))
    for vl in (None, [20, 24]):
        jl, _, _ = jdecoder.decoder_forward(
            jparams, jnp.asarray(toks), jc,
            valid_len=None if vl is None else jnp.asarray(vl))
        tl, _ = tdecoder.decoder_forward(
            params, torch.from_numpy(toks), tc,
            valid_len=None if vl is None else torch.tensor(vl))
        close(tl, jl)


def test_init_and_training_loss(cfgs):
    _, tc = cfgs
    p = tdecoder.init_decoder_params(torch.Generator().manual_seed(0), tc)
    mlp = p["layers"]["mlp"]
    assert mlp["router"].shape == (tc.n_layers, tc.hidden, tc.num_experts)
    assert mlp["gate"].shape == (tc.n_layers, tc.num_experts, tc.hidden,
                                 tc.mlp_dim)
    assert mlp["down"].shape == (tc.n_layers, tc.num_experts, tc.mlp_dim,
                                 tc.hidden)
    # The JAX init's fan-in scales: every expert product is 1/sqrt(fan_in).
    assert abs(float(mlp["gate"].std()) * tc.hidden ** 0.5 - 0.88) < 0.05
    assert abs(float(mlp["down"].std()) * tc.mlp_dim ** 0.5 - 0.88) < 0.05
    toks = torch.randint(0, tc.vocab_size, (1, 9),
                         generator=torch.Generator().manual_seed(1))
    loss, m = tdecoder.decoder_loss(p, toks, tc)
    # An MoE loss is the CE plus 0.01 x the balance loss, which is nonzero.
    assert torch.isfinite(loss) and float(m["aux_loss"]) > 0
    assert abs(float(loss) - float(m["ce_loss"])
               - 0.01 * float(m["aux_loss"])) <= 1e-6


# -- engines ------------------------------------------------------------------------

def _batching(**kw):
    base = dict(max_batch_size=4, max_seq_len=96,
                prefill_buckets=[16, 32, 64], chunked_prefill_tokens=32,
                page_size=16, decode_steps=4)
    base.update(kw)
    return base


def port_engine(cfg, params, **kw):
    return LLMEngine(cfg, BatchingSpec(**_batching(**kw)), params=params,
                     device="cpu")


def gen_all(eng, prompts, n=10):
    reqs = [eng.submit(list(p), SamplingParams(max_new_tokens=n))
            for p in prompts]
    for _ in range(3000):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert all(r.done.is_set() for r in reqs), "requests did not finish"
    return [list(r.output_tokens) for r in reqs]


def jax_gen(jcfg, jparams, prompts, n=10, **kw):
    if kw.get("paged"):
        kw = dict(kw, paged_attn_impl="gather")
    eng = jengine.LLMEngine(jcfg, JBatchingSpec(**_batching(**kw)),
                            params=jparams)
    sp = jengine.SamplingParams(max_new_tokens=n, temperature=0.0)
    reqs = [eng.submit(list(p), sp) for p in prompts]
    while not all(r.done.is_set() for r in reqs):
        eng.step()
    return [list(r.output_tokens) for r in reqs]


@pytest.fixture(scope="module")
def want(cfgs, jparams):
    """The JAX engine's greedy tokens per (layout, prefill impl), its
    decode on the default (dense) path; zero-drop decode on the
    contiguous layout besides."""
    out = {}
    for layout, kw in LAYOUTS.items():
        for pre in ("dispatch", "dense"):
            out[layout, pre, "dense"] = jax_gen(
                cfgs[0], jparams, PROMPTS, moe_prefill_impl=pre, **kw)
    out["contiguous", "dispatch", "zero_drop"] = jax_gen(
        cfgs[0], jparams, PROMPTS, moe_decode_impl="zero_drop")
    return out


@pytest.mark.parametrize("dec", ["dense", "zero_drop"])
@pytest.mark.parametrize("pre", ["dispatch", "dense"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_tokens_equal_jax(cfgs, params, want, layout, pre, dec):
    eng = port_engine(cfgs[1], params, moe_prefill_impl=pre,
                      moe_decode_impl=dec, **LAYOUTS[layout])
    got = gen_all(eng, PROMPTS)
    ref = want.get((layout, pre, dec), want[layout, pre, "dense"])
    assert got == ref
    if eng._allocator is not None:
        eng._allocator.assert_quiescent()


def test_dispatch_prefill_drops_change_tokens(want):
    """The prompt that overflows capacity takes another path through the
    dispatch prefill than through the dense one (so the test above held
    the port to JAX's drops, not to the oracle's)."""
    assert any(want["contiguous", "dispatch", "dense"][i]
               != want["contiguous", "dense", "dense"][i]
               or want["paged", "dispatch", "dense"][i]
               != want["paged", "dense", "dense"][i]
               for i in range(len(PROMPTS)))


def test_phase_resolution(cfgs, params):
    eng = port_engine(cfgs[1], params)
    assert eng._cfg_prefill.moe_impl == "dispatch"
    assert eng._cfg_decode.moe_impl == "dense"
    assert eng.prefill_batch_max == 1
    eng = port_engine(cfgs[1], params, moe_prefill_impl="dense",
                      moe_decode_impl="zero_drop")
    assert eng._cfg_prefill.moe_impl == "dense"
    assert eng._cfg_decode.moe_impl == "dispatch"
    assert eng._cfg_decode.capacity_factor == cfgs[1].num_experts
    assert eng.prefill_batch_max == 4


@pytest.mark.parametrize("kw,match", [
    (dict(moe_prefill_impl="ragged"), "moe_prefill_impl"),
    (dict(moe_decode_impl="dispatch"), "moe_decode_impl")],
    ids=["prefill", "decode"])
def test_unknown_impls_rejected_as_by_jax(cfgs, jparams, params, kw, match):
    with pytest.raises(ValueError, match=match) as jexc:
        jengine.LLMEngine(cfgs[0], JBatchingSpec(**_batching(**kw)),
                          params=jparams)
    with pytest.raises(ValueError, match=match) as texc:
        port_engine(cfgs[1], params, **kw)
    assert str(texc.value) == str(jexc.value)


def test_dispatch_prefill_is_batch_independent(cfgs, params):
    """At the training capacity factor, co-batched traffic changes no
    request's tokens: each alone equals the batched run."""
    batched = gen_all(port_engine(cfgs[1], params), PROMPTS)
    for i, p in enumerate(PROMPTS):
        assert gen_all(port_engine(cfgs[1], params), [p]) == [batched[i]]


def test_prefill_pads_cannot_displace_choices(cfgs, params):
    """Short prompts in a 32-wide bucket: without the valid_len mask the
    pads' choices would flood an expert ahead of the real tokens' second
    choices; with it the dispatch prefill is the dense oracle's."""
    prompts = [[5, 17, 3], [7] * 8, [9, 8, 7, 6], [30, 31]]
    kw = dict(prefill_buckets=[32])
    dense = gen_all(port_engine(cfgs[1], params, moe_prefill_impl="dense",
                                **kw), prompts, n=8)
    disp = gen_all(port_engine(cfgs[1], params,
                               moe_prefill_impl="dispatch", **kw),
                   prompts, n=8)
    assert disp == dense


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_ngram_spec_engine_equals_jax(cfgs, jparams, params, layout):
    """P + G + P (G = P's greedy continuation): the ngram drafter proposes
    from the first round; the spec engine's tokens are the JAX plain
    engine's, and it ran rounds that drafted."""
    got = gen_all(port_engine(cfgs[1], params, **LAYOUTS[layout]),
                  PROMPTS[:3], n=12)
    replay = [p + g + p for p, g in zip(PROMPTS[:3], got)]
    eng = port_engine(cfgs[1], params, speculative={"mode": "ngram", "k": 4},
                      **LAYOUTS[layout])
    out = gen_all(eng, replay, n=12)
    assert out == jax_gen(cfgs[0], jparams, replay, n=12, **LAYOUTS[layout])
    assert eng.metrics.snapshot().get("spec_rounds", 0) > 0
    assert eng.metrics.spec_drafted > 0


def test_moe_draft_model_is_accepted(cfgs, params):
    """A tiny-moe self-draft: its tokens equal the spec-off engine's."""
    spec = {"mode": "draft_model", "k": 4,
            "draft": {"preset": "tiny-moe", "overrides": {"dtype":
                                                          "float32"}}}
    plain = gen_all(port_engine(cfgs[1], params, paged=True), PROMPTS[:2])
    eng = LLMEngine(cfgs[1], BatchingSpec(**_batching(
        paged=True, speculative=spec)), params=params, draft_params=params,
        device="cpu")
    assert gen_all(eng, PROMPTS[:2]) == plain
    assert eng.metrics.spec_drafted > 0


# -- the worker ---------------------------------------------------------------------

def test_worker_accepts_a_jax_batching_dump(cfgs):
    """``runtime.worker_main`` → ``model_server`` with the batching config a
    JAX ``BatchingSpec`` dumps (``moe_prefill_impl``/``moe_decode_impl``
    included) serves ``tiny-moe`` from ``random://``, with an in-process
    engine's text on the same weights."""
    dump = JBatchingSpec(**_batching(paged=True)).model_dump()
    assert {"moe_prefill_impl", "moe_decode_impl"} <= set(dump)
    model = {"preset": "tiny-moe", "overrides": {"dtype": "float32"}}
    tok = ByteTokenizer()
    prompt = "mixture of experts"
    ref = LLMEngine(cfgs[1], BatchingSpec(**dump), seed=0, device="cpu")
    [tokens] = gen_all(ref, [tok.encode(prompt)], n=12)
    port = free_port()
    wenv = WorkerEnv(
        coordinator_address="127.0.0.1:0", num_processes=1, process_id=0,
        job="default/moe", replica_index=0, entrypoint="model_server",
        config={"model": model, "storage_uri": "random://",
                "batching": json.loads(json.dumps(dump)), "port": port,
                "service": "moe"},
        parallelism={}, platform="cpu")
    env = {k: v for k, v in os.environ.items() if not k.startswith("KFTPU_")}
    env.update(wenv.to_env())
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        t0 = time.monotonic()
        while True:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.monotonic() - t0 < 90, "worker never became ready"
            try:
                with urllib.request.urlopen(url + "/v2/health/ready",
                                            timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.2)
        body = json.dumps({"prompt": prompt, "max_tokens": 12}).encode()
        req = urllib.request.Request(url + "/v1/completions", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["choices"][0]["text"] == tok.decode(tokens)
    finally:
        proc.kill()
        proc.wait(timeout=30)
