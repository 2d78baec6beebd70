"""The port's decoder forward against the JAX package's on the same weights:
JAX-initialised params carried across with ``convert.params_from_jax``,
token ids from a numpy seed, float32 throughout.

Presets: ``tiny`` (Llama structure), ``tiny-gemma`` ((1+w) norms, embed
scale, GeGLU, tied embeddings, logit softcap) and the flagship-small
Llama-3 shape of ``__graft_entry__``. Tolerance: |got - want| <= 1e-4 *
(1 + |want|) on logits and cache contents (two layers of fp32 matmuls
summed in a different order by each framework)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models import decoder as tdec  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4


def _maxdiff(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def _configs(name):
    if name == "flagship-small":
        jcfg = dataclasses.replace(__graft_entry__._flagship_small(),
                                   dtype="float32")
    else:
        jcfg = jconfig.preset(name, dtype="float32")
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    return jcfg, tconfig.DecoderConfig(**fields)


PRESETS = ["tiny", "tiny-gemma", "flagship-small"]


@pytest.fixture(scope="module", params=PRESETS)
def model(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return request.param, jcfg, tcfg, jparams, tparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_fields_and_presets_match_jax():
    assert ([f.name for f in dataclasses.fields(jconfig.DecoderConfig)]
            == [f.name for f in dataclasses.fields(tconfig.DecoderConfig)])
    assert sorted(jconfig.PRESETS) == sorted(tconfig.PRESETS)
    for name, jcfg in jconfig.PRESETS.items():
        tcfg = tconfig.PRESETS[name]
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg), name
        assert jcfg.num_params() == tcfg.num_params()
    assert tconfig.preset("tiny").activation_dtype == torch.bfloat16
    assert tconfig.preset("tiny").weight_dtype == torch.float32


def test_forward_matches_jax(model):
    name, jcfg, tcfg, jparams, tparams = model
    toks = _tokens(jcfg, 2, 12)
    want, _, _ = jdec.decoder_forward(jparams, jnp.asarray(toks), jcfg)
    got, caches = tdec.decoder_forward(tparams, torch.from_numpy(toks).long(),
                                       tcfg)
    assert caches is None and got.dtype == torch.float32
    assert _maxdiff(got, want) <= TOL, name
    hidden, _ = tdec.decoder_forward(tparams, torch.from_numpy(toks).long(),
                                     tcfg, skip_head=True)
    jhidden, _, _ = jdec.decoder_forward(jparams, jnp.asarray(toks), jcfg,
                                         skip_head=True)
    assert _maxdiff(hidden, jhidden) <= TOL, name


def test_contiguous_cache_prefill_then_decode_matches_jax(model):
    name, jcfg, tcfg, jparams, tparams = model
    toks = _tokens(jcfg, 2, 12, seed=1)
    jc = jdec.init_kv_caches(jcfg, 2, 32)
    jl1, jc = jdec.decoder_forward(jparams, jnp.asarray(toks[:, :9]), jcfg,
                                   kv_caches=jc)[:2]
    jl2, jc = jdec.decoder_forward(jparams, jnp.asarray(toks[:, 9:]), jcfg,
                                   kv_caches=jc)[:2]
    tc = tdec.init_kv_caches(tcfg, 2, 32, "cpu")
    t = torch.from_numpy(toks).long()
    tl1, tc = tdec.decoder_forward(tparams, t[:, :9], tcfg, kv_caches=tc)
    tl2, tc = tdec.decoder_forward(tparams, t[:, 9:], tcfg, kv_caches=tc)
    assert tc["len"] == int(jc["len"]) == 12
    assert _maxdiff(tl1, jl1) <= TOL, name
    assert _maxdiff(tl2, jl2) <= TOL, name
    assert _maxdiff(tc["k"], jc["k"]) <= TOL, name
    assert _maxdiff(tc["v"], jc["v"]) <= TOL, name
    # Decoding with the cache continues the uncached forward exactly.
    full, _ = tdec.decoder_forward(tparams, t, tcfg)
    assert _maxdiff(tl2, full[:, 9:]) <= TOL, name


def test_prefill_marker_runs_the_flash_path_like_the_plain_path(model):
    """The engine's scratch-cache prefill with ``attn_impl="pallas"`` (the
    flash path; its plain version on the CPU) against the JAX package's
    plain-attention forward, with the fused-kernel wrappers forced on."""
    name, jcfg, tcfg, jparams, tparams = model
    toks = _tokens(jcfg, 2, 16, seed=2)
    want, _, _ = jdec.decoder_forward(jparams, jnp.asarray(toks), jcfg)
    on = dataclasses.replace(tcfg, fused_kernels="on")
    shape = (on.n_layers, 2, 16, on.n_kv_heads, on.head_dim)
    scratch = {"k": torch.zeros(shape), "v": torch.zeros(shape), "len": 0,
               "prefill": True}
    got, filled = tdec.decoder_forward(tparams, torch.from_numpy(toks).long(),
                                       on, kv_caches=scratch,
                                       attn_impl="pallas")
    assert _maxdiff(got, want) <= TOL, name
    assert filled["len"] == 16 and filled["k"] is scratch["k"]


def test_init_decoder_params_layout_matches_jax():
    jcfg, tcfg = _configs("tiny-gemma")
    jtree = jax.tree.map(np.asarray,
                         jdec.init_decoder_params(jax.random.PRNGKey(3), jcfg))
    gen = torch.Generator().manual_seed(3)
    ttree = tdec.init_decoder_params(gen, tcfg)

    def shapes(tree, fn):
        if isinstance(tree, dict):
            return {k: shapes(v, fn) for k, v in tree.items()}
        return fn(tree)

    assert shapes(ttree, lambda t: tuple(t.shape)) == \
        shapes(jtree, lambda a: tuple(a.shape))
    assert ttree["layers"]["attn"]["wq"].dtype == torch.float32
    # Same distribution family: truncated normal x fan-in scale.
    for key in ("wq", "wo"):
        jstd = float(np.std(jtree["layers"]["attn"][key]))
        tstd = float(ttree["layers"]["attn"][key].std())
        assert abs(tstd - jstd) / jstd < 0.1, key
    bf = tdec.init_decoder_params(torch.Generator().manual_seed(3), tcfg,
                                  dtype=torch.bfloat16)
    assert bf["layers"]["mlp"]["gate"].dtype == torch.bfloat16


def test_params_from_jax_stacks_lists_and_reads_bfloat16():
    jcfg, tcfg = _configs("tiny")
    listed = dataclasses.replace(jcfg, scan_layers=False)
    jtree = jdec.init_decoder_params(jax.random.PRNGKey(4), listed)
    assert isinstance(jtree["layers"], list)
    bf = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jtree)
    tparams = params_from_jax(bf, device="cpu")
    wq = tparams["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert tuple(wq.shape) == (jcfg.n_layers, jcfg.hidden, jcfg.n_heads,
                               jcfg.head_dim)
    want = np.stack([np.asarray(b["attn"]["wq"], np.float32)
                     for b in bf["layers"]])
    assert np.array_equal(wq.float().numpy(), want)


def test_moe_lora_and_sequence_parallel_raise():
    moe = tconfig.preset("tiny-moe", dtype="float32")
    with pytest.raises(NotImplementedError):
        tdec.init_decoder_params(torch.Generator(), moe)
    _, tcfg = _configs("tiny")
    params = tdec.init_decoder_params(torch.Generator().manual_seed(0), tcfg)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError):
        tdec.decoder_forward(params, toks, tcfg, attn_impl="ring")
    with pytest.raises(NotImplementedError, match="LoRA"):
        tdec.decoder_forward(params, toks, tcfg, lora={"targets": {}})
