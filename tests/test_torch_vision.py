"""The port's vision models and tasks against the JAX package, on the CPU
at fp32, weights carried across by ``convert.params_from_jax``:

- ``vit_loss`` on ``tiny-vit`` and ``clip_loss`` on ``tiny-clip``: value,
  metrics and every gradient leaf against ``jax.value_and_grad`` (remat
  ``none`` and ``nothing_saveable``; loss within 1e-5, each leaf within
  1e-5 of its largest magnitude);
- ``patchify`` and the encoders' features against JAX's;
- ``vit_batch`` and ``clip_batch`` bit for bit;
- one ``step_fn`` of each task against the JAX task's step from the same
  state (optimizer state carried across by ``opt_state_from_jax``; SGD):
  metrics within 1e-4 of their magnitude (at least 1), every parameter
  within 1e-5;
- the init's keys and shapes equal JAX's, and a task without
  ``device=`` raises when there is no card.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import vision as jvis  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh  # noqa: E402
from kubeflow_tpu.train import optim as joptim  # noqa: E402
from kubeflow_tpu.train import vision_task as jtask  # noqa: E402
from kubeflow_tpu_torch.models import vision as tvis  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    opt_state_from_jax, params_from_jax,
)
from kubeflow_tpu_torch.train import optim as toptim  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from kubeflow_tpu_torch.train import vision_task as ttask  # noqa: E402
from kubeflow_tpu_torch.train.step import trainable  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.array, tree)


def _rel_leaf_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def _vit_cfgs(**over):
    over = {"dtype": "float32", **over}
    return jvis.vit_preset("tiny-vit", **over), tvis.vit_preset(
        "tiny-vit", **over)


def _clip_cfgs(**over):
    out = []
    for mod in (jvis, tvis):
        base = mod.clip_preset("tiny-clip")
        image = dataclasses.replace(base.image, dtype="float32", **over)
        out.append(dataclasses.replace(base, image=image, dtype="float32"))
    return tuple(out)


FAMILIES = {
    "vit": (_vit_cfgs, jvis.init_vit_params, jvis.vit_loss, tvis.vit_loss,
            jtask.vit_batch, ttask.vit_batch),
    "clip": (_clip_cfgs, jvis.init_clip_params, jvis.clip_loss,
             tvis.clip_loss, jtask.clip_batch, ttask.clip_batch),
}


def _params(tree):
    return trainable({"params": params_from_jax(tree, device="cpu")})[
        "params"]


@pytest.mark.parametrize("remat", ["none", "nothing_saveable"])
@pytest.mark.parametrize("family", ["vit", "clip"])
def test_loss_and_grads_match_jax(family, remat):
    mk, jinit, jloss_fn, tloss_fn, jbatch, _ = FAMILIES[family]
    jcfg, tcfg = mk(remat_policy=remat)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    batch = jbatch(jcfg, 4, 1)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, batch, jcfg), has_aux=True)(jparams)
    params = _params(_np(jparams))
    loss, m = tloss_fn(params, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, tcfg)
    assert abs(loss.item() - float(jloss)) <= TOL
    assert set(m) == set(jm)
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) <= TOL * max(
            1.0, abs(float(jm[k]))), k
    grads = torch.autograd.grad(loss, T.leaves(params))
    want = T.flatten(params_from_jax(_np(jgrads), device="cpu"))
    assert list(want) == list(T.flatten(params))
    for (path, w), g in zip(want.items(), grads):
        err = _rel_leaf_err(g.numpy(), w.numpy())
        assert err <= TOL, f"{path}: {err:.2e}"


def test_patchify_and_features_match_jax():
    jcfg, tcfg = _clip_cfgs()
    jparams = jvis.init_clip_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_jax(_np(jparams), device="cpu")
    batch = jtask.clip_batch(jcfg, 3, 2)
    imgs = batch["images"]
    np.testing.assert_array_equal(
        tvis.patchify(torch.from_numpy(imgs), 8).numpy(),
        np.asarray(jvis.patchify(jnp.asarray(imgs), 8)))
    with torch.no_grad():
        for jfn, tfn, x in ((jvis.clip_encode_image, tvis.clip_encode_image,
                             imgs),
                            (jvis.clip_encode_text, tvis.clip_encode_text,
                             batch["tokens"])):
            want = np.asarray(jfn(jparams, jnp.asarray(x), jcfg))
            got = tfn(params, torch.from_numpy(x), tcfg).numpy()
            assert _rel_leaf_err(got, want) <= TOL


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("family", ["vit", "clip"])
def test_synthetic_batches_match_jax_bit_for_bit(family, step):
    mk, _, _, _, jbatch, tbatch = FAMILIES[family]
    jcfg, tcfg = mk()
    want, got = jbatch(jcfg, 5, step), tbatch(tcfg, 5, step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


#: SGD: its step is linear in the gradient, so a parameter's difference
#: after it is lr times the gradient's (held above). Adam's first step,
#: g / (|g| + eps), is sign-like for CLIP's gradients near 1e-7 of their
#: leaf's largest, below the fp32 noise of two summation orders. The
#: optimizers themselves are held to optax in ``test_torch_train.py``.
_OPT = dict(name="sgd", learning_rate=1e-3, warmup_steps=0, total_steps=4)


@pytest.mark.parametrize("family", ["vit", "clip"])
def test_one_step_matches_the_jax_step(family):
    mk, *_, jbatch, _ = FAMILIES[family]
    jcfg, tcfg = mk()
    setup_j = jtask.setup_vit_train if family == "vit" \
        else jtask.setup_clip_train
    setup_t = ttask.setup_vit_train if family == "vit" \
        else ttask.setup_clip_train
    jt = setup_j(jcfg, joptim.OptimizerConfig(**_OPT),
                 build_mesh({"data": 1}, jax.devices()[:1]))
    init = _np(jt.state)
    batch = jbatch(jcfg, 4, 0)
    jstate, jm = jt.step_fn(jt.state, jax.device_put(batch,
                                                     jt.batch_shardings))
    tt = setup_t(tcfg, toptim.OptimizerConfig(**_OPT), device="cpu")
    tt.state = trainable({
        "params": params_from_jax(init["params"], device="cpu"),
        "opt_state": opt_state_from_jax(init["opt_state"], device="cpu"),
        "step": int(init["step"])})
    state, m = tt.step_fn(tt.state, batch)
    assert state["step"] == 1 and state["opt_state"]["count"] == 1
    assert set(m) == set(jm)
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * max(
            1.0, abs(float(jm[k]))), k
    want = T.flatten(params_from_jax(_np(jstate["params"]), device="cpu"))
    for (path, w), g in zip(want.items(), T.leaves(state["params"])):
        assert float((g.detach() - w).abs().max()) <= TOL, path


@pytest.mark.parametrize("family", ["vit", "clip"])
def test_init_keys_and_shapes_equal_jax(family):
    mk, jinit, *_ = FAMILIES[family]
    jcfg, tcfg = mk()
    want = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    init = tvis.init_vit_params if family == "vit" else tvis.init_clip_params
    got = init(torch.Generator().manual_seed(0), tcfg)
    fw = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
          for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    fg = T.flatten(got)
    assert sorted(fw) == sorted(fg)
    for k, leaf in fw.items():
        assert tuple(fg[k].shape) == tuple(leaf.shape), k
        assert str(fg[k].dtype).split(".")[-1] == str(leaf.dtype), k


def test_tasks_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _vit_cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttask.setup_vit_train(tcfg, toptim.OptimizerConfig())
