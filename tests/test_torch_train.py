"""The port's training slice against the JAX package, on the CPU at fp32.

- ``decoder_loss`` value and grads on the flagship-small Llama-3 shape of
  ``__graft_entry__`` (``fused_kernels="off"``; attention ``xla`` and
  ``pallas`` — the JAX flash kernels in interpret mode; remat ``none`` and
  ``nothing_saveable``; dense and chunked CE) against
  ``jax.value_and_grad``: loss within 1e-5, each gradient leaf within
  1e-5 of its largest magnitude (two layers of fp32 products summed in a
  different order).
- ``make_schedule`` against optax's at every step across the warmup
  boundary (rel 1e-6: both evaluate in fp32).
- One and five optimizer steps (adamw, adam, sgd, adamw with a bf16
  ``mu_dtype``, ``FusedAdamW``) against optax from the same state, carried
  across with ``opt_state_from_jax``: params within 1e-6, moments within
  1e-6 (one bf16 ulp of |mu| for a bf16 mu).
- ``SyntheticLM.batch_at`` bit for bit; one ``step_fn`` against the JAX
  ``setup_train`` step from the same state and batch; a 20-step loss curve
  on ``tiny`` against JAX's from the same init.
- Checkpoints (round trip, corruption → quarantine and fallback, tier
  preference), the ``Trainer`` (loss falls, resume is exact, SIGTERM
  saves and exits with ``EXIT_PREEMPTED``; five steps with
  ``fused_kernels="on"`` — the fused norm, SwiGLU and CE through their
  autograd Functions' plain CPU paths — track five with ``"off"`` within
  1e-5), and the refusals: unported remat policies, and entry points
  without ``device=`` when there is no card.
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh  # noqa: E402
from kubeflow_tpu.train import data as jdata  # noqa: E402
from kubeflow_tpu.train import optim as joptim  # noqa: E402
from kubeflow_tpu.train import step as jstep  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models import decoder as tdec  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    opt_state_from_jax, params_from_jax,
)
from kubeflow_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402
from kubeflow_tpu_torch.train import optim as toptim  # noqa: E402
from kubeflow_tpu_torch.train import step as tstep  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from kubeflow_tpu_torch.train.metrics import Throughput  # noqa: E402
from kubeflow_tpu_torch.train.staging import (  # noqa: E402
    DeviceBatchStager, to_device,
)
from kubeflow_tpu_torch.train.survival import EXIT_PREEMPTED  # noqa: E402
from kubeflow_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig,
)


def _tcfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return dataclasses.replace(tconfig.DecoderConfig(**fields), **kw)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _rel_leaf_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


# -- decoder_loss -------------------------------------------------------------

_FLAG = dataclasses.replace(__graft_entry__._flagship_small(),
                            dtype="float32", fused_kernels="off")
_JAX_LOSS: dict = {}


def _jax_loss(attn, chunk):
    if (attn, chunk) not in _JAX_LOSS:
        jcfg = dataclasses.replace(_FLAG, loss_chunk_size=chunk)
        params = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
        toks = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, (2, 65)).astype(np.int32)
        (loss, m), grads = jax.jit(jax.value_and_grad(
            lambda p: jdec.decoder_loss(p, toks, jcfg, attn_impl=attn),
            has_aux=True))(params)
        _JAX_LOSS[attn, chunk] = (jcfg, _np(params), toks, float(loss),
                                  {k: float(v) for k, v in m.items()},
                                  _np(grads))
    return _JAX_LOSS[attn, chunk]


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("chunk", [0, 16], ids=["dense", "chunked"])
@pytest.mark.parametrize("remat", ["none", "nothing_saveable"])
def test_decoder_loss_and_grads_match_jax(attn, chunk, remat):
    jcfg, jparams, toks, jloss, jm, jgrads = _jax_loss(attn, chunk)
    cfg = _tcfg(jcfg, remat_policy=remat)
    params = tstep.trainable({"params": params_from_jax(
        jparams, device="cpu")})["params"]
    loss, m = tdec.decoder_loss(params, torch.from_numpy(toks), cfg,
                                attn_impl=attn)
    assert abs(loss.item() - jloss) <= 1e-5
    for k in ("ce_loss", "aux_loss", "tokens", "accuracy"):
        assert abs(float(m[k]) - jm[k]) <= 1e-5, k
    grads = torch.autograd.grad(loss, T.leaves(params))
    want = T.flatten(params_from_jax(jgrads, device="cpu"))
    for (path, w), g in zip(want.items(), grads):
        err = _rel_leaf_err(g.numpy(), w.numpy())
        assert err <= 1e-5, f"{path}: {err:.2e}"


def test_chunked_ce_argmax_ties_go_to_the_lowest_index():
    cfg = tconfig.preset("tiny", dtype="float32", loss_chunk_size=2)
    hidden = torch.zeros((1, 4, cfg.hidden))
    head = torch.zeros((cfg.hidden, cfg.vocab_size))   # every logit ties
    targets = torch.tensor([[0, 1, 0, 5]])
    nll, correct = tdec._chunked_ce(hidden, head, targets, cfg)
    assert correct.tolist() == [[1.0, 0.0, 1.0, 0.0]]
    torch.testing.assert_close(nll, torch.full((1, 4), np.log(256.0)))


def test_unported_remat_policies_raise():
    cfg = tconfig.preset("tiny", dtype="float32")
    params = tdec.init_decoder_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 9))
    with pytest.raises(NotImplementedError, match="dots_flash"):
        tdec.decoder_loss(params, toks, dataclasses.replace(
            cfg, fused_kernels="off", remat_policy="dots_flash"))
    with torch.no_grad():      # serving with such a config still runs
        tdec.decoder_forward(params, toks, dataclasses.replace(
            cfg, fused_kernels="off", remat_policy="dots_flash"))


# -- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 1, 3, 10])
def test_schedule_matches_optax(warmup):
    cfg = joptim.OptimizerConfig(learning_rate=3e-3, warmup_steps=warmup,
                                 total_steps=20, min_lr_ratio=0.1)
    want = joptim.make_schedule(cfg)
    got = toptim.make_schedule(toptim.OptimizerConfig(
        **dataclasses.asdict(cfg)))
    for step in range(26):
        w = float(want(jnp.int32(step)))
        assert abs(got(step) - w) <= 1e-6 * abs(w) + 1e-12, step


OPT_CASES = {
    "adamw": {},
    "adam": {"name": "adam"},
    "sgd": {"name": "sgd"},
    "adamw_mu_bf16": {"mu_dtype": "bfloat16"},
    "fused": {"fused": True},
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
@pytest.mark.parametrize("steps", [1, 5])
def test_optimizer_steps_match_optax(case, steps):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              clip_norm=1.0, **OPT_CASES[case])
    jcfg_opt = joptim.OptimizerConfig(**kw)
    mcfg = jconfig.preset("tiny", dtype="float32")
    jparams = jdec.init_decoder_params(jax.random.PRNGKey(1), mcfg)
    jopt = joptim.make_optimizer(jcfg_opt)
    jstate = jopt.init(jparams)
    params = params_from_jax(_np(jparams), device="cpu")
    state = opt_state_from_jax(_np(jstate), device="cpu")
    topt = toptim.make_optimizer(toptim.OptimizerConfig(**kw))
    rng = np.random.default_rng(2)
    for i in range(steps):
        # Odd steps stay under the clip norm, even ones are clipped.
        scale = 1e-4 if i % 2 else 1.0
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * scale).astype(
                np.float32), jparams)
        jparams, jstate, jnorm = joptim.apply_optimizer(
            jopt, grads, jstate, jparams)
        params, state, norm = toptim.apply_optimizer(
            topt, params_from_jax(grads, device="cpu"), state, params)
        assert abs(float(norm) - float(jnorm)) <= 1e-5 * float(jnorm)
    want_p = T.flatten(params_from_jax(_np(jparams), device="cpu"))
    for (path, w), g in zip(want_p.items(), T.leaves(params)):
        assert float((g - w).abs().max()) <= 1e-6, path
    want_s = opt_state_from_jax(_np(jstate), device="cpu")
    assert want_s["count"] == state["count"] == steps
    for part in ("mu", "nu", "trace"):
        if part not in want_s:
            continue
        for (path, w), g in zip(T.flatten(want_s[part]).items(),
                                T.leaves(state[part])):
            assert g.dtype == w.dtype, path
            tol = 1e-6 + (2.0 ** -7 * w.float().abs()
                          if w.dtype == torch.bfloat16 else 0.0)
            assert torch.all((g.float() - w.float()).abs() <= tol), \
                f"{part}/{path}"


# -- data, step, loss curve ---------------------------------------------------

@pytest.mark.parametrize("seed,step,shard,shards", [(0, 0, 0, 1), (3, 17, 1, 2),
                                                     (5, 1000, 3, 4)])
def test_synthetic_batches_match_jax_bit_for_bit(seed, step, shard, shards):
    kw = dict(vocab_size=997, seq_len=33, global_batch=8, seed=seed)
    want = jdata.SyntheticLM(jdata.DataConfig(**kw), shard, shards)
    got = tdata.SyntheticLM(tdata.DataConfig(**kw), shard, shards)
    np.testing.assert_array_equal(got.batch_at(step), want.batch_at(step))
    np.testing.assert_array_equal(
        tdata.stacked_batches(got, step, 3),
        jdata.stacked_batches(want, step, 3))


_TINY = jconfig.preset("tiny", dtype="float32", fused_kernels="off",
                       max_seq_len=32)
_OPT = dict(learning_rate=3e-3, warmup_steps=3, total_steps=40)
_JAX_RUN: dict = {}


def _jax_run():
    """The JAX setup_train task on one CPU device: its initial state (as
    numpy), and the losses, grad norms and final params of 20 steps."""
    if not _JAX_RUN:
        task = jstep.setup_train(_TINY, joptim.OptimizerConfig(**_OPT),
                                 build_mesh({"fsdp": 1}, jax.devices()[:1]))
        init = _np(task.state)
        src = jdata.SyntheticLM(jdata.DataConfig(vocab_size=256, seq_len=32,
                                                 global_batch=4))
        state, losses, norms = task.state, [], []
        for i in range(20):
            batch = jax.device_put(src.batch_at(i), task.batch_sharding)
            state, m = task.step_fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i == 0:
                first = _np(state["params"])
        _JAX_RUN.update(init=init, losses=losses, norms=norms, first=first,
                        src=src)
    return _JAX_RUN


def _port_task():
    run = _jax_run()
    task = tstep.setup_train(_tcfg(_TINY), toptim.OptimizerConfig(**_OPT),
                             device="cpu", init_state=False)
    task.state = tstep.trainable({
        "params": params_from_jax(run["init"]["params"], device="cpu"),
        "opt_state": opt_state_from_jax(run["init"]["opt_state"],
                                        device="cpu"),
        "step": int(run["init"]["step"])})
    return task, run


def test_one_step_matches_the_jax_step():
    task, run = _port_task()
    state, m = task.step_fn(task.state, torch.from_numpy(
        run["src"].batch_at(0)))
    assert abs(float(m["loss"]) - run["losses"][0]) <= 1e-5
    assert abs(float(m["grad_norm"]) - run["norms"][0]) \
        <= 1e-4 * run["norms"][0]
    assert state["step"] == 1 and state["opt_state"]["count"] == 1
    want = T.flatten(params_from_jax(run["first"], device="cpu"))
    for (path, w), g in zip(want.items(), T.leaves(state["params"])):
        assert float((g.detach() - w).abs().max()) <= 1e-5, path


def test_twenty_step_loss_curve_tracks_jax():
    """Same init, same batches: every step's loss within 1e-3 of JAX's
    (fp32 differences that Adam's normalisation grows step by step), and
    the curve falls."""
    task, run = _port_task()
    losses = []
    state = task.state
    for i in range(20):
        state, m = task.multi_step_fn(state, torch.from_numpy(
            run["src"].batch_at(i))[None])
        losses.append(float(m["loss"]))
    diffs = np.abs(np.array(losses) - np.array(run["losses"]))
    assert diffs.max() <= 1e-3, diffs
    assert losses[-1] < losses[0] - 0.5


# -- checkpoints --------------------------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 5, generator=g),
                       "layers": {"b": torch.randn(7, generator=g)}},
            "opt_state": {"count": 4,
                          "mu": {"w": torch.randn(3, 5, generator=g).to(
                              torch.bfloat16)}},
            "step": 4}


def _assert_same(a, b):
    fa, fb = T.flatten(a), T.flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_checkpoint_round_trip_is_exact(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3):
        assert mgr.save(step, _state(step))
    assert mgr.steps_on_disk() == [2, 3]             # max_to_keep
    assert not mgr.save(3, _state(0))                # exists: rejected
    assert mgr.verify_step(3)
    _assert_same(mgr.restore(3), _state(3))
    _assert_same(mgr.restore(), _state(3))
    assert mgr.latest_committed_step() == 3


def test_corrupt_step_is_quarantined_and_resume_falls_back(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    path = tmp_path / "ck" / "2" / "params.w.pt"
    data = bytearray(path.read_bytes())
    data[-1] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(tckpt.CheckpointCorruptionError):
        mgr.restore(2)
    state, step, tier, fallbacks = tckpt.resume_from_tiers(
        [("interval", mgr)])
    assert (step, tier, fallbacks) == (1, "interval", 1)
    _assert_same(state, _state(1))
    assert mgr.steps_on_disk() == [1]
    assert os.listdir(tmp_path / "ck" / "quarantine") == ["2"]


def test_resume_prefers_the_emergency_tier_and_ignores_torn_saves(tmp_path):
    interval = tckpt.CheckpointManager(str(tmp_path / "i"))
    emergency = tckpt.CheckpointManager(str(tmp_path / "e"), max_to_keep=1)
    interval.save(4, _state(1))
    emergency.save(4, _state(2))
    tiers = [("emergency", emergency), ("interval", interval)]
    state, step, tier, _ = tckpt.resume_from_tiers(tiers)
    assert (step, tier) == (4, "emergency")
    _assert_same(state, _state(2))
    interval.save(6, _state(3))
    assert tckpt.resume_from_tiers(tiers)[1:3] == (6, "interval")
    # A save a crash interrupted leaves only a temporary directory, which
    # is never a candidate and is removed by the next manager.
    (tmp_path / "i" / "9.tmp-1234").mkdir()
    assert interval.steps_on_disk() == [4, 6]
    tckpt.CheckpointManager(str(tmp_path / "i"))
    assert not (tmp_path / "i" / "9.tmp-1234").exists()


# -- trainer ------------------------------------------------------------------

def _trainer_cfg(**kw):
    base = dict(model="tiny", model_overrides={"dtype": "float32",
                                               "fused_kernels": "off"},
                data={"seq_len": 32, "global_batch": 4},
                optimizer={"learning_rate": 3e-3, "warmup_steps": 5},
                log_every=1, watchdog_enabled=False)
    base.update(kw)
    return TrainerConfig(**base)


def _run(cfg, workdir, on_step=None):
    import io

    os.makedirs(workdir, exist_ok=True)
    tr = Trainer(cfg, device="cpu", workdir=str(workdir))
    tr.emitter.stream = io.StringIO()
    losses = {}

    def record(step, m):
        losses[step] = m["loss"]
        if on_step is not None:
            on_step(step, m)

    tr.run(on_step=record)
    return tr, losses


def test_trainer_loss_falls_over_thirty_steps(tmp_path):
    tr, losses = _run(_trainer_cfg(steps=30), tmp_path)
    first = np.mean([losses[s] for s in range(1, 6)])
    last = np.mean([losses[s] for s in range(26, 31)])
    assert last < first - 1.0, (first, last)
    assert tr.emitter.stream.getvalue().count("step=") == 30


@pytest.mark.parametrize("model", ["tiny", "tiny-gemma"])
def test_trainer_with_fused_kernels_on_tracks_the_plain_run(tmp_path, model):
    """Five steps through the fused kernels' CPU paths (the norms and
    SwiGLU/GeGLU as autograd Functions, the fused CE instead of the
    chunked one; tiny-gemma adds the (1 + w) norms, the tied head and the
    softcap) against five plain steps from the same init and data."""
    runs = {}
    for fk in ("off", "on"):
        cfg = _trainer_cfg(steps=5, model=model, model_overrides={
            "dtype": "float32", "fused_kernels": fk, "loss_chunk_size": 16})
        runs[fk] = _run(cfg, tmp_path / fk)[1]
    assert sorted(runs["on"]) == list(range(1, 6))
    for step in range(1, 6):
        assert abs(runs["on"][step] - runs["off"][step]) <= 1e-5, step


class _Crash(Exception):
    pass


def test_trainer_resume_is_exact(tmp_path):
    _, whole = _run(_trainer_cfg(steps=6), tmp_path / "w")

    def crash(step, _):
        if step == 3:
            raise _Crash()

    ck = str(tmp_path / "ck")
    with pytest.raises(_Crash):
        _run(_trainer_cfg(steps=6, checkpoint_dir=ck, checkpoint_every=3),
             tmp_path / "a", on_step=crash)
    tr, resumed = _run(_trainer_cfg(steps=6, checkpoint_dir=ck,
                                    checkpoint_every=3), tmp_path / "a")
    assert sorted(resumed) == [4, 5, 6]
    for s in (4, 5, 6):
        assert resumed[s] == whole[s], s
    assert tr.ledger.data["attempts"] == 2


def test_sigterm_saves_to_the_emergency_tier_and_exits(tmp_path):
    ck = str(tmp_path / "ck")

    def preempt(step, _):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        _run(_trainer_cfg(steps=10, checkpoint_dir=ck, checkpoint_every=0),
             tmp_path, on_step=preempt)
    assert exc.value.code == EXIT_PREEMPTED
    assert signal.getsignal(signal.SIGTERM) is before
    emergency = tckpt.CheckpointManager(ck + "-emergency")
    assert emergency.steps_on_disk() == [3]
    assert emergency.verify_step(3)
    tr, resumed = _run(_trainer_cfg(steps=5, checkpoint_dir=ck,
                                    checkpoint_every=0), tmp_path)
    assert sorted(resumed) == [4, 5]
    assert tr.ledger.data["emergency_saves"] == 1


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.setup_train(tconfig.preset("tiny"), toptim.OptimizerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_trainer_cfg(steps=1))


def test_throughput_reports_mfu_only_against_a_known_card():
    for card, has_mfu in ((None, False), ("NVIDIA H100 80GB HBM3", True),
                          ("Some Card", False)):
        tp = Throughput(1000, 1, 6e9, generation=card)
        tp.tick()
        out = tp.tick()
        assert ("mfu" in out) is has_mfu
        assert out["tokens_per_sec"] > 0


def test_stager_hands_out_batches_in_order():
    with DeviceBatchStager(lambda i: to_device(np.full((2, 3), i),
                                               torch.device("cpu")),
                           start=5) as st:
        for i in range(5, 9):
            assert st.get(i, timeout=10).tolist() == [[i] * 3] * 2
        with pytest.raises(RuntimeError, match="sequential"):
            st.get(20, timeout=10)


def test_trainer_stages_and_trains_on_a_text_file(tmp_path):
    """``dataset_uri`` stages the file into the workdir and switches the
    data to packed byte-tokenized text; batches are a pure function of the
    step."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the quick brown fox jumps over the lazy dog. " * 40)
    cfg = _trainer_cfg(steps=3, dataset_uri=f"file://{corpus}",
                       model_overrides={"dtype": "float32",
                                        "fused_kernels": "off",
                                        "vocab_size": 512})
    tr, losses = _run(cfg, tmp_path / "w")
    assert sorted(losses) == [1, 2, 3]
    assert tr.data_cfg.kind == "text"
    assert os.path.exists(tmp_path / "w" / "staged" / "corpus.txt")
    np.testing.assert_array_equal(tr.data.batch_at(7), tr.data.batch_at(7))
    assert tr.data.batch_at(0).shape == (4, 33)
