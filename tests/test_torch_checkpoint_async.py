"""Asynchronous checkpoint saves (``train/checkpoint.py``) with orbax's
semantics, on the CPU, and the ``grain`` data kind against the JAX
package's source:

- ``latest_step`` includes the save in flight while
  ``latest_committed_step`` does not, as
  ``tests/test_train_chaos.py::test_latest_committed_vs_latest_divergence``
  holds on the reference; ``wait`` lands it, ``close`` waits;
- the snapshot is taken before ``save()`` returns: state changed in place
  right after it (as the optimizer changes it) does not reach the step,
  also when the host buffers are reused by the next save, and over twelve
  saves back to back on more writer threads than cores;
- a failed write surfaces once, at the next ``wait()`` or ``save()``, and
  a ``Trainer`` counts it into ``checkpoint_save_failures`` and the
  goodput ledger while it trains on;
- a process SIGKILLed mid-write leaves the previous committed step and a
  temporary directory, which the next manager removes; the resume walk
  takes the committed step;
- a ``Trainer``'s interval and emergency tiers snapshot into one set of
  host buffers: a preemption after an interval save allocates no second
  snapshot;
- a ``Trainer`` whose steps 4–5 run while its step-3 save is still being
  written, then crashes, resumes at step 3 to the uninterrupted run's
  losses bit for bit;
- ``GrainLM.batch_at`` equals the JAX grain source's bit for bit.
"""

import io
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.train import checkpoint as tckpt
from kubeflow_tpu_torch.train import data as tdata
from kubeflow_tpu_torch.train import tree as T
from kubeflow_tpu_torch.train.survival import EXIT_PREEMPTED
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig
from port_threads import torch_on_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _state(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 5, generator=g),
                       "b": torch.randn(7, generator=g).to(torch.bfloat16)},
            "opt_state": {"count": torch.tensor(seed, dtype=torch.int32)},
            "step": seed}


def _assert_same(a, b):
    fa, fb = T.flatten(a), T.flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


class _Gate:
    """Holds the writer thread before it writes its files, until opened;
    ``fail`` makes the next write raise instead."""

    def __init__(self, monkeypatch):
        self.held = threading.Event()
        self.opened = threading.Event()
        self.fail = False
        real = tckpt._map

        def gated(fn, items):
            if threading.current_thread() is not threading.main_thread():
                if self.fail:
                    self.fail = False
                    raise OSError("injected write failure")
                if not self.opened.is_set():
                    self.held.set()
                    assert self.opened.wait(60)
            return real(fn, items)

        monkeypatch.setattr(tckpt, "_map", gated)


def test_latest_step_counts_the_save_in_flight(tmp_path, monkeypatch):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(10, _state(10))
    mgr.wait()
    gate = _Gate(monkeypatch)
    assert mgr.save(20, _state(20))
    assert gate.held.wait(60)
    assert mgr.latest_step() == 20               # registered in memory
    assert mgr.latest_committed_step() == 10     # durable on disk
    assert mgr.steps_on_disk() == [10]
    gate.opened.set()
    mgr.wait()
    assert mgr.latest_step() == mgr.latest_committed_step() == 20
    assert mgr.verify_step(20)
    mgr.wait()                                   # nothing in flight: no-op
    mgr.close()
    assert mgr.latest_committed_step() == 20


def test_close_and_restore_wait_for_the_save_in_flight(tmp_path, monkeypatch):
    gate = _Gate(monkeypatch)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _state(1))
    assert gate.held.wait(60)
    threading.Timer(0.2, gate.opened.set).start()
    _assert_same(mgr.restore(), _state(1))       # waits, then picks step 1
    mgr.save(2, _state(2))
    mgr.close()
    assert mgr.steps_on_disk() == [1, 2] and mgr.verify_step(2)


def test_the_snapshot_is_taken_before_save_returns(tmp_path, monkeypatch):
    gate = _Gate(monkeypatch)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    state = _state(1)
    assert mgr.save(1, state)
    for t in T.leaves(state):
        if isinstance(t, torch.Tensor):
            t.add_(1)                            # the optimizer's update
    assert gate.held.wait(60)
    gate.opened.set()
    mgr.wait()
    _assert_same(mgr.restore(1), _state(1))
    # The next save reuses the host buffers, after step 1 is written.
    assert mgr.save(2, state)
    for t in T.leaves(state):
        if isinstance(t, torch.Tensor):
            t.mul_(3)
    mgr.close()
    _assert_same(mgr.restore(1), _state(1))
    want = _state(1)
    for t in T.leaves(want):
        if isinstance(t, torch.Tensor):
            t.add_(1)
    _assert_same(mgr.restore(2), want)


def test_rapid_saves_of_a_changing_state_each_keep_their_bits(
        tmp_path, monkeypatch):
    """Twelve saves back to back, the state changed in place after each,
    the writer on more threads than cores and the interpreter switching
    threads every microsecond: every step restores to the state it was
    saved from (the snapshot buffers are reused only after the previous
    write has landed)."""
    monkeypatch.setattr(tckpt, "_THREADS", 2 * (os.cpu_count() or 1))
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=12)
    state, want = _state(0), {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(1, 13):
            assert mgr.save(step, state)
            want[step] = T.map_tree(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                state)
            for t in T.leaves(state):
                if isinstance(t, torch.Tensor):
                    t.add_(1)
        mgr.close()
    finally:
        sys.setswitchinterval(switch)
    assert mgr.steps_on_disk() == list(range(1, 13))
    for step, tree in want.items():
        _assert_same(mgr.restore(step), tree)


def test_a_failed_write_surfaces_once_and_leaves_no_step(tmp_path,
                                                         monkeypatch):
    gate = _Gate(monkeypatch)
    gate.opened.set()
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    gate.fail = True
    assert mgr.save(1, _state(1))                # the write fails later
    with pytest.raises(OSError, match="injected"):
        mgr.wait()
    mgr.wait()                                   # surfaced once
    assert mgr.steps_on_disk() == [] and mgr.latest_step() is None
    assert os.listdir(mgr.directory) == []       # no temporary left
    gate.fail = True
    mgr.save(2, _state(2))
    with pytest.raises(OSError, match="injected"):
        mgr.save(3, _state(3))                   # raised before step 3
    assert mgr.steps_on_disk() == []
    assert mgr.save(3, _state(3))
    mgr.close()
    assert mgr.steps_on_disk() == [3]


def _trainer_cfg(**kw):
    base = dict(model="tiny", model_overrides={"dtype": "float32",
                                               "fused_kernels": "off"},
                data={"seq_len": 32, "global_batch": 4},
                optimizer={"learning_rate": 3e-3, "warmup_steps": 5},
                log_every=1, watchdog_enabled=False)
    base.update(kw)
    return TrainerConfig(**base)


def _run(cfg, workdir, on_step=None):
    os.makedirs(workdir, exist_ok=True)
    tr = Trainer(cfg, device="cpu", workdir=str(workdir))
    tr.emitter.stream = io.StringIO()
    seen = {}

    def record(step, m):
        seen[step] = dict(m)
        if on_step is not None:
            on_step(step, m)

    tr.run(on_step=record)
    return tr, seen


def test_a_writer_error_is_counted_while_training_continues(tmp_path,
                                                             monkeypatch):
    gate = _Gate(monkeypatch)
    gate.opened.set()
    gate.fail = True                             # step 2's write fails
    ck = str(tmp_path / "ck")
    tr, seen = _run(_trainer_cfg(steps=6, checkpoint_dir=ck,
                                 checkpoint_every=2), tmp_path / "w")
    assert sorted(seen) == list(range(1, 7))
    assert tr.save_failures == 1
    # Counted at step 4's save, after step 4's log line.
    assert [seen[s]["checkpoint_save_failures"] for s in range(1, 7)] == \
        [0, 0, 0, 0, 1, 1]
    assert tckpt.CheckpointManager(ck).steps_on_disk() == [4, 6]
    assert tr.ledger.data["checkpoint_save_failures"] == 1


_KILLED_WRITER = """
import os, sys, time, torch
sys.path.insert(0, {repo!r})
from kubeflow_tpu_torch.train import checkpoint as C

def state(n):
    return {{"w": torch.full((64, 64), float(n)), "step": n}}

mgr = C.CheckpointManager({root!r})
mgr.save(1, state(1))
mgr.wait()
real = C._map

def stall(fn, items):
    items = list(items)
    fn(items[0])                     # one file of step 2 written
    open({marker!r}, "w").close()
    time.sleep(600)

C._map = stall
mgr.save(2, state(2))
time.sleep(600)
"""


def test_a_write_killed_midway_resumes_from_the_committed_step(tmp_path):
    root, marker = str(tmp_path / "ck"), str(tmp_path / "marker")
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILLED_WRITER.format(
            repo=str(REPO), root=root, marker=marker)])
    try:
        for _ in range(1200):
            if os.path.exists(marker) or proc.poll() is not None:
                break
            threading.Event().wait(0.05)
        assert os.path.exists(marker), "the writer never started step 2"
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
    tmp = [d for d in os.listdir(root) if ".tmp-" in d]
    assert len(tmp) == 1 and tmp[0].startswith("2")
    assert os.listdir(os.path.join(root, tmp[0]))
    mgr = tckpt.CheckpointManager(root)
    assert not [d for d in os.listdir(root) if ".tmp-" in d]
    assert mgr.steps_on_disk() == [1] and mgr.latest_committed_step() == 1
    state, step, tier, fallbacks = tckpt.resume_from_tiers([("interval",
                                                             mgr)])
    assert (step, tier, fallbacks) == (1, "interval", 0)
    assert torch.equal(state["w"], torch.full((64, 64), 1.0))


class _Crash(Exception):
    pass


def test_trainer_resume_is_exact_with_saves_in_flight(tmp_path, monkeypatch):
    """Steps 4 and 5 run while step 3's save is held; the crash after step
    5 waits for that save, and the resume from step 3 gives the
    uninterrupted run's losses."""
    _, whole = _run(_trainer_cfg(steps=6), tmp_path / "w")
    gate = _Gate(monkeypatch)
    ck = str(tmp_path / "ck")

    def crash(step, _):
        if step == 5:
            assert gate.held.wait(60) and not gate.opened.is_set()
            gate.opened.set()
            raise _Crash()

    with pytest.raises(_Crash):
        _run(_trainer_cfg(steps=6, checkpoint_dir=ck, checkpoint_every=3),
             tmp_path / "a", on_step=crash)
    assert tckpt.CheckpointManager(ck).latest_committed_step() == 3
    tr, resumed = _run(_trainer_cfg(steps=6, checkpoint_dir=ck,
                                    checkpoint_every=3), tmp_path / "a")
    assert sorted(resumed) == [4, 5, 6]
    for s in (4, 5, 6):
        assert resumed[s]["loss"] == whole[s]["loss"], s
    assert tr.ledger.data["attempts"] == 2


def test_a_preemption_after_an_interval_save_pins_no_second_snapshot(
        tmp_path, monkeypatch):
    """A ``Trainer``'s two tiers share one set of host buffers: the
    emergency save after an interval save waits for that save's writer,
    then snapshots into the same buffers, so the host holds one snapshot
    of the state whichever tier saves."""
    gate = _Gate(monkeypatch)
    snaps = []
    real = tckpt.CheckpointManager._snapshot

    def record(self, tensors):
        host = real(self, tensors)
        snaps.append((self, {p: t.data_ptr() for p, t in host.items()},
                      tr.ckpt.latest_committed_step()))
        return host

    monkeypatch.setattr(tckpt.CheckpointManager, "_snapshot", record)
    ck = str(tmp_path / "ck")
    os.makedirs(tmp_path / "w")
    tr = Trainer(_trainer_cfg(steps=6, checkpoint_dir=ck,
                              checkpoint_every=2),
                 device="cpu", workdir=str(tmp_path / "w"))
    tr.emitter.stream = io.StringIO()
    assert tr.ckpt._host is tr.ckpt_emergency._host

    def preempt(step, _):
        if step == 2:
            tr._preempted.set()     # the notice lands after step 2's save
            threading.Timer(0.5, gate.opened.set).start()

    with pytest.raises(SystemExit) as exit_:
        tr.run(on_step=preempt)
    assert exit_.value.code == EXIT_PREEMPTED
    assert [m for m, _, _ in snaps] == [tr.ckpt, tr.ckpt_emergency]
    assert snaps[0][1] == snaps[1][1]           # the same buffers,
    assert snaps[1][2] == 2                     # once step 2 was written
    assert tr.ckpt.latest_committed_step() == 2
    assert tr.ckpt_emergency.latest_committed_step() == 3
    assert tr.save_failures == 0
    assert tr.ckpt._host.buffers == {}          # freed at the end of run


# -- the grain data kind --------------------------------------------------------

@pytest.mark.parametrize("shard", [0, 1])
def test_grain_batches_equal_the_jax_source(tmp_path, shard):
    jdata = pytest.importorskip("kubeflow_tpu.train.data")
    pytest.importorskip("grain")        # the JAX source checks for it
    path = str(tmp_path / "tokens.npy")
    np.save(path, np.random.default_rng(3).integers(
        0, 32000, 40_001).astype(np.uint16))
    kw = dict(kind="grain", path=path, vocab_size=32000, seq_len=63,
              global_batch=8, seed=5)
    jsrc = jdata.make_data_source(jdata.DataConfig(**kw), shard, 2)
    tsrc = tdata.make_data_source(tdata.DataConfig(**kw), shard, 2)
    assert isinstance(tsrc, tdata.GrainLM) and tsrc.local_batch == 4
    for step in (0, 1, 2, 7, 1000):
        want, got = jsrc.batch_at(step), tsrc.batch_at(step)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    it = tsrc.iterate(7)
    np.testing.assert_array_equal(next(it), jsrc.batch_at(7))


def test_grain_kind_imports_no_grain():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['grain'] = None\n"
         "import numpy as np, tempfile, os\n"
         "from kubeflow_tpu_torch.train.data import DataConfig, "
         "make_data_source\n"
         "p = os.path.join(tempfile.mkdtemp(), 't.npy')\n"
         "np.save(p, np.arange(1000, dtype=np.int32))\n"
         "src = make_data_source(DataConfig(kind='grain', path=p, "
         "seq_len=9, global_batch=2))\n"
         "print(src.batch_at(0).shape)"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(2, 10)"
