"""Ring and Ulysses attention on a 4-rank ``seq`` group (one gloo gang,
``tests/dist_support.py:ring_suite``) against JAX's
``ring_attention_sharded`` and ``ulysses_attention_sharded`` on a 4-device
``seq`` mesh: causal, non-causal and softcapped; the port's plain ring
(``impl="xla"``, the online-softmax oracle), its flash ring (the flash
kernels' plain versions on the CPU, with the global lse and delta in the
backward ring) and Ulysses. o and dq/dk/dv within 1e-5 of the reference's
largest magnitude; the flash ring's lse within 1e-5 of the whole
sequence's log-sum-exp. The one-process lockstep drive of the flash
ring's step functions (what the chip smoke runs on one card) equals the
distributed ring, and its launches follow the causal schedule."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dist_support import RING_CASES, finish, spawn_gang  # noqa: E402
from kubeflow_tpu.parallel import ring_attention as JR  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh  # noqa: E402
from kubeflow_tpu_torch.parallel import ring_attention as R  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

N = 4
B, S, H, KH, D = 2, 32, 8, 4, 16


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    return {"q": rng.standard_normal((B, S, H, D)).astype(f),
            "k": rng.standard_normal((B, S, KH, D)).astype(f),
            "v": rng.standard_normal((B, S, KH, D)).astype(f),
            "do": rng.standard_normal((B, S, H, D)).astype(f)}


_JAX_REFS: dict = {}


def _jax_ref(data, impl, causal, softcap):
    """JAX's sharded ring (``impl="xla"``; the reference of both port
    rings) or Ulysses on a 4-device ``seq`` mesh: o and the q/k/v
    gradients, computed once per (family, causal, softcap)."""
    key = (impl == "ulysses", causal, softcap)
    if key not in _JAX_REFS:
        _JAX_REFS[key] = _jax_run(data, impl, causal, softcap)
    return _JAX_REFS[key]


def _jax_run(data, impl, causal, softcap):
    mesh = build_mesh({"seq": N}, jax.devices()[:N])
    if impl == "ulysses":
        def fn(q, k, v):
            return JR.ulysses_attention_sharded(
                q, k, v, mesh, causal=causal, logits_softcap=softcap)
    else:
        def fn(q, k, v):
            return JR.ring_attention_sharded(
                q, k, v, mesh, causal=causal, logits_softcap=softcap,
                impl="xla")
    @jax.jit
    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(do)

    o, grads = fwd_bwd(*(jnp.asarray(data[x]) for x in ("q", "k", "v",
                                                       "do")))
    return {"o": np.asarray(o), **{f"d{x}": np.asarray(g)
                                   for x, g in zip("qkv", grads)}}


def _lse_ref(data, causal, softcap):
    k = np.repeat(data["k"], H // KH, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", data["q"].astype(np.float64), k) \
        * D ** -0.5
    if softcap is not None:
        s = np.tanh(s / softcap) * softcap
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The gang's outputs; JAX's references are computed while it runs."""
    out = tmp_path_factory.mktemp("ring")
    data = _inputs()
    np.savez(out / "inputs.npz", **data)
    procs = spawn_gang("dist_support:ring_suite",
                       {"inputs": str(out / "inputs.npz"), "out": str(out)},
                       N, [out / f"w{r}" for r in range(N)],
                       parallelism={"seq": N})
    try:
        for impl, causal, softcap in RING_CASES.values():
            _jax_ref(data, impl, causal, softcap)
    finally:
        res = finish(procs)
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} exit {rc}:\n{err[-4000:]}"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(N)]
    return data, ranks


def _whole(ranks, case, key, dim=1):
    return torch.cat([r[case][key] for r in ranks], dim=dim).numpy()


@pytest.mark.parametrize("case", list(RING_CASES))
def test_matches_jax_forward_and_gradients(ring, case):
    data, ranks = ring
    impl, causal, softcap = RING_CASES[case]
    want = _jax_ref(data, impl, causal, softcap)
    for key in ("o", "dq", "dk", "dv"):
        got = _whole(ranks, case, key)
        err = np.abs(got - want[key]).max()
        assert err <= 1e-5 * np.abs(want[key]).max(), (key, err)


@pytest.mark.parametrize("case", [c for c, v in RING_CASES.items()
                                  if v[0] == "pallas"])
def test_flash_ring_lse_is_the_whole_sequence_lse(ring, case):
    data, ranks = ring
    _, causal, softcap = RING_CASES[case]
    got = _whole(ranks, case, "lse", dim=2)
    want = _lse_ref(data, causal, softcap)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("case", [c for c, v in RING_CASES.items()
                                  if v[0] == "pallas"])
def test_lockstep_drive_equals_the_distributed_ring(ring, case):
    data, ranks = ring
    _, causal, softcap = RING_CASES[case]
    t = {x: torch.from_numpy(data[x]) for x in data}
    o, lse, (dq, dk, dv) = R.ring_flash_lockstep(
        t["q"], t["k"], t["v"], N, causal=causal, softcap=softcap,
        do=t["do"])
    for key, got in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        want = _whole(ranks, case, key)
        assert np.abs(got.numpy() - want).max() \
            <= 1e-6 * np.abs(want).max(), key
    want = _whole(ranks, case, "lse", dim=2)
    assert np.abs(lse.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("causal", [True, False])
def test_schedule_skips_future_parts(causal):
    """The flash steps a causal ring of 4 runs: rank i attends parts
    0..i, 10 forward steps in all; a non-causal ring runs all 16."""
    cases = [R.step_case(i, t, N, causal) for i in range(N)
             for t in range(N)]
    runs = sum(c != "future" for c in cases)
    assert runs == (10 if causal else 16)
    assert cases.count("own") == (N if causal else 0)


def test_plain_ring_with_one_rank_is_plain_attention():
    from kubeflow_tpu_torch.ops.attention import multi_head_attention

    t = {x: torch.from_numpy(v) for x, v in _inputs().items()}
    got = R.ring_attention(t["q"], t["k"], t["v"], None, impl="xla")
    want = multi_head_attention(t["q"], t["k"], t["v"], causal=True)
    assert torch.allclose(got, want, atol=1e-6)
