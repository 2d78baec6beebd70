"""Disaggregated serving under tensor parallelism on the CPU: gloo gangs of
``runtime.worker_main`` on 2 ranks and on 4 (where tiny's 2 kv heads are
replicated: ranks 0-1 hold head 0, ranks 2-3 head 1) run
``tests/dist_support.py``'s ``tp_roles_suite`` over JAX-initialised
``tiny`` weights (fp32), on the contiguous cache, full-dtype pages and
int8 pages; beside them a helper process runs JAX's engines
(``LLMEngine(mesh=build_mesh({"model": 2}))`` and one-process ones) on
the same weights (``jax_refs``, in two helper processes).

- Bytes: a TP prefill export is exactly the ranks' kv heads, each taken
  once from its first owner (the wire bytes of the payload assembled from
  the ranks' own cache planes), and the replicas of a kv head hold the
  same bytes. Its metadata, shapes and dtypes equal JAX's TP export and
  the 4-rank export's; its KV values agree with both within the fp32
  rounding of a different partition of the sums (|d| <= 1e-5; int8
  codes within one step, scales rel 1e-5): no two of these exports are
  byte-equal, JAX's own TP and one-process exports included.
- Greedy tokens, exactly JAX's unified engine's, in every direction:
  port TP -> port TP, port TP -> port one-process, port one-process ->
  port TP, JAX TP -> port TP, port TP -> JAX one-process.
- Host tier: the page blobs a TP engine demotes are byte-equal to those a
  one-process engine demotes after adopting the same export, and turn 2
  after promotion keeps its tokens. Remote tier: a TP engine's spilled
  blobs serve a one-process engine's turn 2 and the reverse, tokens
  unchanged.
- Pages and ops: no page referenced or leaked after the ack, the fail and
  the reap paths, or after the adoptions; the followers ran exactly the
  leader's ops, by name, and keep no index.
- A ``{model: 2}`` ``model_server`` gang in the prefill role relays to a
  one-process decode worker over HTTP, falls back to recomputing when
  that worker is gone, and SIGTERM ends it with 143 and 0.
- ``_check_tp`` still refuses speculative decoding, LoRA and other axes.
"""

import json
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dist_support import (  # noqa: E402
    ROLE_CASES, ROLE_NEW, TIER_CASES, TIER_TURN2, TP_PROMPTS, finish,
    free_port, spawn_gang, wait_file, write_pickle,
)
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models import layers as L  # noqa: E402
from kubeflow_tpu_torch.models.config import preset, with_model_axis  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.parallel.collectives import ModelAxis  # noqa: E402
from kubeflow_tpu_torch.serve import engine as E  # noqa: E402
from kubeflow_tpu_torch.serve.handoff import HandoffPayload  # noqa: E402
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

WORLDS = (2, 4)
DIRECTIONS = ("tp_to_tp", "tp_to_one", "one_to_tp", "jax_tp_to_tp",
              "tp_to_jax_one")
CFG = preset("tiny", dtype="float32")


def _jax_params():
    from kubeflow_tpu.models import config as jconfig
    from kubeflow_tpu.models import decoder as jdec

    return jdec.init_decoder_params(jax.random.PRNGKey(5),
                                    jconfig.preset("tiny", dtype="float32"))


def _jax_params_from(path: Path) -> dict:
    """The JAX params the fixture saved flat (``T.flatten``) to ``path``."""
    import jax.numpy as jnp

    from kubeflow_tpu_torch.train import tree as T

    return jax.tree.map(jnp.asarray, T.unflatten(dict(np.load(path))))


def _jax_engine(spec: dict, mesh=None):
    from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec
    from kubeflow_tpu.models import config as jconfig
    from kubeflow_tpu.serve import engine as jengine

    return jengine.LLMEngine(jconfig.preset("tiny", dtype="float32"),
                             JBatchingSpec(**spec), params=_JPARAMS[0],
                             mesh=mesh)


_JPARAMS: list = []


def jax_refs(base: str, part: str) -> None:
    """The JAX side, in the fixture's two helper processes. ``part``
    "tp": JAX's TP prefill exports (``jax_tp.pkl``, which the gangs
    adopt), then its unified tokens (``jax_unified.pkl``); "decode": its
    one-process decode engine on each gang's exports
    (``jax_decode.pkl``)."""
    from kubeflow_tpu.runtime.mesh import build_mesh
    from kubeflow_tpu.serve import engine as jengine
    from kubeflow_tpu.serve import handoff as jhandoff

    from dist_support import drive

    _JPARAMS.append(_jax_params_from(Path(base, "jax_params.npz")))
    greedy = jengine.SamplingParams(max_new_tokens=ROLE_NEW)
    if part == "tp":
        mesh = build_mesh({"model": 2}, jax.devices()[:2])
        tp = {}
        for c, spec in ROLE_CASES.items():
            pre = _jax_engine(dict(spec, role="prefill"), mesh)
            tp[c] = []
            for p in TP_PROMPTS:
                r = drive(pre, pre.submit(p, greedy))
                tp[c].append(r.handoff.to_wire())
                pre.complete_handoff(r.id)
        write_pickle(Path(base, "jax_tp.pkl"), tp)
        unified = {}
        for c, spec in ROLE_CASES.items():
            uni = _jax_engine(spec)
            unified[c] = [uni.generate(p, greedy)
                          for p in TP_PROMPTS + (TIER_TURN2,)]
        write_pickle(Path(base, "jax_unified.pkl"), unified)
        return
    exports = {w: wait_file(Path(base, str(w), "exports.pkl"), 600)
               for w in WORLDS}
    out = {w: {} for w in WORLDS}
    for c, spec in ROLE_CASES.items():
        dec = _jax_engine(dict(spec, role="decode"))
        for w in WORLDS:
            out[w][c] = []
            for wire in exports[w][c]:
                p = jhandoff.HandoffPayload.from_wire(wire)
                r = drive(dec, dec.submit_handoff(p))
                out[w][c].append([p.first_token] + r.output_tokens)
    write_pickle(Path(base, "jax_decode.pkl"), out)


def _start_jax_refs(base: Path, part: str):
    here = Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(here)!r}, "
            f"{str(here.parent)!r}]; import {Path(__file__).stem} as m; "
            f"m.jax_refs({str(base)!r}, {part!r})")
    log = open(base / f"jax_{part}.log", "w+")
    return subprocess.Popen([sys.executable, "-c", code], stdout=log,
                            stderr=subprocess.STDOUT, cwd=here.parent), log


def _server_conf(ckpt, port: int, **batching) -> dict:
    return {"model": {"preset": "tiny", "overrides": {"dtype": "float32"}},
            "storage_uri": f"file://{ckpt}",
            "batching": dict(ROLE_CASES["paged"], **batching), "port": port,
            "service": "tiny", "tokenizer": "dist_support:IdText"}


@pytest.fixture(scope="module")
def roles(tmp_path_factory):
    """Both gangs' records and the JAX helper's references; beside them, a
    ``{model: 2}`` prefill-role ``model_server`` gang and a one-process
    decode worker on a checkpoint of the same weights (started here, so
    they load while the gangs run; the HTTP test drives them)."""
    from kubeflow_tpu_torch.train import tree as T

    base = tmp_path_factory.mktemp("tp_roles")
    jparams = jax.tree.map(np.asarray, _jax_params())
    np.savez(base / "jax_params.npz", **T.flatten(jparams))
    helpers = {part: _start_jax_refs(base, part) for part in ("tp", "decode")}
    params = params_from_jax(jparams, "cpu")
    torch.save(params, base / "params.pt")
    mgr = CheckpointManager(str(base / "ckpt"))
    mgr.save(1, {"params": params})
    mgr.wait()
    gangs = {}
    for w in WORLDS:
        (base / str(w)).mkdir()
        gangs[w] = spawn_gang(
            "dist_support:tp_roles_suite",
            {"params": str(base / "params.pt"), "out": str(base / str(w)),
             "kv_root": str(base / str(w) / "kv"),
             "jax_tp": str(base / "jax_tp.pkl")},
            w, [base / str(w) / f"w{r}" for r in range(w)],
            parallelism={"model": w})
    ports = {"prefill": free_port(), "decode": free_port()}
    servers = {
        "prefill": spawn_gang(
            "model_server", _server_conf(base / "ckpt", ports["prefill"],
                                         role="prefill"),
            2, [base / "sp0", base / "sp1"], parallelism={"model": 2}),
        "decode": spawn_gang(
            "model_server", _server_conf(base / "ckpt", ports["decode"],
                                         role="decode"),
            1, [base / "sd0"])}
    try:
        res = {w: finish(p, timeout=400) for w, p in gangs.items()}
        for w, rs in res.items():
            for r, (code, _, err) in enumerate(rs):
                assert code == 0, f"world {w} rank {r} exit {code}:\n" \
                                  f"{err[-4000:]}"
        for part, (helper, log) in helpers.items():
            rc = helper.wait(timeout=400)
            log.seek(0)
            assert rc == 0, f"JAX {part} references exit {rc}:\n" \
                            f"{log.read()[-4000:]}"
        ranks = {w: [torch.load(base / str(w) / f"rank{r}.pt",
                                weights_only=False) for r in range(w)]
                 for w in WORLDS}
        yield {"ranks": ranks, "jax_tp": wait_file(base / "jax_tp.pkl", 1),
               "jax": {"unified": wait_file(base / "jax_unified.pkl", 1),
                       "decode": wait_file(base / "jax_decode.pkl", 1)},
               "servers": servers, "ports": ports}
    finally:
        for procs in list(gangs.values()) + list(servers.values()):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for helper, log in helpers.values():
            if helper.poll() is None:
                helper.kill()
                helper.wait()
            log.close()


CASES = [(w, c) for w in WORLDS for c in ROLE_CASES]
IDS = [f"{c}-model{w}" for w, c in CASES]
TIERS = [(w, c) for w in WORLDS for c in TIER_CASES]
TIER_IDS = [f"{c}-model{w}" for w, c in TIERS]


def _planes(p: HandoffPayload) -> dict:
    out = {"k": p.kv_k, "v": p.kv_v}
    if p.kv_scale_k is not None:
        out.update(ks=p.kv_scale_k, vs=p.kv_scale_v)
    return out


def _owners(world: int) -> list:
    """Each rank's kv heads as (first, count): tiny's are contiguous on
    every rank of these worlds."""
    return [(h[0], len(h)) for h in L.kv_head_owners(
        with_model_axis(CFG, ModelAxis(None, 0, world)))]


@pytest.mark.parametrize("world,case", CASES, ids=IDS)
def test_tp_export_is_every_kv_head_once(roles, world, case):
    """The exported wire bytes are those of a payload built from the
    ranks' own cache planes at the pages (or the slot) the export read,
    each kv head from its first owner; ranks that share a kv head hold
    the same bytes. The contiguous slot is reused by the next prompt, so
    there only the last export is held."""
    recs = [r["prefill", case] for r in roles["ranks"][world]]
    lead = recs[0]
    assert lead["reasons"] == ["handoff"] * len(TP_PROMPTS)
    owners = _owners(world)
    for r, (first, n) in enumerate(owners):
        assert recs[r]["planes"]["k"].shape[3] == n
        twin = owners.index((first, n))
        for name, t in recs[r]["planes"].items():
            assert torch.equal(t, recs[twin]["planes"][name])
    keep, seen = [], 0
    for r, (first, n) in enumerate(owners):
        if first == seen:
            keep.append(r)
            seen += n
    assert seen == CFG.n_kv_heads
    checked = 0
    for i, (wire, (slot, pages)) in enumerate(zip(lead["wires"],
                                                  lead["export_at"])):
        if pages is None and i != len(TP_PROMPTS) - 1:
            continue
        got = HandoffPayload.from_wire(wire)
        plen = got.kv_len
        whole = {}
        for name in _planes(got):
            parts = [recs[r]["planes"][name] for r in keep]
            if pages is None:
                whole[name] = torch.cat([t[:, slot, :plen] for t in parts],
                                        dim=2)
            else:
                idx = torch.tensor(pages)
                whole[name] = torch.cat([t[:, idx] for t in parts], dim=3)
                whole[name] = whole[name].reshape(
                    (CFG.n_layers, -1) + whole[name].shape[3:])[:, :plen]
        want = HandoffPayload(
            request_id=got.request_id, prompt_tokens=got.prompt_tokens,
            first_token=got.first_token, max_new_tokens=got.max_new_tokens,
            temperature=got.temperature, top_k=got.top_k, top_p=got.top_p,
            stop_token=got.stop_token, qos=got.qos,
            kv_k=whole["k"].numpy(), kv_v=whole["v"].numpy(),
            kv_scale_k=whole["ks"].numpy() if "ks" in whole else None,
            kv_scale_v=whole["vs"].numpy() if "vs" in whole else None)
        assert want.to_wire() == wire
        assert got.kv_k.shape == (CFG.n_layers, plen, CFG.n_kv_heads,
                                  CFG.head_dim)
        checked += 1
    assert checked == (1 if case == "dense" else len(TP_PROMPTS))


def _close_payloads(got: HandoffPayload, want: HandoffPayload) -> None:
    """Same metadata, shapes and dtypes; fp32 KV within 1e-5, int8 codes
    within one step and their scales within rel 1e-5."""
    for f in ("prompt_tokens", "first_token", "max_new_tokens",
              "temperature", "top_k", "top_p", "stop_token", "qos"):
        assert getattr(got, f) == getattr(want, f), f
    a, b = _planes(got), _planes(want)
    assert a.keys() == b.keys()
    for name in a:
        x, y = a[name], b[name]
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if x.dtype == np.int8:
            assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1
        elif name in ("ks", "vs"):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)


@pytest.mark.parametrize("world,case", CASES, ids=IDS)
def test_tp_export_matches_jax_tp_export(roles, world, case):
    lead = roles["ranks"][world][0]["prefill", case]
    for wire, jwire in zip(lead["wires"], roles["jax_tp"][case]):
        _close_payloads(HandoffPayload.from_wire(wire),
                        HandoffPayload.from_wire(jwire))


@pytest.mark.parametrize("case", list(ROLE_CASES))
def test_replicated_heads_export_matches_two_ranks(roles, case):
    """On 4 ranks every kv head lives on two: the export carries each once,
    like the 2-rank one (whose heads are split, not replicated)."""
    w4 = roles["ranks"][4][0]["prefill", case]["wires"]
    w2 = roles["ranks"][2][0]["prefill", case]["wires"]
    for a, b in zip(w4, w2):
        _close_payloads(HandoffPayload.from_wire(a),
                        HandoffPayload.from_wire(b))


def _tokens(roles, world: int, case: str, direction: str) -> list:
    lead = roles["ranks"][world][0]
    if direction == "tp_to_tp":
        return lead["decode", case]["tp"]
    if direction == "tp_to_one":
        return lead["prefill", case]["one_from_tp"]
    if direction == "one_to_tp":
        return lead["decode", case]["one"]
    if direction == "jax_tp_to_tp":
        return lead["decode", case]["jax_tp"]
    return roles["jax"]["decode"][world][case]


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("world,case", CASES, ids=IDS)
def test_greedy_tokens_across_every_handoff(roles, world, case, direction):
    want = roles["jax"]["unified"][case][:len(TP_PROMPTS)]
    assert roles["ranks"][world][0]["unified"][case][:len(TP_PROMPTS)] \
        == want
    assert _tokens(roles, world, case, direction) == want


@pytest.mark.parametrize("world,case", TIERS, ids=TIER_IDS)
def test_host_tier_demotes_the_same_bytes_and_promotes(roles, world, case):
    rec = roles["ranks"][world][0]["tiers", case]
    assert rec["demoted"] >= 4
    assert len(rec["blobs_tp"]) == 4
    assert all(isinstance(b, bytes) for b in rec["blobs_tp"])
    assert rec["blobs_tp"] == rec["blobs_one"]
    assert rec["host_stats"]["pages_promoted"] >= 4
    assert rec["host_tokens"] == roles["jax"]["unified"][case][-1]


@pytest.mark.parametrize("direction", ["tp_to_one", "one_to_tp"])
@pytest.mark.parametrize("world,case", TIERS, ids=TIER_IDS)
def test_remote_tier_crosses_engine_kinds(roles, world, case, direction):
    step = "tiers" if direction == "tp_to_one" else "remote_in"
    rec = roles["ranks"][world][0][step, case]
    assert rec["published"] >= 4
    stats = rec["remote_stats"]
    assert stats["remote_registry_hits"] >= 4, stats
    assert stats["pages_promoted_remote"] >= 4, stats
    assert rec["remote_tokens"] == roles["jax"]["unified"][case][-1]


@pytest.mark.parametrize("world,case", CASES, ids=IDS)
def test_no_page_leaks_and_followers_ran_every_op(roles, world, case):
    recs = roles["ranks"][world]
    steps = ["prefill", "decode"] + (["tiers", "remote_in"]
                                     if case in TIER_CASES else [])
    for step in steps:
        lead = recs[0][step, case]
        assert lead["books"] == {"in_use": 0, "leaks": {},
                                 "quiescent": True}, (step, lead["books"])
        assert lead["ops"] > 0
        for rec in recs[1:]:
            assert rec[step, case]["ops"] == lead["ops"], step
            assert rec[step, case]["by_op"] == lead["by_op"], step
    pre, dec = recs[0]["prefill", case], recs[0]["decode", case]
    assert pre["held"] > 0 or case == "dense"
    assert pre["metrics"]["handoffs_exported"] == len(TP_PROMPTS)
    # The fail and the reap; a contiguous export holds no pages, so there
    # nothing is left to reap.
    assert pre["metrics"]["handoffs_failed"] == (1 if case == "dense" else 2)
    assert pre["one_books"]["in_use"] == 0
    assert dec["metrics"]["handoffs_adopted"] == 3 * len(TP_PROMPTS)
    gather = "gather_pages" if case != "dense" else "_gather_slot"
    upload = "upload_pages" if case != "dense" else "_upload_slot"
    assert pre["by_op"][gather] == len(TP_PROMPTS)
    assert dec["by_op"][upload] == 3 * len(TP_PROMPTS)


def _post(url: str, body: dict, headers: dict = None) -> dict:
    req = urllib.request.Request(
        url, json.dumps(body).encode(),
        {"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _series(url: str, name: str) -> float:
    with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
        for line in resp.read().decode().splitlines():
            if line.startswith(name + " ") or line.startswith(name + "{"):
                return float(line.rsplit(" ", 1)[1])
    return 0.0


def _ask(url: str, prompt, headers=None) -> list:
    out = _post(url + "/v1/completions",
                {"prompt": " ".join(map(str, prompt)),
                 "max_tokens": ROLE_NEW, "temperature": 0}, headers)
    return [int(x) for x in out["choices"][0]["text"].split()]


def _ready(url: str, procs, timeout: float = 120.0) -> None:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            with urllib.request.urlopen(url + "/v2/health/ready",
                                        timeout=2) as resp:
                if resp.status == 200:
                    return
        except OSError:
            assert all(p.poll() is None for p in procs)
            time.sleep(0.3)
    raise AssertionError(f"{url} not ready")


def test_model_server_gang_relays_to_a_decode_worker(roles):
    from kubeflow_tpu_torch.core.headers import DECODE_BACKEND_HEADER

    pre_procs, dec_procs = roles["servers"]["prefill"], \
        roles["servers"]["decode"]
    pre = f"http://127.0.0.1:{roles['ports']['prefill']}"
    dec = f"http://127.0.0.1:{roles['ports']['decode']}"
    _ready(pre, pre_procs)
    _ready(dec, dec_procs)
    want = roles["jax"]["unified"]["paged"][:len(TP_PROMPTS)]
    hdr = {DECODE_BACKEND_HEADER: dec}
    assert [_ask(pre, p, hdr) for p in TP_PROMPTS] == want
    assert _series(pre, "kftpu_engine_handoffs_exported_total") == 3
    assert _series(dec, "kftpu_engine_handoffs_adopted_total") == 3
    t0 = time.monotonic()
    while (_series(pre, "kftpu_engine_kv_pages_resident")
           or _series(dec, "kftpu_engine_kv_pages_resident")):
        assert time.monotonic() - t0 < 30, "pages stay resident"
        time.sleep(0.1)
    dec_procs[0].send_signal(signal.SIGTERM)
    assert finish(dec_procs, timeout=60)[0][0] == 143
    assert _ask(pre, TP_PROMPTS[0], hdr) == want[0]
    assert _series(pre, "kftpu_engine_handoffs_fallback_total") == 1
    pre_procs[0].send_signal(signal.SIGTERM)
    res = finish(pre_procs, timeout=60)
    assert [rc for rc, _, _ in res] == [143, 0], [e[-2000:] for *_, e in res]


def test_refusals_that_stand_name_their_roadmap_items():
    """Roles and tiers pass ``_check_tp``; speculative decoding and LoRA
    (9e3) and any other axis (9e2) still raise, naming only themselves."""
    served = BatchingSpec(role="prefill", paged=True, host_kv_pages=4,
                          remote_kv_root="kv-store")
    E._check_tp(CFG, served, {"model": 2}, None)
    E._check_tp(CFG, BatchingSpec(role="decode"), {"model": 4}, None)
    for spec, mesh, named in (
            (dict(paged=True, speculative={"mode": "ngram", "k": 4}),
             {"model": 2}, "speculative decoding (ROADMAP.md Queue 1 "
             "item 9e3)"),
            (dict(lora={"max_adapters": 2}), {"model": 2},
             "LoRA adapters (ROADMAP.md Queue 1 item 9e3)"),
            (dict(role="prefill", host_kv_pages=4, paged=True),
             {"data": 2, "model": 2}, "mesh axes {'data': 2} "
             "(ROADMAP.md Queue 1 item 9e2)")):
        with pytest.raises(NotImplementedError) as err:
            E.LLMEngine(CFG, BatchingSpec(**spec), device="cpu",
                        mesh=mesh)
        assert str(err.value).split(" under a tensor-parallel mesh")[0] \
            == named
